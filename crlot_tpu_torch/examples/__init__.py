"""The reference's eight examples (`examples/*.py`) on the port.

Each runs as `python -m crlot_tpu_torch.examples.<name> ...` with the
reference script's arguments plus `--device` (default "cuda"; "cpu" runs
it on the CPU): `analyze`, `denoise`, `extract_features`, `fir_filter`,
`loudness`, `sharded_eq`, `streaming_checkpoint` and `time_stretch`. Each
`main(argv)` can also be called in-process.
"""
