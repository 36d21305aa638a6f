"""The port's bench tooling: `suite` (the twelve sections), `stages` (the
round-trip's per-stage times), `regression` (the guard against
`baseline.json`), `probes` (the bf16 and HBM duty probes) and `launches`
(the kernel counters, with the timed repeats taken back out). Counterpart
of `crlot_tpu/bench/`; times are CUDA-event medians on the card and
host-clock medians on the CPU."""
