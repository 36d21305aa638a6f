"""The port's bench suite (`crlot_tpu_torch/bench/suite.py`) on the CPU.

* The `fft` and `ola` sections emit the metric names the JAX package's
  same sections emit (the reference's sections are run here, on JAX's
  CPU backend);
* every other section, run on the CPU at the reference's sizes (the
  stream cut to two chunks with the reference's own
  CRLOT_BENCH_STREAM_MIN), emits the names of a literal list taken from
  `crlot_tpu/bench/suite.py` (line numbers beside each), less the ones
  that exist only on the card: the `_pallas` kernel rows and the
  one-program variants, which are CUDA-graph replays (their absence is
  written under `_not_captured`), and the 4x-chunk variant, which the
  reference too leaves out of a stream of fewer than 8 chunks;
* `main --suites fft,ola --device cpu` prints a last JSON line with
  `_backend: "cpu"` and each section's launches (none on the CPU);
* `check` fails on a NaN, a bit-exact flag of 0 and an SNR under its
  gate; `launches.launch_counts` / `reset_launch_counts` cover every
  kernel counter, and `launches.uncounted()` (the timed repeats and graph
  captures, `probes.device_ms` included) puts every counter back and
  reads as not counting inside.

No tolerance: names and verdicts are compared exactly.
"""

import contextlib
import io
import json

import pytest
import torch

from crlot_tpu.bench import suite as jsuite

from crlot_tpu_torch.bench import launches, probes, suite

CPU = torch.device("cpu")

# Metric names of the reference's sections (crlot_tpu/bench/suite.py).
KERNEL_SIZES = (16, 64, 256, 1024, 4096, 16384, 32768, 1 << 20)  # :61
REFERENCE_NAMES = {
    "kernels": sorted(  # :68-86
        f"kernel_{k}{label}_n{n}_ns_per_elem"
        for n in KERNEL_SIZES for k in ("axpy_windowed", "normalize")
        for label in ("", "_pallas", "_jnp")
        if label != "" or n in (1024, 32768, 1 << 20)),
    "e2e": [  # :159-161
        "e2e_1s48k_n1024_h256_ms", "e2e_1s48k_n1024_h256_rtf",
        "e2e_1s48k_n1024_h256_snr_db", "e2e_1s48k_n1024_h512_ms",
        "e2e_1s48k_n1024_h512_rtf", "e2e_1s48k_n1024_h512_snr_db"],
    "spectral": [  # :189-190, :206-207, :232-233
        "eq_composed_1s48k_ms", "eq_composed_msamples_per_s",
        "mask_gate_1s48k_ms", "mask_gate_msamples_per_s",
        "eq_sharded_blocked_1s48k_ms", "eq_sharded_blocked_msamples_per_s"],
    "multichannel": [  # :258-259, :267-268
        "mc64_1s48k_ms", "mc64_msamples_per_s", "mc64_fir_1s48k_ms",
        "mc64_fir_msamples_per_s"],
    "sweep": [  # :313-316 for N in (256, 1024, 4096, 16384), ratio (2, 4)
        f"sweep_n{n}_r{r}_{m}" for n in (256, 1024, 4096, 16384)
        for r in (2, 4) for m in ("gsamples_per_s", "snr_db",
                                  "sentinel_gsamples_per_s", "vs_sentinel")
    ] + ["sweep_n1024_r4_hamming_snr_db",  # :324
         "sweep_n1024_r4_hamming_gsamples_per_s"],  # :328
    "resample": [  # :425-427, :446-449, :453
        "resample_chain_4s_ms", "resample_chain_msamples_per_s",
        "resample_chain_out_len", "resample_stft_fused_4s_ms",
        "resample_stft_fused_msamples_per_s",
        "resample_stft_unfused_wall_ms"],
    "convolve": [  # :343-344
        "convolve_255tap_4s_ms", "convolve_255tap_msamples_per_s"],
    "features": [  # :365-369, :379-380, :392-393
        "mel64_4s_ms", "mel64_msamples_per_s", "mfcc13_4s_ms",
        "mfcc13_msamples_per_s", "hpss17_4s_ms", "hpss17_msamples_per_s",
        "pcen_mel64_4s_ms", "pcen_mel64_msamples_per_s"],
    "iir": ["iir_butter4_4s_ms", "iir_butter4_msamples_per_s"],  # :409-410
    "streaming": [
        "stream_minutes_audio", "stream_sustained_gsamples_per_s",  # :529-533
        "stream_wall_s",  # :534
        "stream_sustained_i16_gsamples_per_s", "stream_i16_wall_s",  # :580-583
        "stream_i16_vs_f32_max_delta_lsb",  # :599
        "egress_readback_ms_per_chunk", "egress_readback_mb_per_s",  # :615-616
        "egress_batched8_mb_per_s", "egress_batched8_ms_per_chunk",  # :624-627
        "stream_sustained_i16_batched_egress_gsamples_per_s",  # :641
        "link_host_to_device_mb_per_s",  # :657
        "link_device_to_host_mb_per_s",  # :660
        "stream_sustained_device_resident_tiled_gsamples_per_s",  # :682
        "stream_sustained_device_resident_gsamples_per_s",  # :728
        "stream_device_resident_formulation",  # :731
        "stream_sustained_device_resident_bigchunk_gsamples_per_s",  # :768
        "stream_blocked_vs_oneshot_bitexact",  # :790
        "stream_blocked_vs_oneshot_max_abs_delta",  # :793
        "stream_sustained_device_resident_i16_int8x2_gsamples_per_s",  # :843
        "stream_sustained_device_resident_i16_int8x1_gsamples_per_s",  # :843
        "stream_i16_int8x2_vs_f32_snr_db",  # :855
        "stream_sustained_device_resident_scan_gsamples_per_s",  # :905
        "stream_blocked_scan_vs_dispatch_bitexact",  # :914
        "stream_blocked_ring_vs_dispatch_bitexact",  # :947
        "stream_sustained_device_resident_ring_gsamples_per_s",  # :959
        "stream_sustained_device_resident_ring_chained_gsamples_per_s",  # :965
        "stream_sustained_device_resident_scan_chained_gsamples_per_s",  # :982
        "stream_sustained_device_resident_dispatch_gsamples_per_s",  # :999
        "stream_ckpt_save_ms", "stream_ckpt_restore_ms",  # :1045, :1049
        "stream_ckpt_resume_bitexact",  # :1054
        "stream_tail_chunk_snr_db",  # :1060
        "stream_block_latency_ms",  # :1093
        "stream_block_dispatch_ms",  # :1100
        "stream_block_budget_ms", "stream_algorithmic_latency_ms",  # :1101-1102
        "stream_sustained_device_resident_tiled_scan_gsamples_per_s",  # :1140
        "stream_scan_vs_dispatch_bitexact",  # :1149
        "stream_scan_vs_dispatch_max_abs_delta",  # :1158
    ],
}
# The one-program variants: CUDA-graph replays, on the card only.
GRAPH_ONLY = {
    "stream_sustained_device_resident_scan_gsamples_per_s",
    "stream_blocked_scan_vs_dispatch_bitexact",
    "stream_blocked_ring_vs_dispatch_bitexact",
    "stream_sustained_device_resident_ring_gsamples_per_s",
    "stream_sustained_device_resident_ring_chained_gsamples_per_s",
    "stream_sustained_device_resident_scan_chained_gsamples_per_s",
    "stream_sustained_device_resident_tiled_scan_gsamples_per_s",
    "stream_scan_vs_dispatch_bitexact",
    "stream_scan_vs_dispatch_max_abs_delta",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_section(name) -> dict:
    results = {}
    suite.BENCHES[name](results, CPU)
    return results


@pytest.mark.parametrize("name", ["fft", "ola"])
def test_fft_and_ola_names_equal_the_reference_sections(name):
    ref = {}
    getattr(jsuite, f"bench_{name}")(ref)
    got = _port_section(name)
    assert sorted(got) == sorted(ref)
    assert all(v > 0 for v in got.values())


@pytest.mark.parametrize("name", sorted(REFERENCE_NAMES))
def test_section_names_equal_the_reference_list(name, monkeypatch):
    monkeypatch.setenv("CRLOT_BENCH_STREAM_MIN", "0")  # two chunks
    got = _port_section(name)
    want = set(REFERENCE_NAMES[name])
    if name == "kernels":
        want = {k for k in want if "_pallas" not in k}
    not_captured = got.pop("_not_captured", None)
    if name == "streaming":
        want -= GRAPH_ONLY
        # 4x chunks need 8 chunks of the stream or more (:743); two here.
        want.discard(
            "stream_sustained_device_resident_bigchunk_gsamples_per_s")
        assert set(not_captured) == {"scan", "ring", "tiled_scan"}
    else:
        assert not_captured is None
    assert sorted(got) == sorted(want)
    suite.check(got)


def test_graph_only_keys_are_reference_names():
    assert GRAPH_ONLY <= set(REFERENCE_NAMES["streaming"])
    assert set(suite.SECTIONS) == set(REFERENCE_NAMES) | {"fft", "ola"}


def test_main_prints_a_final_line_with_the_cpu_backend(tmp_path):
    out = tmp_path / "suite.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        suite.main(["--suites", "fft,ola", "--device", "cpu", "--out",
                    str(out)])
    lines = buf.getvalue().strip().splitlines()
    assert [json.loads(ln)["suite"] for ln in lines[:-1]] == ["fft", "ola"]
    last = json.loads(lines[-1])
    assert last["_backend"] == "cpu"
    assert last["_launches"] == {"fft": {}, "ola": {}}
    assert last["_nan_retry_attempts"] == 0
    assert json.loads(out.read_text()) == last


def test_main_refuses_an_unknown_suite():
    with pytest.raises(ValueError, match="unknown suites"):
        suite.main(["--suites", "fft,nope", "--device", "cpu"])


@pytest.mark.parametrize("bad,why", [
    ({"e2e_1s48k_n1024_h256_ms": float("nan")}, "NaN"),
    ({"stream_ckpt_resume_bitexact": 0}, "bitexact"),
    ({"sweep_n256_r2_snr_db": 59.9}, "< 60.0"),
    ({"stream_i16_int8x2_vs_f32_snr_db": 84.0}, "< 85.0"),
])
def test_check_fails_on_nan_flag_and_snr(bad, why):
    ok = {"e2e_1s48k_n1024_h256_snr_db": 120.0,
          "stream_blocked_vs_oneshot_bitexact": 1,
          "stream_i16_int8x2_vs_f32_snr_db": 95.4,
          "stream_device_resident_formulation": "blocked",
          "_backend": "cpu"}
    suite.check(ok)
    with pytest.raises(AssertionError, match=why):
        suite.check(dict(ok, **bad))


@contextlib.contextmanager
def _saved_counts():
    saved = launches.launch_counts()
    try:
        yield
    finally:
        launches.set_launch_counts(saved)


def test_launch_counts_cover_every_counter_and_reset():
    from crlot_tpu_torch import int8_gemm
    from crlot_tpu_torch.fft import fused_rt, tf32x3
    from crlot_tpu_torch.ola import kernels

    with _saved_counts():
        tf32x3.launches, fused_rt.frames_launches = 3, 2
        kernels.launches["normalize_and_clear"] = 5
        int8_gemm.launches["limb"] = 7
        got = launches.launch_counts()
        assert (got["B0"], got["B3"], got["K6"], got["B6_limb"]) == (3, 2,
                                                                     5, 7)
        assert len(got) == 11 + len(fused_rt.packed_launches) + len(
            int8_gemm.launches)
        assert suite.launch_counts is launches.launch_counts
        launches.reset_launch_counts()
        assert set(launches.launch_counts().values()) == {0}


def test_set_launch_counts_sets_every_counter():
    with _saved_counts():
        want = {k: i + 1 for i, k in enumerate(launches.launch_counts())}
        launches.set_launch_counts(want)
        assert launches.launch_counts() == want


def test_uncounted_puts_every_counter_back():
    """Launches inside `uncounted()` leave no count, nested or on an
    exception, and `counting()` is False only inside."""
    from crlot_tpu_torch.fft import tf32x3
    from crlot_tpu_torch.ola import kernels

    with _saved_counts():
        launches.reset_launch_counts()
        tf32x3.launches = 1
        assert launches.counting()
        with launches.uncounted():
            assert not launches.counting()
            tf32x3.launches += 5
            with launches.uncounted():
                kernels.launches["axpy_windowed"] += 2
            assert kernels.launches["axpy_windowed"] == 0
            assert not launches.counting()
        assert launches.counting()
        with pytest.raises(RuntimeError):
            with launches.uncounted():
                tf32x3.launches += 1
                raise RuntimeError("timed call failed")
        assert launches.counting()
        got = launches.launch_counts()
        assert got["B0"] == 1 and sum(got.values()) == 1


def test_device_ms_counts_no_launch():
    """A timed call's launches (here a counter bumped by hand, as a
    wrapper bumps it) are taken back out."""
    from crlot_tpu_torch.fft import tf32x3

    seen = []

    def fn():
        seen.append(launches.counting())
        tf32x3.launches += 1

    with _saved_counts():
        before = launches.launch_counts()
        assert probes.device_ms(fn, "cpu", reps=3) >= 0.0
        assert launches.launch_counts() == before
        assert seen == [False] * 4


def test_quick_headline_duty_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.quick_headline_duty()
