"""The port's `profiling` against `crlot_tpu/profiling.py`.

* `roundtrip_traffic` (copied arithmetic) equal to the reference's, field
  for field, for every formulation;
* `roofline_samples_per_sec` equal to the reference's under the same
  injected figures (the port's "high" peak is TF32 / 3, 3xTF32, where the
  reference's is the TPU's bf16 / 3, so the injected TF32 figure stands for
  the reference's bf16); on the H100's published figures the blocked main
  path is compute-bound at 4102 FLOP a sample, about 4.0e10 samples/s;
* `nan_debug` raises `FloatingPointError` at a torch op that makes a NaN,
  and not outside its scope; `trace` writes a Chrome trace;
  `environment_info` names no card on the CPU.
"""

import json

import pytest
import torch

import crlot_tpu.profiling as jprof

from crlot_tpu_torch import profiling

H100 = "NVIDIA H100 80GB HBM3"
CASES = [
    dict(formulation=f, matmul_fft=m, folded=fo, group=g)
    for f in ("framed", "spectral", "blocked")
    for m in (True, False) for fo in (True, False) for g in (2, 4)
]


@pytest.mark.parametrize("n,hop", [(1024, 256), (512, 128), (2048, 512),
                                   (1000, 250), (4096, 480)])
def test_roundtrip_traffic_equals_the_reference(n, hop):
    for kw in CASES:
        if kw["formulation"] == "blocked" and n % hop:
            continue
        got = profiling.roundtrip_traffic(n, hop, **kw)
        want = jprof.roundtrip_traffic(n, hop, **kw)
        assert (got.bytes_per_sample, got.flops_per_sample) == (
            want.bytes_per_sample, want.flops_per_sample), kw


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_roofline_equals_the_reference_under_the_same_figures(monkeypatch,
                                                              precision):
    hbm, tf32, f32 = 1.5e12, 240e12, 33e12
    monkeypatch.setattr(profiling, "_DEVICE_SPECS", {
        "TEST": profiling.DeviceSpecs(hbm, tf32, f32, 4 * tf32)})
    monkeypatch.setattr(jprof, "_DEVICE_SPECS", {"TEST": (hbm, tf32, f32)})
    for kw in CASES:
        got = profiling.roofline_samples_per_sec(
            1024, 256, device_kind="TEST", precision=precision, **kw)
        want = jprof.roofline_samples_per_sec(
            1024, 256, device_kind="TEST", precision=precision, **kw)
        assert got == want, kw


def test_roofline_of_the_main_path_on_the_h100():
    r = profiling.roofline_samples_per_sec(1024, 256, device_kind=H100,
                                           formulation="blocked")
    assert r["flops_per_sample"] == 4102.0
    assert r["compute_bound_samples_per_sec"] < (
        r["bandwidth_bound_samples_per_sec"])
    assert r["roofline_samples_per_sec"] == pytest.approx(
        495e12 / 3 / 4102, rel=1e-12)
    assert 3.9e10 < r["roofline_samples_per_sec"] < 4.1e10
    hi = profiling.roofline_samples_per_sec(
        1024, 256, device_kind=H100, formulation="blocked",
        precision="highest")
    assert hi["compute_bound_samples_per_sec"] == pytest.approx(
        67e12 / 4102, rel=1e-12)


def test_device_specs():
    assert profiling.device_specs(H100) == (3.35e12, 495e12, 67e12, 989e12)
    assert profiling.device_specs("some other card") == profiling._UNKNOWN
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.device_specs()


def test_nan_debug_raises_at_the_op_and_only_inside():
    zero = torch.zeros(3)
    with profiling.nan_debug():
        assert torch.equal(torch.ones(3) / torch.ones(3), torch.ones(3))
        with pytest.raises(FloatingPointError, match="div"):
            zero / zero
        with pytest.raises(FloatingPointError):
            torch.complex(zero, zero) / 0
    assert torch.isnan(zero / zero).all()  # the scope has ended


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.matmul(torch.ones(64, 64), torch.ones(64, 64))
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_environment_info():
    info = profiling.environment_info()
    assert info["torch"] == torch.__version__
    assert set(info) == {"git", "platform", "python", "torch", "cuda",
                         "device_kind", "nvidia_smi", "num_devices"}
    if not torch.cuda.is_available():
        assert info["device_kind"] is None and info["num_devices"] == 0
