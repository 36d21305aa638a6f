"""Import hygiene of the port and its kernel loader.

Importing `crlot_tpu_torch` must not import jax or crlot_tpu (the card's
machine has no jax) nor triton, and must build nothing. The loader builds
with nvcc at first use and lets every build error propagate.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crlot_tpu_torch import cuda_build

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax_crlot_tpu_or_triton(tmp_path):
    code = (
        "import sys, crlot_tpu_torch, crlot_tpu_torch.pipeline, "
        "crlot_tpu_torch.fft.fused_rt, crlot_tpu_torch.ola.fused, "
        "crlot_tpu_torch.convert, crlot_tpu_torch.distributed, "
        "crlot_tpu_torch.resample.polyphase, crlot_tpu_torch.resample.kernel, "
        "crlot_tpu_torch.ola.kernels, crlot_tpu_torch.convolve, "
        "crlot_tpu_torch.demo, crlot_tpu_torch.profile_paths, "
        "crlot_tpu_torch.streaming_pipeline, crlot_tpu_torch.wire, "
        "crlot_tpu_torch.int8_gemm, crlot_tpu_torch.int8_probe, "
        "crlot_tpu_torch.timing, crlot_tpu_torch.core.device, "
        "crlot_tpu_torch.cuda_build as b\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'crlot_tpu', 'triton'))\n"
        "print('BAD', bad)\n"
        "print('LIB', b._LIB)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
    assert "LIB None" in out.stdout


def test_streaming_layer_names_import_no_jax(tmp_path):
    """The reference's top-level streaming and FFT-plan names, and the
    sharded streamer, come from the port without importing jax."""
    code = (
        "import sys, crlot_tpu_torch as pt\n"
        "names = ['Framer', 'OLAConfig', 'BoundaryMode', 'FftDomain', "
        "'FftPlanDesc', 'FftPlan', 'make_fft_plan', 'WavReader', "
        "'WavWriter', 'PeakMeter', 'xcorr_delay_ms', 'checkpoint', "
        "'OLAAccumulator', 'ShardedStreamer', 'sharded_stream', "
        "'sharded_stream_iter']\n"
        "missing = [n for n in names if not hasattr(pt, n)]\n"
        "missing += [n for n in ('ShardedStreamer', 'sharded_stream', "
        "'sharded_stream_iter') if not hasattr(pt.distributed, n)]\n"
        "import crlot_tpu_torch.checkpoint, crlot_tpu_torch.fft.api, "
        "crlot_tpu_torch.frame.streaming, crlot_tpu_torch.ola.streaming, "
        "crlot_tpu_torch.distributed.stream\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'crlot_tpu', 'triton'))\n"
        "print('MISSING', missing)\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "MISSING []" in out.stdout
    assert "BAD []" in out.stdout


def test_analysis_stack_names_import_no_jax(tmp_path):
    """Every top-level name the reference exports from `iir`, `effects`,
    `features`, `griffinlim` and `segment` (`crlot_tpu/__init__.py`) comes
    from the port, and importing the five modules imports no jax,
    crlot_tpu or triton."""
    src = (REPO / "crlot_tpu" / "__init__.py").read_text()
    names = []
    for mod in ("features", "segment", "effects", "griffinlim", "iir"):
        block = src.split(f"from .{mod} import", 1)[1]
        block = block.split(")", 1)[0] if block.lstrip().startswith("(") \
            else block.split("\n", 1)[0]
        names += [n.strip() for n in block.replace("(", "").split(",")
                  if n.strip()]
    assert len(names) == 51
    code = (
        "import sys, crlot_tpu_torch as pt\n"
        "import crlot_tpu_torch.iir, crlot_tpu_torch.effects, "
        "crlot_tpu_torch.features, crlot_tpu_torch.griffinlim, "
        "crlot_tpu_torch.segment\n"
        f"missing = [n for n in {names!r} if not hasattr(pt, n)]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'crlot_tpu', 'triton'))\n"
        "print('MISSING', missing)\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "MISSING []" in out.stdout
    assert "BAD []" in out.stdout


def test_last_analysis_names_and_core_types_import_no_jax(tmp_path):
    """The 17 top-level names the reference exports from `psd`, `hpss`,
    `pitch`, `vocoder` and `align` (`crlot_tpu/__init__.py`) come from the
    port, the ten types the reference's `core` re-exports come from
    `crlot_tpu_torch.core` (C21), and importing the five modules and the
    Cooley-Tukey backend imports no jax, crlot_tpu or triton."""
    src = (REPO / "crlot_tpu" / "__init__.py").read_text()
    names = []
    for mod in ("psd", "hpss", "pitch", "vocoder", "align"):
        line = src.split(f"from .{mod} import", 1)[1].split("\n", 1)[0]
        names += [n.strip() for n in line.split(",") if n.strip()]
    assert len(names) == 17
    core_src = (REPO / "crlot_tpu" / "core" / "__init__.py").read_text()
    block = core_src.split("import (", 1)[1].split(")", 1)[0]
    types = [n.strip() for n in block.split("\n")[1:] if n.strip()]
    types = [t.rstrip(",") for t in types]
    assert len(types) == 10
    code = (
        "import sys\n"
        f"from crlot_tpu_torch.core import {', '.join(types)}\n"
        "import crlot_tpu_torch as pt, crlot_tpu_torch.core as core\n"
        "import crlot_tpu_torch.psd, crlot_tpu_torch.pitch, "
        "crlot_tpu_torch.vocoder, crlot_tpu_torch.align, "
        "crlot_tpu_torch.fft.ct_backend\n"
        "import importlib; importlib.import_module('crlot_tpu_torch.hpss')\n"
        f"missing = [n for n in {names!r} if not hasattr(pt, n)]\n"
        f"missing += [t for t in {types!r} if getattr(core, t) is not "
        "getattr(pt, t)]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'crlot_tpu', 'triton'))\n"
        "print('MISSING', missing)\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "MISSING []" in out.stdout
    assert "BAD []" in out.stdout


def test_multiprocess_profiling_and_formulation_names_import_no_jax(
        tmp_path):
    """The reference's `distributed` names (`initialize`, `global_mesh`,
    `process_info`, `dryrun`, the accounting), `profiling`'s six and the
    quad, conv and packed formulations come from the port, and importing
    `profiling`, `distributed.multihost` and the two-rank child imports no
    jax, crlot_tpu or triton (and does not start a process group)."""
    dist_names = ["initialize", "global_mesh", "process_info", "dryrun",
                  "collective_bytes_per_step", "overlap_dot_fraction",
                  "weak_scaling_model", "permute_bytes_from_hlo",
                  "process_allgather"]
    prof_names = ["device_specs", "PipelineTraffic", "roundtrip_traffic",
                  "roofline_samples_per_sec", "trace", "nan_debug",
                  "environment_info"]
    fft_names = ["roundtrip_composed_conv", "quad_supported",
                 "rfft_folded_quad_parts", "irfft_folded_quad_parts",
                 "roundtrip_folded_quad", "roundtrip_packed_matmul"]
    code = (
        "import sys\n"
        "import crlot_tpu_torch as pt, crlot_tpu_torch.profiling as prof, "
        "crlot_tpu_torch.distributed.multihost, "
        "crlot_tpu_torch.distributed.multihost_child, "
        "crlot_tpu_torch.fft.matmul_backend as mb, torch\n"
        f"missing = [n for n in {dist_names!r} "
        "if not hasattr(pt.distributed, n)]\n"
        "missing += [n for n in ('initialize', 'global_mesh', "
        "'process_info', 'dryrun') if not hasattr(pt, n)]\n"
        f"missing += [n for n in {prof_names!r} if not hasattr(prof, n)]\n"
        f"missing += [n for n in {fft_names!r} if not hasattr(mb, n)]\n"
        "assert pt.profiling is prof\n"
        "assert not torch.distributed.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'crlot_tpu', 'triton'))\n"
        "print('MISSING', missing)\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "MISSING []" in out.stdout
    assert "BAD []" in out.stdout


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_build_error_propagates_and_is_not_cached(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIB", None)
    calls = []

    def failing(out_path):
        calls.append(out_path)
        raise RuntimeError("nvcc failed (2): simulated")

    monkeypatch.setattr(cuda_build, "compile_library", failing)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="simulated"):
            cuda_build.load_library()
    assert len(calls) == 2 and cuda_build._LIB is None


def test_nvcc_command_targets_sm90a_without_fast_math(monkeypatch, tmp_path):
    """One nvcc per source, all started together, then one link, whose
    failure here is simulated."""
    seen = []

    class Proc:
        stdout = ""
        stderr = "error: simulated"

        def __init__(self, cmd):
            self.returncode = 0 if "-c" in cmd else 1

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return Proc(cmd)

    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="simulated"):
        cuda_build.compile_library(tmp_path / "lib.so")
    compiles, link = seen[:-1], seen[-1]
    assert "-shared" in link
    for cmd in seen:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in c for c in cmd)
    for cmd in compiles:
        assert sum(c.endswith(".cu") for c in cmd) == 1
    assert {Path(c).name for cmd in seen for c in cmd if c.endswith(".cu")} == {
        "b6_sm90.cu", "fp32_window.cu", "fused_rt.cu", "ola_fused.cu",
        "ola_kernels.cu", "resample.cu"}
    assert not list(tmp_path.rglob("*.so"))  # no half-written library left


def test_sources_export_the_bound_symbols():
    text = "".join(p.read_text() for p in cuda_build.sources())
    for name in list(cuda_build._SIGNATURES) + ["crlot_error_string"]:
        assert f' {name}(' in text, name


def test_kernel_wrappers_refuse_non_cuda_devices():
    """A tensor that is not on the CPU goes to the kernel path, which checks
    its device and raises: no plain fallback for non-CPU tensors."""
    from crlot_tpu_torch.fft import fused_rt

    meta = torch.empty((1, 8192), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_rt.roundtrip_signal_fused(
            meta, 1024, 256, 29, torch.ones(1024).numpy(),
            torch.empty(8192, device="meta"),
        )


def test_native_bench_and_example_modules_import_no_jax(tmp_path):
    """The native runtime, the bench tooling and the eight examples import
    no jax, crlot_tpu or triton, build nothing (neither the native library
    nor the CUDA kernels) and run no benchmark at import; `chip_smoke.py`
    imports neither jax nor crlot_tpu either."""
    examples = ["analyze", "denoise", "extract_features", "fir_filter",
                "loudness", "sharded_eq", "streaming_checkpoint",
                "time_stretch"]
    code = (
        "import sys, importlib\n"
        "import crlot_tpu_torch.io.native as nat, crlot_tpu_torch.cuda_build as b\n"
        "import crlot_tpu_torch.bench.suite, crlot_tpu_torch.bench.stages, "
        "crlot_tpu_torch.bench.regression, crlot_tpu_torch.bench.probes, "
        "crlot_tpu_torch.bench.launches\n"
        f"for e in {examples!r}:\n"
        "    importlib.import_module('crlot_tpu_torch.examples.' + e)\n"
        "import runpy; runpy.run_path(sys.argv[1], run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'crlot_tpu', 'triton'))\n"
        "print('BAD', bad)\n"
        "print('LIB', b._LIB, nat._lib)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout
    assert "LIB None None" in out.stdout
    assert not list(tmp_path.iterdir())  # nothing written where it ran
