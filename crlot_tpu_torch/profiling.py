"""Tracing, roofline accounting and the NaN-debug mode, on the card.

Counterpart of `crlot_tpu/profiling.py`: `trace()` is a `torch.profiler`
scope (the reference's is `jax.profiler`), `nan_debug()` raises at the
first op that makes a NaN (the reference's `jax_debug_nans`),
`environment_info()` captures the build and the card, and
`roofline_samples_per_sec()` is the speed-of-light of the round-trip on
the card's published peaks. `PipelineTraffic` and `roundtrip_traffic` are
the reference's traffic model, copied: pure arithmetic.

    python -m crlot_tpu_torch.profiling   # environment and roofline, as JSON
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import platform
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class DeviceSpecs(NamedTuple):
    """Published peaks of one card: HBM bytes/s and dense FLOP/s by type."""

    hbm_bytes_per_s: float
    tf32_flops: float
    fp32_flops: float
    bf16_flops: float


# By `torch.cuda.get_device_name()` substring. H100: NVIDIA H100 Tensor
# Core GPU datasheet, SXM5 column, dense (no sparsity): 3.35 TB/s HBM3,
# 495 TFLOP/s TF32, 67 TFLOP/s FP32, 989 TFLOP/s BF16, at the 700 W limit.
_DEVICE_SPECS = {
    "H100": DeviceSpecs(3.35e12, 495e12, 67e12, 989e12),
}
_UNKNOWN = DeviceSpecs(100e9, 1e12, 5e11, 2e12)  # conservative fallback


def device_specs(kind: Optional[str] = None) -> DeviceSpecs:
    """The peaks of the card named `kind` (default: card 0's name; raises
    without a card); an unknown card gets conservative figures."""
    if kind is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass the card's "
                               "name as `kind`")
        kind = torch.cuda.get_device_name(0)
    for sub, spec in _DEVICE_SPECS.items():
        if sub in kind:
            return spec
    return _UNKNOWN


@dataclass(frozen=True)
class PipelineTraffic:
    """HBM bytes and FLOPs per INPUT SAMPLE for a round-trip config."""

    bytes_per_sample: float
    flops_per_sample: float


def roundtrip_traffic(
    frame_size: int, hop: int, matmul_fft: bool = True, folded: bool = True,
    formulation: str = "framed", group: int = 2,
) -> PipelineTraffic:
    """Traffic model of the round-trip, per INPUT sample (the reference's).

    "framed": frame -> window -> rFFT -> irFFT -> OLA -> norm with ideal
    fusion: x read once, the [F, N] frame matrix written and read in both
    directions (overlap R = N/H), the spectrum written and read, y written
    once; the folded DFT is N*(N/2+1) MACs a frame a direction, the direct
    basis 2*N*(N+2), an FFT 5*N*log2(N).

    "spectral": the framed nonlinear per-bin path, one more spectrum write
    and read for the fn's output.

    "blocked": the hop-block Toeplitz round-trip: each output sample is one
    kernel row of (R + G - 2)*hop + N MACs, and each of the
    mg = ceil(height / (G*hop)) terms reads the signal once and writes a
    partial that a final add reads, beside the norm read and the output
    write.

    Approximate by construction: a fused kernel can beat the modelled
    passes."""
    if formulation == "blocked":
        r = frame_size // hop
        gh = group * hop
        height = (r + group - 2) * hop + frame_size
        mg = -(-height // gh)
        flops = 2.0 * height + 6  # + normalize epilogue
        b = (
            4.0 * mg      # signal read per matmul term
            + 4.0 * mg    # per-term partial write
            + 4.0 * mg    # final fused add reads the partials
            + 4.0         # norm read
            + 4.0         # output write
        )
        return PipelineTraffic(bytes_per_sample=b, flops_per_sample=flops)
    r = frame_size / hop
    bytes_frames = 2 * 4 * r  # write + read, forward
    bytes_spec = 2 * 4 * r * ((frame_size // 2 + 1) * 2 / frame_size)
    bytes_out_frames = 2 * 4 * r
    b = 4 + bytes_frames + bytes_spec + bytes_out_frames + 4 + 4
    if formulation == "spectral":
        b += bytes_spec  # the fn's output planes: one more write + read
    if matmul_fft and folded and frame_size % 2 == 0:
        # 2 FLOP per MAC x half-size [Re | Im] bases, two directions.
        flops_per_frame = 2 * frame_size * (frame_size // 2 + 1) * 2
    elif matmul_fft:
        flops_per_frame = 2 * frame_size * (frame_size + 2) * 2
    else:
        flops_per_frame = 2 * 5 * frame_size * math.log2(frame_size)
    f = flops_per_frame / hop + 10  # + window/ola/normalize elementwise
    return PipelineTraffic(bytes_per_sample=b, flops_per_sample=f)


def roofline_samples_per_sec(
    frame_size: int, hop: int, matmul_fft: bool = True,
    device_kind: Optional[str] = None, precision: str = "high",
    folded: bool = True, formulation: str = "framed", group: int = 2,
) -> dict:
    """Speed-of-light samples/s of the round-trip on the card: the smaller
    of the HBM-bandwidth bound and the compute bound, both reported.

    precision: "high" runs the DFT products in 3xTF32 (three TF32 products
    each, so the compute peak is TF32 / 3) and "highest" in IEEE fp32 on
    the CUDA cores (the fp32 peak)."""
    spec = device_specs(device_kind)
    t = roundtrip_traffic(frame_size, hop, matmul_fft, folded,
                          formulation, group)
    compute_peak = (spec.tf32_flops / 3.0 if precision == "high"
                    else spec.fp32_flops)
    bw_bound = spec.hbm_bytes_per_s / t.bytes_per_sample
    compute_bound = compute_peak / t.flops_per_sample
    return {
        "bandwidth_bound_samples_per_sec": bw_bound,
        "compute_bound_samples_per_sec": compute_bound,
        "roofline_samples_per_sec": min(bw_bound, compute_bound),
        "bytes_per_sample": t.bytes_per_sample,
        "flops_per_sample": t.flops_per_sample,
        "precision": precision,
        "formulation": formulation,
    }


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """`torch.profiler` scope over the CPU and, with a card, CUDA; on exit
    it writes a Chrome trace (`trace.json`) under `log_dir` (default
    `crlot_trace` in the temporary directory). Yields the profiler."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "crlot_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debug() -> Iterator[None]:
    """Scope in which a torch op whose floating output holds a NaN raises
    `FloatingPointError` (the debugging counterpart of the pipeline's
    finite-scrub contract). Every op's output is checked on the host, so
    each op synchronizes. A hand-written CUDA kernel launched through
    `cuda_build.launch` is not a torch op: a NaN it writes is seen at the
    next torch op that reads its output."""
    with _NanCheck():
        yield


def _git_head() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=Path(__file__).resolve().parent,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _smi() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def environment_info() -> dict:
    """Build, platform, git and card capture (the reference's, with torch,
    CUDA and nvidia-smi's name and power limit in place of jax's
    backend)."""
    cuda = torch.cuda.is_available()
    return {
        "git": _git_head(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": _smi() if cuda else None,
        "num_devices": torch.cuda.device_count() if cuda else 0,
    }


if __name__ == "__main__":
    info = environment_info()
    info["roofline_n1024_h256"] = {
        k: round(v, 2) if isinstance(v, (int, float)) else v
        for k, v in roofline_samples_per_sec(1024, 256).items()
    }
    print(json.dumps(info, indent=1))
