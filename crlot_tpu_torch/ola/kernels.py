"""The OLA SIMD tier: B5's three kernels, their wrappers and plain versions.

Counterpart of `crlot_tpu/ola/kernels.py` (the reference's axpy,
axpy_windowed and normalize_and_clear hot loops). The kernels live in
`csrc/ola_kernels.cu` and are bit-identical to the plain versions here
(`*_reference`) and to the reference's jnp oracles on the CPU: the
multiply-add is ONE fused multiply-add (a single rounding), as XLA
contracts `dst + src*gain` and as the reference's Highway `MulAdd` does --
`fma(src, gain, dst)` and `fma(src*win, gain, dst)` -- and NaN in `norm`
propagates as `torch.clamp_min` does. torch has no fused multiply-add, so
the plain versions compute it exactly in float64 (`fma_f32`).

`use_pallas` keeps the reference's tri-state name so a reader finds the
counterpart; here it means "the hand-written kernel". A CPU tensor always
runs the plain version. Any other tensor launches the kernel with None or
True, and raises with False: a tensor on the card never takes the plain
version (call `*_reference` for that). The reference's size crossover
(`CRLOT_PALLAS_MIN_N`, measured on a TPU v5e) is not carried over: the card
has no measured crossover yet, so there is no size dispatch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import cuda_build

# Max frame size the ring shadow sizing assumed in the reference
# (dsp/ola/kernels.h:11); kept as the tested upper bound for sweeps.
MAX_FRAME_SIZE = 16384

# B5 kernel launches since import (or the caller's reset), per kernel.
launches: Dict[str, int] = {
    "axpy": 0, "axpy_windowed": 0, "normalize_and_clear": 0,
}


def _f32(v) -> float:
    """A Python scalar cast to float32 once, as `jnp.float32(gain)` does."""
    return float(np.float32(v))


def _tensors(*arrays) -> list:
    """float32 tensors on one device (array-likes go to the CPU)."""
    ts = [torch.as_tensor(a, dtype=torch.float32) for a in arrays]
    if len({t.device for t in ts}) > 1:
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in ts]}")
    return ts


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a*b + c) with one rounding, for float32 operands: the
    product is exact in float64 and the sum is rounded to odd there (TwoSum
    error term), which a final rounding to float32 turns into the correctly
    rounded result."""
    a64, c64 = a.double(), c.double()
    p = a64 * b  # exact: 24 + 24 significant bits
    s = p + c64
    bb = s - c64
    err = (c64 - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & torch.isfinite(err) & even
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def _use_kernel(t: torch.Tensor, use_pallas: Optional[bool]) -> bool:
    if t.device.type == "cpu":
        return False
    if use_pallas is False:
        raise ValueError(f"use_pallas=False on a {t.device} tensor: the "
                         f"plain version runs only on the CPU")
    return True


def _check_cuda(what: str, *ts: torch.Tensor) -> None:
    cuda_build.require_cuda(what, *ts)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ts):
        raise ValueError(f"{what} takes contiguous float32 tensors")
    if any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{what}: shape mismatch "
                         f"{[tuple(t.shape) for t in ts]}")


# --- axpy: dst + src*gain (reference: kernels.cc:18-22) ---


def axpy_reference(dst: torch.Tensor, src: torch.Tensor,
                   gain) -> torch.Tensor:
    return fma_f32(src, _f32(gain), dst)


def axpy_cuda(dst: torch.Tensor, src: torch.Tensor, gain) -> torch.Tensor:
    _check_cuda("axpy", dst, src)
    out = torch.empty_like(dst)
    cuda_build.launch("crlot_axpy", dst.device, dst.data_ptr(),
                      src.data_ptr(), _f32(gain), out.data_ptr(), dst.numel())
    launches["axpy"] += 1
    return out


def axpy(dst, src, gain=1.0,
         use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Returns dst + src*gain (functional form of the in-place reference)."""
    dst, src = _tensors(dst, src)
    if dst.shape != src.shape:
        raise ValueError(f"shape mismatch {tuple(dst.shape)} vs "
                         f"{tuple(src.shape)}")
    if dst.numel() == 0:
        return dst
    if not _use_kernel(dst, use_pallas):
        return axpy_reference(dst, src, gain)
    return axpy_cuda(dst.contiguous(), src.contiguous(), gain)


# --- axpy_windowed: dst + src*win*gain (kernels.cc:24-28) ---


def axpy_windowed_reference(dst, src, win, gain) -> torch.Tensor:
    return fma_f32(src * win, _f32(gain), dst)


def axpy_windowed_cuda(dst, src, win, gain) -> torch.Tensor:
    _check_cuda("axpy_windowed", dst, src, win)
    out = torch.empty_like(dst)
    cuda_build.launch("crlot_axpy_windowed", dst.device, dst.data_ptr(),
                      src.data_ptr(), win.data_ptr(), _f32(gain),
                      out.data_ptr(), dst.numel())
    launches["axpy_windowed"] += 1
    return out


def axpy_windowed(dst, src, win, gain=1.0,
                  use_pallas: Optional[bool] = None) -> torch.Tensor:
    dst, src, win = _tensors(dst, src, win)
    if not (dst.shape == src.shape == win.shape):
        raise ValueError(
            f"shape mismatch {tuple(dst.shape)} vs {tuple(src.shape)} vs "
            f"{tuple(win.shape)}"
        )
    if dst.numel() == 0:
        return dst
    if not _use_kernel(dst, use_pallas):
        return axpy_windowed_reference(dst, src, win, gain)
    return axpy_windowed_cuda(dst.contiguous(), src.contiguous(),
                              win.contiguous(), gain)


# --- normalize_and_clear: out = acc/max(norm, eps) (kernels.cc:30-36) ---


def normalize_and_clear_reference(acc, norm, eps):
    out = acc / torch.clamp_min(norm, _f32(eps))
    return out, torch.zeros_like(acc)


def normalize_and_clear_cuda(acc, norm, eps):
    _check_cuda("normalize_and_clear", acc, norm)
    out = torch.empty_like(acc)
    cleared = torch.empty_like(acc)
    cuda_build.launch("crlot_normalize_and_clear", acc.device, acc.data_ptr(),
                      norm.data_ptr(), _f32(eps), out.data_ptr(),
                      cleared.data_ptr(), acc.numel())
    launches["normalize_and_clear"] += 1
    return out, cleared


def normalize_and_clear(acc, norm, eps=1e-8,
                        use_pallas: Optional[bool] = None):
    """Returns (out, cleared_acc): the fused divide-and-zero drain pass that
    lets the OLA ring be reused (reference: kernels.cc:30-36). Functional:
    `acc` itself is not zeroed."""
    acc, norm = _tensors(acc, norm)
    if acc.shape != norm.shape:
        raise ValueError(f"shape mismatch {tuple(acc.shape)} vs "
                         f"{tuple(norm.shape)}")
    if acc.numel() == 0:
        return acc, acc
    if not _use_kernel(acc, use_pallas):
        return normalize_and_clear_reference(acc, norm, eps)
    return normalize_and_clear_cuda(acc.contiguous(), norm.contiguous(), eps)


# --- dispatch introspection (reference: kernels.cc:58-147) ---


def kernel_dispatch_info() -> Dict[str, object]:
    """torch's device facts and whether the kernels are built (nothing is
    built by asking)."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "cuda_available": cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "num_devices": torch.cuda.device_count() if cuda else 0,
        "kernels_built": cuda_build._LIB is not None,
    }


def print_kernel_dispatch_info() -> None:
    for k, v in kernel_dispatch_info().items():
        print(f"{k}: {v}")
