"""Fused OLA + normalize: the B1 kernel's wrapper and its plain version.

Counterpart of `crlot_tpu/ola/fused.py`. The kernel
(`csrc/ola_fused.cu`, replacing the Pallas `_fused_kernel`) computes

    out[..., t] = (sum over frames covering t, ascending) / max(norm[t], eps)

in one pass and is bit-identical to `ola_normalized_plain`. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.

Its seeded variant (`ola_seeded`: the same kernel template with a
compile-time flag, its own entry `crlot_ola_seeded_normalized`) is the
masked stream's overlap-add: a window [t0, t0 + length) of the sum of the
frames [f_lo, f_hi) alone, with a seed (the left neighbour's OLA tail)
added before any frame, divided by `max(norm[t], eps)` where a norm is
given; bit-identical to `ola_seeded_plain`.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .reference import normalize, overlap_add, overlap_count

launches = 0  # B1 kernel launches since import (or the caller's reset)
seeded_launches = 0  # the seeded variant's launches, likewise


def ola_normalized_plain(
    frames: torch.Tensor, norm: torch.Tensor, hop: int, out_len: int,
    eps: float = 1e-8,
) -> torch.Tensor:
    """The reference OLA + divide (`ola/reference.py`)."""
    acc = overlap_add(frames, hop, out_len)
    return normalize(acc, norm[:out_len], eps)


def ola_normalized_cuda(
    frames: torch.Tensor, norm: torch.Tensor, hop: int, out_len: int,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Launch B1 on `frames[B, F, N]` (or `[F, N]`) f32 contiguous CUDA
    tensors; `norm` f32 with at least out_len entries on the same card."""
    global launches
    cuda_build.require_cuda("B1 (frames, norm)", frames, norm)
    if frames.dtype != torch.float32 or norm.dtype != torch.float32:
        raise ValueError(f"B1 takes float32, got {frames.dtype}/{norm.dtype}")
    if frames.ndim not in (2, 3):
        raise ValueError(f"B1 takes [F, N] or [B, F, N], got {frames.shape}")
    if not frames.is_contiguous() or not norm.is_contiguous():
        raise ValueError("B1 takes contiguous frames and norm")
    if hop <= 0 or out_len <= 0 or norm.numel() < out_len:
        raise ValueError(
            f"bad geometry: hop={hop} out_len={out_len} norm={norm.numel()}"
        )
    batched = frames.ndim == 3
    f3 = frames if batched else frames.unsqueeze(0)
    bsz, n_frames, nfft = f3.shape
    out = torch.empty((bsz, out_len), dtype=torch.float32, device=frames.device)
    cuda_build.launch(
        "crlot_ola_normalized", frames.device, f3.data_ptr(), norm.data_ptr(),
        out.data_ptr(), bsz, n_frames, nfft, hop, out_len, float(eps))
    launches += 1
    return out if batched else out[0]


def ola_normalized_auto(
    frames: torch.Tensor, norm: torch.Tensor, hop: int, out_len: int,
    eps: float = 1e-8,
) -> torch.Tensor:
    """OLA + normalize of `frames[..., F, N]` -> `[..., out_len]`: the plain
    version for a CPU tensor, else B1, with the leading axes flattened into
    one batched launch."""
    if frames.device.type == "cpu":
        return ola_normalized_plain(frames, norm, hop, out_len, eps)
    lead = frames.shape[:-2]
    flat = frames.reshape((-1,) + tuple(frames.shape[-2:])).contiguous()
    out = ola_normalized_cuda(
        flat.float(), norm.float().contiguous(), hop, out_len, eps
    )
    return out.reshape(tuple(lead) + (out_len,))


def _check_window(frames, hop, t0, length, f_lo, f_hi, seed, norm) -> None:
    if frames.ndim not in (2, 3):
        raise ValueError(f"B1 takes [F, N] or [B, F, N], got {frames.shape}")
    if hop <= 0 or t0 < 0 or length <= 0:
        raise ValueError(f"bad window: hop={hop} t0={t0} length={length}")
    if not 0 <= f_lo <= f_hi <= frames.shape[-2]:
        raise ValueError(f"bad frame range [{f_lo}, {f_hi}) of "
                         f"{frames.shape[-2]}")
    if seed is not None and seed.shape[:-1] != frames.shape[:-2]:
        raise ValueError(f"seed {tuple(seed.shape)} against frames "
                         f"{tuple(frames.shape)}")
    if norm is not None and norm.numel() < t0 + length:
        raise ValueError(f"norm of {norm.numel()} < {t0 + length}")


def ola_seeded_plain(
    frames: torch.Tensor, hop: int, t0: int, length: int, f_lo: int,
    f_hi: int, seed: torch.Tensor | None = None,
    norm: torch.Tensor | None = None, eps: float = 1e-8,
) -> torch.Tensor:
    """Samples [t0, t0 + length) of the overlap-add of `frames[..., F, N]`
    at spacing `hop` counting only frames [f_lo, f_hi), with `seed[...,
    S]` added first into samples [0, S) and, where `norm` is given,
    divided by `max(norm[t], eps)` -> `[..., length]`.

    The reference's sums (`overlap_add` with `init_head`, then
    `normalize`) on a window-sized accumulator: frame k's hop-block r is
    added to block k + r for r = R-1 .. 0, frames read as views of
    `frames`, so no frame-sized tensor is written. A frame left out adds
    what a zeroed one would: the sum starts at +0.0 and never holds -0.0,
    so adding +0.0 changes no bit."""
    _check_window(frames, hop, t0, length, f_lo, f_hi, seed, norm)
    nfft = frames.shape[-1]
    blk0, blk1 = t0 // hop, -(-(t0 + length) // hop)
    flat = frames.new_zeros((*frames.shape[:-2], (blk1 - blk0) * hop))
    acc = flat.view(*flat.shape[:-1], blk1 - blk0, hop)
    lo = t0 - blk0 * hop
    if seed is not None and seed.shape[-1] > t0:
        s_hi = min(seed.shape[-1], t0 + length)
        flat[..., lo : lo + s_hi - t0] += seed[..., t0:s_hi]
    for r in range(overlap_count(nfft, hop) - 1, -1, -1):
        k0, k1 = max(f_lo, blk0 - r), min(f_hi, blk1 - r)
        if k1 > k0:
            cols = frames[..., k0:k1, r * hop : min((r + 1) * hop, nfft)]
            acc[..., k0 + r - blk0 : k1 + r - blk0, : cols.shape[-1]] += cols
    out = flat[..., lo : lo + length]
    if norm is None:
        return out
    return normalize(out, norm[t0 : t0 + length], eps)


def ola_seeded_cuda(
    frames: torch.Tensor, hop: int, t0: int, length: int, f_lo: int,
    f_hi: int, seed: torch.Tensor | None = None,
    norm: torch.Tensor | None = None, eps: float = 1e-8,
) -> torch.Tensor:
    """Launch B1's seeded variant on `frames[B, F, N]` (or `[F, N]`) f32
    contiguous CUDA tensors; `seed[B, S]` (`[S]`) and `norm` (at least
    t0 + length entries) f32 contiguous on the same card, or None."""
    global seeded_launches
    given = [t for t in (frames, seed, norm) if t is not None]
    cuda_build.require_cuda("B1 seeded (frames, seed, norm)", *given)
    if any(t.dtype != torch.float32 for t in given):
        raise ValueError(f"B1 takes float32, got {[t.dtype for t in given]}")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("B1 takes contiguous frames, seed and norm")
    _check_window(frames, hop, t0, length, f_lo, f_hi, seed, norm)
    batched = frames.ndim == 3
    f3 = frames if batched else frames.unsqueeze(0)
    bsz, n_frames, nfft = f3.shape
    out = torch.empty((bsz, length), dtype=torch.float32, device=frames.device)
    cuda_build.launch(
        "crlot_ola_seeded_normalized", frames.device, f3.data_ptr(),
        None if seed is None else seed.data_ptr(),
        0 if seed is None else seed.shape[-1],
        None if norm is None else norm.data_ptr(), out.data_ptr(), bsz,
        n_frames, nfft, hop, t0, length, f_lo, f_hi, float(eps))
    seeded_launches += 1
    return out if batched else out[0]


def ola_seeded(
    frames: torch.Tensor, hop: int, t0: int, length: int, f_lo: int,
    f_hi: int, seed: torch.Tensor | None = None,
    norm: torch.Tensor | None = None, eps: float = 1e-8,
) -> torch.Tensor:
    """`ola_seeded_plain`'s window: the plain version for a CPU tensor,
    else B1's seeded variant (the seed and norm made contiguous)."""
    if frames.device.type == "cpu":
        return ola_seeded_plain(frames, hop, t0, length, f_lo, f_hi, seed,
                                norm, eps)
    return ola_seeded_cuda(
        frames, hop, t0, length, f_lo, f_hi,
        None if seed is None else seed.contiguous(),
        None if norm is None else norm.contiguous(), eps)
