"""Fused OLA + normalize: the B1 kernel's wrapper and its plain version.

Counterpart of `crlot_tpu/ola/fused.py`. The kernel
(`csrc/ola_fused.cu`, replacing the Pallas `_fused_kernel`) computes

    out[..., t] = (sum over frames covering t, ascending) / max(norm[t], eps)

in one pass and is bit-identical to `ola_normalized_plain`. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .reference import normalize, overlap_add

launches = 0  # B1 kernel launches since import (or the caller's reset)


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
