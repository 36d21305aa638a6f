"""Plain overlap-add and normalize in torch.

Counterpart of `crlot_tpu/ola/reference.py`. Each frame is split into
R = ceil(N/H) hop-blocks and the R shifted block planes are added in the
order r = R-1 .. 0, so every output position sums its frames in ascending
frame order: the canonical order every OLA path of the port reproduces bit
for bit (the B1 kernel in `ola/fused.py` included).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def overlap_count(frame_size: int, hop: int) -> int:
    return -(-frame_size // hop)


def overlap_add(
    frames: torch.Tensor,
    hop: int,
    out_len: Optional[int] = None,
    init_head: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Overlap-add `frames[..., F, N]` at spacing `hop` -> `[..., out_len]`
    (default: the full span (F-1)*hop + N; longer is zero-padded).

    `init_head[..., h]` is added into the zeroed accumulator's first h
    samples BEFORE any frame, so each of those positions sums "seed, then
    the frames in ascending order": the sharded round-trip seeds the left
    neighbour's OLA tail this way, which keeps N shards bit-identical to
    one."""
    if frames.ndim < 2:
        raise ValueError("frames must be at least 2-D [F, N]")
    if hop <= 0:
        raise ValueError(f"hop must be > 0, got {hop}")
    f, n = frames.shape[-2], frames.shape[-1]
    full = (f - 1) * hop + n
    if out_len is None:
        out_len = full
    if out_len <= 0:
        raise ValueError(f"out_len must be > 0, got {out_len}")
    r_count = overlap_count(n, hop)
    n_pad = r_count * hop
    if n_pad != n:
        frames = F.pad(frames, (0, n_pad - n))
    hops = frames.reshape(*frames.shape[:-1], r_count, hop)
    blocks = f + r_count - 1
    out = frames.new_zeros((*frames.shape[:-2], blocks, hop))
    if init_head is not None:
        flat = out.view(*out.shape[:-2], blocks * hop)
        flat[..., : init_head.shape[-1]] += init_head
    for r in range(r_count - 1, -1, -1):
        out[..., r : r + f, :] += hops[..., :, r, :]
    flat = out.reshape(*out.shape[:-2], blocks * hop)
    if out_len > blocks * hop:
        return F.pad(flat, (0, out_len - blocks * hop))
    return flat[..., :out_len]


def normalize(
    acc: torch.Tensor, norm: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """`acc / max(norm, eps)`."""
    norm = norm.to(acc.dtype)
    return acc / torch.clamp_min(norm, eps)


def overlap_add_normalized(
    frames: torch.Tensor,
    hop: int,
    norm: torch.Tensor,
    out_len: Optional[int] = None,
    eps: float = 1e-8,
) -> torch.Tensor:
    y = overlap_add(frames, hop, out_len)
    return normalize(y, norm[: y.shape[-1]], eps)
