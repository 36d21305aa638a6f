"""Boundary padding with reflect101 / edge / constant semantics, in torch.

Counterpart of `crlot_tpu/core/padding.py`. Pads of any length are
supported: the common single-reflection case is a flip of a slice, longer
pads gather through `reflect101_index`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .types import PadMode


def reflect101_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Map indices into [0, n) by non-repeating reflection (period
    2*(n-1)); n == 1 maps everything to 0."""
    if n <= 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    m = idx.abs() % period
    return torch.where(m >= n, period - m, m)


def pad_signal(
    x: torch.Tensor,
    pad_left: int,
    pad_right: int,
    mode: PadMode = PadMode.CONSTANT,
    value: float = 0.0,
) -> torch.Tensor:
    """Pad the last axis of `x` by (pad_left, pad_right) samples."""
    if pad_left < 0 or pad_right < 0:
        raise ValueError("pad amounts must be >= 0")
    if pad_left == 0 and pad_right == 0:
        return x
    n = x.shape[-1]
    if mode == PadMode.CONSTANT:
        return F.pad(x, (pad_left, pad_right), mode="constant", value=value)
    if n == 0:
        raise ValueError(f"cannot {mode.value}-pad an empty signal")

    def gather(lo: int, hi: int) -> torch.Tensor:
        idx = reflect101_index(torch.arange(lo, hi, device=x.device), n)
        return x.index_select(-1, idx)

    def left_piece(p: int) -> torch.Tensor:
        if mode == PadMode.EDGE:
            return x[..., :1].expand(*x.shape[:-1], p)
        if p <= n - 1:  # reflect101 of -p..-1 is x[1..p] reversed
            return x[..., 1 : p + 1].flip(-1)
        return gather(-p, 0)

    def right_piece(p: int) -> torch.Tensor:
        if mode == PadMode.EDGE:
            return x[..., -1:].expand(*x.shape[:-1], p)
        if p <= n - 1:  # reflect101 of n..n+p-1 is x[n-1-p..n-2] reversed
            return x[..., n - 1 - p : n - 1].flip(-1)
        return gather(n, n + p)

    pieces = []
    if pad_left:
        pieces.append(left_piece(pad_left))
    pieces.append(x)
    if pad_right:
        pieces.append(right_piece(pad_right))
    return torch.cat(pieces, dim=-1)
