"""Dynamic time warping on feature sequences (min-plus scan formulation),
in torch.

Counterpart of `crlot_tpu/align.py`. Aligns two feature matrices X
`[N, d]`, Y `[M, d]` with the classic recurrence over steps
{(1,0), (0,1), (1,1)}:

    D[i, j] = C[i, j] + min(D[i-1, j], D[i, j-1], D[i-1, j-1])

The in-row dependency is a min-plus linear recurrence
d[j] = min(a[j], d[j-1] + c[j]) with a[j] = c[j] + min(up[j], upleft[j]):
the maps f_j(x) = min(a_j, x + c_j) compose associatively as
(a2, c2) o (a1, c1) = (min(a2, a1 + c2), c1 + c2), so each row is one
parallel prefix scan (`_minplus_row`, `jax.lax.associative_scan`'s
odd/even recursion step for step, as `iir._scan` mirrors it: the mins are
exact and each add rounds in the reference's order, so a row is equal to
the reference's given the same previous row and costs). The rows advance
in a Python loop (the reference's `lax.scan`), a few elementwise launches
a scan level on the card; every operation rounds on its own, so the card
and the CPU give the same matrix from the same costs. The warping path is
backtraced on the host from the accumulated matrix.

The cost's cross term `x @ y.T` is an IEEE fp32 `torch.matmul` (TF32
off), as the reference's is a plain product at its default precision
outside any Pallas kernel; the squared norms are sums in one fixed
pairwise order (`features._sum_last`). Array-like input goes to `device`
(default "cuda", `core/device.py`); a tensor stays on its own device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .core import device as _device
from .features import _sum_last
from .iir import _interleave

__all__ = ["dtw_cost", "dtw", "dtw_path"]

_BIG = np.float32(3.0e38)


def _as_frames(a, device=None) -> torch.Tensor:
    """Coerce to a [N, d] frame matrix: a 1-D length-N input is N
    scalar-feature frames [N, 1]; rank > 2 raises."""
    a = _device.place(a, device, torch.float32)
    if a.ndim == 1:
        return a[:, None]
    if a.ndim != 2:
        raise ValueError(f"expected [N, d] or 1-D [N] series, got "
                         f"{tuple(a.shape)}")
    return a


def dtw_cost(x, y, metric: str = "euclidean", device=None) -> torch.Tensor:
    """Pairwise frame-distance matrix `[N, M]` between X `[N, d]` and
    Y `[M, d]`. `euclidean` expands |x-y|^2 = |x|^2 + |y|^2 - 2<x, y> so
    the cross term is one product (float32 cancellation leaves an ~1e-3
    absolute floor on near-zero distances); `cosine` is 1 - normalized dot.
    A 1-D input of length N is N scalar-feature frames [N, 1]."""
    x = _as_frames(x, device)
    y = _as_frames(y, device)
    if metric == "euclidean":
        sq = (_sum_last(torch.square(x))[:, None]
              + _sum_last(torch.square(y))[None, :]
              - 2.0 * torch.matmul(x, y.T))
        return torch.sqrt(torch.clamp_min(sq, 0.0))
    if metric == "cosine":
        xn = x / torch.clamp_min(
            torch.sqrt(_sum_last(torch.square(x)))[:, None], 1e-12)
        yn = y / torch.clamp_min(
            torch.sqrt(_sum_last(torch.square(y)))[:, None], 1e-12)
        return 1.0 - torch.matmul(xn, yn.T)
    raise ValueError(f"unknown metric {metric!r}")


def _minplus_scan(a: torch.Tensor, c: torch.Tensor):
    """Inclusive prefix scan of the pairs (a, c) under
    (a_l, c_l), (a_r, c_r) -> (min(a_r, a_l + c_r), c_l + c_r) along the
    last axis, `jax.lax.associative_scan`'s recursion step for step."""
    n = a.shape[-1]
    if n < 2:
        return a, c

    def combine(al, cl, ar, cr):
        return torch.minimum(ar, al + cr), cl + cr

    ra, rc = combine(a[..., 0:-1:2], c[..., 0:-1:2], a[..., 1::2],
                     c[..., 1::2])
    oa, oc = _minplus_scan(ra, rc)
    if n % 2 == 0:
        ea, ec = combine(oa[..., :-1], oc[..., :-1], a[..., 2::2],
                         c[..., 2::2])
    else:
        ea, ec = combine(oa, oc, a[..., 2::2], c[..., 2::2])
    ea = torch.cat([a[..., :1], ea], dim=-1)
    ec = torch.cat([c[..., :1], ec], dim=-1)
    return _interleave(ea, oa), _interleave(ec, oc)


def _minplus_row(carry_prev: torch.Tensor,
                 c_row: torch.Tensor) -> torch.Tensor:
    """One DTW row given the previous accumulated row: the min-plus scan
    d[j] = min(a[j], d[j-1] + c[j]), a[j] = c[j] + min(up[j], upleft[j])."""
    upleft = torch.cat([carry_prev.new_full((1,), float(_BIG)),
                        carry_prev[:-1]])
    a = c_row + torch.minimum(carry_prev, upleft)
    return _minplus_scan(a, c_row)[0]


def dtw(x, y, metric: str = "euclidean",
        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DTW of X `[N, d]` against Y `[M, d]` -> `(total_cost, acc)` where
    `acc` is the `[N, M]` accumulated-cost matrix (acc[-1, -1] ==
    total_cost). Feed `acc` to `dtw_path` for the warping path."""
    acc = _accumulate(dtw_cost(x, y, metric=metric, device=device))
    return acc[-1, -1], acc


def _accumulate(c: torch.Tensor) -> torch.Tensor:
    """The accumulated-cost matrix of a cost matrix `[N, M]`. Row 0 (only
    (0, 1) steps) is its running sum, taken as the same min-plus scan with
    a = [c[0, 0], BIG, ...]: the adds then round in one order on every
    device (`torch.cumsum` sums in another order on the card than on the
    CPU, and the reference's XLA cumsum in a third)."""
    acc = torch.empty_like(c)
    a0 = torch.full_like(c[0], float(_BIG))
    a0[0] = c[0, 0]
    acc[0] = _minplus_scan(a0, c[0])[0]
    for i in range(1, c.shape[0]):
        acc[i] = _minplus_row(acc[i - 1], c[i])
    return acc


def dtw_path(acc) -> List[Tuple[int, int]]:
    """Backtrace the optimal warping path from an accumulated-cost matrix
    (on the host, data-dependent length): returns [(0, 0), ..., (N-1, M-1)]
    in ascending order, stepping through the minimal predecessor each time
    (ties prefer the diagonal)."""
    if isinstance(acc, torch.Tensor):
        acc = acc.cpu().numpy()
    a = np.asarray(acc, np.float64)
    i, j = a.shape[0] - 1, a.shape[1] - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            cands = (a[i - 1, j - 1], a[i - 1, j], a[i, j - 1])
            k = int(np.argmin(cands))  # the diagonal wins ties (index 0)
            if k == 0:
                i, j = i - 1, j - 1
            elif k == 1:
                i -= 1
            else:
                j -= 1
        path.append((i, j))
    return path[::-1]
