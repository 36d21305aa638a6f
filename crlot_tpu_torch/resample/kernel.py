"""Polyphase resampler kernel: B4's wrapper and its plain version.

Counterpart of `crlot_tpu/resample/pallas_kernel.py`. Both compute, per
channel c and output j = b*L + i < n_out,

    y[c, j] = sum_{w < W} bank[i, w] * x[c, b*M + w + tau_min]

with x read as 0 outside [0, T) (the reference's left pad of -tau_min).

* `resample_bank_plain` is that sum as strided windows (`unfold`) times
  bank.T in fp32, in slabs of blocks so the window copy stays bounded.
* `resample_cuda` launches B4 (`csrc/resample.cu`) on the compact form of
  the bank: row i's nonzero taps are one contiguous run of tp entries, so
  output j is sum_k taps_t[k, j % L] * x[s_j + k], s_j = floor((j*M +
  h0) / L) - (tp - 1): tp MACs an output instead of W (157 of 303 at
  44.1 -> 48 kHz). Its main kernel gives each thread a register tile of R
  runs x J consecutive outputs: the J outputs of a run share one window of
  `span` samples (their taps shifted into the zero-padded table of
  `runs_table`), and the R runs of a thread share their taps, so one load
  feeds J or R FMAs instead of one. `geometry` picks the tile; where its
  input segment outgrows shared memory, the former phase x block tile
  ("blocks"), and past that ("windows", integer decimation above M = 141,
  e.g. 48 kHz -> 300 Hz) one output a thread reading its window from L2.
  Every output sums its products in ascending input sample with fp32 FMAs
  (the table's zeros add exact zeros), one order independent of its place,
  so chunked and one-shot resampling agree bit for bit on the card, and
  every tile gives the same bits.

Both take `[T]` or `[C, T]`; the channels go into one launch.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_build
from . import polyphase  # bound at call time: polyphase imports this module

launches = 0  # B4 kernel launches since import (or the caller's reset)

THREADS = 256  # per CTA; mirrors kThreads in csrc/resample.cu
WARPS = THREADS // 32
MAX_SHARED_BYTES = 232_448  # dynamic shared memory a CTA may use on sm_90
# Two CTAs an SM: 228 KB of an SM's shared memory less 1 KB a CTA.
TWO_CTAS_BYTES = 113 * 1024
U_COLS = 8  # a row of the runs table: J <= 8 taps, padded
_SLAB = 1 << 24  # floats of window copy per product in the plain version


@lru_cache(maxsize=None)
def compact_bank(l: int, m: int, taps_per_phase, atten_db: float):
    """(taps_t [tp, L] f32, offsets [L] int32, tau_min, W): the bank's
    nonzero run of each row, transposed so that neighbouring phases i are
    neighbouring addresses; bank[i, offsets[i] + k] == taps_t[k, i]."""
    bank, tau_min, w = polyphase._kernel_bank(l, m, taps_per_phase, atten_db)
    tp = -(-_n_h(l, m, taps_per_phase, atten_db) // l)
    offsets = (_run_start(np.arange(l), l, m, taps_per_phase, atten_db)
               - tau_min).astype(np.int32)
    rows = offsets[:, None] + np.arange(tp)[None, :]
    taps = np.take_along_axis(bank, rows, axis=1)  # [L, tp]
    return np.ascontiguousarray(taps.T), offsets, tau_min, w


def _n_h(l, m, taps_per_phase, atten_db) -> int:
    return len(polyphase.design_lowpass(l, m, taps_per_phase, atten_db))


def _run_start(j, l, m, taps_per_phase, atten_db):
    """s_j: the first input sample of output j's tp taps (x index)."""
    n_h = _n_h(l, m, taps_per_phase, atten_db)
    tp = -(-n_h // l)
    return (np.asarray(j, np.int64) * m + (n_h - 1) // 2) // l - (tp - 1)


def run_classes(l: int, j: int) -> int:
    """nc = L / gcd(L, J): runs of J outputs starting at j0 = rho*J fall in
    nc classes j0 % L, which repeat every lcm(J, L) outputs."""
    return l // math.gcd(l, j)


def run_period(l: int, m: int, j: int) -> int:
    """Delta: the input samples between two runs of one class, lcm(J, L) *
    M / L; a warp's 32 lanes take runs Delta apart."""
    return run_classes(l, j) * j * m // l


def run_length(l: int, m: int) -> int:
    """J: 8 outputs a run, or 7 where that, and not 8, makes Delta odd (a
    warp's shared loads then hit 32 distinct banks)."""
    if run_period(l, m, 8) % 2 == 0 and run_period(l, m, 7) % 2 == 1:
        return 7
    return 8


@lru_cache(maxsize=None)
def runs_table(l: int, m: int, taps_per_phase, atten_db: float, j: int):
    """(U [nc, span, 8] f32, h0, span): U[c, n, jj] = taps_t[n - delta,
    (c*J + jj) % L] for 0 <= n - delta < tp, else 0, where delta = s_(cJ+jj)
    - s_(cJ); output j0 + jj of a run of class c is the ascending sum over
    n < span of U[c, n, jj] * x[s_j0 + n]. h0 = (n_h - 1) // 2."""
    taps_t, _, _, _ = compact_bank(l, m, taps_per_phase, atten_db)
    tp = taps_t.shape[0]
    nc = run_classes(l, j)
    j0 = np.arange(nc)[:, None] * j + np.arange(j)[None, :]  # [nc, J]
    s = _run_start(j0, l, m, taps_per_phase, atten_db)
    delta = s - s[:, :1]
    span = tp + int(delta.max())
    u = np.zeros((nc, span, U_COLS), np.float32)
    for c in range(nc):
        for jj in range(j):
            d = int(delta[c, jj])
            u[c, d : d + tp, jj] = taps_t[:, (c * j + jj) % l]
    h0 = (_n_h(l, m, taps_per_phase, atten_db) - 1) // 2
    return u, h0, span


class Plan(NamedTuple):
    """B4's kernel and tile, as `crlot_resample` takes them: kind "runs"
    (runs_kernel: J outputs a run, R runs a thread, WC classes a CTA),
    "blocks" (the former phase x block tile, R blocks a thread) or "windows"
    (unstaged); seg_floats is the shared memory a CTA takes, in floats.
    Made by `plan_of`, which derives every field but kind, R and WC."""

    kind: str
    j: int
    r: int
    wc: int
    nc: int
    span: int
    seg_floats: int


def class_warps(nc: int) -> int:
    """WC: the warps of a CTA over classes -- the largest of 8, 4, 2, 1
    dividing nc, or 8 where that is below 4 and nc >= 8 (a few idle warps
    in the last slice of classes)."""
    wc = next(w for w in (8, 4, 2, 1) if nc % w == 0)
    return 8 if wc < 4 and nc >= 8 else wc


def runs_segment(l: int, m: int, j: int, r: int, wc: int, span: int) -> int:
    """A runs_kernel CTA's shared memory, in floats: its slice of wc
    classes of U (span x 8 each) and a zero row; its outputs, per_cta rows
    of (wc*J | 1); its input segment -- from its first run's start to its
    last run's start plus span, the last run ((per_cta - 1) periods and
    wc - 1 classes on) at most ceil(runs * J * M / L) samples later -- and
    one float (the last step's prefetch)."""
    nc = run_classes(l, j)
    per_cta = (WARPS // wc) * 32 * r
    runs = (per_cta - 1) * nc + wc - 1
    return ((wc * span + 1) * U_COLS + per_cta * ((wc * j) | 1)
            + -(-runs * j * m // l) + span + 1)


def blocks_segment(l: int, m: int, w: int, r: int) -> int:
    """blocks_kernel's segment: (Q*r - 1)*M + W floats, Q = 256 // min(L,
    256)."""
    q = THREADS // min(l, THREADS)
    return (q * r - 1) * m + w


_TILE_RS = (8, 4, 2, 1)  # the R (and WC) of csrc/resample.cu's instances


@lru_cache(maxsize=None)
def plan_of(l: int, m: int, kind: str, r: int = 0, wc: Optional[int] = None,
            taps_per_phase=None, atten_db: float = 120.0) -> Plan:
    """The Plan of `kind` with R = r (and, for "runs", WC = wc, by default
    `class_warps`), every other field derived from the rate: J, the
    classes and span from `runs_table`, seg_floats as the kernel stages it
    (`runs_segment`, `blocks_segment`). Raises ValueError for an R or WC
    the kernel has no instance of, or a segment past shared memory."""
    taps_t, _, _, w = compact_bank(l, m, taps_per_phase, atten_db)
    tp = taps_t.shape[0]
    if kind == "windows":
        return Plan("windows", 0, 0, 1, 0, tp, 0)
    if kind == "runs":
        j = run_length(l, m)
        nc = run_classes(l, j)
        span = runs_table(l, m, taps_per_phase, atten_db, j)[2]
        wc = class_warps(nc) if wc is None else wc
        plan = Plan("runs", j, r, wc, nc, span,
                    runs_segment(l, m, j, r, wc, span))
    elif kind == "blocks":
        plan = Plan("blocks", 0, r, 1, 0, tp, blocks_segment(l, m, w, r))
    else:
        raise ValueError(f"unknown B4 tile kind {kind!r}")
    if plan.r not in _TILE_RS or plan.wc not in _TILE_RS:
        raise ValueError(f"B4 has R and WC of {_TILE_RS}, got R={plan.r} "
                         f"WC={plan.wc}")
    if plan.seg_floats * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"B4 {kind} tile R={r} at L={l} M={m} stages "
                         f"{plan.seg_floats * 4} bytes, over the "
                         f"{MAX_SHARED_BYTES} of shared memory")
    return plan


@lru_cache(maxsize=None)
def geometry(l: int, m: int, taps_per_phase=None,
             atten_db: float = 120.0) -> Plan:
    """B4's tile for a rate: runs_kernel with the largest R whose segment
    fits two CTAs an SM, else one CTA an SM; else the blocks tile with the
    largest R that fits; else the unstaged windows. Never raises."""
    j = run_length(l, m)
    wc = class_warps(run_classes(l, j))
    span = runs_table(l, m, taps_per_phase, atten_db, j)[2]
    w = compact_bank(l, m, taps_per_phase, atten_db)[3]
    fits = [("runs", r, TWO_CTAS_BYTES, runs_segment(l, m, j, r, wc, span))
            for r in _TILE_RS]
    fits += [("runs", r, MAX_SHARED_BYTES, seg) for _, r, _, seg in fits]
    fits += [("blocks", r, MAX_SHARED_BYTES, blocks_segment(l, m, w, r))
             for r in _TILE_RS]
    for kind, r, budget, seg in fits:
        if seg * 4 <= budget:
            return plan_of(l, m, kind, r, wc if kind == "runs" else 1,
                           taps_per_phase, atten_db)
    return plan_of(l, m, "windows", 0, 1, taps_per_phase, atten_db)


@lru_cache(maxsize=8)
def _compact_on(l, m, taps_per_phase, atten_db, device: torch.device):
    taps_t, offsets, _, _ = compact_bank(l, m, taps_per_phase, atten_db)
    return (torch.from_numpy(taps_t).to(device),
            torch.from_numpy(offsets).to(device))


@lru_cache(maxsize=8)
def _runs_on(l, m, taps_per_phase, atten_db, j, device: torch.device):
    return torch.from_numpy(
        runs_table(l, m, taps_per_phase, atten_db, j)[0]).to(device)


@lru_cache(maxsize=8)
def _bank_t_on(l, m, taps_per_phase, atten_db,
               device: torch.device) -> torch.Tensor:
    bank, _, _ = polyphase._kernel_bank(l, m, taps_per_phase, atten_db)
    return torch.from_numpy(np.ascontiguousarray(bank.T)).to(device)


def resample_bank_plain(
    x: torch.Tensor,
    l: int,
    m: int,
    n_out: int,
    taps_per_phase=None,
    atten_db: float = 120.0,
) -> torch.Tensor:
    """`[T]` or `[C, T]` -> `[..., n_out]`: windows[b] = x_pad[b*M : +W]
    times bank.T, on the tensor's device."""
    squeeze = x.ndim == 1
    x2 = x.reshape(1, -1) if squeeze else x
    _, tau_min, w = polyphase._kernel_bank(l, m, taps_per_phase, atten_db)
    bank_t = _bank_t_on(l, m, taps_per_phase, atten_db, x.device)  # [W, L]
    channels, t_in = x2.shape
    blocks = -(-n_out // l)
    pad_left = -tau_min
    pad_right = max(0, (blocks - 1) * m + w - (t_in + pad_left))
    windows = F.pad(x2.float(), (pad_left, pad_right)).unfold(-1, w, m)
    out = torch.empty((channels, blocks, l), dtype=torch.float32,
                      device=x.device)
    step = max(1, _SLAB // (w * channels))
    for s in range(0, blocks, step):
        e = min(blocks, s + step)
        out[:, s:e] = torch.matmul(windows[:, s:e], bank_t)
    y = out.reshape(channels, blocks * l)[:, :n_out]
    return y[0] if squeeze else y


def resample_cuda(
    x: torch.Tensor,
    l: int,
    m: int,
    n_out: int,
    taps_per_phase=None,
    atten_db: float = 120.0,
    plan: Optional[Plan] = None,
) -> torch.Tensor:
    """Launch B4 on a contiguous f32 CUDA `[T]` or `[C, T]` tensor, with
    `geometry`'s tile unless `plan` names another (to time it): one that
    `plan_of` made for this rate, or the launch is refused."""
    global launches
    cuda_build.require_cuda("B4", x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"B4 takes contiguous float32, got {x.dtype}")
    if x.ndim not in (1, 2):
        raise ValueError(f"B4 takes [T] or [C, T], got {tuple(x.shape)}")
    squeeze = x.ndim == 1
    x2 = x.reshape(1, -1) if squeeze else x
    channels, t_in = x2.shape
    if l < 1 or m < 1 or n_out < 0:
        raise ValueError(f"bad geometry: L={l} M={m} n_out={n_out}")
    if n_out >= 2**31 or t_in >= 2**31 or channels > 65535:
        raise ValueError(f"B4 takes < 2^31 samples and <= 65535 channels, "
                         f"got [{channels}, {t_in}] -> {n_out}")
    taps_t, _, tau_min, w = compact_bank(l, m, taps_per_phase, atten_db)
    out = torch.empty((channels, n_out), dtype=torch.float32, device=x.device)
    if n_out == 0 or channels == 0:
        return out[0] if squeeze else out
    if plan is None:
        plan = geometry(l, m, taps_per_phase, atten_db)
    else:
        try:
            own = plan_of(l, m, plan.kind, plan.r, plan.wc, taps_per_phase,
                          atten_db)
        except ValueError as err:
            own = err
        if plan != own:
            raise ValueError(f"B4: {plan} is not a tile of L={l} M={m}; "
                             f"make it with plan_of ({own})")
    taps_dev, offsets_dev = _compact_on(l, m, taps_per_phase, atten_db,
                                        x.device)
    u_dev, h0 = taps_dev, 0
    if plan.kind == "runs":
        u_dev = _runs_on(l, m, taps_per_phase, atten_db, plan.j, x.device)
        h0 = runs_table(l, m, taps_per_phase, atten_db, plan.j)[1]
    cuda_build.launch(
        "crlot_resample", x.device, x2.data_ptr(), t_in, u_dev.data_ptr(),
        plan.nc, plan.span, taps_dev.data_ptr(), offsets_dev.data_ptr(),
        out.data_ptr(), channels, n_out, l, m, taps_t.shape[0], w, tau_min,
        h0, plan.j, plan.r, plan.wc, plan.seg_floats)
    launches += 1
    return out[0] if squeeze else out
