"""Polyphase resampler kernel: B4's wrapper and its plain version.

Counterpart of `crlot_tpu/resample/pallas_kernel.py`. Both compute, per
channel c and output j = b*L + i < n_out,

    y[c, j] = sum_{w < W} bank[i, w] * x[c, b*M + w + tau_min]

with x read as 0 outside [0, T) (the reference's left pad of -tau_min).

* `resample_bank_plain` is that sum as strided windows (`unfold`) times
  bank.T in fp32, in slabs of blocks so the window copy stays bounded.
* `resample_cuda` launches B4 (`csrc/resample.cu`) on the compact form of
  the bank: row i's nonzero taps are one contiguous run of tp entries
  starting at column offsets[i], so B4 runs tp MACs per output instead of
  W (157 of 303 at 44.1 -> 48 kHz); each thread computes R outputs of one
  phase, so each tap it loads feeds R FMAs. Every output sums its products in
  ascending w with fp32 FMAs, in one order independent of its position,
  so chunked and one-shot resampling agree bit for bit on the card.
  Where the input segment outgrows shared memory (integer decimation above
  M = 141), B4 does not stage it: each thread reads its own output's window
  from L2 in tiles of 32 taps, transposed through shared memory
  (`geometry`).

Both take `[T]` or `[C, T]`; the channels go into one launch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .. import cuda_build
from . import polyphase  # bound at call time: polyphase imports this module

launches = 0  # B4 kernel launches since import (or the caller's reset)

THREADS = 256  # per CTA at most; mirrors kThreads in csrc/resample.cu
MAX_SHARED_BYTES = 232_448  # dynamic shared memory a CTA may use on sm_90
_SLAB = 1 << 24  # floats of window copy per product in the plain version


@lru_cache(maxsize=None)
def compact_bank(l: int, m: int, taps_per_phase, atten_db: float):
    """(taps_t [tp, L] f32, offsets [L] int32, tau_min, W): the bank's
    nonzero run of each row, transposed so that neighbouring phases i are
    neighbouring addresses; bank[i, offsets[i] + k] == taps_t[k, i]."""
    bank, tau_min, w = polyphase._kernel_bank(l, m, taps_per_phase, atten_db)
    n_h = len(polyphase.design_lowpass(l, m, taps_per_phase, atten_db))
    tp = -(-n_h // l)
    d = (np.arange(l) * m + (n_h - 1) // 2) // l
    offsets = (d - tau_min - (tp - 1)).astype(np.int32)
    rows = offsets[:, None] + np.arange(tp)[None, :]
    taps = np.take_along_axis(bank, rows, axis=1)  # [L, tp]
    return np.ascontiguousarray(taps.T), offsets, tau_min, w


@lru_cache(maxsize=8)
def _compact_on(l, m, taps_per_phase, atten_db, device: torch.device):
    taps_t, offsets, _, _ = compact_bank(l, m, taps_per_phase, atten_db)
    return (torch.from_numpy(taps_t).to(device),
            torch.from_numpy(offsets).to(device))


@lru_cache(maxsize=8)
def _bank_t_on(l, m, taps_per_phase, atten_db,
               device: torch.device) -> torch.Tensor:
    bank, _, _ = polyphase._kernel_bank(l, m, taps_per_phase, atten_db)
    return torch.from_numpy(np.ascontiguousarray(bank.T)).to(device)


def shared_bytes(l: int, m: int, w: int, r: int = 1) -> int:
    """Shared memory of one B4 CTA taking r outputs per thread: the input
    segment of its Q*r blocks, (Q*r - 1)*M + W floats, Q = 256 // min(L,
    256)."""
    q = THREADS // min(l, THREADS)
    return ((q * r - 1) * m + w) * 4


def geometry(l: int, m: int, w: int) -> tuple:
    """(R, staged): B4's outputs per thread and whether it stages the input
    segment in shared memory -- the largest R of 8, 4, 2, 1 whose segment
    fits, else one output per thread, each reading its own window from L2
    (integer decimation above M = 141, e.g. 48 kHz -> 300 Hz). Mirrors
    `crlot_resample`'s choice; never raises."""
    for r in (8, 4, 2, 1):
        if shared_bytes(l, m, w, r) <= MAX_SHARED_BYTES:
            return r, True
    return 1, False


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
) -> torch.Tensor:
    """Launch B4 on a contiguous f32 CUDA `[T]` or `[C, T]` tensor."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"B4 needs a CUDA tensor, got {x.device}")
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
    taps_t, offsets, tau_min, w = compact_bank(l, m, taps_per_phase, atten_db)
    out = torch.empty((channels, n_out), dtype=torch.float32, device=x.device)
    if n_out == 0 or channels == 0:
        return out[0] if squeeze else out
    taps_dev, offsets_dev = _compact_on(l, m, taps_per_phase, atten_db,
                                        x.device)
    lib = cuda_build.load_library()
    status = lib.crlot_resample(
        x2.data_ptr(), t_in, taps_dev.data_ptr(), offsets_dev.data_ptr(),
        out.data_ptr(), channels, n_out, l, m, taps_t.shape[0], w, tau_min,
        cuda_build.stream_handle(x.device),
    )
    cuda_build.check(status, "crlot_resample")
    launches += 1
    return out[0] if squeeze else out
