"""Polyphase FIR resampler, in torch.

Counterpart of `crlot_tpu/resample/polyphase.py`. The float64 design code
(Kaiser windowed-sinc lowpass, the [L, W] kernel bank and its grouped
Toeplitz expansion) is a numpy copy of the reference's, not an import: both
packages build byte-identical filter banks from
(L, M, taps_per_phase, atten_db), which the tests hold.

Math. For a rational rate L/M (reduced), outputs come in blocks of L whose
phase pattern is fixed, so the resampler is one bank K[L, W] applied with
input stride M:

    y[b*L + i] = sum_w K[i, w] * x[b*M + w + tau_min]   (x = 0 outside).

Runtime. `resample` runs the B4 kernel (`kernel.resample_cuda`,
`csrc/resample.cu`) on a CUDA tensor. On a CPU tensor it runs the
reference's own formulation, the grouped Toeplitz product
(`resample_grouped_plain`), whose group count G is the reference's TPU
lane choice; B4 needs neither the grouping nor the im2col copy.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import device as _device
from .kernel import resample_cuda


def kaiser_beta(atten_db: float) -> float:
    """Kaiser window beta for a target stopband attenuation (dB)."""
    a = atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def design_lowpass(
    l: int,
    m: int,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
    rolloff: float = 0.1,
) -> np.ndarray:
    """Centered Kaiser-windowed-sinc lowpass for L/M resampling, float64.

    The stopband edge sits at the output Nyquist (pi/max(L, M) at the
    L-upsampled rate), the transition band `rolloff * Nyquist` wide. With
    taps_per_phase=None the length comes from the Kaiser design formula so
    `atten_db` is met; otherwise length = taps_per_phase * max(L, M).
    Passband gain L compensates zero-stuffing. Odd length, group delay =
    half."""
    mx = max(l, m)
    if taps_per_phase is None:
        delta_omega = rolloff * np.pi / mx
        n_total = int(np.ceil((atten_db - 7.95) / (2.285 * delta_omega)))
        half = max(n_total // 2, mx)
    else:
        half = (taps_per_phase * mx) // 2
    n = 2 * half + 1
    k = np.arange(n, dtype=np.float64) - half
    fc = (1.0 - rolloff / 2.0) / mx  # cutoff centered in the transition band
    h = fc * np.sinc(fc * k)
    h *= np.kaiser(n, kaiser_beta(atten_db))
    # Normalize DC gain to exactly L (sum of every Lth tap ~ 1/L each).
    h *= l / h.sum()
    return h


@lru_cache(maxsize=None)
def _kernel_bank(
    l: int, m: int, taps_per_phase: int | None, atten_db: float
) -> Tuple[np.ndarray, int, int]:
    """Build the [L, W] kernel bank; returns (K f32, tau_min, W)."""
    h = design_lowpass(l, m, taps_per_phase, atten_db)
    half = (len(h) - 1) // 2
    tp = -(-len(h) // l)  # taps per phase after zero-pad
    hpad = np.zeros(tp * l, dtype=np.float64)
    hpad[: len(h)] = h

    a = np.arange(l) * m + half  # a_i = i*M + G
    p = a % l
    d = a // l
    tau_min = int(d.min()) - (tp - 1)
    tau_max = int(d.max())
    w = tau_max - tau_min + 1
    bank = np.zeros((l, w), dtype=np.float64)
    for i in range(l):
        for t in range(tp):
            tau = int(d[i]) - t
            bank[i, tau - tau_min] = hpad[t * l + p[i]]
    return bank.astype(np.float32), tau_min, w


@lru_cache(maxsize=32)
def _grouped_kernel(
    l: int, m: int, taps_per_phase: int | None, atten_db: float, g: int
) -> Tuple[np.ndarray, int, int]:
    """Toeplitz expansion of the kernel bank over G consecutive L-blocks:
    K2[r, j*L + i] = bank[i, r - j*M], span = (G-1)*M + W. Returns
    (K2 f32, tau_min, span)."""
    bank, tau_min, w = _kernel_bank(l, m, taps_per_phase, atten_db)
    span = (g - 1) * m + w
    k2 = np.zeros((span, g * l), dtype=np.float32)
    for j in range(g):
        k2[j * m : j * m + w, j * l : (j + 1) * l] = bank.T
    return k2, tau_min, span


def _group_count(l: int) -> int:
    """Blocks per matmul row in the reference: ~256-512 output lanes."""
    return max(1, -(-256 // l))


def output_length(n_in: int, sr_in: int, sr_out: int) -> int:
    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    return -(-n_in * l // m)  # ceil(n*L/M), matches scipy.resample_poly


@lru_cache(maxsize=8)
def _grouped_kernel_on(l, m, taps_per_phase, atten_db, g,
                       device: torch.device) -> torch.Tensor:
    k2, _, _ = _grouped_kernel(l, m, taps_per_phase, atten_db, g)
    return torch.from_numpy(k2).to(device)


def resample_grouped_plain(
    x: torch.Tensor,  # [C, T] f32
    l: int,
    m: int,
    n_out: int,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
) -> torch.Tensor:
    """The reference's `_resample_impl`: one grouped Toeplitz product,
    y[(b*G + j)*L + i] = sum_r X[b, r] * K2[r, j*L + i] with
    X[b] = x_padded[b*G*M : +span] (an `unfold`, copied by the product)."""
    g = _group_count(l)
    _, tau_min, span = _grouped_kernel(l, m, taps_per_phase, atten_db, g)
    k2 = _grouped_kernel_on(l, m, taps_per_phase, atten_db, g, x.device)
    channels, t_in = x.shape
    row = g * l
    blocks = -(-n_out // row)
    pad_left = -tau_min
    need = (blocks - 1) * g * m + span
    pad_right = max(0, need - (t_in + pad_left))
    xp = F.pad(x.float(), (pad_left, pad_right))
    frames = xp.unfold(-1, span, g * m)[:, :blocks]  # [C, B, span]
    y = torch.matmul(frames, k2).reshape(channels, blocks * row)
    return y[:, :n_out]


def _rate(sr_in: int, sr_out: int) -> Tuple[int, int]:
    if sr_in <= 0 or sr_out <= 0:
        raise ValueError("sample rates must be > 0")
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def _resample_impl(x: torch.Tensor, l: int, m: int, n_out: int,
                   taps_per_phase, atten_db) -> torch.Tensor:
    """[C, T] -> [C, n_out]: the grouped plain version on a CPU tensor,
    else B4 (which raises on what it does not take)."""
    if x.device.type == "cpu":
        return resample_grouped_plain(x, l, m, n_out, taps_per_phase,
                                      atten_db)
    return resample_cuda(x.contiguous(), l, m, n_out, taps_per_phase,
                         atten_db)


def resample(
    x,
    sr_in: int,
    sr_out: int,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
    device=None,
) -> torch.Tensor:
    """Resample `[T]` or `[C, T]` from sr_in to sr_out (zero-phase,
    ceil(T*L/M) out), on the tensor's device (an array-like goes to
    `device`, default "cuda"); the channels go in one launch.

    Matches scipy.signal.resample_poly(x, L, M, window=<same filter>) on the
    interior; edges use zero padding (same as scipy)."""
    x = _device.place(x, device, torch.float32)
    l, m = _rate(sr_in, sr_out)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"expected [T] or [C, T], got shape {tuple(x.shape)}")
    if l == m:
        return x[0] if squeeze else x
    n_out = -(-x.shape[-1] * l // m)
    y = _resample_impl(x, l, m, n_out, taps_per_phase, atten_db)
    return y[0] if squeeze else y


def resample_chunked(
    x,
    sr_in: int,
    sr_out: int,
    chunk: int = 65536,
    taps_per_phase: int | None = None,
    atten_db: float = 120.0,
    device=None,
):
    """Streaming variant: resample a long signal fed in chunks of `chunk`
    samples through `stream.PolyphaseStreamer`, which carries each chunk's
    history to the next, with output identical to one-shot `resample`.

    A numpy (or other array-like) input is moved to `device` (default
    "cuda", which raises without a card; "cpu" asks for the CPU) and the
    result comes back as numpy, as in the reference. A tensor input stays
    on its own device and the result is a tensor there; it takes no
    `device`. On CUDA every chunk launches B4 or raises."""
    from .stream import PolyphaseStreamer  # it imports this module

    as_numpy = not isinstance(x, torch.Tensor)
    xt = _device.place(x, device, torch.float32)
    if chunk <= 0:
        raise ValueError(f"chunk must be > 0, got {chunk}")
    squeeze = xt.ndim == 1
    if squeeze:
        xt = xt[None, :]
    if xt.ndim != 2:
        raise ValueError(f"expected [T] or [C, T], got shape {tuple(xt.shape)}")
    st = PolyphaseStreamer(sr_in, sr_out, xt.shape[0], xt.device,
                           taps_per_phase, atten_db)
    t_in = xt.shape[-1]
    last = max(0, (t_in - 1) // chunk * chunk)
    parts = [st.feed(xt[:, s : s + chunk]) for s in range(0, last, chunk)]
    parts.append(st.finish(xt[:, last:]))
    out = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    if squeeze:
        out = out[0]
    return out.cpu().numpy() if as_numpy else out
