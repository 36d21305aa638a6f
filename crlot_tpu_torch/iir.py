"""IIR filtering as a log-depth scan, in torch.

Counterpart of `crlot_tpu/iir.py`. The direct-form-II-transposed
recurrence is an affine map per sample,

    s[t] = A s[t-1] + c x[t]        (A constant [N, N], c [N])
    y[t] = b0 x[t] + s[t-1][0]

and affine maps compose associatively, so the state trajectory is one
parallel prefix scan over (matrix, vector) pairs: O(T log T) work at
log2(T) depth, never a loop over samples. `_affine_scan` mirrors
`jax.lax.associative_scan`'s odd/even recursion (the same pairs combined in
the same order), and writes each combine's products as elementwise
multiply-adds over the N x N state, j ascending: no einsum or matmul (which
would run as batched GEMMs with their own summation orders, and on the card
could be TF32).

The scan runs in IEEE float64 (the filter's coefficients are the
reference's float32 ones; input and output are float32). A float32 scan
loses the accuracy of filters with poles near z = 1: the prefix products
A^n of a companion matrix grow large and cancel. On white noise at 48 kHz
against a float64 scipy filter, `a_weighting_sos` / `c_weighting_sos`
through this scan measure 40.96 / 25.94 dB in float32, 90.42 / 59.90 dB
in float32 with float64 combines, and 109.32 / 81.22 dB in float64, the
limit the float32 coefficients set (`chip_smoke.py` phase 30, 2 ch x
60 s on an H100; ROADMAP C18). The reference's float32 scan misses the
70 dB gate on both too (`tests/test_torch_iir.py::
test_c18_float32_scans_miss_scipy` holds every float32 variant below it).
Each multiply and add rounds on its own, so the scan gives the same bits
on the CPU and on the card.

Memory: the matrices do not depend on the channel, so the scan keeps them
once, [N, N, T] (32 MB for a biquad at T = 2^20); the vectors are
[N, B, T] float64 (2.1 GB at BASELINE config 5's 128 x 2^20 for a
biquad), and the recursion's halves, the interleaved outputs and the final
state add about four times that at the peak of a call.

API as the reference's (scipy.signal parity): `sosfilt` (cascaded biquads,
`zi` / `zf` in scipy's DF2T convention), `lfilter` (any order, companion
form), `sosfiltfilt`, and the float64 host designers `butter_sos`,
`a_weighting_sos`, `c_weighting_sos`, `sosfilt_zi` (copies of the
reference's, byte-identical). A filter state crosses between the packages
as it is: the reference's `zf` (numpy) is the port's `zi`. Chunked
streaming with a carried `zi` matches one-shot filtering to f32 tolerance,
not bit for bit: the scan's pairs differ across a chunk boundary.
Array-like input goes to `device` (default "cuda", `core/device.py`); a
tensor stays on its own device, and its `zi` joins it there.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .core import device as _device
from .core.consts import const_on

__all__ = [
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
    "lfilter",
    "butter_sos",
    "a_weighting_sos",
    "c_weighting_sos",
]


# ---------------------------------------------------------------------------
# core: affine associative scan
# ---------------------------------------------------------------------------

def _combine(m1, v1, m2, v2):
    """(m1, v1) then (m2, v2): (m2 m1, m2 v1 + v2), the products summed
    over j ascending. m: [N, N, T'] (no batch axis), v: [N, B, T']."""
    m = m2[:, :1] * m1[:1]
    v = m2[:, 0, None] * v1[0][None]
    for j in range(1, m1.shape[0]):
        m = m + m2[:, j : j + 1] * m1[j : j + 1]
        v = v + m2[:, j, None] * v1[j][None]
    return m, v + v2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """out[..., 2i] = even[..., i], out[..., 2i+1] = odd[..., i]."""
    ne, no = even.shape[-1], odd.shape[-1]
    out = even.new_empty(even.shape[:-1] + (ne + no,))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _scan(m: torch.Tensor, v: torch.Tensor):
    """Inclusive prefix scan of the affine maps along the last axis,
    `jax.lax.associative_scan`'s recursion step for step."""
    n = m.shape[-1]
    if n < 2:
        return m, v
    rm, rv = _combine(m[..., 0:-1:2], v[..., 0:-1:2], m[..., 1::2],
                      v[..., 1::2])
    om, ov = _scan(rm, rv)
    if n % 2 == 0:
        em, ev = _combine(om[..., :-1], ov[..., :-1], m[..., 2::2],
                          v[..., 2::2])
    else:
        em, ev = _combine(om, ov, m[..., 2::2], v[..., 2::2])
    em = torch.cat([m[..., :1], em], dim=-1)
    ev = torch.cat([v[..., :1], ev], dim=-1)
    return _interleave(em, om), _interleave(ev, ov)


def _affine_scan(a_mat: torch.Tensor, c: torch.Tensor, b0: torch.Tensor,
                 x: torch.Tensor, s0: torch.Tensor):
    """Run the DF2T recurrence as a log-depth scan.

    a_mat [N, N], c [N], b0 [], x [B, T], s0 [B, N], all of one dtype
    (float64 in the filters) on one device. Returns (y [B, T], zf [B, N])
    in that dtype."""
    n = a_mat.shape[0]
    t = x.shape[-1]
    mats = a_mat[:, :, None].expand(n, n, t)
    vecs = c[:, None, None] * x[None]  # [N, B, T]
    m_cum, v_cum = _scan(mats, vecs)
    # s[t] = m_cum[t] s0 + v_cum[t], over j ascending.
    s = m_cum[:, 0, None] * s0[:, 0][None, :, None]
    for j in range(1, n):
        s = s + m_cum[:, j, None] * s0[:, j][None, :, None]
    s = s + v_cum  # [N, B, T]
    s_prev0 = torch.cat([s0[:, :1], s[0, :, :-1]], dim=-1)
    y = b0 * x + s_prev0
    return y, s[:, :, -1].t().contiguous()


def _df2t_constants(b32: np.ndarray, a32: np.ndarray, device):
    """DF2T state matrix / vector from normalized (a[0] = 1) float32
    coefficients, computed in float32 as the reference's jitted code computes
them, returned as float64 tensors for the scan:

    z_i[t] = b[i+1] x[t] - a[i+1] y[t] + z_{i+1}[t-1],  y = b[0] x + z_1[t-1]
    => A[i, 0] = -a[i+1], A[i, i+1] = 1; c[i] = b[i+1] - a[i+1] b[0]."""
    n = a32.shape[0] - 1
    a_mat = np.zeros((n, n), np.float32)
    a_mat[:, 0] = -a32[1:]
    if n > 1:
        a_mat[np.arange(n - 1), np.arange(1, n)] = 1.0
    c = (b32[1:] - a32[1:] * b32[0]).astype(np.float32)
    return tuple(const_on(v, device, np.float64) for v in (a_mat, c, b32[0]))


def _state_like(z, x: torch.Tensor) -> torch.Tensor:
    """A filter state as f32 on x's device (an array-like joins x there)."""
    if isinstance(z, torch.Tensor):
        return z.to(torch.float32)
    return torch.as_tensor(np.array(z, np.float32), device=x.device)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _check_sos(sos) -> np.ndarray:
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must be [n_sections, 6], got {sos.shape}")
    return sos


def sosfilt(
    sos: np.ndarray,
    x,
    zi=None,
    device=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Cascaded-biquad IIR filter of `[..., T]` along the last axis.

    `sos` is `[n_sections, 6]` (b0 b1 b2 a0 a1 a2, scipy layout; a0 need not
    be 1). With `zi` (shape `[n_sections, ..., 2]`, scipy's DF2T state
    convention) returns `(y, zf)` for chunked streaming; without it, zero
    initial state and returns `y` alone."""
    sos = _check_sos(sos)
    if np.any(sos[:, 3] == 0.0):
        raise ValueError("sos a0 coefficients must be nonzero")
    x = _device.place(x, device, torch.float32)
    batch_shape = tuple(x.shape[:-1])
    x2 = x.reshape((-1, x.shape[-1]))
    n_sections = sos.shape[0]
    if zi is None:
        zi2 = x2.new_zeros((n_sections, x2.shape[0], 2))
    else:
        zi = _state_like(zi, x2)
        expect = (n_sections,) + batch_shape + (2,)
        if tuple(zi.shape) != expect:
            raise ValueError(f"zi shape {tuple(zi.shape)} != expected {expect}")
        zi2 = zi.reshape((n_sections, x2.shape[0], 2))
    y, zf = _cascade(sos, x2, zi2)
    y = y.float().reshape(batch_shape + (y.shape[-1],))
    if zi is None:
        return y
    return y, zf.float().reshape((n_sections,) + batch_shape + (2,))


def _cascade(sos: np.ndarray, x2: torch.Tensor, zi2: torch.Tensor,
             dtype=torch.float64):
    """The sections' scans in turn on x2 [B, T] from zi2 [S, B, 2], in
    `dtype` (float64, C18; float32 only to measure what it would lose).
    Returns (y [B, T], zf [S, B, 2]) in `dtype`."""
    sos32 = sos.astype(np.float32)
    y = x2.to(dtype)
    zf = []
    for s in range(sos.shape[0]):
        b = sos32[s, :3] / sos32[s, 3]
        a = sos32[s, 3:] / sos32[s, 3]
        consts = [c.to(dtype) for c in _df2t_constants(b, a, x2.device)]
        y, z_last = _affine_scan(*consts, y, zi2[s].to(dtype))
        zf.append(z_last)
    return y, torch.stack(zf, dim=0)


def lfilter(
    b,
    a,
    x,
    zi=None,
    device=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Direct-form IIR filter `[..., T]` (scipy.signal.lfilter parity, DF2T
    state convention for `zi` of shape `[..., max(len(a), len(b)) - 1]`)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.ndim != 1 or b.ndim != 1 or a.size == 0 or a[0] == 0.0:
        raise ValueError("a and b must be 1-D with a[0] != 0")
    x = _device.place(x, device, torch.float32)
    n = max(len(a), len(b)) - 1
    if n == 0:
        y = x * np.float32(b[0] / a[0])
        return (y, x.new_zeros(x.shape[:-1] + (0,))) if zi is not None else y
    bp = np.zeros(n + 1)
    bp[: len(b)] = b / a[0]
    ap = np.zeros(n + 1)
    ap[: len(a)] = a / a[0]
    batch_shape = tuple(x.shape[:-1])
    x2 = x.reshape((-1, x.shape[-1]))
    if zi is None:
        zi2 = x2.new_zeros((x2.shape[0], n))
    else:
        zi = _state_like(zi, x2)
        expect = batch_shape + (n,)
        if tuple(zi.shape) != expect:
            raise ValueError(f"zi shape {tuple(zi.shape)} != expected {expect}")
        zi2 = zi.reshape((x2.shape[0], n))
    consts = _df2t_constants(bp.astype(np.float32), ap.astype(np.float32),
                             x2.device)
    y, zf = _affine_scan(*consts, x2.double(), zi2.double())
    y = y.float().reshape(batch_shape + (y.shape[-1],))
    if zi is None:
        return y
    return y, zf.float().reshape(batch_shape + (n,))


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state DF2T state for a unit-step input, `[n_sections, 2]`
    float64 (scipy.signal.sosfilt_zi parity). Multiply by the signal's
    first sample to start a filter without a step transient — the
    initial-condition trick `sosfiltfilt` relies on. Host-side f64."""
    sos = _check_sos(sos)
    zi = np.zeros((sos.shape[0], 2))
    scale = 1.0
    for k in range(sos.shape[0]):
        b = sos[k, :3] / sos[k, 3]
        a = sos[k, 3:] / sos[k, 3]
        # Steady state of s = A s + c for unit input (DF2T constants as in
        # _df2t_constants): solve (I - A) zi = c.
        A = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        c = b[1:] - a[1:] * b[0]
        zi[k] = scale * np.linalg.solve(np.eye(2) - A, c)
        scale *= b.sum() / a.sum()  # section DC gain feeds the next stage
    return zi


def sosfiltfilt(sos: np.ndarray, x, padlen: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Zero-phase forward-backward filtering (scipy.signal.sosfiltfilt
    parity: odd-extension edge padding + steady-state initial conditions).
    The effective magnitude response is squared; phase is exactly zero.
    The reference's negative-step slices are `flip`s here."""
    sos = _check_sos(sos)
    n_sections = sos.shape[0]
    if padlen is None:
        ntaps = 2 * n_sections + 1
        ntaps -= min(
            int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum())
        )
        padlen = 3 * ntaps
    x = _device.place(x, device, torch.float32)
    t = x.shape[-1]
    if padlen >= t:
        raise ValueError(
            f"padlen ({padlen}) must be < signal length ({t})"
        )
    batch_shape = tuple(x.shape[:-1])
    zi_base = const_on(sosfilt_zi(sos), x.device)  # [S, 2]
    zi_b = zi_base.reshape((n_sections,) + (1,) * len(batch_shape) + (2,))

    if padlen > 0:  # odd extension about both endpoints
        # x[..., padlen:0:-1] and x[..., -2:-padlen-2:-1]
        left = 2.0 * x[..., :1] - x[..., 1 : padlen + 1].flip(-1)
        right = 2.0 * x[..., -1:] - x[..., t - padlen - 1 : t - 1].flip(-1)
        ext = torch.cat([left, x, right], dim=-1)
    else:
        ext = x

    def scaled_zi(first):  # first: [*batch] -> [S, *batch, 2]
        return zi_b * first[None, ..., None]

    y, _ = sosfilt(sos, ext, zi=scaled_zi(ext[..., 0]))
    y = y.flip(-1)
    y, _ = sosfilt(sos, y, zi=scaled_zi(y[..., 0]))
    y = y.flip(-1)
    if padlen > 0:
        y = y[..., padlen:-padlen]
    return y


# ---------------------------------------------------------------------------
# shared zpk -> digital SOS machinery (host, float64 numpy)
# ---------------------------------------------------------------------------

def _bilinear_zpk_to_sos(z, p, k, fs):
    """Analog zpk -> digital `[n_sections, 6]` SOS via the bilinear
    transform s -> 2*fs*(z-1)/(z+1), then conjugate-adjacent pairing.

    Pairing keeps conjugate pairs adjacent (sorted by |imag| descending,
    real roots last); exact for the designs here (identical zeros, or all
    roots real) — this is not scipy's general nearest-pole-zero pairing.
    """
    z = np.asarray(z, dtype=complex)
    p = np.asarray(p, dtype=complex)
    c2 = 2.0 * fs  # the transform constant is 2*fs, NOT fs itself
    k = k * np.real(np.prod(c2 - z) / np.prod(c2 - p))
    z_d = (c2 + z) / (c2 - z)
    p_d = (c2 + p) / (c2 - p)
    z_d = np.concatenate([z_d, -np.ones(len(p) - len(z))])

    def key(q):
        return (abs(q.imag) < 1e-12, -abs(q.imag), q.real)

    p_sorted = sorted(p_d, key=key)
    z_sorted = sorted(z_d, key=key)
    n = len(p_sorted)
    sections = []
    i = 0
    while i < n:
        # Two at a time: the sort puts conjugate pairs adjacent and real
        # roots last, so a window of two is a conjugate pair or two reals;
        # an odd leftover becomes a first-order section.
        take = 2 if i + 1 < n else 1
        pp = np.array(p_sorted[i : i + take])
        zz = np.array(z_sorted[i : i + take])
        i += take
        bq = np.real(np.poly(zz))
        aq = np.real(np.poly(pp))
        if len(pp) == 1:  # first-order section, pad to biquad layout
            bq = np.append(bq, 0.0)
            aq = np.append(aq, 0.0)
        sections.append(np.concatenate([bq, aq]))
    sos = np.array(sections, dtype=np.float64)
    sos[0, :3] *= k  # overall gain into the first section's numerator
    return sos


def _sos_gain_at(sos: np.ndarray, freq: float, fs: float) -> float:
    """|H(e^{j 2 pi freq/fs})| of a digital SOS cascade (host f64)."""
    zinv = np.exp(-2j * np.pi * freq / fs)
    h = 1.0 + 0.0j
    for s in np.asarray(sos, dtype=np.float64):
        num = s[0] + s[1] * zinv + s[2] * zinv * zinv
        den = s[3] + s[4] * zinv + s[5] * zinv * zinv
        h *= num / den
    return float(np.abs(h))


def butter_sos(
    order: int,
    wn: float,
    btype: str = "lowpass",
    fs: Optional[float] = None,
) -> np.ndarray:
    """Butterworth digital filter as `[n_sections, 6]` SOS (float64).

    `wn` is the -3 dB frequency — normalized to Nyquist (0 < wn < 1) when
    `fs` is None, in Hz otherwise. `btype` in {"lowpass", "highpass"}.
    Designed in float64 via the bilinear transform (analog prototype poles
    exp(j*pi*(2k+n+1)/(2n)), conjugate-paired into biquads)."""
    if order < 1:
        raise ValueError("order must be >= 1")
    if fs is not None:
        wn = 2.0 * wn / fs
    if not (0.0 < wn < 1.0):
        raise ValueError(f"normalized wn must be in (0, 1), got {wn}")
    if btype not in ("lowpass", "highpass"):
        raise ValueError(f"btype must be lowpass or highpass, got {btype!r}")

    # Analog lowpass prototype (unit cutoff): left-half-plane unit poles.
    k_idx = np.arange(order)
    p = np.exp(1j * np.pi * (2.0 * k_idx + order + 1.0) / (2.0 * order))
    z = np.zeros(0, dtype=complex)
    k = 1.0

    fs2 = 2.0
    warped = 2.0 * fs2 * np.tan(np.pi * wn / fs2)
    if btype == "lowpass":
        p = p * warped
        k *= warped ** order
    else:  # highpass: lp2hp on the zpk (no prototype zeros: numerator 1)
        k *= np.real(1.0 / np.prod(-p))
        p = warped / p
        z = np.zeros(order, dtype=complex)

    return _bilinear_zpk_to_sos(z, p, k, fs2)


# ---------------------------------------------------------------------------
# IEC 61672 loudness-weighting designers
# ---------------------------------------------------------------------------

# Analog corner frequencies (Hz) shared by the A and C curves.
_W1 = 2.0 * np.pi * 20.598997
_W2 = 2.0 * np.pi * 107.65265
_W3 = 2.0 * np.pi * 737.86223
_W4 = 2.0 * np.pi * 12194.217


def a_weighting_sos(fs: float) -> np.ndarray:
    """IEC 61672 A-weighting filter as digital `[3, 6]` SOS (float64):
    H(s) = k s^4 / ((s+w1)^2 (s+w2) (s+w3) (s+w4)^2), bilinear-transformed
    at `fs` and renormalized to exactly 0 dB at 1 kHz digitally."""
    if fs <= 2000.0:
        raise ValueError(f"fs must be > 2000 Hz for a 1 kHz reference, "
                         f"got {fs}")
    z = np.zeros(4, dtype=complex)
    p = np.array([-_W1, -_W1, -_W2, -_W3, -_W4, -_W4], dtype=complex)
    sos = _bilinear_zpk_to_sos(z, p, 1.0, fs)
    sos[0, :3] /= _sos_gain_at(sos, 1000.0, fs)
    return sos


def c_weighting_sos(fs: float) -> np.ndarray:
    """IEC 61672 C-weighting filter as digital `[2, 6]` SOS (float64):
    H(s) = k s^2 / ((s+w1)^2 (s+w4)^2), 0 dB at 1 kHz digitally."""
    if fs <= 2000.0:
        raise ValueError(f"fs must be > 2000 Hz for a 1 kHz reference, "
                         f"got {fs}")
    z = np.zeros(2, dtype=complex)
    p = np.array([-_W1, -_W1, -_W4, -_W4], dtype=complex)
    sos = _bilinear_zpk_to_sos(z, p, 1.0, fs)
    sos[0, :3] /= _sos_gain_at(sos, 1000.0, fs)
    return sos
