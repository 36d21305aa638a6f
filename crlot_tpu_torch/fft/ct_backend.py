"""Cooley-Tukey matmul FFT: large power-of-two transforms as two stages of
matrix products, in torch.

Counterpart of `crlot_tpu/fft/ct_backend.py`. The direct DFT-as-matmul
(`matmul_backend.py`) needs an [N, N+2] basis: fine to N = 4096, quadratic
beyond. This backend factors the transform: a real rFFT of length N packs
even / odd samples into a complex signal of length M = N/2, runs a
two-stage Cooley-Tukey FFT (M = M1*M2: a DFT_M1 product, a twiddle
multiply, a DFT_M2 product), and unpacks with the half-size real-FFT
post-twiddle. The operations drop from O(N^2) to O(N*(M1+M2)) a frame.

Complex arithmetic is split into real products; the bases are designed in
float64 and cast to float32, byte-identical to the reference's
(`tests/test_torch_fft_ct.py`). The products are IEEE fp32 on every device:
the reference runs them at `Precision.HIGHEST` outside any Pallas kernel,
and the port runs them as `torch.matmul`, which stays IEEE fp32 as long as
`torch.backends.cuda.matmul.allow_tf32` keeps its default, False.

Derivation: index n = M2*n1 + n2, k = k1 + M1*k2 gives
Z[k1, k2] = DFT_M2(twiddle * DFT_M1(z)), laid out [k2, k1]; the inverse
uses Z[k] = (S + D)/2 with S = X[k] + conj(X[M-k]),
D = -i*conj(e_k)*(conj(X[M-k]) - X[k]), then ifft(z) = conj(fft(conj(z)))/M.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def factor(m: int) -> tuple:
    """Split m = m1*m2 with m2 the largest power of two <= sqrt(m)."""
    if m & (m - 1):
        raise ValueError(f"CT backend requires power-of-two sizes, got {m}")
    m2 = 1
    while m2 * m2 * 4 <= m:
        m2 *= 2
    return m // m2, m2


@lru_cache(maxsize=None)
def _ct_consts(m1: int, m2: int):
    """(D1 re, D1 im, D2 re, D2 im, twiddle re, twiddle im), float32 casts
    of the float64 designs."""
    m = m1 * m2
    d1 = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m1)) / m1)
    d2 = np.exp(-2j * np.pi * np.outer(np.arange(m2), np.arange(m2)) / m2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(m1), np.arange(m2)) / m)
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    return (
        f32(d1.real), f32(d1.imag),
        f32(d2.real), f32(d2.imag),
        f32(tw.real), f32(tw.imag),
    )


@lru_cache(maxsize=None)
def _pack_consts(n: int):
    """The real-FFT post-twiddle e_k = exp(-2 pi i k / n), k = 0..n/2."""
    m = n // 2
    k = np.arange(m + 1)
    e = np.exp(-2j * np.pi * k / n)
    return (
        np.asarray(e.real, dtype=np.float32),
        np.asarray(e.imag, dtype=np.float32),
    )


@lru_cache(maxsize=16)
def _ct_consts_on(m1: int, m2: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _ct_consts(m1, m2))


@lru_cache(maxsize=16)
def _pack_consts_on(n: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _pack_consts(n))


def _ct_fft(zr: torch.Tensor, zi: torch.Tensor, m1: int, m2: int):
    """Two-stage complex FFT on real / imaginary pairs [..., M] -> [..., M]."""
    d1r, d1i, d2r, d2i, twr, twi = _ct_consts_on(m1, m2, zr.device)
    ar = zr.reshape(*zr.shape[:-1], m1, m2)
    ai = zi.reshape(*zi.shape[:-1], m1, m2)
    # Stage 1: B = D1 @ A (contract over n1, the second-to-last axis).
    br = torch.matmul(d1r, ar) - torch.matmul(d1i, ai)
    bi = torch.matmul(d1r, ai) + torch.matmul(d1i, ar)
    # Twiddle (elementwise complex multiply).
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    # Stage 2: Z = C @ D2 (contract over n2, the last axis).
    zr2 = torch.matmul(cr, d2r) - torch.matmul(ci, d2i)
    zi2 = torch.matmul(cr, d2i) + torch.matmul(ci, d2r)
    # k = k1 + m1*k2: output index [k2, k1].
    m = m1 * m2
    zr2 = zr2.transpose(-1, -2).reshape(*zr.shape[:-1], m)
    zi2 = zi2.transpose(-1, -2).reshape(*zi.shape[:-1], m)
    return zr2, zi2


def rfft_ct(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Real [..., nfft] -> complex64 [..., nfft//2+1] via the packed CT FFT."""
    m1, m2 = factor(nfft // 2)
    x = x.float()
    fr, fi = _ct_fft(x[..., 0::2], x[..., 1::2], m1, m2)
    # Extend with Z[M] = Z[0]; Zc[k] = conj(Z[M-k]).
    fr_ext = torch.cat([fr, fr[..., :1]], dim=-1)
    fi_ext = torch.cat([fi, fi[..., :1]], dim=-1)
    zcr = fr_ext.flip(-1)
    zci = -fi_ext.flip(-1)
    er, ei = _pack_consts_on(nfft, x.device)
    # X = 0.5 (Z + Zc) - 0.5 i e (Z - Zc)
    sr, si = fr_ext + zcr, fi_ext + zci
    dr, di = fr_ext - zcr, fi_ext - zci
    xr = 0.5 * (sr + (er * di + ei * dr))
    xi = 0.5 * (si - (er * dr - ei * di))
    return torch.complex(xr, xi)


def irfft_ct(spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """Complex [..., nfft//2+1] -> real [..., nfft] (1/N included)."""
    m = nfft // 2
    m1, m2 = factor(m)
    xr = spec.real.float()
    xi = spec.imag.float()
    # conj(X[M-k]) for k = 0..M-1 (index M-k runs M..1).
    xmr = xr.flip(-1)[..., :m]
    xmi = -xi.flip(-1)[..., :m]
    xr_k, xi_k = xr[..., :m], xi[..., :m]
    er_full, ei_full = _pack_consts_on(nfft, spec.device)
    er, ei = er_full[:m], ei_full[:m]
    sr, si = xr_k + xmr, xi_k + xmi
    gr, gi = xmr - xr_k, xmi - xi_k
    # D = -i * conj(e) * G = (-ei - i er)(gr + i gi)
    dr = -ei * gr + er * gi
    di = -er * gr - ei * gi
    zr = 0.5 * (sr + dr)
    zi = 0.5 * (si + di)
    # ifft(z) = conj(fft(conj(z))) / M
    fr, fi = _ct_fft(zr, -zi, m1, m2)
    tr, ti = fr / m, -fi / m
    return torch.stack([tr, ti], dim=-1).reshape(*tr.shape[:-1], nfft)


def fft_ct(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Complex FFT [..., nfft] -> [..., nfft] via the two-stage products."""
    m1, m2 = factor(nfft)
    zr, zi = _ct_fft(x.real.float(), x.imag.float(), m1, m2)
    return torch.complex(zr, zi)


def ifft_ct(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Inverse complex FFT (1/N included): conj(fft(conj(x)))/N."""
    m1, m2 = factor(nfft)
    zr, zi = _ct_fft(x.real.float(), -x.imag.float(), m1, m2)
    return torch.complex(zr / nfft, -zi / nfft)
