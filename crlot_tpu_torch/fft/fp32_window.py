"""B0 at HIGHEST: the windowed product in IEEE fp32, in a fixed order.

`matmul_backend.hopblock_apply` at `FftPrecision.HIGHEST` on a CUDA tensor
launches `csrc/fp32_window.cu`: C[r, n] = sum_k A[r*lda + k] . W[k, n] over
the overlapping windows of an f32 signal (or the rows of a matrix), each
output one `fmaf` chain over k ascending. A row's result therefore depends
on its window and the kernel alone, not on the row count, the chunk or the
mesh: the f32 streamer's chunked == one-shot and the sharded blocked route's
(2, 2) == (1, 1) hold bit for bit at HIGHEST too (ROADMAP C6), which the
former cuBLAS loop, whose split follows the shape, did not promise.

Its plain version, `gemm_plain`, is the float64 product of the same windows
cast to f32; the kernel stays within `K * 2^-24 * sum_k |a_k||w_k|` of it
per output (`tolerance`). `chain_plain` emulates the kernel's own chain
exactly (one correctly rounded fused multiply-add a step, `ola.kernels.
fma_f32`), so that the card can hold the kernel to it bit for bit at a
small size. On the CPU `hopblock_apply` keeps its m-ordered `torch.matmul`
loop.

B7, the framed windowed rFFT (`stft_cuda`, the same file's
`stft_fp32_window_kernel`): `dispatch.rfft_windowed` on the MATMUL route
launches it for float32 frames on a CUDA card whose samples are
contiguous (`stft_takes`), N even in [16, 1024] with N/2 a product of
2, 3, 5 and 7. It reads the frames in place (any frame and row stride, no
alignment), applies the window, and computes the rFFT as a complex FFT of
the N/2 even and odd sample pairs (mixed-radix Stockham passes,
`stft_radices`) and one split pass, in IEEE fp32, writing the complex64
spectrum. A frame's bins depend on the frame alone, so a stream's
spectrum equals the one-shot's bit for bit. Its plain versions:
`stft_plain`, the float64 DFT of the kernel's own windowed frames (the
kernel stays within `stft_tolerance`), and `stft_fft_plain`, the kernel's
passes, tables and split in torch ops at any precision. `stft_plan` picks
the radices and the frames a CTA from N and the frame stride.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from ..core.consts import design_cache
from ..int8_gemm import _as_signal, windows
from ..ola.kernels import fma_f32

launches = 0  # kernel launches since import (or the caller's reset)
stft_launches = 0  # B7's


def gemm_plain(a, kern, rows=None, lda=None) -> torch.Tensor:
    """The windows (or matrix rows) of `a` times kern [K, N], in float64,
    rounded once to f32."""
    x, rows, lda = _as_signal(a, rows, lda)
    win = windows(x, rows, lda, kern.shape[0])
    return torch.matmul(win.double(), kern.double()).float()


def chain_plain(a, kern, rows=None, lda=None) -> torch.Tensor:
    """The kernel's arithmetic exactly: acc = fmaf(a_k, w_k, acc) for k = 0
    .. K-1 from 0.0f, every output at once (K steps of elementwise ops)."""
    x, rows, lda = _as_signal(a, rows, lda)
    win = windows(x, rows, lda, kern.shape[0]).float()
    acc = torch.zeros(win.shape[:-1] + (kern.shape[1],), dtype=torch.float32,
                      device=win.device)
    for k in range(kern.shape[0]):
        acc = fma_f32(win[..., k : k + 1], kern[k].double(), acc)
    return acc


def tolerance(a, kern, rows=None, lda=None) -> torch.Tensor:
    """K * 2^-24 * sum_k |a_k||w_k| per output: the bound of one f32 chain
    of K fused multiply-adds against the exact sum."""
    x, rows, lda = _as_signal(a, rows, lda)
    win = windows(x, rows, lda, kern.shape[0])
    scale = torch.matmul(win.double().abs(), kern.double().abs())
    return scale * (kern.shape[0] * 2.0 ** -24)


def gemm_cuda(a, kern, rows=None, lda=None) -> torch.Tensor:
    """Launch the fp32 window kernel: f32 A (a matrix [..., M, K], or with
    `rows` and `lda` the windows of a signal [..., L]) times kern [K, N] ->
    f32 [..., rows, N]."""
    global launches
    x, rows, lda = _as_signal(a, rows, lda)
    cuda_build.require_cuda("B0 fp32", x, kern)
    k, n = kern.shape
    if x.dtype != torch.float32 or kern.dtype != torch.float32:
        raise ValueError(f"B0 fp32 takes f32, got {x.dtype}, {kern.dtype}")
    if not x.is_contiguous() or not kern.is_contiguous():
        raise ValueError("B0 fp32 takes a contiguous signal and kernel")
    windows(x, rows, lda, k)  # raises if the rows overrun the signal
    lead = x.shape[:-1]
    batch = int(np.prod(lead)) if lead else 1
    length = x.shape[-1]
    if (lda % 4 or k % 4 or n % 4 or (batch > 1 and length % 4)
            or x.data_ptr() % 16 or kern.data_ptr() % 16):
        raise ValueError(f"B0 fp32: lda {lda}, K {k}, N {n} and the signal "
                         f"length {length} must be multiples of 4, the "
                         f"operands 16-byte aligned")
    out = torch.empty(lead + (rows, n), dtype=torch.float32, device=x.device)
    cuda_build.launch("crlot_fp32_window", x.device, x.data_ptr(), lda,
                      length, kern.data_ptr(), k, n, out.data_ptr(), rows,
                      batch)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# B7: the framed windowed rFFT.
# ---------------------------------------------------------------------------

MIN_STFT_N, MAX_STFT_N = 16, 1024
STFT_RADICES = (2, 3, 4, 5, 7, 8)  # csrc's `stft_pass` instances
_STFT_WARPS = 8  # csrc's kFWarps: a frame at a time a warp
_STFT_MAX_TM = 64
_STFT_SMEM_BUDGET = 56 * 1024  # four CTAs an SM where it fits, else two


_TAKES = (f"an even N in [{MIN_STFT_N}, {MAX_STFT_N}] whose half is a "
          f"product of 2, 3, 5 and 7")


def stft_radices(nfft: int):
    """B7's passes at N = nfft, first to last, whose product is M = N/2:
    the odd factors 7, 5, 3, then the power of two as 8s after a 2 or a
    4; None where B7 does not take N."""
    if nfft % 2 or not MIN_STFT_N <= nfft <= MAX_STFT_N:
        return None
    odd, r = [], nfft // 2
    for p in (7, 5, 3):
        while r % p == 0:
            odd.append(p)
            r //= p
    if r & (r - 1):
        return None
    bits = r.bit_length() - 1
    pw = [8] * (bits // 3)
    if bits % 3:
        pw.insert(0, 1 << (bits % 3))
    return tuple(odd + pw)


def stft_takes(device, dtype, last_stride: int, nfft: int) -> bool:
    """Whether B7 takes frames on `device` of `dtype` whose samples lie
    `last_stride` apart, at N = nfft."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and last_stride == 1 and stft_radices(nfft) is not None)


def _padded(m: int) -> int:
    """csrc's `pad2`: a warp's buffer of m complex, one slot skipped every
    16 (conflict-free strided stores)."""
    return m + (m - 1) // 16 + 1


class StftPlan(NamedTuple):
    """B7's launch: the radices packed 4 bits a pass, first pass lowest;
    the frames a CTA; its dynamic shared memory in bytes (the span, the
    window, the two tables, two buffers a warp)."""

    radices: int
    tm: int
    smem_bytes: int


def _stft_smem(nfft: int, hop: int, tm: int) -> int:
    m = nfft // 2
    span = (tm - 1) * min(hop, nfft) + nfft
    return (4 * (span + nfft) + 8 * (2 * m + 1)
            + 8 * 2 * _STFT_WARPS * _padded(m))


@design_cache(64)
def stft_plan(nfft: int, hop: int) -> StftPlan:
    """B7's launch at N = nfft and frames `hop` samples apart: the most
    frames a CTA (a multiple of the warps, at most 64) whose shared memory
    leaves four CTAs an SM, else two (from N 1024, H 256 up), else 8."""
    radices = stft_radices(nfft)
    if radices is None:
        raise ValueError(f"B7 takes {_TAKES}, got {nfft}")
    tm, budget = _STFT_WARPS, _STFT_SMEM_BUDGET
    if _stft_smem(nfft, hop, tm) > budget:
        budget *= 2
    while (tm + _STFT_WARPS <= _STFT_MAX_TM and _stft_smem(
            nfft, hop, tm + _STFT_WARPS) <= budget):
        tm += _STFT_WARPS
    code = sum(r << (4 * i) for i, r in enumerate(radices))
    return StftPlan(code, tm, _stft_smem(nfft, hop, tm))


def _unit_roots(count: int, period: int) -> np.ndarray:
    """exp(-2 pi i t / period) for t < count, float64 [count, 2], exact at
    the quarter turns."""
    t = np.arange(count)
    ang = 2.0 * np.pi * t / period
    roots = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    quarter = (4 * t) % period == 0
    q = (4 * t[quarter]) // period % 4
    roots[quarter] = np.array([[1, 0], [0, -1], [-1, 0], [0, 1]])[q]
    return roots


@design_cache(None)
def _stft_tables(nfft: int) -> np.ndarray:
    """float32 [2M + 1, 2], M = N/2: the passes' twiddles exp(-2 pi i t /
    M), t < M, then the split's exp(-2 pi i k / N), k <= M."""
    m = nfft // 2
    return np.concatenate([_unit_roots(m, m), _unit_roots(m + 1, nfft)]
                          ).astype(np.float32)


@design_cache(16)
def stft_tables_on(nfft: int, device: torch.device) -> torch.Tensor:
    """`_stft_tables` on `device`, uploaded once."""
    return torch.from_numpy(_stft_tables(nfft)).to(device)


def _stft_check(frames: torch.Tensor, nfft: int) -> None:
    if frames.dtype != torch.float32:
        raise ValueError(f"B7 takes float32 frames, got {frames.dtype}")
    if stft_radices(nfft) is None:
        raise ValueError(f"B7 takes {_TAKES}, got {nfft}")
    if frames.ndim < 1 or frames.shape[-1] != nfft:
        raise ValueError(f"B7 takes frames [..., {nfft}], got "
                         f"{tuple(frames.shape)}")
    if frames.stride(-1) != 1:
        raise ValueError(f"B7 reads a frame's samples contiguous, got a "
                         f"stride of {frames.stride(-1)}")


def _as_rows(frames: torch.Tensor) -> torch.Tensor:
    """[..., F, N] -> [R, F, N], a view where the leading axes merge (the
    frames stay in place), else a copy."""
    if frames.ndim == 1:
        return frames.unsqueeze(0).unsqueeze(0)
    if frames.ndim == 2:
        return frames.unsqueeze(0)
    shape = (int(np.prod(frames.shape[:-2])),) + frames.shape[-2:]
    try:
        return frames.view(shape)
    except RuntimeError:
        return frames.reshape(shape)


def stft_cuda(frames: torch.Tensor, nfft: int,
              window: torch.Tensor) -> torch.Tensor:
    """Launch B7: float32 frames [..., F, N] (a frame's samples contiguous,
    frames and rows at any stride: the `unfold` view of a signal is read
    in place) times the window [N] -> complex64 [..., F, N/2 + 1]."""
    global stft_launches
    _stft_check(frames, nfft)
    cuda_build.require_cuda("B7", frames, window)
    if window.dtype != torch.float32 or window.shape != (nfft,):
        raise ValueError(f"B7 takes a float32 window [{nfft}], got "
                         f"{window.dtype} {tuple(window.shape)}")
    window = window.contiguous()
    x = _as_rows(frames)
    rows, f = x.shape[0], x.shape[1]
    out = torch.empty(frames.shape[:-1] + (nfft // 2 + 1,),
                      dtype=torch.complex64, device=x.device)
    if rows == 0 or f == 0:
        return out
    hop = x.stride(1) if f > 1 else nfft
    row_stride = x.stride(0) if rows > 1 else 0
    plan = stft_plan(nfft, hop)
    tables = stft_tables_on(nfft, x.device)
    cuda_build.launch("crlot_stft_fp32_window", x.device, x.data_ptr(),
                      row_stride, hop, nfft, f, rows, window.data_ptr(),
                      tables.data_ptr(), torch.view_as_real(out).data_ptr(),
                      *plan)
    stft_launches += 1
    return out


def _windowed(frames, nfft: int, window) -> torch.Tensor:
    """The kernel's windowed frames: the float32 products w[n] x[n]."""
    w = window.to(frames.device, torch.float32)
    return frames.float() * w


def stft_plain(frames, nfft: int, window) -> torch.Tensor:
    """The float64 DFT of the kernel's own windowed frames, as products
    with a float64 basis (exact at the quarter turns, so Im is 0 at bins 0
    and N/2): complex128 [..., F, N/2 + 1]."""
    y = _windowed(frames, nfft, window).double()
    t = np.outer(np.arange(nfft), np.arange(nfft // 2 + 1)) % nfft
    basis = torch.from_numpy(_unit_roots(nfft, nfft)[t]).to(y.device)
    return torch.complex(torch.matmul(y, basis[..., 0]),
                         torch.matmul(y, basis[..., 1]))


def stft_tolerance(frames, nfft: int, window) -> torch.Tensor:
    """The bound of B7's error in each output's real and imaginary part
    (the real and imaginary parts of a complex128 [..., F, 1]): (the sum
    of the radices + 8) 2^-24 sqrt(N) ||y||_2 of the frame's windowed
    samples y. An R-point pass of direct sums adds at most about R
    roundings of the spectrum's 2-norm, sqrt(N) ||y||_2; the window's
    product, the twiddles and the split a few more."""
    y = _windowed(frames, nfft, window).double()
    k = (sum(stft_radices(nfft)) + 8) * 2.0 ** -24 * math.sqrt(nfft)
    t = torch.linalg.vector_norm(y, dim=-1, keepdim=True) * k
    return torch.complex(t, t)


def stft_fft_plain(frames, nfft: int, window,
                   dtype=torch.float64) -> torch.Tensor:
    """B7's algorithm in torch ops, at the precision of `dtype`: the
    windowed frames' even and odd samples as M = N/2 complex points, the
    Stockham passes of `stft_radices` with `_stft_tables`' twiddles (each
    an R-point DFT of the R inputs a stride of M/R apart, twiddled by the
    pass's root), then the split of the M-point spectrum into the N-point
    real one. Complex [..., F, N/2 + 1]."""
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    y = _windowed(frames, nfft, window).to(dtype)
    m = nfft // 2
    tab = torch.from_numpy(_stft_tables(nfft).astype(np.float64))
    tab = torch.complex(tab[:, 0], tab[:, 1]).to(device=y.device, dtype=cdt)
    wm, wn = tab[:m], tab[m:]
    src = torch.complex(y[..., 0::2], y[..., 1::2])
    ns = 1
    for r in stft_radices(nfft):
        q = m // r
        j = torch.arange(q)
        js = j % ns
        v = torch.stack([src[..., j + i * q] * wm[js * i * (m // (ns * r))]
                         for i in range(r)], dim=-2)  # [..., R, q]
        dft = torch.from_numpy(np.exp(-2j * np.pi * np.outer(
            np.arange(r), np.arange(r)) / r)).to(device=y.device, dtype=cdt)
        v = torch.einsum("kr,...rq->...kq", dft, v)
        dst = torch.empty_like(src)
        d = (j // ns) * ns * r + js
        for i in range(r):
            dst[..., d + i * ns] = v[..., i, :]
        src, ns = dst, ns * r
    k = torch.arange(m + 1)
    zk, zc = src[..., k % m], src[..., (m - k) % m].conj()
    a, b = (zk + zc) * 0.5, (zk - zc) * -0.5j
    out = a + wn * b
    out.imag[..., 0] = 0.0
    out.imag[..., m] = 0.0
    return out
