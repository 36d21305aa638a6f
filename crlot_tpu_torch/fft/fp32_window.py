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
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from ..int8_gemm import _as_signal, windows
from ..ola.kernels import fma_f32

launches = 0  # kernel launches since import (or the caller's reset)


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
