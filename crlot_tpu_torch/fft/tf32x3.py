"""3xTF32, the HIGH tier's products on Hopper's tensor cores, and B0.

The reference reaches its HIGH tier on the TPU with a 3-pass bf16 split on
the MXU. The port's counterpart is 3xTF32 on `wgmma` (`csrc/sm90.cuh`): an
f32 a is split as hi = tf32(a), lo = tf32(a - hi), each rounded to nearest
with ties away from zero (`cvt.rna.tf32.f32`: 10 mantissa bits, the low 13
bits of the f32 zero), so |a - (hi + lo)| <= 2^-21 |a|; a product a.b is
taken as lo.b_hi + hi.b_lo + hi.b_hi, each term exact in f32. TF32 appears
only inside these kernels, by name: `torch.backends.cuda.matmul.allow_tf32`
stays False.

B0 is the blocked round-trip's windowed product (`hopblock_apply`; an XLA
dot in the reference, `crlot_tpu/fft/matmul_backend.py:633`): C[r, n] =
sum_k A[r*lda + k] . Bt[n, k] over overlapping windows of an f32 signal,
mode 8 of `csrc/b6_sm90.cu`. Each output sums its k in ascending stages of
32 (3xTF32 into a fresh accumulator, then an IEEE add into the running
sum), with no split-K, so a row's result does not depend on the row count,
the chunk or the mesh. Its plain version, `gemm_plain`, emulates the split
in torch and sums the three products in f32 with torch's order: the two
agree within a stated bound, not bit for bit (the tensor core's sums are
not IEEE round-to-nearest at each step).

Its callers (`matmul_backend.hopblock_apply`, `roundtrip_composed_matmul`)
take the kernel for a CUDA tensor at HIGH, which launches or raises; a CPU
tensor runs IEEE fp32 at every tier.
"""

from __future__ import annotations

import numpy as np
import torch

from ..int8_gemm import MODE_TF32X3, _as_signal, _check_b, _launch, windows

launches = 0  # B0 kernel launches since import (or the caller's reset)

# |kernel - plain| <= REL_TOL * sum_k |a_k||b_k| for every output of B0:
# both sum the same exact products in f32, in two orders; at K = 2048 the
# measured gap is far below it (`chip_smoke.py` prints it).
REL_TOL = 2.0 ** -18


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: integer
    operations on the f32 bits (add half an ulp of TF32 to the magnitude,
    clear the low 13 bits)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32).reshape(x.shape)


def split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), both f32 tensors."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_round_np(a: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_np(a: np.ndarray):
    """The host design code's split of an f32 array: (hi, lo), f32."""
    a = np.ascontiguousarray(a, np.float32)
    hi = tf32_round_np(a)
    return hi, tf32_round_np(a - hi)


def split_t(kern) -> tuple:
    """A [K, N] kernel as B0 takes it: its transpose [N, K] (K-major, as
    `wgmma` takes TF32 operands), split into TF32 (hi, lo). numpy in, numpy
    out; a tensor gives tensors on its device."""
    if isinstance(kern, np.ndarray):
        return split_np(np.ascontiguousarray(kern.T))
    return tuple(t.contiguous() for t in split(kern.T))


def gemm_plain(a, bt_hi, bt_lo, rows=None, lda=None) -> torch.Tensor:
    """B0's function in torch: the windows (or matrix rows) of `a`, split on
    the fly, times the TF32 halves of Bt [N, K]: (lo.b_hi + hi.b_lo) +
    hi.b_hi, in f32."""
    x, rows, lda = _as_signal(a, rows, lda)
    hi, lo = split(windows(x, rows, lda, bt_hi.shape[1]))
    return ((torch.matmul(lo, bt_hi.T) + torch.matmul(hi, bt_lo.T))
            + torch.matmul(hi, bt_hi.T))


def gemm_cuda(a, bt_hi, bt_lo, rows=None, lda=None) -> torch.Tensor:
    """Launch B0: f32 A (a matrix [..., M, K], or with `rows` and `lda` the
    windows of a signal [..., L]; lda * 4 bytes a multiple of 128 where the
    windows overlap) times Bt's TF32 halves [N, K] -> f32 [..., rows, N]."""
    global launches
    x, rows, lda = _as_signal(a, rows, lda)
    if x.dtype != torch.float32:
        raise ValueError(f"B0 takes f32 A, got {x.dtype}")
    for bt in (bt_hi, bt_lo):
        _check_b("B0", bt, torch.float32, k=bt_hi.shape[1])
    out = _launch("B0", MODE_TF32X3, [x], [bt_hi, bt_lo], rows, lda,
                  torch.float32)
    launches += 1
    return out


def supported(n: int, k: int, lda: int) -> bool:
    """Whether B0's tiles take an [N, K] kernel over windows at stride lda
    (f32): N and K bytes multiples of 64, and overlapping windows at a
    stride of a multiple of 128 bytes."""
    return (n >= 64 and n % 64 == 0 and (4 * k) % 64 == 0
            and (4 * lda) % 16 == 0 and (lda >= k or (4 * lda) % 128 == 0))


def frame_rows(frames: torch.Tensor):
    """(x [B, L] contiguous, rows F, lda) with frame f of batch b at
    x[b, f*lda : f*lda + N], for a frame tensor [..., F, N]: the signal a
    window view (`unfold`) reads, in place, where B0's tiles can read it
    (16-byte aligned; where the frames overlap, a frame stride that
    divides N and is a multiple of 128 bytes), or else the frames made
    contiguous (lda = N)."""
    f, n = frames.shape[-2:]
    fr = frames.reshape((-1, f, n))
    b = fr.shape[0]
    sb, sf, s1 = fr.stride()
    length = (f - 1) * sf + n
    if (s1 == 1 and sf > 0 and (b == 1 or sb == length)
            and fr.data_ptr() % 16 == 0
            and (sf == n or (sf < n and n % sf == 0
                             and (4 * sf) % 128 == 0))):
        return fr.as_strided((b, length), (length, 1)), f, sf
    return fr.contiguous().reshape(b, f * n), f, n
