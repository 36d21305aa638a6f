"""DFT-as-matmul pieces of the round-trip slice, in torch.

Counterpart of the slice's part of `crlot_tpu/fft/matmul_backend.py`:

* the dense [N, N+2] / [N+2, N] DFT bases (odd N: `fft/dispatch.py`'s
  MATMUL route for an odd nfft <= 4096), a window folded in or not;
* the folded (half-size) forward and inverse DFT bases, the packed
  forward / inverse that use them, the complex transforms on them
  (`rfft_folded`, `irfft_folded`, `rfft_windowed_folded`: the tiled cores
  where N % 256 == 0, as the reference's) and the frames-level identity
  `roundtrip_folded_matmul`;
* the composed round-trip basis: for a FIXED per-bin response, frame ->
  spectrum -> response -> frame is one [N, N] matrix;
* the blocked formulation: that map plus the overlap-add folded into a
  hop-block Toeplitz kernel applied straight to the padded signal
  (`hopblock_apply`), with the head/tail blocks recomputed exactly from the
  real boundary frames (`blocked_edge_patch`), and the halo a streaming
  chunk carries to reproduce it (`blocked_chunk_geometry`);
* its plan (`blocked_response`, `blocked_plan`): the response a spectral
  fn resolves to and every design constant of one blocked round-trip
  (geometry, norm fold, edge norms, the kernel and its B0 split on each
  device), the one source of them for the one-shot route, both chunk
  streamers and the mesh program.

The float64 host design code is copied, not imported (the port never
imports the JAX package); the tests hold every array byte-identical to the
reference's. On a CUDA tensor at `FftPrecision.HIGH` (the default; INT8X2
runs every product here as HIGH) the windowed product of `hopblock_apply`
and the scan form's composed product run on B0, 3xTF32 on the tensor cores
with a fixed order per output (`fft/tf32x3.py`); at HIGHEST the windowed
product runs on B0's IEEE fp32 kernel, also in a fixed order
(`fft/fp32_window.py`), and the composed product is a `torch.matmul`; on
the CPU both are IEEE fp32 `torch.matmul`s (TF32 stays off).

The tiled round-trip (`rfft_folded_tiled_parts`,
`irfft_folded_tiled_parts`, `roundtrip_folded_tiled`; `rfft_tiled`,
`irfft_tiled` and the packed-plane converters) is the reference's
lane-aligned layout of the folded bases: an [h, h] core a product and the
(h+1)-th row and column as exact alternating-sign rank-1 borders. Its
products are IEEE fp32 `torch.matmul`s at every tier; `fft/int8_backend.py`
runs the same layout on K11's int8 limb products.

The reference's opt-in formulations, which no pipeline calls: the composed
round-trip as one strided product on the raw signal
(`roundtrip_composed_conv`), the quarter-size bases in their parity-split
layout (`quad_supported`, `rfft_folded_quad_parts`,
`irfft_folded_quad_parts`, `roundtrip_folded_quad`) and the two-product
packed round-trip (`roundtrip_packed_matmul`). They are products the
reference leaves to XLA, not Pallas kernels: at HIGHEST, and on the CPU,
IEEE fp32 (`torch.matmul`, `conv1d` with cuDNN's TF32 off); at HIGH on a
CUDA tensor, B0 (3xTF32) where its tiles take the shape, IEEE fp32
otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core.consts import as_f32, const_on, design_cache
from ..core.types import FftPrecision, StftConfig, float_tier
from ..ola.norm import edge_norm
from ..spectral import resolve_per_bin_response
from ..window.windows import get_window
from . import fp32_window, tf32x3

MAX_MATMUL_NFFT = 4096


@design_cache(None)
def _folded_forward_consts(nfft: int):
    """C [N/2+1, K] (cos rows n = 0..N/2) and S [N/2-1, K] (-sin rows
    n = 1..N/2-1): the DFT rows' symmetry halves the contraction."""
    kk = nfft // 2 + 1
    k = np.arange(kk, dtype=np.float64)
    n_e = np.arange(nfft // 2 + 1, dtype=np.float64)
    n_o = np.arange(1, nfft // 2, dtype=np.float64)
    c = np.cos(2.0 * np.pi * np.outer(n_e, k) / nfft)
    s = -np.sin(2.0 * np.pi * np.outer(n_o, k) / nfft)
    return c.astype(np.float32), s.astype(np.float32)


@design_cache(None)
def _folded_inverse_consts(nfft: int):
    """Cinv [K, N/2+1], Sinv [K, N/2-1], hermitian weights and 1/N
    included: A = Re @ Cinv gives x[0], (x[n]+x[N-n])/2, x[N/2];
    B = Im @ Sinv gives (x[n]-x[N-n])/2 for n = 1..N/2-1."""
    kk = nfft // 2 + 1
    k = np.arange(kk, dtype=np.float64)
    w = np.full(kk, 2.0)
    w[0] = 1.0
    if nfft % 2 == 0:
        w[-1] = 1.0
    n_e = np.arange(nfft // 2 + 1, dtype=np.float64)
    n_o = np.arange(1, nfft // 2, dtype=np.float64)
    cinv = (w[:, None] * np.cos(2.0 * np.pi * np.outer(k, n_e) / nfft)) / nfft
    sinv = -(w[:, None] * np.sin(2.0 * np.pi * np.outer(k, n_o) / nfft)) / nfft
    return cinv.astype(np.float32), sinv.astype(np.float32)


@design_cache(16)
def folded_consts_on(nfft: int, device: torch.device):
    """(C, S, Cinv, Sinv) as contiguous f32 tensors on `device`."""
    c, s = _folded_forward_consts(nfft)
    cinv, sinv = _folded_inverse_consts(nfft)
    return tuple(torch.from_numpy(a).to(device) for a in (c, s, cinv, sinv))


def _fold_frames(y: torch.Tensor, nfft: int):
    """[..., N] -> even part [..., N/2+1], odd part [..., N/2-1]."""
    h = nfft // 2
    head = y[..., 1:h]
    tail = y[..., h + 1 :].flip(-1)
    even = torch.cat([y[..., :1], head + tail, y[..., h : h + 1]], dim=-1)
    odd = head - tail
    return even, odd


def fold_windowed(x: torch.Tensor, nfft: int, window_f32=None):
    """x [* window] [..., N] -> the folded halves (even [..., N/2+1], odd
    [..., N/2-1]) that the forward products take."""
    y = x.float()
    if window_f32 is not None:
        w = (window_f32.to(x.device, torch.float32)
             if isinstance(window_f32, torch.Tensor)
             else const_on(window_f32, x.device))
        y = y * w
    return _fold_frames(y, nfft)


def rfft_folded_bytes(rows: int, nfft: int) -> int:
    """The bytes `rfft_folded_packed` writes on `rows` float32 frames of
    an even N, from the shape: the windowed frames; the fold's flipped
    tail, sum, even part and difference (`_fold_frames`); the Re and Im
    planes."""
    h = nfft // 2
    return 4 * rows * (nfft + 3 * (h - 1) + (h + 1) + 2 * (h + 1))


def folded_forward(even: torch.Tensor, odd: torch.Tensor, c: torch.Tensor,
                   s: torch.Tensor):
    """The folded halves -> (Re [..., K], Im [..., K]): two half-size
    products on `folded_consts_on`'s C and S."""
    re = torch.matmul(even, c)
    if s.shape[0]:
        im = torch.matmul(odd, s)
    else:
        im = torch.zeros_like(re)
    return re, im


def folded_inverse(re: torch.Tensor, im: torch.Tensor, cinv: torch.Tensor,
                   sinv: torch.Tensor) -> torch.Tensor:
    """(Re, Im) [..., K] -> real [..., N] (1/N included): two half-size
    products on `folded_consts_on`'s Cinv and Sinv, and the unfold."""
    a = torch.matmul(re.float(), cinv)
    h = cinv.shape[1] - 1
    if sinv.shape[1]:
        b = torch.matmul(im.float(), sinv)
        mid = a[..., 1:h]
        return torch.cat(
            [a[..., :1], mid + b, a[..., h : h + 1], (mid - b).flip(-1)],
            dim=-1,
        )
    return a  # nfft == 2: output is [x0, x1] = [A0, A1]


def rfft_folded_packed(x: torch.Tensor, nfft: int, window_f32=None):
    """rfft(x [* window]) -> (Re [..., K], Im [..., K]) via two half-size
    products."""
    c, s, _, _ = folded_consts_on(nfft, x.device)
    return folded_forward(*fold_windowed(x, nfft, window_f32), c, s)


def irfft_folded_parts(re: torch.Tensor, im: torch.Tensor,
                       nfft: int) -> torch.Tensor:
    """(Re, Im) [..., K] -> real [..., N] (1/N included): two half-size
    products and an unfold."""
    _, _, cinv, sinv = folded_consts_on(nfft, re.device)
    return folded_inverse(re, im, cinv, sinv)


@design_cache(None)
def _forward_basis(nfft: int) -> np.ndarray:
    """[N, 2K] with columns [cos | -sin]: x @ B -> [Re(X) | Im(X)]."""
    k = np.arange(nfft // 2 + 1, dtype=np.float64)
    n = np.arange(nfft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@design_cache(None)
def _inverse_basis(nfft: int) -> np.ndarray:
    """[2K, N]: [Re(X) | Im(X)] @ B -> x, with hermitian weights and 1/N."""
    kk = nfft // 2 + 1
    k = np.arange(kk, dtype=np.float64)
    n = np.arange(nfft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, n) / nfft
    w = np.full(kk, 2.0)
    w[0] = 1.0
    if nfft % 2 == 0:
        w[-1] = 1.0
    cos_part = (w[:, None] * np.cos(ang)) / nfft
    sin_part = -(w[:, None] * np.sin(ang)) / nfft
    return np.concatenate([cos_part, sin_part], axis=0).astype(np.float32)


@design_cache(None)
def _windowed_forward_basis(nfft: int, window_bytes: bytes) -> np.ndarray:
    """The forward basis with the analysis window folded in:
    (x * w) @ B == x @ (diag(w) @ B)."""
    w = np.frombuffer(window_bytes, dtype=np.float64)
    assert len(w) == nfft
    return (w[:, None] * _forward_basis(nfft).astype(np.float64)).astype(
        np.float32
    )


@design_cache(8)
def _dense_basis_on(nfft: int, window_bytes, inverse: bool,
                    device: torch.device) -> torch.Tensor:
    if inverse:
        b = _inverse_basis(nfft)
    elif window_bytes is None:
        b = _forward_basis(nfft)
    else:
        b = _windowed_forward_basis(nfft, window_bytes)
    return torch.from_numpy(b).to(device)


def rfft_matmul(x: torch.Tensor, nfft: int, window_f64=None) -> torch.Tensor:
    """rfft(x [* window]) as one product: real [..., nfft] -> complex64
    [..., nfft//2+1]. IEEE fp32 (`torch.matmul`, TF32 off)."""
    wb = None if window_f64 is None else _bytes(window_f64, np.float64)
    flat = torch.matmul(x.float(), _dense_basis_on(nfft, wb, False, x.device))
    kk = nfft // 2 + 1
    return torch.complex(flat[..., :kk], flat[..., kk:])


def rfft_windowed_matmul(x: torch.Tensor, nfft: int,
                         window_f64: np.ndarray) -> torch.Tensor:
    """rfft(x * window) as one product on unwindowed frames, the window
    folded into the dense basis."""
    return rfft_matmul(x, nfft, window_f64)


def irfft_matmul(spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """Complex [..., nfft//2+1] -> real [..., nfft] (1/N included) as one
    product."""
    ri = torch.cat([spec.real, spec.imag], dim=-1).float()
    return torch.matmul(ri, _dense_basis_on(nfft, None, True, spec.device))


@design_cache(None)
def _composed_roundtrip_basis(
    nfft: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
) -> np.ndarray:
    """[N, N] M = diag(w_a) . Re(B_f . diag(g) . B_i) [. diag(w_s)], built
    in f64 as the windowed circulant M[i, j] = w[i] * h[(j - i) mod N] with
    h = irfft(g)."""
    kk = nfft // 2 + 1
    w = np.frombuffer(awin_bytes, dtype=np.float64)
    g = np.frombuffer(response_bytes, dtype=np.complex128)
    assert len(w) == nfft and len(g) == kk
    h = np.fft.irfft(g, n=nfft)
    idx = (np.arange(nfft)[None, :] - np.arange(nfft)[:, None]) % nfft
    m = w[:, None] * h[idx]
    if swin_bytes is not None:
        ws = np.frombuffer(swin_bytes, dtype=np.float64)
        m = m * ws[None, :]
    return m.astype(np.float32)


def _bytes(a, dtype) -> bytes:
    return np.ascontiguousarray(a, dtype).tobytes()


@design_cache(8)
def _composed_bt_on(nfft, awin_bytes, swin_bytes, response_bytes,
                    device: torch.device):
    """The composed basis as B0 takes it: transposed, TF32 hi and lo."""
    m = _composed_roundtrip_basis(nfft, awin_bytes, swin_bytes, response_bytes)
    return tuple(torch.from_numpy(a).to(device) for a in tf32x3.split_t(m))


def roundtrip_composed_matmul(
    frames: torch.Tensor,
    nfft: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
    precision=FftPrecision.HIGH,
) -> torch.Tensor:
    """irfft(rfft(frames * w) * g) [* w_s] as one [F, N] @ [N, N] product.
    At HIGH a CUDA tensor runs it on B0 over the frame rows in place
    (`tf32x3.frame_rows`) where B0's tiles take N (a multiple of 64); at
    HIGHEST, on the CPU and for other N, it is a `torch.matmul`."""
    keys = (
        nfft,
        _bytes(analysis_window_f64, np.float64),
        None if synthesis_window_f64 is None
        else _bytes(synthesis_window_f64, np.float64),
        _bytes(per_bin_response, np.complex128),
    )
    if (frames.device.type != "cpu"
            and float_tier(precision) == FftPrecision.HIGH
            and tf32x3.supported(nfft, nfft, nfft)):
        x, rows, lda = tf32x3.frame_rows(frames.float())
        out = tf32x3.gemm_cuda(x, *_composed_bt_on(*keys, frames.device),
                               rows=rows, lda=lda)
        return out.reshape(frames.shape[:-1] + (nfft,))
    m = _composed_roundtrip_basis(*keys)
    return torch.matmul(frames.float(), torch.from_numpy(m).to(frames.device))


@design_cache(None)
def _composed_block_kernel(
    nfft: int,
    hop: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
):
    """[L, hop] block-Toeplitz kernel folding the composed frame map and the
    OLA (L = (R-1)*hop + nfft):
    K[tau, s] = sum_r M[tau - (R-1)*hop + r*hop, r*hop + s]."""
    r_count = nfft // hop
    m = _composed_roundtrip_basis(
        nfft, awin_bytes, swin_bytes, response_bytes
    ).astype(np.float64)
    ll = (r_count - 1) * hop + nfft
    k = np.zeros((ll, hop), np.float64)
    for r in range(r_count):
        rows = np.arange(nfft)
        k[rows + (r_count - 1 - r) * hop, :] += m[:, r * hop : (r + 1) * hop]
    return np.ascontiguousarray(k.astype(np.float32))


def blocked_group_for(nfft: int, hop: int):
    """Group size G (output hop-blocks per product row) of the blocked
    kernel, or None when the blocked formulation does not apply. Kept
    identical to the reference's choice (G*hop a multiple of 128 and
    G | 2(R-1); G=2 at H=256) so the two packages run the same kernel; a
    Hopper-chosen G waits for measurement."""
    if not (
        nfft <= MAX_MATMUL_NFFT
        and 0 < hop < nfft
        and nfft % hop == 0
        and nfft // hop >= 2
    ):
        return None
    r = nfft // hop
    for g in range(2, 2 * (r - 1) + 1):
        if (g * hop) % 128 == 0 and (2 * (r - 1)) % g == 0:
            return g
    return None


def composed_block_supported(nfft: int, hop: int) -> bool:
    return blocked_group_for(nfft, hop) is not None


@design_cache(None)
def _composed_block_kernel_grouped(
    nfft: int,
    hop: int,
    group: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
):
    """K for GROUP consecutive output hop-blocks per row, block-banded:
    K_G[tau, g*hop + s] = K1[tau - g*hop, s]."""
    k1 = _composed_block_kernel(
        nfft, hop, awin_bytes, swin_bytes, response_bytes
    ).astype(np.float64)
    ll = k1.shape[0]
    kg = np.zeros((ll + (group - 1) * hop, group * hop), np.float64)
    for g in range(group):
        kg[g * hop : g * hop + ll, g * hop : (g + 1) * hop] = k1
    return np.ascontiguousarray(kg.astype(np.float32))


def blocked_runtime_kernel(
    nfft: int,
    hop: int,
    group: int,
    awin_bytes: bytes,
    swin_bytes,
    response_kern_bytes: bytes,
):
    """(kern_f32 [mg*G*hop, G*hop], mg): the grouped kernel zero-row-padded
    to a whole number of G*hop tiles."""
    gh = group * hop
    kern = _composed_block_kernel_grouped(
        nfft, hop, group, awin_bytes, swin_bytes, response_kern_bytes
    )
    mg = -(-kern.shape[0] // gh)
    if mg * gh != kern.shape[0]:
        kern = np.pad(kern, ((0, mg * gh - kern.shape[0]), (0, 0)))
    return kern, mg


@design_cache(8)
def _composed_basis_on(nfft, awin_bytes, swin_bytes, response_bytes,
                       device: torch.device) -> torch.Tensor:
    m = _composed_roundtrip_basis(nfft, awin_bytes, swin_bytes, response_bytes)
    return torch.from_numpy(m).to(device)


def hopblock_extent(n_out: int, block: int, mg: int) -> tuple:
    """(nb, length): the output blocks of a hop-block product of `n_out`
    samples, and the length of the extended signal that its nb windows of
    `mg` blocks read, the look-back halo included."""
    nb = -(-n_out // block)
    return nb, (nb - 1 + mg) * block


def _hopblock_ext(x, kern, block, n_out, left):
    """(x padded with `left` zeros and enough right zeros, mg, nb)."""
    assert kern.shape[0] % block == 0, (
        f"kernel height {kern.shape[0]} must be a multiple of the "
        f"block size {block}"
    )
    mg = kern.shape[0] // block
    nb, length = hopblock_extent(n_out, block, mg)
    right = length - left - x.shape[-1]
    return torch.nn.functional.pad(x, (left, right)), mg, nb


def hopblock_apply(
    x: torch.Tensor,  # [..., T] signal
    kern: torch.Tensor,  # [M*block, block] Toeplitz-laid kernel, same device
    block: int,
    n_out: int,
    left: int,
    precision=FftPrecision.HIGH,
    bt=None,
) -> torch.Tensor:
    """Hop-block Toeplitz product: pad x with `left` zeros (the look-back
    halo) and enough right zeros, and take each output block as one window
    of M*block samples times the kernel (`hopblock_product`). Returns
    [..., n_out]."""
    x_ext, _, _ = _hopblock_ext(x, kern, block, n_out, left)
    return hopblock_product(x_ext, kern, block, precision, bt)[..., :n_out]


def hopblock_product(
    x_ext: torch.Tensor,  # [..., (nb - 1 + M)*block] extended signal
    kern: torch.Tensor,  # [M*block, block] Toeplitz-laid kernel, same device
    block: int,
    precision=FftPrecision.HIGH,
    bt=None,
) -> torch.Tensor:
    """`hopblock_apply`'s product on a signal already extended by its
    halo and right zeros (`hopblock_extent`): output block b is the window
    x_ext[..., b*block : (b + M)*block] times the kernel. Returns
    [..., nb*block].

    On a CUDA tensor, one launch over the overlapping windows (lda =
    block), each output summed in a fixed order: at HIGH (and INT8X2) B0 in
    3xTF32, with `bt` = the kernel's (hi, lo) from the host design code
    (split here when not given); at HIGHEST B0's IEEE fp32 kernel
    (`fp32_window`). On the CPU: the extended signal viewed as ONE
    contiguous [..., B, block] tensor and the M products of its shifted row
    slices (each a contiguous view, no im2col copy) accumulated in
    ascending m order, in IEEE fp32."""
    mg = kern.shape[0] // block
    nb = x_ext.shape[-1] // block - mg + 1
    if x_ext.device.type != "cpu":
        if float_tier(precision) == FftPrecision.HIGH:
            bt_hi, bt_lo = tf32x3.split_t(kern) if bt is None else bt
            out = tf32x3.gemm_cuda(x_ext.contiguous(), bt_hi, bt_lo,
                                   rows=nb, lda=block)
        else:
            out = fp32_window.gemm_cuda(x_ext.contiguous(), kern, rows=nb,
                                        lda=block)
        return out.reshape(out.shape[:-2] + (nb * block,))
    blocks = x_ext.reshape(x_ext.shape[:-1] + (-1, block))
    acc = None
    for m in range(mg):
        term = torch.matmul(
            blocks[..., m : m + nb, :], kern[m * block : (m + 1) * block, :]
        )
        acc = term if acc is None else acc + term
    return acc.reshape(acc.shape[:-2] + (nb * block,))


def hopblock_apply_tf32x3_plain(x, kern, block, n_out, left) -> torch.Tensor:
    """`hopblock_apply`'s B0 route in torch: the same windows, the kernel's
    TF32 halves and the split emulated (`tf32x3.gemm_plain`), summed in f32.
    The kernel agrees with it within `tf32x3.REL_TOL` of sum |x||k|."""
    x_ext, mg, nb = _hopblock_ext(x, kern, block, n_out, left)
    out = tf32x3.gemm_plain(x_ext, *tf32x3.split_t(kern), rows=nb, lda=block)
    return out.reshape(out.shape[:-2] + (nb * block,))[..., :n_out]


def blocked_chunk_geometry(nfft: int, hop: int, group=None) -> dict:
    """Context a halo-extended streaming chunk must carry so its hop-block
    Toeplitz rows read exactly what the one-shot's rows read: output block
    bg consumes input [bg*gh - left_ctx, bg*gh - left_ctx + mg*gh). With
    G | 2(R-1) (`blocked_group_for`) right_ctx == N - hop."""
    if group is None:
        group = blocked_group_for(nfft, hop)
        assert group is not None, (nfft, hop)
    r_count = nfft // hop
    gh = group * hop
    edge = (r_count - 1) * hop
    l_g = edge + nfft + (group - 1) * hop
    mg = -(-l_g // gh)
    return {
        "group": group,
        "gh": gh,
        "mg": mg,
        "left_ctx": edge,
        "right_ctx": mg * gh - gh - edge,
        "edge": edge,
    }


def blocked_patch_span(nfft: int, hop: int) -> int:
    """Input samples an edge patch reads: (R-2)*hop + nfft."""
    return (nfft // hop - 2) * hop + nfft


def blocked_edge_patch(
    x_region: torch.Tensor,  # [..., (R-2)*hop + nfft] head/tail samples
    nfft: int,
    hop: int,
    awin_bytes: bytes,
    swin_bytes,
    response_bytes: bytes,
    side: str = "head",
    precision=FftPrecision.HIGH,
    fixed_order: bool = False,
) -> torch.Tensor:
    """UN-normalized local OLA of the R-1 real boundary frames at the
    stream head (or tail), [..., (R-1)*hop]: the exact values of the blocks
    where the Toeplitz product sees phantom frames. Frames are summed in
    ascending order.

    The frames' product by the composed basis is a `torch.matmul`, unless
    `fixed_order` asks for bits that do not depend on how many channels
    share the call (a channel-sharded mesh patches its edges as one shard
    does): then a CUDA tensor runs it in a fixed order per output, the
    frames read in place, on B0 at HIGH (and INT8X2) and on B0's fp32
    kernel at HIGHEST. (cuBLAS sums differently at 64 and 128 channels,
    and the edge samples' near-zero norm made that 0.75 apart, ROADMAP
    C15; on one channel count it is the same sum every call, and about
    three times faster than B0 on these few rows.)"""
    r_count = nfft // hop
    edge = (r_count - 1) * hop
    keys = (nfft, awin_bytes, swin_bytes, response_bytes)
    dev = x_region.device
    if (fixed_order and dev.type != "cpu"
            and tf32x3.supported(nfft, nfft, nfft)):
        frames = x_region.float().contiguous().unfold(-1, nfft, hop)[
            ..., : r_count - 1, :]
        x, rows, lda = tf32x3.frame_rows(frames)
        if float_tier(precision) == FftPrecision.HIGH:
            of = tf32x3.gemm_cuda(x, *_composed_bt_on(*keys, dev), rows=rows,
                                  lda=lda)
        else:
            of = fp32_window.gemm_cuda(x, _composed_basis_on(*keys, dev),
                                       rows=rows, lda=lda)
        of = of.reshape(frames.shape)
    else:
        frames = torch.stack(
            [x_region[..., f * hop : f * hop + nfft]
             for f in range(r_count - 1)],
            dim=-2,
        )  # [..., R-1, N]
        of = torch.matmul(frames, _composed_basis_on(*keys, dev))
    span_l = (r_count - 2) * hop + nfft
    acc_l = of.new_zeros(of.shape[:-2] + (span_l,))
    for f in range(r_count - 1):
        acc_l[..., f * hop : f * hop + nfft] += of[..., f, :]
    return acc_l[..., :edge] if side == "head" else acc_l[..., span_l - edge :]


def roundtrip_composed_blocked(
    padded: torch.Tensor,  # [..., T_pad] padded signal
    nfft: int,
    hop: int,
    num_frames: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
    group: int = 1,
    norm_fold=None,
    precision=FftPrecision.HIGH,
) -> torch.Tensor:
    """Composed per-bin round-trip INCLUDING the overlap-add as hop-block
    products on the raw signal, length (num_frames-1)*hop + nfft, for any
    window pair and group; the windowed product at `precision`
    (`hopblock_apply`). `round_trip`'s "blocked" route runs the same steps
    on a `blocked_plan`'s constants (`pipeline.blocked_composed_round_trip`).

    Without `norm_fold` the result is the un-normalized OLA sum. With
    `norm_fold = (norm_c, head_norm, tail_norm)` -- the constant interior
    COLA norm and the eps-clamped f32 norms of the (R-1)*hop edge samples at
    each end, on the signal's device -- 1/norm_c is folded into the kernel
    at f64 design time and only the edge samples divide by their true
    norm."""
    assert composed_block_supported(nfft, hop)
    assert num_frames >= 2 * (nfft // hop - 1)
    assert group >= 1
    full = (num_frames - 1) * hop + nfft
    edge = (nfft // hop - 1) * hop
    wb = _bytes(analysis_window_f64, np.float64)
    sb = (None if synthesis_window_f64 is None
          else _bytes(synthesis_window_f64, np.float64))
    response = np.asarray(per_bin_response, np.complex128)
    rb = _bytes(response, np.complex128)
    kern, _ = blocked_runtime_kernel(
        nfft, hop, group, wb, sb,
        rb if norm_fold is None else _bytes(response / norm_fold[0],
                                            np.complex128))
    x = padded[..., :full].float()
    out = hopblock_apply(x, torch.from_numpy(kern).to(x.device), group * hop,
                         full, edge, precision)
    span_p = blocked_patch_span(nfft, hop)
    head = blocked_edge_patch(x[..., :span_p], nfft, hop, wb, sb, rb, "head")
    tail = blocked_edge_patch(x[..., full - span_p :], nfft, hop, wb, sb, rb,
                              "tail")
    if norm_fold is not None:
        head, tail = head / norm_fold[1], tail / norm_fold[2]
    return torch.cat([head, out[..., edge : full - edge], tail], dim=-1)


# --- the blocked plan --------------------------------------------------------


def blocked_response(cfg: StftConfig, spectral_fn) -> Optional[np.ndarray]:
    """The per-bin response (complex128 [N/2+1]) the blocked formulation
    applies for `spectral_fn` at cfg's frame size: ones for the identity,
    the fn's fixed per-bin response, or None where there is none (a
    nonlinear fn, or N above MAX_MATMUL_NFFT). The one resolution of the
    fn for a round-trip call, a chunk stream or a mesh stream."""
    n = cfg.frame_size
    if n > MAX_MATMUL_NFFT:
        return None
    if spectral_fn is None:
        return np.ones(n // 2 + 1, np.complex128)
    return resolve_per_bin_response(spectral_fn, n)


@dataclass(frozen=True)
class BlockedPlan:
    """The design of one blocked (hop-block Toeplitz) round-trip, for every
    caller: the one-shot route, both chunk streamers and the mesh program.
    Equal (and hashed) by its key: N, hop, the f64 analysis window's bytes,
    whether the window also synthesizes, eps and the response's bytes.

    The geometry is `blocked_chunk_geometry`'s with `blocked_group_for`'s
    group G (its left context is `edge`). Where the interior COLA norm is
    constant (to 1e-9 relative) 1/norm_c folds into the kernel at f64
    design time (`rb_kern` is the response over norm_c, `tile` None);
    otherwise the kernel keeps the raw response and the interior divides
    by `tile`, the eps-clamped [hop] period of the norm. `head_norm` and
    `tail_norm` are the eps-clamped f32 norms of the (R-1)*hop edge
    samples at each end. None of these depends on the frame count
    (`ola.norm.edge_norm` adds frames in ascending order), so one plan
    serves every count >= 2(R-1)."""

    nfft: int
    hop: int
    wb: bytes
    synthesis: bool
    eps: float
    rb: bytes
    group: int = field(compare=False)
    gh: int = field(compare=False)
    mg: int = field(compare=False)
    edge: int = field(compare=False)
    right_ctx: int = field(compare=False)
    patch_span: int = field(compare=False)
    rb_kern: bytes = field(compare=False)
    norm_c: Optional[float] = field(compare=False)
    tile: Optional[np.ndarray] = field(compare=False)
    head_norm: np.ndarray = field(compare=False)
    tail_norm: np.ndarray = field(compare=False)

    @property
    def sb(self):
        """The synthesis window's bytes, or None."""
        return self.wb if self.synthesis else None

    def kernel(self, folded: bool = True) -> np.ndarray:
        """The f32 runtime kernel [mg*G*hop, G*hop] of the folded response
        (`rb_kern`) or of the raw one."""
        return blocked_runtime_kernel(self.nfft, self.hop, self.group,
                                      self.wb, self.sb,
                                      self.rb_kern if folded else self.rb)[0]

    def operands(self, device, precision, folded: bool = True) -> tuple:
        """(kern, bt): the kernel (`kernel(folded)`) on `device`, and where
        `hopblock_apply` runs it on B0 in 3xTF32 (a card at HIGH) its TF32
        (hi, lo) halves from the host design code, else None. Built once a
        device."""
        folded = folded and self.norm_c is not None  # else the same kernel
        device = torch.device(device)
        bt = (_plan_bt_on(self, folded, device) if device.type != "cpu"
              and float_tier(precision) == FftPrecision.HIGH else None)
        return _plan_kernel_on(self, folded, device), bt

    def patch(self, x_region: torch.Tensor, side: str,
              precision=FftPrecision.HIGH, fixed_order: bool = False):
        """`blocked_edge_patch` of the raw response: the UN-normalized head
        (or tail) samples of a [..., patch_span] region."""
        return blocked_edge_patch(x_region, self.nfft, self.hop, self.wb,
                                  self.sb, self.rb, side, precision,
                                  fixed_order)

    def edge_patch(self, x_region: torch.Tensor, side: str,
                   precision=FftPrecision.HIGH, fixed_order: bool = False):
        """`patch` over the edge samples' norm: the normalized head (or
        tail) of the output."""
        head, tail, _ = _plan_norms_on(self, x_region.device)
        return (self.patch(x_region, side, precision, fixed_order)
                / (head if side == "head" else tail))

    def interior_(self, out: torch.Tensor) -> torch.Tensor:
        """A hop-aligned stretch of the folded kernel's output, normalized
        in place and returned: as it is where 1/norm_c is in the kernel,
        else divided by `tile` hop by hop."""
        tile = _plan_norms_on(self, out.device)[2]
        if tile is not None:
            out.unflatten(-1, (-1, self.hop)).div_(tile)
        return out


@design_cache(16)
def blocked_plan(nfft: int, hop: int, window_bytes: bytes, synthesis: bool,
                 eps: float, response_bytes: bytes) -> BlockedPlan:
    """The `BlockedPlan` of this key (requires
    `composed_block_supported(nfft, hop)`). The norms are those of the f32
    window, as every frames route of the pipeline normalizes, over a
    reference frame count."""
    geo = blocked_chunk_geometry(nfft, hop)
    edge = geo["edge"]
    nf_ref = 2 * (nfft // hop - 1) + 2
    full = (nf_ref - 1) * hop + nfft
    w = np.frombuffer(window_bytes, np.float64)
    w = w.astype(np.float32).astype(np.float64)
    norm = edge_norm(w * w if synthesis else w, hop, nf_ref, full)
    interior = norm[edge : full - edge]
    fold = bool(interior[0] > 0 and np.max(np.abs(interior - interior[0]))
                <= 1e-9 * interior[0])
    norm64 = np.asarray(norm, np.float64)
    norm_c = float(norm64[edge]) if fold else None
    response = np.frombuffer(response_bytes, np.complex128)

    def clamped(a):
        return np.maximum(a, eps).astype(np.float32)

    return BlockedPlan(
        nfft, hop, window_bytes, synthesis, eps, response_bytes,
        group=geo["group"], gh=geo["gh"], mg=geo["mg"], edge=edge,
        right_ctx=geo["right_ctx"],
        patch_span=blocked_patch_span(nfft, hop),
        rb_kern=(_bytes(response / norm_c, np.complex128) if fold
                 else response_bytes),
        norm_c=norm_c,
        tile=None if fold else clamped(norm64[edge : edge + hop]),
        head_norm=clamped(norm64[:edge]),
        tail_norm=clamped(norm64[full - edge :]),
    )


def blocked_plan_for(cfg: StftConfig, response: np.ndarray) -> BlockedPlan:
    """`blocked_plan` for cfg's geometry, window, synthesis flag and eps
    and a response `blocked_response` resolved."""
    w = get_window(cfg.window, cfg.frame_size, cfg.periodic, dtype=np.float64)
    return blocked_plan(cfg.frame_size, cfg.hop_size, _bytes(w, np.float64),
                        cfg.synthesis_window, cfg.eps,
                        _bytes(response, np.complex128))


@design_cache(8)
def _plan_kernel_on(plan: BlockedPlan, folded: bool,
                    device: torch.device) -> torch.Tensor:
    return torch.from_numpy(plan.kernel(folded)).to(device)


@design_cache(8)
def _plan_bt_on(plan: BlockedPlan, folded: bool,
                device: torch.device) -> tuple:
    return tuple(torch.from_numpy(a).to(device)
                 for a in tf32x3.split_t(plan.kernel(folded)))


@design_cache(8)
def _plan_norms_on(plan: BlockedPlan, device: torch.device) -> tuple:
    """(head_norm, tail_norm, tile or None) as f32 tensors on `device`."""
    return (as_f32(plan.head_norm, device), as_f32(plan.tail_norm, device),
            None if plan.tile is None else as_f32(plan.tile, device))


# --- the tiled layout -------------------------------------------------------


@design_cache(None)
def _tiled_consts(nfft: int):
    """(c512, s_eff, ci512, si_eff, cvec, alt, sign_h): the folded bases'
    [h, h] cores (h = N/2; [h-1, h-1] for the sine parts) and their rank-1
    borders. The h-th row and column of each basis is the exact
    alternating-sign vector cos(pi n) = (-1)^n, so

      Re[:, :h] = e[:, :h] @ C[:h, :h] + e[:, h] (x) (-1)^k
      Re[:, h]  = sum_n e[:, n] (-1)^n + e[:, h] (-1)^h
      Im        = o @ S[:, 1:h]          (Im[0] = Im[h] = 0 exactly)
      a[:, :h]  = Re[:, :h] @ Cinv[:h, :h] + Re[:, h] (x) (-1)^n / N
      a[:, h]   = sum_k Re[:, k] w_k (-1)^k / N + Re[:, h] (-1)^h / N
      b         = Im_eff @ Sinv[1:h, :]"""
    h = nfft // 2
    c, s = _folded_forward_consts(nfft)
    cinv, sinv = _folded_inverse_consts(nfft)
    c512 = np.ascontiguousarray(c[:h, :h])
    s_eff = np.ascontiguousarray(s[:, 1:h])
    ci512 = np.ascontiguousarray(cinv[:h, :h])
    si_eff = np.ascontiguousarray(sinv[1:h, :])
    cvec = np.ascontiguousarray(cinv[:h, h])
    alt = np.where(np.arange(h) % 2 == 0, 1.0, -1.0).astype(np.float32)
    sign_h = 1.0 if h % 2 == 0 else -1.0
    return c512, s_eff, ci512, si_eff, cvec, alt, sign_h


def tiled_supported(nfft: int) -> bool:
    return nfft % 256 == 0 and nfft <= MAX_MATMUL_NFFT


@design_cache(None)
def _tiled_inverse_gained(nfft: int, gains_bytes: bytes):
    """The tiled inverse constants with a REAL per-bin gain g [h+1] folded
    into their rows in f64: (ci512_g, si_eff_g, cvec_g, g_nyq)."""
    g = np.frombuffer(gains_bytes, dtype=np.float64)
    h = nfft // 2
    assert len(g) == h + 1
    cinv, sinv = _folded_inverse_consts(nfft)
    ci512_g = np.ascontiguousarray(
        (cinv[:h, :h].astype(np.float64) * g[:h, None]).astype(np.float32))
    si_eff_g = np.ascontiguousarray(
        (sinv[1:h, :].astype(np.float64) * g[1:h, None]).astype(np.float32))
    cvec_g = np.ascontiguousarray(
        (cinv[:h, h].astype(np.float64) * g[:h]).astype(np.float32))
    return ci512_g, si_eff_g, cvec_g, float(g[h])


def _gains_bytes(per_bin_gains_f64) -> bytes:
    return np.ascontiguousarray(per_bin_gains_f64, np.float64).tobytes()


@design_cache(16)
def _tiled_consts_on(nfft: int, device: torch.device) -> tuple:
    """`_tiled_consts`' arrays as f32 tensors on `device` (sign_h a float)."""
    *arrays, sign_h = _tiled_consts(nfft)
    return (*(torch.from_numpy(a).to(device) for a in arrays), sign_h)


@design_cache(16)
def _tiled_gained_on(nfft: int, gains_bytes: bytes, device: torch.device):
    ci512_g, si_eff_g, cvec_g, g_nyq = _tiled_inverse_gained(nfft,
                                                             gains_bytes)
    return (*(torch.from_numpy(a).to(device)
              for a in (ci512_g, si_eff_g, cvec_g)), g_nyq)


def _tiled_fold(x: torch.Tensor, nfft: int, window_f32=None):
    """(e512 [..., h], e_n [..., 1], o [..., h-1]) of (windowed) frames."""
    h = nfft // 2
    y = x.float()
    if window_f32 is not None:
        y = y * const_on(window_f32, y.device)
    head = y[..., 1:h]
    tail = y[..., h + 1 :].flip(-1)
    e512 = torch.cat([y[..., :1], head + tail], dim=-1)
    return e512, y[..., h : h + 1], head - tail


def _tiled_unfold(a512, a_nyq, b, nfft: int) -> torch.Tensor:
    h = nfft // 2
    mid = a512[..., 1:h]
    return torch.cat([a512[..., :1], mid + b, a_nyq, (mid - b).flip(-1)],
                     dim=-1)


def rfft_folded_tiled_parts(x: torch.Tensor, nfft: int, window_f32=None):
    """rfft(x [* w]) -> (re512 [..., h], re_nyq [..., 1], im_eff [..., h-1]):
    the packed-real spectrum in the tiled layout (bins 0..h-1, the Nyquist
    bin, and Im 1..h-1). IEEE fp32 products."""
    c512, s_eff, _, _, _, alt, sign_h = _tiled_consts_on(nfft, x.device)
    e512, e_n, o = _tiled_fold(x, nfft, window_f32)
    re512 = torch.matmul(e512, c512) + e_n * alt
    re_nyq = (e512 * alt).sum(-1, keepdim=True) + e_n * sign_h
    im_eff = torch.matmul(o, s_eff)
    return re512, re_nyq, im_eff


def irfft_folded_tiled_parts(re512, re_nyq, im_eff, nfft: int,
                             per_bin_gains_f64=None) -> torch.Tensor:
    """Tiled-layout packed spectrum -> real [..., N] (1/N included); a
    REAL per-bin gain folds into the inverse constants. IEEE fp32."""
    _, _, ci512, si_eff, cvec, alt, sign_h = _tiled_consts_on(nfft,
                                                              re512.device)
    g_nyq = 1.0
    if per_bin_gains_f64 is not None:
        ci512, si_eff, cvec, g_nyq = _tiled_gained_on(
            nfft, _gains_bytes(per_bin_gains_f64), re512.device)
    a512 = (torch.matmul(re512, ci512)
            + (re_nyq * g_nyq) * (alt / nfft))
    a_nyq = ((re512 * cvec).sum(-1, keepdim=True)
             + re_nyq * (g_nyq * sign_h / nfft))
    b = torch.matmul(im_eff, si_eff)
    return _tiled_unfold(a512, a_nyq, b, nfft)


def roundtrip_folded_tiled(frames: torch.Tensor, nfft: int,
                           analysis_window_f64: np.ndarray,
                           synthesis_window_f64=None,
                           per_bin_gains_f64=None) -> torch.Tensor:
    """irfft(rfft(frames * w) [* g]) [* w_s] in the tiled layout: four
    [h, h]-core products and their rank-1 borders, IEEE fp32 at every
    tier."""
    w = np.asarray(analysis_window_f64, np.float32)
    out = irfft_folded_tiled_parts(
        *rfft_folded_tiled_parts(frames, nfft, w), nfft, per_bin_gains_f64)
    if synthesis_window_f64 is not None:
        out = out * const_on(np.asarray(synthesis_window_f64, np.float32),
                             out.device)
    return out


def tiled_parts_to_packed(re512, re_nyq, im_eff):
    """Tiled-layout spectrum -> full packed planes (Re [..., K], Im [..., K])
    with the structurally zero Im[0] and Im[Nyquist] filled in."""
    re = torch.cat([re512, re_nyq], dim=-1)
    zero = torch.zeros_like(re_nyq)
    return re, torch.cat([zero, im_eff, zero], dim=-1)


def packed_to_tiled_parts(re, im, nfft: int):
    """Inverse of `tiled_parts_to_packed`: drops Im[0] and Im[Nyquist], which
    the tiled inverse ignores (the projection irfft applies)."""
    h = nfft // 2
    return re[..., :h], re[..., h : h + 1], im[..., 1:h]


def rfft_tiled(x: torch.Tensor, nfft: int, window_f64=None) -> torch.Tensor:
    """Real [..., nfft] -> complex64 [..., K] through the tiled cores
    (requires `tiled_supported(nfft)`); the window optional (f64 design)."""
    w = None if window_f64 is None else np.asarray(window_f64, np.float32)
    return torch.complex(*tiled_parts_to_packed(
        *rfft_folded_tiled_parts(x, nfft, w)))


def irfft_tiled(spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """Complex [..., K] -> real [..., nfft] through the tiled cores;
    Im[0] and Im[Nyquist] are ignored."""
    return irfft_folded_tiled_parts(
        *packed_to_tiled_parts(spec.real, spec.imag, nfft), nfft)


def rfft_folded(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Real [..., nfft] -> complex64 [..., K] through the folded half-size
    bases (their tiled cores where `tiled_supported(nfft)`)."""
    return rfft_windowed_folded(x, nfft, None)


def irfft_folded(spec: torch.Tensor, nfft: int) -> torch.Tensor:
    """Complex [..., K] -> real [..., nfft] through the folded half-size
    bases (their tiled cores where `tiled_supported(nfft)`)."""
    if tiled_supported(nfft):
        return irfft_tiled(spec, nfft)
    return irfft_folded_parts(spec.real, spec.imag, nfft)


def rfft_windowed_folded(x: torch.Tensor, nfft: int,
                         window_f64) -> torch.Tensor:
    """rfft(x [* window]) -> complex64 through the folded half-size bases
    (their tiled cores where `tiled_supported(nfft)`)."""
    if tiled_supported(nfft):
        return rfft_tiled(x, nfft, window_f64)
    w = None if window_f64 is None else np.asarray(window_f64, np.float32)
    return torch.complex(*rfft_folded_packed(x, nfft, w))


def roundtrip_folded_matmul(frames: torch.Tensor, nfft: int,
                            analysis_window_f64: np.ndarray,
                            synthesis_window_f64=None) -> torch.Tensor:
    """irfft(rfft(frames * w)) [* w_s] by the four half-size products, Re
    and Im kept as separate planes between the directions: the frames-level
    identity of `pipeline.round_trip` ("folded") at an even N that is
    neither blocked nor tiled. IEEE fp32 at every tier."""
    w = np.asarray(analysis_window_f64, np.float32)
    out = irfft_folded_parts(*rfft_folded_packed(frames, nfft, w), nfft)
    if synthesis_window_f64 is not None:
        out = out * const_on(np.asarray(synthesis_window_f64, np.float32),
                             out.device)
    return out


# --- the opt-in formulations: conv, quad, packed -----------------------------


def _product(x: torch.Tensor, b: torch.Tensor, bt, precision) -> torch.Tensor:
    """x [..., M, K] @ b [K, N] at `precision`: on a CUDA tensor at HIGH,
    B0 (3xTF32) with `bt` = b's transposed TF32 halves where its tiles take
    the shape; otherwise IEEE fp32 (`torch.matmul`, TF32 off)."""
    k, n = b.shape
    if (x.device.type != "cpu" and x.ndim >= 2
            and float_tier(precision) == FftPrecision.HIGH
            and tf32x3.supported(n, k, k)):
        return tf32x3.gemm_cuda(x.float(), *bt)
    return torch.matmul(x, b)


def roundtrip_composed_conv(
    signal: torch.Tensor,  # [..., T] padded signal (frames fully inside)
    nfft: int,
    hop: int,
    num_frames: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
    precision=FftPrecision.HIGH,
) -> torch.Tensor:
    """The composed response round-trip as ONE strided product on the raw
    signal: out_frames[f, j] = sum_i signal[f*hop + i] * M[i, j], a 1-D
    convolution with kernel M and stride hop, so the [F, N] frame matrix
    is never made. The same function as frame_signal +
    `roundtrip_composed_matmul`; the reference keeps it as a documented
    formulation that no pipeline calls, and so does the port.

    On a CUDA tensor at HIGH, B0 reads the overlapping windows in place
    (3xTF32) where its tiles take the stride; otherwise `conv1d` in IEEE
    fp32, with cuDNN's TF32 off around the call."""
    keys = (
        nfft,
        _bytes(analysis_window_f64, np.float64),
        None if synthesis_window_f64 is None
        else _bytes(synthesis_window_f64, np.float64),
        _bytes(per_bin_response, np.complex128),
    )
    x = signal.float()
    lead = x.shape[:-1]
    xb = x.reshape((-1, x.shape[-1])).contiguous()
    if (x.device.type != "cpu"
            and float_tier(precision) == FftPrecision.HIGH
            and tf32x3.supported(nfft, nfft, hop)
            and (xb.shape[0] == 1 or xb.shape[-1] % 4 == 0)):
        out = tf32x3.gemm_cuda(xb, *_composed_bt_on(*keys, x.device),
                               rows=num_frames, lda=hop)
        return out.reshape(lead + out.shape[-2:])
    m = _composed_basis_on(*keys, x.device)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.nn.functional.conv1d(
            xb[:, None, :], m.T.contiguous()[:, None, :], stride=hop)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    out = out[:, :, :num_frames].transpose(1, 2)  # [B, F, N]
    return out.reshape(lead + out.shape[1:])


def quad_supported(nfft: int) -> bool:
    """The reference's gate for the quarter bases (q = N/4 a multiple of
    128 lanes)."""
    return nfft % 512 == 0 and nfft <= MAX_MATMUL_NFFT


def _quad_inverse_f64(nfft: int, g: "np.ndarray | None"):
    """f64 inverse quarter-bases with an optional per-bin gain g[K] folded
    into the constants (rows k scaled by g[k])."""
    h = nfft // 2
    q = h // 2
    m = np.arange(q, dtype=np.float64)
    k_e = 2.0 * m  # even bins k = 2m, m = 0..q-1
    k_o = 2.0 * m + 1.0  # odd bins k = 2m+1
    n_c = np.arange(q, dtype=np.float64)  # output positions n = 0..q-1
    n_m = np.arange(1, q, dtype=np.float64)  # interior n = 1..q-1
    tw = 2.0 * np.pi / nfft
    w_e = np.full(q, 2.0)
    w_e[0] = 1.0  # hermitian weight w_0 = 1
    w_o = np.full(q, 2.0)
    g_e = np.ones(q) if g is None else g[0::2][:q]
    g_o = np.ones(q) if g is None else g[1::2][:q]
    g_nyq = 1.0 if g is None else float(g[h])
    we = w_e * g_e
    wo = w_o * g_o
    altq = np.where(np.arange(q) % 2 == 0, 1.0, -1.0)
    pe = (we[:, None] * np.cos(tw * np.outer(k_e, n_c))) / nfft  # [q, q]
    po = (wo[:, None] * np.cos(tw * np.outer(k_o, n_c))) / nfft  # [q, q]
    qe = -(we[1:, None] * np.sin(tw * np.outer(k_e[1:], n_m))) / nfft
    qo = -(wo[:, None] * np.sin(tw * np.outer(k_o, n_m))) / nfft  # [q, q-1]
    pe_q = we * altq / nfft  # n = q column of the even-cos inverse
    qo_q = -(wo * altq) / nfft  # n = q column of the odd-sin inverse
    cve = we / nfft  # a_nyq row: w_k (-1)^k g_k / N at k = 2m
    cvo = -wo / nfft  # ... and at k = 2m+1
    return pe, po, qe, qo, pe_q, qo_q, cve, cvo, g_nyq


@design_cache(None)
def _quad_consts(nfft: int):
    """Quarter-size DFT bases: one more exact symmetry fold than the
    folded bases. cos(2 pi k (h-n)/N) = (-1)^k cos(2 pi k n/N) (h = N/2),
    so folding the even/odd frame halves once more about N/4 splits each
    half-size product into two quarter-size products, one per bin parity,
    combined by signs alone. The spectrum stays in its parity-split layout
    between forward and inverse; the fixed points of the fold (n = 0, N/4;
    k = Nyquist) are exact rank-1 borders, as in the tiled layout. The
    inverse includes 1/N; the constants are designed in f64."""
    assert nfft % 4 == 0 and nfft >= 4
    h = nfft // 2
    q = h // 2
    m = np.arange(q, dtype=np.float64)
    k_e = 2.0 * m
    k_o = 2.0 * m + 1.0
    n_c = np.arange(q, dtype=np.float64)
    n_m = np.arange(1, q, dtype=np.float64)
    tw = 2.0 * np.pi / nfft
    ce = np.cos(tw * np.outer(n_c, k_e))  # [q, q] rows n = 0..q-1
    co = np.cos(tw * np.outer(n_c, k_o))  # [q, q]
    se = -np.sin(tw * np.outer(n_m, k_e[1:]))  # [q-1, q-1] m = 1..q-1
    so = -np.sin(tw * np.outer(n_m, k_o))  # [q-1, q]
    inv = _quad_inverse_f64(nfft, None)[:-1]
    altq = np.where(np.arange(q) % 2 == 0, 1.0, -1.0)
    sign_q = 1.0 if q % 2 == 0 else -1.0

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    return (
        f32(ce), f32(co), f32(se), f32(so),
        tuple(f32(a) for a in inv),
        f32(altq), sign_q,
    )


@design_cache(None)
def _quad_inverse_gained(nfft: int, gains_bytes: bytes):
    g = np.frombuffer(gains_bytes, dtype=np.float64)
    assert len(g) == nfft // 2 + 1
    out = _quad_inverse_f64(nfft, g)
    return (
        tuple(np.ascontiguousarray(a, np.float32) for a in out[:-1]),
        out[-1],
    )


@design_cache(16)
def _quad_on(nfft: int, gains_bytes, device: torch.device) -> dict:
    """The quad constants on `device`: each product's basis as (f32 tensor,
    its transposed TF32 halves for B0), the border vectors as tensors, and
    the scalars sign_q and g_nyq."""
    ce, co, se, so, inv, altq, sign_q = _quad_consts(nfft)
    g_nyq = 1.0
    if gains_bytes is not None:
        inv, g_nyq = _quad_inverse_gained(nfft, gains_bytes)
    pe_b, po_b, qe_b, qo_b, pe_q, qo_q, cve, cvo = inv

    def on(a):
        return torch.from_numpy(a).to(device)

    bases = {name: (on(a), tuple(on(t) for t in tf32x3.split_t(a)))
             for name, a in (("ce", ce), ("co", co), ("se", se), ("so", so),
                             ("pe", pe_b), ("po", po_b), ("qe", qe_b),
                             ("qo", qo_b))}
    vecs = {name: on(a) for name, a in (("altq", altq), ("pe_q", pe_q),
                                        ("qo_q", qo_q), ("cve", cve),
                                        ("cvo", cvo))}
    return {**bases, **vecs, "sign_q": sign_q, "g_nyq": g_nyq}


def rfft_folded_quad_parts(x: torch.Tensor, nfft: int, window_f32=None,
                           precision=FftPrecision.HIGH):
    """rfft(x [* w]) -> the parity-split packed spectrum by four
    quarter-size products:

      re_e [..., q]   = Re X[2m],   m = 0..q-1      (q = nfft//4)
      re_o [..., q]   = Re X[2m+1]
      re_nyq [..., 1] = Re X[h]                      (h = nfft//2)
      im_e [..., q-1] = Im X[2m],   m = 1..q-1       (Im X[0] = 0 exactly)
      im_o [..., q]   = Im X[2m+1]

    Products at `precision` (`_product`)."""
    c = _quad_on(nfft, None, x.device)
    h = nfft // 2
    q = h // 2
    y = x.float()
    if window_f32 is not None:
        y = y * const_on(window_f32, y.device)
    # First fold (about N/2): even/odd parts of the frame.
    head = y[..., 1:h]
    tail = y[..., h + 1 :].flip(-1)
    e = torch.cat([y[..., :1], head + tail], dim=-1)  # n = 0..h-1
    e_n = y[..., h : h + 1]
    o = head - tail  # n = 1..h-1
    # Second fold (about N/4), pairing n <-> h-n.
    e_head = e[..., 1:q]
    e_tail = e[..., q + 1 :].flip(-1)  # e[h-n], n = 1..q-1
    u = torch.cat([e[..., :1], e_head + e_tail], dim=-1)  # [..., q]
    v = torch.cat([e[..., :1], e_head - e_tail], dim=-1)  # [..., q]
    eq = e[..., q : q + 1]
    o_head = o[..., : q - 1]  # o[n],   n = 1..q-1
    o_tail = o[..., q:].flip(-1)  # o[h-n], n = 1..q-1
    od = o_head - o_tail
    os_ = o_head + o_tail
    oq = o[..., q - 1 : q]
    altq = c["altq"]
    # Borders: e[q] enters even bins as (-1)^m (odd bins: cos(pi*k/2) = 0);
    # y[h] enters every Re bin as (-1)^k -> +1 on even bins, -1 on odd.
    re_e = _product(u, *c["ce"], precision) + eq * altq + e_n
    re_o = _product(v, *c["co"], precision) - e_n
    re_nyq = (u * altq).sum(-1, keepdim=True) + eq * c["sign_q"] + e_n
    im_e = _product(od, *c["se"], precision)
    im_o = _product(os_, *c["so"], precision) - oq * altq
    return re_e, re_o, re_nyq, im_e, im_o


def irfft_folded_quad_parts(re_e, re_o, re_nyq, im_e, im_o, nfft: int,
                            precision=FftPrecision.HIGH,
                            per_bin_gains_f64=None) -> torch.Tensor:
    """Parity-split packed spectrum -> real [..., nfft] (1/N included) by
    four quarter-size products; a REAL per-bin gain folds into the inverse
    constants."""
    gb = None if per_bin_gains_f64 is None else _gains_bytes(per_bin_gains_f64)
    c = _quad_on(nfft, gb, re_e.device)
    g_nyq, sign_q, altq = c["g_nyq"], c["sign_q"], c["altq"]
    pe = _product(re_e, *c["pe"], precision)  # [..., q]
    po = _product(re_o, *c["po"], precision)  # [..., q]
    # Nyquist-bin contribution (-1)^n g/N is n-even under the fold (h even).
    p = pe + re_nyq * (g_nyq / nfft) * altq
    a_q = ((re_e * c["pe_q"]).sum(-1, keepdim=True)
           + re_nyq * (g_nyq * sign_q / nfft))
    qe = _product(im_e, *c["qe"], precision)  # [..., q-1]
    qo = _product(im_o, *c["qo"], precision)  # [..., q-1]
    b_q = (im_o * c["qo_q"]).sum(-1, keepdim=True)
    a_nyq = ((re_e * c["cve"]).sum(-1, keepdim=True)
             + (re_o * c["cvo"]).sum(-1, keepdim=True)
             + re_nyq * (g_nyq / nfft))  # (-1)^h = +1 (h even)
    # Unfold both symmetry levels in one assembly:
    #   x[n]     = P[n] + po[n] + qe[n] + qo[n]        n = 1..q-1
    #   x[h-n]   = P[n] - po[n] - qe[n] + qo[n]
    #   x[h+n]   = P[n] - po[n] + qe[n] - qo[n]
    #   x[N-n]   = P[n] + po[n] - qe[n] - qo[n]
    pm = p[..., 1:]
    pom = po[..., 1:]
    return torch.cat(
        [
            p[..., :1] + po[..., :1],
            pm + pom + qe + qo,
            a_q + b_q,
            (pm - pom - qe + qo).flip(-1),
            a_nyq,
            pm - pom + qe - qo,
            a_q - b_q,
            (pm + pom - qe - qo).flip(-1),
        ],
        dim=-1,
    )


def roundtrip_folded_quad(frames: torch.Tensor, nfft: int,
                          analysis_window_f64: np.ndarray,
                          synthesis_window_f64=None,
                          precision=FftPrecision.HIGH,
                          per_bin_gains_f64=None) -> torch.Tensor:
    """irfft(rfft(frames * w) [* g]) [* w_s] by quarter-size DFT bases
    (eight products with [N/4, N/4] cores), the spectrum held in its
    parity-split layout between the directions."""
    w = np.asarray(analysis_window_f64, np.float32)
    parts = rfft_folded_quad_parts(frames, nfft, w, precision)
    out = irfft_folded_quad_parts(*parts, nfft, precision, per_bin_gains_f64)
    if synthesis_window_f64 is not None:
        out = out * const_on(np.asarray(synthesis_window_f64, np.float32),
                             out.device)
    return out


@design_cache(None)
def _windowed_inverse_basis(nfft: int, window_bytes: bytes) -> np.ndarray:
    """The inverse basis with a synthesis window folded in (columns
    scaled)."""
    w = np.frombuffer(window_bytes, dtype=np.float64)
    assert len(w) == nfft
    base = _inverse_basis(nfft).astype(np.float64)
    return (base * w[None, :]).astype(np.float32)


@design_cache(8)
def _packed_bases_on(nfft: int, awin_bytes: bytes, swin_bytes,
                     device: torch.device) -> tuple:
    """The packed round-trip's two bases on `device`, each as (f32 tensor,
    its transposed TF32 halves)."""
    fwd = _windowed_forward_basis(nfft, awin_bytes)
    inv = (_inverse_basis(nfft) if swin_bytes is None
           else _windowed_inverse_basis(nfft, swin_bytes))

    def on(a):
        return torch.from_numpy(a).to(device)

    return tuple((on(a), tuple(on(t) for t in tf32x3.split_t(a)))
                 for a in (fwd, inv))


def roundtrip_packed_matmul(frames: torch.Tensor, nfft: int,
                            analysis_window_f64: np.ndarray,
                            synthesis_window_f64=None,
                            precision=FftPrecision.HIGH) -> torch.Tensor:
    """irfft(rfft(frames * w)) [* w_s] as two products with no complex
    dtype: the forward basis emits [Re | Im] packed reals, the layout the
    inverse basis takes. Products at `precision` (`_product`: B0 only where
    its tiles take N + 2 columns, so IEEE fp32 at the usual N)."""
    fwd, inv = _packed_bases_on(
        nfft, _bytes(analysis_window_f64, np.float64),
        None if synthesis_window_f64 is None
        else _bytes(synthesis_window_f64, np.float64),
        frames.device)
    packed = _product(frames.float(), *fwd, precision)
    return _product(packed, *inv, precision)
