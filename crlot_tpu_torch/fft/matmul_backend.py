"""DFT-as-matmul pieces of the round-trip slice, in torch.

Counterpart of the slice's part of `crlot_tpu/fft/matmul_backend.py`:

* the folded (half-size) forward and inverse DFT bases and the packed
  forward / inverse that use them;
* the composed round-trip basis: for a FIXED per-bin response, frame ->
  spectrum -> response -> frame is one [N, N] matrix;
* the blocked formulation: that map plus the overlap-add folded into a
  hop-block Toeplitz kernel applied straight to the padded signal
  (`hopblock_apply`), with the head/tail blocks recomputed exactly from the
  real boundary frames (`blocked_edge_patch`), and the halo a streaming
  chunk carries to reproduce it (`blocked_chunk_geometry`).

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
`irfft_folded_tiled_parts`, `roundtrip_folded_tiled`) is the reference's
lane-aligned layout of the folded bases: an [h, h] core a product and the
(h+1)-th row and column as exact alternating-sign rank-1 borders. Its
products are IEEE fp32 `torch.matmul`s at every tier; `fft/int8_backend.py`
runs the same layout on K11's int8 limb products.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.consts import const_on
from ..core.types import FftPrecision, float_tier
from . import fp32_window, tf32x3

MAX_MATMUL_NFFT = 4096


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=16)
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


def rfft_folded_packed(x: torch.Tensor, nfft: int, window_f32=None):
    """rfft(x [* window]) -> (Re [..., K], Im [..., K]) via two half-size
    products."""
    c, s, _, _ = folded_consts_on(nfft, x.device)
    y = x.float()
    if window_f32 is not None:
        w = (window_f32.to(x.device, torch.float32)
             if isinstance(window_f32, torch.Tensor)
             else const_on(window_f32, x.device))
        y = y * w
    even, odd = _fold_frames(y, nfft)
    re = torch.matmul(even, c)
    if s.shape[0]:
        im = torch.matmul(odd, s)
    else:
        im = torch.zeros_like(re)
    return re, im


def irfft_folded_parts(re: torch.Tensor, im: torch.Tensor,
                       nfft: int) -> torch.Tensor:
    """(Re, Im) [..., K] -> real [..., N] (1/N included): two half-size
    products and an unfold."""
    _, _, cinv, sinv = folded_consts_on(nfft, re.device)
    a = torch.matmul(re.float(), cinv)
    h = nfft // 2
    if sinv.shape[1]:
        b = torch.matmul(im.float(), sinv)
        mid = a[..., 1:h]
        return torch.cat(
            [a[..., :1], mid + b, a[..., h : h + 1], (mid - b).flip(-1)],
            dim=-1,
        )
    return a  # nfft == 2: output is [x0, x1] = [A0, A1]


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=8)
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


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=8)
def _runtime_kernel_on(nfft, hop, group, awin_bytes, swin_bytes, rb_kern,
                       device: torch.device) -> torch.Tensor:
    kern, _ = blocked_runtime_kernel(
        nfft, hop, group, awin_bytes, swin_bytes, rb_kern
    )
    return torch.from_numpy(kern).to(device)


@lru_cache(maxsize=8)
def _runtime_bt_on(nfft, hop, group, awin_bytes, swin_bytes, rb_kern,
                   device: torch.device) -> tuple:
    """The runtime kernel as B0 takes it: transposed [G*hop, mg*G*hop],
    split into TF32 (hi, lo) by the host design code."""
    kern, _ = blocked_runtime_kernel(
        nfft, hop, group, awin_bytes, swin_bytes, rb_kern
    )
    return tuple(torch.from_numpy(a).to(device) for a in tf32x3.split_t(kern))


@lru_cache(maxsize=8)
def _composed_basis_on(nfft, awin_bytes, swin_bytes, response_bytes,
                       device: torch.device) -> torch.Tensor:
    m = _composed_roundtrip_basis(nfft, awin_bytes, swin_bytes, response_bytes)
    return torch.from_numpy(m).to(device)


def _hopblock_ext(x, kern, block, n_out, left):
    """(x padded with `left` zeros and enough right zeros, mg, nb)."""
    assert kern.shape[0] % block == 0, (
        f"kernel height {kern.shape[0]} must be a multiple of the "
        f"block size {block}"
    )
    mg = kern.shape[0] // block
    nb = -(-n_out // block)
    right = (nb - 1 + mg) * block - left - x.shape[-1]
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
    of M*block samples times the kernel. Returns [..., n_out].

    On a CUDA tensor, one launch over the overlapping windows (lda =
    block), each output summed in a fixed order: at HIGH (and INT8X2) B0 in
    3xTF32, with `bt` = the kernel's (hi, lo) from the host design code
    (split here when not given); at HIGHEST B0's IEEE fp32 kernel
    (`fp32_window`). On the CPU: the padded signal viewed as ONE contiguous
    [..., B, block] tensor and the M products of its shifted row slices
    (each a contiguous view, no im2col copy) accumulated in ascending m
    order, in IEEE fp32."""
    x_ext, mg, nb = _hopblock_ext(x, kern, block, n_out, left)
    if x.device.type != "cpu":
        if float_tier(precision) == FftPrecision.HIGH:
            bt_hi, bt_lo = tf32x3.split_t(kern) if bt is None else bt
            out = tf32x3.gemm_cuda(x_ext.contiguous(), bt_hi, bt_lo,
                                   rows=nb, lda=block)
        else:
            out = fp32_window.gemm_cuda(x_ext.contiguous(), kern, rows=nb,
                                        lda=block)
        return out.reshape(out.shape[:-2] + (nb * block,))[..., :n_out]
    blocks = x_ext.reshape(x_ext.shape[:-1] + (-1, block))
    acc = None
    for m in range(mg):
        term = torch.matmul(
            blocks[..., m : m + nb, :], kern[m * block : (m + 1) * block, :]
        )
        acc = term if acc is None else acc + term
    return acc.reshape(acc.shape[:-2] + (nb * block,))[..., :n_out]


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
    products on the raw signal, length (num_frames-1)*hop + nfft; the
    windowed product at `precision` (`hopblock_apply`).

    Without `norm_fold` the result is the un-normalized OLA sum. With
    `norm_fold = (norm_c, head_norm, tail_norm)` -- the constant interior
    COLA norm and the eps-clamped f32 norms of the (R-1)*hop edge samples at
    each end, on the signal's device (`pipeline.blocked_norm_fold` checks
    the interior is constant) -- 1/norm_c is folded into the kernel at f64
    design time and only the edge samples divide by their true norm."""
    assert composed_block_supported(nfft, hop)
    assert num_frames >= 2 * (nfft // hop - 1)
    assert group >= 1
    wb = _bytes(analysis_window_f64, np.float64)
    sb = (
        None if synthesis_window_f64 is None
        else _bytes(synthesis_window_f64, np.float64)
    )
    rb = _bytes(per_bin_response, np.complex128)
    r_count = nfft // hop
    full = (num_frames - 1) * hop + nfft
    edge = (r_count - 1) * hop
    rb_kern = rb
    if norm_fold is not None:
        rb_kern = _bytes(
            np.asarray(per_bin_response, np.complex128) / norm_fold[0],
            np.complex128,
        )
    kern = _runtime_kernel_on(nfft, hop, group, wb, sb, rb_kern, padded.device)
    x = padded[..., :full].float()
    out = hopblock_apply(
        x, kern, group * hop, full, edge, precision,
        _runtime_bt_on(nfft, hop, group, wb, sb, rb_kern, padded.device)
        if padded.device.type != "cpu"
        and float_tier(precision) == FftPrecision.HIGH
        else None,
    )
    span_p = blocked_patch_span(nfft, hop)
    head = blocked_edge_patch(x[..., :span_p], nfft, hop, wb, sb, rb, "head")
    tail = blocked_edge_patch(
        x[..., full - span_p : full], nfft, hop, wb, sb, rb, "tail"
    )
    if norm_fold is not None:
        head = head / norm_fold[1]
        tail = tail / norm_fold[2]
    return torch.cat([head, out[..., edge : full - edge], tail], dim=-1)


# --- the tiled layout -------------------------------------------------------


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=16)
def _tiled_consts_on(nfft: int, device: torch.device) -> tuple:
    """`_tiled_consts`' arrays as f32 tensors on `device` (sign_h a float)."""
    *arrays, sign_h = _tiled_consts(nfft)
    return (*(torch.from_numpy(a).to(device) for a in arrays), sign_h)


@lru_cache(maxsize=16)
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
