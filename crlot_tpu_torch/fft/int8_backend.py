"""The INT8X2 tier: the tiled round-trip's products as two int8 limbs a value.

Counterpart of `crlot_tpu/fft/int8_backend.py`. Every operand of a product
is quantized to 14 significant bits as q = 128*hi + lo with both limbs int8
(|hi| <= 127, |lo| <= 64: the split is exact), and a product of two split
operands runs as three int8 products with exact int32 sums, the lowest
(lo . lo, about 2^-16 relative) dropped:

    x @ b ~= s_x * s_b * 128 * (128 * (xh @ bh) + (xh @ bl) + (xl @ bh))

The constant bases take a per-COLUMN scale, folded into the f32
recombination (`quantize_basis`, float64 host design code, cached); the
runtime operand a dynamic per-ROW (per-frame) scale (`_quantize_dynamic`).
`dot_i8x2` runs on K11's reference variant (`int8_gemm.fusedq_ref_gemm`:
the row scale, the limbs and the three products in one kernel of
`csrc/b6_sm90.cu`) on a CUDA tensor and on its plain version on the CPU;
the basis's limbs are laid out once as the kernel's Bt [N, K], K-contiguous,
with K and N padded to multiples of 64 by zero rows and columns (a zero
entry changes neither a row's amax nor an integer sum). The f32 borders of
the tiled layout stay torch ops, as they are XLA ops in the reference.

Numerics: the one rounding of each operand, about 78 dB round-trip SNR,
18 dB above the reference's 60 dB gate.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import int8_gemm as b6
from ..core.consts import const_on, design_cache
from . import matmul_backend as mb

# Max quantized magnitude: 127 * 128 (hi limb saturates at 127, lo at 0).
QMAX = 16256.0


def _split_limbs_np(q: np.ndarray):
    """Exact two-limb split of integer-valued |q| <= QMAX (f64 numpy)."""
    hi = np.clip(np.rint(q / 128.0), -127, 127)
    lo = q - hi * 128.0
    assert np.abs(lo).max(initial=0.0) <= 127
    return hi.astype(np.int8), lo.astype(np.int8)


@dataclass(frozen=True, eq=False)
class QBasis:
    """A quantized basis, unpacked as the reference's tuple (hi, lo, cs):
    hi and lo int8 [n, m], cs f32 [m]. Hashed by identity, so that the
    kernel's layout of it is made once (`_operands_on`)."""

    hi: np.ndarray
    lo: np.ndarray
    cs: np.ndarray

    def __iter__(self):
        return iter((self.hi, self.lo, self.cs))


@design_cache(None)
def _quantize_basis(key, basis_bytes: bytes, shape) -> QBasis:
    """Per-column 14-bit quantization of a constant basis: basis[:, j] ~=
    (hi + lo/128)[:, j] * 128 * cs[j]."""
    b = np.frombuffer(basis_bytes, dtype=np.float64).reshape(shape)
    col_max = np.abs(b).max(axis=0)
    col_max = np.where(col_max == 0.0, 1.0, col_max)
    q = np.rint(b * (QMAX / col_max))
    hi, lo = _split_limbs_np(q)
    return QBasis(hi, lo, (col_max / QMAX).astype(np.float32))


def quantize_basis(b_f64: np.ndarray, key: str = "") -> QBasis:
    b = np.ascontiguousarray(b_f64, dtype=np.float64)
    return _quantize_basis(key, b.tobytes(), b.shape)


def _quantize_dynamic(x: torch.Tensor):
    """14-bit two-limb quantization with a dynamic per-ROW scale: (hi int8,
    lo int8, s f32 [..., 1]) with x ~= (hi*128 + lo) * s. s = max(amax,
    1e-30) * f32(1/QMAX) and q = rint(x * f32(1/s)), as XLA lowers the
    reference's `amax / QMAX` (folded into the reciprocal's product) and
    `x * (1.0 / s)` (kept as written) under jit (ROADMAP C8)."""
    return b6.quantize_rows_ref(x.float())


def _pad64(n: int) -> int:
    return -(-n // 64) * 64


@design_cache(64)
def _operands_on(qbasis: QBasis, device: torch.device):
    """(bh_t int8 [Np, Kp], bl_t int8 [Np, Kp], cs f32 [Np]): the basis as
    the kernel takes it, transposed, K-contiguous, zero-padded to multiples
    of 64 (a padded column's scale is 0)."""
    k, n = qbasis.hi.shape
    kp, np_ = _pad64(k), _pad64(n)

    def lay(a):
        t = np.zeros((np_, kp), np.int8)
        t[:n, :k] = a.T
        return torch.from_numpy(t).to(device)

    c = np.zeros(np_, np.float32)
    c[:n] = qbasis.cs
    return lay(qbasis.hi), lay(qbasis.lo), torch.from_numpy(c).to(device)


def dot_i8x2(x: torch.Tensor, qbasis: QBasis) -> torch.Tensor:
    """f32 [..., K] @ quantized basis [K, N] -> f32 [..., N]: each row
    quantized to two limbs, three int8 products (hh, and the cross terms
    xh.bl + xl.bh as one int32 sum), then (f32(hh)*128 + f32(cross)) *
    ((128*s) * cs). K11 on a CUDA tensor, its plain version on the CPU."""
    bh_t, bl_t, cs = _operands_on(qbasis, x.device)
    k, n = qbasis.hi.shape
    if x.shape[-1] != k:
        raise ValueError(f"dot_i8x2: x has {x.shape[-1]} columns, the basis "
                         f"{k} rows")
    lead = x.shape[:-1]
    xm = x.float().reshape(-1, k)
    if bh_t.shape[1] != k:
        xm = torch.nn.functional.pad(xm, (0, bh_t.shape[1] - k))
    out = b6.fusedq_ref_gemm(xm.contiguous(), bh_t, bl_t, cs)
    return out[:, :n].reshape(lead + (n,))


def int8_supported(nfft: int) -> bool:
    """int32 sums are exact to a contraction of about 2^17 (127*127*K <
    2^31), so the whole tiled range qualifies."""
    return mb.tiled_supported(nfft)


@design_cache(None)
def _tiled_consts_i8(nfft: int):
    """The tiled cores quantized (the borders stay f32)."""
    c512, s_eff, ci512, si_eff, cvec, alt, sign_h = mb._tiled_consts(nfft)
    return (
        quantize_basis(c512, f"c512:{nfft}"),
        quantize_basis(s_eff, f"s_eff:{nfft}"),
        quantize_basis(ci512, f"ci512:{nfft}"),
        quantize_basis(si_eff, f"si_eff:{nfft}"),
        cvec,
        alt,
        sign_h,
    )


@design_cache(None)
def _tiled_inverse_gained_i8(nfft: int, gains_bytes: bytes):
    """The inverse cores with a real per-bin gain folded in BEFORE
    quantization (the gains scale the contraction rows; per-column
    quantization renormalizes afterwards)."""
    ci512_g, si_eff_g, cvec_g, g_nyq = mb._tiled_inverse_gained(
        nfft, gains_bytes)
    return (
        quantize_basis(ci512_g, f"ci512_g:{nfft}:{hash(gains_bytes)}"),
        quantize_basis(si_eff_g, f"si_eff_g:{nfft}:{hash(gains_bytes)}"),
        cvec_g,
        g_nyq,
    )


def rfft_folded_tiled_parts_i8(x: torch.Tensor, nfft: int, window_f32=None):
    """The int8x2 `matmul_backend.rfft_folded_tiled_parts`: (re512,
    re_nyq, im_eff), the two cores on K11."""
    qc, qs, _, _, _, alt, sign_h = _tiled_consts_i8(nfft)
    e512, e_n, o = mb._tiled_fold(x, nfft, window_f32)
    altj = const_on(alt, x.device)
    re512 = dot_i8x2(e512, qc) + e_n * altj
    re_nyq = (e512 * altj).sum(-1, keepdim=True) + e_n * sign_h
    im_eff = dot_i8x2(o, qs)
    return re512, re_nyq, im_eff


def irfft_folded_tiled_parts_i8(re512, re_nyq, im_eff, nfft: int,
                                per_bin_gains_f64=None) -> torch.Tensor:
    """The int8x2 `matmul_backend.irfft_folded_tiled_parts`."""
    _, _, qci, qsi, cvec, alt, sign_h = _tiled_consts_i8(nfft)
    g_nyq = 1.0
    if per_bin_gains_f64 is not None:
        qci, qsi, cvec, g_nyq = _tiled_inverse_gained_i8(
            nfft, mb._gains_bytes(per_bin_gains_f64))
    dev = re512.device
    altj = const_on(alt, dev)
    a512 = dot_i8x2(re512, qci) + (re_nyq * g_nyq) * (altj / nfft)
    a_nyq = ((re512 * const_on(cvec, dev)).sum(-1, keepdim=True)
             + re_nyq * (g_nyq * sign_h / nfft))
    b = dot_i8x2(im_eff, qsi)
    return mb._tiled_unfold(a512, a_nyq, b, nfft)


def roundtrip_folded_tiled_i8(
    frames: torch.Tensor,
    nfft: int,
    analysis_window_f64: np.ndarray,
    synthesis_window_f64=None,
    per_bin_gains_f64=None,
) -> torch.Tensor:
    """irfft(rfft(frames * w) [* g]) [* w_s] with every product on K11: four
    launches, about 78 dB round-trip SNR."""
    w = np.asarray(analysis_window_f64, np.float32)
    out = irfft_folded_tiled_parts_i8(
        *rfft_folded_tiled_parts_i8(frames, nfft, w), nfft,
        per_bin_gains_f64)
    if synthesis_window_f64 is not None:
        out = out * const_on(np.asarray(synthesis_window_f64, np.float32),
                             out.device)
    return out


def roundtrip_composed_i8(
    frames: torch.Tensor,
    nfft: int,
    analysis_window_f64: np.ndarray,
    per_bin_response: np.ndarray,
    synthesis_window_f64=None,
) -> torch.Tensor:
    """The composed one-product response round-trip on K11: the windowed
    circulant (`matmul_backend._composed_roundtrip_basis`) quantized per
    column, one launch. For MILD responses the circulant is near-diagonal
    and the per-column noise grows about sqrt(K) against the signal: about
    65 dB for a +-10 dB EQ at N = 1024 (the reference's measure); the f32
    composed product has no such penalty."""
    m = mb._composed_roundtrip_basis(
        nfft,
        mb._bytes(analysis_window_f64, np.float64),
        None if synthesis_window_f64 is None
        else mb._bytes(synthesis_window_f64, np.float64),
        mb._bytes(per_bin_response, np.complex128),
    )
    return dot_i8x2(frames, quantize_basis(m, f"composed:{nfft}"))
