"""B6: the int8 limb dots and their bf16 twin -- wrappers and plain versions.

Counterpart of the four Pallas kernels of `scripts/bench_pallas_int8_probe.py`
(K8 `_kernel_bf16`, K9 `_kernel_i8`, K10 `_kernel_i8_3dot`, K11
`_kernel_i8_fusedq`) and of the born-int16 wire tier's interior dots
(`crlot_tpu/wire.py:105-179`), and of the reference's INT8X2 tier's
`fft/int8_backend.dot_i8x2`. Every one runs on the TMA + `wgmma` kernel of
`csrc/b6_sm90.cu` (one template, a mode each; its tile per mode is
`SM90_GEO`).

Operands. A product is C = A @ B with B given as `bt` [N, K] (K-contiguous,
laid out once at design time). A is either a matrix [..., M, K] or, with
`rows` and `lda`, the overlapping windows of a signal [..., L]: row r is
x[..., r*lda : r*lda + K], read in place. The wire tier calls it with
lda = gh and K = mg*gh, which is the reference's m-ordered sum of mg
shifted dots (`_hopblock_apply_i8`) in one exact int32 product.
`tile_plan` is the geometry in which the TMA kernel reads such windows.

* `i8_gemm` (B6-i8, K9): int8 x int8 -> int32.
* `limb_gemm` (B6-limb, K10): several limb-pair products in one launch,
  each an exact int32 accumulator, and a fixed f32 epilogue picked by name
  (`EPILOGUES`): "probe3" f32(hh)*128 + f32(hl + lh); "wire2" (hh*32768 +
  lh*128 + hl*256 + ll) * scale; "wire1" (h*256 + l) * scale. The wire's
  low limb is unsigned (0..255). The kernel runs "probe3" on int8 limbs;
  the wire epilogues run on the card only from int16 samples
  (`limb_gemm_i16`), and on limbs only in the plain version.
* `limb_gemm_i16` (B6-limb on int16 samples, the wire tier): the wire
  epilogues on the limbs of int16 samples, which the kernel splits on chip
  (`i16_limb_bytes`: hi = the high byte, lo = the low byte of each
  sample).
* `bf16_gemm` (B6-bf16, K8): bf16 x bf16 -> f32.
* `fusedq_gemm` (B6-fusedq, K11, the probe's variant): f32 rows
  quantized per row to two int8 limbs in the kernel, then the three dots
  of "probe3", times s*128.
* `fusedq_ref_gemm` (K11, the reference's variant: `dot_i8x2`): the same
  on the basis's limbs, each row quantized as `int8_backend.
  _quantize_dynamic` does (`quantize_rows_ref`), times (128*s) * cs[col].

K11's two variants share the row scale s = max(amax, 1e-30) * f32(1/16256)
(`row_scale`: XLA folds both `/ 16256.0`s into that product, ROADMAP C8)
and differ in q: the probe divides, rint(x / s); `dot_i8x2` multiplies by
the f32 reciprocal, rint(x * (1/s)), which XLA keeps as written. The kernel
takes s from a first pass over the rows, then quantizes each TMA stage of
its rows into the limbs of wgmma's register A fragment; K is not capped.

Plain versions. Integer products are exact: int32 `torch.matmul` on the
CPU, float64 on any other device cast back (every sum is far below 2^53).
The f32 epilogues convert the same accumulators and combine them in the
same order as the kernels, so kernel and plain agree bit for bit on every
integer variant. A CPU tensor takes the plain version; any other tensor
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import cuda_build

# B6 kernel launches since import (or the caller's reset), per kernel.
launches: Dict[str, int] = {"i8": 0, "limb": 0, "bf16": 0, "fusedq": 0,
                            "fusedq_ref": 0}

# The B operands of each B6-limb epilogue; every limb product takes two A
# operands, the high and the low limb.
EPILOGUES = {"probe3": 2, "wire2": 2, "wire1": 1}
# The kernel's modes: K10's probe3 on int8 limbs, and the wire epilogues on
# int16 samples, split into limbs on chip.
_MODE_I32, _MODE_PROBE3, _MODE_BF16 = 0, 1, 4
MODE_TF32X3 = 8  # B0, f32 in 3xTF32 (`fft/tf32x3.py`)
I16_MODES = {"wire2": 6, "wire1": 7}
FUSEDQ_MODES = {"probe": 5, "ref": 9}  # K11's variants (crlot_b6_fusedq)
TILE = 64  # the kernels' N and K-byte granularity
KTILE_BYTES = 128  # contraction bytes of one K tile of the TMA kernel

# b6_sm90.cu's `Cfg` per mode: (A tiles (int16: the two 64-sample boxes of
# one tile; K11: the four 32-float boxes of 128 f32 elements of K), B
# tiles, int32 accumulators, tile columns BN, ring stages, epilogue columns
# a pass, int16 input). The tile is 128 rows x BN.
SM90_GEO = {
    0: (1, 1, 1, 128, 4, 128, False),  # K9 int8 -> int32
    4: (1, 1, 1, 128, 4, 128, False),  # K8 bf16 -> f32
    1: (2, 2, 2, 128, 3, 64, False),   # K10 probe3
    6: (2, 2, 4, 64, 4, 64, True),     # wire int8x2 on int16 samples
    7: (2, 1, 2, 128, 4, 64, True),    # wire int8x1 on int16 samples
    8: (1, 2, 2, 128, 4, 64, False),   # B0 3xTF32: sum and stage partial
    5: (4, 2, 2, 128, 2, 64, False),   # K11, the probe's variant
    9: (4, 2, 2, 128, 2, 64, False),   # K11, dot_i8x2's variant
}
SM90_MAX_SMEM = 232_448  # dynamic shared memory a CTA may use on sm_90
SM90_ACC_REGS = 128  # of setmaxnreg's 232 a consumer thread


def sm90_budget(mode: int) -> dict:
    """Shared memory and accumulator registers of b6_sm90.cu's kernel in
    `mode`, as its `Geo` computes them: STAGES stages of NA 16 KB A tiles
    (int16 input: one tile of 128 x 128 samples; K11: 128 rows x 128 f32)
    and NB B tiles of BN x 128 bytes, two warpgroups' 64 x SC x 4-byte
    staging, the mbarriers, and 1 KB of alignment; each consumer thread
    holds NACC x BN / 2 accumulators (and, for int16 input and K11, 32
    registers of limb fragments; for 3xTF32, 32 of TF32 hi / lo
    fragments). K11's f32 stage of 96 KB leaves room for two."""
    na, nb, nacc, bn, stages, sc, i16 = SM90_GEO[mode]
    fused = mode in FUSEDQ_MODES.values()
    stage = na * 128 * 128 + nb * bn * 128
    smem = stages * stage + 2 * 64 * sc * 4 + 2 * stages * 8 + 1024
    return {"tile": (128, bn), "stages": stages, "stage_bytes": stage,
            "smem": smem, "acc_regs": nacc * bn // 2,
            "frag_regs": 32 if i16 or fused or mode == MODE_TF32X3 else 0,
            "passes": bn // sc,
            "ktile_a_bytes": KTILE_BYTES * (4 if fused else 2 if i16 else 1)}


def sm90_tiles(mode: int, rows: int, n: int, batch: int = 1) -> int:
    """Output tiles of one launch: the persistent grid walks them on
    min(tiles, SMs) CTAs."""
    bn = SM90_GEO[mode][3]
    return -(-rows // 128) * -(-n // bn) * batch

# K11's quantization constants (the probe's :68-70, `int8_backend.py`'s
# :84-86). XLA folds `/ 16256.0` (a division by a constant) into a product
# by the float32 reciprocal, in the probe's kernel and in a jitted
# `_quantize_dynamic` alike; the kernel and the plain versions do the same,
# which the tests hold bit for bit against the interpreted kernel and the
# jitted reference. The probe's `x / s` stays a divide, `_quantize_dynamic`'s
# `x * (1.0 / s)` a product by the reciprocal (ROADMAP C8).
_INV_QMAX = float(np.float32(1.0 / 16256.0))  # 127 * 128 = 16256
_AMAX_FLOOR = 1e-30


def windows(x: torch.Tensor, rows: int, lda: int, k: int) -> torch.Tensor:
    """[..., L] -> [..., rows, K] view: row r = x[..., r*lda : r*lda + K]."""
    if rows < 1 or (rows - 1) * lda + k > x.shape[-1]:
        raise ValueError(
            f"{rows} rows of {k} at stride {lda} need "
            f"{(rows - 1) * lda + k} samples, have {x.shape[-1]}")
    return x.unfold(-1, k, lda)[..., :rows, :]


class TilePlan(NamedTuple):
    """How the TMA kernel reads windows: the signal as the non-overlapping
    view [view_rows, lda], and for each K tile of `width` elements its
    (row shift m, column j) in that view."""

    view_rows: int
    width: int
    tiles: tuple


def tile_plan(rows: int, lda: int, k: int, elem: int, length: int,
              ktile_bytes: int = KTILE_BYTES) -> TilePlan:
    """The K tiles of windows row r = x[r*lda : r*lda + k] of a signal of
    `length` elements of `elem` bytes (a matrix is lda = k). K tile kt holds
    window bytes kt*T .. kt*T + T - 1, T = `ktile_bytes` (128; 256 for the
    int16 limb modes, whose stage is 128 samples): the view's row r + m at
    column j, m = (kt*T) // lda and j = (kt*T) % lda in bytes. Columns past
    lda (a ragged last tile) read as zeros. Raises ValueError where a tile
    would straddle two view rows (overlapping windows with lda bytes % T !=
    0) or a window would reach past the view."""
    lda_b, k_b = lda * elem, k * elem
    if lda_b % 16 or k_b % 16:
        raise ValueError(f"row stride {lda_b} and K {k_b} bytes must be "
                         f"multiples of 16")
    if lda_b < k_b and lda_b % ktile_bytes:
        raise ValueError(f"overlapping windows need a row stride of a "
                         f"multiple of {ktile_bytes} bytes, got {lda_b}")
    view_rows = length // lda
    if rows < 1 or (rows - 1) * lda + k > view_rows * lda:
        raise ValueError(f"{rows} windows of {k} at stride {lda} do not fit "
                         f"the {view_rows} whole rows of {lda} in {length}")
    tiles = tuple(((kb // lda_b), (kb % lda_b) // elem)
                  for kb in range(0, k_b, ktile_bytes))
    return TilePlan(view_rows, ktile_bytes // elem, tiles)


def _as_signal(a: torch.Tensor, rows, lda):
    """(x [..., L], rows, lda) for a matrix [..., M, K] (rows None) or a
    signal with its window geometry."""
    if rows is None:
        if a.ndim < 2:
            raise ValueError(f"A must be [..., M, K], got {tuple(a.shape)}")
        return a.contiguous().flatten(-2), a.shape[-2], a.shape[-1]
    return a, rows, lda


def i16_limbs(x_i16: torch.Tensor):
    """Exact limbs of int16 samples over the whole range: (hi int8, lo
    uint8) with hi = x >> 8 in [-128, 127], lo = x & 0xFF in [0, 255], and
    256*hi + lo == x."""
    x = x_i16.to(torch.int32)
    return (x >> 8).to(torch.int8), (x & 0xFF).to(torch.uint8)


def i16_limb_bytes(x_i16: torch.Tensor):
    """The same limbs as the int16 limb modes make them on chip: each
    little-endian sample's high byte (hi, read as int8) and low byte (lo,
    uint8), the byte permutes of `b6_sm90.cu`'s split_limbs."""
    b = x_i16.contiguous().view(torch.uint8).reshape(x_i16.shape + (2,))
    return b[..., 1].view(torch.int8), b[..., 0]


def int_dot(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ bt.T as int32 (a [..., M, K] int, bt [N, K])."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), bt.to(torch.int32).T)
    return torch.matmul(a.double(), bt.double().T).to(torch.int32)


def combine(accs, epilogue: str, scale: float = 1.0) -> torch.Tensor:
    """The f32 epilogue of B6-limb on its int32 accumulators, in the
    kernel's order (each product by a power of two is exact)."""
    f = [a.float() for a in accs]
    if epilogue == "probe3":
        return f[0] * 128.0 + f[1]
    s = torch.tensor(scale, dtype=torch.float32, device=f[0].device)
    if epilogue == "wire2":
        return (f[0] * 32768.0 + f[1] * 128.0 + f[2] * 256.0 + f[3]) * s
    if epilogue == "wire1":
        return (f[0] * 256.0 + f[1]) * s
    raise ValueError(f"unknown epilogue {epilogue!r}; one of "
                     f"{list(EPILOGUES)}")


def _accumulators(epilogue, a, b):
    """The int32 accumulators of an epilogue from the A rows and B
    operands, as the kernel pairs them."""
    if epilogue == "probe3":  # hh, and hl + lh summed in int32
        return [int_dot(a[0], b[0]), int_dot(a[0], b[1]) + int_dot(a[1], b[0])]
    if epilogue == "wire2":  # hh, lh, hl, ll
        return [int_dot(a[0], b[0]), int_dot(a[1], b[0]),
                int_dot(a[0], b[1]), int_dot(a[1], b[1])]
    if epilogue == "wire1":
        return [int_dot(a[0], b[0]), int_dot(a[1], b[0])]
    raise ValueError(f"unknown epilogue {epilogue!r}; one of "
                     f"{list(EPILOGUES)}")


# --- plain versions -------------------------------------------------------


def i8_gemm_plain(a, bt, rows=None, lda=None) -> torch.Tensor:
    x, rows, lda = _as_signal(a, rows, lda)
    return int_dot(windows(x, rows, lda, bt.shape[1]), bt)


def limb_gemm_plain(a0, a1, b0, b1, epilogue, scale=1.0, rows=None,
                    lda=None) -> torch.Tensor:
    x0, _, _ = _as_signal(a0, rows, lda)
    x1, rows, lda = _as_signal(a1, rows, lda)
    k = b0.shape[1]
    a = [windows(x0, rows, lda, k), windows(x1, rows, lda, k)]
    return combine(_accumulators(epilogue, a, [b0, b1]), epilogue, scale)


def limb_gemm_i16_plain(x, b0, b1, epilogue, scale=1.0, rows=None,
                        lda=None) -> torch.Tensor:
    hi, lo = i16_limb_bytes(x)
    return limb_gemm_plain(hi, lo, b0, b1, epilogue, scale, rows, lda)


def bf16_gemm_plain(a, bt) -> torch.Tensor:
    """a [..., M, K] bf16 @ bt.T in f32 (each bf16 product is exact in
    f32; the sums run in the backend's order)."""
    return torch.matmul(a.float(), bt.float().T)


def row_scale(x: torch.Tensor) -> torch.Tensor:
    """K11's per-row scale of f32 rows [..., K]: max(amax, 1e-30) *
    f32(1/16256), [..., 1] (its first pass)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    inv = torch.tensor(_INV_QMAX, dtype=torch.float32, device=x.device)
    return torch.clamp_min(amax, _AMAX_FLOOR) * inv


def _limbs(q: torch.Tensor):
    hi = torch.clamp(torch.round(q * (1.0 / 128.0)), -127.0, 127.0)
    return hi.to(torch.int8), (q - hi * 128.0).to(torch.int8)


def quantize_rows(x: torch.Tensor):
    """K11's in-kernel quantization of f32 rows, the probe's variant: (hi,
    lo) int8 limbs and the per-row s*128 (the probe's :66-70; q = rint(x /
    s), round = half to even)."""
    s = row_scale(x)
    return (*_limbs(torch.round(x / s)), s * 128.0)


def quantize_rows_ref(x: torch.Tensor):
    """The reference variant's quantization (`int8_backend.py:77-89`,
    `_quantize_dynamic` as XLA lowers it): (hi, lo) int8 limbs and the
    per-row s, [..., 1]; q = rint(x * f32(1/s)), x ~= (128*hi + lo) * s."""
    s = row_scale(x)
    return (*_limbs(torch.round(x * torch.reciprocal(s))), s)


def fusedq_gemm_plain(x, bt, b2t) -> torch.Tensor:
    xh, xl, s128 = quantize_rows(x.float())
    acc = combine(_accumulators("probe3", [xh, xl], [bt, b2t]), "probe3")
    return acc * s128


def fusedq_ref_gemm_plain(x, bh_t, bl_t, cs) -> torch.Tensor:
    """`dot_i8x2` (`int8_backend.py:101-118`) on the basis's limbs as Bt [N,
    K] and its per-column scale cs [N]: hh = xh . bh, cross = xh . bl + xl
    . bh, (f32(hh)*128 + f32(cross)) * ((128*s) * cs)."""
    xh, xl, s = quantize_rows_ref(x.float())
    acc = combine(_accumulators("probe3", [xh, xl], [bh_t, bl_t]), "probe3")
    return acc * ((128.0 * s) * cs)


# --- kernels ---------------------------------------------------------------


def _check_b(what, bt, dtype, k=None):
    if bt.dtype != dtype or bt.ndim != 2 or not bt.is_contiguous():
        raise ValueError(f"{what}: B must be a contiguous {dtype} [N, K], got "
                         f"{bt.dtype} {tuple(bt.shape)}")
    n, kb = bt.shape[0], bt.shape[1] * bt.element_size()
    if n % TILE or kb % TILE or (k is not None and bt.shape[1] != k):
        raise ValueError(f"{what}: B [N, K] = {tuple(bt.shape)} must have N "
                         f"and K bytes multiples of {TILE}")


def _launch(what, mode, xs, bts, rows, lda, out_dtype, scale=1.0):
    """One B6 gemm launch on signals xs [..., L] (same shape) and Bt's."""
    x0 = xs[0]
    cuda_build.require_cuda(what, *xs, *bts)
    n, k = bts[0].shape
    es = x0.element_size()
    lead = x0.shape[:-1]
    batch = int(np.prod(lead)) if lead else 1
    length = x0.shape[-1]
    for x in xs:
        if x.shape != x0.shape or not x.is_contiguous():
            raise ValueError(f"{what}: A operands must be contiguous and of "
                             f"one shape, got {[tuple(v.shape) for v in xs]}")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: A must be 16-byte aligned")
    windows(x0, rows, lda, k)  # raises if the rows overrun the signal
    if (lda * es) % 16 or (batch > 1 and (length * es) % 16):
        raise ValueError(f"{what}: row stride {lda} and signal length "
                         f"{length} must be multiples of 16 bytes")
    ktile = sm90_budget(mode)["ktile_a_bytes"]
    tile_plan(rows, lda, k, es, length, ktile)  # the TMA kernel's geometry
    out = torch.empty(lead + (rows, n), dtype=out_dtype, device=x0.device)
    cuda_build.launch(
        "crlot_b6_gemm", x0.device, mode, x0.data_ptr(), xs[-1].data_ptr(),
        lda * es, length * es, bts[0].data_ptr(), bts[-1].data_ptr(), k * es,
        out.data_ptr(), n, rows * n, rows, n, batch, float(np.float32(scale)))
    return out


def i8_gemm_cuda(a, bt, rows=None, lda=None) -> torch.Tensor:
    """Launch B6-i8: int8 A (matrix or windows) @ bt.T -> int32."""
    global launches
    x, rows, lda = _as_signal(a, rows, lda)
    if x.dtype != torch.int8:
        raise ValueError(f"B6-i8 takes int8 A, got {x.dtype}")
    _check_b("B6-i8", bt, torch.int8)
    out = _launch("B6-i8", _MODE_I32, [x], [bt], rows, lda, torch.int32)
    launches["i8"] += 1
    return out


def limb_gemm_cuda(a0, a1, b0, b1, epilogue, scale=1.0, rows=None,
                   lda=None) -> torch.Tensor:
    """Launch B6-limb on int8 limbs: the three products of "probe3" (K10)
    in one launch. The wire epilogues take int16 samples
    (`limb_gemm_i16_cuda`)."""
    if epilogue != "probe3":
        raise ValueError(f"B6-limb on int8 limbs runs 'probe3', got "
                         f"{epilogue!r}; the wire epilogues take int16 "
                         f"samples (limb_gemm_i16)")
    x0, _, _ = _as_signal(a0, rows, lda)
    x1, rows, lda = _as_signal(a1, rows, lda)
    if x0.dtype != torch.int8 or x1.dtype != torch.int8:
        raise ValueError(f"B6-limb probe3: both limbs must be int8, got "
                         f"{x0.dtype}, {x1.dtype}")
    for bt in (b0, b1):
        _check_b("B6-limb", bt, torch.int8, k=b0.shape[1])
    out = _launch("B6-limb", _MODE_PROBE3, [x0, x1], [b0, b1], rows, lda,
                  torch.float32, scale)
    launches["limb"] += 1
    return out


def limb_gemm_i16_cuda(x, b0, b1, epilogue, scale=1.0, rows=None,
                       lda=None) -> torch.Tensor:
    """Launch B6-limb on int16 samples (a matrix [..., M, K] or, with rows
    and lda, windows of a signal): the kernel splits each sample into its
    limbs on chip and runs the wire epilogue's products in one launch."""
    if epilogue not in I16_MODES:
        raise ValueError(f"B6-limb on int16 takes an epilogue of "
                         f"{list(I16_MODES)}, got {epilogue!r}")
    x, rows, lda = _as_signal(x, rows, lda)
    if x.dtype != torch.int16:
        raise ValueError(f"B6-limb on int16 takes int16 A, got {x.dtype}")
    bts = [b0, b1][:EPILOGUES[epilogue]]
    for bt in bts:
        _check_b("B6-limb", bt, torch.int8, k=b0.shape[1])
    out = _launch("B6-limb", I16_MODES[epilogue], [x], bts, rows, lda,
                  torch.float32, scale)
    launches["limb"] += 1
    return out


def bf16_gemm_cuda(a, bt) -> torch.Tensor:
    """Launch B6-bf16: a [..., M, K] bf16 @ bt.T -> f32."""
    x, rows, lda = _as_signal(a, None, None)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"B6-bf16 takes bf16 A, got {x.dtype}")
    _check_b("B6-bf16", bt, torch.bfloat16)
    out = _launch("B6-bf16", _MODE_BF16, [x], [bt], rows, lda, torch.float32)
    launches["bf16"] += 1
    return out


def _fusedq_launch(variant, x, bt, b2t, cs=None) -> torch.Tensor:
    """One K11 launch (its row-scale pass and the TMA + wgmma kernel) on x
    f32 [M, K] and Bt's [N, K] int8 limbs; cs f32 [N] for "ref"."""
    what = f"K11 ({variant})"
    cuda_build.require_cuda(what, x, bt, b2t, *([] if cs is None else [cs]))
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous f32 [M, K], got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: A must be 16-byte aligned")
    for b in (bt, b2t):
        _check_b(what, b, torch.int8, k=k)
    n = bt.shape[0]
    if cs is not None and (cs.dtype != torch.float32 or cs.shape != (n,)
                           or not cs.is_contiguous()):
        raise ValueError(f"{what}: cs must be contiguous f32 [{n}], got "
                         f"{cs.dtype} {tuple(cs.shape)}")
    s = torch.empty((2, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    cuda_build.launch(
        "crlot_b6_fusedq", x.device, 0 if cs is None else 1, x.data_ptr(), m,
        k, bt.data_ptr(), b2t.data_ptr(), 0 if cs is None else cs.data_ptr(),
        s.data_ptr(), out.data_ptr(), n)
    return out


def fusedq_gemm_cuda(x, bt, b2t) -> torch.Tensor:
    """Launch K11, the probe's variant: x f32 [M, K] quantized per row in
    the kernel (q = rint(x / s)), times Bt's [N, K] limbs b and b2."""
    out = _fusedq_launch("probe", x, bt, b2t)
    launches["fusedq"] += 1
    return out


def fusedq_ref_gemm_cuda(x, bh_t, bl_t, cs) -> torch.Tensor:
    """Launch K11, `dot_i8x2`'s variant: x f32 [M, K] quantized per row in
    the kernel (q = rint(x * (1/s))), times the basis's limbs bh, bl as Bt
    [N, K], scaled by (128*s) * cs[col]."""
    out = _fusedq_launch("ref", x, bh_t, bl_t, cs)
    launches["fusedq_ref"] += 1
    return out


# --- dispatch: the plain version for a CPU tensor, else the kernel ---------


def i8_gemm(a, bt, rows: Optional[int] = None, lda: Optional[int] = None):
    if a.device.type == "cpu":
        return i8_gemm_plain(a, bt, rows, lda)
    return i8_gemm_cuda(a, bt, rows, lda)


def limb_gemm(a0, a1, b0, b1, epilogue, scale=1.0, rows=None, lda=None):
    if a0.device.type == "cpu":
        return limb_gemm_plain(a0, a1, b0, b1, epilogue, scale, rows, lda)
    return limb_gemm_cuda(a0, a1, b0, b1, epilogue, scale, rows, lda)


def limb_gemm_i16(x, b0, b1, epilogue, scale=1.0, rows=None, lda=None):
    if x.device.type == "cpu":
        return limb_gemm_i16_plain(x, b0, b1, epilogue, scale, rows, lda)
    return limb_gemm_i16_cuda(x, b0, b1, epilogue, scale, rows, lda)


def bf16_gemm(a, bt):
    if a.device.type == "cpu":
        return bf16_gemm_plain(a, bt)
    return bf16_gemm_cuda(a, bt)


def fusedq_gemm(x, bt, b2t):
    if x.device.type == "cpu":
        return fusedq_gemm_plain(x, bt, b2t)
    return fusedq_gemm_cuda(x, bt, b2t)


def fusedq_ref_gemm(x, bh_t, bl_t, cs):
    if x.device.type == "cpu":
        return fusedq_ref_gemm_plain(x, bh_t, bl_t, cs)
    return fusedq_ref_gemm_cuda(x, bh_t, bl_t, cs)
