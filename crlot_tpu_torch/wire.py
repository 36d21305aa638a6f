"""Born-int16 wire ingest: the blocked round-trip on integer-born operands.

Counterpart of `crlot_tpu/wire.py`. Wire audio arrives on the device as
int16. `I16BlockedStreamer` follows `BlockedChunkStreamer`'s halo-extended
chunk protocol (one chunk of latency, resumable state) but takes int16
chunks and runs the hop-block Toeplitz interior as exact int8 x int8 ->
int32 limb products on B6 (`int8_gemm.limb_gemm_i16`, `csrc/b6_sm90.cu`):
ONE launch per chunk reads the chunk's int16 samples, splits them into
limbs on chip, computes every limb pair over the overlapping windows of
the chunk, read in place, and combines them in f32. Only the head / tail
edge-patch regions (the stream's ends) are dequantized to f32.

Limbs. The port splits every int16 code exactly: hi = x >> 8 (int8,
-128..127) and lo = x & 0xFF (an UNSIGNED byte, 0..255), x == 256*hi + lo
for all 65 536 codes; the lo products are u8 x s8. (The reference's signed
split wraps codes 32640..32767: its hi is 128 there, which its int8 cast
turns into -128; ROADMAP C1.) Int32 headroom: |lo . k_hi| <= 255*127*mg*gh
= 66.3 M at mg*gh = 2048 (ROADMAP C2), far below 2^31.

Tiers:
  int8x2 (default)  two-limb ~15-bit kernel, 4 limb products: hh, lh, hl,
                    ll, combined as (hh*32768 + lh*128 + hl*256 + ll) *
                    (k_scale / 32768).
  int8x1            one 8-bit kernel limb, 2 products: (h*256 + l) * ...

The integer interior is exactly chunk-size invariant (int32 sums are
exact), so the output is bit-identical across chunk sizes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from . import int8_gemm as b6
from .int8_gemm import i16_limbs  # noqa: F401  (the exact split, C1)
from .core import device as _device
from .core.types import StftConfig
from .fft.matmul_backend import BlockedPlan
from .streaming_pipeline import _HaloChunkStreamer

_TIERS = ("int8x2", "int8x1")

# int16 full-scale: wire samples are x_f = x_i16 / 32768.
_I16_SCALE = 32768.0


@lru_cache(maxsize=16)
def _i16_kernel_consts(plan: BlockedPlan, tier: str) -> dict:
    """The plan's folded runtime kernel (`kern`, the one the f32 streamer
    runs) and its design-time integer limbs with their `k_scale`,
    quantized byte for byte as the reference quantizes it (numpy)."""
    out = {"kern": plan.kernel()}
    kern = np.asarray(out["kern"], np.float64)  # [mg*gh, gh]
    kmax = float(np.max(np.abs(kern)))
    if kmax == 0.0:
        kmax = 1.0
    if tier == "int8x1":
        s1 = kmax / 127.0
        out["k_i8"] = np.clip(np.rint(kern / s1), -127, 127).astype(np.int8)
        out["k_scale"] = s1
    else:
        # Two-limb kernel: k ~= (k_hi*128 + k_lo) * s2, |k_hi|,|k_lo|<=127.
        s2 = kmax / 16256.0  # 127*128
        kq = np.clip(np.rint(kern / s2), -16256, 16256).astype(np.int32)
        k_hi_i = np.round(kq / 128.0).astype(np.int32)
        out["k_hi"] = k_hi_i.astype(np.int8)
        out["k_lo"] = (kq - k_hi_i * 128).astype(np.int8)
        out["k_scale"] = s2
    return out


@lru_cache(maxsize=8)
def _i16_limbs_on(plan: BlockedPlan, tier: str,
                  device: torch.device) -> list:
    """The kernel limbs as B6's B operands, [gh, mg*gh] int8 (K-contiguous),
    on `device`."""
    c = _i16_kernel_consts(plan, tier)
    names = ("k_i8",) if tier == "int8x1" else ("k_hi", "k_lo")
    return [torch.from_numpy(np.ascontiguousarray(c[k].T)).to(device)
            for k in names]


def _hopblock_apply_i8(x_i8, kt_i8, block: int, n_out: int) -> torch.Tensor:
    """The reference's `_hopblock_apply_i8` as one B6-i8 product: int8
    [..., L] (zero-padded on the right as the reference pads it) against
    the kernel limb given as Bt [block, mg*block] -> exact int32
    [..., n_out]. Row bg reads x[bg*block : bg*block + mg*block] in place;
    the int32 sum equals the reference's m-ordered sum of mg shifted dots."""
    mg = kt_i8.shape[1] // block
    nb = -(-n_out // block)
    right = (nb - 1 + mg) * block - x_i8.shape[-1]
    if right > 0:
        x_i8 = torch.cat(
            [x_i8, x_i8.new_zeros(x_i8.shape[:-1] + (right,))], dim=-1)
    acc = b6.i8_gemm(x_i8.contiguous(), kt_i8, rows=nb, lda=block)
    return acc.reshape(acc.shape[:-2] + (nb * block,))[..., :n_out]


class I16BlockedStreamer(_HaloChunkStreamer):
    """Resumable chunk streamer for born-int16 wire audio on the blocked
    formulation's integer tier.

    Same protocol as `streaming_pipeline.BlockedChunkStreamer`: feed
    equal-shape G*hop-aligned int16 [..., S] chunks with `feed()` (returns
    the reconstructed PREDECESSOR chunk), drain the last with `finish()`;
    `state()`/`load_state()` checkpoint and resume bit-identically. With
    `emit_i16=True` (default) the output chunks are int16 wire samples.
    Numpy chunks go to `device` (default "cuda")."""

    _unsupported = ("config not supported by the blocked streamer (see "
                    "blocked_stream_supported); the integer wire tier has no "
                    "scan fallback")

    def __init__(
        self,
        cfg: StftConfig,
        spectral_fn=None,
        tier: str = "int8x2",
        emit_i16: bool = True,
        device=None,
    ) -> None:
        if tier not in _TIERS:
            raise ValueError(f"tier must be one of {_TIERS}, got {tier!r}")
        super().__init__(cfg, spectral_fn, device)
        self.tier = tier
        self.emit_i16 = emit_i16

    def _place(self, chunk) -> torch.Tensor:
        t = super()._place(chunk)
        if t.dtype != torch.int16:
            raise TypeError(f"wire chunks must be int16, got {t.dtype}")
        return t

    def _chunk(self, lctx, mid, rctx, head, tail):
        """One halo-extended chunk on int16 wire samples: the limb products
        and their f32 combination in ONE B6-limb launch, then the interior
        norm (non-fold configs) and the f32 edge patches on the
        dequantized patch regions."""
        plan, s = self._plan, mid.shape[-1]
        c = _i16_kernel_consts(plan, self.tier)
        x_ext = torch.cat([lctx, mid, rctx], dim=-1)
        limbs = _i16_limbs_on(plan, self.tier, mid.device)
        scale = float(np.float32(c["k_scale"] / _I16_SCALE))
        epilogue = "wire1" if self.tier == "int8x1" else "wire2"
        out = b6.limb_gemm_i16(x_ext, limbs[0], limbs[-1], epilogue, scale,
                               rows=s // plan.gh, lda=plan.gh)
        out = plan.interior_(out.reshape(out.shape[:-2] + (s,)))
        out = self._splice(out, lambda a, b: x_ext[..., a:b].to(
            torch.float32) * (1.0 / _I16_SCALE), head, tail)
        if self.emit_i16:
            out = torch.clamp(torch.round(out * _I16_SCALE), -32768.0,
                              32767.0).to(torch.int16)
        return out


def i16_round_trip(
    x_i16,
    cfg: StftConfig,
    spectral_fn=None,
    tier: str = "int8x2",
    chunk_samples: Optional[int] = None,
    emit_i16: bool = True,
    device=None,
):
    """Stream an int16 signal through `I16BlockedStreamer` in
    `chunk_samples` chunks (default: one chunk covering the padded signal)
    and concatenate the output. The integer interior makes the result
    bit-identical for every valid chunk size. Numpy input goes to `device`
    (default "cuda") and comes back as numpy; a tensor stays on its
    device."""
    as_numpy = not isinstance(x_i16, torch.Tensor)
    x = _device.place(x_i16, device)
    total = x.shape[-1]
    st = I16BlockedStreamer(cfg, spectral_fn, tier, emit_i16)
    gh = st._gh
    min_s = 2 * st._edge + cfg.frame_size
    if chunk_samples is None:
        chunk_samples = max(-(-total // gh) * gh, -(-min_s // gh) * gh)
    pad = -(total % chunk_samples) % chunk_samples
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    outs = []
    for k in range(x.shape[-1] // chunk_samples):
        o = st.feed(x[..., k * chunk_samples : (k + 1) * chunk_samples],
                    force=False)
        if o is not None:
            outs.append(o)
    outs.append(st.finish(force=False))
    y = torch.cat(outs, dim=-1)[..., :total]
    return y.cpu().numpy() if as_numpy else y
