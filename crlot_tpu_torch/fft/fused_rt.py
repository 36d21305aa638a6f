"""Fused nonlinear round-trip: the B2 and B3 kernels' wrappers and their
plain versions.

Counterpart of `crlot_tpu/fft/pallas_rt.py`. Both kernels live in
`csrc/fused_rt.cu` and share its frame -> window -> fold -> forward
half-size DFT -> per-bin epilogue from the spectral fn's menu
(`spectral.EpilogueOp`) -> inverse stages; the spectrum never reaches
device memory.

* B2, the signal-level route (`roundtrip_signal_fused`, the reference's
  `_rt_ola_call` -> `_rt_ola_kernel`), goes on to unfold, overlap-add in
  ascending frame order and divide by the COLA norm.
* B3, the frames-level route (`roundtrip_frames_fused`, the reference's
  `_rt_call` -> `_rt_kernel`), stores the [F, N] round-trip frames; the
  `cfg.fused_roundtrip` branch and the sharded round-trip overlap-add them.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Which spectral fns take these routes is decided up front (a fn
whose packed chain has a full epilogue menu). A failure inside a kernel
raises; nothing falls back.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import cuda_build
from ..frame.framing import hop_block_frames
from ..ola.reference import normalize, overlap_add
from ..spectral import (
    OP_COMPLEX,
    OP_GAIN,
    OP_GATE,
    OP_REAL_GAINS,
    OP_SUBTRACT,
)
from ..core.consts import const_on
from .matmul_backend import (
    _folded_forward_consts,
    _folded_inverse_consts,
    irfft_folded_parts,
    rfft_folded_packed,
)

MAX_FUSED_NFFT = 1024

launches = 0  # B2 kernel launches since import (or the caller's reset)
frames_launches = 0  # B3 kernel launches, likewise

# (opcode -> number of scalars, number of per-bin arrays)
_MENU = {
    OP_GAIN: (1, 0),
    OP_REAL_GAINS: (0, 1),
    OP_COMPLEX: (0, 2),
    OP_GATE: (2, 0),
    OP_SUBTRACT: (2, 1),
}


def fused_rt_supported(nfft: int, hop: int) -> bool:
    """The reference's gate, kept as it is until measurement says where the
    Hopper kernel should reach (its lane rule hop % 128 is a TPU rule)."""
    return (
        nfft % 2 == 0
        and 4 <= nfft <= MAX_FUSED_NFFT
        and hop >= 128
        and hop % 128 == 0
        and nfft % hop == 0
        and (nfft // hop) % 2 == 0
    )


@lru_cache(maxsize=4)
def _kernel_bases_on(nfft: int, device: torch.device):
    """The folded bases as B2 reads them: zero-padded to Kp = 8*ceil(K/8)
    columns (16-byte aligned rows, whole 8-bin tiles), with Sinv shifted so
    that column j of B is frame sample j (columns 0 and N/2 zero)."""
    c, s = _folded_forward_consts(nfft)
    cinv, sinv = _folded_inverse_consts(nfft)
    k, h = nfft // 2 + 1, nfft // 2
    kp = -(-k // 8) * 8

    def pad(a, first_col=0):
        out = np.zeros((a.shape[0], kp), np.float32)
        out[:, first_col : first_col + a.shape[1]] = a
        return out

    return tuple(
        torch.from_numpy(a).to(device)
        for a in (pad(c), pad(s), pad(cinv), pad(sinv, first_col=1))
    )


def pack_epilogue(ops, k: int):
    """Menu -> (desc int32 [n_ops, 2] of (opcode, params offset), params
    float32 [*]) in the layout csrc/fused_rt.cu reads: each op's scalars,
    then its per-bin arrays of K entries each."""
    desc, params = [], []
    off = 0
    for op in ops:
        if op.code not in _MENU:
            raise ValueError(f"unknown epilogue opcode {op.code}")
        n_s, n_b = _MENU[op.code]
        if len(op.scalars) != n_s or len(op.per_bin) != n_b:
            raise ValueError(f"epilogue op {op.code}: bad arity")
        desc.append((op.code, off))
        chunk = [np.asarray(op.scalars, np.float32)]
        for arr in op.per_bin:
            arr = np.asarray(arr, np.float32).reshape(-1)
            if arr.shape != (k,):
                raise ValueError(
                    f"epilogue op {op.code}: per-bin array of {arr.size} "
                    f"entries for K={k}"
                )
            chunk.append(arr)
        chunk = np.concatenate(chunk)
        params.append(chunk)
        off += chunk.size
    desc_a = np.asarray(desc, np.int32).reshape(-1, 2)
    params_a = np.concatenate(params) if params else np.zeros(1, np.float32)
    return desc_a, params_a.astype(np.float32)


def roundtrip_frames_plain(
    padded: torch.Tensor, nfft: int, hop: int, n_frames: int,
    window_f32: torch.Tensor, spectral_packed=None,
) -> torch.Tensor:
    """B3's function in torch ops: `[..., Lp]` -> `[..., n_frames, nfft]`
    round-trip frames (frame -> window -> folded forward ->
    `spectral_packed` -> folded inverse). A signal shorter than the frames'
    span is zero-padded, as the reference's `_rt_call` does."""
    frames = hop_block_frames(padded, nfft, hop, n_frames)
    re, im = rfft_folded_packed(frames, nfft, window_f32)
    if spectral_packed is not None:
        re, im = spectral_packed(re, im)
    return irfft_folded_parts(re, im, nfft)


def roundtrip_signal_plain(
    padded: torch.Tensor, nfft: int, hop: int, n_frames: int,
    window_f32: torch.Tensor, norm: torch.Tensor, eps: float, out_len: int,
    spectral_packed=None,
) -> torch.Tensor:
    """B2's function in torch ops: the plain round-trip frames -> plain OLA
    -> divide."""
    out_frames = roundtrip_frames_plain(
        padded, nfft, hop, n_frames, window_f32, spectral_packed
    )
    full = (n_frames - 1) * hop + nfft
    acc = overlap_add(out_frames, hop, full)
    return normalize(acc, norm[:full], eps)[..., :out_len]


def _launch_args(what: str, padded: torch.Tensor, nfft: int, hop: int,
                 n_frames: int, window_f32: torch.Tensor, spectral_packed,
                 *more: torch.Tensor):
    """Check what B2 and B3 both take, and pack the spectral fn's menu:
    returns (desc, n_ops, params, bases) on the signal's card. The menu is
    checked first, so a fn outside it is refused on any device."""
    ops = ()
    if spectral_packed is not None:
        ops = getattr(spectral_packed, "epilogue", None)
        if ops is None:
            raise ValueError(
                f"spectral fn has no {what} epilogue menu; route it through "
                "'packed_parts'"
            )
    dev = padded.device
    tensors = (padded, window_f32) + more
    cuda_build.require_cuda(what, *tensors)
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 tensors")
    if padded.ndim != 2:
        raise ValueError(
            f"{what} takes padded [C, Lp], got {tuple(padded.shape)}"
        )
    if not fused_rt_supported(nfft, hop):
        raise ValueError(f"{what} unsupported for N={nfft} H={hop}")
    if n_frames <= 0 or window_f32.shape != (nfft,):
        raise ValueError(f"{what}: bad n_frames {n_frames} or window")
    desc_np, params_np = pack_epilogue(ops, nfft // 2 + 1)
    return (
        const_on(desc_np, dev, np.int32), desc_np.shape[0],
        const_on(params_np, dev), _kernel_bases_on(nfft, dev),
    )


def roundtrip_signal_cuda(
    padded: torch.Tensor, nfft: int, hop: int, n_frames: int,
    window_f32: torch.Tensor, norm: torch.Tensor, eps: float, out_len: int,
    spectral_packed=None,
) -> torch.Tensor:
    """Launch B2 over `padded[C, Lp]` (f32, contiguous, CUDA): one grid row
    per channel. The spectral fn must carry an epilogue menu."""
    global launches
    desc, n_ops, params, (c, s, cinv, sinv) = _launch_args(
        "B2", padded, nfft, hop, n_frames, window_f32, spectral_packed, norm
    )
    full = (n_frames - 1) * hop + nfft
    if padded.shape[-1] < full:
        raise ValueError(
            f"padded length {padded.shape[-1]} < span {full} of "
            f"{n_frames} frames"
        )
    if norm.numel() < out_len or out_len > full:
        raise ValueError("B2: bad norm or out_len")
    channels = padded.shape[0]
    out = torch.empty((channels, out_len), dtype=torch.float32,
                      device=padded.device)
    cuda_build.launch(
        "crlot_rt_ola", padded.device,
        padded.data_ptr(), padded.shape[-1], window_f32.data_ptr(),
        c.data_ptr(), s.data_ptr(), cinv.data_ptr(), sinv.data_ptr(),
        norm.data_ptr(), desc.data_ptr(), n_ops, params.data_ptr(),
        out.data_ptr(), channels, nfft, hop, n_frames, out_len, float(eps),
    )
    launches += 1
    return out


def roundtrip_frames_cuda(
    padded: torch.Tensor, nfft: int, hop: int, n_frames: int,
    window_f32: torch.Tensor, spectral_packed=None,
) -> torch.Tensor:
    """Launch B3 over `padded[C, Lp]` (f32, contiguous, CUDA) ->
    `[C, n_frames, nfft]`; samples past Lp read as zero. The spectral fn
    must carry an epilogue menu."""
    global frames_launches
    desc, n_ops, params, (c, s, cinv, sinv) = _launch_args(
        "B3", padded, nfft, hop, n_frames, window_f32, spectral_packed
    )
    channels = padded.shape[0]
    out = torch.empty((channels, n_frames, nfft), dtype=torch.float32,
                      device=padded.device)
    cuda_build.launch(
        "crlot_rt_frames", padded.device,
        padded.data_ptr(), padded.shape[-1], window_f32.data_ptr(),
        c.data_ptr(), s.data_ptr(), cinv.data_ptr(), sinv.data_ptr(),
        desc.data_ptr(), n_ops, params.data_ptr(), out.data_ptr(), channels,
        nfft, hop, n_frames,
    )
    frames_launches += 1
    return out


def roundtrip_signal_fused(
    padded: torch.Tensor,
    nfft: int,
    hop: int,
    n_frames: int,
    analysis_window_f64: np.ndarray,
    norm: torch.Tensor,
    eps: float = 1e-8,
    out_len: int | None = None,
    spectral_packed=None,
) -> torch.Tensor:
    """`[..., Lp]` padded signal -> `[..., out_len]` NORMALIZED
    reconstruction (still carrying the center padding; callers crop).
    `norm` is the edge-aware COLA norm over (n_frames-1)*hop + nfft
    samples."""
    if not fused_rt_supported(nfft, hop):
        raise ValueError(f"fused round-trip unsupported for N={nfft} H={hop}")
    full = (n_frames - 1) * hop + nfft
    if out_len is None:
        out_len = full
    w32 = const_on(analysis_window_f64, padded.device)
    norm = norm.to(device=padded.device, dtype=torch.float32)
    if padded.device.type == "cpu":
        return roundtrip_signal_plain(
            padded.float(), nfft, hop, n_frames, w32, norm, eps, out_len,
            spectral_packed,
        )
    lead = padded.shape[:-1]
    flat = padded.reshape(-1, padded.shape[-1]).float().contiguous()
    out = roundtrip_signal_cuda(
        flat, nfft, hop, n_frames, w32, norm.contiguous(), eps, out_len,
        spectral_packed,
    )
    return out.reshape(tuple(lead) + (out_len,))


def roundtrip_frames_fused(
    padded: torch.Tensor,
    nfft: int,
    hop: int,
    n_frames: int,
    analysis_window_f64: np.ndarray,
    spectral_packed=None,
) -> torch.Tensor:
    """`[..., Lp]` padded signal -> `[..., n_frames, nfft]` round-trip
    frames; frame f covers padded[f*hop : f*hop + nfft], zero past Lp. The
    reference's `interpret` and `flip_mm` are TPU-only and not taken."""
    if not fused_rt_supported(nfft, hop):
        raise ValueError(f"fused round-trip unsupported for N={nfft} H={hop}")
    w32 = const_on(analysis_window_f64, padded.device)
    if padded.device.type == "cpu":
        return roundtrip_frames_plain(
            padded.float(), nfft, hop, n_frames, w32, spectral_packed
        )
    lead = padded.shape[:-1]
    flat = padded.reshape(-1, padded.shape[-1]).float().contiguous()
    out = roundtrip_frames_cuda(
        flat, nfft, hop, n_frames, w32, spectral_packed
    )
    return out.reshape(tuple(lead) + (n_frames, nfft))
