"""Fused nonlinear round-trip: the B2 and B3 kernels' wrappers and their
plain versions.

Counterpart of `crlot_tpu/fft/pallas_rt.py`. `csrc/fused_rt.cu`'s one call,
`crlot_rt_frames`, runs three kernels on the frames of a signal: a fold
pass (frame -> window -> fold into the even and odd parts), the forward
half-size DFT with the spectral fn's per-bin epilogue menu
(`spectral.EpilogueOp`) on both accumulators of a tile, and the inverse
with the unfold into frame samples; both products are 3xTF32 on the tensor
cores (the reference's HIGH tier), with the bases split into their TF32
halves by the host design code (`tf32_bases`).

* B3, the frames-level route (`roundtrip_frames_fused`, the reference's
  `_rt_call` -> `_rt_kernel`), returns the [F, N] round-trip frames; the
  `cfg.fused_roundtrip` branch and the sharded round-trip overlap-add them.
  `roundtrip_of_frames` is the same kernels on any frame tensor (the scan
  form's frames, read in place at their row stride).
* B2, the signal-level route (`roundtrip_signal_fused`, the reference's
  `_rt_ola_call` -> `_rt_ola_kernel`), is B3's frames overlap-added in
  ascending frame order and divided by the COLA norm by B1's kernel
  (`ola/fused.py`).

A frame's result depends only on its own samples, so any batching of the
frames gives the same frames bit for bit. A CPU tensor takes the plain
version; a CUDA tensor launches the kernels or raises. Which spectral fns
take these routes is decided up front (a fn whose packed chain has a full
epilogue menu). A failure inside a kernel raises; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda_build
from ..frame.framing import hop_block_frames
from ..ola.fused import ola_normalized_cuda
from ..ola.reference import normalize, overlap_add
from ..spectral import (
    OP_COMPLEX,
    OP_GAIN,
    OP_GATE,
    OP_REAL_GAINS,
    OP_SUBTRACT,
)
from ..core.consts import const_on, design_cache
from ..profiling import span
from . import tf32x3
from .matmul_backend import (
    MAX_MATMUL_NFFT,
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


def padded_bins(nfft: int) -> int:
    """Kp = 8 * ceil(K / 8), K = N/2 + 1: the kernels' bin count (16-byte
    rows for TMA)."""
    return -(-(nfft // 2 + 1) // 8) * 8


@design_cache(None)
def tf32_bases(nfft: int) -> tuple:
    """The folded DFT bases as `crlot_rt_frames` reads them: each [Kp, Kp],
    K-major (row = output column), zero-padded, split into TF32 (hi, lo):
    C, S (forward: row = bin k, column = frame index n, S shifted so that
    column n is o[n]) and Cinv, Sinv (inverse: row = sample n, column = bin
    k, Sinv shifted so that row n is sample n). Returns (C hi, C lo, S hi,
    S lo, Cinv hi, Cinv lo, Sinv hi, Sinv lo)."""
    c, s = _folded_forward_consts(nfft)  # [h+1, K], [h-1, K]
    cinv, sinv = _folded_inverse_consts(nfft)  # [K, h+1], [K, h-1]
    k, h, kp = nfft // 2 + 1, nfft // 2, padded_bins(nfft)
    ct, st, cit, sit = (np.zeros((kp, kp), np.float32) for _ in range(4))
    ct[:k, : h + 1] = c.T
    st[:k, 1:h] = s.T
    cit[: h + 1, :k] = cinv.T
    sit[1:h, :k] = sinv.T
    return tuple(a for b in (ct, st, cit, sit) for a in tf32x3.split_np(b))


@design_cache(4)
def _kernel_bases_on(nfft: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in tf32_bases(nfft))


def fold_plain(frames: torch.Tensor, window_f32: torch.Tensor):
    """The fold pass's function in torch, indexed as the kernel indexes:
    frames [..., N] -> (e, o) [..., Kp] with y = frames * w, e[n] = y[n] +
    y[N-n] and o[n] = y[n] - y[N-n] for 0 < n < N/2, e[0] = y[0], e[N/2] =
    y[N/2], zeros elsewhere. Equals `_fold_frames` zero-padded, bit for
    bit."""
    nfft = frames.shape[-1]
    h, kp = nfft // 2, padded_bins(nfft)
    y = frames.float() * window_f32.to(frames.device)
    n = torch.arange(kp, device=frames.device)
    inner = (n > 0) & (n < h)
    a = y[..., torch.clamp(n, max=nfft - 1)]
    b = y[..., torch.where(inner, nfft - n, 0)]
    e = torch.where(inner, a + b, torch.where(n <= h, a, 0.0))
    o = torch.where(inner, a - b, 0.0)
    return e, o


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


def _menu(what: str, spectral_packed):
    """The spectral fn's epilogue menu (a tuple of ops), checked before
    anything else, so that a fn outside it is refused on any device."""
    ops = ()
    if spectral_packed is not None:
        ops = getattr(spectral_packed, "epilogue", None)
        if ops is None:
            raise ValueError(
                f"spectral fn has no {what} epilogue menu; route it through "
                "'packed_parts'"
            )
    return ops


def _launch_frames(what: str, x: torch.Tensor, ch_stride: int, lp: int,
                   frame_stride: int, n_frames: int, nfft: int,
                   window_f32: torch.Tensor, spectral_packed) -> torch.Tensor:
    """One `crlot_rt_frames` call on the frames of x [C, *] (frame f of
    channel c at x[c, f * frame_stride:], samples at or past lp read as 0):
    the [C * n_frames, nfft] round-trip frames."""
    ops = _menu(what, spectral_packed)
    cuda_build.require_cuda(what, x, window_f32)
    for t in (x, window_f32):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous float32 tensors")
    if x.ndim != 2:
        raise ValueError(f"{what} takes [C, L], got {tuple(x.shape)}")
    if nfft < 4 or nfft % 2 or nfft > MAX_MATMUL_NFFT:
        raise ValueError(f"{what}: unsupported N={nfft}")
    if n_frames <= 0 or window_f32.shape != (nfft,):
        raise ValueError(f"{what}: bad n_frames {n_frames} or window")
    dev = x.device
    desc_np, params_np = pack_epilogue(ops, nfft // 2 + 1)
    desc, params = const_on(desc_np, dev, np.int32), const_on(params_np, dev)
    rows, kp = x.shape[0] * n_frames, padded_bins(nfft)
    e, o, re, im = (torch.empty((rows, kp), dtype=torch.float32, device=dev)
                    for _ in range(4))
    out = torch.empty((rows, nfft), dtype=torch.float32, device=dev)
    cuda_build.launch(
        "crlot_rt_frames", dev, x.data_ptr(), ch_stride, lp, frame_stride,
        window_f32.data_ptr(),
        *(b.data_ptr() for b in _kernel_bases_on(nfft, dev)),
        desc.data_ptr(), desc_np.shape[0], params.data_ptr(), e.data_ptr(),
        o.data_ptr(), re.data_ptr(), im.data_ptr(), out.data_ptr(),
        x.shape[0], n_frames, nfft,
    )
    return out


def _check_signal(what, padded, nfft, hop):
    if not fused_rt_supported(nfft, hop):
        raise ValueError(f"{what} unsupported for N={nfft} H={hop}")
    if padded.ndim != 2:
        raise ValueError(
            f"{what} takes padded [C, Lp], got {tuple(padded.shape)}"
        )


def roundtrip_signal_cuda(
    padded: torch.Tensor, nfft: int, hop: int, n_frames: int,
    window_f32: torch.Tensor, norm: torch.Tensor, eps: float, out_len: int,
    spectral_packed=None,
) -> torch.Tensor:
    """Launch B2 over `padded[C, Lp]` (f32, contiguous, CUDA): B3's frames,
    then B1's overlap-add and divide. The spectral fn must carry an
    epilogue menu."""
    global launches
    _menu("B2", spectral_packed)
    _check_signal("B2", padded, nfft, hop)
    full = (n_frames - 1) * hop + nfft
    if padded.shape[-1] < full:
        raise ValueError(
            f"padded length {padded.shape[-1]} < span {full} of "
            f"{n_frames} frames"
        )
    cuda_build.require_cuda("B2", padded, norm)
    if norm.numel() < out_len or out_len > full:
        raise ValueError("B2: bad norm or out_len")
    lp = padded.shape[-1]
    frames = _launch_frames("B2", padded, lp, lp, hop, n_frames, nfft,
                            window_f32, spectral_packed)
    out = ola_normalized_cuda(frames.view(padded.shape[0], n_frames, nfft),
                              norm, hop, out_len, eps)
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
    _menu("B3", spectral_packed)
    _check_signal("B3", padded, nfft, hop)
    lp = padded.shape[-1]
    out = _launch_frames("B3", padded, lp, lp, hop, n_frames, nfft,
                         window_f32, spectral_packed)
    frames_launches += 1
    return out.view(padded.shape[0], n_frames, nfft)


def roundtrip_of_frames_plain(frames: torch.Tensor, nfft: int,
                              window_f32: torch.Tensor,
                              spectral_packed=None) -> torch.Tensor:
    """B3's function on a frame tensor [..., F, N], in torch ops."""
    re, im = rfft_folded_packed(frames, nfft, window_f32)
    if spectral_packed is not None:
        re, im = spectral_packed(re, im)
    return irfft_folded_parts(re, im, nfft)


def roundtrip_of_frames(frames: torch.Tensor, nfft: int,
                        window_f32: torch.Tensor,
                        spectral_packed=None) -> torch.Tensor:
    """B3's kernels on any frame tensor [..., F, N] (the scan form's): a
    CUDA tensor is read in place where it is a window view of a signal
    (`tf32x3.frame_rows`), one B3 launch; a CPU tensor takes the plain
    version. The spectral fn must carry an epilogue menu."""
    global frames_launches
    if frames.device.type == "cpu":
        return roundtrip_of_frames_plain(frames, nfft, window_f32,
                                         spectral_packed)
    x, f, lda = tf32x3.frame_rows(frames.float())
    out = _launch_frames("B3", x, x.shape[-1], x.shape[-1], lda, f, nfft,
                         window_f32.to(frames.device, torch.float32),
                         spectral_packed)
    frames_launches += 1
    return out.view(frames.shape)


# C12: B2 and B3 and their plain version decide each noise-gate bin on
# their own spectrum. A bin whose power lies within the products' error of
# the threshold may go either way in either version (another CPU's BLAS
# does it as well as 3xTF32), and a flipped bin moves its frame by up to
# |X| * (1 - att) * 2 / N. Comparisons therefore leave such frames out. The
# bound on a spectrum entry's absolute error: AMBIGUITY_REL * the sum of
# |e| and |o| over the frame's folded row (every basis entry is at most 1).
# 2^-20 of that sum is about 100 times the largest entry error measured
# between the two versions at N = 1024 (the 3xTF32 products keep about
# 2^-21 of sum |a||b|, f32 sums of K = 513 terms about sqrt(K) 2^-24); 2^-18
# flagged 33 of 22 502 frames of noise at -30 dB on the H100 (PERF.md).
AMBIGUITY_REL = 2.0 ** -20


def ambiguous_bins(re: torch.Tensor, im: torch.Tensor, delta: torch.Tensor,
                   ops) -> torch.Tensor:
    """[..., K] bool: bins where a gate of the menu `ops` may decide
    either way. `re`, `im` [..., K] the plain f32 spectrum, `delta` [...,
    1] (or [..., K]) the bound on each entry's absolute error. The menu runs
    on the plain spectrum as the kernel runs it; at each gate the power is
    taken in float64 and a bin is ambiguous when |p - thresh| <= 2 *
    sqrt(max(p, thresh)) * d + d^2, d = the bound scaled by the magnitude
    of every op before it."""
    amb = torch.zeros(re.shape, dtype=torch.bool, device=re.device)
    d = delta.double().expand(re.shape)
    for op in ops:
        per = [torch.as_tensor(np.asarray(a, np.float32), device=re.device)
               for a in op.per_bin]
        if op.code == OP_GATE:
            thresh, att = (float(np.float32(v)) for v in op.scalars)
            p = re.double().square() + im.double().square()
            amb |= (p - thresh).abs() <= (
                2.0 * torch.sqrt(torch.clamp_min(p, thresh)) * d + d * d)
            keep = (re * re + im * im) >= thresh  # the kernel's f32 power
            s = torch.where(keep, 1.0, att).to(re.dtype)
            d = d * max(1.0, abs(att))
        elif op.code == OP_GAIN:
            s = torch.full_like(re, float(np.float32(op.scalars[0])))
            d = d * abs(float(op.scalars[0]))
        elif op.code == OP_REAL_GAINS:
            s = per[0].expand(re.shape)
            d = d * per[0].double().abs()
        elif op.code == OP_COMPLEX:
            hr, hi = per
            re, im = re * hr - im * hi, re * hi + im * hr
            d = d * torch.sqrt(hr.double() ** 2 + hi.double() ** 2)
            continue
        elif op.code == OP_SUBTRACT:  # shrinks |X|: scales the error by <= 1
            alpha, floor = (float(np.float32(v)) for v in op.scalars)
            mag = torch.sqrt(re * re + im * im)
            nw = torch.maximum(mag - alpha * per[0], floor * mag)
            s = torch.where(mag > 0, nw / torch.clamp_min(mag, 1e-20), 0.0)
        else:
            raise ValueError(f"unknown epilogue opcode {op.code}")
        re, im = re * s, im * s
    return amb


def ambiguous_frames(padded: torch.Tensor, nfft: int, hop: int,
                     n_frames: int, window_f32: torch.Tensor,
                     spectral_packed=None,
                     rel: float = AMBIGUITY_REL) -> torch.Tensor:
    """[..., n_frames] bool: the frames of `padded` [..., Lp] that hold a
    bin whose gate decision is ambiguous (`ambiguous_bins`), on the plain
    version's spectrum; all False for a menu without a gate."""
    ops = () if spectral_packed is None else _menu("B2", spectral_packed)
    if not any(op.code == OP_GATE for op in ops):
        return torch.zeros(padded.shape[:-1] + (n_frames,), dtype=torch.bool,
                           device=padded.device)
    frames = hop_block_frames(padded.float(), nfft, hop, n_frames)
    e, o = fold_plain(frames, window_f32)
    delta = rel * (e.abs().sum(-1, keepdim=True) + o.abs().sum(-1, keepdim=True))
    re, im = rfft_folded_packed(frames, nfft, window_f32)
    return ambiguous_bins(re, im, delta, ops).any(-1)


def frames_cover(mask: torch.Tensor, hop: int, nfft: int,
                 length: int) -> torch.Tensor:
    """[..., length] bool: the samples that the flagged frames of `mask`
    [..., F] overlap-add into (frame f covers [f*hop, f*hop + N))."""
    f = mask.shape[-1]
    t = torch.arange(length, device=mask.device)
    lo = torch.clamp((t - nfft) // hop + 1, min=0)
    hi = torch.clamp(t // hop, max=f - 1)
    csum = torch.cat([torch.zeros(mask.shape[:-1] + (1,), dtype=torch.int64,
                                  device=mask.device),
                      mask.long().cumsum(-1)], dim=-1)
    return (csum[..., hi + 1] - csum[..., lo]) > 0


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
    with span("crlot.fused_rt.consts"):
        w32 = const_on(analysis_window_f64, padded.device)
        norm = norm.to(device=padded.device, dtype=torch.float32)
    with span("crlot.fused_rt.kernels"):
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
