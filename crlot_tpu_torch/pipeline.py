"""Single-device STFT / iSTFT / round-trip pipeline, in torch.

Counterpart of `crlot_tpu/pipeline.py`. The reference picks its formulation
from `jax.default_backend()`; the port picks it from the config and the
spectral fn alone (`formulation_for`), so the CPU tests run the same
branches as the card. Only the innermost call depends on the tensor's
device: a kernel on CUDA, its plain version on the CPU.

Branches of `round_trip` (names returned by `formulation_for`):

* "fused_rt_frames": the opt-in `cfg.fused_roundtrip` identity, through the
  B3 kernel's round-trip frames (`fft/fused_rt.py`) and the B1 OLA kernel;
* "blocked": identity and fixed per-bin responses (EQ, FIR, gain) as one
  hop-block Toeplitz product with the OLA and 1/COLA folded in
  (`blocked_composed_round_trip`, its constants from
  `fft/matmul_backend.blocked_plan`);
* "fused_rt_ola": a nonlinear packed fn whose packed chain has a full B2
  epilogue menu, through the B2 kernel (`fft/fused_rt.py`);
* "packed_parts": any other packed fn: folded forward, `fn.packed`, folded
  inverse, then the B1 OLA kernel; at HIGH on the card the fold, the
  products and the unfold run on B2's kernels launched one by one
  (`fft/fused_rt.packed_engine`), elsewhere in torch ops;
* "tiled_i8": the identity at `FftPrecision.INT8X2` where the blocked
  formulation does not apply (N % hop != 0, or too few frames) and the
  tiled layout does (N % 256 == 0): the tiled round-trip's four products
  on K11 (`fft/int8_backend.roundtrip_folded_tiled_i8`), then B1;
* "tiled": the same identity at HIGH or HIGHEST, its products IEEE fp32
  (`fft/matmul_backend.roundtrip_folded_tiled`), then B1;
* "composed": a fixed per-bin response where the blocked formulation does
  not apply, at every tier: the frames times one [N, N] matrix
  (`fft/matmul_backend.roundtrip_composed_matmul`; B0 at HIGH where its
  tiles take N), then B1;
* "folded": the identity at any other N <= 4096, four half-size products
  (`fft/matmul_backend.roundtrip_folded_matmul`), then B1. The reference
  sends an odd N to its packed products instead, but `StftConfig` takes
  only an even N, in both packages, so that branch is never reached and
  the port has none;
* "stft_istft": everything else, `stft` -> fn -> `istft` (B1 for the OLA).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from .core import device as _device
from .core.consts import as_f32, const_on, design_cache
from .core.padding import pad_signal, pad_signal_into
from .core.types import FftBackend, FftPrecision, StftConfig
from .fft import dispatch as _fft
from .fft import fused_rt as _rt
from .fft.fused_rt import (
    fused_rt_supported,
    roundtrip_frames_fused,
    roundtrip_signal_fused,
)
from .fft.matmul_backend import (
    MAX_MATMUL_NFFT,
    blocked_chunk_geometry,
    blocked_plan_for,
    blocked_response,
    composed_block_supported,
    fold_windowed,
    folded_consts_on,
    folded_forward,
    folded_inverse,
    hopblock_extent,
    hopblock_product,
    roundtrip_composed_matmul,
    roundtrip_folded_matmul,
    roundtrip_folded_tiled,
    tiled_supported,
)
from .fft.int8_backend import roundtrip_folded_tiled_i8
from .frame.framing import frame_signal
from .ola.fused import ola_normalized_auto
from .ola.norm import edge_norm
from .profiling import span
from .resample.polyphase import resample
from .spectral import epilogue_of
from .window.windows import get_window


@design_cache(None)
def _window_np(cfg: StftConfig) -> np.ndarray:
    return get_window(cfg.window, cfg.frame_size, cfg.periodic)


@design_cache(None)
def _window_f64(cfg: StftConfig) -> np.ndarray:
    return get_window(cfg.window, cfg.frame_size, cfg.periodic, dtype=np.float64)


# Bounded as its callers' caches are: a norm is as long as its signal
# (11.5 MB for a 60 s clip at 48 kHz), and a stream of clips of varying
# length would otherwise keep one for every length it has seen.
@design_cache(8)
def _norm_np(cfg: StftConfig, num_frames: int, out_len: int) -> np.ndarray:
    w = _window_np(cfg).astype(np.float64)
    contrib = w * w if cfg.synthesis_window else w
    return edge_norm(contrib, cfg.hop_size, num_frames, out_len)


@design_cache(8)
def _norm_on(cfg: StftConfig, num_frames: int, out_len: int,
             device: torch.device) -> torch.Tensor:
    return as_f32(_norm_np(cfg, num_frames, out_len), device)


def _synthesis(frames: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    if not cfg.synthesis_window:
        return frames
    return frames * const_on(_window_np(cfg), frames.device)


def stft(signal, cfg: StftConfig, device=None) -> torch.Tensor:
    """`[..., L]` real -> `[..., F, nfft//2+1]` complex64 spectrogram. An
    array-like goes to `device` (default "cuda"; `core/device.py`)."""
    signal = _device.place(signal, device)
    frames = frame_signal(signal, cfg.frame_spec)
    return _fft.rfft_windowed(
        frames, cfg.frame_size, _window_f64(cfg), backend=cfg.fft_backend
    )


def resampled_stft(
    signal: torch.Tensor,
    sr_in: int,
    sr_out: int,
    cfg: StftConfig,
    taps_per_phase: Optional[int] = None,
    atten_db: float = 120.0,
    device=None,
) -> torch.Tensor:
    """Polyphase resample (B4 on CUDA) -> frame -> window -> rFFT: the
    `[..., F, nfft//2+1]` spectrogram at the OUTPUT rate sr_out. The
    resampled signal stays on the device between the two stages."""
    y = resample(signal, sr_in, sr_out, taps_per_phase, atten_db,
                 device=device)
    return stft(y, cfg)


def istft(
    spec, cfg: StftConfig, length: Optional[int] = None, device=None
) -> torch.Tensor:
    """`[..., F, nfft//2+1]` complex -> `[..., length]` real (default: the
    span an stft of that many frames covers, minus center padding)."""
    spec = _device.place(spec, device)
    pad = cfg.frame_spec.pad_amount
    out = _istft_uncropped(spec, cfg)
    if length is None:
        length = out.shape[-1] - 2 * pad
    return out[..., pad : pad + length]


def _istft_uncropped(spec: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """`istft`'s overlap-added, normalized frames over their whole span,
    the center padding included."""
    num_frames = spec.shape[-2]
    frames = _fft.irfft(spec, cfg.frame_size, backend=cfg.fft_backend)
    frames = _synthesis(frames, cfg)
    full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
    norm = _norm_on(cfg, num_frames, full, frames.device)
    return ola_normalized_auto(frames, norm, cfg.hop_size, full, cfg.eps)


@design_cache(8)
def blocked_norm_fold(cfg: StftConfig, num_frames: int):
    """(norm_arr, full, edge, fold_ok): fold_ok when the interior COLA sum
    is constant (to 1e-9 relative), so 1/norm folds into the blocked kernel
    at design time and only the 2*(R-1)*hop edge samples divide by the true
    norm. The reference's counterpart; the port's routes take the same
    decision from their `blocked_plan`, for every frame count."""
    full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
    norm_arr = _norm_np(cfg, num_frames, full)
    edge = (cfg.frame_size // cfg.hop_size - 1) * cfg.hop_size
    interior = norm_arr[edge : full - edge]
    fold_ok = bool(
        interior.size > 0
        and interior[0] > 0
        and np.max(np.abs(interior - interior[0])) <= 1e-9 * interior[0]
    )
    return norm_arr, full, edge, fold_ok


def blocked_composed_round_trip(
    signal: torch.Tensor, cfg: StftConfig, per_bin: np.ndarray
) -> torch.Tensor:
    """round_trip's "blocked" branch as a gate-free program: B0's extended
    input written once (`blocked_input`), B0's hop-block product of the
    plan's folded kernel on it, the head and tail patches over their norms
    written into B0's output, and the crop, a view of that output. Caller
    contract: composed_block_supported(N, hop) and num_frames >=
    2*(N/hop - 1)."""
    spec_ = cfg.frame_spec
    full = ((spec_.num_frames(signal.shape[-1]) - 1) * cfg.hop_size
            + cfg.frame_size)
    with span("crlot.blocked.pad"):
        x_ext, edge = blocked_input(signal, cfg, full)
    with span("crlot.blocked.consts"):
        plan = blocked_plan_for(cfg, per_bin)
        kern, bt = plan.operands(signal.device, cfg.fft_precision)
    x, span_p = x_ext[..., edge : edge + full], plan.patch_span
    with span("crlot.blocked.b0"):
        out = hopblock_product(x_ext, kern, plan.gh, cfg.fft_precision,
                               bt)[..., :full]
    with span("crlot.blocked.edges"):
        head = plan.edge_patch(x[..., :span_p], "head")
        tail = plan.edge_patch(x[..., full - span_p :], "tail")
    with span("crlot.blocked.join"):
        out[..., :edge].copy_(head)
        plan.interior_(out[..., edge : full - edge])
        out[..., full - edge :].copy_(tail)
    pad = spec_.pad_amount
    with span("crlot.round_trip.crop"):
        return out[..., pad : pad + signal.shape[-1]]


def blocked_input(signal: torch.Tensor, cfg: StftConfig,
                  full: int) -> tuple:
    """(x_ext, edge): the blocked one-shot's B0 input, float32 [..., L],
    each sample written once: the first `full` samples of the
    centre-padded signal (`pad_signal_into`), after `edge` zeros (B0's
    look-back halo) and before zeros to the end of B0's last window
    (`hopblock_extent`), the zeros written last. Equal to
    `F.pad(pad_signal(signal, ...)[..., :full].float(), (edge, right))`."""
    geo = blocked_chunk_geometry(cfg.frame_size, cfg.hop_size)
    edge = geo["edge"]
    _, length = hopblock_extent(full, geo["gh"], geo["mg"])
    x_ext = torch.empty(signal.shape[:-1] + (length,), dtype=torch.float32,
                        device=signal.device)
    spec_ = cfg.frame_spec
    pad_signal_into(x_ext[..., edge : edge + full], signal, spec_.pad_amount,
                    spec_.pad_amount, spec_.pad_mode, spec_.pad_value)
    x_ext[..., :edge].zero_()
    x_ext[..., edge + full :].zero_()
    return x_ext, edge


def _blocked_ok(cfg: StftConfig, n_samples: int) -> bool:
    return composed_block_supported(cfg.frame_size, cfg.hop_size) and (
        cfg.frame_spec.num_frames(n_samples)
        >= 2 * (cfg.frame_size // cfg.hop_size - 1)
    )


def formulation_for(
    cfg: StftConfig, spectral_fn: Optional[Callable], n_samples: int
) -> str:
    """The branch `round_trip(signal[..., n_samples], cfg, spectral_fn)`
    takes: "fused_rt_frames", "blocked", "composed", "tiled_i8", "tiled",
    "folded", "fused_rt_ola", "packed_parts" or "stft_istft".
    Each is the reference accelerator's choice at the same gates
    (`crlot_tpu/pipeline.py`'s round_trip with a "tpu" backend); a
    frames-level route needs at least one frame."""
    return _formulation(cfg, spectral_fn, n_samples,
                        blocked_response(cfg, spectral_fn))


def _formulation(cfg: StftConfig, spectral_fn: Optional[Callable],
                 n_samples: int, response: Optional[np.ndarray]) -> str:
    """`formulation_for` with the fn's `blocked_response` resolved."""
    matmul_ok = cfg.fft_backend in (FftBackend.AUTO, FftBackend.MATMUL)
    nfft, hop = cfg.frame_size, cfg.hop_size
    has_frames = cfg.frame_spec.num_frames(n_samples) > 0
    if not matmul_ok:
        return "stft_istft"
    if (
        spectral_fn is None
        and cfg.fused_roundtrip
        and cfg.fft_precision == FftPrecision.HIGH
        and fused_rt_supported(nfft, hop)
        and has_frames
    ):
        return "fused_rt_frames"
    if response is not None:
        if _blocked_ok(cfg, n_samples):
            return "blocked"
        if not has_frames:
            return "stft_istft"
        if spectral_fn is not None:
            return "composed"
        if tiled_supported(nfft):
            return ("tiled_i8" if cfg.fft_precision == FftPrecision.INT8X2
                    else "tiled")
        return "folded"
    if spectral_fn is None or not hasattr(spectral_fn, "packed"):
        return "stft_istft"
    if (
        not cfg.synthesis_window
        and cfg.fft_precision == FftPrecision.HIGH
        and fused_rt_supported(nfft, hop)
        and has_frames
        and epilogue_of(spectral_fn) is not None
    ):
        return "fused_rt_ola"
    if nfft % 256 == 0 and nfft <= MAX_MATMUL_NFFT:
        return "packed_parts"
    return "stft_istft"


def round_trip(
    signal,
    cfg: StftConfig,
    spectral_fn: Optional[Callable] = None,
    device=None,
) -> torch.Tensor:
    """stft -> (spectral processing) -> istft, output the length of the
    input. The identity round-trip must reconstruct at > 60 dB SNR. A
    tensor is processed on its own device; an array-like goes to `device`
    (default "cuda", which raises without a card; "cpu" asks for the CPU).

    While a profiler records, a call is the span `crlot.round_trip` (its
    `route`, `rows` and `samples`, the constants it built and kernels it
    launched, and on "packed_parts" `frame_bytes`, `packed_frame_bytes`)
    over its stages: `crlot.round_trip.plan` (the fn's
    `blocked_response`, resolved once a call, the route, and the window on
    routes but "blocked"), the route's own stages and
    `crlot.round_trip.crop` (`profiling.span`)."""
    with span("crlot.round_trip") as call:
        signal = _device.place(signal, device)
        n = signal.shape[-1]
        with span("crlot.round_trip.plan"):
            response = blocked_response(cfg, spectral_fn)
            route = _formulation(cfg, spectral_fn, n, response)
            w64 = None if route == "blocked" else _window_f64(cfg)
        if call:
            rows = math.prod(signal.shape[:-1])
            call.note(route=route, rows=rows, samples=n)
            if route == "packed_parts":
                call.note(frame_bytes=packed_frame_bytes(
                    cfg, rows, n,
                    _rt.packed_engine(cfg.fft_precision, signal.device)))
        if route == "blocked":
            return blocked_composed_round_trip(signal, cfg, response)
        return _round_trip(signal, cfg, spectral_fn, route, w64, response)


def _round_trip(signal: torch.Tensor, cfg: StftConfig, spectral_fn,
                route: str, w64: np.ndarray, response) -> torch.Tensor:
    """`round_trip` on `route`, every route but "blocked" (`response`: the
    fn's `blocked_response`, which "composed" applies)."""
    n = signal.shape[-1]
    spec_ = cfg.frame_spec
    pad = spec_.pad_amount

    def crop(out):
        with span("crlot.round_trip.crop"):
            return out[..., pad : pad + n]

    def ola_crop(out_frames, synthesized=False):
        """OLA + COLA normalize (B1 on CUDA) + center crop; the synthesis
        window is applied here unless the frames already carry it."""
        num_frames = out_frames.shape[-2]
        full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
        return crop(ola_normalized_auto(
            out_frames if synthesized else _synthesis(out_frames, cfg),
            _norm_on(cfg, num_frames, full, signal.device),
            cfg.hop_size, full, cfg.eps,
        ))

    if route == "fused_rt_frames":
        padded = pad_signal(
            signal, pad, pad, spec_.pad_mode, spec_.pad_value
        )
        return ola_crop(roundtrip_frames_fused(
            padded, cfg.frame_size, cfg.hop_size, spec_.num_frames(n), w64,
        ))
    if route == "fused_rt_ola":
        num_frames = spec_.num_frames(n)
        with span("crlot.fused_rt.pad"):
            padded = pad_signal(
                signal, pad, pad, spec_.pad_mode, spec_.pad_value
            )
        full = (num_frames - 1) * cfg.hop_size + cfg.frame_size
        with span("crlot.fused_rt.consts"):
            norm = _norm_on(cfg, num_frames, full, signal.device)
        return crop(roundtrip_signal_fused(
            padded, cfg.frame_size, cfg.hop_size, num_frames, w64, norm,
            cfg.eps, spectral_packed=spectral_fn.packed,
        ))
    if route in ("composed", "folded"):
        # Both apply the synthesis window themselves (composed: folded into
        # its matrix).
        syn = w64 if cfg.synthesis_window else None
        frames = frame_signal(signal, spec_)
        if route == "composed":
            out_frames = roundtrip_composed_matmul(
                frames, cfg.frame_size, w64, response, syn, cfg.fft_precision)
        else:
            out_frames = roundtrip_folded_matmul(frames, cfg.frame_size, w64,
                                                 syn)
        return ola_crop(out_frames, synthesized=True)
    if route in ("tiled_i8", "tiled"):
        rt = (roundtrip_folded_tiled_i8 if route == "tiled_i8"
              else roundtrip_folded_tiled)
        return ola_crop(rt(frame_signal(signal, spec_), cfg.frame_size, w64))
    if route == "packed_parts":
        return crop(_packed_parts(signal, cfg, spectral_fn))
    spec = stft(signal, cfg)
    if spectral_fn is not None:
        spec = spectral_fn(spec)
    return crop(_istft_uncropped(spec, cfg))


def packed_frame_bytes(cfg: StftConfig, rows: int, n_samples: int,
                       engine: str = "matmul") -> int:
    """The bytes of the frame-sized float32 tensors that the "packed_parts"
    route writes in a call of `rows` x `n_samples` on `engine`
    (`fft/fused_rt.packed_engine`), from the shapes: every [rows, F, *]
    output of the route's own passes and the two planes the spectral fn
    returns (its own temporaries are the fn's, and not counted). On
    "matmul": the windowed frames, the fold's flip, sum, cat and
    difference, the forward products, the inverse products, the unfold's
    sum, difference, flip and cat; on "rt_gemm": the fold pass's e, o and
    the forward GEMM's Re, Im (each Kp wide), the fn's planes copied into
    e, o, and the inverse GEMM's frames. Both: the synthesis window's
    product where there is one."""
    n, h = cfg.frame_size, cfg.frame_size // 2
    if engine == "rt_gemm":
        k, kp = h + 1, _rt.padded_bins(n)
        widths = (
            2 * kp + 2 * kp   # fold, forward GEMM
            + 2 * k + 2 * k   # the fn's Re, Im, copied into e, o
            + n               # inverse GEMM and unfold
        )
    else:
        widths = (
            n + (h - 1) + (h - 1) + (h + 1) + (h - 1)  # window, fold
            + 2 * (h + 1)                              # forward products
            + 2 * (h + 1)                              # the fn's Re, Im
            + (h + 1) + (h - 1) + 3 * (h - 1) + n      # inverse, unfold
        )
    widths += n if cfg.synthesis_window else 0
    return 4 * rows * cfg.frame_spec.num_frames(n_samples) * widths


def _packed_parts(signal: torch.Tensor, cfg: StftConfig,
                  spectral_fn) -> torch.Tensor:
    """round_trip's "packed_parts" route up to the crop: the folded forward
    products, `spectral_fn.packed`, the folded inverse products, then B1's
    OLA and normalize, each stage a span. The `.forward` and `.inverse`
    spans name the `engine` that ran (`fft/fused_rt.packed_engine`): on
    "rt_gemm" the centre pad then B2's fold pass, its forward GEMM with no
    menu, the fn on views of Re, Im (`fused_rt.packed_spectral`), and its
    inverse GEMM with the unfold; on "matmul" the framing, the window's
    product and the fold, two `torch.matmul`s each way and the unfold in
    torch ops."""
    spec_ = cfg.frame_spec
    nfft, hop = cfg.frame_size, cfg.hop_size
    num_frames = spec_.num_frames(signal.shape[-1])
    full = (num_frames - 1) * hop + nfft
    engine = _rt.packed_engine(cfg.fft_precision, signal.device)
    lead = signal.shape[:-1]
    with span("crlot.packed.consts"):
        if engine == "rt_gemm":
            bases = _rt.kernel_bases_on(nfft, signal.device)
        else:
            c, s, cinv, sinv = folded_consts_on(nfft, signal.device)
        window = const_on(_window_np(cfg), signal.device)
        norm = _norm_on(cfg, num_frames, full, signal.device)
    with span("crlot.packed.fold"):
        if engine == "rt_gemm":
            pad = spec_.pad_amount
            padded = pad_signal(signal, pad, pad, spec_.pad_mode,
                                spec_.pad_value)
            folded = _rt.packed_fold_cuda(
                padded.reshape(-1, padded.shape[-1]).float().contiguous(),
                nfft, hop, num_frames, window)
        else:
            folded = fold_windowed(frame_signal(signal, spec_), nfft, window)
    with span("crlot.packed.forward") as fwd:
        if fwd:
            fwd.note(frames=math.prod(lead) * num_frames, bins=nfft // 2 + 1,
                     engine=engine)
        if engine == "rt_gemm":
            parts = _rt.packed_forward_cuda(*folded, nfft, bases[:4])
        else:
            parts, folded = folded_forward(*folded, c, s), None
    with span("crlot.packed.fn"):
        if engine == "rt_gemm":
            parts = _rt.packed_spectral(spectral_fn.packed, *parts, *folded,
                                        (*lead, num_frames), nfft)
        else:
            parts = spectral_fn.packed(*parts)
        folded = None
    with span("crlot.packed.inverse") as inv:
        if inv:
            inv.note(engine=engine)
        if engine == "rt_gemm":
            frames = _rt.packed_inverse_cuda(*parts, nfft, bases[4:]).view(
                *lead, num_frames, nfft)
        else:
            frames = folded_inverse(*parts, cinv, sinv)
        parts = None  # the planes go before B1 allocates its output
    with span("crlot.packed.ola"):
        return ola_normalized_auto(_synthesis(frames, cfg), norm, hop, full,
                                   cfg.eps)
