"""Sharded STFT -> process -> iSTFT -> OLA over a (channel, time) mesh.

Counterpart of `crlot_tpu/distributed/sharded_pipeline.py`. Channels shard
embarrassingly; the time axis shards into hop-aligned blocks with one
nearest-neighbour exchange each way:

  1. pull the RIGHT halo (N - H samples) to frame the trailing hops,
  2. frame + window + rFFT + spectral fn + irFFT locally (batched),
  3. local overlap-add,
  4. push the (N - H)-sample OLA tail RIGHT; the received left tail seeds
     the local accumulation before any local frame, so every position sums
     its frames in global ascending order and N shards give the same bits
     as one wherever each frame's arithmetic does not depend on the batch
     (B3, `torch.fft`, the seeded OLA).

Single controller, as the reference: one process holds one tensor per
shard on the mesh's devices (`mesh.py`) and runs the shards one after
another; `shard_map`'s per-shard body becomes a loop over a channel
group's time shards between the exchanges (`halo.py`), and the in-mesh
`psum`/`pmax` of the metrics become sums and maxima of the shards' f32
partials in a fixed shard order. The result is gathered onto the device
of shard (0, 0).

Routes are chosen from the config and the spectral fn, never from the
device (as `pipeline.formulation_for`), so the CPU tests run the card's
branches through the plain versions. Per shard, in the reference's order:
"blocked" (`blocked_per_bin`), then `shard_route`'s "composed",
"fused_rt_frames" (the B3 kernel), "packed_parts" and "stft_istft".

Constraints (checked): T % n_time == 0, block % hop == 0, block >= frame
(halos touch only immediate neighbours), center=False (pad on the host).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch

from ..core import device as _device
from ..core.consts import as_f32, const_on
from ..core.types import FftBackend, FftPrecision, StftConfig
from ..fft import dispatch as _fft
from ..fft.fused_rt import fused_rt_supported, roundtrip_frames_fused
from ..fft.matmul_backend import (
    MAX_MATMUL_NFFT,
    _bytes,
    _runtime_bt_on,
    _runtime_kernel_on,
    blocked_edge_patch,
    blocked_group_for,
    blocked_patch_span,
    hopblock_apply,
    irfft_folded_parts,
    rfft_folded_packed,
    roundtrip_composed_matmul,
)
from ..frame.framing import hop_block_frames
from ..ola.reference import overlap_add
from ..pipeline import _norm_np
from ..spectral import epilogue_of, resolve_per_bin_response
from ..window.windows import get_window
from .halo import pull_left_halo, pull_right_halo, push_right_tail
from .mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, auto_mesh


def _on_matmul(cfg: StftConfig) -> bool:
    """The reference's `_pick(backend, N) == MATMUL` as its accelerator
    decides it, from the config alone."""
    n = cfg.frame_size
    return cfg.fft_backend == FftBackend.MATMUL or (
        cfg.fft_backend == FftBackend.AUTO
        and n % 2 == 0 and n <= MAX_MATMUL_NFFT
    )


def shard_route(cfg: StftConfig, spectral_fn: Optional[Callable]) -> str:
    """The per-shard route of the masked frame formulation (when the
    blocked one does not apply): "composed", "fused_rt_frames",
    "packed_parts" or "stft_istft"."""
    n = cfg.frame_size
    on_matmul = _on_matmul(cfg)
    packed = spectral_fn is not None and hasattr(spectral_fn, "packed")
    if (
        spectral_fn is not None and on_matmul
        and resolve_per_bin_response(spectral_fn, n) is not None
    ):
        return "composed"
    if (
        packed and on_matmul
        and cfg.fft_precision == FftPrecision.HIGH
        and fused_rt_supported(n, cfg.hop_size)
        and epilogue_of(spectral_fn) is not None
    ):
        return "fused_rt_frames"
    if packed and on_matmul and n % 256 == 0:
        return "packed_parts"
    return "stft_istft"


def _local_frames(route, x_ext, cfg, spectral_fn, window_f64, n_frames):
    """[C, L] halo-extended block -> [C, n_frames, N] round-trip frames."""
    n, hop = cfg.frame_size, cfg.hop_size
    if route == "fused_rt_frames":
        return roundtrip_frames_fused(
            x_ext, n, hop, n_frames, window_f64,
            spectral_packed=spectral_fn.packed,
        )
    frames = hop_block_frames(x_ext, n, hop, n_frames)
    if route == "composed":
        return roundtrip_composed_matmul(
            frames, n, window_f64, resolve_per_bin_response(spectral_fn, n),
            precision=cfg.fft_precision,
        )
    if route == "packed_parts":
        re, im = rfft_folded_packed(frames, n, window_f64)
        return irfft_folded_parts(*spectral_fn.packed(re, im), n)
    spec = _fft.rfft_windowed(frames, n, window_f64, backend=cfg.fft_backend)
    if spectral_fn is not None:
        spec = spectral_fn(spec)
    return _fft.irfft(spec, n, backend=cfg.fft_backend)


def _blocked_local_round_trip(
    xs: list,  # one channel group's time shards, [C_local, T_block] each
    window_f64: np.ndarray,
    cfg: StftConfig,
    per_bin: np.ndarray,
    group: int,
    num_frames: int,
    t_block: int,
    n_time: int,
) -> list:
    """Sharded blocked (hop-block Toeplitz) composed round-trip: each
    shard's UN-normalized OLA accumulation.

    Every output sample is one full kernel row over the halo-extended
    block [left halo | block | right halo], accumulated in the same m order
    as the one-shot `hopblock_apply`, so the summation tree per sample does
    not depend on the mesh. The global head and tail, where the Toeplitz
    product sees phantom frames, are recomputed by `blocked_edge_patch` on
    the first and last time shard.

    Preconditions (gated by the caller): the blocked group G divides
    2(R-1) (so the kernel's look-ahead equals the halo), t_block % (G*hop)
    == 0, full-coverage frame set, num_frames >= 2*(N/hop - 1)."""
    n, hop = cfg.frame_size, cfg.hop_size
    halo = n - hop
    gh = group * hop
    span = (num_frames - 1) * hop + n
    span_p = blocked_patch_span(n, hop)
    wb = _bytes(window_f64, np.float64)
    sb = wb if cfg.synthesis_window else None
    rb = _bytes(per_bin, np.complex128)
    off = span - (n_time - 1) * t_block  # end of the span in the last block
    lefts = pull_left_halo(xs, halo)
    rights = pull_right_halo(xs, halo)
    accs = []
    for t, (x, left, right) in enumerate(zip(xs, lefts, rights)):
        kern = _runtime_kernel_on(n, hop, group, wb, sb, rb, x.device)
        if kern.shape[0] - gh - halo != halo:
            raise ValueError("blocked group must divide 2(R-1)")
        x_blk = torch.cat([left, x, right], dim=-1).float()
        bt = (_runtime_bt_on(n, hop, group, wb, sb, rb, x.device)
              if x.device.type != "cpu" else None)
        acc = hopblock_apply(x_blk, kern, gh, t_block, 0, cfg.fft_precision,
                             bt)
        if t == 0:
            acc[..., :halo] = blocked_edge_patch(
                x_blk[..., halo : halo + span_p], n, hop, wb, sb, rb, "head",
                cfg.fft_precision, fixed_order=True,
            )
        if t == n_time - 1:
            acc[..., off - halo : off] = blocked_edge_patch(
                x_blk[..., off + halo - span_p : off + halo], n, hop, wb, sb,
                rb, "tail", cfg.fft_precision, fixed_order=True,
            )
        accs.append(acc)
    return accs


def _block_round_trip(
    xs: list,  # one channel group's time shards, [C_local, T_block] each
    norms: list,  # each shard's [T_block] COLA norm, on its device
    window_f64: np.ndarray,
    cfg: StftConfig,
    total_len: int,
    spectral_fn: Optional[Callable],
    valid_start: int = 0,
    with_metrics: bool = False,
    blocked: Optional[dict] = None,
):
    """One channel group through the round-trip: its normalized output
    blocks, and with `with_metrics` each shard's (signal energy, noise
    energy, peak) f32 partials."""
    n, hop = cfg.frame_size, cfg.hop_size
    halo = n - hop
    t_block = xs[0].shape[-1]
    if blocked is not None:
        accs = _blocked_local_round_trip(
            xs, window_f64, cfg, blocked["per_bin"], blocked["group"],
            blocked["num_frames"], t_block, blocked["n_time"],
        )
    else:
        route = shard_route(cfg, spectral_fn)
        frames_per_block = t_block // hop
        rights = pull_right_halo(xs, halo)
        frames = []
        for t, (x, right) in enumerate(zip(xs, rights)):
            x_ext = torch.cat([x, right], dim=-1)
            of = _local_frames(route, x_ext, cfg, spectral_fn, window_f64,
                               frames_per_block)
            if cfg.synthesis_window:
                of = of * const_on(window_f64, of.device)
            # Keep only the frames that exist globally: start >= valid_start
            # and start + N <= total_len.
            start = t * t_block + hop * torch.arange(
                frames_per_block, device=of.device)
            valid = (start >= valid_start) & (start + n <= total_len)
            frames.append(torch.where(valid[:, None], of, 0.0))
        # OLA with the left neighbour's tail seeded first (canonical
        # order): the tail each shard ships right is the part of its local
        # OLA past its block.
        tails = [overlap_add(of, hop, t_block + halo)[..., t_block:]
                 for of in frames]
        accs = [overlap_add(of, hop, t_block, init_head=seed)
                for of, seed in zip(frames, push_right_tail(tails))]
    outs = [acc / torch.clamp_min(norm, cfg.eps)
            for acc, norm in zip(accs, norms)]
    if not with_metrics:
        return outs, None
    partials = [
        (torch.sum(torch.square(x)), torch.sum(torch.square(x - out)),
         torch.max(torch.abs(out)))
        for x, out in zip(xs, outs)
    ]
    return outs, partials


@lru_cache(maxsize=64)
def _norm_block_on(cfg: StftConfig, num_frames: int, valid_start: int,
                   total_len: int, t: int, t_block: int,
                   device: torch.device) -> torch.Tensor:
    """Time block t of the [total_len] COLA norm (zero outside the frames'
    span), as f32 on `device`."""
    span = (num_frames - 1) * cfg.hop_size + cfg.frame_size
    norm = np.pad(_norm_np(cfg, num_frames, span),
                  (valid_start, total_len - valid_start - span))
    return as_f32(norm[t * t_block : (t + 1) * t_block], device)


def sharded_round_trip(
    x: torch.Tensor,  # [channels, T]
    cfg: StftConfig,
    mesh: Optional[Mesh] = None,
    spectral_fn: Optional[Callable] = None,
    valid_len: Optional[int] = None,
    valid_start: int = 0,
    return_metrics: bool = False,
    allow_blocked: bool = True,
    device=None,
):
    """Distributed round-trip over a (channel, time) mesh.

    Output equals `pipeline.round_trip(x, cfg)` with center=False over the
    covered span (positions past the last frame get zeros).
    `valid_start`/`valid_len` restrict the frame set to frames fully inside
    x[..., valid_start:valid_len] (valid_start hop-aligned).

    With `return_metrics=True` returns `(y, metrics)`: `metrics` holds
    {signal_energy, noise_energy, peak} reduced over the mesh (0-d tensors
    on the output's device; `metrics_report` converts them to dB).

    A tensor is sharded from its own device; an array-like first goes to
    `device` (default "cuda", which raises without a card)."""
    if mesh is None:
        mesh = auto_mesh()
    if cfg.center:
        raise ValueError(
            "sharded pipeline requires center=False; pad on the host first"
        )
    x = _device.place(x, device, torch.float32)
    channels, total_len = x.shape
    if valid_len is None:
        valid_len = total_len
    valid_len = min(valid_len, total_len)
    n_ch = mesh.shape[CHANNEL_AXIS]
    n_time = mesh.shape[TIME_AXIS]
    n, hop = cfg.frame_size, cfg.hop_size
    if channels % n_ch != 0:
        raise ValueError(f"channels ({channels}) % mesh channel ({n_ch}) != 0")
    if total_len % n_time != 0:
        raise ValueError(f"T ({total_len}) % mesh time ({n_time}) != 0")
    t_block = total_len // n_time
    if t_block % hop != 0:
        raise ValueError(f"time block ({t_block}) must be hop-aligned ({hop})")
    if t_block < n:
        raise ValueError(
            f"time block ({t_block}) must be >= frame_size ({n}) so halos "
            "touch only immediate neighbors"
        )
    if valid_start % hop != 0:
        raise ValueError(f"valid_start ({valid_start}) must be hop-aligned")
    num_frames = cfg.frame_spec.num_frames(valid_len - valid_start)
    if num_frames <= 0:
        return torch.zeros_like(x)
    window_f64 = get_window(cfg.window, n, cfg.periodic, dtype=np.float64)

    # Fixed per-bin responses (and the identity) take the blocked
    # hop-block Toeplitz formulation when the full frame set is covered and
    # the blocks align to its group grid; otherwise the masked frame
    # formulation with the tail-seeding protocol.
    blocked = None
    if allow_blocked and valid_start == 0 and valid_len == total_len:
        per_bin_b = blocked_per_bin(
            cfg, spectral_fn, t_block=t_block, num_frames=num_frames
        )
        if per_bin_b is not None:
            blocked = {"group": blocked_group_for(n, hop),
                       "num_frames": num_frames,
                       "n_time": n_time, "per_bin": per_bin_b}

    c_local = channels // n_ch
    rows, partials = [], []
    for c in range(n_ch):
        devs = [mesh.device(c, t) for t in range(n_time)]
        xs = [
            x[c * c_local : (c + 1) * c_local,
              t * t_block : (t + 1) * t_block].to(dev, non_blocking=True)
            for t, dev in enumerate(devs)
        ]
        norms = [
            _norm_block_on(cfg, num_frames, valid_start, total_len, t,
                           t_block, dev)
            for t, dev in enumerate(devs)
        ]
        outs, parts = _block_round_trip(
            xs, norms, window_f64, cfg, valid_len, spectral_fn,
            valid_start=valid_start, with_metrics=return_metrics,
            blocked=blocked,
        )
        rows.append(outs)
        partials += parts or []
    dev0 = mesh.device(0, 0)
    y = torch.cat([torch.cat([o.to(dev0) for o in outs], dim=-1)
                   for outs in rows], dim=0)
    if not return_metrics:
        return y
    sig, noise, peak = (p.to(dev0) for p in partials[0])
    for s_, n_, p_ in partials[1:]:
        sig = sig + s_.to(dev0)
        noise = noise + n_.to(dev0)
        peak = torch.maximum(peak, p_.to(dev0))
    return y, {"signal_energy": sig, "noise_energy": noise, "peak": peak}


def blocked_per_bin(
    cfg: StftConfig,
    spectral_fn: Optional[Callable],
    t_block: int,
    num_frames: int,
) -> Optional[np.ndarray]:
    """The per-bin response the blocked mesh formulation uses for a
    FULL-COVERAGE `sharded_round_trip` with these shapes (ones for the
    identity), or None when its gate does not hold: not a matmul config,
    unsupported N/hop, unaligned blocks, too few frames, or a spectral fn
    that is not a fixed per-bin response."""
    n, hop = cfg.frame_size, cfg.hop_size
    if spectral_fn is None:
        per_bin = np.ones(n // 2 + 1)
    else:
        per_bin = resolve_per_bin_response(spectral_fn, n)
    group = blocked_group_for(n, hop)
    if (
        per_bin is not None
        and _on_matmul(cfg)
        and group is not None
        and t_block % (group * hop) == 0
        and num_frames >= 2 * (n // hop - 1)
    ):
        return per_bin
    return None


def metrics_report(metrics: dict) -> dict:
    """In-mesh metric reductions in the reference's report units: SNR in
    dB and peak / peak dBFS."""
    sig = float(metrics["signal_energy"])
    noise = float(metrics["noise_energy"])
    peak = float(metrics["peak"])
    if sig <= 0.0:
        snr = float("-inf")
    elif noise <= 0.0:
        snr = float("inf")
    else:
        snr = 10.0 * np.log10(sig / noise)
    return {
        "snr_db": snr,
        "peak": peak,
        "peak_db": 20.0 * np.log10(peak) if peak > 0 else float("-inf"),
    }


def sharded_round_trip_jit(cfg: StftConfig, mesh: Mesh, spectral_fn=None):
    """A closure over (cfg, mesh, spectral_fn) for repeated use (the
    reference jits it; PyTorch runs eagerly)."""

    def run(x, device=None):
        return sharded_round_trip(x, cfg, mesh, spectral_fn, device=device)

    return run
