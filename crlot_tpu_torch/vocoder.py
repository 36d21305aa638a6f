"""Phase vocoder: time-stretch and pitch-shift on the port's STFT, in torch.

Counterpart of `crlot_tpu/vocoder.py`. Analysis at hop Ha, per-bin
instantaneous frequency from the wrapped phase increment, phase
re-integration at synthesis hop Hs (a cumulative sum along the frames),
resynthesis with a synthesis window and the sum-w^2 COLA norm (`istft`:
B1 on the card, at the synthesis hop).

Numerics, as the reference's: the synthesis phase is accumulated in two
parts. The carrier ramp Hs*w_k*t (millions of radians on minutes-long
audio, beyond float32 phase precision) is computed exactly modulo 2*pi in
integer arithmetic, 2*pi*((a_k * (t mod N)) mod N)/N with
a_k = (k*Hs) mod N, every intermediate below N^2 (hence the 46 340 limit
on the frame size, kept from the reference's int32 ramp). Only the
per-frame deviation Hs*princarg(dP)/Ha is summed along the frames. The
reference sums it in float32 (XLA's cumsum, in a tree order on its CPU);
the port sums it in float64 and reduces it mod 2*pi before it joins the
float32 phase. A float32 running sum in sequence, which is what
`torch.cumsum` runs on the card, reaches thousands of radians on an
off-grid tone and loses 0.01 rad to rounding: 41.38 dB at rate 1 on 30 s
of 440 Hz on an H100, under the reference's own 60 dB gate
(`chip_smoke.py` phase 38; `tests/test_torch_vocoder.py`).

Array-like input goes to `device` (default "cuda", `core/device.py`); a
tensor stays on its own device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .core import device as _device
from .core.types import StftConfig

__all__ = ["time_stretch", "pitch_shift"]


def _princarg(p: torch.Tensor) -> torch.Tensor:
    """Wrap phase to (-pi, pi] (`torch.round` rounds half to even, as
    `jnp.round` does)."""
    return p - 2.0 * math.pi * torch.round(p / (2.0 * math.pi))


def _running_sum(inc: torch.Tensor) -> torch.Tensor:
    """The running sum of the phase increments `[..., F, K]` along the
    frames, in float64, reduced mod 2*pi and returned in float32. The sum
    runs along the innermost axis of a transposed copy: on the card a
    cumsum along an outer axis is one sequential thread a column (4.43 ms
    of `time_stretch`'s 7.56 at 2 x 60 s on an H100)."""
    rows = inc.double().transpose(-1, -2).contiguous()
    return torch.remainder(torch.cumsum(rows, dim=-1),
                           2.0 * math.pi).float().transpose(-1, -2)


def _stretch_impl(signal: torch.Tensor, cfg_a: StftConfig,
                  cfg_s: StftConfig) -> torch.Tensor:
    from .pipeline import istft, stft

    n = cfg_a.frame_size
    ha = cfg_a.hop_size
    hs = cfg_s.hop_size
    spec = stft(signal, cfg_a)  # [..., F, K]
    mag = torch.abs(spec)
    phase = torch.angle(spec)
    num_frames = spec.shape[-2]

    kk = n // 2 + 1
    k_i = torch.arange(kk, device=spec.device)
    # The heterodyned phase increment: the bin advance w_k*Ha is taken off
    # mod 2*pi in exact integers, leaving the per-bin frequency deviation.
    wrap_k = (2.0 * math.pi / n) * ((k_i * (ha % n)) % n).float()
    dp = phase[..., 1:, :] - phase[..., :-1, :] - wrap_k
    dev = _princarg(dp) / ha  # [..., F-1, K]
    # The carrier ramp Hs*w_k*t, exact mod 2*pi in integers.
    a_k = (k_i * (hs % n)) % n
    t_idx = torch.arange(num_frames, device=spec.device) % n
    ramp = (2.0 * math.pi / n) * (
        (t_idx[:, None] * a_k[None, :]) % n).float()  # [F, K]
    phase_s = phase[..., :1, :] + ramp + torch.cat(
        [torch.zeros_like(phase[..., :1, :]), _running_sum(hs * dev)],
        dim=-2)
    spec_s = torch.complex(mag * torch.cos(phase_s), mag * torch.sin(phase_s))
    return istft(spec_s, cfg_s)


def time_stretch(signal, cfg: StftConfig, rate: float,
                 device=None) -> torch.Tensor:
    """Stretch duration by `rate` (>1 = longer / slower) at constant pitch.

    `cfg.hop_size` is the analysis hop; the synthesis hop is
    round(rate * hop). The synthesis window is forced on (modified spectra
    need the tapered resynthesis and the sum-w^2 norm). Accepts [..., T];
    returns [..., T_out] with T_out = (F-1)*Hs + N for F analysis frames.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if cfg.frame_size > 46340:
        # The exact carrier ramp reduces products below N^2, which must
        # stay below 2^31 (the reference's int32 ramp).
        raise ValueError(
            f"frame_size {cfg.frame_size} exceeds the 46340 limit of the "
            "int32 exact-mod phase ramp"
        )
    # Uncentered analysis: reflect padding would put a time-reversed copy of
    # the signal in the first frames, whose instantaneous frequencies enter
    # the phase cumsum once and de-cohere the bins for good.
    cfg_a = dataclasses.replace(cfg, synthesis_window=True, center=False)
    ha = cfg_a.hop_size
    hs = max(1, int(round(rate * ha)))
    cfg_s = dataclasses.replace(cfg_a, hop_size=hs)
    return _stretch_impl(_device.place(signal, device, torch.float32),
                         cfg_a, cfg_s)


def pitch_shift(signal, cfg: StftConfig, semitones: float,
                device=None) -> torch.Tensor:
    """Shift pitch by `semitones` at (approximately) constant duration:
    phase-vocoder stretch by s = 2^(semitones/12), then polyphase-resample
    the stretched audio back (B4 on the card). The factor is approximated
    by a rational with denominator <= 64 (pitch error < ~2 cents)."""
    from fractions import Fraction

    from .resample.polyphase import resample

    x = _device.place(signal, device, torch.float32)
    s = float(2.0 ** (semitones / 12.0))
    frac = Fraction(s).limit_denominator(64)
    stretched = time_stretch(x, cfg, frac.numerator / frac.denominator)
    out = resample(stretched, frac.numerator, frac.denominator)
    t = x.shape[-1]
    out = out[..., :t]
    pad = t - out.shape[-1]
    if pad > 0:
        out = torch.nn.functional.pad(out, (0, pad))
    return out
