"""The one generator of the benchmark's inputs: a traffic mix's `signal`
parameters and a seed in, float32 [channels, samples] tensors out, made on
the device by a seeded `torch.Generator` in a few large calls.

Every seed gets the same sizes; only the values change. Kinds:

* "uniform": white noise, uniform in +-amplitude.
* "tones": per channel, `tones` sinusoids (frequency uniform in
  `freq_hz`, amplitude uniform in `amplitude`, random phase), each
  switched on or off for each `segment_s` stretch (on with probability
  `on_share`), over Gaussian noise of rms `floor_rms`.
"""

from __future__ import annotations

import math

import torch


def _uniform(g, shape, device, dtype=torch.float32) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device, dtype=dtype)


def make(signal: dict, channels: int, samples: int, sample_rate: int,
         g: torch.Generator, device) -> torch.Tensor:
    kind = signal["kind"]
    if kind == "uniform":
        a = float(signal["amplitude"])
        return _uniform(g, (channels, samples), device) * (2 * a) - a
    if kind == "tones":
        return _tones(signal, channels, samples, sample_rate, g, device)
    raise ValueError(f"unknown signal kind {kind!r}")


def _tones(sig: dict, channels: int, samples: int, sample_rate: int,
           g: torch.Generator, device) -> torch.Tensor:
    n_t = int(sig["tones"])
    f_lo, f_hi = sig["freq_hz"]
    a_lo, a_hi = sig["amplitude"]
    seg = max(1, int(round(sig["segment_s"] * sample_rate)))
    n_seg = -(-samples // seg)
    f64 = torch.float64
    freq = f_lo + (f_hi - f_lo) * _uniform(g, (channels, n_t, 1), device, f64)
    amp = a_lo + (a_hi - a_lo) * _uniform(g, (channels, n_t, 1), device, f64)
    phase = 2 * math.pi * _uniform(g, (channels, n_t, 1), device, f64)
    on = (_uniform(g, (channels, n_t, n_seg), device)
          < float(sig["on_share"])).to(f64)
    noise = torch.randn((channels, samples), generator=g, device=device)
    t = torch.arange(samples, device=device, dtype=f64) / sample_rate
    x = noise.to(f64) * float(sig["floor_rms"])
    for k in range(n_t):
        env = on[:, k].repeat_interleave(seg, dim=-1)[..., :samples]
        x += (amp[:, k] * env
              * torch.sin(2 * math.pi * freq[:, k] * t + phase[:, k]))
    return x.float()


def ring(signal: dict, count: int, channels: int, samples: int,
         sample_rate: int, seed: int, device) -> list:
    """`count` distinct inputs from `seed`: the same seed gives the same
    inputs on every device of one kind."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [make(signal, channels, samples, sample_rate, g, device)
            for _ in range(count)]
