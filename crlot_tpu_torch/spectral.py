"""Spectral-domain ops for the STFT pipeline's process stage, in torch.

Counterpart of `crlot_tpu/spectral.py`: functions `spec [..., F, K] ->
spec` for `round_trip(spectral_fn=...)`, with the same optional fast-path
attributes:

- `per_bin_gains(nfft) -> f64 [K] | None` (fixed real per-bin gains);
- `per_bin_response(nfft) -> complex [K] | None` (any fixed per-bin curve;
  composes into the blocked round-trip kernel);
- `packed(re, im) -> (re, im)`: the op on split Re/Im planes.

Each `packed` fn here also carries `packed.epilogue`, a tuple of
`EpilogueOp`s: the fixed menu of per-bin ops that the B2 kernel
(`fft/fused_rt.py`) applies between its forward and inverse products. A
CUDA kernel cannot host an arbitrary traced function the way the Pallas
kernel hosts a jaxpr, so the menu covers every packed fn of this module and
`compose` concatenates the menus of its parts. A packed fn without an
epilogue still runs, on the "packed_parts" route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .core.consts import const_on

# Opcodes shared with csrc/fused_rt.cu.
OP_GAIN = 1  # re, im *= g
OP_REAL_GAINS = 2  # re, im *= g[k]
OP_COMPLEX = 3  # (re, im) <- (re*hr - im*hi, re*hi + im*hr)
OP_GATE = 4  # s = (re^2+im^2 >= thresh) ? 1 : att;  re, im *= s
OP_SUBTRACT = 5  # s = max(|X| - alpha*nm[k], floor*|X|) / |X|;  re, im *= s


@dataclass(frozen=True, eq=False)
class EpilogueOp:
    """One per-bin op of the B2 kernel's menu: an opcode, its scalars and
    its per-bin float32 arrays (each of length K = nfft//2 + 1)."""

    code: int
    scalars: tuple = ()
    per_bin: tuple = ()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32))


def _on(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return const_on(a, like.device, a.dtype)


def gain(g: float) -> Callable:
    """Uniform complex gain."""

    def f(spec):
        return spec * g

    g32 = float(np.float32(g))
    f.per_bin_gains = lambda nfft: np.full(nfft // 2 + 1, g, np.float64)
    f.packed = lambda re, im: (re * g32, im * g32)
    f.packed.epilogue = (EpilogueOp(OP_GAIN, (g32,)),)
    return f


def per_bin_filter(h) -> Callable:
    """Multiply every frame by a fixed complex (or real) response h[K]."""
    hn = h.detach().cpu().numpy() if isinstance(h, torch.Tensor) else np.asarray(h)

    def f(spec):
        return spec * _on(hn, spec).to(spec.dtype if hn.dtype.kind == "c"
                                       else spec.real.dtype)

    if hn.ndim == 1 and np.isrealobj(hn):
        f.per_bin_gains = lambda nfft: (
            hn.astype(np.float64) if len(hn) == nfft // 2 + 1 else None
        )
    if hn.ndim == 1:
        f.per_bin_response = lambda nfft: (
            hn.astype(np.complex128) if len(hn) == nfft // 2 + 1 else None
        )
        hr = _f32(np.real(hn))
        hi = _f32(np.imag(hn))

        def packed(re, im):
            r, i = _on(hr, re), _on(hi, re)
            return re * r - im * i, re * i + im * r

        packed.epilogue = (EpilogueOp(OP_COMPLEX, (), (hr, hi)),)
        f.packed = packed
    return f


def fir_frequency_response(taps: np.ndarray, nfft: int) -> np.ndarray:
    """Frequency response of an FIR filter at the pipeline's bin grid."""
    t = np.zeros(nfft, dtype=np.float64)
    t[: len(taps)] = np.asarray(taps, dtype=np.float64)
    return np.fft.rfft(t).astype(np.complex64)


def magnitude(spec) -> torch.Tensor:
    """|spec| (a tensor stays on its device; an array goes to the CPU)."""
    return torch.as_tensor(spec).abs()


def power_db(spec, floor_db: float = -120.0) -> torch.Tensor:
    """10*log10(|spec|^2), the power floored at `floor_db`."""
    p = torch.as_tensor(spec).abs().square()
    floor = 10.0 ** (floor_db / 10.0)
    return 10.0 * torch.log10(torch.clamp_min(p, floor))


def noise_gate(threshold_db: float, attenuation_db: float = -60.0) -> Callable:
    """Attenuate bins whose power is below `threshold_db` (full scale)."""
    thresh = float(np.float32(10.0 ** (threshold_db / 10.0)))
    att = float(np.float32(10.0 ** (attenuation_db / 20.0)))

    def f(spec):
        p = spec.abs().square()
        return torch.where(p >= thresh, spec, spec * att)

    def packed(re, im):
        p = re * re + im * im
        s = torch.where(p >= thresh, 1.0, att).to(re.dtype)
        return re * s, im * s

    packed.epilogue = (EpilogueOp(OP_GATE, (thresh, att)),)
    f.packed = packed
    return f


def spectral_subtraction(noise_mag, alpha: float = 1.0,
                         floor: float = 0.0) -> Callable:
    """Magnitude spectral subtraction with a floor:
    |Y| = max(|X| - alpha*|N|, floor*|X|), phase preserved."""
    nm = _f32(noise_mag)
    alpha32 = float(np.float32(alpha))
    floor32 = float(np.float32(floor))

    def _scale(mag):
        new_mag = torch.maximum(mag - alpha32 * _on(nm, mag), floor32 * mag)
        return torch.where(
            mag > 0, new_mag / torch.clamp_min(mag, 1e-20),
            torch.zeros_like(mag),
        )

    def f(spec):
        return spec * _scale(spec.abs())

    def packed(re, im):
        s = _scale(torch.sqrt(re * re + im * im))
        return re * s, im * s

    packed.epilogue = (EpilogueOp(OP_SUBTRACT, (alpha32, floor32), (nm,)),)
    f.packed = packed
    return f


def band_gain(edges_hz: Sequence[float], gains: Sequence[float],
              sample_rate: int, nfft: int) -> Callable:
    """Piecewise-constant graphic-EQ band gains; bin k at k*sr/nfft Hz gets
    the gain of its band (edges ascending, len(gains) == len(edges)+1)."""
    if len(gains) != len(edges_hz) + 1:
        raise ValueError("need len(gains) == len(edges_hz) + 1")
    freqs = np.arange(nfft // 2 + 1) * (sample_rate / nfft)
    g = np.asarray(gains, dtype=np.float64)[np.searchsorted(edges_hz, freqs)]
    g32 = _f32(g)

    def f(spec):
        return spec * _on(g32, spec)

    def packed(re, im):
        gt = _on(g32, re)
        return re * gt, im * gt

    f.per_bin_gains = lambda n: g if n == nfft else None
    packed.epilogue = (EpilogueOp(OP_REAL_GAINS, (), (g32,)),)
    f.packed = packed
    return f


def compose(*fns: Callable) -> Callable:
    """Chain spectral fns left-to-right."""

    def f(spec):
        for fn in fns:
            spec = fn(spec)
        return spec

    def _gains(nfft):
        total = np.ones(nfft // 2 + 1, np.float64)
        for fn in fns:
            gfn = getattr(fn, "per_bin_gains", None)
            g = gfn(nfft) if gfn is not None else None
            if g is None:
                return None
            total = total * g
        return total

    def _response(nfft):
        total = np.ones(nfft // 2 + 1, np.complex128)
        for fn in fns:
            rfn = getattr(fn, "per_bin_response", None) or getattr(
                fn, "per_bin_gains", None
            )
            r = rfn(nfft) if rfn is not None else None
            if r is None:
                return None
            total = total * r
        return total

    f.per_bin_gains = _gains
    f.per_bin_response = _response
    if all(hasattr(fn, "packed") for fn in fns):

        def _packed(re, im):
            for fn in fns:
                re, im = fn.packed(re, im)
            return re, im

        menus = [getattr(fn.packed, "epilogue", None) for fn in fns]
        if all(m is not None for m in menus):
            _packed.epilogue = tuple(op for m in menus for op in m)
        f.packed = _packed
    return f


def epilogue_of(spectral_fn) -> Optional[tuple]:
    """The B2 menu of a spectral fn's packed form, or None when it has none
    (then the fn cannot run inside the B2 kernel)."""
    packed = getattr(spectral_fn, "packed", None)
    return getattr(packed, "epilogue", None) if packed is not None else None


def resolve_per_bin_gains(spectral_fn, nfft: int):
    """Fixed REAL per-bin gains of a spectral fn (f64 [K]) or None."""
    if spectral_fn is None:
        return None
    gfn = getattr(spectral_fn, "per_bin_gains", None)
    if gfn is None:
        return None
    g = gfn(nfft)
    if g is None:
        return None
    g = np.asarray(g, np.float64)
    if g.shape != (nfft // 2 + 1,) or not np.isfinite(g).all():
        return None
    return g


def resolve_per_bin_response(spectral_fn, nfft: int):
    """Fixed real-or-complex per-bin response (complex128 [K]) or None."""
    if spectral_fn is None:
        return None
    rfn = getattr(spectral_fn, "per_bin_response", None)
    r = rfn(nfft) if rfn is not None else None
    if r is None:
        g = resolve_per_bin_gains(spectral_fn, nfft)
        return None if g is None else g.astype(np.complex128)
    r = np.asarray(r, np.complex128)
    if r.shape != (nfft // 2 + 1,) or not np.isfinite(r).all():
        return None
    return r
