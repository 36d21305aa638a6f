"""Carry the reference's configuration and spectral parameters across.

There are no learned weights: the "parameters" are the host-designed
arrays (rebuilt here from the same float64 design code) and the arguments
of the config and the spectral fns. These two functions read them without
importing `crlot_tpu`, so a test can hand both packages the same setup.
"""

from __future__ import annotations

from . import spectral
from .core.types import (
    FftBackend,
    FftPrecision,
    PadMode,
    StftConfig,
    WindowType,
)

_ENUM_FIELDS = {
    "window": WindowType,
    "pad_mode": PadMode,
    "fft_backend": FftBackend,
    "fft_precision": FftPrecision,
}
_PLAIN_FIELDS = (
    "frame_size", "hop_size", "periodic", "synthesis_window", "center",
    "eps", "fused_roundtrip",
)


def config_from_reference(cfg) -> StftConfig:
    """The port's StftConfig from a `crlot_tpu` StftConfig, read by field
    name and enum `.value`."""
    kw = {name: getattr(cfg, name) for name in _PLAIN_FIELDS}
    for name, enum_t in _ENUM_FIELDS.items():
        kw[name] = enum_t(getattr(cfg, name).value)
    return StftConfig(**kw)


def spectral_from_reference(kind: str, **params):
    """The port's spectral fn of the given kind, from the numpy arguments
    the reference's constructor took:

    - "gain": g;
    - "per_bin_filter": h;
    - "band_gain": edges_hz, gains, sample_rate, nfft;
    - "noise_gate": threshold_db, attenuation_db;
    - "spectral_subtraction": noise_mag, alpha, floor;
    - "compose": parts = [(kind, params), ...].
    """
    if kind == "compose":
        return spectral.compose(
            *(spectral_from_reference(k, **p) for k, p in params["parts"])
        )
    makers = {
        "gain": spectral.gain,
        "per_bin_filter": spectral.per_bin_filter,
        "band_gain": spectral.band_gain,
        "noise_gate": spectral.noise_gate,
        "spectral_subtraction": spectral.spectral_subtraction,
    }
    if kind not in makers:
        raise ValueError(f"unknown spectral fn kind {kind!r}")
    return makers[kind](**params)
