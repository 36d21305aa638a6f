"""Carry the reference's configuration and spectral parameters across.

There are no learned weights: the "parameters" are the host-designed
arrays (rebuilt here from the same float64 design code), the arguments
of the configs and the spectral fns, and a stream's carried state (the OLA
ring and its cursors). These functions read them without importing
`crlot_tpu`, so a test can hand both packages the same setup, and a
stream can move between the packages mid-flight.

The analysis stack needs no helper here: its filter states (the `zi` / `zf`
of `iir.sosfilt` and `iir.lfilter`, `features.pcen`'s smoother state) have
the reference's layout and dtype, so a reference state passes to the port
as the numpy array it is, and back as `tensor.numpy()`; its design arrays
are rebuilt by the port's own copies of the float64 design code.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spectral
from .core import device as _device
from .core.types import (
    FftBackend,
    FftDomain,
    FftPlanDesc,
    FftPrecision,
    OLAConfig,
    PadMode,
    StftConfig,
    WindowType,
)
from .ola.streaming import OLAStreamState

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


def ola_config_from_reference(cfg) -> OLAConfig:
    """The port's OLAConfig from a `crlot_tpu` OLAConfig, by field name."""
    return OLAConfig(**{name: getattr(cfg, name) for name in (
        "sample_rate", "frame_size", "hop_size", "channels", "eps",
        "apply_window_inside", "ring_margin_hops")})


def plan_desc_from_reference(desc) -> FftPlanDesc:
    """The port's FftPlanDesc from a `crlot_tpu` FftPlanDesc."""
    return FftPlanDesc(
        domain=FftDomain(desc.domain.value), nfft=desc.nfft,
        in_place=desc.in_place, batch=desc.batch, stride_in=desc.stride_in,
        stride_out=desc.stride_out, scrub=desc.scrub,
        backend=FftBackend(desc.backend.value))


def stream_state_from_reference(state, device=None) -> OLAStreamState:
    """The port's OLA stream state from a `crlot_tpu` OLAStreamState (its
    ring and cursors read as numpy); the ring goes to `device` (default
    "cuda"; `core/device.py`)."""
    ring = np.array(state.ring, dtype=np.float32)
    return OLAStreamState(
        torch.from_numpy(ring).to(_device.resolve(device)),
        int(np.asarray(state.read_pos)), int(np.asarray(state.produced)),
        bool(np.asarray(state.flushed)))


def stream_state_to_reference(state: OLAStreamState) -> dict:
    """The port's OLA stream state as the numpy fields of a `crlot_tpu`
    OLAStreamState, in its dtypes: `OLAStreamState(**{k: jnp.asarray(v)})`
    there rebuilds it."""
    return {
        "ring": state.ring.detach().cpu().numpy().astype(np.float32),
        "read_pos": np.asarray(state.read_pos, dtype=np.int32),
        "produced": np.asarray(state.produced, dtype=np.int32),
        "flushed": np.asarray(state.flushed, dtype=bool),
    }


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
