"""Harmonic / percussive source separation (HPSS) by median-filter masking,
in torch.

Counterpart of `crlot_tpu/hpss.py` (Fitzgerald 2010): on a power
spectrogram, harmonic content is smooth along time and percussive content
along frequency. Median-filter the spectrogram along each axis, build
soft masks from the two filtered copies, apply them to the complex STFT,
and invert (two `istft`s: two launches of B1 on the card).

The sliding median takes `size` shifted views of the edge-replicated
input (`Tensor.unfold`) and their middle value (`torch.median`; the sizes
are odd, so its lower median is the exact middle, the value `jnp.median`
gives). Every output depends only on its own window, so the masks of a
channel do not depend on the other channels. Beyond a cap of 32 M stacked
elements (128 MB) the median runs in chunks along the largest other axis,
as the reference's does: one minute of stereo at the default kernels
would otherwise stack 11 251 x 513 x 31 x 2 floats, about 1.4 GB.

Boundary handling is edge replication (clamped indices): a median across
an edge-replicated window never invents energy that was not present.
Array-like input goes to `device` (default "cuda", `core/device.py`); a
tensor stays on its own device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .core import device as _device
from .core.types import StftConfig

__all__ = ["hpss", "hpss_masks", "harmonic", "percussive"]

# Cap on the stacked windows' element count (32 M f32 = 128 MB).
_MEDIAN_STACK_ELEMS = 32 * 1024 * 1024


def _sliding_median(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Median over a centered length-`size` window along `axis` (odd size;
    edge-replicated boundaries). When the windows would exceed
    `_MEDIAN_STACK_ELEMS`, the input is processed in chunks along its
    largest other axis (positions there are independent of the window),
    bounding the memory at O(cap) whatever the signal's length."""
    if size < 1 or size % 2 == 0:
        raise ValueError(f"median size must be odd and >= 1, got {size}")
    if size == 1:
        return x
    axis = axis % x.ndim
    half = size // 2
    n = x.shape[axis]
    idx = torch.arange(-half, n + half, device=x.device).clamp_(0, n - 1)
    xp = x.index_select(axis, idx)

    def med(block: torch.Tensor) -> torch.Tensor:
        return block.unfold(axis, size, 1).median(dim=-1).values

    if x.numel() * size <= _MEDIAN_STACK_ELEMS or x.ndim == 1:
        return med(xp)
    other = max((d for d in range(x.ndim) if d != axis),
                key=lambda d: x.shape[d])
    per_slice = (x.numel() // x.shape[other]) * size
    chunk = max(1, _MEDIAN_STACK_ELEMS // per_slice)
    if chunk >= x.shape[other]:
        return med(xp)
    return torch.cat([med(b) for b in xp.split(chunk, dim=other)], dim=other)


def hpss_masks(
    power: torch.Tensor,
    kernel_harm: int = 31,
    kernel_perc: int = 31,
    mask_power: float = 2.0,
    margin_harm: float = 1.0,
    margin_perc: float = 1.0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft HPSS masks from a `[..., F, K]` power (or magnitude)
    spectrogram with frames on axis -2 and bins on axis -1.

    `H` = median over `kernel_harm` frames (per bin), `P` = median over
    `kernel_perc` bins (per frame); the masks are the Wiener-style ratio

        mask_h = H^p / (H^p + (margin_h * P)^p)
        mask_p = P^p / (P^p + (margin_p * H)^p)

    With margins of 1 the masks sum to 1 (a complete decomposition);
    margins > 1 demand a dominance margin and leave a discarded residual.
    """
    if margin_harm < 1.0 or margin_perc < 1.0:
        raise ValueError("margins must be >= 1")
    power = _device.place(power, device)
    h = _sliding_median(power, kernel_harm, axis=-2)
    p = _sliding_median(power, kernel_perc, axis=-1)
    tiny = torch.finfo(power.dtype).tiny
    hp = torch.pow(torch.clamp_min(h, 0.0), mask_power)
    pp = torch.pow(torch.clamp_min(p, 0.0), mask_power)
    mh = hp / (hp + margin_harm ** mask_power * pp + tiny)
    mp = pp / (pp + margin_perc ** mask_power * hp + tiny)
    return mh, mp


def hpss(
    signal,
    cfg: StftConfig,
    kernel_harm: int = 31,
    kernel_perc: int = 31,
    mask_power: float = 2.0,
    margin_harm: float = 1.0,
    margin_perc: float = 1.0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separate `[..., T]` audio into `(harmonic, percussive)` parts of the
    same length: STFT -> median masks on |X|^2 -> two masked iSTFTs.

    With unit margins the two parts sum to the stft round trip of the
    input (the masks sum to 1 bin by bin), > 60 dB on the default
    pipeline.
    """
    from .pipeline import istft, stft

    x = _device.place(signal, device, torch.float32)
    spec = stft(x, cfg)  # [..., F, K] complex
    mh, mp = hpss_masks(
        torch.abs(spec) ** 2, kernel_harm, kernel_perc,
        mask_power, margin_harm, margin_perc,
    )
    length = x.shape[-1]
    return (
        istft(spec * mh, cfg, length=length),
        istft(spec * mp, cfg, length=length),
    )


def harmonic(signal, cfg: StftConfig, **kwargs) -> torch.Tensor:
    """The harmonic part of `hpss` (same keyword options)."""
    return hpss(signal, cfg, **kwargs)[0]


def percussive(signal, cfg: StftConfig, **kwargs) -> torch.Tensor:
    """The percussive part of `hpss` (same keyword options)."""
    return hpss(signal, cfg, **kwargs)[1]
