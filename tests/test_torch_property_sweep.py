"""Randomized config sweep of the port's round-trip (the draws of
`tests/test_property_sweep.py`), plus the frames-level routes at the gates
that select them.

Tolerances, each the reference test's own: an identity round-trip
reconstructs its input above 80 dB, at the input's length, finite;
`istft(stft(x))` and `round_trip(x)` agree within max-abs 5e-4 (the
reference's bound between its two paths, which also bounds the port's
round-trip against the reference's `round_trip` on the CPU); the composed
product meets the float64 rfft * g -> irfft oracle above 90 dB. The routes'
cases gate a fixed response against a float64 STFT * g * iSTFT oracle at
80 dB, as `chip_smoke.py` phase 4 does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu.core.types import FftBackend as JFftBackend
from crlot_tpu.core.types import StftConfig as JStftConfig
from crlot_tpu.core.types import WindowType as JWin
from crlot_tpu.pipeline import round_trip as j_round_trip

import crlot_tpu_torch as pt
from crlot_tpu_torch import spectral as tsp
from crlot_tpu_torch.convert import config_from_reference
from crlot_tpu_torch.fft.matmul_backend import roundtrip_composed_matmul
from crlot_tpu_torch.window.windows import get_window

WINDOWS = [JWin.HANN, JWin.HAMMING, JWin.BLACKMAN, JWin.BLACKMAN_HARRIS]
SR = 48000


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_config(rng):
    """The reference sweep's draw, step for step (a reference config)."""
    n = int(rng.choice([128, 192, 256, 320, 512, 768, 1024, 2048]))
    hop = int(rng.choice([d for d in (32, 64, 96, 128, 256, 512)
                          if d <= n // 2]))
    return JStftConfig(
        frame_size=n,
        hop_size=hop,
        window=WINDOWS[int(rng.integers(len(WINDOWS)))],
        periodic=bool(rng.integers(2)),
        synthesis_window=bool(rng.integers(2)),
        center=True,
        fft_backend=JFftBackend(str(rng.choice(["auto", "xla", "matmul"]))),
    )


@pytest.mark.parametrize("seed", range(16))
def test_random_config_round_trip(seed):
    rng = np.random.default_rng(1000 + seed)
    jcfg = _draw_config(rng)
    cfg = config_from_reference(jcfg)
    length = int(rng.integers(jcfg.frame_size, 6 * jcfg.frame_size))
    x = rng.uniform(-0.9, 0.9, length).astype(np.float32)
    y = pt.round_trip(x, cfg, device="cpu").numpy()
    route = pt.formulation_for(cfg, None, length)
    assert y.shape == x.shape, (cfg, route)
    assert np.isfinite(y).all(), (cfg, route)
    assert pt.snr_db(x, y) > 80.0, (cfg, route, length)
    want = np.asarray(j_round_trip(jnp.asarray(x), jcfg))
    assert np.max(np.abs(y - want)) < 5e-4, (cfg, route)


@pytest.mark.parametrize("seed", range(6))
def test_random_config_stft_istft_consistency(seed):
    rng = np.random.default_rng(2000 + seed)
    cfg = config_from_reference(_draw_config(rng))
    length = int(rng.integers(2 * cfg.frame_size, 5 * cfg.frame_size))
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, length).astype(np.float32))
    via_spec = pt.istft(pt.stft(x, cfg), cfg, length=length)
    direct = pt.round_trip(x, cfg)
    assert float((via_spec - direct).abs().max()) < 5e-4, cfg


@pytest.mark.parametrize("seed", range(10))
def test_random_composed_response(seed):
    rng = np.random.default_rng(2000 + seed)
    n = int(rng.choice([256, 320, 500, 999, 1024, 2048, 4096]))
    kk = n // 2 + 1
    wtype = WINDOWS[int(rng.integers(len(WINDOWS)))]
    w = get_window(pt.WindowType[wtype.name],
                   n, bool(rng.integers(2)), dtype=np.float64)
    mag = 10.0 ** rng.uniform(-1, 1, kk)
    if rng.integers(2):
        g = mag.astype(np.complex128)
    else:
        g = mag * np.exp(1j * rng.uniform(-np.pi, np.pi, kk))
    syn = w if rng.integers(2) else None
    fr = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    got = roundtrip_composed_matmul(torch.from_numpy(fr), n, w, g,
                                    syn).numpy()
    want = np.fft.irfft(np.fft.rfft(fr.astype(np.float64) * w, axis=-1) * g,
                        n=n, axis=-1)
    if syn is not None:
        want = want * w
    err = want - got
    snr = 10 * np.log10(np.sum(want**2) / max(np.sum(err**2), 1e-300))
    assert snr > 90, (n, snr)


def _band(nfft):
    return tsp.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, nfft)


def _oracle(x, cfg, gains):
    """float64 STFT * g * iSTFT of x (center padding, COLA by the edge
    norm) on the host, the window applied once each way."""
    from crlot_tpu_torch.pipeline import _norm_np, _window_f64

    n, hop, pad = cfg.frame_size, cfg.hop_size, cfg.frame_spec.pad_amount
    w = _window_f64(cfg)
    xp = np.pad(x.astype(np.float64), [(0, 0)] * (x.ndim - 1) + [(pad, pad)],
                mode="reflect")
    f = cfg.frame_spec.num_frames(x.shape[-1])
    idx = np.arange(f)[:, None] * hop + np.arange(n)
    frames = np.fft.irfft(np.fft.rfft(xp[..., idx] * w, axis=-1) * gains,
                          n=n, axis=-1)
    if cfg.synthesis_window:
        frames = frames * w
    full = (f - 1) * hop + n
    acc = np.zeros(x.shape[:-1] + (full,))
    for k in range(f):
        acc[..., k * hop : k * hop + n] += frames[..., k, :]
    out = acc / np.maximum(_norm_np(cfg, f, full), cfg.eps)
    return out[..., pad : pad + x.shape[-1]]


@pytest.mark.parametrize("precision", list(pt.FftPrecision))
@pytest.mark.parametrize("synthesis", [False, True])
def test_frames_level_routes_at_their_gates(precision, synthesis):
    """(a) the identity at N = 960, H = 240 (20 ms / 5 ms at 48 kHz: no
    blocked group, N % 256 != 0) runs "folded"; (b) a band EQ there runs
    "composed"; (d) the EQ on 8 clips of 1 200 samples at N = 1024, H = 256
    (5 frames, under the blocked gate's 6) runs "composed"; at every tier,
    with and without a synthesis window."""
    x = np.random.default_rng(77).uniform(-0.9, 0.9, (2, SR // 2)).astype(
        np.float32)
    clips = np.random.default_rng(78).uniform(-0.9, 0.9, (8, 1200)).astype(
        np.float32)
    kw = dict(center=True, fft_precision=precision,
              synthesis_window=synthesis)
    c960 = pt.StftConfig(frame_size=960, hop_size=240, **kw)
    c1024 = pt.StftConfig(frame_size=1024, hop_size=256, **kw)
    assert pt.formulation_for(c960, None, x.shape[-1]) == "folded"
    assert pt.snr_db(x, pt.round_trip(x, c960, device="cpu")) > 80.0
    for cfg, sig in ((c960, x), (c1024, clips)):
        band = _band(cfg.frame_size)
        assert pt.formulation_for(cfg, band, sig.shape[-1]) == "composed"
        got = pt.round_trip(sig, cfg, band, device="cpu").numpy()
        gains = tsp.resolve_per_bin_response(band, cfg.frame_size)
        assert pt.snr_db(_oracle(sig, cfg, gains), got) > 80.0
    # One more frame and the clips take the blocked kernel.
    assert pt.formulation_for(c1024, _band(1024), 1200 + 256) == "blocked"


def test_odd_frame_sizes_are_refused_in_both_packages():
    """(c) 30 ms / 10 ms at 44.1 kHz is N = 1323: the reference's accelerator
    would run its packed products for an odd N, but neither package's
    StftConfig takes one, so no round_trip reaches that branch."""
    with pytest.raises(ValueError):
        JStftConfig(frame_size=1323, hop_size=441)
    with pytest.raises(ValueError):
        pt.StftConfig(frame_size=1323, hop_size=441)
