"""The port's Welch PSD and coherence (`crlot_tpu_torch.psd`) on the CPU.

Mirrors `tests/test_psd.py` case for case with its gates (scipy's welch
and coherence within relative RMSE 1e-4, an on-bin tone's power to rel
0.05, identical signals cohere to 1 within 1e-4, the loud errors), then
holds the port against the reference on the same seeded input: every
output within 1e-5 of the largest |value| of the reference's (the two
STFTs and the frame means sum in other orders; measured below 6e-7).
The frame mean is pairwise (`features._sum_last`), so eight CPU shards of
the channels are `torch.equal` to one call.
"""

import numpy as np
import pytest
import scipy.signal
import torch

from crlot_tpu.core.types import StftConfig as JConfig
from crlot_tpu.core.types import WindowType as JWindow
from crlot_tpu.psd import coherence as j_coherence
from crlot_tpu.psd import welch_freqs as j_welch_freqs
from crlot_tpu.psd import welch_psd as j_welch_psd

from crlot_tpu_torch.core.types import StftConfig, WindowType
from crlot_tpu_torch.distributed.mesh import make_mesh
from crlot_tpu_torch.psd import coherence, welch_freqs, welch_psd

SR = 48000
CPU = "cpu"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n=1024, hop=512, window=WindowType.HANN):
    return StftConfig(frame_size=n, hop_size=hop, window=window)


def _jcfg(n=1024, hop=512, window=JWindow.HANN):
    return JConfig(frame_size=n, hop_size=hop, window=window)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want))


# ---------------------------------------------------------------------------
# mirrors of tests/test_psd.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("n,hop", [(1024, 512), (1024, 256), (512, 128)])
def test_welch_matches_scipy(scaling, n, hop):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SR).astype(np.float32)
    cfg = _cfg(n, hop)
    got = welch_psd(x, cfg, fs=SR, scaling=scaling, device=CPU).numpy()
    f_ref, want = scipy.signal.welch(
        x, fs=SR, window="hann", nperseg=n, noverlap=n - hop,
        detrend=False, scaling=scaling,
    )
    np.testing.assert_allclose(welch_freqs(cfg, SR), f_ref)
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2))
    assert rel < 1e-4, f"{scaling} N={n} H={hop}: rel rmse {rel}"


def test_welch_tone_peak_and_parseval():
    freq = 32 * SR / 1024  # exactly on bin 32
    t = np.arange(SR) / SR
    x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    cfg = _cfg()
    p = welch_psd(x, cfg, fs=SR, scaling="spectrum", device=CPU).numpy()
    f = welch_freqs(cfg, SR)
    assert f[np.argmax(p)] == pytest.approx(freq, abs=SR / 1024)
    assert p.max() == pytest.approx(0.125, rel=0.05)


def test_welch_batched():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 24000)).astype(np.float32)
    p = welch_psd(x, _cfg(), fs=SR, device=CPU).numpy()
    assert p.shape == (3, 513)
    assert np.isfinite(p).all() and (p >= 0).all()


def test_coherence_matches_scipy():
    rng = np.random.default_rng(2)
    n = 24000
    x = rng.standard_normal(n).astype(np.float32)
    y = (np.convolve(x, np.ones(8) / 8.0, mode="same")
         + 0.5 * rng.standard_normal(n)).astype(np.float32)
    got = coherence(x, y, _cfg(1024, 512), device=CPU).numpy()
    _, want = scipy.signal.coherence(
        x, y, window="hann", nperseg=1024, noverlap=512, detrend=False
    )
    rel = np.sqrt(np.mean((got - want) ** 2))
    assert rel < 1e-4, f"coherence rmse {rel}"
    assert (got >= 0).all() and (got <= 1.0 + 1e-5).all()


def test_coherence_identical_signals_is_one():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(24000).astype(np.float32)
    c = coherence(x, x, _cfg(1024, 256), device=CPU).numpy()
    np.testing.assert_allclose(c, 1.0, atol=1e-4)


def test_welch_validation():
    with pytest.raises(ValueError):
        welch_psd(np.zeros(4096, np.float32), _cfg(), scaling="db",
                  device=CPU)


def test_welch_too_short_signal_raises():
    with pytest.raises(ValueError, match="zero Welch segments"):
        welch_psd(np.zeros(512, np.float32), _cfg(1024, 256), device=CPU)


def test_coherence_too_short_signal_raises():
    with pytest.raises(ValueError, match="zero Welch segments"):
        coherence(np.zeros(100, np.float32), np.zeros(100, np.float32),
                  _cfg(1024, 256), device=CPU)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scaling", ["density", "spectrum"])
@pytest.mark.parametrize("n,hop,window", [
    (1024, 256, "HANN"), (512, 128, "HAMMING"), (1024, 1024, "HANN")])
def test_welch_matches_reference(scaling, n, hop, window):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, SR // 2)).astype(np.float32)
    got = welch_psd(x, _cfg(n, hop, WindowType[window]), fs=SR,
                    scaling=scaling, device=CPU)
    want = j_welch_psd(x, _jcfg(n, hop, JWindow[window]), fs=SR,
                       scaling=scaling)
    _close(got, want)
    assert np.array_equal(welch_freqs(_cfg(n, hop), SR),
                          j_welch_freqs(_jcfg(n, hop), SR))


def test_coherence_matches_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, SR // 2)).astype(np.float32)
    y = (0.7 * x + 0.3 * rng.standard_normal((2, SR // 2))).astype(
        np.float32)
    got = coherence(x, y, _cfg(1024, 256), device=CPU)
    want = j_coherence(x, y, _jcfg(1024, 256))
    _close(got, want)


def test_sharded_welch_and_coherence_bit_identical():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((8, SR // 4)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, SR // 4)).astype(np.float32))
    mesh = make_mesh(channel=8, time=1, devices=[CPU] * 8)
    cfg = _cfg(1024, 256)
    whole = welch_psd(x, cfg, fs=SR)
    parts = torch.cat([welch_psd(x[c:c + 1].to(mesh.device(c, 0)), cfg,
                                 fs=SR) for c in range(8)])
    assert torch.equal(parts, whole)
    whole = coherence(x, y, cfg)
    parts = torch.cat([coherence(x[c:c + 1], y[c:c + 1], cfg)
                       for c in range(8)])
    assert torch.equal(parts, whole)


def test_welch_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            welch_psd(np.zeros(4096, np.float32), _cfg())
