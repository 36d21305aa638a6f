"""The port's HPSS (`crlot_tpu_torch.hpss`) on the CPU.

Mirrors `tests/test_hpss.py` case for case with its gates (scipy's
median_filter within 1e-6, masks summing to 1 within 1e-5, the energy and
SNR separation gates, the parts summing to the round trip above 60 dB,
the chunked median bit-equal to the direct one), then holds the port
against the reference on the same seeded input:

- `_sliding_median`: equal to the reference's, value for value, on each
  axis, chunked or not (a median of an odd window is one of its values);
- `hpss_masks` from the same power: within 2^-21 of the reference's (the
  masks lie in [0, 1]; XLA's CPU `power(x, 2.0)` is a `powf` that misses
  x*x by an ulp, torch squares; measured 1.2e-7);
- `hpss`, `harmonic`, `percussive`: each part within 1e-5 of the largest
  |value| of the reference's (the two STFTs differ by ulps; measured
  below 3e-7).
"""

import sys

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

import crlot_tpu.hpss  # noqa: F401  (the package re-exports the function)
from crlot_tpu.core.types import StftConfig as JConfig

import crlot_tpu_torch.hpss  # noqa: F401
from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.metrics import snr_db
from crlot_tpu_torch.pipeline import round_trip

ref = sys.modules["crlot_tpu.hpss"]
H = sys.modules["crlot_tpu_torch.hpss"]
_sliding_median, harmonic, hpss = H._sliding_median, H.harmonic, H.hpss
hpss_masks, percussive = H.hpss_masks, H.percussive

SR = 48000
CFG = StftConfig(frame_size=1024, hop_size=256, center=True)
JCFG = JConfig(frame_size=1024, hop_size=256, center=True)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, seconds=1.0, sr=SR):
    t = np.arange(int(seconds * sr)) / sr
    return np.sin(2 * np.pi * freq * t).astype(np.float32)


def _clicks(seconds=1.0, sr=SR, period=4800, width=8):
    x = np.zeros(int(seconds * sr), dtype=np.float32)
    for p in range(period // 2, len(x) - width, period):
        x[p : p + width] = 1.0
    return x


def _energy(x):
    return float(np.sum(np.square(np.asarray(x, np.float64))))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# mirrors of tests/test_hpss.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,axis", [(3, -1), (7, -1), (5, -2), (1, -1)])
def test_sliding_median_matches_scipy(size, axis):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 24)).astype(np.float32)
    got = _sliding_median(_t(x), size, axis).numpy()
    shape = [1, 1]
    shape[axis] = size
    want = scipy.ndimage.median_filter(x, size=tuple(shape), mode="nearest")
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sliding_median_rejects_even_size():
    with pytest.raises(ValueError):
        _sliding_median(torch.zeros((4, 4)), 4, axis=-1)


def test_masks_sum_to_one_at_unit_margin():
    rng = np.random.default_rng(3)
    p = _t(rng.uniform(0.1, 2.0, (40, 33)).astype(np.float32))
    mh, mp = hpss_masks(p, kernel_harm=9, kernel_perc=9)
    np.testing.assert_allclose((mh + mp).numpy(), 1.0, atol=1e-5)


def test_margin_rejects_below_one():
    with pytest.raises(ValueError):
        hpss_masks(torch.ones((8, 8)), margin_harm=0.5)


def test_margin_leaves_residual():
    rng = np.random.default_rng(4)
    p = _t(rng.uniform(0.1, 2.0, (40, 33)).astype(np.float32))
    mh, mp = hpss_masks(p, kernel_harm=9, kernel_perc=9,
                        margin_harm=3.0, margin_perc=3.0)
    assert float(torch.max(mh + mp)) < 1.0


def test_tone_is_harmonic():
    x = _tone(440.0)
    h, p = hpss(x, CFG, device=CPU)
    assert _energy(h) > 0.9 * _energy(x)
    assert _energy(p) < 0.1 * _energy(x)


def test_clicks_are_percussive():
    x = _clicks()
    h, p = hpss(x, CFG, device=CPU)
    assert _energy(p) > 0.8 * _energy(x)
    assert _energy(h) < 0.2 * _energy(x)


def test_mixture_separates():
    tone = _tone(440.0)
    clicks = 0.5 * _clicks()
    h, p = hpss(tone + clicks, CFG, device=CPU)
    assert snr_db(tone, h.numpy()) > 10.0
    assert snr_db(clicks, p.numpy()) > 3.0
    assert snr_db(tone, h.numpy()) > snr_db(tone, tone + clicks)


def test_parts_sum_to_round_trip_at_unit_margin():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(SR // 2).astype(np.float32)
    h, p = hpss(x, CFG, device=CPU)
    rt = round_trip(x, CFG, device=CPU).numpy()
    assert snr_db(rt, (h + p).numpy()) > 60.0


def test_wrappers_match_tuple():
    x = _tone(220.0, seconds=0.25)
    h, p = hpss(x, CFG, device=CPU)
    assert torch.equal(harmonic(x, CFG, device=CPU), h)
    assert torch.equal(percussive(x, CFG, device=CPU), p)


def test_sliding_median_chunked_matches_direct(monkeypatch):
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((37, 24)).astype(np.float32))
    for size, axis in [(5, -1), (7, -2)]:
        direct = _sliding_median(x, size, axis)
        monkeypatch.setattr(H, "_MEDIAN_STACK_ELEMS", 1024)
        chunked = _sliding_median(x, size, axis)
        monkeypatch.undo()
        assert torch.equal(chunked, direct)


def test_sliding_median_chunked_batched(monkeypatch):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 40, 8)).astype(np.float32)
    monkeypatch.setattr(H, "_MEDIAN_STACK_ELEMS", 512)
    got = _sliding_median(_t(x), 5, -2).numpy()
    want = np.stack([
        scipy.ndimage.median_filter(x[b], size=(5, 1), mode="nearest")
        for b in range(x.shape[0])
    ])
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,axis,cap", [
    (9, -1, None), (9, -2, None), (31, -2, 4096), (31, -1, 4096)])
def test_sliding_median_equals_reference(size, axis, cap, monkeypatch):
    rng = np.random.default_rng(20)
    x = rng.uniform(0, 2, (2, 120, 65)).astype(np.float32)
    if cap is not None:
        monkeypatch.setattr(H, "_MEDIAN_STACK_ELEMS", cap)
        monkeypatch.setattr(ref, "_MEDIAN_STACK_ELEMS", cap)
    got = _sliding_median(_t(x), size, axis).numpy()
    want = np.asarray(ref._sliding_median(jnp.asarray(x), size, axis))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("margin", [1.0, 2.5])
def test_masks_match_reference(margin):
    rng = np.random.default_rng(21)
    p = rng.uniform(0, 2, (2, 120, 65)).astype(np.float32)
    got = hpss_masks(_t(p), 9, 15, 2.0, margin, margin)
    want = ref.hpss_masks(jnp.asarray(p), 9, 15, 2.0, margin, margin)
    for g, w in zip(got, want):
        assert np.max(np.abs(g.numpy() - np.asarray(w))) <= 2.0 ** -21


def test_hpss_matches_reference():
    rng = np.random.default_rng(22)
    x = (0.5 * np.stack([_tone(440.0, 0.5), _tone(660.0, 0.5)])
         + 0.5 * rng.standard_normal((2, SR // 2))
         * (rng.uniform(size=(2, SR // 2)) < 0.01)).astype(np.float32)
    got = hpss(x, CFG, kernel_harm=17, kernel_perc=11, device=CPU)
    want = ref.hpss(x, JCFG, kernel_harm=17, kernel_perc=11)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.max(np.abs(w))
    g = harmonic(x, CFG, margin_harm=2.0, device=CPU).numpy()
    w = np.asarray(ref.harmonic(x, JCFG, margin_harm=2.0))
    assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))
    g = percussive(x, CFG, margin_perc=2.0, device=CPU).numpy()
    w = np.asarray(ref.percussive(x, JCFG, margin_perc=2.0))
    assert np.max(np.abs(g - w)) <= 1e-5 * np.max(np.abs(w))
