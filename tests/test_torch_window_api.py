"""The port's window cache and verification oracles against the reference
(`tests/test_window.py`'s cache and oracle cases, run on both packages).

Tolerances: each oracle returns a float64 value equal (==) to the
reference's on the same input; the gates the reference test states
(RMS < 1e-6 against the re-derived formula, sums to 1e-6, the OLA gain of a
periodic Hann at 75 % overlap to 1e-3 relative) are kept as they are. The
cache keeps the reference's semantics: one object per key, `clear_cache`
safe while callers hold references, and an 8-thread race that leaves every
window finite.
"""

import concurrent.futures
import math

import numpy as np
import pytest

from crlot_tpu.core.types import NormalizationType as JNorm
from crlot_tpu.core.types import WindowType as JWin
from crlot_tpu.window import windows as JW

from crlot_tpu_torch.core.types import NormalizationType, WindowType
from crlot_tpu_torch.window import windows as W

SIZES = [8, 64, 255, 256, 1000, 1023, 1024, 4096]


def _formula(wtype, n, periodic):
    denom = n if periodic else n - 1
    k = np.arange(n, dtype=np.float64)
    c = lambda m: np.cos(2.0 * math.pi * m * k / denom)  # noqa: E731
    if wtype == WindowType.HANN:
        return 0.5 - 0.5 * c(1)
    if wtype == WindowType.HAMMING:
        return 0.54 - 0.46 * c(1)
    if wtype == WindowType.BLACKMAN:
        return 0.42 - 0.5 * c(1) + 0.08 * c(2)
    if wtype == WindowType.BLACKMAN_HARRIS:
        return 0.35875 - 0.48829 * c(1) + 0.14128 * c(2) - 0.01168 * c(3)
    return np.ones(n)


@pytest.mark.parametrize("wtype", list(WindowType))
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("periodic", [True, False])
def test_window_rms_error_matches_reference(wtype, n, periodic):
    w = W.get_window(wtype, n, periodic)
    want = _formula(wtype, n, periodic)
    rms = W.calculate_rms_error(w, want)
    assert rms < 1e-6, f"{wtype} N={n} periodic={periodic}: rms {rms}"
    assert rms == JW.calculate_rms_error(w, want)


@pytest.mark.parametrize("n", [256, 1000, 1024])
def test_sum_oracles_match_reference(n):
    s1 = W.get_window(WindowType.HANN, n, norm=NormalizationType.SUM_TO_ONE)
    l2 = W.get_window(WindowType.HAMMING, n, norm=NormalizationType.L2_NORM)
    assert abs(W.calculate_sum(s1) - 1.0) < 1e-6
    assert abs(W.calculate_sum_of_squares(l2) - 1.0) < 1e-6
    assert W.calculate_sum(s1) == JW.calculate_sum(s1)
    assert W.calculate_sum_of_squares(l2) == JW.calculate_sum_of_squares(l2)


def test_ola_sum_wsq_with_hop():
    n, hop = 1024, 256
    w = W.get_window(WindowType.HANN, n, norm=NormalizationType.OLA_SUM_WSQ,
                     hop=hop)
    jw = JW.get_window(JWin.HANN, n, norm=JNorm.OLA_SUM_WSQ, hop=hop)
    assert W.calculate_sum_of_squares(w) == pytest.approx(hop / n, rel=1e-6)
    assert W.calculate_sum_of_squares(w) == JW.calculate_sum_of_squares(jw)


@pytest.mark.parametrize("n,hop", [(1024, 256), (1000, 250), (512, 384),
                                   (64, 1), (8, 16)])
def test_calculate_ola_gain_matches_reference(n, hop):
    w = W.get_window(WindowType.HANN, n, periodic=True)
    assert W.calculate_ola_gain(w, hop) == JW.calculate_ola_gain(w, hop)
    if (n, hop) == (1024, 256):  # max overlapped sum of w^2 = 1.5
        assert W.calculate_ola_gain(w, hop) == pytest.approx(1.5, rel=1e-3)


def test_oracles_reject_what_the_reference_rejects():
    w = W.get_window(WindowType.HANN, 1024, periodic=True)
    for mod in (W, JW):
        with pytest.raises(ValueError):
            mod.calculate_ola_gain(w, 0)
        with pytest.raises(ValueError):
            mod.calculate_rms_error(np.ones(3), np.ones(4))
        assert mod.calculate_rms_error(np.ones(0), np.ones(0)) == 0.0


def test_cache_identity_and_clear():
    W.clear_cache()
    a = W.get_window(WindowType.HANN, 512)
    b = W.get_window(WindowType.HANN, 512)
    assert a is b  # same key -> same object
    assert W.cache_size() >= 1
    W.clear_cache()
    assert W.cache_size() == 0
    assert a[256] == pytest.approx(1.0, abs=1e-6)  # a live array survives
    c = W.get_window(WindowType.HANN, 512)
    np.testing.assert_array_equal(a, c)
    assert c is not a
    np.testing.assert_array_equal(c, JW.get_window(JWin.HANN, 512))


def test_cache_counts_keys():
    W.clear_cache()
    for n in (64, 128):
        for periodic in (True, False):
            W.get_window(WindowType.HAMMING, n, periodic)
            W.get_window(WindowType.HAMMING, n, periodic)  # a hit
    W.get_window(WindowType.HAMMING, 64, dtype=np.float64)
    assert W.cache_size() == 5


def test_cache_thread_race():
    """8 threads (reference: window_lut_test.cc:244-284) reading and
    clearing at once."""
    W.clear_cache()

    def task(i):
        out = []
        for n in [256, 512, 1024, 1000]:
            out.append(W.get_window(WindowType.HANN, n, periodic=bool(i % 2)))
            if i % 3 == 0:
                W.clear_cache()
        return out

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(task, range(32)))
    for i, res in enumerate(results):
        for n, w in zip([256, 512, 1024, 1000], res):
            assert np.isfinite(w).all()
            np.testing.assert_array_equal(
                w, JW.get_window(JWin.HANN, n, periodic=bool(i % 2)))
