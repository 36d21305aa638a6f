"""The port's host metrics against the reference's: `snr_db`, `rms_db`,
`xcorr_delay_samples`, `xcorr_delay_ms` and `PeakMeter`.

Both compute in float64 on the host from the same float32 inputs, so every
value is held equal (`==`, no tolerance), for numpy input and for a CPU
tensor.
"""

import numpy as np
import pytest
import torch

from crlot_tpu import metrics as jm

import crlot_tpu_torch as pt
from crlot_tpu_torch import metrics as pm


def _sig(n, seed):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_rms_db_matches_reference(as_tensor):
    for x in (_sig(1000, 0), 0.25 * _sig(7, 1), np.zeros(5, np.float32),
              np.zeros(0, np.float32), np.ones((2, 3), np.float32)):
        arg = torch.from_numpy(x) if as_tensor else x
        assert pm.rms_db(arg) == jm.rms_db(x)


@pytest.mark.parametrize("lag", [-37, 0, 5, 120])
def test_xcorr_delay_matches_reference(lag):
    ref = _sig(2000, 2)
    test = np.roll(ref, lag) + 0.01 * _sig(2000, 3)
    got = pm.xcorr_delay_samples(torch.from_numpy(ref), test)
    assert got == jm.xcorr_delay_samples(ref, test) == lag
    assert pt.xcorr_delay_ms(ref, test, 48000) == jm.xcorr_delay_ms(
        ref, test, 48000) == lag * 1000.0 / 48000


def test_xcorr_delay_unequal_lengths():
    ref, test = _sig(300, 4), _sig(417, 5)
    assert pm.xcorr_delay_samples(ref, test) == jm.xcorr_delay_samples(
        ref, test)


def test_peak_meter_matches_reference():
    j, p = jm.PeakMeter(), pt.PeakMeter()
    assert p.peak == j.peak == 0.0 and p.peak_db == j.peak_db == -np.inf
    for block in (0.5 * _sig(64, 6), np.zeros(0, np.float32),
                  np.array([-0.75, 0.1], np.float32), 0.1 * _sig(9, 7)):
        assert p.update(torch.from_numpy(block)) == j.update(block)
        assert p.peak == j.peak and p.peak_db == j.peak_db
    p.reset()
    j.reset()
    assert p.peak == j.peak == 0.0


def test_snr_db_matches_reference():
    x = _sig(4096, 8)
    y = x + 1e-4 * _sig(4096, 9)
    assert pm.snr_db(x, torch.from_numpy(y)) == jm.snr_db(x, y)
    assert pm.snr_db(x, x) == jm.snr_db(x, x) == np.inf
