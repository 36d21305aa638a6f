"""The port's segmentation (`crlot_tpu_torch.segment`) and tonnetz on the
CPU.

Mirrors `tests/test_segment.py` (its 12 cases and gates: trims and splits
that cover each tone and cut the silence to within a frame, all-silent
input, batched masks, the tonnetz basis's circle radii within 1e-6, a
fifth nearer than a tritone, tonnetz within [-1, 1], the frame / time
conversions), then holds the port against the reference on the same
input: `activity_mask`, `trim_silence` and `split_silence` equal
(booleans and sample intervals), `frames_to_time` / `time_to_frames`
equal value for value, and `tonnetz` within 1e-5 of the largest |value|
of the reference's.
"""

import numpy as np
import pytest
import torch

from crlot_tpu import features as ref_features
from crlot_tpu import segment as ref
from crlot_tpu.core.types import StftConfig as RefConfig

from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.features import _tonnetz_basis, tonnetz
from crlot_tpu_torch.segment import (
    activity_mask,
    frames_to_time,
    split_silence,
    time_to_frames,
    trim_silence,
)

SR = 16000
CFG = StftConfig(frame_size=512, hop_size=128, center=True)
REF_CFG = RefConfig(frame_size=512, hop_size=128, center=True)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tone(freq, n, sr=SR, amp=0.5):
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _with_silence():
    """0.2 s silence | 0.3 s tone | 0.25 s silence | 0.3 s tone | 0.2 s."""
    gap = lambda s: np.zeros(int(s * SR), np.float32)  # noqa: E731
    a, b = _tone(440.0, int(0.3 * SR)), _tone(880.0, int(0.3 * SR))
    x = np.concatenate([gap(0.2), a, gap(0.25), b, gap(0.2)])
    spans = [
        (int(0.2 * SR), int(0.5 * SR)),
        (int(0.75 * SR), int(1.05 * SR)),
    ]
    return x, spans


def test_trim_covers_active_region():
    x, spans = _with_silence()
    trimmed, (start, end) = trim_silence(x, CFG, top_db=40.0, device=CPU)
    assert start <= spans[0][0] and end >= spans[1][1]
    assert start > spans[0][0] - CFG.frame_size
    assert end < spans[1][1] + CFG.frame_size
    np.testing.assert_array_equal(trimmed, x[start:end])


def test_trim_all_silence():
    trimmed, (s, e) = trim_silence(np.zeros(SR, np.float32), CFG, device=CPU)
    assert trimmed.size == 0 and (s, e) == (0, 0)


def test_split_finds_both_regions():
    x, spans = _with_silence()
    iv = split_silence(x, CFG, top_db=40.0, device=CPU)
    assert len(iv) == 2
    for (s, e), (ts, te) in zip(iv, spans):
        assert s <= ts and e >= te
        assert s > ts - CFG.frame_size and e < te + CFG.frame_size
    assert iv[0][1] <= iv[1][0]


def test_split_all_silence_empty():
    assert split_silence(np.zeros(SR, np.float32), CFG, device=CPU) == []


def test_activity_mask_batched():
    x, _ = _with_silence()
    m = activity_mask(np.stack([x, x]), CFG, top_db=40.0, device=CPU).numpy()
    assert m.shape[0] == 2
    np.testing.assert_array_equal(m[0], m[1])


def test_trim_rejects_2d():
    with pytest.raises(ValueError):
        trim_silence(np.zeros((2, SR), np.float32), CFG, device=CPU)


# ---------------------------------------------------------------------------
# tonnetz
# ---------------------------------------------------------------------------

def test_tonnetz_basis_geometry():
    b = _tonnetz_basis(12)
    assert b.shape == (6, 12)
    np.testing.assert_allclose(np.hypot(b[0], b[1]), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.hypot(b[4], b[5]), 0.5, atol=1e-6)


def test_fifth_closer_than_tritone():
    sr, cfg = 48000, StftConfig(frame_size=4096, hop_size=1024, center=True)
    n = sr // 2
    c4, g4, fs4 = 261.63, 392.00, 369.99

    def t(f):
        return tonnetz(_tone(f, n, sr), cfg, sr, device=CPU).numpy().mean(0)

    tc, tg, tf = t(c4), t(g4), t(fs4)
    assert np.linalg.norm(tc - tg) < np.linalg.norm(tc - tf)


def test_tonnetz_shape_and_bounds():
    t = tonnetz(_tone(440.0, SR // 2), CFG, SR, device=CPU).numpy()
    assert t.shape[-1] == 6
    assert np.all(np.abs(t) <= 1.0 + 1e-6)


# ---------------------------------------------------------------------------
# frame/time conversion
# ---------------------------------------------------------------------------

def test_frames_to_time_roundtrip():
    f = np.arange(0, 200, 7)
    t = frames_to_time(f, CFG, SR)
    np.testing.assert_array_equal(time_to_frames(t, CFG, SR), f)


def test_frames_to_time_center_convention():
    c = StftConfig(frame_size=512, hop_size=128, center=True)
    u = StftConfig(frame_size=512, hop_size=128, center=False)
    assert frames_to_time(0, c, SR) == 0.0
    assert abs(frames_to_time(0, u, SR) - 256 / SR) < 1e-12


def test_time_to_frames_clips_at_zero():
    u = StftConfig(frame_size=512, hop_size=128, center=False)
    assert time_to_frames(0.0, u, SR) == 0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _gappy(seed):
    """Tones with silent and near-silent gaps, plus a quiet noise floor in
    one gap (above and below top_db)."""
    rng = np.random.default_rng(seed)
    x, _ = _with_silence()
    x = x.copy()
    x[int(0.55 * SR) : int(0.65 * SR)] = 1e-4 * rng.standard_normal(
        int(0.1 * SR))
    return x


@pytest.mark.parametrize("top_db", [20.0, 40.0, 90.0])
def test_segmentation_matches_reference(top_db):
    x = _gappy(0)
    for center in (True, False):
        cfg = StftConfig(frame_size=512, hop_size=128, center=center)
        rcfg = RefConfig(frame_size=512, hop_size=128, center=center)
        np.testing.assert_array_equal(
            activity_mask(np.stack([x, 0.1 * x]), cfg, top_db,
                          device=CPU).numpy(),
            np.asarray(ref.activity_mask(np.stack([x, 0.1 * x]), rcfg,
                                         top_db)))
        assert (split_silence(x, cfg, top_db, device=CPU)
                == ref.split_silence(x, rcfg, top_db))
        got, se = trim_silence(x, cfg, top_db, device=CPU)
        want, se_ref = ref.trim_silence(x, rcfg, top_db)
        assert se == se_ref
        np.testing.assert_array_equal(got, want)


def test_tensor_input_gives_a_slice_of_the_tensor():
    x = torch.from_numpy(_gappy(1))
    trimmed, (s, e) = trim_silence(x, CFG, top_db=40.0)
    assert isinstance(trimmed, torch.Tensor) and torch.equal(trimmed, x[s:e])
    assert split_silence(x, CFG, top_db=40.0) == split_silence(
        x.numpy(), CFG, top_db=40.0, device=CPU)


def test_frame_time_conversions_match_reference():
    f = np.arange(0, 500, 3)
    for center in (True, False):
        cfg = StftConfig(frame_size=1024, hop_size=256, center=center)
        rcfg = RefConfig(frame_size=1024, hop_size=256, center=center)
        t = frames_to_time(f, cfg, 48000)
        assert np.array_equal(t, ref.frames_to_time(f, rcfg, 48000))
        assert np.array_equal(time_to_frames(t + 1e-4, cfg, 48000),
                              ref.time_to_frames(t + 1e-4, rcfg, 48000))


def test_tonnetz_matches_reference():
    sr = 48000
    cfg = StftConfig(frame_size=4096, hop_size=1024, center=True)
    rcfg = RefConfig(frame_size=4096, hop_size=1024, center=True)
    x = np.stack([_tone(261.63, sr // 2, sr), _tone(392.0, sr // 2, sr)])
    got = tonnetz(x, cfg, sr, device=CPU).numpy()
    want = np.asarray(ref_features.tonnetz(x, rcfg, sr))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
