"""The port's streaming `Framer`, `FrameQueue` and AoS/SoA helpers against
the reference's.

Mirrors the framer, `FrameQueue` and AoS/SoA cases of
`tests/test_framing.py` (its lines 136-245) on the same inputs, and drives
the reference's `Framer` beside the port's with the same pushes: every
popped frame, `available()` and the buffer's growth and compaction are
equal (`assert_array_equal`: exact, no tolerance). The port's frames come
back as float32 tensors on the framer's device (here `device="cpu"`).
"""

import numpy as np
import pytest
import torch

from crlot_tpu.core.types import BoundaryMode as JBoundary
from crlot_tpu.core.types import FrameSpec as JSpec
from crlot_tpu.frame.framing import FrameQueue as JFrameQueue
from crlot_tpu.frame.framing import aos_to_soa as j_aos_to_soa
from crlot_tpu.frame.framing import frame_start_indices as j_starts
from crlot_tpu.frame.streaming import Framer as JFramer

import crlot_tpu_torch as pt
from crlot_tpu_torch.core.types import BoundaryMode, FrameSpec
from crlot_tpu_torch.frame.framing import (
    FrameQueue,
    aos_to_soa,
    frame_start_indices,
    soa_to_aos,
)

CPU = "cpu"


def _framer(*a, **kw):
    return pt.Framer(*a, device=CPU, **kw)


class Pair:
    def __init__(self, n, hop, channels=1, boundary="zero_pad"):
        self.j = JFramer(n, hop, channels, JBoundary(boundary))
        self.p = _framer(n, hop, channels, BoundaryMode(boundary))

    def same(self):
        assert self.p.available() == self.j.available()
        assert self.p.buffered == self.j.buffered
        np.testing.assert_array_equal(self.p._buf, self.j._buf)

    def push(self, x):
        self.j.push(x)
        self.p.push(x)
        self.same()

    def pop(self):
        want = self.j.pop()
        got = self.p.pop()
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want)
        self.same()
        return want

    def flush(self):
        self.j.flush()
        self.p.flush()
        self.same()


def test_framer_push_pop_matches_batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000).astype(np.float32)
    pair = Pair(64, 16, 1, "drop")
    popped = []
    for chunk in np.array_split(x, 13):
        pair.push(chunk)
        while (f := pair.pop()) is not None:
            popped.append(f[0])
    batch = pt.frame_signal(torch.from_numpy(x), FrameSpec(64, 16)).numpy()
    got = np.stack(popped)
    assert got.shape == batch.shape
    np.testing.assert_array_equal(got, batch)


def test_framer_available_law():
    pair = Pair(1024, 256)
    pair.push(np.zeros(1024, dtype=np.float32))
    assert pair.p.available() == 1
    pair.push(np.zeros(255, dtype=np.float32))
    assert pair.p.available() == 1
    pair.push(np.zeros(1, dtype=np.float32))
    assert pair.p.available() == 2  # (1280-1024)//256+1


def test_framer_zero_pad_flush():
    pair = Pair(8, 4, boundary="zero_pad")
    pair.push(np.ones(10, dtype=np.float32))
    assert pair.p.available() == 1
    np.testing.assert_array_equal(pair.pop()[0], np.ones(8))
    assert pair.pop() is None  # only 6 left, no full frame
    pair.flush()
    np.testing.assert_array_equal(pair.pop()[0], [1, 1, 1, 1, 1, 1, 0, 0])
    assert pair.pop() is None


def test_framer_drop_refuses_partial():
    pair = Pair(8, 4, boundary="drop")
    pair.push(np.ones(10, dtype=np.float32))
    pair.pop()
    pair.flush()
    assert pair.pop() is None


def test_framer_stereo_deinterleave():
    pair = Pair(4, 2, channels=2)
    pair.push(np.array([1, -1, 2, -2, 3, -3, 4, -4], dtype=np.float32))
    np.testing.assert_array_equal(pair.pop(),
                                  [[1, 2, 3, 4], [-1, -2, -3, -4]])


def test_framer_pop_batch():
    j, p = JFramer(16, 8), _framer(16, 8)
    for fr in (j, p):
        fr.push(np.arange(100, dtype=np.float32))
    want = j.pop_batch()
    got = p.pop_batch()
    assert tuple(got.shape) == (11, 1, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[10, 0].numpy(), np.arange(80, 96))
    for fr in (j, p):  # a capped batch, after a flushed partial tail
        fr.push(np.arange(100, 150, dtype=np.float32))
        fr.flush()
    np.testing.assert_array_equal(p.pop_batch(3).numpy(), j.pop_batch(3))
    np.testing.assert_array_equal(p.pop_batch().numpy(), j.pop_batch())
    assert p.available() == j.available() == 0


def test_framer_compaction_long_stream():
    pair = Pair(64, 32)
    for _ in range(200):
        pair.push(np.zeros(64, dtype=np.float32))
        while pair.pop() is not None:
            pass
    assert pair.p._buf.size <= 64 * 4 * 4


def test_framer_growth_matches_reference():
    """A push larger than the buffer grows it geometrically, as the
    reference does; interleaved multichannel pops stay exact."""
    rng = np.random.default_rng(4)
    pair = Pair(32, 12, channels=3)
    for size in (3 * 500, 3 * 7, 3 * 1000, 3 * 33):
        pair.push(rng.standard_normal(size).astype(np.float32))
        for _ in range(5):
            pair.pop()
    pair.flush()
    while pair.pop() is not None:
        pass


def test_framer_invalid():
    with pytest.raises(ValueError):
        _framer(0, 1)
    fr = _framer(4, 2, channels=2)
    with pytest.raises(ValueError):
        fr.push(np.zeros(3, dtype=np.float32))  # not a multiple of channels
    fr.flush()
    with pytest.raises(RuntimeError):
        fr.push(np.zeros(2, dtype=np.float32))


def test_framer_defaults_to_the_card():
    if torch.cuda.is_available():
        assert pt.Framer(8, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Framer(8, 4)


def test_frame_queue_accessors():
    x = np.arange(64, dtype=np.float32)
    q = FrameQueue(x, FrameSpec(16, 8), device=CPU)
    jq = JFrameQueue(x, JSpec(16, 8))
    assert len(q) == q.num_frames == len(jq) == 7
    np.testing.assert_array_equal(q.get_frame(2).numpy(), x[16:32])
    c = q.copy_frame(0)
    c[0] = 99.0
    assert q.get_frame(0)[0] == 0.0  # the copy is independent
    allf = q.get_all_frames()
    assert tuple(allf.shape) == (7, 16)
    assert allf.is_contiguous()  # frame i+1 follows frame i
    np.testing.assert_array_equal(allf.numpy(), jq.get_all_frames())
    with pytest.raises(IndexError):
        q.get_frame(7)
    with pytest.raises(ValueError):
        FrameQueue(np.zeros((2, 64), dtype=np.float32), FrameSpec(16, 8),
                   device=CPU)


@pytest.mark.parametrize("center", [False, True])
def test_frame_start_indices_match_reference(center):
    spec, jspec = FrameSpec(16, 4, center=center), JSpec(16, 4, center=center)
    got = frame_start_indices(spec, 100, device=CPU)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_starts(jspec, 100)))


def test_aos_soa_round_trip():
    inter = np.array([1, -1, 2, -2, 3, -3], dtype=np.float32)
    soa = aos_to_soa(inter, 2, device=CPU)
    np.testing.assert_array_equal(soa.numpy(), [[1, 2, 3], [-1, -2, -3]])
    np.testing.assert_array_equal(soa.numpy(), j_aos_to_soa(inter, 2))
    assert soa.is_contiguous()
    np.testing.assert_array_equal(soa_to_aos(soa).numpy(), inter)
    with pytest.raises(ValueError):
        aos_to_soa(np.zeros(5, dtype=np.float32), 2, device=CPU)
    with pytest.raises(ValueError):
        soa_to_aos(np.zeros(4, dtype=np.float32), device=CPU)
