"""The port's streaming OLA accumulator against the reference's, in lockstep.

Mirrors `tests/test_streaming_ola.py` (its twelve tests, same inputs from
the same seeds) with both accumulators driven by the same calls: after
every call the port's ring, cursors and cursor shift are equal to the
reference's (`assert_array_equal`, no tolerance), and so is every
`produce` output. The reference's own oracle checks are kept beside it
with its bounds (offline OLA within 1e-5, interior reconstruction above
100 dB). The port drains through `ola.kernels.normalize_and_clear` (B5's
K6 on the card, its plain version on these CPU tensors): one call a ring
span, never one a channel, and a tensor off the CPU never takes the plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crlot_tpu.core.types import OLAConfig as JOLAConfig
from crlot_tpu.ola.reference import overlap_add
from crlot_tpu.ola.streaming import OLAAccumulator as JAccumulator
from crlot_tpu.ola.streaming import ola_available as j_ola_available
from crlot_tpu.ola.streaming import ola_init as j_ola_init
from crlot_tpu.ola.streaming import ola_produce as j_ola_produce

import crlot_tpu_torch as pt
from crlot_tpu_torch.convert import ola_config_from_reference
from crlot_tpu_torch.core.types import WindowType
from crlot_tpu_torch.metrics import snr_db
from crlot_tpu_torch.ola import kernels as pk
from crlot_tpu_torch.ola import streaming as ps
from crlot_tpu_torch.window.windows import get_window

CPU = "cpu"


def _cfg(**kw):
    base = dict(sample_rate=48000, frame_size=64, hop_size=16, channels=1)
    base.update(kw)
    return JOLAConfig(**base)


class Pair:
    """The reference's and the port's accumulator, fed the same calls and
    compared after each one."""

    def __init__(self, jcfg, window=None):
        self.cfg = jcfg
        self.j = JAccumulator(jcfg)
        self.p = pt.OLAAccumulator(ola_config_from_reference(jcfg),
                                   device=CPU)
        if window is not None:
            self.j.set_window(window)
            self.p.set_window(window)
        self.same()

    def same(self):
        js, ps_ = self.j._state, self.p._state
        np.testing.assert_array_equal(ps_.ring.numpy(), np.asarray(js.ring))
        assert ps_.read_pos == int(js.read_pos)
        assert ps_.produced == int(js.produced)
        assert ps_.flushed == bool(js.flushed)
        assert self.p._cursor_shift == self.j._cursor_shift

    def add(self, frame, start, **kw):
        self.j.add_frame_soa(frame, start, **kw)
        self.p.add_frame_soa(frame, start, **kw)
        self.same()

    def produce(self, n):
        read_pos = int(self.j._state.read_pos)
        want = self.j.produce(n)
        got = self.p.produce(n)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        if n > self.cfg.ring_len and want.shape[1]:
            # C14: the reference's clear scatters n > ring_len indices, and
            # an uncleared duplicate overwrites a drained slot; the port
            # clears every drained slot.
            ring = np.array(self.j._state.ring)
            idx = (read_pos + np.arange(want.shape[1])) % self.cfg.ring_len
            ring[:, idx] = 0.0
            np.testing.assert_array_equal(self.p._state.ring.numpy(), ring)
            self.j._state = self.j._state._replace(ring=jnp.asarray(ring))
        self.same()
        return want

    def available(self):
        a = self.j.available()
        assert self.p.available() == a
        return a

    def flush(self):
        self.j.flush()
        self.p.flush()
        self.same()


def _run_stream(cfg, frames, window=None, drain_every=1, gain=1.0):
    """Push frames at k*hop, draining hop samples per frame, through both
    accumulators; returns the output."""
    pair = Pair(cfg, window)
    chunks = []
    for k in range(frames.shape[0]):
        pair.add(frames[k], k * cfg.hop_size, gain=gain)
        if (k + 1) % drain_every == 0:
            chunks.append(pair.produce(cfg.hop_size * drain_every))
    pair.flush()
    while True:
        out = pair.produce(cfg.ring_len)
        if out.shape[1] == 0:
            break
        chunks.append(out)
    return np.concatenate(chunks, axis=1)


@pytest.mark.parametrize("n,hop", [(64, 16), (64, 32), (64, 64), (48, 12)])
def test_streaming_matches_offline_unwindowed(n, hop):
    rng = np.random.default_rng(0)
    f = 40
    cfg = _cfg(frame_size=n, hop_size=hop, apply_window_inside=False)
    frames = rng.standard_normal((f, 1, n)).astype(np.float32)
    got = _run_stream(cfg, frames)
    want = np.asarray(overlap_add(frames[:, 0, :], hop))
    assert got.shape[1] == want.shape[0]
    np.testing.assert_allclose(got[0], want, atol=1e-5)


def test_streaming_ring_reuse_long_stream():
    cfg = _cfg(frame_size=64, hop_size=16, ring_margin_hops=4)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((200, 1, 64)).astype(np.float32)
    w = get_window(WindowType.HANN, 64, periodic=True)
    got = _run_stream(cfg, frames, window=w, gain=0.7)
    wf = frames[:, 0, :] * np.float32(0.7) * w
    acc = np.asarray(overlap_add(wf, 16))
    steady = np.array([w.astype(np.float64)[p::16].sum() for p in range(16)])
    norm = np.tile(steady, acc.shape[0] // 16 + 1)[: acc.shape[0]]
    want = acc / np.maximum(norm, 1e-8)
    n = 64
    assert snr_db(want[n:-n], got[0][n : want.shape[0] - n]) > 100


def test_aos_matches_soa():
    cfg = _cfg(frame_size=32, hop_size=8, channels=2)
    rng = np.random.default_rng(2)
    frame = rng.standard_normal((2, 32)).astype(np.float32)
    a = Pair(cfg)
    b = pt.OLAAccumulator(ola_config_from_reference(cfg), device=CPU)
    a.add(frame, 0)
    b.push_frame_aos(frame.T.reshape(-1), 0)
    a.flush()
    b.flush()
    np.testing.assert_array_equal(a.produce(64), b.produce(64).numpy())


def test_partial_frame_clamp():
    cfg = _cfg(frame_size=16, hop_size=4, apply_window_inside=False)
    pair = Pair(cfg)
    frame = np.arange(16, dtype=np.float32)[None, :]
    pair.add(frame, 0, start_off=4, size=100)  # size clamps to 12
    pair.flush()
    out = pair.produce(32)[0]
    np.testing.assert_array_equal(out[:12], np.arange(4, 16))
    assert np.all(out[12:] == 0)


def test_gain():
    cfg = _cfg(frame_size=16, hop_size=16, apply_window_inside=False)
    pair = Pair(cfg)
    pair.add(np.ones((1, 16), dtype=np.float32), 0, gain=2.5)
    pair.flush()
    np.testing.assert_allclose(pair.produce(16)[0], 2.5, rtol=1e-6)


def test_available_respects_overlap_tail():
    cfg = _cfg(frame_size=64, hop_size=16)
    pair = Pair(cfg)
    pair.add(np.ones((1, 64), dtype=np.float32), 0)
    assert pair.available() == 16
    pair.flush()
    assert pair.available() == 64


def test_produce_clamps_to_available():
    cfg = _cfg(frame_size=32, hop_size=8, apply_window_inside=False)
    pair = Pair(cfg)
    pair.add(np.ones((1, 32), dtype=np.float32), 0)
    assert pair.produce(1000).shape == (1, 8)  # only one hop is safe


def test_reference_fault_c14_drain_past_ring_len():
    """ROADMAP C14: the reference's produce(n) with n > ring_len leaves
    drained slots uncleared (its scatter has duplicate indices and an
    uncleared duplicate wins), so they would be added into again on the
    next lap. The port clears every drained slot; the outputs agree."""
    cfg = _cfg(frame_size=32, hop_size=8, apply_window_inside=False)
    j = JAccumulator(cfg)
    p = pt.OLAAccumulator(ola_config_from_reference(cfg), device=CPU)
    for acc in (j, p):
        acc.add_frame_soa(np.ones((1, 32), dtype=np.float32), 0)
    np.testing.assert_array_equal(p.produce(1000).numpy(), j.produce(1000))
    assert np.asarray(j._state.ring)[0, :8].tolist() == [1.0] * 8
    assert p._state.ring[0, :8].tolist() == [0.0] * 8


def test_ring_overrun_raises():
    cfg = _cfg(frame_size=64, hop_size=16, ring_margin_hops=2)
    pair = Pair(cfg)
    frame = np.ones((1, 64), dtype=np.float32)
    for acc in (pair.j, pair.p):
        with pytest.raises(ValueError, match="overruns the ring"):
            acc.add_frame_soa(frame, cfg.ring_len)  # a full lap ahead
    pair.same()


def test_peak_meter_and_reset():
    cfg = _cfg(frame_size=16, hop_size=16, apply_window_inside=False,
               channels=2)
    pair = Pair(cfg)
    frame = np.zeros((2, 16), dtype=np.float32)
    frame[0, 3] = -0.75
    frame[1, 5] = 3.0  # the meter reads channel 0 only
    pair.add(frame, 0)
    pair.flush()
    pair.produce(16)
    assert pair.p.meter_peak == pair.j.meter_peak == pytest.approx(0.75)
    pair.j.reset()
    pair.p.reset()
    pair.same()
    assert pair.p.meter_peak == 0.0
    assert pair.p.available() == 0
    assert pair.p.window is None


def test_window_inside_normalization_reconstructs():
    n, hop = 64, 16
    cfg = _cfg(frame_size=n, hop_size=hop, apply_window_inside=True)
    w = get_window(WindowType.HANN, n, periodic=True)
    rng = np.random.default_rng(3)
    f = 50
    sig = rng.uniform(-1, 1, (f - 1) * hop + n).astype(np.float32)
    idx = np.arange(f)[:, None] * hop + np.arange(n)[None, :]
    frames = sig[idx][:, None, :]
    got = _run_stream(cfg, frames, window=w)[0]
    assert snr_db(sig[n:-n], got[n : len(sig) - n]) > 100


def test_set_window_validation():
    cfg = ola_config_from_reference(_cfg(frame_size=32, hop_size=8))
    ola = pt.OLAAccumulator(cfg, device=CPU)
    with pytest.raises(ValueError):
        ola.set_window(np.ones(31, dtype=np.float32))
    with pytest.raises(ValueError):
        ola.add_frame_soa(np.ones((2, 32), dtype=np.float32), 0)
    with pytest.raises(ValueError):
        pt.OLAConfig(sample_rate=48000, frame_size=32, hop_size=64)


def test_cursor_renormalization_long_stream():
    cfg = _cfg(frame_size=64, hop_size=16, apply_window_inside=False)
    pair = Pair(cfg)
    big = (1 << 30) + cfg.ring_len * 3
    shift = (big // cfg.ring_len) * cfg.ring_len
    pair.j._state = pair.j._state._replace(
        read_pos=pair.j._state.read_pos + (big - shift),
        produced=pair.j._state.produced + (big - shift),
    )
    pair.j._cursor_shift = shift
    pair.p._state = pair.p._state._replace(
        read_pos=pair.p._state.read_pos + (big - shift),
        produced=pair.p._state.produced + (big - shift),
    )
    pair.p._cursor_shift = shift
    base = shift + (big - shift)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((20, 1, 64)).astype(np.float32)
    chunks = []
    for k in range(20):
        pair.add(frames[k], base + k * 16)
        avail = pair.available()
        if avail:
            chunks.append(pair.produce(avail))
    pair.flush()
    chunks.append(pair.produce(cfg.ring_len))
    got = np.concatenate(chunks, axis=1)
    want = np.asarray(overlap_add(frames[:, 0, :], 16))
    np.testing.assert_allclose(got[0], want, atol=1e-5)


def test_cursors_renormalize_past_2_30_like_the_reference():
    """The port's own shift (not simulated): read_pos crosses 2^30 in a
    produce and both packages shift by the same ring multiple."""
    cfg = _cfg(frame_size=64, hop_size=16, apply_window_inside=False)
    pair = Pair(cfg)
    start = (1 << 30) - 32
    for acc in (pair.j, pair.p):
        acc._cursor_shift = 0
    pair.j._state = pair.j._state._replace(
        read_pos=np.int32(start), produced=np.int32(start))
    pair.p._state = pair.p._state._replace(read_pos=start, produced=start)
    rng = np.random.default_rng(8)
    for k in range(8):
        pair.add(rng.standard_normal((1, 64)).astype(np.float32),
                 start + k * 16)
        pair.produce(16)
    assert pair.p._cursor_shift > 0


def test_functional_core_matches_reference():
    """ola_init / ola_add_frame / ola_produce / ola_flush against the
    reference's jitted functions, step by step, including a partial frame
    and a drain that wraps the ring (two spans)."""
    from crlot_tpu.ola.streaming import ola_add_frame as j_add
    from crlot_tpu.ola.streaming import ola_flush as j_flush

    jcfg = _cfg(frame_size=32, hop_size=8, channels=3, ring_margin_hops=1)
    cfg = ola_config_from_reference(jcfg)
    w = get_window(WindowType.HANN, 32, periodic=True)
    norm = ps.make_norm_ring(cfg, w)
    js, st = j_ola_init(jcfg), ps.ola_init(cfg, device=CPU)
    rng = np.random.default_rng(11)
    for k in range(12):
        fr = rng.standard_normal((3, 32)).astype(np.float32)
        off, size = (5, 20) if k == 4 else (0, None)
        js = j_add(js, jnp.asarray(fr), jnp.asarray(k * 8, jnp.int32),
                   jnp.asarray(w), jcfg, gain=0.3, start_off=off, size=size)
        st = ps.ola_add_frame(st, torch.from_numpy(fr), k * 8,
                              torch.tensor(w), cfg, gain=0.3,
                              start_off=off, size=size)
        js, jout, jc = j_ola_produce(js, jnp.asarray(norm), jcfg, 11)
        st, out, c = ps.ola_produce(st, torch.from_numpy(norm), cfg, 11)
        assert c == int(jc) and out.shape == (3, 11)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(st.ring.numpy(), np.asarray(js.ring))
        assert ps.ola_available(st, cfg) == int(j_ola_available(js, jcfg))
    js, st = j_flush(js), ps.ola_flush(st)
    js, jout, jc = j_ola_produce(js, jnp.asarray(norm), jcfg, cfg.ring_len)
    st, out, c = ps.ola_produce(st, torch.from_numpy(norm), cfg, cfg.ring_len)
    assert c == int(jc)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(st.ring.numpy(), np.asarray(js.ring))


def test_drain_is_one_normalize_call_a_span(monkeypatch):
    """A drain passes each ring span through normalize_and_clear once, as
    one contiguous [C, n] operand with the norm expanded over channels."""
    calls = []
    orig = pk.normalize_and_clear

    def spy(acc, norm, eps=1e-8, use_pallas=None):
        calls.append((tuple(acc.shape), acc.is_contiguous(),
                      norm.is_contiguous(), bool((norm == norm[0]).all())))
        return orig(acc, norm, eps, use_pallas)

    monkeypatch.setattr(pk, "normalize_and_clear", spy)
    cfg = pt.OLAConfig(sample_rate=48000, frame_size=32, hop_size=8,
                       channels=4, ring_margin_hops=3)  # ring of 56
    ola = pt.OLAAccumulator(cfg, device=CPU)
    ola.set_window(get_window(WindowType.HANN, 32, periodic=True))
    x = np.ones((4, 32), np.float32)
    for k in range(3):
        ola.add_frame_soa(x, k * 8)
    assert ola.produce(40).shape == (4, 24)  # [0, 24): one span
    assert calls == [((4, 24), True, True, True)]
    for k in range(3, 6):  # the last frame wraps: positions 40..55, 0..15
        ola.add_frame_soa(x, k * 8)
    ola.flush()
    calls.clear()
    assert ola.produce(56).shape == (4, 48)  # [24, 56) and [0, 16)
    assert [c[0] for c in calls] == [(4, 32), (4, 16)]


def test_accumulator_off_the_cpu_never_takes_the_plain_drain():
    """On a meta tensor the drain goes to the kernel wrapper, which raises
    for a non-CUDA tensor: no plain fallback off the CPU."""
    cfg = pt.OLAConfig(sample_rate=48000, frame_size=32, hop_size=8)
    ola = pt.OLAAccumulator(cfg, device="meta")
    ola.add_frame_soa(torch.ones((1, 32), device="meta"), 0)
    with pytest.raises(ValueError, match="CUDA"):
        ola.produce(8)


def test_accumulator_defaults_to_the_card():
    cfg = pt.OLAConfig(sample_rate=48000, frame_size=32, hop_size=8)
    if torch.cuda.is_available():
        assert pt.OLAAccumulator(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.OLAAccumulator(cfg)
