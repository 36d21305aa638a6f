"""Stream-state checkpoints: a resumed stream produces identical output, and
a checkpoint file crosses between the packages in both directions.

Mirrors `tests/test_checkpoint.py` (its two tests) on the port, then
writes a file with `crlot_tpu.checkpoint` and resumes it in the port, and
the reverse. The file's keys, dtypes and `meta` are the reference's, and
every output after a resume equals the unbroken run's bit for bit
(`assert_array_equal`, no tolerance).
"""

import jax.numpy as jnp
import numpy as np
import torch

from crlot_tpu.checkpoint import load_stream_state as j_load
from crlot_tpu.checkpoint import save_stream_state as j_save
from crlot_tpu.core.types import OLAConfig as JOLAConfig
from crlot_tpu.ola.streaming import OLAAccumulator as JAccumulator
from crlot_tpu.ola.streaming import OLAStreamState as JState

import crlot_tpu_torch as pt
from crlot_tpu_torch.checkpoint import load_stream_state, save_stream_state
from crlot_tpu_torch.convert import (
    ola_config_from_reference,
    stream_state_from_reference,
    stream_state_to_reference,
)
from crlot_tpu_torch.core.types import OLAConfig, WindowType
from crlot_tpu_torch.ola.streaming import ola_init
from crlot_tpu_torch.window.windows import get_window

CPU = "cpu"


def _feed(ola, frames, ks, hop):
    out = []
    for k in ks:
        ola.add_frame_soa(frames[k], k * hop)
        avail = ola.available()
        if avail:
            out.append(np.asarray(ola.produce(avail)))
    return out


def _drain(ola, out):
    ola.flush()
    out.append(np.asarray(ola.produce(ola.cfg.ring_len)))
    return np.concatenate(out, axis=1)


def _run(frames, cfg, w, ckpt_path=None, at=10):
    """The unbroken port run, checkpointing before frame `at`."""
    ola = pt.OLAAccumulator(cfg, device=CPU)
    ola.set_window(w)
    out = _feed(ola, frames, range(at), cfg.hop_size)
    if ckpt_path is not None:
        save_stream_state(ckpt_path, ola.state, cfg, at,
                          extra={"note": "mid-stream"})
    out += _feed(ola, frames, range(at, frames.shape[0]), cfg.hop_size)
    return _drain(ola, out)


def _inputs(channels=1):
    cfg = OLAConfig(sample_rate=48000, frame_size=64, hop_size=16,
                    channels=channels)
    w = get_window(WindowType.HANN, 64, periodic=True)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((30, channels, 64)).astype(np.float32)
    return cfg, w, frames


def _resume_port(path, frames, w):
    state, cfg, frame_index, extra = load_stream_state(path, device=CPU)
    assert extra["note"] == "mid-stream"
    ola = pt.OLAAccumulator(cfg, device=CPU)
    ola.set_window(w)
    ola.load_state(state)
    out = _feed(ola, frames, range(frame_index, frames.shape[0]),
                cfg.hop_size)
    return _drain(ola, out)


def _tail(want, got):
    np.testing.assert_array_equal(got, want[:, want.shape[1] - got.shape[1]:])


def test_resume_produces_identical_output(tmp_path):
    cfg, w, frames = _inputs()
    ckpt = str(tmp_path / "stream.ckpt")
    want = _run(frames, cfg, w, ckpt_path=ckpt)
    _tail(want, _resume_port(ckpt, frames, w))


def test_checkpoint_roundtrip_fields(tmp_path):
    cfg = OLAConfig(sample_rate=44100, frame_size=32, hop_size=8, channels=2)
    state = ola_init(cfg, device=CPU)
    p = str(tmp_path / "s.ckpt")
    save_stream_state(p, state, cfg, 0)
    s2, cfg2, fi, extra = load_stream_state(p, device=CPU)
    assert cfg2 == cfg and fi == 0 and extra == {}
    assert torch.equal(s2.ring, state.ring)
    assert s2.read_pos == 0 and s2.flushed is False
    with np.load(p) as z:  # the reference's keys and dtypes
        assert sorted(z.files) == ["flushed", "meta", "produced", "read_pos",
                                   "ring"]
        assert z["ring"].dtype == np.float32
        assert z["ring"].shape == (2, cfg.ring_len)
        assert z["read_pos"].dtype == np.int32 == z["produced"].dtype
        assert z["flushed"].dtype == np.bool_


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """A file the reference writes mid-stream resumes in the port, whose
    output then equals the reference's unbroken run bit for bit."""
    cfg, w, frames = _inputs(channels=2)
    jcfg = JOLAConfig(sample_rate=48000, frame_size=64, hop_size=16,
                      channels=2)
    ckpt = str(tmp_path / "ref.ckpt")
    j = JAccumulator(jcfg)
    j.set_window(w)
    out = _feed(j, frames, range(10), 16)
    j_save(ckpt, j._state, jcfg, 10, extra={"note": "mid-stream"})
    out += _feed(j, frames, range(10, 30), 16)
    want = _drain(j, out)
    got = _resume_port(ckpt, frames, w)
    _tail(want, got)
    assert ola_config_from_reference(jcfg) == cfg


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    """A file the port writes mid-stream resumes in the reference, whose
    output then equals the port's unbroken run bit for bit."""
    cfg, w, frames = _inputs(channels=2)
    ckpt = str(tmp_path / "port.ckpt")
    want = _run(frames, cfg, w, ckpt_path=ckpt)
    state, jcfg, frame_index, extra = j_load(ckpt)
    assert extra == {"note": "mid-stream"} and frame_index == 10
    j = JAccumulator(jcfg)
    j.set_window(w)
    j._state = state
    got = _drain(j, _feed(j, frames, range(10, 30), 16))
    _tail(want, got)


def test_state_converts_both_ways():
    """convert's state pair: the reference's OLAStreamState to the port's
    and back, values and dtypes kept."""
    jcfg = JOLAConfig(sample_rate=48000, frame_size=32, hop_size=8,
                      channels=2)
    j = JAccumulator(jcfg)
    j.set_window(get_window(WindowType.HANN, 32, periodic=True))
    rng = np.random.default_rng(5)
    for k in range(6):
        j.add_frame_soa(rng.standard_normal((2, 32)).astype(np.float32), 8 * k)
    j.produce(20)
    st = stream_state_from_reference(j._state, device=CPU)
    np.testing.assert_array_equal(st.ring.numpy(), np.asarray(j._state.ring))
    assert (st.read_pos, st.produced, st.flushed) == (20, 72, False)
    back = stream_state_to_reference(st)
    assert back["read_pos"].dtype == np.int32
    rebuilt = JState(**{k: jnp.asarray(v) for k, v in back.items()})
    for a, b in zip(rebuilt, j._state):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
