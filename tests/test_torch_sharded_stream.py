"""The port's sharded streamer (BASELINE config 5's path) on CPU meshes.

Mirrors `tests/test_sharded_stream.py` (its five tests) at sizes that run
in the fast lane, on meshes of up to 8 shards that list the CPU device.

* Chunked vs the port's own one-shot `sharded_round_trip` of the whole
  stream: bit-exact (`torch.equal`) wherever `tests/test_torch_distributed.py`
  holds N shards == 1 shard bit-exact -- the masked frame formulation on
  `torch.fft` and the seeded OLA, and the blocked identity -- and under that
  file's bounds where a route runs `torch.matmul` on the CPU: the blocked EQ
  rtol 3e-6 / atol 1e-6 with the edges exact, the B3 route rtol 2e-4 /
  atol 1e-4. (On the card every one of these is bit-exact: `chip_smoke.py`
  phase 27.)
* The port against the reference's `sharded_stream` / `sharded_stream_iter`
  on the same input: interior within 2e-6 and the edges within 1e-6 before
  their division by the partial-coverage norm, as
  `tests/test_torch_streaming.py` states (ROADMAP C4).
* A reference `ShardedStreamer.state()` loaded into the port resumes it
  (bit-exact against the port's unbroken run), and the reverse.
"""

import numpy as np
import pytest
import torch

from crlot_tpu import spectral as JS
from crlot_tpu.core.types import StftConfig as JConfig
from crlot_tpu.distributed.mesh import make_mesh as j_make_mesh
from crlot_tpu.distributed.stream import ShardedStreamer as JStreamer
from crlot_tpu.distributed.stream import sharded_stream as j_stream
from crlot_tpu.distributed.stream import sharded_stream_iter as j_stream_iter

import crlot_tpu_torch as pt
from crlot_tpu_torch import spectral as S
from crlot_tpu_torch.convert import config_from_reference
from crlot_tpu_torch.core.types import FftBackend, StftConfig
from crlot_tpu_torch.distributed import stream as pst
from crlot_tpu_torch.fft import matmul_backend as mb
from crlot_tpu_torch.pipeline import _norm_np

CPU = torch.device("cpu")
CFG = StftConfig(frame_size=256, hop_size=64, center=False)
JCFG = JConfig(frame_size=256, hop_size=64, center=False)
S16 = 4 * 64 * 16  # a chunk of 16 hops per shard on a 4-long time axis


def _mesh(channel, time):
    return pt.make_mesh(channel, time, devices=[CPU] * (channel * time))


def _sig(c, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, (c, t)).astype(np.float32)


def _oneshot(x, cfg, mesh, fn=None, **kw):
    return pt.sharded_round_trip(x, cfg, mesh, fn, device="cpu", **kw).numpy()


def _stream(x, s, cfg, mesh, fn=None, **kw):
    st = pt.ShardedStreamer(cfg, mesh, fn, device="cpu", **kw)
    outs = [st.feed(x[:, i : i + s]) for i in range(0, x.shape[1], s)]
    outs.append(st.finish())
    return np.concatenate([o for o in outs if o is not None], axis=1), st


def _eq():
    edges, gains = [2000.0, 9000.0], [0.5, 1.0, 0.25]
    return (S.band_gain(edges, gains, 48000, CFG.frame_size),
            JS.band_gain(edges, gains, 48000, CFG.frame_size))


def _vs_reference(got, want, cfg):
    """Interior within 2e-6; the edges within 1e-6 once multiplied back by
    their partial-coverage norm (C4)."""
    n, hop = cfg.frame_size, cfg.hop_size
    total = got.shape[1]
    nf = (total - n) // hop + 1
    norm = np.maximum(_norm_np(cfg, nf, total), cfg.eps)
    err = np.abs(got - want)
    assert err[:, n:-n].max() <= 2e-6
    assert (err[:, :n] * norm[:n]).max() <= 1e-6
    assert (err[:, -n:] * norm[-n:]).max() <= 1e-6


# --- the reference's five tests ---


def test_chunked_stream_matches_oneshot_bitexact():
    mesh = _mesh(2, 4)
    x = _sig(2, 4 * 64 * 96)
    want = _oneshot(x, CFG, mesh, allow_blocked=False)
    got = pt.sharded_stream(x, CFG, mesh, chunk_samples=S16, device="cpu")
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)


def test_chunked_stream_odd_total_length():
    mesh = _mesh(1, 4)
    x = _sig(2, 4 * 64 * 37 + 4 * 64 * 7, seed=1)
    want = _oneshot(x, CFG, mesh, allow_blocked=False)
    got = pt.sharded_stream(torch.from_numpy(x), CFG, mesh, chunk_samples=S16)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", [FftBackend.XLA, FftBackend.AUTO])
def test_stream_iter_matches_the_array_form(backend):
    """With the library FFT (the reference CPU's route) the iterator and
    the array form run the same masked frames: bit for bit. With AUTO
    the iterator takes the blocked formulation, and matches the blocked
    one-shot bit for bit (the identity)."""
    cfg = StftConfig(frame_size=256, hop_size=64, center=False,
                     fft_backend=backend)
    mesh = _mesh(1, 4)
    x = _sig(2, S16 * 5, seed=2)
    chunks = [x[:, i * S16 : (i + 1) * S16] for i in range(5)]
    got = np.concatenate(list(pt.sharded_stream_iter(
        iter(chunks), cfg, mesh, device="cpu")), axis=1)
    assert got.shape == x.shape
    if backend == FftBackend.XLA:
        want = pt.sharded_stream(x, cfg, mesh, chunk_samples=S16,
                                 device="cpu")
    else:
        want = _oneshot(x, cfg, mesh)
    np.testing.assert_array_equal(got, want)


def test_64_channel_fir_sharded():
    """BASELINE config 4: 64 channels sharded over channels, per-channel
    round-trip with an FIR response, against scipy's lfilter."""
    from scipy import signal as sps

    mesh = _mesh(8, 1)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)
    x = _sig(64, 16384, seed=3)
    taps = sps.firwin(63, 0.3)
    h = S.fir_frequency_response(taps, 1024)
    y = _oneshot(x, cfg, mesh, S.per_bin_filter(h))
    assert y.shape == x.shape
    want = sps.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    covered = (cfg.frame_spec.num_frames(16384) - 1) * 256 + 1024
    lo, hi = 2048, covered - 2048
    assert pt.snr_db(want[:, lo:hi], y[:, lo:hi]) > 40


def test_stream_validation():
    mesh = _mesh(2, 4)
    with pytest.raises(ValueError):
        pt.sharded_stream(_sig(3, 4 * 64 * 32), CFG, mesh, device="cpu")
    with pytest.raises(ValueError):
        next(pt.sharded_stream_iter(iter([_sig(2, 100)]), CFG, mesh,
                                    device="cpu"))
    st = pt.ShardedStreamer(CFG, mesh, device="cpu")
    st.feed(_sig(2, S16))
    with pytest.raises(ValueError, match="changed"):
        st.feed(_sig(2, 2 * S16))


# --- the streamer against its one-shot, and its modes ---


@pytest.mark.parametrize("channel,time", [(1, 1), (2, 2), (1, 4)])
def test_streamer_blocked_identity_bitexact(channel, time):
    mesh = _mesh(channel, time)
    x = _sig(2, S16 * 4, seed=4)
    got, st = _stream(x, S16, CFG, mesh)
    assert st.blocked
    np.testing.assert_array_equal(got, _oneshot(x, CFG, mesh))


@pytest.mark.parametrize("channel,time", [(1, 1), (2, 2)])
def test_streamer_blocked_eq_within_the_blocked_bound(channel, time):
    eq, _ = _eq()
    mesh = _mesh(channel, time)
    x = _sig(2, S16 * 4, seed=5)
    got, st = _stream(x, S16, CFG, mesh, eq)
    assert st.blocked
    want = _oneshot(x, CFG, mesh, eq)
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=1e-6)
    edge = CFG.frame_size - CFG.hop_size
    np.testing.assert_array_equal(got[:, :edge], want[:, :edge])
    np.testing.assert_array_equal(got[:, -edge:], want[:, -edge:])


def test_streamer_masked_modes():
    """The masked formulation: with the library FFT bit for bit; the
    noise gate on a matmul config (B3's route) within the B3 bound; and
    allow_blocked=False keeps the identity masked."""
    mesh = _mesh(2, 2)
    x = _sig(2, S16 * 4, seed=6)
    gate = S.noise_gate(-40.0, attenuation_db=-80.0)
    xla = StftConfig(frame_size=256, hop_size=64, center=False,
                     fft_backend=FftBackend.XLA)
    got, st = _stream(x, S16, xla, mesh, gate)
    assert not st.blocked
    np.testing.assert_array_equal(got, _oneshot(x, xla, mesh, gate))
    got, st = _stream(x, S16, CFG, mesh, gate)
    assert not st.blocked
    want = _oneshot(x, CFG, mesh, gate)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    got, st = _stream(x, S16, xla, mesh, allow_blocked=False)
    assert not st.blocked
    np.testing.assert_array_equal(
        got, _oneshot(x, xla, mesh, allow_blocked=False))


def test_blocked_mode_gate():
    mesh = _mesh(1, 4)
    assert pst._blocked_stream_mode(CFG, mesh, None, S16) is (
        mb.blocked_plan_for(CFG, mb.blocked_response(CFG, None)))
    gate = S.noise_gate(-40.0)
    assert pst._blocked_stream_mode(CFG, mesh, gate, S16) is None
    xla = StftConfig(frame_size=256, hop_size=64, fft_backend=FftBackend.XLA)
    assert pst._blocked_stream_mode(xla, mesh, None, S16) is None
    # Too short for the head and tail patches not to overlap: masked.
    assert pst._blocked_stream_mode(CFG, _mesh(1, 1), None, 512) is None
    assert pst._ctx_len(CFG, 4) == 256 and pst._ctx_len(CFG, 3) == 384


def test_feed_after_finish_raises_and_load_state_resumes():
    mesh = _mesh(1, 2)
    st = pt.ShardedStreamer(CFG, mesh, device="cpu")
    x = _sig(1, 4 * S16, seed=7)
    st.feed(x[:, :S16])
    st.feed(x[:, S16 : 2 * S16])
    saved = st.state()
    st.finish()
    with pytest.raises(RuntimeError, match="after finish"):
        st.feed(x[:, 2 * S16 : 3 * S16])
    st.load_state(saved)
    assert st.feed(x[:, 2 * S16 : 3 * S16]).shape == (1, S16)


def test_force_false_returns_device_tensors():
    mesh = _mesh(1, 1)
    x = torch.from_numpy(_sig(2, 3 * S16, seed=8))
    st = pt.ShardedStreamer(CFG, mesh, device="cpu")
    outs = [st.feed(c, force=False) for c in x.split(S16, dim=1)]
    outs.append(st.finish(force=False))
    assert outs[0] is None
    assert all(isinstance(o, torch.Tensor) for o in outs[1:])
    got = torch.cat(outs[1:], dim=1)
    assert torch.equal(got, torch.from_numpy(_oneshot(x.numpy(), CFG, mesh)))


def test_streamer_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        pt.ShardedStreamer(CFG)  # auto_mesh() without a card
    st = pt.ShardedStreamer(CFG, _mesh(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.feed(_sig(1, S16))  # numpy goes to the card by default


# --- against the reference ---


def test_sharded_stream_matches_reference():
    x = _sig(2, 4 * 64 * 48, seed=9)
    want = j_stream(x, JCFG, j_make_mesh(channel=2, time=4),
                    chunk_samples=S16)
    got = pt.sharded_stream(x, config_from_reference(JCFG), _mesh(2, 4),
                            chunk_samples=S16, device="cpu")
    _vs_reference(got, np.asarray(want), CFG)


@pytest.mark.parametrize("eq", [False, True])
def test_streamer_matches_reference_iter(eq):
    """The port's streamer (blocked on its matmul config) against the
    reference's iterator (its CPU runs the masked frames)."""
    fn, jfn = _eq() if eq else (None, None)
    x = _sig(2, S16 * 4, seed=10)
    chunks = [x[:, i * S16 : (i + 1) * S16] for i in range(4)]
    want = np.concatenate(list(j_stream_iter(
        iter(chunks), JCFG, j_make_mesh(channel=1, time=4), jfn)), axis=1)
    got, st = _stream(x, S16, CFG, _mesh(1, 4), fn)
    assert st.blocked
    _vs_reference(got, want, CFG)


def test_reference_state_resumes_in_the_port_and_back():
    x = _sig(2, S16 * 5, seed=11)
    chunks = [x[:, i * S16 : (i + 1) * S16] for i in range(5)]
    port_all, _ = _stream(x, S16, CFG, _mesh(1, 4))
    # The reference streams two chunks, then the port resumes its state.
    jst = JStreamer(JCFG, j_make_mesh(channel=1, time=4))
    ref_out = [jst.feed(c) for c in chunks[:2]]
    state = jst.state()
    assert set(state) == {"prev", "tail", "first", "s"}
    st = pt.ShardedStreamer(CFG, _mesh(1, 4), device="cpu")
    st.load_state(state)
    rest = [st.feed(c) for c in chunks[2:]] + [st.finish()]
    got = np.concatenate(rest, axis=1)
    np.testing.assert_array_equal(got, port_all[:, S16:])
    head = np.concatenate([o for o in ref_out if o is not None], axis=1)
    _vs_reference(np.concatenate([head, got], axis=1), port_all, CFG)
    # And the port's state resumes in the reference.
    st2 = pt.ShardedStreamer(CFG, _mesh(1, 4), device="cpu")
    for c in chunks[:3]:
        st2.feed(c)
    jst2 = JStreamer(JCFG, j_make_mesh(channel=1, time=4))
    jst2.load_state(st2.state())
    tail = np.concatenate([np.asarray(jst2.feed(c)) for c in chunks[3:]]
                          + [np.asarray(jst2.finish())], axis=1)
    want = np.concatenate(list(j_stream_iter(
        iter(chunks), JCFG, j_make_mesh(channel=1, time=4))), axis=1)
    np.testing.assert_array_equal(tail, want[:, 2 * S16:])


# --- the edge patch's product on the card (C15) ---


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_edge_patch_product_runs_a_fixed_order_kernel_on_the_card(
        monkeypatch, precision):
    """With fixed_order (the sharded route and the streamer) the edge
    patch's product on a non-CPU tensor launches B0 (HIGH) or B0's fp32
    kernel (HIGHEST), one launch for all channels, reading the region's
    frames in place: fixed-order kernels, so a channel-sharded mesh
    patches its edges with the bits of one shard (C15). Without it, a
    `torch.matmul`. Meta tensors with a recorded launch stand in for the
    card."""
    import ctypes

    from crlot_tpu_torch import cuda_build
    from crlot_tpu_torch.fft import fp32_window
    from crlot_tpu_torch.fft.tf32x3 import MODE_TF32X3

    calls = []

    def launch(name, device, *args):
        calls.append((name, args[0] if name == "crlot_b6_gemm" else None,
                      args))

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    n, hop = 1024, 256
    w = np.ascontiguousarray(pt.get_window(CFG.window, n, True,
                                           dtype=np.float64)).tobytes()
    rb = np.ascontiguousarray(np.ones(n // 2 + 1), np.complex128).tobytes()
    prec = pt.FftPrecision(precision)
    region = torch.empty((128, mb.blocked_patch_span(n, hop)), device="meta")
    p = mb.blocked_edge_patch(region, n, hop, w, None, rb, "tail", prec,
                              fixed_order=True)
    assert tuple(p.shape) == (128, n - hop)
    want = (("crlot_b6_gemm", MODE_TF32X3) if precision == "high"
            else ("crlot_fp32_window", None))
    assert [c[:2] for c in calls] == [want]
    if precision == "highest":
        # lda = hop: the three frames read in place as windows of the region
        assert calls[0][2][1] == hop
        assert fp32_window.launches >= 1
    calls.clear()  # one channel count (the one-device paths): torch.matmul
    mb.blocked_edge_patch(region, n, hop, w, None, rb, "head", prec)
    assert calls == []
