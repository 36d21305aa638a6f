"""The port's streaming round-trips vs its one-shot paths and the reference.

Mirrors `tests/test_streaming_pipeline.py`: the blocked chunk streamer
(`BlockedChunkStreamer`) against the port's one-shot
`blocked_composed_round_trip` (center=False), bit for bit for the identity
on the CPU; the scan form (`streaming_round_trip`, `process_wav_file`)
against the offline round-trip. Cross-package: the port's streamers on
the same numpy input as the reference's, interior within 2e-6 (ROADMAP
C4; measured bit-identical) and the edges within 1e-6 before their
division by the partial-coverage norm (the edge patches are products
summed in another order than XLA's; measured 1.2e-7 for the identity and
7.1e-7 for an EQ, a few ULP of values near 1).
"""

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu.core.types import FftBackend as JBackend
from crlot_tpu.core.types import FftPrecision as JPrecision
from crlot_tpu.core.types import StftConfig as JConfig
from crlot_tpu.fft import matmul_backend as jmm
from crlot_tpu.streaming_pipeline import BlockedChunkStreamer as JStreamer
from crlot_tpu.streaming_pipeline import streaming_round_trip as j_stream
from crlot_tpu_torch import spectral as S
from crlot_tpu_torch.core.types import FftBackend, FftPrecision, StftConfig
from crlot_tpu_torch.fft import matmul_backend as mm
from crlot_tpu_torch.pipeline import blocked_composed_round_trip
from crlot_tpu_torch.streaming_pipeline import (
    BlockedChunkStreamer,
    blocked_stream_supported,
    process_wav_file,
    streaming_round_trip,
    streaming_round_trip_blocks,
)

CPU = "cpu"


def _sig(n, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, n).astype(
        np.float32)


def _csig(c, t, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (c, t)).astype(
        np.float32)


def _snr(ref, got):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.sum(ref**2) / max(np.sum(err**2), 1e-300))


def _blocked_oneshot(x, cfg, fn=None):
    pb = (np.ones(cfg.frame_size // 2 + 1) if fn is None
          else S.resolve_per_bin_response(fn, cfg.frame_size))
    return blocked_composed_round_trip(torch.from_numpy(x), cfg, pb).numpy()


def _stream(cfg, x, s, fn=None):
    st = BlockedChunkStreamer(cfg, fn, device=CPU)
    k = x.shape[-1] // s
    outs = [st.feed(x[..., i * s : (i + 1) * s]) for i in range(k)]
    outs.append(st.finish())
    return np.concatenate([o for o in outs if o is not None], axis=-1)


def _mm_cfg(n, hop, **kw):
    return StftConfig(frame_size=n, hop_size=hop, center=False,
                      fft_backend=FftBackend.MATMUL, **kw)


def _j_mm_cfg(n, hop, **kw):
    return JConfig(frame_size=n, hop_size=hop, center=False,
                   fft_backend=JBackend.MATMUL, **kw)


# ---------------------------------------------------------------------------
# Blocked chunk streamer.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,hop", [(1024, 256), (1024, 512), (512, 128),
                                   (256, 64), (1024, 64), (2048, 256)])
def test_blocked_chunk_geometry_matches_reference(n, hop):
    assert mm.blocked_chunk_geometry(n, hop) == jmm.blocked_chunk_geometry(
        n, hop)


def test_blocked_chunk_geometry_matches_reference_everywhere():
    """Every (N, hop) the blocked gate accepts (even N <= 4096, hop | N)."""
    accepted = 0
    for n in range(2, mm.MAX_MATMUL_NFFT + 1, 2):
        for hop in range(1, n // 2 + 1):
            if n % hop:
                continue
            g = mm.blocked_group_for(n, hop)
            assert g == jmm.blocked_group_for(n, hop), (n, hop)
            if g is not None:
                accepted += 1
                assert mm.blocked_chunk_geometry(n, hop) == (
                    jmm.blocked_chunk_geometry(n, hop)), (n, hop)
    assert accepted > 100


def test_blocked_chunk_geometry_headline_values():
    assert mm.blocked_chunk_geometry(1024, 256) == {
        "group": 2, "gh": 512, "mg": 4, "left_ctx": 768, "right_ctx": 768,
        "edge": 768}


@pytest.mark.parametrize("n,hop,s,k", [
    (1024, 256, 8192, 4),   # headline config
    (1024, 256, 8192, 1),   # single-chunk stream (head+tail in one chunk)
    (512, 128, 4096, 3),
    (256, 64, 1280, 3),     # hop < 128
    (1024, 64, 4096, 3),
])
def test_blocked_streamer_identity_bitexact_vs_oneshot(n, hop, s, k):
    cfg = _mm_cfg(n, hop)
    assert blocked_stream_supported(cfg, s)
    x = _csig(2, k * s, seed=n + hop)
    np.testing.assert_array_equal(_stream(cfg, x, s), _blocked_oneshot(x, cfg))


def test_blocked_streamer_eq_response():
    """Fixed per-bin EQ: edges bit-exact vs the one-shot, the interior
    within 2e-6 (the reference's CPU bound for EQ, ROADMAP C4)."""
    cfg = _mm_cfg(1024, 256)
    eq = S.band_gain([3000.0], [1.0, 0.4], 48000, 1024)
    s, k = 8192, 3
    x = _csig(2, k * s, seed=7)
    y = _stream(cfg, x, s, eq)
    y1 = _blocked_oneshot(x, cfg, eq)
    edge = cfg.frame_size - cfg.hop_size
    np.testing.assert_array_equal(y[:, :edge], y1[:, :edge])
    np.testing.assert_array_equal(y[:, -edge:], y1[:, -edge:])
    np.testing.assert_allclose(y, y1, rtol=0, atol=2e-6)


def test_blocked_streamer_synthesis_window_nonfold():
    cfg = _mm_cfg(512, 128, synthesis_window=True)
    s, k = 4096, 3
    assert blocked_stream_supported(cfg, s)
    x = _csig(2, k * s, seed=9)
    y = _stream(cfg, x, s)
    y1 = _blocked_oneshot(x, cfg)
    edge = cfg.frame_size - cfg.hop_size
    np.testing.assert_array_equal(y[:, :edge], y1[:, :edge])
    np.testing.assert_array_equal(y[:, -edge:], y1[:, -edge:])
    np.testing.assert_allclose(y, y1, rtol=0, atol=2e-6)
    assert _snr(x[:, edge:-edge], y[:, edge:-edge]) > 60.0


def test_blocked_streamer_ckpt_resume_bitexact(tmp_path):
    """A mid-stream checkpoint through an npz file resumes bit for bit."""
    cfg = _mm_cfg(1024, 256)
    s, k = 8192, 4
    x = _csig(2, k * s, seed=11)
    full = _stream(cfg, x, s)
    st = BlockedChunkStreamer(cfg, device=CPU)
    outs = [st.feed(x[:, i * s : (i + 1) * s]) for i in range(2)]
    state = st.state()
    assert all(isinstance(state[k], np.ndarray) for k in ("prev", "lctx"))
    path = tmp_path / "ckpt.npz"
    np.savez(path, prev=state["prev"], lctx=state["lctx"],
             first=state["first"], s=state["s"])
    with np.load(path) as z:
        restored = {"prev": z["prev"], "lctx": z["lctx"],
                    "first": bool(z["first"]), "s": int(z["s"])}
    st2 = BlockedChunkStreamer(cfg, device=CPU)
    st2.load_state(restored)
    outs += [st2.feed(x[:, i * s : (i + 1) * s]) for i in range(2, k)]
    outs.append(st2.finish())
    resumed = np.concatenate([o for o in outs if o is not None], axis=1)
    np.testing.assert_array_equal(resumed, full)


def test_blocked_streamer_feed_keeps_device_tensors():
    """force=False returns the tensor on the stream's device (the prefetch
    hook); tensor chunks stay where they are."""
    cfg = _mm_cfg(1024, 256)
    x = torch.from_numpy(_csig(1, 3 * 8192, seed=5))
    st = BlockedChunkStreamer(cfg)
    assert st.feed(x[:, :8192], force=False) is None
    out = st.feed(x[:, 8192:16384], force=False)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert isinstance(st.finish(), np.ndarray)


def test_blocked_streamer_validation():
    cfg = _mm_cfg(1024, 256)
    with pytest.raises(ValueError, match="center"):
        BlockedChunkStreamer(StftConfig(frame_size=1024, hop_size=256,
                                        center=True))
    st = BlockedChunkStreamer(cfg, device=CPU)
    with pytest.raises(ValueError, match="multiple of G\\*hop"):
        st.feed(np.zeros((1, 1000), np.float32))
    st.feed(np.zeros((1, 8192), np.float32))
    with pytest.raises(ValueError, match="changed"):
        st.feed(np.zeros((1, 4096), np.float32))
    st.finish()
    with pytest.raises(RuntimeError, match="finish"):
        st.feed(np.zeros((1, 8192), np.float32))
    # nonlinear spectral fns are not per-bin: unsupported
    assert not blocked_stream_supported(cfg, 8192, lambda spec: spec ** 2)
    assert not blocked_stream_supported(
        StftConfig(1024, 256, fft_backend=FftBackend.XLA))
    with pytest.raises(ValueError, match="not supported"):
        BlockedChunkStreamer(cfg, lambda spec: spec ** 2)


def test_blocked_group_for_gate():
    assert mm.blocked_group_for(1024, 256) == 2
    assert mm.blocked_group_for(1024, 512) == 2
    assert mm.blocked_group_for(256, 64) == 2
    assert mm.blocked_group_for(1024, 64) == 2
    assert mm.composed_block_supported(256, 64)
    assert not mm.composed_block_supported(1024, 192)
    assert not mm.composed_block_supported(1000, 250)
    assert not mm.composed_block_supported(1024, 1024)
    assert not mm.composed_block_supported(8192, 512)


@pytest.mark.parametrize("fn_name", ["identity", "eq"])
def test_blocked_streamer_vs_reference(fn_name):
    """The port's and the reference's streamers on the same numpy chunks:
    interior within 2e-6, edges within 1e-6 before the edge-norm divide."""
    from crlot_tpu import spectral as jsp

    cfg, jcfg = _mm_cfg(1024, 256), _j_mm_cfg(1024, 256)
    fn = jfn = None
    if fn_name == "eq":
        fn = S.band_gain([3000.0], [1.0, 0.4], 48000, 1024)
        jfn = jsp.band_gain([3000.0], [1.0, 0.4], 48000, 1024)
    s, k = 8192, 3
    x = _csig(2, k * s, seed=13)
    y = _stream(cfg, x, s, fn)
    jst = JStreamer(jcfg, jfn)
    outs = [jst.feed(x[:, i * s : (i + 1) * s]) for i in range(k)]
    outs.append(jst.finish())
    want = np.concatenate([o for o in outs if o is not None], axis=1)
    edge = 768
    assert np.max(np.abs(y - want)[:, edge:-edge]) <= 2e-6
    # The edges divide by the partial-coverage norm (down to eps at the
    # first sample): compare them before that division.
    plan = mm.blocked_plan_for(cfg, mm.blocked_response(cfg, fn))
    head = np.abs(y[:, :edge] - want[:, :edge]) * plan.head_norm
    tail = np.abs(y[:, -edge:] - want[:, -edge:]) * plan.tail_norm
    assert max(head.max(), tail.max()) <= 1e-6


# ---------------------------------------------------------------------------
# Scan form.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,hop,bf", [(256, 64, 16), (1024, 256, 8),
                                      (256, 128, 32)])
def test_streaming_matches_offline_interior(n, hop, bf):
    cfg = StftConfig(frame_size=n, hop_size=hop, center=False)
    x = _sig(hop * bf * 6 + n)
    got, valid_from = streaming_round_trip(x, cfg, block_frames=bf,
                                           device=CPU)
    want = pt.round_trip(x, cfg, device=CPU).numpy()
    lo, hi = max(valid_from, n), len(got) - n
    assert _snr(want[lo:hi], got[lo:hi]) > 120.0
    assert _snr(x[lo:hi], got[lo:hi]) > 80.0


def test_streaming_block_boundaries_bitexact():
    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    x = _sig(64 * 96 + 256, seed=1)
    a, _ = streaming_round_trip(x, cfg, block_frames=8, device=CPU)
    b, _ = streaming_round_trip(x, cfg, block_frames=32, device=CPU)
    m = min(len(a), len(b))
    np.testing.assert_array_equal(a[:m], b[:m])


def test_streaming_carry_chains_calls_bitexact():
    """Two calls chained by the carried tail equal one call."""
    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    x = torch.from_numpy(_sig(64 * 64 + 192, seed=4))
    frames = x.unfold(-1, 256, 64)[:64].reshape(8, 8, 256)
    one = streaming_round_trip_blocks(frames, cfg, 8)
    a, tail = streaming_round_trip_blocks(frames[:3], cfg, 8,
                                          return_carry=True)
    b = streaming_round_trip_blocks(frames[3:], cfg, 8, carry_tail=tail)
    assert torch.equal(torch.cat([a, b]), one)


def test_streaming_too_short_raises():
    cfg = StftConfig(frame_size=256, hop_size=64, center=False)
    with pytest.raises(ValueError, match="too short"):
        streaming_round_trip(_sig(100), cfg, block_frames=8, device=CPU)


def test_streaming_center_rejected():
    cfg = StftConfig(frame_size=256, hop_size=64, center=True)
    with pytest.raises(ValueError):
        streaming_round_trip(_sig(10000), cfg, device=CPU)


def test_streaming_matmul_backend_packed_path():
    """MATMUL takes the folded packed parts inside the scan: within the
    matmul-DFT tolerance of the torch.fft route, and block-size invariant
    to 2e-6 (the GEMM's order may vary with the batch on the CPU)."""
    cfg = StftConfig(frame_size=512, hop_size=128, center=False,
                     fft_backend=FftBackend.MATMUL,
                     fft_precision=FftPrecision.HIGHEST)
    cfg_fft = StftConfig(frame_size=512, hop_size=128, center=False,
                         fft_backend=FftBackend.XLA)
    x = _sig(128 * 128 + 512, seed=2)
    a, v = streaming_round_trip(x, cfg, block_frames=16, device=CPU)
    b, _ = streaming_round_trip(x, cfg_fft, block_frames=16, device=CPU)
    m = min(len(a), len(b))
    np.testing.assert_allclose(a[v:m], b[v:m], atol=1e-4)
    c, _ = streaming_round_trip(x, cfg, block_frames=64, device=CPU)
    m = min(len(a), len(c))
    np.testing.assert_allclose(a[:m], c[:m], atol=2e-6)


def test_streaming_spectral_fn_matches_offline():
    """All three routes: composed (EQ on MATMUL), packed (gate on MATMUL),
    complex (the torch.fft route), against the offline round_trip."""
    n, hop, bf = 512, 128, 16
    x = _sig(hop * bf * 6 + n, seed=3)
    cfg_mm = StftConfig(frame_size=n, hop_size=hop, center=False,
                        fft_backend=FftBackend.MATMUL,
                        fft_precision=FftPrecision.HIGHEST)
    cfg_fft = StftConfig(frame_size=n, hop_size=hop, center=False)
    eq = S.band_gain([4000.0, 12000.0], [1.0, 0.4, 0.1], 48000, n)
    gate = S.noise_gate(-40.0)
    for cfg, fn in [(cfg_mm, eq), (cfg_mm, gate), (cfg_fft, eq),
                    (cfg_fft, lambda s: s * 0.5)]:
        got, valid_from = streaming_round_trip(x, cfg, block_frames=bf,
                                               spectral_fn=fn, device=CPU)
        want = pt.round_trip(x, cfg, fn, device=CPU).numpy()
        lo, hi = max(valid_from, n), len(got) - n
        assert _snr(want[lo:hi], got[lo:hi]) > 90.0, (cfg.fft_backend, fn)


@pytest.mark.parametrize("backend", ["fft", "matmul"])
def test_streaming_vs_reference(backend):
    """The port's scan vs the reference's on the same input: the interior
    within 2e-6 (the same routes: rfft/irfft, or the composed product)."""
    n, hop, bf = 512, 128, 16
    x = _sig(hop * bf * 6 + n, seed=6)
    from crlot_tpu import spectral as jsp

    if backend == "fft":
        cfg = StftConfig(frame_size=n, hop_size=hop, center=False)
        jcfg = JConfig(frame_size=n, hop_size=hop, center=False)
        fn, jfn = None, None
    else:
        cfg = StftConfig(frame_size=n, hop_size=hop, center=False,
                         fft_backend=FftBackend.MATMUL)
        jcfg = JConfig(frame_size=n, hop_size=hop, center=False,
                       fft_backend=JBackend.MATMUL,
                       fft_precision=JPrecision.HIGHEST)
        fn = S.band_gain([4000.0], [1.0, 0.5], 48000, n)
        jfn = jsp.band_gain([4000.0], [1.0, 0.5], 48000, n)
    got, v = streaming_round_trip(x, cfg, block_frames=bf, spectral_fn=fn,
                                  device=CPU)
    want, jv = j_stream(x, jcfg, block_frames=bf, spectral_fn=jfn)
    assert v == jv and got.shape == want.shape
    assert np.max(np.abs(got[v:] - np.asarray(want)[v:])) <= 2e-6


def test_process_wav_file_matches_unbroken_stream(tmp_path):
    """File-to-file chunked processing equals one unbroken stream: stereo,
    EQ, a zero-padded tail, 32-bit output (quantization 2^-31)."""
    rng = np.random.default_rng(9)
    sr, total = 48000, 50321  # deliberately not chunk-aligned
    x = rng.uniform(-0.8, 0.8, (2, total)).astype(np.float32)
    infile, outfile = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    pt.write_wav(infile, x, sr, bits=32, float_format=True)
    cfg = StftConfig(frame_size=512, hop_size=128, center=False)
    eq = S.band_gain([4000.0], [1.0, 0.5], sr, 512)
    n_written = process_wav_file(infile, outfile, cfg, spectral_fn=eq,
                                 block_frames=16, blocks_per_chunk=4, bits=32,
                                 device=CPU)
    assert n_written == total
    y, _ = pt.read_wav(outfile)
    assert y.shape == (2, total)
    n, hop = 512, 128
    chunk = 16 * 4 * hop
    span_frames = -(-total // chunk) * (chunk // hop)
    need = (span_frames - 1) * hop + n
    xp = np.pad(x, [(0, 0), (0, need - total)])
    for c in range(2):
        want, _ = streaming_round_trip(xp[c], cfg, block_frames=16,
                                       spectral_fn=eq, device=CPU)
        np.testing.assert_allclose(y[c], want[:total], atol=2e-6)


def test_wav_stream_reader_and_writer_match_reference(tmp_path):
    """`WavStreamReader` decodes the same chunks as the reference's, and
    `WavWriter` writes the same bytes."""
    from crlot_tpu.io.wav import WavStreamReader as JReader
    from crlot_tpu.io.wav import WavWriter as JWriter

    x = np.random.default_rng(1).uniform(-0.9, 0.9, (2, 5000)).astype(
        np.float32)
    for bits in (16, 24, 32):
        a, b = tmp_path / f"a{bits}.wav", tmp_path / f"b{bits}.wav"
        with pt.io.wav.WavWriter(str(a), 2, 44100, bits=bits) as w:
            w.write(x[:, :3000])
            w.write(x[:, 3000:])
        with JWriter(str(b), 2, 44100, bits=bits) as w:
            w.write(x)
        assert a.read_bytes() == b.read_bytes()
        r, jr = pt.io.wav.WavStreamReader(str(a)), JReader(str(a))
        assert (r.channels, r.sample_rate, r.num_frames) == (2, 44100, 5000)
        for _ in range(3):
            np.testing.assert_array_equal(r.read_chunk(2048),
                                          jr.read_chunk(2048))
        r.seek(10)
        whole = pt.io.wav.WavReader(str(a))
        np.testing.assert_array_equal(r.read_chunk(5), whole.read(10, 5))
