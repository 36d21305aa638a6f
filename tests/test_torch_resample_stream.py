"""BASELINE config 3's resample chain as a stream, on the CPU: the
configuration and traffic of the benchmark cell `rschain128.chain_stream`
(44.1 -> 48 -> 16 kHz, then Whisper's framing: N 400, H 160, periodic
Hann, not centred) through `ResampledStftStreamer`, each stage a
`PolyphaseStreamer` (on the CPU the grouped product `resample` runs
there; B4 on the card, `test_torch_resample_stream_card.py`).

At 3 rows x 4 s of the cell's tones at 44.1 kHz, fed in uneven pieces:
each stage equals one-shot `resample`, the chain equals `stft` of the
one-shot chain frame for frame, both within the rounding of sums taken in
another order; the chain meets the benchmark's plain float64 reference
(`portbench/reference/resample64.py`, plain PyTorch that imports neither
JAX nor the port) where its TF32 control does not; the frames a feed
completes; `resample_chunked` on the stage streamer; the edges.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch.resample import polyphase
from portbench import signals
from portbench.reference import resample64, stft64

ROOT = Path(__file__).resolve().parent.parent
CELL = json.loads((ROOT / "portbench/configs/rschain128.json").read_text())
MIX = json.loads((ROOT / "portbench/traffic/chain_stream.json").read_text())
RATES = tuple(CELL["rates"])
CFG = pt.StftConfig(frame_size=CELL["frame_size"], hop_size=CELL["hop_size"])
ROWS, SAMPLES = 3, 4 * 44100
SEEDS = [2 ** 33 + 25, 2 ** 31 + 7, 11]
# Feeds of one sample, under and at a 10 ms hop (441), odd and prime
# lengths, then the rest in one feed.
FEEDS = [1, 440, 441, 8191, 7919, 93, 3, 147]

# The stream against the one-shot chain: the same products over the same
# samples, summed in another order (the grouped product's rows, up to 1 234
# terms at 1/3, fall elsewhere in a feed; the DFT's batch differs), so they
# agree to a few float32 roundings of the largest value. The program read
# at most 5.5e-7 (160/147) and 1.19e-6 (1/3) of the largest sample, and
# 2.45e-7 of the largest bin, over the seeds; the tolerances leave four to
# eight times that.
STAGE_TOL = 5e-6
FRAME_TOL = 2e-6
# Against the float64 reference: the products are IEEE fp32 sums of up to
# 1 234 terms and of 201 (the DFT); the program read err_rel 3.63-4.32e-7
# and peak_rel 1.86-2.09e-7 over the three seeds. The tolerances leave
# about ten times that; the TF32 control (operands rounded to TF32,
# float32 sums) read 4.08-6.11e-4 and 2.34-2.73e-4, a hundred times above.
ERR_REL = 4e-6
PEAK_REL = 2e-6


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _x(seed: int, rows: int = ROWS, samples: int = SAMPLES) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return signals.make(MIX["signal"], rows, samples, RATES[0], g, "cpu")


def _pieces(total: int, feeds: list) -> list:
    """[(start, end)] of `feeds` lengths in turn, the last piece the rest
    once half the signal is fed."""
    out, pos, k = [], 0, 0
    while pos < total:
        n = feeds[k % len(feeds)] if pos < total // 2 else total - pos
        out.append((pos, min(total, pos + n)))
        pos, k = pos + n, k + 1
    return out


def _oneshot_chain(x: torch.Tensor, cfg=CFG) -> torch.Tensor:
    y = x
    for a, b in zip(RATES, RATES[1:]):
        y = pt.resample(y, a, b)
    return pt.stft(y, cfg)


def _streamed(x: torch.Tensor, feeds: list, cfg=CFG, **kw) -> tuple:
    st = pt.ResampledStftStreamer(RATES, cfg, x.shape[0], device="cpu", **kw)
    outs = [st.feed(x[:, a:b]) for a, b in _pieces(x.shape[-1], feeds)]
    outs.append(st.finish())
    return torch.cat(outs, dim=-2), [o.shape[-2] for o in outs], st


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_the_chain_fed_unevenly_is_the_one_shot_chain(seed):
    x = _x(seed)
    want = _oneshot_chain(x)
    got, counts, st = _streamed(x, FEEDS)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert sum(counts) == want.shape[-2] == st.frames_out
    assert _rel_max(got, want) <= FRAME_TOL


@pytest.mark.parametrize("backend", list(pt.FftBackend))
@pytest.mark.parametrize("n, hop", [(400, 160), (512, 128)])
def test_the_chains_spectrum_takes_stfts_route(backend, n, hop):
    """The frames go through `stft`'s own windowed rFFT at every backend
    the configuration names (the folded products on MATMUL, `torch.fft` on
    XLA), so the stream is `stft` of the one-shot chain at each. An odd
    frame size, which the products would not fold, is refused with the
    configuration."""
    cfg = pt.StftConfig(frame_size=n, hop_size=hop, fft_backend=backend)
    x = _x(9, rows=2, samples=66_150)
    want = _oneshot_chain(x, cfg)
    got, _, _ = _streamed(x, [8191, 441], cfg)
    assert got.shape == want.shape
    assert _rel_max(got, want) <= FRAME_TOL
    with pytest.raises(ValueError):
        pt.StftConfig(frame_size=n + 1, hop_size=hop, fft_backend=backend)


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("sr_in, sr_out", [(44100, 48000), (48000, 16000)])
def test_each_stage_fed_unevenly_is_one_shot_resample(seed, sr_in, sr_out):
    x = _x(seed, samples=sr_in * 2)
    want = pt.resample(x, sr_in, sr_out)
    st = pt.PolyphaseStreamer(sr_in, sr_out, ROWS, device="cpu")
    _, _, w = polyphase._kernel_bank(st.l, st.m, None, 120.0)
    outs = []
    for a, b in _pieces(x.shape[-1], FEEDS):
        outs.append(st.feed(x[:, a:b]))
        # The history never outgrows the bank's width and one stride.
        assert st.history.shape[-1] <= w + st.m and st.start % st.m == 0
    outs.append(st.finish())
    got = torch.cat(outs, dim=-1)
    assert got.shape == want.shape and st.emitted == got.shape[-1]
    assert _rel_max(got, want) <= STAGE_TOL


@pytest.mark.parametrize("seed", SEEDS)
def test_the_chain_meets_the_float64_reference(seed):
    x = _x(seed)
    ref = resample64.Chain(CELL, "cpu").clip(x)
    got, _, _ = _streamed(x, FEEDS)
    nums = stft64.compare(torch.view_as_real(got), ref)
    assert nums["err_rel"] <= ERR_REL and nums["peak_rel"] <= PEAK_REL, nums
    ctl = stft64.compare(resample64.Chain(CELL, "cpu", "tf32").clip(x), ref)
    assert ctl["err_rel"] > ERR_REL or ctl["peak_rel"] > PEAK_REL, ctl


def test_the_reference_over_the_stream_is_its_one_shot():
    """`stream_frames`, which the benchmark checks each feed with, is the
    float64 chain over the unbroken stream at the same frames (to float64
    rounding: its products are batched otherwise)."""
    chunk = 20000
    ring = [_x(s, rows=2, samples=chunk) for s in (1, 2, 3)]
    stream = torch.cat([ring[k % 3] for k in range(6)], dim=-1)
    chain = resample64.Chain(CELL, "cpu")
    whole = chain.clip(stream)
    for f0, f1 in ((0, 40), (57, 201), (200, 250)):  # of 271, clear of the end
        got = chain.stream_frames(ring, chunk, f0, f1, row_block=1)
        want = whole[:, f0:f1]
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


def test_a_feed_of_441_k_samples_completes_k_hops():
    """Once the filters' delay is fed, a feed of 441*k samples at 44.1 kHz
    is 480*k at 48 kHz and k hops of 160 at 16 kHz: a 30 s feed (Whisper's
    window) completes 3000 frames, N_FRAMES."""
    chunk = CELL["chunk_samples_per_card"]
    x = _x(5, rows=1, samples=3 * chunk)
    st = pt.ResampledStftStreamer(RATES, CFG, 1, device="cpu")
    counts = [st.feed(x[:, k * chunk:(k + 1) * chunk]).shape[-2]
              for k in range(3)]
    assert counts[1:] == [3000, 3000] and counts[0] < 3000
    for k in (1, 7, 100, 3):
        assert st.feed(torch.zeros((1, 441 * k))).shape[-2] == k


def test_resample_chunked_runs_on_the_stage_streamer():
    """One piece of code carries the history: `resample_chunked` is the
    stage streamer fed its chunks."""
    x = _x(4, rows=2, samples=50_000)
    got = pt.resample_chunked(x, 44100, 48000, chunk=8192)
    st = pt.PolyphaseStreamer(44100, 48000, 2, device="cpu")
    parts = [st.feed(x[:, s:s + 8192]) for s in range(0, 49152, 8192)]
    parts.append(st.finish(x[:, 49152:]))
    assert torch.equal(got, torch.cat(parts, dim=-1))


def test_finish_after_no_feed_is_empty():
    st = pt.ResampledStftStreamer(RATES, CFG, 2, device="cpu")
    out = st.finish()
    assert out.shape == (2, 0, 201) and out.dtype == torch.complex64
    with pytest.raises(RuntimeError):
        st.feed(torch.zeros((2, 10)))
    stage = pt.PolyphaseStreamer(44100, 48000, 2, device="cpu")
    assert stage.finish().shape == (2, 0)
    with pytest.raises(RuntimeError):
        stage.finish()


def test_feeds_shorter_than_the_history():
    """Ten-sample feeds complete no frame for a while and nothing is lost:
    the stream is still the one-shot chain."""
    x = _x(6, rows=2, samples=12_000)
    want = _oneshot_chain(x)
    got, counts, _ = _streamed(x, [10])
    assert counts[0] == 0 and got.shape == want.shape
    assert _rel_max(got, want) <= FRAME_TOL


def test_numpy_feeds_go_to_the_streams_device():
    x = _x(7, rows=2, samples=20_000)
    a, _, _ = _streamed(x, [5000])
    st = pt.ResampledStftStreamer(RATES, CFG, 2, device="cpu")
    b = torch.cat([st.feed(x[:, p:q].numpy())
                   for p, q in _pieces(20_000, [5000])] + [st.finish()],
                  dim=-2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("make", [
    lambda: pt.PolyphaseStreamer(0, 48000, 2, device="cpu"),
    lambda: pt.PolyphaseStreamer(44100, -1, 2, device="cpu"),
    lambda: pt.PolyphaseStreamer(44100, 48000, 0, device="cpu"),
    lambda: pt.ResampledStftStreamer((44100, 0, 16000), CFG, 2, device="cpu"),
    lambda: pt.ResampledStftStreamer((44100,), CFG, 2, device="cpu"),
    lambda: pt.ResampledStftStreamer(RATES, pt.StftConfig(
        frame_size=400, hop_size=160, center=True), 2, device="cpu"),
])
def test_bad_streams_raise(make):
    with pytest.raises(ValueError):
        make()


def test_bad_feeds_raise():
    st = pt.PolyphaseStreamer(44100, 48000, 2, device="cpu")
    with pytest.raises(ValueError):
        st.feed(torch.zeros((3, 100)))
    with pytest.raises(ValueError):
        st.feed(torch.zeros(100))
    with pytest.raises(ValueError):
        st.feed(torch.zeros((2, 100), device="meta"))


def test_the_identity_rate_passes_through():
    x = _x(8, rows=2, samples=1000)
    st = pt.PolyphaseStreamer(16000, 16000, 2, device="cpu")
    got = torch.cat([st.feed(x[:, :300]), st.finish(x[:, 300:])], dim=-1)
    assert torch.equal(got, x)
    np.testing.assert_array_equal(
        pt.resample_chunked(x.numpy(), 16000, 16000, chunk=128,
                            device="cpu"), x.numpy())
