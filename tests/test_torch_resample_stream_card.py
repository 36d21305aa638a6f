"""The stream form of B4 on the card: each stage streamer's outputs
`torch.equal` to one-shot B4 under uneven feeds, one launch a feed that
completes an output, and the chain streamer's frames against `stft` of the
one-shot chain. B7, the framed windowed rFFT: within its bound of the
folded products in float64 on its own operands, `torch.equal` to its
emulated fmaf chains, and the chain's streamed spectrum `torch.equal` to
the one-shot's.

Needs a CUDA card and skips without one. It imports neither JAX nor the
JAX package, so it runs on the card's machine, which has no JAX, without
the suite's conftest:

    python -m pytest tests/test_torch_resample_stream_card.py --noconftest -q

B4 sums each output over its taps in one ascending order wherever the
output sits in its launch (`resample/kernel.py`), so a stage fed in any
pieces gives the one-shot's bits; B7 sums each bin of a frame in one
order too (`fft/fp32_window.py`), so the chain's spectrum is the
one-shot's to the bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch.core.consts import const_on
from crlot_tpu_torch.fft import dispatch
from crlot_tpu_torch.fft import fp32_window as b7
from crlot_tpu_torch.resample import kernel as b4
from crlot_tpu_torch.window.windows import WindowType, get_window

pytestmark = pytest.mark.card

RATES = [(44100, 48000), (48000, 16000), (8000, 12000), (48000, 300)]
FEEDS = [1, 440, 441, 8191, 7919, 147, 3, 65536]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B4 runs only there")
    return torch.device("cuda", 0)


def _signal(dev, rows, samples, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, samples), generator=g, device=dev) * 0.1


def _fed(streamer, x, feeds):
    """Feed x in pieces of the lengths `feeds` names, in turn, then
    finish; (the outputs joined, launches a call)."""
    outs, launched, pos, k = [], [], 0, 0
    while pos < x.shape[-1]:
        n = feeds[k % len(feeds)]
        before = b4.launches
        outs.append(streamer.feed(x[:, pos : pos + n]))
        launched.append((b4.launches - before, outs[-1].shape[-1]))
        pos, k = pos + n, k + 1
    before = b4.launches
    outs.append(streamer.finish())
    launched.append((b4.launches - before, outs[-1].shape[-1]))
    return torch.cat(outs, dim=-1), launched


@pytest.mark.parametrize("sr_in, sr_out", RATES)
@pytest.mark.parametrize("rows", [1, 3])
def test_each_stage_equals_one_shot_b4(dev, sr_in, sr_out, rows):
    x = _signal(dev, rows, 3 * sr_in // 2 + 17, sr_in + rows)
    want = pt.resample(x, sr_in, sr_out)
    st = pt.PolyphaseStreamer(sr_in, sr_out, rows, device=dev)
    got, launched = _fed(st, x, FEEDS)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert all(k == (1 if n else 0) for k, n in launched), launched


def test_the_cells_feed(dev):
    """At the cell's 30 s feeds of 44.1 kHz on 128 rows, three feeds: each
    stage bit-equal to one-shot, two launches a feed, 3000 frames a feed
    once the filters' delay is fed, and the frames against `stft` of the
    one-shot chain."""
    rows, chunk = 128, 1_323_000
    x = _signal(dev, rows, 3 * chunk, 3)
    chain = pt.ResampledStftStreamer(channels=rows, device=dev)
    spec, counts = [], []
    for k in range(3):
        before = b4.launches
        spec.append(chain.feed(x[:, k * chunk : (k + 1) * chunk]))
        counts.append(b4.launches - before)
    spec.append(chain.finish())
    torch.cuda.synchronize()
    assert counts == [2, 2, 2]
    assert [s.shape[-2] for s in spec[1:3]] == [3000, 3000]
    y16 = pt.resample(pt.resample(x, 44100, 48000), 48000, 16000)
    want = pt.stft(y16, pt.StftConfig(frame_size=400, hop_size=160))
    got = torch.cat(spec, dim=-2)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    del got, want, spec
    st = pt.PolyphaseStreamer(44100, 48000, rows, device=dev)
    one = pt.resample(x, 44100, 48000)
    part, _ = _fed(st, x, [chunk])
    assert torch.equal(part, one)


# (rows, row length, N, H): the cell's frames on one row and a CTA's worth
# on 128, rows of a length off 4 (so each row starts off 16 bytes), frame
# counts off a CTA's, hops below, at and above N, N/2 of 7s and 3s.
B7_SHAPES = [(1, 160 * 2999 + 400, 400, 160),
             (128, 160 * 120 + 403, 400, 160),
             (3, 128 * 300 + 513, 512, 128), (2, 200 * 77 + 514, 512, 200),
             (2, 512 * 9 + 512, 512, 512), (5, 256 * 41 + 1027, 1024, 256),
             (2, 333 * 50 + 1025, 1024, 333),
             (2, 1100 * 19 + 1029, 1024, 1100), (4, 7 * 33 + 17, 16, 7),
             (3, 45 * 60 + 98, 98, 45), (2, 100 * 30 + 960 + 1, 960, 100)]


def _window(dev, n, kind, seed):
    if kind == "hann":
        return const_on(get_window(WindowType.HANN, n), dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(n, generator=g, device=dev) + 0.1  # not symmetric


def _frames(dev, rows, length, n, hop, seed):
    x = _signal(dev, 1, rows * length + 1, seed)[0, 1:].view(rows, length)
    return x.unfold(-1, n, hop)


@pytest.mark.parametrize("kind", ["hann", "random"])
@pytest.mark.parametrize("rows, length, n, hop", B7_SHAPES)
def test_b7_within_its_bound_of_the_float64_products(dev, rows, length, n,
                                                     hop, kind):
    frames = _frames(dev, rows, length, n, hop, n + hop)
    w = _window(dev, n, kind, n)
    before = b7.stft_launches
    got = b7.stft_cuda(frames, n, w)
    torch.cuda.synchronize()
    assert b7.stft_launches == before + 1
    assert got.shape == frames.shape[:-1] + (n // 2 + 1,)
    want = b7.stft_plain(frames, n, w)
    tol = b7.stft_tolerance(frames, n, w)
    d = got.to(torch.complex128) - want
    assert bool((d.real.abs() <= tol.real).all())
    assert bool((d.imag.abs() <= tol.imag).all())
    assert bool((got.imag[..., 0] == 0).all())
    assert bool((got.imag[..., -1] == 0).all())


@pytest.mark.parametrize("rows, length, n, hop", [
    (1, 160 * 299 + 400, 400, 160), (3, 128 * 37 + 513, 512, 128),
    (2, 1100 * 5 + 1029, 1024, 1100), (4, 7 * 33 + 17, 16, 7)])
def test_b7_bins_depend_on_the_frame_alone(dev, rows, length, n, hop):
    """A run of frames copied out and taken alone (another CTA, another
    place in it, another row count) gives the whole call's bins bit for
    bit."""
    frames = _frames(dev, rows, length, n, hop, 7 * n + hop)
    w = _window(dev, n, "random", hop)
    whole = b7.stft_cuda(frames, n, w)
    part = frames[-1:, 3:-2]
    assert torch.equal(b7.stft_cuda(part.contiguous(), n, w),
                       whole[-1:, 3:-2])
    assert torch.equal(b7.stft_cuda(frames[0, 5], n, w), whole[0, 5])


def test_b7_takes_dense_and_batched_frames(dev):
    """[B, C, F, N] frames (contiguous: H = N) and a frames view whose
    leading axes do not merge (a copy) give each row's own spectrum."""
    x = _signal(dev, 6, 50 * 400, 11).view(2, 3, 50, 400)
    w = _window(dev, 400, "random", 3)
    got = b7.stft_cuda(x, 400, w)
    assert got.shape == (2, 3, 50, 201)
    assert torch.equal(got[1, 2], b7.stft_cuda(x[1, 2], 400, w))
    y = x.transpose(0, 1)  # leading axes that do not merge
    assert torch.equal(b7.stft_cuda(y, 400, w), got.transpose(0, 1))


def test_rfft_windowed_takes_b7_on_the_card(dev):
    frames = _frames(dev, 2, 160 * 40 + 400, 400, 160, 5)
    w64 = get_window(WindowType.HANN, 400, dtype=np.float64)
    assert dispatch.windowed_route(400, dev) == "B7"
    before = b7.stft_launches
    got = dispatch.rfft_windowed(frames, 400, w64)
    assert b7.stft_launches == before + 1
    assert torch.equal(got, b7.stft_cuda(frames, 400, const_on(w64, dev)))
    assert dispatch.rfft_windowed_bytes(frames.shape, 400, dev) == 0


@pytest.mark.parametrize("rates", [(44100, 16000), (44100, 48000, 16000),
                                   (48000, 16000)])
def test_streamed_spectrum_equals_the_one_shot(dev, rates):
    """`ResampledStftStreamer` in uneven feeds, one B7 launch a feed that
    completes a frame: the spectrum `torch.equal` to the one-shot
    `resampled_stft` (one stage) or `stft` of the one-shot chain."""
    cfg = pt.StftConfig(frame_size=400, hop_size=160)
    x = _signal(dev, 2, 3 * rates[0] + 17, 21)
    st = pt.ResampledStftStreamer(rates, cfg, 2, dev)
    parts, pos, k = [], 0, 0
    while pos < x.shape[-1]:
        n = FEEDS[k % len(FEEDS)]
        before = b7.stft_launches
        parts.append(st.feed(x[:, pos : pos + n]))
        assert b7.stft_launches - before == (1 if parts[-1].shape[-2] else 0)
        pos, k = pos + n, k + 1
    parts.append(st.finish())
    got = torch.cat(parts, dim=-2)
    if len(rates) == 2:
        want = pt.resampled_stft(x, rates[0], rates[1], cfg)
    else:
        y = x
        for a, b in zip(rates, rates[1:]):
            y = pt.resample(y, a, b)
        want = pt.stft(y, cfg)
    assert got.shape == want.shape
    assert torch.equal(got, want)
