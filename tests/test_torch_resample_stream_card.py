"""The stream form of B4 on the card: each stage streamer's outputs
`torch.equal` to one-shot B4 under uneven feeds, one launch a feed that
completes an output, and the chain streamer's frames against `stft` of the
one-shot chain.

Needs a CUDA card and skips without one. It imports neither JAX nor the
JAX package, so it runs on the card's machine, which has no JAX, without
the suite's conftest:

    python -m pytest tests/test_torch_resample_stream_card.py --noconftest -q

B4 sums each output over its taps in one ascending order wherever the
output sits in its launch (`resample/kernel.py`), so a stage fed in any
pieces gives the one-shot's bits. The spectrum's products are cuBLAS's,
batched by the feed, so the chain's frames agree to rounding: fp32 sums of
N/2 + 1 terms of the windowed frames, held within 1e-5 of the largest
bin, the tolerance of `chip_smoke.py`'s phase 15 for the same route.
"""

from __future__ import annotations

import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch.resample import kernel as b4

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
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    del got, want, spec
    st = pt.PolyphaseStreamer(44100, 48000, rows, device=dev)
    one = pt.resample(x, 44100, 48000)
    part, _ = _fed(st, x, [chunk])
    assert torch.equal(part, one)
