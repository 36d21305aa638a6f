"""B1's seeded variant on the card: the kernel `torch.equal` to its plain
version, one launch counted a call.

Needs a CUDA card and skips without one. It imports neither JAX nor the
JAX package, so it runs on the card's machine, which has no JAX, without
the suite's conftest:

    python -m pytest tests/test_torch_ola_seeded_card.py --noconftest -q

At the gate stream cell's shapes (128 rows of 2352 frames of 1024, hop
256, a 602 112-sample block with the 768-sample tail seeded first and the
divide; the tail window undivided) and at odd ones: R from 2 to 5, N not
a multiple of the hop, hops that are not multiples of 4, windows off the
hop grid, a frames pointer off 16 bytes (the one-sample path).
"""

from __future__ import annotations

import pytest
import torch

from crlot_tpu_torch.ola import fused

pytestmark = pytest.mark.card

EPS = 1e-8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1's seeded kernel runs only there")
    return torch.device("cuda", 0)


def _case(dev, batch, n_frames, nfft, seed_len, norm_len, gen_seed,
          offset=0):
    g = torch.Generator(device=dev).manual_seed(gen_seed)
    flat = torch.randn(batch * n_frames * nfft + offset, generator=g,
                       device=dev)
    frames = flat[offset:].view(batch, n_frames, nfft)
    frames[:, ::3, ::5] = -0.0
    seed = torch.randn((batch, seed_len), generator=g, device=dev)
    seed[:, ::7] = -0.0
    norm = torch.rand(norm_len, generator=g, device=dev) + 0.25
    norm[::97] = 0.0  # below eps: divided by eps
    return frames, seed, norm


def _held(frames, hop, t0, length, f_lo, f_hi, seed, norm):
    """One launch, counted once, equal to the plain version on the card."""
    before = fused.seeded_launches
    got = fused.ola_seeded(frames, hop, t0, length, f_lo, f_hi, seed, norm,
                           EPS)
    torch.cuda.synchronize()
    assert fused.seeded_launches == before + 1
    want = fused.ola_seeded_plain(frames, hop, t0, length, f_lo, f_hi, seed,
                                  norm, EPS)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("f_lo", [0, 4])  # an interior feed, the first
def test_the_cells_block_and_tail(dev, f_lo):
    rows, n_frames, nfft, hop = 128, 2352, 1024, 256
    t_block, halo = n_frames * hop, nfft - hop
    f_hi = (t_block - nfft) // hop + 1
    frames, seed, norm = _case(dev, rows, n_frames, nfft, halo, t_block, 1)
    _held(frames, hop, 0, t_block, f_lo, f_hi, seed, norm)
    _held(frames, hop, t_block, halo, f_lo, f_hi, None, None)


@pytest.mark.parametrize("nfft, hop", [(64, 32), (96, 32), (128, 32),
                                       (160, 32), (100, 32), (63, 21),
                                       (33, 7), (1024, 256)])
@pytest.mark.parametrize("t0, length", [(0, None), ("tail", None),
                                        (5, 301), (64, 1000)])
@pytest.mark.parametrize("offset", [0, 1])
def test_odd_shapes(dev, nfft, hop, t0, length, offset):
    n_frames = 50
    t_block, halo = n_frames * hop, nfft - hop
    if t0 == "tail":
        t0, length = t_block, halo
    elif length is None:
        length = t_block
    frames, seed, norm = _case(dev, 3, n_frames, nfft, halo, t0 + length, 2,
                               offset)
    for f_lo, f_hi in ((0, n_frames), (3, n_frames - 4), (7, 7)):
        _held(frames, hop, t0, length, f_lo, f_hi, seed, norm)
        _held(frames, hop, t0, length, f_lo, f_hi, None, None)


def test_two_d_frames(dev):
    frames, seed, norm = _case(dev, 1, 40, 1024, 768, 40 * 256, 3)
    _held(frames[0], 256, 0, 40 * 256, 2, 37, seed[0], norm)
