"""The blocked formulation's one plan (`fft.matmul_backend.blocked_plan`).

The one-shot route, both chunk streamers and the mesh stream take their
constants from one `BlockedPlan`: it is built once between them at one
config, its kernel is designed once for the folded response and once for
the raw one (the mesh program divides by its norm blocks afterwards), and
the spectral fn's response is resolved once a `round_trip` call and once a
stream. The plan's fold decision and norms are the ones the frame-count
norm gives for every count the formulation takes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch import pipeline, spectral
from crlot_tpu_torch.core.consts import const_builds
from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.fft import matmul_backend as mb
from crlot_tpu_torch.wire import I16BlockedStreamer


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _counting_eq(n):
    """A 3-band EQ whose per-bin gains count their resolutions."""
    fn = spectral.band_gain([1000.0, 6000.0], [0.5, 1.0, 1.5], 48000, n)
    gains = fn.per_bin_gains
    fn.resolutions = 0

    def per_bin_gains(nfft):
        fn.resolutions += 1
        return gains(nfft)

    fn.per_bin_gains = per_bin_gains
    return fn


def _x(channels, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, (channels, n)).astype(np.float32)


def _stream(st, x, s):
    outs = [st.feed(x[..., k * s : (k + 1) * s])
            for k in range(x.shape[-1] // s)]
    outs.append(st.finish())
    return [o for o in outs if o is not None]


def _misses(fn):
    return fn.cache_info().misses


def _run_all(cfg, fn, x, s):
    """A round_trip call, a BlockedChunkStreamer, an I16BlockedStreamer and
    a ShardedStreamer on a (1, 1) mesh, each over `x` in [.., s] chunks;
    returns the resolutions each made."""
    made = []
    before = fn.resolutions
    assert pipeline.formulation_for(cfg, fn, x.shape[-1]) == "blocked"
    made.append(fn.resolutions - before)
    before = fn.resolutions
    pt.round_trip(torch.from_numpy(x), cfg, fn)
    made.append(fn.resolutions - before)
    for make, chunks in (
            (lambda: pt.BlockedChunkStreamer(cfg, fn, device="cpu"), x),
            (lambda: I16BlockedStreamer(cfg, fn, device="cpu"),
             (x * 32767).astype(np.int16)),
            (lambda: pt.ShardedStreamer(
                cfg, pt.make_mesh(1, 1, devices=["cpu"]), fn, device="cpu"),
             x)):
        before = fn.resolutions
        st = make()
        _stream(st, chunks, s)
        assert getattr(st, "blocked", True)
        made.append(fn.resolutions - before)
    return made


def test_one_plan_and_kernel_between_the_blocked_callers():
    # An eps no other test uses, so that this test builds the plan.
    cfg = StftConfig(frame_size=512, hop_size=128, center=False, eps=7e-9)
    fn = _counting_eq(512)
    x, s = _x(2, 5 * 2048), 2048
    plans = _misses(mb.blocked_plan)
    kernels = _misses(mb._plan_kernel_on)
    designs = _misses(mb._composed_block_kernel_grouped)
    made = _run_all(cfg, fn, x, s)
    assert made == [1, 1, 1, 1, 1]
    assert _misses(mb.blocked_plan) - plans == 1
    # The folded kernel (one-shot, f32 streamer; the int16 streamer
    # quantizes the same design) and the raw one (the mesh program).
    assert _misses(mb._plan_kernel_on) - kernels == 2
    assert _misses(mb._composed_block_kernel_grouped) - designs == 2
    builds = const_builds()
    assert _run_all(cfg, fn, x, s) == [1, 1, 1, 1, 1]
    assert const_builds() == builds


@pytest.mark.parametrize("n,hop,synthesis", [
    (1024, 256, False), (512, 128, False), (1024, 256, True),
    (1024, 512, True)])
def test_plan_norms_hold_for_every_frame_count(n, hop, synthesis):
    """The fold decision, norm_c, the interior tile and the clamped edge
    norms equal what the actual-coverage norm of any frame count >= 2(R-1)
    gives, fold or not (with the synthesis window the squared Hann sum is
    constant only to f32 rounding, so it does not fold)."""
    cfg = StftConfig(frame_size=n, hop_size=hop, synthesis_window=synthesis)
    plan = mb.blocked_plan_for(cfg, mb.blocked_response(cfg, None))
    edge, eps = plan.edge, cfg.eps
    assert (edge, plan.gh) == (n - hop, mb.blocked_group_for(n, hop) * hop)
    r = n // hop
    for nf in (2 * (r - 1), 2 * (r - 1) + 1, 37):
        norm, full, edge_, fold = pipeline.blocked_norm_fold(cfg, nf)
        assert edge_ == edge and fold == (plan.norm_c is not None)
        norm64 = norm.astype(np.float64)
        np.testing.assert_array_equal(
            plan.head_norm, np.maximum(norm64[:edge], eps).astype(np.float32))
        np.testing.assert_array_equal(
            plan.tail_norm,
            np.maximum(norm64[full - edge :], eps).astype(np.float32))
        inner = np.maximum(norm64[edge : full - edge], eps).astype(np.float32)
        if fold:
            assert plan.norm_c == float(norm64[edge]) and plan.tile is None
        else:
            np.testing.assert_array_equal(
                np.tile(plan.tile, len(inner) // hop), inner)
    assert (plan.norm_c is None) == synthesis


def test_plan_is_keyed_by_its_design_not_the_config():
    """Configs that differ only where the design does not (centering, the
    tier, the backend) share one plan; eps, the synthesis flag and the
    response each give another."""
    base = StftConfig(frame_size=1024, hop_size=256)
    ones = mb.blocked_response(base, None)
    plan = mb.blocked_plan_for(base, ones)
    same = StftConfig(frame_size=1024, hop_size=256, center=True,
                      fft_precision=pt.FftPrecision.HIGHEST,
                      fft_backend=pt.FftBackend.MATMUL)
    assert mb.blocked_plan_for(same, ones) is plan
    for other, response in (
            (StftConfig(frame_size=1024, hop_size=256, eps=2e-8), ones),
            (StftConfig(frame_size=1024, hop_size=256,
                        synthesis_window=True), ones),
            (base, ones * 0.5)):
        assert mb.blocked_plan_for(other, response) != plan
    assert mb.blocked_response(base, spectral.noise_gate(-40.0)) is None
    assert mb.blocked_response(StftConfig(frame_size=8192, hop_size=2048),
                               None) is None
