"""B1's seeded variant on the CPU: `ola.fused.ola_seeded_plain` and the
masked stream's overlap-add that it carries.

The masked branch of `distributed/sharded_pipeline.py` used to zero the
frames that do not exist globally (`torch.where` on a frame mask), run
`overlap_add` twice (the tail past the block, then the block with the
left neighbour's tail as `init_head`) and divide. The seeded variant does
the three in one pass over a window. Here it is held `torch.equal` to
that composition, rebuilt in the test: the plain version case by case
(seeds, frame ranges, R from 2 to 5, hops that are not multiples of 4,
the tail window, NaN in the frames left out), and the masked branch
whole on (1, 1), (1, 2) and (1, 4) meshes for every per-shard route, and
through `ShardedStreamer`.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import crlot_tpu_torch as pt
from crlot_tpu_torch import spectral
from crlot_tpu_torch.bench import launches
from crlot_tpu_torch.core.consts import const_on
from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.distributed import sharded_pipeline as sp
from crlot_tpu_torch.distributed.halo import (
    pull_right_halo,
    push_right_tail,
    received,
)
from crlot_tpu_torch.ola import fused
from crlot_tpu_torch.ola.reference import overlap_add

EPS = 1e-8
SR = 48000


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _parent(frames, hop, t0, length, f_lo, f_hi, seed=None, norm=None,
            eps=EPS):
    """The former composition: the frames outside [f_lo, f_hi) zeroed by a
    `where`, `overlap_add` with the seed as `init_head`, the window sliced
    out, `acc / clamp_min(norm, eps)` where a norm is given."""
    k = torch.arange(frames.shape[-2], device=frames.device)
    valid = (k >= f_lo) & (k < f_hi)
    of = torch.where(valid[:, None], frames, 0.0)
    acc = overlap_add(of, hop, t0 + length, init_head=seed)[..., t0:]
    if norm is None:
        return acc
    return acc / torch.clamp_min(norm[t0 : t0 + length], eps)


def _frames(seed: int, batch: int, n_frames: int, nfft: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    f = g.standard_normal((batch, n_frames, nfft)).astype(np.float32)
    f[:, ::3, ::5] = -0.0  # signed zeros among the frames' samples
    return torch.from_numpy(f)


def _seed(kind: str, batch: int, length: int) -> torch.Tensor | None:
    if kind == "none":
        return None
    if kind == "zero":
        return torch.zeros((batch, length))
    g = np.random.default_rng(length)
    s = g.standard_normal((batch, length)).astype(np.float32)
    s[:, ::7] = -0.0
    return torch.from_numpy(s)


def _norm(length: int) -> torch.Tensor:
    g = np.random.default_rng(length + 1)
    n = (g.random(length) + 0.25).astype(np.float32)
    n[::11] = 0.0  # below eps: divided by eps
    return torch.from_numpy(n)


# (N, hop): R = ceil(N / hop) of 2, 3, 4 and 5 (the run-time trip count),
# N not a multiple of hop, and hops that are not multiples of 4.
GEOMETRIES = {
    "R2": (64, 32),
    "R3": (96, 32),
    "R4": (128, 32),
    "R5": (160, 32),
    "R4_ragged": (100, 32),
    "hop21": (63, 21),
    "hop7_R5": (33, 7),
}
N_FRAMES = 12


def _ranges(f: int) -> dict:
    return {"full": (0, f), "empty": (5, 5), "f_lo": (3, f),
            "f_hi": (0, f - 4), "inner": (2, f - 3)}


@pytest.mark.parametrize("rng_name", list(_ranges(N_FRAMES)))
@pytest.mark.parametrize("seed_kind", ["none", "zero", "random"])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_the_block_window_is_the_parent_composition(geom, seed_kind,
                                                    rng_name):
    """[0, t_block) with the left tail seeded first and the divide: the
    main launch of the masked branch."""
    nfft, hop = GEOMETRIES[geom]
    frames = _frames(1, 2, N_FRAMES, nfft)
    f_lo, f_hi = _ranges(N_FRAMES)[rng_name]
    t_block = N_FRAMES * hop
    seed = _seed(seed_kind, 2, nfft - hop)
    norm = _norm(t_block)
    got = fused.ola_seeded_plain(frames, hop, 0, t_block, f_lo, f_hi, seed,
                                 norm, EPS)
    want = _parent(frames, hop, 0, t_block, f_lo, f_hi, seed, norm)
    assert got.shape == (2, t_block)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("rng_name", list(_ranges(N_FRAMES)))
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_the_tail_window_is_the_parent_composition(geom, rng_name):
    """[t_block, t_block + N - H), no seed, no divide: the tail launch,
    which only the last R - 1 frames reach."""
    nfft, hop = GEOMETRIES[geom]
    frames = _frames(2, 3, N_FRAMES, nfft)
    f_lo, f_hi = _ranges(N_FRAMES)[rng_name]
    t_block, halo = N_FRAMES * hop, nfft - hop
    got = fused.ola_seeded_plain(frames, hop, t_block, halo, f_lo, f_hi)
    want = _parent(frames, hop, t_block, halo, f_lo, f_hi)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("geom", list(GEOMETRIES))
@pytest.mark.parametrize("t0, length", [(5, 40), (0, 7), (33, 300),
                                        (64, 1000)])
def test_any_window_is_the_parent_composition(geom, t0, length):
    """Windows that start off a hop block, end inside one, or run past
    the frames' span (zeros there, as `overlap_add` pads), with a seed
    that ends inside the window and one that starts before it."""
    nfft, hop = GEOMETRIES[geom]
    frames = _frames(3, 2, N_FRAMES, nfft)
    norm = _norm(t0 + length)
    for seed_len in (1, 2 * nfft):
        seed = _seed("random", 2, seed_len)
        got = fused.ola_seeded_plain(frames, hop, t0, length, 2, 9, seed,
                                     norm, EPS)
        want = _parent(frames, hop, t0, length, 2, 9, seed, norm)
        assert torch.equal(got, want), (seed_len,)


@pytest.mark.parametrize("geom", ["R4", "hop21", "R4_ragged"])
@pytest.mark.parametrize("window", ["block", "tail"])
def test_nan_in_the_frames_left_out_changes_nothing(geom, window):
    """The `where` turned NaN and inf in a frame that does not exist into
    zeros; skipping the frame does the same."""
    nfft, hop = GEOMETRIES[geom]
    frames = _frames(4, 2, N_FRAMES, nfft)
    f_lo, f_hi = 2, N_FRAMES - 3
    frames[:, :f_lo] = float("nan")
    frames[:, f_hi:] = float("inf")
    frames[:, f_hi, 1] = float("nan")
    t_block, halo = N_FRAMES * hop, nfft - hop
    t0, length, seed, norm = ((0, t_block, _seed("random", 2, halo),
                               _norm(t_block)) if window == "block"
                              else (t_block, halo, None, None))
    got = fused.ola_seeded_plain(frames, hop, t0, length, f_lo, f_hi, seed,
                                 norm, EPS)
    want = _parent(frames, hop, t0, length, f_lo, f_hi, seed, norm)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_two_d_frames_and_the_dispatcher():
    """[F, N] frames with an [S] seed, and `ola_seeded` on a CPU tensor
    (the plain version; no launch counted)."""
    frames = _frames(5, 1, N_FRAMES, 128)[0]
    seed, norm = _seed("random", 1, 96)[0], _norm(N_FRAMES * 32)
    before = launches.launch_counts()["B1_seeded"]
    got = fused.ola_seeded(frames, 32, 0, N_FRAMES * 32, 1, 10, seed, norm)
    want = _parent(frames, 32, 0, N_FRAMES * 32, 1, 10, seed, norm)
    assert got.shape == (N_FRAMES * 32,) and torch.equal(got, want)
    assert launches.launch_counts()["B1_seeded"] == before


@pytest.mark.parametrize("bad", [
    dict(f_lo=-1), dict(f_hi=N_FRAMES + 1), dict(f_lo=6, f_hi=5),
    dict(t0=-1), dict(length=0), dict(hop=0), dict(norm_len=10),
    dict(seed_rows=3),
])
def test_bad_windows_raise(bad):
    frames = _frames(6, 2, N_FRAMES, 64)
    args = dict(hop=32, t0=0, length=N_FRAMES * 32, f_lo=0, f_hi=N_FRAMES)
    args.update({k: v for k, v in bad.items()
                 if k not in ("norm_len", "seed_rows")})
    norm = _norm(bad.get("norm_len", N_FRAMES * 32 + 64))
    seed = _seed("random", bad.get("seed_rows", 2), 32)
    with pytest.raises(ValueError):
        fused.ola_seeded_plain(frames, seed=seed, norm=norm, **args)


def test_the_cuda_wrapper_refuses_cpu_tensors():
    frames = _frames(7, 2, N_FRAMES, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fused.ola_seeded_cuda(frames, 32, 0, 64, 0, N_FRAMES)


class _Writes(TorchDispatchMode):
    """The largest tensor (in elements) an op writes: outputs that share
    no storage with the op's inputs."""

    def __init__(self) -> None:
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr()
                  for t in tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in inputs):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("geom", ["R4", "R4_ragged", "hop21"])
def test_the_plain_version_writes_no_frame_sized_tensor(geom):
    """Its largest write is the window's accumulator: the frames are read
    as views, never zeroed, padded or copied."""
    nfft, hop = GEOMETRIES[geom]
    frames = _frames(8, 2, N_FRAMES, nfft)
    t_block = N_FRAMES * hop
    writes = _Writes()
    with writes:
        fused.ola_seeded_plain(frames, hop, 0, t_block, 1, N_FRAMES - 2,
                               _seed("random", 2, nfft - hop),
                               _norm(t_block), EPS)
    assert writes.largest == 2 * t_block < frames.numel()


@pytest.mark.parametrize("start, count, valid_start, total_len", [
    (0, 16, 0, 4096), (0, 16, 0, 8192), (4096, 16, 0, 8192),
    (4096, 16, 512, 7000), (0, 16, 512, 7000), (0, 40, 1024, 10240),
    (2048, 8, 4096, 8192), (6144, 8, 0, 6500), (0, 8, 0, 100),
])
def test_valid_frames_is_the_frame_mask(start, count, valid_start,
                                        total_len):
    """`_valid_frames`' range holds exactly the frames the former mask
    kept: start >= valid_start and start + N <= total_len."""
    n, hop = 1024, 256
    starts = start + hop * torch.arange(count)
    mask = (starts >= valid_start) & (starts + n <= total_len)
    f_lo, f_hi = sp._valid_frames(start, count, n, hop, valid_start,
                                  total_len)
    want = torch.zeros(count, dtype=torch.bool)
    want[f_lo:f_hi] = True
    assert 0 <= f_lo <= f_hi <= count
    assert torch.equal(mask, want)


# --- the masked branch whole -------------------------------------------------


def _parent_masked(xs, norms, window_f64, cfg, total_len, spectral_fn,
                   valid_start, t_block, row=None, frame_bytes=None):
    """The masked branch as it was: each shard's route, the `where`, the
    two `overlap_add` passes with the tail's push between them, the
    divide."""
    n, hop = cfg.frame_size, cfg.hop_size
    halo = n - hop
    route = sp.shard_route(cfg, spectral_fn)
    per_block = t_block // hop
    rights = pull_right_halo(xs, halo, row)
    frames = []
    for t, (x, right) in enumerate(zip(xs, rights)):
        if x is None:
            frames.append(None)
            continue
        x_ext = torch.cat([x, received(right)], dim=-1)
        of = sp._local_frames(route, x_ext, cfg, spectral_fn, window_f64,
                              per_block)
        if cfg.synthesis_window:
            of = of * const_on(window_f64, of.device)
        start = t * t_block + hop * torch.arange(per_block,
                                                 device=of.device)
        valid = (start >= valid_start) & (start + n <= total_len)
        frames.append(torch.where(valid[:, None], of, 0.0))
    tails = [None if of is None
             else overlap_add(of, hop, t_block + halo)[..., t_block:]
             for of in frames]
    seeds = push_right_tail(tails, row)
    accs = [None if of is None
            else overlap_add(of, hop, t_block, init_head=received(seed))
            for of, seed in zip(frames, seeds)]
    return [None if acc is None else acc / torch.clamp_min(norm, cfg.eps)
            for acc, norm in zip(accs, norms)]


def _band_gain(nfft):
    return spectral.band_gain([500, 4000], [0.5, 1.0, 0.25], SR, nfft)


def _without_menu(fn):
    def same(spec):
        return fn(spec)

    same.packed = lambda re, im: fn.packed(re, im)
    return same


MASKED_ROUTES = {
    "fused_rt_frames": lambda n: spectral.noise_gate(-30.0),
    "composed": _band_gain,
    "packed_parts": lambda n: _without_menu(spectral.noise_gate(-30.0)),
    "stft_istft": lambda n: None,
}


def _signal(seed: int, channels: int, n: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.from_numpy(
        (0.5 * g.uniform(-1, 1, (channels, n))).astype(np.float32))


@pytest.mark.parametrize("valid", [(0, None), (512, 7000)])
@pytest.mark.parametrize("n_time", [1, 2, 4])
@pytest.mark.parametrize("route", list(MASKED_ROUTES))
def test_the_masked_branch_is_the_parent_composition(monkeypatch, route,
                                                     n_time, valid):
    """`sharded_round_trip` on the masked route, output and metrics,
    against the same call with the former masked branch in its place."""
    cfg = StftConfig(frame_size=1024, hop_size=256)
    fn = MASKED_ROUTES[route](1024)
    assert sp.shard_route(cfg, fn) == route
    mesh = pt.make_mesh(1, n_time, devices=["cpu"] * n_time)
    x = _signal(9 + n_time, 2, 8192)
    valid_start, valid_len = valid

    def call():
        return pt.sharded_round_trip(x, cfg, mesh, fn, valid_len=valid_len,
                                     valid_start=valid_start,
                                     return_metrics=True,
                                     allow_blocked=False)

    y, m = call()
    monkeypatch.setattr(sp, "_masked_local_round_trip", _parent_masked)
    want, m_want = call()
    assert torch.equal(y, want)
    for k in m_want:
        assert torch.equal(m[k], m_want[k]), k


def test_the_synthesis_window_branch_is_the_parent_composition(monkeypatch):
    cfg = StftConfig(frame_size=1024, hop_size=256, synthesis_window=True)
    mesh = pt.make_mesh(1, 2, devices=["cpu"] * 2)
    x = _signal(21, 2, 8192)
    y = pt.sharded_round_trip(x, cfg, mesh, spectral.noise_gate(-30.0),
                              allow_blocked=False)
    monkeypatch.setattr(sp, "_masked_local_round_trip", _parent_masked)
    want = pt.sharded_round_trip(x, cfg, mesh, spectral.noise_gate(-30.0),
                                 allow_blocked=False)
    assert torch.equal(y, want)


@pytest.mark.parametrize("n_time", [1, 2])
def test_the_masked_stream_is_chunked_one_shot_and_the_parent(monkeypatch,
                                                              n_time):
    """`ShardedStreamer` with the gate (the masked mode): chunked equals
    the one-shot masked call, and equals the stream with the former
    masked branch."""
    cfg = StftConfig(frame_size=1024, hop_size=256)
    fn = spectral.noise_gate(-30.0)
    mesh = pt.make_mesh(1, n_time, devices=["cpu"] * n_time)
    x = _signal(31, 2, 5 * 4096)

    def stream():
        st = pt.ShardedStreamer(cfg, mesh, fn, device="cpu")
        outs = [st.feed(x[:, i : i + 4096], force=False)
                for i in range(0, x.shape[1], 4096)]
        outs.append(st.finish(force=False))
        assert st.blocked is False
        return torch.cat([o for o in outs if o is not None], dim=-1)

    y = stream()
    one = pt.sharded_round_trip(x, cfg, mesh, fn, allow_blocked=False)
    assert torch.equal(y, one)
    monkeypatch.setattr(sp, "_masked_local_round_trip", _parent_masked)
    assert torch.equal(y, stream())
    assert math.isfinite(float(y.abs().max()))
