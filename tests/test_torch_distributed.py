"""The port's sharded round-trip on CPU meshes of up to 8 shards, mirroring
`tests/test_distributed.py`, against the port's own 1-shard mesh and the
reference's `sharded_round_trip` on its 8-device CPU mesh.

A port mesh of n shards on the CPU lists the CPU device n times. Bounds:

* N shards vs 1 shard: bit-exact where each frame's arithmetic does not
  depend on the batch (`torch.fft`, B3's plain version on these inputs, the
  seeded OLA) and where the reference asserts it; the reference's own
  tolerances where a route runs `torch.matmul` (blocked: rtol 3e-6 with
  exact edges; packed nonlinear: rtol 2e-4 / atol 1e-4).
* Port vs reference (another FFT library, another GEMM order): max-abs
  <= 1e-5 over the interior [N, T - N); `center=False` divides the first
  samples by the near-zero norm of a periodic Hann, so edges are compared
  only inside the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crlot_tpu.spectral as jsp
from crlot_tpu.core.types import FftBackend as JFftBackend
from crlot_tpu.core.types import StftConfig as JStftConfig
from crlot_tpu.distributed.mesh import make_mesh as j_make_mesh
from crlot_tpu.distributed.sharded_pipeline import (
    sharded_round_trip as j_sharded,
)
from crlot_tpu.pipeline import round_trip as j_round_trip

import crlot_tpu_torch as pt
from crlot_tpu_torch import spectral as tsp
from crlot_tpu_torch.convert import config_from_reference
from crlot_tpu_torch.distributed import halo
from crlot_tpu_torch.distributed import sharded_pipeline as spl
from crlot_tpu_torch.distributed.mesh import visible_devices

CPU = torch.device("cpu")


def _mesh(channel, time):
    return pt.make_mesh(channel, time, devices=[CPU] * (channel * time))


def _sig(c, t, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (c, t)).astype(
        np.float32)


def _cfgs(**kw):
    jcfg = JStftConfig(center=False, **kw)
    return jcfg, config_from_reference(jcfg)


def _reference(x, jcfg, channel, time, fn=None, **kw):
    return np.asarray(j_sharded(jnp.asarray(x), jcfg,
                                j_make_mesh(channel=channel, time=time),
                                spectral_fn=fn, **kw))


def _interior_err(got, want, nfft):
    return np.max(np.abs(np.asarray(got)[:, nfft:-nfft]
                         - np.asarray(want)[:, nfft:-nfft]))


@pytest.mark.parametrize("nfft,hop,total", [(128, 32, 4096), (256, 128, 8192)])
@pytest.mark.parametrize("channel,time", [(1, 8), (2, 4), (4, 2), (8, 1),
                                          (1, 4)])
def test_sharded_matches_single_shard_bitexact(nfft, hop, total, channel,
                                               time):
    cfg = pt.StftConfig(frame_size=nfft, hop_size=hop)
    x = _sig(max(channel, 2), total, seed=nfft + channel)
    got = pt.sharded_round_trip(x, cfg, _mesh(channel, time), device="cpu")
    one = pt.sharded_round_trip(x, cfg, _mesh(1, 1), device="cpu")
    assert got.shape == x.shape
    assert torch.equal(got, one)
    if pt.formulation_for(cfg, None, total) == "stft_istft":
        # The same frames as the one-shot pipeline: bit for bit.
        assert torch.equal(got, pt.round_trip(torch.from_numpy(x), cfg))


@pytest.mark.parametrize("nfft,hop,total", [(128, 32, 4096), (256, 128, 8192)])
def test_sharded_matches_reference_sharded(nfft, hop, total):
    """At 256/128 the port takes the blocked route (a matmul config by
    default) and the reference's CPU its FFT route: same math."""
    jcfg, cfg = _cfgs(frame_size=nfft, hop_size=hop)
    x = _sig(2, total, seed=nfft + 2)
    got = pt.sharded_round_trip(x, cfg, _mesh(2, 4), device="cpu")
    want = _reference(x, jcfg, 2, 4)
    assert _interior_err(got, want, nfft) <= 1e-5


def test_sharded_spectral_fn():
    jcfg, cfg = _cfgs(frame_size=128, hop_size=32)
    x = _sig(2, 8192, seed=2)
    got = pt.sharded_round_trip(x, cfg, _mesh(1, 8), lambda s: s * 0.25,
                                device="cpu")
    assert spl.shard_route(cfg, lambda s: s) == "stft_istft"
    want = pt.round_trip(torch.from_numpy(x), cfg, lambda s: s * 0.25)
    assert torch.equal(got, want)
    ref = _reference(x, jcfg, 1, 8, lambda s: s * 0.25)
    assert _interior_err(got, ref, 128) <= 1e-5


def test_sharded_reconstruction_quality():
    cfg = pt.StftConfig(frame_size=128, hop_size=32)
    x = _sig(2, 8192, seed=3)
    y = pt.sharded_round_trip(x, cfg, pt.auto_mesh(8, devices=[CPU] * 8),
                              device="cpu")
    covered = (cfg.frame_spec.num_frames(8192) - 1) * 32 + 128
    assert pt.snr_db(x[:, 128:covered - 128], y[:, 128:covered - 128]) > 80


def test_sharded_validation():
    cfg = pt.StftConfig(frame_size=128, hop_size=32)
    mesh = _mesh(2, 4)
    for x in (torch.zeros((3, 4096)),   # channels not divisible
              torch.zeros((2, 4100)),   # T not divisible
              torch.zeros((2, 256))):   # block < frame
        with pytest.raises(ValueError):
            pt.sharded_round_trip(x, cfg, mesh)
    with pytest.raises(ValueError, match="hop-aligned"):  # block % hop
        pt.sharded_round_trip(torch.zeros((2, 4 * 144)), cfg, _mesh(1, 4))
    with pytest.raises(ValueError, match="center"):
        pt.sharded_round_trip(
            torch.zeros((2, 4096)),
            pt.StftConfig(frame_size=128, hop_size=32, center=True), mesh)
    with pytest.raises(ValueError, match="valid_start"):
        pt.sharded_round_trip(torch.zeros((2, 4096)), cfg, mesh,
                              valid_start=7)
    # No frame fits: zeros, like the reference.
    y = pt.sharded_round_trip(torch.ones((2, 4096)), cfg, mesh, valid_len=100)
    assert torch.equal(y, torch.zeros((2, 4096)))


def test_mesh_helpers():
    m = pt.auto_mesh(8, devices=[CPU] * 8)
    assert m.shape["channel"] * m.shape["time"] == 8
    assert m.shape == {"channel": 2, "time": 4}
    assert pt.auto_mesh(8, channels=1, devices=[CPU] * 8).shape == {
        "channel": 1, "time": 8}
    with pytest.raises(ValueError):
        pt.make_mesh(channel=16, time=16, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        pt.make_mesh(channel=3, devices=[CPU] * 8)
    # Default devices: every visible CUDA device; without a card the
    # defaults raise (never a silent CPU mesh).
    assert visible_devices() == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.auto_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.sharded_round_trip(_sig(2, 4096), pt.StftConfig(128, 32),
                              _mesh(1, 1))
    two = pt.make_mesh(2, 3, devices=["cpu"] * 6)
    assert two.device(1, 2) == CPU


def test_sharded_round_trip_jit_closure():
    cfg = pt.StftConfig(frame_size=128, hop_size=32)
    mesh = _mesh(2, 4)
    run = spl.sharded_round_trip_jit(cfg, mesh)
    x = _sig(2, 4096, seed=12)
    assert torch.equal(run(x, device="cpu"),
                       pt.sharded_round_trip(x, cfg, mesh, device="cpu"))


# ---------------------------------------------------------------------------
# in-mesh metric reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channel,time", [(2, 4), (1, 8), (8, 1)])
def test_sharded_metrics_match_host(channel, time):
    cfg = pt.StftConfig(frame_size=128, hop_size=32)
    x = _sig(max(channel, 2), 4096, seed=3)
    y, m = pt.sharded_round_trip(x, cfg, _mesh(channel, time),
                                 return_metrics=True, device="cpu")
    rep = pt.metrics_report(m)
    assert rep["peak"] == float(torch.max(torch.abs(y)))
    assert abs(rep["snr_db"] - pt.snr_db(x, y)) < 0.01
    assert rep["peak_db"] == 20.0 * np.log10(rep["peak"])


def test_sharded_metrics_output_identical_to_plain_call():
    cfg = pt.StftConfig(frame_size=128, hop_size=32)
    mesh = _mesh(2, 4)
    x = _sig(2, 4096, seed=4)
    plain = pt.sharded_round_trip(x, cfg, mesh, device="cpu")
    y, _ = pt.sharded_round_trip(x, cfg, mesh, return_metrics=True,
                                 device="cpu")
    assert torch.equal(y, plain)


def test_metrics_report_edge_values():
    z, one = torch.tensor(0.0), torch.tensor(1.0)
    rep = pt.metrics_report({"signal_energy": one, "noise_energy": z,
                             "peak": z})
    assert rep["snr_db"] == float("inf") and rep["peak_db"] == float("-inf")
    rep = pt.metrics_report({"signal_energy": z, "noise_energy": one,
                             "peak": one})
    assert rep["snr_db"] == float("-inf") and rep["peak_db"] == 0.0


# ---------------------------------------------------------------------------
# blocked (hop-block Toeplitz) sharded route
# ---------------------------------------------------------------------------

def _blocked_setup():
    jcfg, cfg = _cfgs(frame_size=512, hop_size=128,
                      fft_backend=JFftBackend.MATMUL)
    args = ([3000.0], [1.0, 0.3], 48000, 512)
    return jcfg, cfg, jsp.band_gain(*args), tsp.band_gain(*args), _sig(
        2, 8192, seed=31)


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(spl, name)

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(spl, name, spy)
    return calls


def test_sharded_blocked_eq_engages_and_matches_unsharded(monkeypatch):
    from crlot_tpu_torch.fft.matmul_backend import roundtrip_composed_blocked
    from crlot_tpu_torch.ola.norm import edge_norm

    _, cfg, _, eq, x = _blocked_setup()
    calls = _spy(monkeypatch, "_blocked_local_round_trip")
    got = pt.sharded_round_trip(x, cfg, _mesh(1, 1), eq, device="cpu")
    assert calls, "blocked route did not engage"
    n, hop = cfg.frame_size, cfg.hop_size
    num_frames = (x.shape[1] - n) // hop + 1
    w64 = pt.get_window(cfg.window, n, cfg.periodic, dtype=np.float64)
    acc = roundtrip_composed_blocked(
        torch.from_numpy(x), n, hop, num_frames, w64,
        tsp.resolve_per_bin_response(eq, n), None, group=2,
    )
    norm = torch.from_numpy(
        edge_norm(w64, hop, num_frames, x.shape[1]).astype(np.float32))
    ref = acc / torch.clamp_min(norm, cfg.eps)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-6, atol=1e-6)


@pytest.mark.parametrize("channel,time", [(2, 4), (1, 8), (1, 2)])
def test_sharded_blocked_eq_mesh_consistency(channel, time, monkeypatch):
    _, cfg, _, eq, x = _blocked_setup()
    calls = _spy(monkeypatch, "_blocked_local_round_trip")
    one = pt.sharded_round_trip(x, cfg, _mesh(1, 1), eq, device="cpu").numpy()
    got = pt.sharded_round_trip(x, cfg, _mesh(channel, time), eq,
                                device="cpu").numpy()
    assert len(calls) == 1 + channel
    np.testing.assert_allclose(got, one, rtol=3e-6, atol=1e-6)
    edge = cfg.frame_size - cfg.hop_size
    np.testing.assert_array_equal(got[:, :edge], one[:, :edge])
    np.testing.assert_array_equal(got[:, -edge:], one[:, -edge:])


def test_sharded_blocked_eq_vs_reference():
    """Against the reference's one-shot CPU round-trip (its FFT route)."""
    jcfg, cfg, jeq, eq, x = _blocked_setup()
    got = pt.sharded_round_trip(x, cfg, _mesh(2, 4), eq, device="cpu")
    j_auto = JStftConfig(frame_size=512, hop_size=128, center=False)
    want = np.asarray(j_round_trip(jnp.asarray(x), j_auto, jeq))
    assert _interior_err(got, want, cfg.frame_size) <= 1e-5


def test_sharded_blocked_identity_with_auto_backend_is_config_decided(
        monkeypatch):
    """The identity at N=256/H=128 with FftBackend.AUTO takes the blocked
    route on the CPU too: the gate reads the config, not the device."""
    cfg = pt.StftConfig(frame_size=256, hop_size=128)
    assert cfg.fft_backend == pt.FftBackend.AUTO
    assert spl.blocked_per_bin(cfg, None, t_block=2048, num_frames=63) is not None
    calls = _spy(monkeypatch, "_blocked_local_round_trip")
    x = _sig(2, 8192, seed=33)
    pt.sharded_round_trip(x, cfg, _mesh(1, 4), device="cpu")
    assert calls
    xla = pt.StftConfig(frame_size=256, hop_size=128,
                        fft_backend=pt.FftBackend.XLA)
    assert spl.blocked_per_bin(xla, None, t_block=2048, num_frames=63) is None


def test_sharded_blocked_matches_composed_route_within_tier(monkeypatch):
    _, cfg, _, eq, x = _blocked_setup()
    mesh = _mesh(2, 4)
    blocked = pt.sharded_round_trip(x, cfg, mesh, eq, device="cpu").numpy()
    assert spl.shard_route(cfg, eq) == "composed"
    calls = _spy(monkeypatch, "_blocked_local_round_trip")
    composed = pt.sharded_round_trip(x, cfg, mesh, eq,
                                     allow_blocked=False, device="cpu").numpy()
    assert not calls
    interior = slice(cfg.frame_size, x.shape[1] - cfg.frame_size)
    err = np.abs(blocked[:, interior] - composed[:, interior])
    scale = np.abs(composed[:, interior]).max()
    assert err.max() <= 1e-4 * max(scale, 1.0), (err.max(), scale)


def test_sharded_blocked_falls_back_when_unaligned(monkeypatch):
    """t_block % (group*hop) != 0 -> the composed frame formulation."""
    jcfg, cfg, jeq, eq, _ = _blocked_setup()
    x = _sig(2, 8 * 640, seed=32)  # t_block = 640 = 5 hops, group*hop = 256
    calls = _spy(monkeypatch, "_blocked_local_round_trip")
    got = pt.sharded_round_trip(x, cfg, _mesh(1, 8), eq, device="cpu")
    assert not calls, "blocked route must not engage on unaligned blocks"
    assert torch.isfinite(got).all()
    want = _reference(x, jcfg, 1, 8, jeq)
    assert _interior_err(got, want, cfg.frame_size) <= 1e-5


# ---------------------------------------------------------------------------
# nonlinear packed fns: the B3 route and the packed parts
# ---------------------------------------------------------------------------

def test_sharded_packed_nonlinear_gate_takes_b3(monkeypatch):
    """noise_gate (packed, with a menu) on a MATMUL config: the
    "fused_rt_frames" route (B3's plain version on the CPU), mesh-consistent,
    and within the reference's tolerance of its sharded result."""
    _, cfg = _cfgs(frame_size=512, hop_size=128,
                   fft_backend=JFftBackend.MATMUL)
    gate = tsp.noise_gate(-40.0, attenuation_db=-80.0)
    assert spl.shard_route(cfg, gate) == "fused_rt_frames"
    x = np.random.default_rng(22).uniform(-0.9, 0.9, (1, 4 * 4096)).astype(
        np.float32)
    calls = _spy(monkeypatch, "roundtrip_frames_fused")
    y4 = pt.sharded_round_trip(x, cfg, _mesh(1, 4), gate, device="cpu").numpy()
    assert len(calls) == 4
    y1 = pt.sharded_round_trip(x, cfg, _mesh(1, 1), gate, device="cpu").numpy()
    interior = slice(512, -512)
    np.testing.assert_allclose(y4[0][interior], y1[0][interior], rtol=2e-4,
                               atol=1e-4)
    # The reference's one-shot CPU round-trip (its FFT route).
    j_auto = JStftConfig(frame_size=512, hop_size=128, center=False)
    want = np.asarray(j_round_trip(
        jnp.asarray(x), j_auto, jsp.noise_gate(-40.0, attenuation_db=-80.0)))
    np.testing.assert_allclose(y4[0][interior], want[0][interior],
                               rtol=2e-4, atol=1e-4)


def test_sharded_packed_parts_for_fn_without_menu():
    """A packed fn outside the B3 menu takes the folded parts; a gate that
    reaches the kernel's menu takes B3; the two agree within the tier."""
    cfg = pt.StftConfig(frame_size=512, hop_size=128)
    gate = tsp.noise_gate(-40.0, attenuation_db=-80.0)

    def no_menu(spec):
        return gate(spec)

    no_menu.packed = lambda re, im: gate.packed(re, im)
    assert spl.shard_route(cfg, no_menu) == "packed_parts"
    x = _sig(2, 4 * 4096, seed=23)
    a = pt.sharded_round_trip(x, cfg, _mesh(2, 2), no_menu,
                              device="cpu").numpy()
    b = pt.sharded_round_trip(x, cfg, _mesh(2, 2), gate, device="cpu").numpy()
    np.testing.assert_allclose(a[:, 512:-512], b[:, 512:-512], rtol=0,
                               atol=1e-6)


def test_shard_routes_follow_the_config():
    base = dict(frame_size=512, hop_size=128)
    gate = tsp.noise_gate(-30.0)
    eq = tsp.band_gain([1000.0], [1.0, 0.5], 48000, 512)
    route = spl.shard_route
    assert route(pt.StftConfig(**base), eq) == "composed"
    assert route(pt.StftConfig(**base), gate) == "fused_rt_frames"
    assert route(pt.StftConfig(**base), None) == "stft_istft"
    assert route(pt.StftConfig(**base, fft_precision=pt.FftPrecision.HIGHEST),
                 gate) == "packed_parts"
    assert route(pt.StftConfig(**base, fft_backend=pt.FftBackend.XLA),
                 gate) == "stft_istft"
    assert route(pt.StftConfig(**base, fft_backend=pt.FftBackend.XLA),
                 eq) == "stft_istft"


def test_sharded_synthesis_window_mode():
    cfg = pt.StftConfig(frame_size=128, hop_size=32, synthesis_window=True)
    x = _sig(2, 4096, seed=9)
    want = pt.round_trip(torch.from_numpy(x), cfg)
    assert torch.equal(
        pt.sharded_round_trip(x, cfg, _mesh(2, 4), device="cpu"), want)


def test_sharded_valid_window_masks_frames():
    """valid_start / valid_len keep only frames inside the window; the
    rest of the output is zero, on any mesh."""
    cfg = pt.StftConfig(frame_size=128, hop_size=32)
    x = _sig(2, 4096, seed=10)
    kw = dict(valid_start=512, valid_len=3000)
    one = pt.sharded_round_trip(x, cfg, _mesh(1, 1), **kw, device="cpu")
    got = pt.sharded_round_trip(x, cfg, _mesh(2, 4), **kw, device="cpu")
    assert torch.equal(got, one)
    assert not got[:, :512].any() and not got[:, 3000:].any()
    inner = pt.round_trip(torch.from_numpy(x[:, 512:3000]), cfg)
    span = (cfg.frame_spec.num_frames(2488) - 1) * 32 + 128
    np.testing.assert_array_equal(got[:, 512:512 + span].numpy(),
                                  inner[:, :span].numpy())


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

def test_halo_edges_receive_zeros():
    shards = [torch.full((2, 16), float(d + 1)) for d in range(4)]
    right = halo.pull_right_halo(shards, 5)
    left = halo.pull_left_halo(shards, 5)
    tails = halo.push_right_tail([s[:, :3] for s in shards])
    for d in range(4):
        assert right[d].shape == left[d].shape == (2, 5)
        assert float(right[d][0, 0]) == (d + 2 if d < 3 else 0)
        assert float(left[d][0, 0]) == (d if d > 0 else 0)
        assert float(tails[d][0, 0]) == (d if d > 0 else 0)


@pytest.mark.parametrize("allow_blocked", [True, False])
def test_halo_volume_is_o_frame_not_o_block(monkeypatch, allow_blocked):
    """The samples the exchanges move do not grow with the block: one
    N - H halo (and one tail) per edge."""
    moved = []

    def count(fn):
        def f(*a, **k):
            out = fn(*a, **k)
            moved.append(sum(t.numel() for t in out))
            return out
        return f

    for name in ("pull_right_halo", "pull_left_halo", "push_right_tail"):
        monkeypatch.setattr(spl, name, count(getattr(spl, name)))
    cfg = pt.StftConfig(frame_size=256, hop_size=128)

    def volume(total):
        moved.clear()
        pt.sharded_round_trip(np.zeros((1, total), np.float32), cfg,
                              _mesh(1, 4), allow_blocked=allow_blocked,
                              device="cpu")
        return sum(moved)

    small, large = volume(4 * 2048), volume(4 * 8192)
    assert small > 0 and large == small
    halo_len = cfg.frame_size - cfg.hop_size
    assert small == 2 * 4 * halo_len  # two exchanges, 4 shards, 1 channel
