"""The B2 route (fused nonlinear round-trip + OLA): the port's plain version
vs the reference's Pallas kernel (interpret mode) and vs the reference's
CPU `round_trip`, plus the epilogue menu's descriptors.

Tolerances: the Pallas kernel emulates fp32 products with 3 bf16 passes and
sits up to ~2.1e-5 from the reference's own XLA route on these inputs, so
the port is held to max-abs <= 1e-4 against it. Against the reference's CPU
`round_trip` (fp32 FFTs) the port is held to max-abs <= 1e-5. `noise_gate`
is discontinuous, so every gate threshold here is placed in a gap of at
least 2 dB in the float64 bin powers of the input: no bin can flip between
the two packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crlot_tpu.spectral as jsp
from crlot_tpu.core.padding import pad_signal as j_pad
from crlot_tpu.core.types import StftConfig as JStftConfig
from crlot_tpu.fft.pallas_rt import roundtrip_signal_fused as j_fused
from crlot_tpu.pipeline import _norm_np as j_norm_np
from crlot_tpu.pipeline import _window_f64 as j_window_f64
from crlot_tpu.pipeline import round_trip as j_round_trip

import crlot_tpu_torch as pt
from crlot_tpu_torch import spectral as tsp
from crlot_tpu_torch.convert import config_from_reference, spectral_from_reference
from crlot_tpu_torch.fft import fused_rt
from crlot_tpu_torch.fft.fused_rt import (
    fused_rt_supported,
    gemm_plan,
    pack_epilogue,
    roundtrip_signal_fused as t_fused,
)

NFFT, HOP, SR = 1024, 256, 48000


def _signal(seed, channels=1):
    """About 1 s of bin-centred cosines over a quiet noise floor. Zero-phase
    cosines with (length - 1) a multiple of N/2 are symmetric about both
    ends, so the reflect padding continues them exactly and every frame
    holds each tone in 3 bins: bin powers fall into two groups some 70 dB
    apart, and a gate threshold can sit in the gap."""
    rng = np.random.default_rng(seed)
    n = 94 * (NFFT // 2) + 1
    t = np.arange(n)
    x = np.zeros((channels, n))
    for c in range(channels):
        for k, a in ((20, 0.4), (57, 0.25), (160, 0.15), (301, 0.05)):
            x[c] += a * (1 - 0.3 * c) * np.cos(2 * np.pi * k * t / NFFT)
        x[c] += 1e-5 * rng.uniform(-1, 1, n)
    return x.astype(np.float32)


def _bin_powers_db(x, cfg, pre_gain=None):
    frames = pt.frame_signal(torch.from_numpy(x), cfg.frame_spec).double()
    spec = np.fft.rfft(frames.numpy() * pt.pipeline._window_f64(cfg), axis=-1)
    if pre_gain is not None:
        spec = spec * pre_gain
    return 10 * np.log10(np.abs(spec) ** 2 + 1e-30).ravel()


def _gap_threshold_db(db, lo=-60.0, hi=0.0):
    """Middle of the widest gap between bin powers inside [lo, hi] dB."""
    v = np.unique(np.concatenate([[lo, hi], db[(db > lo) & (db < hi)]]))
    i = int(np.argmax(np.diff(v)))
    assert v[i + 1] - v[i] >= 2.0, "no 2 dB gap for the gate threshold"
    thr = 0.5 * (v[i] + v[i + 1])
    assert (db < thr).any() and (db > thr).any()
    return float(thr)


def _noise_mag():
    return np.linspace(0.5, 0.05, NFFT // 2 + 1).astype(np.float32)


def _band():
    return dict(edges_hz=[500.0, 4000.0], gains=[0.5, 1.0, 0.25],
                sample_rate=SR, nfft=NFFT)


def _fn_params(kind, x, cfg):
    """(kind, params) for spectral_from_reference and the reference's
    constructor alike."""
    if kind == "noise_gate":
        thr = _gap_threshold_db(_bin_powers_db(x, cfg))
        return "noise_gate", dict(threshold_db=thr, attenuation_db=-40.0)
    if kind == "spectral_subtraction":
        return kind, dict(noise_mag=_noise_mag(), alpha=1.0, floor=0.05)
    if kind == "compose_band_gate":
        g = np.asarray(_band()["gains"])[
            np.searchsorted(_band()["edges_hz"],
                            np.arange(NFFT // 2 + 1) * SR / NFFT)]
        thr = _gap_threshold_db(_bin_powers_db(x, cfg, pre_gain=g))
        return "compose", dict(parts=[
            ("band_gain", _band()),
            ("noise_gate", dict(threshold_db=thr, attenuation_db=-30.0)),
        ])
    assert kind == "compose_gate_filter_gain"
    thr = _gap_threshold_db(_bin_powers_db(x, cfg))
    h = np.exp(-1j * np.pi * np.arange(NFFT // 2 + 1) * 3 / NFFT).astype(
        np.complex64)
    return "compose", dict(parts=[
        ("noise_gate", dict(threshold_db=thr)),
        ("per_bin_filter", dict(h=h)),
        ("gain", dict(g=0.7)),
    ])


def _reference_fn(kind, params):
    if kind == "compose":
        return jsp.compose(*(_reference_fn(k, p) for k, p in params["parts"]))
    if kind == "spectral_subtraction":
        params = dict(params, noise_mag=jnp.asarray(params["noise_mag"]))
    if kind == "per_bin_filter":
        params = dict(h=jnp.asarray(params["h"]))
    return getattr(jsp, kind)(**params)


KINDS = ["noise_gate", "spectral_subtraction", "compose_band_gate",
         "compose_gate_filter_gain"]


@pytest.mark.parametrize("kind", KINDS)
def test_b2_plain_vs_pallas_interpret(kind):
    x = _signal(seed=KINDS.index(kind))[0]
    jcfg = JStftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    cfg = config_from_reference(jcfg)
    fkind, params = _fn_params(kind, x, cfg)
    spec_ = cfg.frame_spec
    f = spec_.num_frames(x.shape[-1])
    full = (f - 1) * HOP + NFFT
    w64 = j_window_f64(jcfg)
    norm = j_norm_np(jcfg, f, full)
    padded = j_pad(jnp.asarray(x), spec_.pad_amount, spec_.pad_amount,
                   jcfg.frame_spec.pad_mode, 0.0)
    want = np.asarray(j_fused(
        padded, NFFT, HOP, f, w64, jnp.asarray(norm), jcfg.eps,
        interpret=True, spectral_packed=_reference_fn(fkind, params).packed,
    ))
    tfn = spectral_from_reference(fkind, **params)
    got = t_fused(
        torch.from_numpy(np.array(padded)), NFFT, HOP, f, w64,
        torch.from_numpy(norm), cfg.eps, spectral_packed=tfn.packed,
    ).numpy()
    assert got.shape == want.shape == (full,)
    # Compare the signal span: the center padding divides by the near-zero
    # edge norm and is cropped by every caller.
    pad = spec_.pad_amount
    crop = slice(pad, pad + x.shape[-1])
    assert np.max(np.abs(got[crop] - want[crop])) <= 1e-4


@pytest.mark.parametrize("kind", KINDS)
def test_b2_route_vs_reference_cpu_round_trip(kind):
    x = _signal(seed=10 + KINDS.index(kind), channels=2)
    jcfg = JStftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    cfg = config_from_reference(jcfg)
    fkind, params = _fn_params(kind, x[0], cfg)
    tfn = spectral_from_reference(fkind, **params)
    assert pt.formulation_for(cfg, tfn, x.shape[-1]) == "fused_rt_ola"
    got = pt.round_trip(torch.from_numpy(x), cfg, tfn).numpy()
    want = np.asarray(j_round_trip(jnp.asarray(x), jcfg,
                                   _reference_fn(fkind, params)))
    assert got.shape == x.shape
    assert np.max(np.abs(got - want)) <= 1e-5


def test_gate_does_gate():
    """The gap-placed threshold attenuates the noise floor and keeps the
    tones: the gated output is far from the input but close to the tones."""
    x = _signal(seed=3)
    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    _, params = _fn_params("noise_gate", x[0], cfg)
    y = pt.round_trip(torch.from_numpy(x), cfg, tsp.noise_gate(**params))
    err = (y.numpy() - x)[0]
    assert 1e-6 < np.sqrt(np.mean(err ** 2)) < 1e-5  # ~the removed floor


@pytest.mark.parametrize("make,code,scalars,n_bins", [
    (lambda: tsp.gain(0.5), tsp.OP_GAIN, (0.5,), 0),
    (lambda: tsp.band_gain([1000.0], [1.0, 0.5], SR, NFFT), tsp.OP_REAL_GAINS,
     (), 1),
    (lambda: tsp.per_bin_filter(np.full(NFFT // 2 + 1, 1 - 1j, np.complex64)),
     tsp.OP_COMPLEX, (), 2),
    (lambda: tsp.noise_gate(-30.0, -60.0), tsp.OP_GATE,
     (np.float32(1e-3), np.float32(1e-3)), 0),
    (lambda: tsp.spectral_subtraction(_noise_mag(), 1.5, 0.1),
     tsp.OP_SUBTRACT, (1.5, np.float32(0.1)), 1),
])
def test_epilogue_descriptor_per_menu_op(make, code, scalars, n_bins):
    k = NFFT // 2 + 1
    ops = tsp.epilogue_of(make())
    assert len(ops) == 1 and ops[0].code == code
    desc, params = pack_epilogue(ops, k)
    assert desc.tolist() == [[code, 0]]
    assert params.dtype == np.float32
    assert params.size == max(1, len(scalars) + n_bins * k)
    np.testing.assert_array_equal(params[: len(scalars)],
                                  np.asarray(scalars, np.float32))


def test_compose_concatenates_menus_and_offsets():
    k = NFFT // 2 + 1
    fn = tsp.compose(tsp.noise_gate(-30.0), tsp.band_gain([1e3], [1, 2], SR, NFFT),
                     tsp.spectral_subtraction(_noise_mag(), 1.0, 0.05))
    desc, params = pack_epilogue(tsp.epilogue_of(fn), k)
    assert desc.tolist() == [[tsp.OP_GATE, 0], [tsp.OP_REAL_GAINS, 2],
                             [tsp.OP_SUBTRACT, 2 + k]]
    assert params.size == 2 + k + 2 + k
    np.testing.assert_array_equal(params[2 + k + 2 :], _noise_mag())


def test_fn_without_menu_has_no_epilogue():
    def custom(spec):
        return spec

    custom.packed = lambda re, im: (re, im)
    assert tsp.epilogue_of(custom) is None
    assert tsp.epilogue_of(tsp.compose(tsp.noise_gate(-30.0), custom)) is None
    with pytest.raises(ValueError, match="K="):
        pack_epilogue(tsp.epilogue_of(tsp.spectral_subtraction(np.ones(7))), 513)


def test_b2_support_gate_matches_reference():
    from crlot_tpu.fft.pallas_rt import fused_rt_supported as j_supported

    for nfft in (256, 512, 768, 1024, 2048):
        for hop in (64, 128, 192, 256, 341, 512):
            assert fused_rt_supported(nfft, hop) == j_supported(nfft, hop)


# --- the GEMMs' launch plan (csrc/fused_rt.cu's rt_shape) -------------------

PLAN_N = (4, 8, 256, 512, 1024, 2048, 4096)
PLAN_ROWS = (1, 127, 128, 129, 511, 512, 11251, 720064)


def _tiles(plan, col_blocks, clusters):
    """[T, 2] (row block, column block) of every tile that the kernel's
    persistent loop stores with `clusters` clusters resident: cluster `cid`
    takes cluster tiles cid, cid + clusters, ...; cluster tile t is row
    group t // col_blocks at column block t % col_blocks, and CTA `rank` of
    the cluster takes that group's row block `rank`, storing nothing past
    the last row block."""
    out = []
    for cid in range(clusters):
        t = np.arange(cid, plan.row_groups * col_blocks, clusters)
        for rank in range(plan.cluster):
            rb = (t // col_blocks) * plan.cluster + rank
            keep = rb < plan.row_blocks
            out.append(np.stack([rb[keep], t[keep] % col_blocks], -1))
    return np.concatenate(out)


@pytest.mark.parametrize("nfft", PLAN_N)
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_gemm_plan_covers_every_tile_once(nfft, rows):
    plan = gemm_plan(rows, nfft)
    assert plan.row_blocks == -(-rows // 128)
    assert 1 <= plan.cluster <= plan.row_blocks
    assert plan.cluster == min(2, plan.row_blocks)
    kp = fused_rt.padded_bins(nfft)
    cols = (kp, nfft // 2 + 1)  # the forward's and the inverse's columns
    for cb, n_cols in zip(plan.col_blocks, cols):
        assert (cb - 1) * 64 < n_cols <= cb * 64
        for clusters in (1, 3, 32, 33):  # the cards' resident clusters vary
            got = _tiles(plan, cb, clusters)
            ids = got[:, 0] * cb + got[:, 1]
            assert len(ids) == plan.row_blocks * cb
            assert np.array_equal(np.sort(ids),
                                  np.arange(plan.row_blocks * cb))


@pytest.mark.parametrize("nfft", PLAN_N)
def test_gemm_plan_last_stage_issues_the_steps_with_bins(nfft):
    """The k8 steps issued cover Kp, and Kp's last 8 floats hold a bin."""
    plan = gemm_plan(720064, nfft)
    kp, k = fused_rt.padded_bins(nfft), nfft // 2 + 1
    steps = 4 * (plan.k_stages - 1) + plan.k_last
    assert 1 <= plan.k_last <= 4
    assert 8 * steps == kp
    assert 8 * (steps - 1) < k <= 8 * steps
    assert (plan.k_stages - 1) * 32 < kp <= plan.k_stages * 32


def test_gemm_plan_at_the_gate_batch():
    plan = gemm_plan(64 * 11251, 1024)
    assert plan == fused_rt.GemmPlan(
        cluster=2, stage_bytes=48 * 1024, k_stages=17, k_last=1,
        row_blocks=5626, row_groups=2813, col_blocks=(9, 9))


@pytest.mark.parametrize("rows,cluster,stage_kb", [
    (128, 1, 64), (129, 2, 48), (511, 2, 48), (11251, 2, 48)])
def test_gemm_plan_stage_bytes(rows, cluster, stage_kb):
    """Two 16 KB A tiles of the CTA's own and 1 / cluster of the four 8 KB
    basis tiles from L2 a stage."""
    plan = gemm_plan(rows, 1024)
    assert (plan.cluster, plan.stage_bytes) == (cluster, stage_kb * 1024)


@pytest.mark.parametrize("channels,samples,cluster", [
    (1, 20000, 1), (1, 48000, 2), (64, 48000, 2)])
def test_kernels_span_records_the_gemm_plan(monkeypatch, channels, samples,
                                            cluster):
    """Under a fake launch, the `crlot.fused_rt.kernels` span of a gate
    call carries the GEMMs' cluster and L2 bytes a CTA stage."""
    from crlot_tpu_torch import cuda_build, profiling

    launched = []
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, device, *a: launched.append(name))
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    x = torch.empty((channels, samples), device="meta")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pt.round_trip(x, cfg, tsp.noise_gate(-45.0))
    assert "crlot_rt_frames" in launched
    rec = [r for r in profiling.span_log()
           if r.name == "crlot.fused_rt.kernels"][-1]
    plan = gemm_plan(channels * cfg.frame_spec.num_frames(samples), NFFT)
    assert plan.cluster == cluster
    assert (rec.attrs["cluster"], rec.attrs["stage_bytes"]) == (
        cluster, plan.stage_bytes)
