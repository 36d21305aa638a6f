"""The B3 route (frames-level fused round-trip, no OLA): the port's plain
version vs the reference's Pallas kernel (interpret mode) and vs a float64
numpy oracle, its argument checks, and `round_trip` with
`cfg.fused_roundtrip` vs the reference's CPU `round_trip`.

Tolerances: the Pallas kernel emulates fp32 products with 3 bf16 passes
(the reference's HIGH tier, `tests/test_pallas_rt.py`), so the port is held
to max-abs <= 1e-4 against it; against the float64 oracle and the
reference's CPU `round_trip` (fp32 FFTs) to max-abs <= 1e-5. The
noise-gate threshold sits in a 2 dB gap of the input's bin powers, as in
`test_torch_fused_rt.py`, so no bin can flip between the two packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu.core.padding import pad_signal as j_pad
from crlot_tpu.core.types import StftConfig as JStftConfig
from crlot_tpu.fft.pallas_rt import roundtrip_frames_fused as j_frames
from crlot_tpu.pipeline import _window_f64 as j_window_f64
from crlot_tpu.pipeline import round_trip as j_round_trip

import crlot_tpu_torch as pt
from crlot_tpu_torch import pipeline as tpipe
from crlot_tpu_torch import spectral as tsp
from crlot_tpu_torch.convert import config_from_reference, spectral_from_reference
from crlot_tpu_torch.fft.fused_rt import (
    roundtrip_frames_cuda,
    roundtrip_frames_fused,
    roundtrip_frames_plain,
)

from test_torch_fused_rt import KINDS, _fn_params, _reference_fn, _signal

N_FRAMES = 21


def _padded(nfft, hop, seed, n_frames=N_FRAMES):
    """A centered, reflect-padded uniform-noise signal of n_frames frames,
    as the reference pads it, and its config."""
    jcfg = JStftConfig(frame_size=nfft, hop_size=hop, center=True)
    n = (n_frames - 1) * hop
    x = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    pad = jcfg.frame_spec.pad_amount
    padded = np.array(j_pad(jnp.asarray(x), pad, pad,
                            jcfg.frame_spec.pad_mode, 0.0))
    assert jcfg.frame_spec.num_frames(n) == n_frames
    return padded, jcfg


def _port(padded, nfft, hop, jcfg, spectral_packed=None, n_frames=N_FRAMES):
    return roundtrip_frames_fused(
        torch.from_numpy(padded), nfft, hop, n_frames, j_window_f64(jcfg),
        spectral_packed=spectral_packed,
    ).numpy()


@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 128), (1024, 256)])
def test_b3_plain_identity_vs_pallas_interpret(nfft, hop):
    padded, jcfg = _padded(nfft, hop, seed=nfft)
    want = np.asarray(j_frames(jnp.asarray(padded), nfft, hop, N_FRAMES,
                               j_window_f64(jcfg), interpret=True))
    got = _port(padded, nfft, hop, jcfg)
    assert got.shape == want.shape == (N_FRAMES, nfft)
    assert np.max(np.abs(got - want)) <= 1e-4


@pytest.mark.parametrize("kind", KINDS)
def test_b3_plain_menu_vs_pallas_interpret(kind):
    nfft, hop = 1024, 256
    x = _signal(seed=20 + KINDS.index(kind))[0]
    jcfg = JStftConfig(frame_size=nfft, hop_size=hop, center=True)
    cfg = config_from_reference(jcfg)
    fkind, params = _fn_params(kind, x, cfg)
    pad = jcfg.frame_spec.pad_amount
    padded = np.array(j_pad(jnp.asarray(x), pad, pad,
                            jcfg.frame_spec.pad_mode, 0.0))
    want = np.asarray(j_frames(
        jnp.asarray(padded), nfft, hop, N_FRAMES, j_window_f64(jcfg),
        interpret=True, spectral_packed=_reference_fn(fkind, params).packed,
    ))
    tfn = spectral_from_reference(fkind, **params)
    got = _port(padded, nfft, hop, jcfg, tfn.packed)
    assert got.shape == want.shape == (N_FRAMES, nfft)
    assert np.max(np.abs(got - want)) <= 1e-4


@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 128), (1024, 256)])
@pytest.mark.parametrize("fn", ["identity", "fir"])
def test_b3_plain_vs_float64_oracle(nfft, hop, fn):
    padded, jcfg = _padded(nfft, hop, seed=nfft + 1)
    w = j_window_f64(jcfg)
    resp = np.ones(nfft // 2 + 1, np.complex128)
    tfn = None
    if fn == "fir":
        resp = tsp.fir_frequency_response(np.hanning(31) / 15.0, nfft)
        tfn = tsp.per_bin_filter(resp)
        resp = resp.astype(np.complex128)
    idx = np.arange(N_FRAMES)[:, None] * hop + np.arange(nfft)[None, :]
    frames = padded.astype(np.float64)[idx] * w
    want = np.fft.irfft(np.fft.rfft(frames, axis=-1) * resp, n=nfft, axis=-1)
    got = _port(padded, nfft, hop, jcfg, tfn.packed if tfn else None)
    assert np.max(np.abs(got - want)) <= 1e-5


def test_b3_zero_pads_a_short_signal():
    """Frames reaching past the signal read zeros, as the reference's
    `_rt_call` pads: the last frames of a signal cut short."""
    nfft, hop = 512, 128
    padded, jcfg = _padded(nfft, hop, seed=5)
    short = padded[: padded.size - 300]
    zeros = np.concatenate([short, np.zeros(300, np.float32)])
    got = _port(short, nfft, hop, jcfg)
    np.testing.assert_array_equal(got, _port(zeros, nfft, hop, jcfg))
    want = np.asarray(j_frames(jnp.asarray(short), nfft, hop, N_FRAMES,
                               j_window_f64(jcfg), interpret=True))
    assert np.max(np.abs(got - want)) <= 1e-4
    # Frames wholly past the end are exact zeros.
    few = _port(short[: 2 * hop], nfft, hop, jcfg, n_frames=4)
    assert few.shape == (4, nfft) and not few[2:].any()


def test_b3_refusals():
    w64 = np.hanning(1024)
    x = torch.zeros((1, 8192))
    with pytest.raises(ValueError, match="unsupported"):
        roundtrip_frames_fused(x, 1024, 192, 4, w64)
    w32 = torch.ones(1024)
    with pytest.raises(ValueError, match="CUDA"):
        roundtrip_frames_cuda(x, 1024, 256, 4, w32)
    with pytest.raises(ValueError, match="CUDA"):
        roundtrip_frames_fused(torch.zeros((1, 8192), device="meta"),
                               1024, 256, 4, w64)

    def custom(spec):
        return spec

    custom.packed = lambda re, im: (re, im)
    with pytest.raises(ValueError, match="epilogue menu"):
        roundtrip_frames_cuda(x, 1024, 256, 4, w32, custom.packed)
    # The plain version runs any packed fn.
    y = roundtrip_frames_fused(x, 1024, 256, 4, w64, custom.packed)
    assert y.shape == (1, 4, 1024)


@pytest.mark.parametrize("nfft,hop,synthesis", [
    (1024, 256, False), (512, 128, False), (512, 128, True),
])
def test_fused_roundtrip_vs_reference_cpu_round_trip(nfft, hop, synthesis,
                                                     monkeypatch):
    jcfg = JStftConfig(frame_size=nfft, hop_size=hop, center=True,
                       synthesis_window=synthesis, fused_roundtrip=True)
    cfg = config_from_reference(jcfg)
    x = np.random.default_rng(nfft + hop).uniform(-1, 1, (2, 12000)).astype(
        np.float32)
    assert pt.formulation_for(cfg, None, x.shape[-1]) == "fused_rt_frames"
    calls = []

    def spy(name, fn):
        def f(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return f

    monkeypatch.setattr(tpipe, "roundtrip_frames_fused",
                        spy("B3", tpipe.roundtrip_frames_fused))
    monkeypatch.setattr(tpipe, "ola_normalized_auto",
                        spy("B1", tpipe.ola_normalized_auto))
    got = pt.round_trip(torch.from_numpy(x), cfg).numpy()
    assert calls == ["B3", "B1"]
    want = np.asarray(j_round_trip(jnp.asarray(x), jcfg))
    assert got.shape == x.shape
    assert np.max(np.abs(got - want)) <= 1e-5
    assert pt.snr_db(x, got) > 60.0


def test_fused_roundtrip_gate_follows_reference():
    """The flag applies only to the identity with a matmul backend, HIGH
    precision and a B3 geometry; otherwise the usual routes."""
    base = dict(frame_size=1024, hop_size=256, center=True,
                fused_roundtrip=True)
    n = 12000
    assert pt.formulation_for(pt.StftConfig(**base), None, n) == "fused_rt_frames"
    for kw in (dict(fft_backend=pt.FftBackend.XLA),
               dict(fft_precision=pt.FftPrecision.HIGHEST),
               dict(hop_size=64)):
        route = pt.formulation_for(pt.StftConfig(**dict(base, **kw)), None, n)
        assert route != "fused_rt_frames", kw
    band = tsp.band_gain([1000.0], [1.0, 0.5], 48000, 1024)
    assert pt.formulation_for(pt.StftConfig(**base), band, n) == "blocked"


def test_b2_plain_is_b3_plain_then_ola():
    """B2's plain version is B3's plain frames through the plain OLA and
    divide, bit for bit: the order that lets B3 + OLA match B2 on the card."""
    from crlot_tpu_torch.fft.fused_rt import roundtrip_signal_plain
    from crlot_tpu_torch.ola.reference import normalize, overlap_add

    nfft, hop = 1024, 256
    padded, jcfg = _padded(nfft, hop, seed=9)
    cfg = config_from_reference(jcfg)
    full = (N_FRAMES - 1) * hop + nfft
    norm = torch.from_numpy(tpipe._norm_np(cfg, N_FRAMES, full).astype(np.float32))
    w32 = torch.from_numpy(j_window_f64(jcfg).astype(np.float32))
    gate = tsp.noise_gate(-30.0)
    x = torch.from_numpy(padded)
    frames = roundtrip_frames_plain(x, nfft, hop, N_FRAMES, w32, gate.packed)
    want = normalize(overlap_add(frames, hop, full), norm, cfg.eps)
    got = roundtrip_signal_plain(x, nfft, hop, N_FRAMES, w32, norm, cfg.eps,
                                 full, gate.packed)
    assert torch.equal(got, want)
