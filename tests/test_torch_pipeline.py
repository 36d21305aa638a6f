"""The port's pipeline vs the reference on the CPU, at small sizes.

* The blocked branch (identity and fixed responses) against the reference's
  `blocked_composed_round_trip`: max-abs <= 1e-5 (fp32 products summed in
  another order; the reference's own CPU tests allow 2e-6 between batch
  sizes).
* The reference's >60 dB round-trip gate, on every route.
* `formulation_for` names the branch the reference's ACCELERATOR takes: the
  reference is run with its backend reported as "tpu" and each branch's
  entry point replaced by a probe that records the branch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import crlot_tpu.fft.int8_backend as ji8
import crlot_tpu.fft.matmul_backend as jmm
import crlot_tpu.fft.pallas_rt as jrt
import crlot_tpu.pipeline as jpipe
import crlot_tpu.spectral as jsp
from crlot_tpu.core.types import (
    FftBackend as JFftBackend,
    FftPrecision as JFftPrecision,
    StftConfig as JStftConfig,
)
from crlot_tpu.io.wav import read_wav as j_read_wav, write_wav as j_write_wav

import crlot_tpu_torch as pt
from crlot_tpu_torch import spectral as tsp
from crlot_tpu_torch.convert import config_from_reference

SR = 48000


def _x(seed, channels=2, n=SR):
    return np.random.default_rng(seed).uniform(-1, 1, (channels, n)).astype(
        np.float32)


def _band_args(nfft):
    return ([500.0, 4000.0], [0.5, 1.0, 0.25], SR, nfft)


@pytest.mark.parametrize("nfft,hop", [(1024, 256), (512, 128)])
@pytest.mark.parametrize("fn", ["identity", "band_gain", "fir"])
@pytest.mark.parametrize("synthesis", [False, True])
def test_blocked_matches_reference(nfft, hop, fn, synthesis):
    jcfg = JStftConfig(frame_size=nfft, hop_size=hop, center=True,
                       synthesis_window=synthesis)
    cfg = config_from_reference(jcfg)
    k = nfft // 2 + 1
    if fn == "identity":
        per_bin = np.ones(k)
    elif fn == "band_gain":
        per_bin = tsp.resolve_per_bin_response(tsp.band_gain(*_band_args(nfft)),
                                               nfft)
    else:
        per_bin = tsp.fir_frequency_response(np.hanning(31) / 15.0, nfft)
    x = _x(nfft + hop, n=SR // 2)
    got = pt.pipeline.blocked_composed_round_trip(
        torch.from_numpy(x), cfg, per_bin).numpy()
    want = np.asarray(jpipe.blocked_composed_round_trip(
        jnp.asarray(x), jcfg, per_bin))
    assert got.shape == want.shape == x.shape
    assert np.max(np.abs(got - want)) <= 1e-5


def test_round_trip_identity_and_eq_routes():
    x = _x(1)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    y = pt.round_trip(torch.from_numpy(x), cfg)
    assert y.shape == x.shape and pt.snr_db(x, y) >= 60.0
    band = tsp.band_gain(*_band_args(1024))
    y_eq = pt.round_trip(torch.from_numpy(x), cfg, band).numpy()
    jcfg = JStftConfig(frame_size=1024, hop_size=256, center=True)
    want = np.asarray(jpipe.round_trip(jnp.asarray(x), jcfg,
                                       jsp.band_gain(*_band_args(1024))))
    assert np.max(np.abs(y_eq - want)) <= 1e-5


@pytest.mark.parametrize("nfft,hop", [(1024, 256), (512, 128), (256, 64)])
def test_stft_istft_round_trip(nfft, hop):
    x = _x(2)
    cfg = pt.StftConfig(frame_size=nfft, hop_size=hop, center=True)
    spec = pt.stft(torch.from_numpy(x), cfg)
    assert spec.dtype == torch.complex64
    assert spec.shape == (2, cfg.frame_spec.num_frames(SR), nfft // 2 + 1)
    y = pt.istft(spec, cfg, length=SR)
    assert pt.snr_db(x, y) >= 60.0
    jcfg = JStftConfig(frame_size=nfft, hop_size=hop, center=True)
    jspec = np.asarray(jpipe.stft(jnp.asarray(x), jcfg))
    assert np.max(np.abs(spec.numpy() - jspec)) <= 1e-4 * np.max(np.abs(jspec))


def test_round_trip_noise_gate_and_packed_parts():
    x = _x(3)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    gate = tsp.noise_gate(-30.0)
    y = pt.round_trip(torch.from_numpy(x), cfg, gate)
    assert pt.snr_db(x, y) >= 60.0

    def same_gate_without_menu(spec):
        return gate(spec)

    same_gate_without_menu.packed = lambda re, im: gate.packed(re, im)
    assert pt.formulation_for(cfg, same_gate_without_menu, SR) == "packed_parts"
    y2 = pt.round_trip(torch.from_numpy(x), cfg, same_gate_without_menu)
    np.testing.assert_allclose(y2.numpy(), y.numpy(), rtol=0, atol=1e-6)


class _Branch(Exception):
    pass


@pytest.fixture
def reference_accelerator_branch(monkeypatch):
    """Run the reference's round_trip as its accelerator would, returning
    the name of the branch it enters."""
    taken = []

    def probe(name):
        def f(*a, **k):
            raise _Branch(name)
        return f

    def fused_probe(padded, *a, **k):
        taken.append("fused_rt_ola")  # the caller swallows exceptions
        return padded

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpipe, "blocked_composed_round_trip", probe("blocked"))
    monkeypatch.setattr(jrt, "roundtrip_signal_fused", fused_probe)
    monkeypatch.setattr(jmm, "rfft_folded_tiled_parts", probe("packed_parts"))
    monkeypatch.setattr(jmm, "roundtrip_composed_matmul", probe("composed"))
    monkeypatch.setattr(jmm, "roundtrip_folded_tiled", probe("tiled"))
    monkeypatch.setattr(ji8, "roundtrip_folded_tiled_i8", probe("tiled_i8"))
    monkeypatch.setattr(jmm, "roundtrip_folded_matmul", probe("folded"))
    monkeypatch.setattr(jmm, "roundtrip_packed_matmul", probe("packed"))
    monkeypatch.setattr(jpipe, "stft", probe("stft_istft"))

    def run(jcfg, fn, n):
        taken.clear()
        try:
            jpipe.round_trip(jnp.zeros((2, n), jnp.float32), jcfg, fn)
        except _Branch as b:
            return b.args[0]
        assert taken, "no branch recorded"
        return taken[0]

    return run


def _fns(nfft):
    """(name, reference fn, port fn) for the slice's spectral fns."""
    k = nfft // 2 + 1
    h = tsp.fir_frequency_response(np.hanning(31) / 15.0, nfft)
    nm = np.full(k, 0.1, np.float32)

    def exotic(spec):
        return spec

    def t_exotic(spec):
        return spec

    exotic.packed = lambda re, im: (re, im)
    t_exotic.packed = lambda re, im: (re, im)
    return [
        ("identity", None, None),
        ("gain", jsp.gain(0.5), tsp.gain(0.5)),
        ("band_gain", jsp.band_gain(*_band_args(nfft)),
         tsp.band_gain(*_band_args(nfft))),
        ("fir", jsp.per_bin_filter(jnp.asarray(h)), tsp.per_bin_filter(h)),
        ("noise_gate", jsp.noise_gate(-30.0), tsp.noise_gate(-30.0)),
        ("subtraction", jsp.spectral_subtraction(jnp.asarray(nm), 1.0, 0.05),
         tsp.spectral_subtraction(nm, 1.0, 0.05)),
        ("compose", jsp.compose(jsp.band_gain(*_band_args(nfft)),
                                jsp.noise_gate(-30.0)),
         tsp.compose(tsp.band_gain(*_band_args(nfft)), tsp.noise_gate(-30.0))),
        ("exotic_packed", exotic, t_exotic),
        ("opaque", lambda s: s, lambda s: s),
    ]


@pytest.mark.parametrize("cfg_kw", [
    dict(frame_size=1024, hop_size=256, center=True),
    dict(frame_size=1024, hop_size=256, center=True, synthesis_window=True),
    dict(frame_size=1024, hop_size=256, center=True,
         fft_precision="highest"),
    dict(frame_size=1024, hop_size=256, center=True, fft_backend="xla"),
    dict(frame_size=512, hop_size=128, center=False),
    dict(frame_size=960, hop_size=240, center=True),
    dict(frame_size=960, hop_size=240, center=True, synthesis_window=True),
    dict(frame_size=1024, hop_size=480, center=True),
    dict(frame_size=1024, hop_size=480, center=True, fft_precision="int8x2"),
    dict(frame_size=1000, hop_size=250, center=True,
         fft_precision="highest"),
])
def test_formulation_matches_reference_accelerator(cfg_kw,
                                                   reference_accelerator_branch):
    kw = dict(cfg_kw)
    if "fft_precision" in kw:
        kw["fft_precision"] = JFftPrecision(kw["fft_precision"])
    if "fft_backend" in kw:
        kw["fft_backend"] = JFftBackend(kw["fft_backend"])
    jcfg = JStftConfig(**kw)
    cfg = config_from_reference(jcfg)
    for n in (SR, 4000, 1200):
        for name, jfn, tfn in _fns(jcfg.frame_size):
            want = reference_accelerator_branch(jcfg, jfn, n)
            got = pt.formulation_for(cfg, tfn, n)
            if name == "exotic_packed" and want == "fused_rt_ola":
                # The Pallas kernel traces any packed fn; B2 runs a fixed
                # menu, so a fn outside it is routed up front to the parts.
                want = "packed_parts"
            assert got == want, (name, n, cfg_kw)


def test_fused_roundtrip_flag_refused():
    """The flag is no longer refused: the identity takes the frames-level
    fused route (B3 + B1); a spectral fn ignores the flag, as in the
    reference."""
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True,
                        fused_roundtrip=True)
    assert pt.formulation_for(cfg, None, 4096) == "fused_rt_frames"
    assert pt.formulation_for(cfg, tsp.noise_gate(-30.0), 4096) == "fused_rt_ola"
    x = _x(5, channels=1, n=4096)[0]
    y = pt.round_trip(torch.from_numpy(x), cfg)
    assert y.shape == x.shape and pt.snr_db(x, y) >= 60.0


def test_wav_round_trip_matches_reference(tmp_path):
    """The verify drive, WAV -> round_trip -> WAV, with the port's numpy
    WAV codec writing the same bytes as the reference's."""
    x = 0.5 * _x(4, n=SR // 4)
    jp, tp = tmp_path / "j.wav", tmp_path / "t.wav"
    j_write_wav(str(jp), x, SR, bits=16)
    pt.write_wav(str(tp), x, SR, bits=16)
    assert jp.read_bytes() == tp.read_bytes()
    data, sr = pt.read_wav(str(tp))
    jdata, _ = j_read_wav(str(jp))
    np.testing.assert_array_equal(data, jdata)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    y = pt.round_trip(torch.from_numpy(data), cfg)
    assert sr == SR and pt.snr_db(data, y) >= 60.0
    pt.write_wav(str(tmp_path / "y.wav"), y.numpy(), sr, bits=16)
    assert pt.snr_db(data, pt.read_wav(str(tmp_path / "y.wav"))[0]) >= 60.0


def test_composed_matmul_and_scrub_match_reference():
    """The composed frame map (one [N, N] product per frame) and the
    library-FFT scrub contract, against the reference on the CPU."""
    from crlot_tpu.fft import xla_backend as jxla
    from crlot_tpu_torch.fft import xla_backend as txla
    from crlot_tpu_torch.fft.matmul_backend import roundtrip_composed_matmul

    nfft = 512
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((2, 9, nfft)).astype(np.float32)
    w64 = pt.get_window(pt.WindowType.HANN, nfft, dtype=np.float64)
    resp = tsp.fir_frequency_response(np.hanning(31) / 15.0, nfft)
    got = roundtrip_composed_matmul(torch.from_numpy(frames), nfft, w64, resp,
                                    w64).numpy()
    want = np.asarray(jmm.roundtrip_composed_matmul(
        jnp.asarray(frames), nfft, w64, resp, w64))
    assert np.max(np.abs(got - want)) <= 1e-5

    x = rng.standard_normal((3, nfft)).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, 1e-31]
    spec = txla.rfft(torch.from_numpy(x), nfft)
    jspec = np.asarray(jxla.rfft(x, nfft))
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=0, atol=1e-4)
    y = txla.irfft(spec, nfft).numpy()
    np.testing.assert_allclose(y, np.asarray(jxla.irfft(jspec, nfft)),
                               rtol=0, atol=1e-6)
    assert np.isfinite(y).all()
