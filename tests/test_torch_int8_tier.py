"""The INT8X2 tier of the port (`fft/int8_backend.py`, K11's reference
variant and the "tiled_i8" / "tiled" routes) against the JAX reference.

The first ten tests mirror `tests/test_fft_int8.py` with its seeds and
gates (74 dB, 70 dB with gains, 62 dB composed, 60 dB for the pipeline) on
the port. Then parity case by case: the quantized bases byte for byte, the
dynamic quantization and `dot_i8x2` bit for bit against the reference as
XLA jit-compiles it (ROADMAP C8: the eager reference divides where the jit
multiplies by a reciprocal, and differs in a stated fraction), the tiled
parts and round-trips within stated bounds (their f32 border sums run in
another order), and the routes of `round_trip` at N = 1024, H = 480 against
the reference's tiled round-trips plus its OLA. On the CPU, K11 is its
plain version; the kernel's launches are checked on meta tensors with a
recorded fake launch.
"""

from __future__ import annotations

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crlot_tpu.fft.int8_backend as jib
import crlot_tpu.fft.matmul_backend as jmm
from crlot_tpu.core.types import FftPrecision as JPrec
from crlot_tpu.core.types import StftConfig as JCfg
from crlot_tpu.frame.framing import frame_signal as j_frame_signal
from crlot_tpu.ola.fused import ola_normalized_auto as j_ola
from crlot_tpu.pipeline import _norm_np as j_norm_np
from crlot_tpu.window.windows import get_window as j_get_window

import crlot_tpu_torch as pt
from crlot_tpu_torch import cuda_build
from crlot_tpu_torch import int8_gemm as b6
from crlot_tpu_torch.core.types import WindowType
from crlot_tpu_torch.fft import int8_backend as ib
from crlot_tpu_torch.fft import matmul_backend as mb
from crlot_tpu_torch.window.windows import get_window

QMAX = ib.QMAX


def _snr(ref, test):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    return 10 * np.log10(np.sum(ref**2) / max(np.sum(err**2), 1e-300))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hann(nfft):
    return get_window(WindowType.HANN, nfft, True, dtype=np.float64)


# --- the reference's int8 tests, on the port ---------------------------------


def test_basis_limb_split_exact():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((257, 130)) * 10 ** rng.uniform(-3, 3, (1, 130))
    hi, lo, cs = ib.quantize_basis(b)
    assert hi.dtype == np.int8 and lo.dtype == np.int8
    recon = (hi.astype(np.float64) * 128 + lo) * cs.astype(np.float64)
    err = np.abs(recon - b)
    assert np.all(err <= (0.5 + QMAX * 2.0**-24) * cs + 1e-12)
    q = hi.astype(np.float64) * 128 + lo
    assert np.abs(q).max() <= QMAX


def test_dynamic_quantization_exact_split():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((16, 640)) * 10 ** rng.uniform(-4, 1)).astype(
        np.float32)
    hi, lo, s = (t.numpy() for t in ib._quantize_dynamic(_t(x)))
    q = hi.astype(np.float64) * 128 + lo
    assert np.abs(q).max() <= QMAX
    row_max = np.abs(x).max(axis=-1)
    live = row_max > 0
    assert np.all(np.abs(q[live]).max(axis=-1) >= QMAX - 1)
    recon = q * s
    assert np.abs(recon - x).max() <= 0.5 * s.max() + 1e-12


def test_zero_rows_are_safe():
    x = torch.zeros((4, 512))
    hi, lo, s = ib._quantize_dynamic(x)
    assert not hi.any() and not lo.any()
    y = ib.dot_i8x2(x, ib.quantize_basis(np.eye(512)))
    assert torch.isfinite(y).all() and not y.any()


def test_dot_snr_vs_f64():
    rng = np.random.default_rng(2)
    b = rng.standard_normal((512, 512))
    x = rng.standard_normal((256, 512)).astype(np.float32)
    y = ib.dot_i8x2(_t(x), ib.quantize_basis(b))
    assert _snr(x.astype(np.float64) @ b, y) > 74


@pytest.mark.parametrize("nfft", [512, 1024, 2048, 4096])
def test_roundtrip_snr(nfft):
    assert ib.int8_supported(nfft)
    rng = np.random.default_rng(3)
    w = _hann(nfft)
    fr = rng.uniform(-1, 1, (32, nfft)).astype(np.float32)
    out = ib.roundtrip_folded_tiled_i8(_t(fr), nfft, w)
    assert _snr(fr.astype(np.float64) * w, out) > 74


def test_roundtrip_snr_per_frame_headroom():
    """A 60 dB frame-amplitude spread must not cost SNR (per-row scales)."""
    nfft = 1024
    rng = np.random.default_rng(4)
    w = _hann(nfft)
    fr = rng.uniform(-1, 1, (64, nfft))
    fr *= 10 ** np.linspace(-3, 0, 64)[:, None]
    fr = fr.astype(np.float32)
    out = ib.roundtrip_folded_tiled_i8(_t(fr), nfft, w)
    assert _snr(fr.astype(np.float64) * w, out) > 74


def test_roundtrip_with_per_bin_gains():
    nfft = 1024
    rng = np.random.default_rng(5)
    w = _hann(nfft)
    g = 10 ** rng.uniform(-1, 1, nfft // 2 + 1)
    fr = rng.uniform(-1, 1, (32, nfft)).astype(np.float32)
    out = ib.roundtrip_folded_tiled_i8(_t(fr), nfft, w, per_bin_gains_f64=g)
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1) * g
    ref = np.fft.irfft(spec, n=nfft, axis=-1)
    assert _snr(ref, out) > 70


def test_roundtrip_synthesis_window():
    nfft = 512
    rng = np.random.default_rng(6)
    w = _hann(nfft)
    fr = rng.uniform(-1, 1, (16, nfft)).astype(np.float32)
    out = ib.roundtrip_folded_tiled_i8(_t(fr), nfft, w,
                                       synthesis_window_f64=w)
    assert _snr(fr.astype(np.float64) * w * w, out) > 74


def test_pipeline_accepts_int8_tier():
    """INT8X2 through the public config: at (1024, 256) the blocked route,
    which runs the tier as HIGH, above the 60 dB gate."""
    cfg = pt.StftConfig(frame_size=1024, hop_size=256,
                        fft_precision=pt.FftPrecision.INT8X2)
    rng = np.random.default_rng(7)
    sig = rng.uniform(-1, 1, 48000).astype(np.float32)
    assert pt.formulation_for(cfg, None, sig.size) == "blocked"
    out = pt.round_trip(sig, cfg, device="cpu").numpy()
    body = slice(1024, 48000 - 1024)
    assert _snr(sig[body], out[body]) > 60


def test_composed_i8_matches_oracle():
    nfft = 1024
    rng = np.random.default_rng(8)
    w = _hann(nfft)
    k = np.arange(nfft // 2 + 1)
    g = (10 ** rng.uniform(-0.5, 0.5, nfft // 2 + 1)) * np.exp(
        -2j * np.pi * k * 3 / nfft)
    fr = rng.uniform(-1, 1, (16, nfft)).astype(np.float32)
    out = ib.roundtrip_composed_i8(_t(fr), nfft, w, g)
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1) * g
    ref = np.fft.irfft(spec, n=nfft, axis=-1)
    assert _snr(ref, out) > 62


# --- parity with the reference, case by case ---------------------------------


@pytest.mark.parametrize("nfft", [256, 1024, 4096])
def test_quantized_tiled_bases_byte_identical(nfft):
    """The port's tiled constants and their quantized limbs and column
    scales are the reference's, byte for byte (gained inverse too)."""
    for a, b in zip(mb._tiled_consts(nfft), jmm._tiled_consts(nfft)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got, want = ib._tiled_consts_i8(nfft), jib._tiled_consts_i8(nfft)
    for qa, qb in zip(got[:4], want[:4]):
        for a, b in zip(qa, qb):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    g = np.random.default_rng(nfft).uniform(0.1, 2.0, nfft // 2 + 1)
    gb = g.tobytes()
    got = ib._tiled_inverse_gained_i8(nfft, gb)
    want = jib._tiled_inverse_gained_i8(nfft, gb)
    for qa, qb in zip(got[:2], want[:2]):
        for a, b in zip(qa, qb):
            assert a.tobytes() == b.tobytes()
    assert got[2].tobytes() == want[2].tobytes() and got[3] == want[3]


def test_quantize_basis_byte_identical_on_random_bases():
    rng = np.random.default_rng(11)
    for shape in [(257, 130), (511, 511), (1024, 64)]:
        b = rng.standard_normal(shape) * 10 ** rng.uniform(-3, 3, shape[1])
        b[:, 3] = 0.0  # a zero column: its scale is 1 / QMAX
        for a, c in zip(ib.quantize_basis(b), jib.quantize_basis(b)):
            assert a.dtype == c.dtype and a.tobytes() == c.tobytes()


def _rows(seed, shape=(64, 512)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10 ** rng.uniform(-4, 1, (shape[0], 1))
    x[3] = 0.0
    x[5, 7] = 1e-33  # amax below the 1e-30 floor
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [1, 12, 13])
def test_dynamic_quantization_equals_the_jitted_reference(seed):
    """Limbs and scales bit for bit against `jax.jit(_quantize_dynamic)`:
    s = max(amax, 1e-30) * f32(1/QMAX) (XLA folds the division by the
    constant), q = rint(x * f32(1/s)) (kept as written)."""
    x = _rows(seed)
    want = [np.asarray(a) for a in jax.jit(jib._quantize_dynamic)(x)]
    got = [a.numpy() for a in ib._quantize_dynamic(_t(x))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dynamic_quantization_vs_the_eager_reference():
    """Op by op, XLA divides amax by QMAX (IEEE): the scales differ from the
    jitted fold in about 4 % of rows by one ulp, and the limbs in well under
    1e-4 of the values (ROADMAP C8's note)."""
    x = _rows(14, (4096, 512))
    hi, lo, s = (np.asarray(a) for a in jib._quantize_dynamic(jnp.asarray(x)))
    ghi, glo, gs = (a.numpy() for a in ib._quantize_dynamic(_t(x)))
    s_frac = np.mean(gs != s)
    q_frac = np.mean((ghi.astype(np.int32) * 128 + glo)
                     != (hi.astype(np.int32) * 128 + lo))
    assert 0.0 < s_frac < 0.1
    assert q_frac < 1e-4
    np.testing.assert_allclose(gs, s, rtol=2.0**-23, atol=0)


@pytest.mark.parametrize("k,n", [(512, 512), (511, 511), (1024, 1024),
                                 (100, 70)])
def test_dot_i8x2_equals_the_jitted_reference(k, n):
    """`dot_i8x2` bit for bit against the jitted reference: the same limbs,
    exact int32 products, and the epilogue's f32 steps in its order. K and
    N off 64 are padded with zero rows and columns and sliced."""
    rng = np.random.default_rng(k + n)
    b = rng.standard_normal((k, n))
    x = _rows(k, (48, k))
    qb_t, qb_j = ib.quantize_basis(b), jib.quantize_basis(b)
    want = np.asarray(jax.jit(jib.dot_i8x2, static_argnums=())(
        jnp.asarray(x), qb_j))
    got = ib.dot_i8x2(_t(x), qb_t)
    assert got.shape == (48, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dot_i8x2_leading_axes_and_operands_layout():
    """[..., K] operands keep their leading axes; the kernel's operands are
    the limbs transposed, K-contiguous, zero-padded to 64, made once."""
    rng = np.random.default_rng(21)
    b = rng.standard_normal((511, 511))
    qb = ib.quantize_basis(b)
    x = rng.uniform(-1, 1, (2, 3, 511)).astype(np.float32)
    got = ib.dot_i8x2(_t(x), qb)
    flat = ib.dot_i8x2(_t(x.reshape(6, 511)), qb)
    assert got.shape == (2, 3, 511)
    assert torch.equal(got.reshape(6, 511), flat)
    bh, bl, cs = ib._operands_on(qb, torch.device("cpu"))
    assert bh.shape == bl.shape == (512, 512) and cs.shape == (512,)
    assert torch.equal(bh[:511, :511], _t(qb.hi.T))
    assert torch.equal(bl[:511, :511], _t(qb.lo.T))
    assert not bh[511].any() and not bh[:, 511].any() and cs[511] == 0
    assert ib._operands_on(qb, torch.device("cpu"))[0] is bh


# Two f32 products of a contraction up to 512 summed in two orders: within
# 2^-17 of the output's scale (measured about 1e-6).
F32_REL = 2.0 ** -17


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("nfft", [512, 1024])
def test_tiled_parts_i8_match_the_reference(nfft, jit):
    """The tiled int8 parts against the reference, op by op and jitted:
    above 100 dB each (measured 110-157 dB). They are not bit-equal: op by
    op the reference's scale is an IEEE quotient (ROADMAP C8), and jitted,
    XLA contracts the window product into the fold's add (a fused
    multiply-add, C5), so a few limbs of each row land one quantum apart;
    the f32 border sums run in another order."""
    rng = np.random.default_rng(nfft)
    fr = rng.uniform(-1, 1, (2, 40, nfft)).astype(np.float32)
    w32 = np.asarray(_hann(nfft), np.float32)
    fwd = (jax.jit(jib.rfft_folded_tiled_parts_i8, static_argnums=1) if jit
           else jib.rfft_folded_tiled_parts_i8)
    want = fwd(jnp.asarray(fr), nfft, jnp.asarray(w32))
    got = ib.rfft_folded_tiled_parts_i8(_t(fr), nfft, w32)
    for a, b in zip(got, want):
        assert _snr(b, a) > 100
    g = rng.uniform(0.2, 2.0, nfft // 2 + 1)
    for gains in (None, g):
        want_i = jib.irfft_folded_tiled_parts_i8(*want, nfft, gains)
        got_i = ib.irfft_folded_tiled_parts_i8(
            *(_t(np.array(a)) for a in want), nfft, gains)
        assert _snr(want_i, got_i) > 100


@pytest.mark.parametrize("nfft", [256, 1024, 4096])
def test_roundtrip_folded_tiled_i8_matches_the_reference(nfft):
    rng = np.random.default_rng(30 + nfft // 256)
    fr = rng.uniform(-1, 1, (24, nfft)).astype(np.float32)
    w = _hann(nfft)
    want = np.asarray(jib.roundtrip_folded_tiled_i8(jnp.asarray(fr), nfft, w))
    got = ib.roundtrip_folded_tiled_i8(_t(fr), nfft, w).numpy()
    assert _snr(want, got) > 100
    g = rng.uniform(0.2, 2.0, nfft // 2 + 1)
    want = np.asarray(jib.roundtrip_folded_tiled_i8(
        jnp.asarray(fr), nfft, w, w, per_bin_gains_f64=g))
    got = ib.roundtrip_folded_tiled_i8(_t(fr), nfft, w, w,
                                       per_bin_gains_f64=g).numpy()
    assert _snr(want, got) > 100


def test_roundtrip_composed_i8_matches_the_reference():
    """One quantized product: the jitted reference bit for bit (the eager
    one within its scale's ulp differences)."""
    nfft = 1024
    rng = np.random.default_rng(8)
    w = _hann(nfft)
    k = np.arange(nfft // 2 + 1)
    g = (10 ** rng.uniform(-0.5, 0.5, nfft // 2 + 1)) * np.exp(
        -2j * np.pi * k * 3 / nfft)
    fr = rng.uniform(-1, 1, (16, nfft)).astype(np.float32)
    got = ib.roundtrip_composed_i8(_t(fr), nfft, w, g).numpy()
    jitted = np.asarray(jax.jit(
        lambda f: jib.roundtrip_composed_i8(f, nfft, w, g))(jnp.asarray(fr)))
    np.testing.assert_array_equal(got, jitted)
    eager = np.asarray(jib.roundtrip_composed_i8(jnp.asarray(fr), nfft, w, g))
    assert _snr(eager, got) > 120


@pytest.mark.parametrize("nfft", [512, 1024])
def test_f32_tiled_parts_match_the_reference(nfft):
    """The port's f32 tiled layout (IEEE fp32 products) against the
    reference's at HIGHEST on the CPU."""
    rng = np.random.default_rng(40 + nfft)
    fr = rng.uniform(-1, 1, (3, 20, nfft)).astype(np.float32)
    w = _hann(nfft)
    hi = jax.lax.Precision.HIGHEST
    want = jmm.rfft_folded_tiled_parts(jnp.asarray(fr), nfft,
                                       jnp.asarray(np.float32(w)), hi)
    got = mb.rfft_folded_tiled_parts(_t(fr), nfft, np.float32(w))
    for a, b in zip(got, want):
        _close(a, b, F32_REL)
    g = rng.uniform(0.2, 2.0, nfft // 2 + 1)
    want_i = jmm.irfft_folded_tiled_parts(*want, nfft, hi, g)
    got_i = mb.irfft_folded_tiled_parts(*(_t(np.array(a)) for a in want),
                                        nfft, g)
    _close(got_i, want_i, F32_REL)
    want_rt = jmm.roundtrip_folded_tiled(jnp.asarray(fr), nfft, w, w, hi, g)
    got_rt = mb.roundtrip_folded_tiled(_t(fr), nfft, w, w, g)
    _close(got_rt, want_rt, F32_REL)
    assert mb.tiled_supported(nfft) == jmm.tiled_supported(nfft)


# --- the routes of round_trip -------------------------------------------------


def _reference_tiled_round_trip(x, jcfg, int8):
    """The reference accelerator's "tiled" branch of round_trip, run on the
    CPU: frames, the tiled round-trip, its OLA + normalize, the crop."""
    sig = jnp.asarray(x)
    frames = j_frame_signal(sig, jcfg.frame_spec)
    w64 = j_get_window(jcfg.window, jcfg.frame_size, jcfg.periodic,
                       dtype=np.float64)
    if int8:
        out = jib.roundtrip_folded_tiled_i8(frames, jcfg.frame_size, w64)
    else:
        out = jmm.roundtrip_folded_tiled(frames, jcfg.frame_size, w64,
                                         precision=jax.lax.Precision.HIGHEST)
    nf = frames.shape[-2]
    full = (nf - 1) * jcfg.hop_size + jcfg.frame_size
    norm = jnp.asarray(j_norm_np(jcfg, nf, full))
    y = j_ola(out, norm, jcfg.hop_size, full, jcfg.eps)
    pad = jcfg.frame_spec.pad_amount
    return np.asarray(y[..., pad : pad + x.shape[-1]])


@pytest.mark.parametrize("precision,route,gate", [
    ("INT8X2", "tiled_i8", 100.0), ("HIGH", "tiled", 120.0),
    ("HIGHEST", "tiled", 120.0)])
def test_tiled_routes_match_the_reference(precision, route, gate):
    """round_trip at N = 1024, H = 480 (10 ms at 48 kHz: N % H != 0, so no
    blocked kernel) takes the tiled routes and meets the reference's tiled
    round-trip plus its OLA tail; identity above the 60 dB gate."""
    x = np.random.default_rng(50).uniform(-1, 1, (2, 24000)).astype(
        np.float32)
    cfg = pt.StftConfig(frame_size=1024, hop_size=480, center=True,
                        fft_precision=getattr(pt.FftPrecision, precision))
    jcfg = JCfg(frame_size=1024, hop_size=480, center=True,
                fft_precision=getattr(JPrec, precision))
    assert pt.formulation_for(cfg, None, x.shape[-1]) == route
    got = pt.round_trip(x, cfg, device="cpu").numpy()
    want = _reference_tiled_round_trip(x, jcfg, route == "tiled_i8")
    assert _snr(want, got) > gate
    assert _snr(x, got) > (74 if route == "tiled_i8" else 120)


def test_route_gates_of_the_int8_tier():
    """Identity and fixed responses at H = 256 stay blocked at every tier;
    the tiled routes take the identity only; the fused routes stay HIGH-only;
    a fixed response the blocked kernel cannot take runs the composed
    product at every tier, and the identity at N % 256 != 0 the folded
    products, as the reference's accelerator does."""
    n = 48000
    gate = pt.spectral.noise_gate(-30.0)
    band = pt.spectral.band_gain([1000.0], [1.0, 0.5], 48000, 1024)
    for prec in pt.FftPrecision:
        c256 = pt.StftConfig(frame_size=1024, hop_size=256, center=True,
                             fft_precision=prec)
        assert pt.formulation_for(c256, None, n) == "blocked"
        assert pt.formulation_for(c256, band, n) == "blocked"
        c480 = dataclasses.replace(c256, hop_size=480)
        assert pt.formulation_for(c480, band, n) == "composed"
        assert pt.formulation_for(
            dataclasses.replace(c480, frame_size=1000), None, n) == \
            "folded"
    i8 = pt.StftConfig(frame_size=1024, hop_size=256, center=True,
                       fft_precision=pt.FftPrecision.INT8X2)
    assert pt.formulation_for(i8, None, 1000) == "tiled_i8"  # few frames
    assert pt.formulation_for(i8, gate, n) == "packed_parts"
    assert pt.formulation_for(dataclasses.replace(i8, fused_roundtrip=True),
                              None, n) == "blocked"
    xla = dataclasses.replace(i8, hop_size=480, fft_backend=pt.FftBackend.XLA)
    assert pt.formulation_for(xla, None, n) == "stft_istft"


def test_int8_tier_on_the_other_routes_runs_as_high():
    """Where the tier has no int8 formulation, the port runs it as HIGH: the
    blocked round-trip, the f32 streamer, convolve and the packed route
    give HIGH's result."""
    x = np.random.default_rng(60).uniform(-1, 1, (2, 30000)).astype(
        np.float32)
    hi = pt.StftConfig(frame_size=512, hop_size=128, center=True)
    i8 = dataclasses.replace(hi, fft_precision=pt.FftPrecision.INT8X2)
    assert torch.equal(pt.round_trip(x, i8, device="cpu"),
                       pt.round_trip(x, hi, device="cpu"))
    gate = pt.spectral.noise_gate(-30.0)
    assert torch.equal(pt.round_trip(x, i8, gate, device="cpu"),
                       pt.round_trip(x, hi, gate, device="cpu"))
    nc_hi = dataclasses.replace(hi, center=False)
    nc_i8 = dataclasses.replace(i8, center=False)
    y_hi, _ = pt.streaming_round_trip(x[0], nc_hi, device="cpu")
    y_i8, _ = pt.streaming_round_trip(x[0], nc_i8, device="cpu")
    assert torch.equal(torch.as_tensor(y_hi), torch.as_tensor(y_i8))


# --- K11's two variants: plain versions and launches --------------------------


def test_probe_and_reference_variants_agree_where_they_must():
    """The two plain versions share the row scale and the epilogue's
    product by s*128; with cs = 1 they give the same value wherever their
    limbs agree, and q = rint(x / s) and rint(x * (1/s)) differ in well
    under 1e-3 of the values."""
    rng = np.random.default_rng(70)
    x = _t(rng.uniform(-1, 1, (256, 512)).astype(np.float32))
    bt = _t(rng.integers(-127, 128, (128, 512), dtype=np.int8))
    b2t = _t(rng.integers(-64, 65, (128, 512), dtype=np.int8))
    ph, pl, s128 = b6.quantize_rows(x)
    rh, rl, s = b6.quantize_rows_ref(x)
    assert torch.equal(s128, s * 128.0)
    same = (ph == rh) & (pl == rl)
    assert 1.0 - float(same.float().mean()) < 1e-3
    probe = b6.fusedq_gemm_plain(x, bt, b2t)
    ref = b6.fusedq_ref_gemm_plain(x, bt, b2t, torch.ones(128))
    rows = same.all(dim=-1)
    assert rows.sum() > 200
    assert torch.equal(probe[rows], ref[rows])


def test_reference_variant_plain_is_dot_i8x2():
    rng = np.random.default_rng(71)
    b = rng.standard_normal((512, 192))
    qb = ib.quantize_basis(b)
    x = _t(rng.uniform(-1, 1, (100, 512)).astype(np.float32))
    bh, bl, cs = ib._operands_on(qb, torch.device("cpu"))
    assert torch.equal(b6.fusedq_ref_gemm_plain(x, bh, bl, cs),
                       ib.dot_i8x2(x, qb))


@pytest.fixture
def fake_launch(monkeypatch):
    """Records (library function, first argument) of every kernel launch and
    lets meta tensors through the device check."""
    calls = []
    monkeypatch.setattr(cuda_build, "launch",
                        lambda name, device, *a: calls.append((name, a[0])))
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(b6, "launches", dict.fromkeys(b6.launches, 0))
    return calls


def test_tiled_i8_route_launches_k11_four_times_then_b1(fake_launch):
    """On a non-CPU tensor the "tiled_i8" route runs its four products on
    K11's reference variant (variant 1 of crlot_b6_fusedq) and its OLA on
    B1: no plain version, no fallback."""
    cfg = pt.StftConfig(frame_size=1024, hop_size=480, center=True,
                        fft_precision=pt.FftPrecision.INT8X2)
    pt.round_trip(torch.empty((2, 48000), device="meta"), cfg)
    assert fake_launch == [("crlot_b6_fusedq", 1)] * 4 + [
        ("crlot_ola_normalized", fake_launch[-1][1])]
    assert b6.launches["fusedq_ref"] == 4 and b6.launches["fusedq"] == 0


def test_k11_wrappers_refuse_what_the_kernel_cannot_take(fake_launch):
    meta = torch.empty((64, 512), device="meta")
    bt = torch.empty((128, 512), dtype=torch.int8, device="meta")
    cs = torch.empty((128,), device="meta")
    b6.fusedq_ref_gemm(meta, bt, bt, cs)
    b6.fusedq_gemm(meta, bt, bt)
    assert fake_launch == [("crlot_b6_fusedq", 1), ("crlot_b6_fusedq", 0)]
    with pytest.raises(ValueError, match="cs"):
        b6.fusedq_ref_gemm(meta, bt, bt, cs[:64])
    b500 = torch.empty((128, 500), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="multiples of 64"):
        b6.fusedq_gemm(torch.empty((64, 500), device="meta"), b500, b500)
    with pytest.raises(ValueError, match="f32"):
        b6.fusedq_gemm(meta.to(torch.bfloat16), bt, bt)


def test_k11_on_meta_raises_without_a_card():
    meta = torch.empty((64, 512), device="meta")
    bt = torch.empty((128, 512), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        b6.fusedq_ref_gemm(meta, bt, bt, torch.empty((128,), device="meta"))


def test_k11_takes_k_past_the_former_cap():
    """No K cap below 4096: the composed basis at N = 4096 runs on one
    launch (the former kernel held K <= 1024 rows in shared memory)."""
    assert not hasattr(b6, "FUSEDQ_MAX_K")
    rng = np.random.default_rng(72)
    x = _t(rng.uniform(-1, 1, (8, 4096)).astype(np.float32))
    b = rng.standard_normal((4096, 64))
    y = ib.dot_i8x2(x, ib.quantize_basis(b))
    assert _snr(x.double().numpy() @ b, y) > 74
