"""The port's matmul-DFT functions and complex library transforms against the
reference on the CPU (`tests/test_fft_matmul.py`, `tests/test_spectral.py`'s
`power_db` floor and packed tiled route, `tests/test_fft.py`'s complex
round-trip and scrub cases).

Tolerances. Against float64 numpy, each reference gate as it stands: rfft
RMSE / sqrt(N) < 1e-5, round-trip RMSE < 1e-5, the tiled round-trip within
2e-6 of the folded one (the reference's HIGHEST tier; the port's products
are IEEE fp32 at every tier), a synthesis-windowed round-trip within 1e-4,
the packed tiled route within 5e-5, the complex round-trip within 1e-4.
Against the reference's function of the same name on the same input
(XLA's CPU dot in f32 at HIGHEST, summed in another order than
`torch.matmul`): max-abs <= 4e-6 of the largest output magnitude (and at
least of 1), where a product's fp32 rounding reads at most about 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crlot_tpu.fft.matmul_backend as jmm
import crlot_tpu.fft.xla_backend as jxla
import crlot_tpu.spectral as jsp
from crlot_tpu.core.types import WindowType as JWin
from crlot_tpu.window.windows import get_window as j_get_window

import crlot_tpu_torch.fft.matmul_backend as mm
import crlot_tpu_torch.fft.xla_backend as xla
from crlot_tpu_torch import spectral as tsp
from crlot_tpu_torch.core.types import FftBackend, WindowType
from crlot_tpu_torch.fft import dispatch
from crlot_tpu_torch.window.windows import get_window

FOLDED_SIZES = [2, 4, 8, 48, 256, 1000, 1024]
REL = 4e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_to_reference(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.max(np.abs(want))))
    err = float(np.max(np.abs(got - want)))
    assert err <= REL * scale, f"{err:.3e} of {scale:.3e}"


def _x(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _hann64(n):
    return get_window(WindowType.HANN, n, True, dtype=np.float64)


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_dense_rfft_and_round_trip(nfft):
    x = _x(0, (4, nfft))
    got = mm.rfft_matmul(_t(x), nfft).numpy()
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    err = np.sqrt(np.mean(np.abs(got - want) ** 2)) / np.sqrt(nfft)
    assert err < 1e-5, f"N={nfft}: rfft err {err}"
    x = _x(1, (4, nfft))
    y = mm.irfft_matmul(mm.rfft_matmul(_t(x), nfft), nfft).numpy()
    assert np.sqrt(np.mean((x - y) ** 2)) < 1e-5  # the hard gate


def test_tone_bin():
    nfft, k, amp = 1024, 7, 0.5
    t = np.arange(nfft)
    x = (amp * np.cos(2 * np.pi * k * t / nfft)).astype(np.float32)
    for fn in (mm.rfft_matmul, mm.rfft_folded):
        spec = fn(_t(x), nfft).numpy()
        assert abs(spec[k]) == pytest.approx(amp * nfft / 2, rel=1e-4)


def test_dispatch_auto_on_cpu_and_matmul_forced():
    x = torch.ones((2, 512))
    assert torch.equal(dispatch.rfft(x, 512, FftBackend.AUTO),
                       torch.fft.rfft(x, dim=-1))  # AUTO == torch.fft here
    x = _t(_x(2, (3, 1024)))
    y = dispatch.irfft(dispatch.rfft(x, 1024, FftBackend.MATMUL), 1024,
                       FftBackend.MATMUL)
    assert float((x - y).square().mean().sqrt()) < 1e-5


def test_pipeline_matmul_backend_snr():
    import crlot_tpu_torch as pt

    x = np.random.default_rng(3).uniform(-0.9, 0.9, 48000).astype(np.float32)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True,
                        fft_backend=FftBackend.MATMUL)
    assert pt.snr_db(x, pt.round_trip(x, cfg, device="cpu")) > 90.0


def test_tiled_parts_spectrum_matches_numpy():
    nfft, h = 512, 256
    x = _x(8, (5, nfft))
    w64 = get_window(WindowType.HAMMING, nfft, True, dtype=np.float64)
    re512, re_nyq, im_eff = mm.rfft_folded_tiled_parts(
        _t(x), nfft, w64.astype(np.float32))
    want = np.fft.rfft(x.astype(np.float64) * w64, axis=-1)
    re = torch.cat([re512, re_nyq], dim=-1).numpy()
    assert np.max(np.abs(re - want.real)) < 1e-3
    assert np.max(np.abs(im_eff.numpy() - want.imag[:, 1:h])) < 1e-3


def test_tiled_supported_predicate():
    assert mm.tiled_supported(256) and mm.tiled_supported(1024)
    assert not mm.tiled_supported(128)  # h = 64
    assert not mm.tiled_supported(1000)
    assert not mm.tiled_supported(2 * mm.MAX_MATMUL_NFFT)


@pytest.mark.parametrize("nfft", FOLDED_SIZES)
def test_folded_forward_matches_numpy_and_reference(nfft):
    x = _x(7, (4, nfft))
    got = mm.rfft_folded(_t(x), nfft).numpy()
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    err = np.sqrt(np.mean(np.abs(got - want) ** 2)) / np.sqrt(nfft)
    assert err < 1e-5, f"N={nfft}: folded rfft err {err}"
    _close_to_reference(got, jmm.rfft_folded(jnp.asarray(x), nfft))


@pytest.mark.parametrize("nfft", FOLDED_SIZES)
def test_folded_round_trip_rmse(nfft):
    x = _x(8, (4, nfft))
    spec = mm.rfft_folded(_t(x), nfft)
    y = mm.irfft_folded(spec, nfft).numpy()
    assert np.sqrt(np.mean((x - y) ** 2)) < 1e-5
    _close_to_reference(y, jmm.irfft_folded(jnp.asarray(spec.numpy()), nfft))


@pytest.mark.parametrize("nfft", [48, 1000, 1024])
def test_windowed_forwards_match_reference(nfft):
    x = _x(12, (3, 5, nfft))
    w64 = _hann64(nfft)
    want = np.fft.rfft(x.astype(np.float64) * w64, axis=-1)
    for fn, jfn in ((mm.rfft_windowed_folded, jmm.rfft_windowed_folded),
                    (mm.rfft_windowed_matmul, jmm.rfft_windowed_matmul)):
        got = fn(_t(x), nfft, w64).numpy()
        err = np.sqrt(np.mean(np.abs(got - want) ** 2)) / np.sqrt(nfft)
        assert err < 1e-5, (fn.__name__, err)
        _close_to_reference(got, jfn(jnp.asarray(x), nfft, w64))


def test_packed_roundtrip_matches_complex_path():
    """The packed round-trip's two products against the windowed dense
    forward and the dense inverse: the same products, bit-identical (the
    reference's gate)."""
    frames = _x(5, (7, 1024))
    w64 = _hann64(1024)
    via_complex = mm.irfft_matmul(
        mm.rfft_windowed_matmul(_t(frames), 1024, w64), 1024).numpy()
    packed = mm.roundtrip_packed_matmul(_t(frames), 1024, w64).numpy()
    np.testing.assert_array_equal(packed, via_complex)


def test_folded_roundtrip_matches_packed_and_reference():
    frames = _x(9, (7, 1024))
    w64 = _hann64(1024)
    packed = mm.roundtrip_packed_matmul(_t(frames), 1024, w64).numpy()
    folded = mm.roundtrip_folded_matmul(_t(frames), 1024, w64).numpy()
    assert np.max(np.abs(folded - packed)) < 1e-5
    _close_to_reference(folded, jmm.roundtrip_folded_matmul(
        jnp.asarray(frames), 1024, w64))


@pytest.mark.parametrize("nfft", [512, 960])
def test_folded_roundtrip_synthesis_window(nfft):
    frames = _x(10, (4, nfft))
    w64 = _hann64(nfft)
    got = mm.roundtrip_folded_matmul(_t(frames), nfft, w64, w64).numpy()
    want = np.fft.irfft(
        np.fft.rfft(frames.astype(np.float64) * w64, axis=-1), axis=-1) * w64
    assert np.max(np.abs(got - want)) < 1e-4
    _close_to_reference(got, jmm.roundtrip_folded_matmul(
        jnp.asarray(frames), nfft, w64, w64))


def test_dispatch_matmul_uses_folded_for_even_sizes():
    """The MATMUL route takes the folded half-size products at every even
    N <= 4096 (C20). Outside the tiled layout they are `rfft_folded`'s and
    `irfft_folded`'s; at N % 256 == 0 those take the reference's tiled
    cores, which the port's dispatch does not (`fft/dispatch.py`), and the
    two agree within the tiled test's 2e-6 scaled by the bins' size."""
    for nfft in (1000, 512):
        x = _t(_x(11, (3, nfft)))
        spec = dispatch.rfft(x, nfft, FftBackend.MATMUL)
        back = dispatch.irfft(spec, nfft, FftBackend.MATMUL)
        folded = torch.complex(*mm.rfft_folded_packed(x, nfft))
        np.testing.assert_array_equal(spec.numpy(), folded.numpy())
        np.testing.assert_array_equal(
            back.numpy(), mm.irfft_folded_parts(spec.real, spec.imag,
                                                nfft).numpy())
        if not mm.tiled_supported(nfft):
            assert torch.equal(spec, mm.rfft_folded(x, nfft))
            assert torch.equal(back, mm.irfft_folded(spec, nfft))
        scale = float(spec.abs().max())
        assert float((spec - mm.rfft_folded(x, nfft)).abs().max()) < \
            2e-6 * scale
        assert float((back - mm.irfft_folded(spec, nfft)).abs().max()) < 2e-6
    w64 = _hann64(1000)
    y = _t(_x(13, (3, 1000)))
    np.testing.assert_array_equal(
        dispatch.rfft_windowed(y, 1000, w64, FftBackend.MATMUL).numpy(),
        mm.rfft_windowed_folded(y, 1000, w64).numpy())


@pytest.mark.parametrize("nfft", [256, 512, 1024, 2048])
def test_tiled_roundtrip_matches_folded(nfft):
    assert mm.tiled_supported(nfft)
    x = _t(_x(7, (17, nfft)))
    w64 = _hann64(nfft)
    t = mm.roundtrip_folded_tiled(x, nfft, w64).numpy()
    f = mm.roundtrip_folded_matmul(x, nfft, w64).numpy()
    assert np.max(np.abs(t - f)) < 2e-6


@pytest.mark.parametrize("nfft", [256, 1024])
def test_tiled_transforms_match_reference(nfft):
    x = _x(14, (5, nfft))
    w64 = j_get_window(JWin.HAMMING, nfft, True, dtype=np.float64)
    got = mm.rfft_tiled(_t(x), nfft, w64).numpy()
    want = np.fft.rfft(x.astype(np.float64) * w64, axis=-1)
    assert np.max(np.abs(got.real - want.real)) < 1e-3
    assert np.max(np.abs(got.imag - want.imag)) < 1e-3
    assert np.all(got.imag[:, 0] == 0) and np.all(got.imag[:, -1] == 0)
    _close_to_reference(got, jmm.rfft_tiled(jnp.asarray(x), nfft, w64))
    _close_to_reference(mm.rfft_tiled(_t(x), nfft).numpy(),
                        jmm.rfft_tiled(jnp.asarray(x), nfft))
    # Im[0] and Im[Nyquist] of a synthetic spectrum are ignored, as irfft
    # ignores them.
    spec = got.copy()
    spec.imag[:, 0], spec.imag[:, -1] = 3.0, -2.0
    y = mm.irfft_tiled(_t(spec), nfft).numpy()
    np.testing.assert_allclose(y, np.fft.irfft(spec, n=nfft, axis=-1),
                               atol=1e-5)
    _close_to_reference(y, jmm.irfft_tiled(jnp.asarray(spec), nfft))


def test_tiled_parts_packing_round_trips():
    nfft, h = 512, 256
    parts = mm.rfft_folded_tiled_parts(_t(_x(15, (3, nfft))), nfft)
    re, im = mm.tiled_parts_to_packed(*parts)
    assert re.shape == im.shape == (3, h + 1)
    assert not im[:, 0].any() and not im[:, h].any()
    back = mm.packed_to_tiled_parts(re, im, nfft)
    for a, b in zip(back, parts):
        assert torch.equal(a, b)
    jre, jim = jmm.tiled_parts_to_packed(*(jnp.asarray(p.numpy())
                                           for p in parts))
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    for a, b in zip(back, jmm.packed_to_tiled_parts(jre, jim, nfft)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_packed_tiled_route_matches_complex_route():
    """Tiled parts -> packed fn -> tiled inverse equals the float64
    stft -> fn -> istft frames (the reference's gate)."""
    nfft = 512
    w = get_window(WindowType.HANN, nfft, True)
    fn = tsp.noise_gate(-40.0)
    fr = _x(27, (6, nfft))
    re, im = mm.tiled_parts_to_packed(
        *mm.rfft_folded_tiled_parts(_t(fr), nfft, w))
    got = mm.irfft_folded_tiled_parts(
        *mm.packed_to_tiled_parts(*fn.packed(re, im), nfft), nfft).numpy()
    spec = np.fft.rfft(fr.astype(np.float64) * w, axis=-1)
    want = np.fft.irfft(np.asarray(jsp.noise_gate(-40.0)(jnp.asarray(spec))),
                        n=nfft, axis=-1)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_power_db_floor_and_magnitude():
    spec = np.zeros((2, 513), dtype=np.complex64)
    assert torch.all(tsp.power_db(spec) == -120.0)
    rng = np.random.default_rng(16)
    spec = (rng.standard_normal((3, 65)) + 1j * rng.standard_normal((3, 65))
            ).astype(np.complex64)
    spec[0, :5] = 0.0
    for floor in (-120.0, -20.0):
        got = tsp.power_db(_t(spec), floor).numpy()
        want = np.asarray(jsp.power_db(jnp.asarray(spec), floor))
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = tsp.magnitude(_t(spec)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsp.magnitude(jnp.asarray(
        spec))), rtol=1e-6, atol=0)


def test_complex_round_trip():
    nfft = 512
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)).astype(
        np.complex64)
    spec = xla.fft(_t(x), nfft)
    y = xla.ifft(spec, nfft).numpy()
    assert np.max(np.abs(x - y)) < 1e-4
    _close_to_reference(spec.numpy(), jxla.fft(x, nfft))
    _close_to_reference(y, jxla.ifft(np.asarray(spec.numpy()), nfft))


def test_complex_nan_inf_denormal_scrub():
    nfft = 256
    x = np.full(nfft, 0.5 + 0.25j, dtype=np.complex64)
    x[0] = complex(np.nan, 1.0)
    x[1] = complex(np.inf, -np.inf)
    x[2] = complex(1e-38, 0.5)  # below the 1e-30 threshold
    spec = xla.fft(_t(x), nfft)
    assert torch.isfinite(torch.view_as_real(spec)).all()
    np.testing.assert_allclose(spec.numpy(), np.asarray(jxla.fft(x, nfft)),
                               rtol=0, atol=1e-4)
    bad = spec.clone()
    bad[3] = complex(np.nan, 0.0)
    y = xla.ifft(bad, nfft)
    assert torch.isfinite(torch.view_as_real(y)).all()


def test_complex_scrub_disabled_passes_nan():
    x = np.full(256, np.nan, dtype=np.complex64)
    assert torch.isnan(torch.view_as_real(xla.fft(_t(x), 256,
                                                  do_scrub=False))).any()
    assert torch.isnan(torch.view_as_real(xla.ifft(_t(x), 256,
                                                   do_scrub=False))).any()
