"""The port's Toeplitz-product convolution vs the reference and numpy.

Same inputs from a seed go to `crlot_tpu.convolve` (JAX on the CPU), to
`crlot_tpu_torch.convolve` and to float64 `numpy.convolve`. The bound is
the reference's own: relative RMSE < 1e-5 (`tests/test_convolve.py`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu.convolve import convolve as j_convolve

from crlot_tpu_torch.convolve import _toeplitz_kernel, convolve
from crlot_tpu_torch.core.types import FftPrecision


def _rel_rmse(got, want):
    scale = max(1e-12, np.sqrt(np.mean(want**2)))
    return np.sqrt(np.mean((got - want) ** 2)) / scale


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("t,l", [(100, 7), (256, 127), (257, 128),
                                 (4096, 513), (1000, 1000),
                                 (100, 255), (4, 8), (300, 513)])
def test_convolve_matches_reference_and_numpy(mode, t, l):
    rng = np.random.default_rng(t * 1000 + l)
    x = rng.uniform(-1, 1, t).astype(np.float32)
    taps = rng.uniform(-1, 1, l).astype(np.float32)
    got = convolve(torch.from_numpy(x), taps, mode=mode).numpy()
    ref = np.asarray(j_convolve(jnp.asarray(x), taps, mode=mode))
    want = np.convolve(x.astype(np.float64), taps.astype(np.float64), mode)
    assert got.shape == ref.shape == want.shape
    assert _rel_rmse(got, want) < 1e-5
    assert _rel_rmse(got, ref) < 1e-5


def test_convolve_batched_and_tensor_taps():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 2, 500)).astype(np.float32)
    taps = rng.uniform(-1, 1, 31).astype(np.float32)
    got = convolve(x, torch.from_numpy(taps), mode="same", device="cpu").numpy()
    assert got.shape == (3, 2, 500)
    for i in range(3):
        for c in range(2):
            want = np.convolve(x[i, c].astype(np.float64), taps, "same")
            assert _rel_rmse(got[i, c], want) < 1e-5


def test_convolve_identity_and_lowpass():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_allclose(convolve(x, np.ones(1), device="cpu").numpy(),
                               x, atol=1e-6)
    sr = 48000
    t = np.arange(sr // 2) / sr
    taps = (np.hamming(255) * np.sinc(np.arange(-127, 128) * 2 * 4000 / sr)
            * 2 * 4000 / sr).astype(np.float32)
    lo = convolve(np.sin(2 * np.pi * 500 * t).astype(np.float32), taps,
                  "same", device="cpu")
    hi = convolve(np.sin(2 * np.pi * 20000 * t).astype(np.float32), taps,
                  "same", device="cpu")
    mid = slice(2048, -2048)
    assert float(lo[mid].abs().max()) > 0.5
    assert float(hi[mid].abs().max()) < float(lo[mid].abs().max()) * 1e-3


def test_toeplitz_kernel_byte_identical_and_cache_bounded():
    from crlot_tpu.convolve import _toeplitz_kernel as j_kernel

    taps = np.random.default_rng(3).uniform(-1, 1, 300).astype(np.float64)
    assert (_toeplitz_kernel(taps.tobytes(), 256).tobytes()
            == j_kernel(taps.tobytes(), 256).tobytes())
    assert _toeplitz_kernel.cache_parameters()["maxsize"] == 64


@pytest.mark.parametrize("taps,mode", [(np.ones(3), "reflect"),
                                       (np.ones((2, 2)), "full"),
                                       (np.ones(0), "full")])
def test_convolve_errors(taps, mode):
    with pytest.raises(ValueError):
        convolve(torch.ones(16), taps, mode=mode)


@pytest.mark.parametrize("precision", [
    None, "highest", "HIGH", "default", FftPrecision.HIGHEST,
    FftPrecision.HIGH])
def test_convolve_precision_accepted_values_give_fp32(precision):
    """On the CPU the reference's `precision=` values all run IEEE fp32
    products (on the card HIGHEST is fp32, the rest 3xTF32 on B0): the
    result equals the default call bit for bit (jax.lax.Precision members
    pass by name)."""
    import jax

    x = np.random.default_rng(5).uniform(-1, 1, (2, 3000)).astype(np.float32)
    taps = np.hanning(63)
    want = convolve(x, taps, "same", device="cpu")
    got = convolve(x, taps, "same", precision=precision, device="cpu")
    assert torch.equal(got, want)
    lax = convolve(x, taps, "same", precision=jax.lax.Precision.HIGHEST,
                   device="cpu")
    assert torch.equal(lax, want)


@pytest.mark.parametrize("precision", ["tf32", 3, object()])
def test_convolve_unknown_precision_raises(precision):
    with pytest.raises(ValueError, match="precision"):
        convolve(np.zeros(64, np.float32), np.ones(3), precision=precision,
                 device="cpu")


def test_convolve_int8_tier_runs_as_high():
    """INT8X2 has no int8 formulation in convolve: it runs as HIGH, as the
    reference's dispatch maps it for every lowering but the tiled one."""
    from crlot_tpu_torch.convolve import _tier

    assert _tier(FftPrecision.INT8X2) == FftPrecision.HIGH
    x = np.random.default_rng(6).uniform(-1, 1, (2, 3000)).astype(np.float32)
    taps = np.hanning(63)
    assert torch.equal(
        convolve(x, taps, "same", precision=FftPrecision.INT8X2,
                 device="cpu"),
        convolve(x, taps, "same", precision=FftPrecision.HIGH, device="cpu"))
