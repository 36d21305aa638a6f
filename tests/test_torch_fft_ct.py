"""The port's Cooley-Tukey products (`crlot_tpu_torch.fft.ct_backend`), the
dense odd-N DFT bases, and the MATMUL routes of `fft.dispatch` (C20).

Mirrors `tests/test_fft_ct.py`'s eight tests with its gates: rfft within
max|err| / N < 2e-6 of numpy's float64 rfft; round-trip RMSE < 1e-5; a tone
bin to rel 1e-3; the pipeline at N = 16384 on MATMUL above 80 dB; the
complex transform within max|err| / N < 2e-6, back within 1e-3; a COMPLEX
plan on MATMUL within 1e-3; the HIGH tier above 80 dB. Then holds the port
against the reference on the same seeded input (JAX on the CPU):

- every design array byte-identical: `factor`, the two-stage bases and
  twiddles (`_ct_consts`), the post-twiddle (`_pack_consts`), the dense
  forward / inverse / windowed bases;
- `rfft_ct`, `irfft_ct`, `fft_ct`, `ifft_ct` and the dense products within
  the same gates of the reference's output (max|err| / N < 2e-6 for the
  forwards; the inverses within 1e-5, the round-trip gate; measured at
  most a few ulps: the products sum in other orders);
- C20: at nfft 1023, 6000 and 8192, `dispatch.rfft` / `irfft` on MATMUL
  and the plans (REAL where nfft is even; COMPLEX) return the reference's
  shapes and values within those gates, and never raise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crlot_tpu.fft.ct_backend as jct
import crlot_tpu.fft.matmul_backend as jmm
from crlot_tpu.core.types import FftBackend as JBackend
from crlot_tpu.core.types import FftDomain as JDomain
from crlot_tpu.core.types import FftPlanDesc as JDesc
from crlot_tpu.core.types import StftConfig as JConfig
from crlot_tpu.fft import dispatch as jdispatch
from crlot_tpu.fft.api import make_fft_plan as j_make
from crlot_tpu.pipeline import round_trip as j_round_trip

import crlot_tpu_torch.fft.matmul_backend as tmm
from crlot_tpu_torch.core.types import (
    FftBackend,
    FftDomain,
    FftPlanDesc,
    FftPrecision,
    StftConfig,
)
from crlot_tpu_torch.fft import dispatch
from crlot_tpu_torch.fft.api import make_fft_plan
from crlot_tpu_torch.fft.ct_backend import (
    _ct_consts,
    _pack_consts,
    factor,
    fft_ct,
    ifft_ct,
    irfft_ct,
    rfft_ct,
)
from crlot_tpu_torch.metrics import snr_db
from crlot_tpu_torch.pipeline import round_trip

SIZES = [2048, 4096, 8192, 16384]
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want, nfft):
    return np.max(np.abs(np.asarray(got) - np.asarray(want))) / nfft


# ---------------------------------------------------------------------------
# mirrors of tests/test_fft_ct.py
# ---------------------------------------------------------------------------

def test_factor():
    assert factor(8192) == (128, 64)
    assert factor(4096) == (64, 64)
    with pytest.raises(ValueError):
        factor(1000)


@pytest.mark.parametrize("nfft", SIZES)
def test_rfft_matches_numpy(nfft):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, nfft)).astype(np.float32)
    got = rfft_ct(_t(x), nfft).numpy()
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    err = _rel(got, want, nfft)
    assert err < 2e-6, f"N={nfft}: rel err {err}"


@pytest.mark.parametrize("nfft", SIZES)
def test_round_trip(nfft):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, nfft)).astype(np.float32)
    y = irfft_ct(rfft_ct(_t(x), nfft), nfft).numpy()
    rmse = np.sqrt(np.mean((x - y) ** 2))
    assert rmse < 1e-5, f"N={nfft}: rmse {rmse}"


def test_tone_bin_large():
    nfft, k, amp = 16384, 129, 0.25
    t = np.arange(nfft)
    x = (amp * np.cos(2 * np.pi * k * t / nfft)).astype(np.float32)
    spec = rfft_ct(_t(x), nfft).numpy()
    assert abs(spec[k]) == pytest.approx(amp * nfft / 2, rel=1e-3)


def test_pipeline_large_frame_ct():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.9, 0.9, 65536).astype(np.float32)
    cfg = StftConfig(frame_size=16384, hop_size=4096, center=True,
                     fft_backend=FftBackend.MATMUL)
    y = round_trip(x, cfg, device=CPU).numpy()
    assert snr_db(x, y) > 80.0


def test_complex_ct_matches_numpy():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
         ).astype(np.complex64)
    got = fft_ct(_t(x), 4096).numpy()
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    assert _rel(got, want, 4096) < 2e-6
    back = ifft_ct(_t(got), 4096).numpy()
    assert np.max(np.abs(back - x)) < 1e-3


def test_plan_complex_matmul_backend():
    plan = make_fft_plan(FftPlanDesc(domain=FftDomain.COMPLEX, nfft=2048,
                                     backend=FftBackend.MATMUL))
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(
        np.complex64)
    y = plan.inverse_complex(plan.forward_complex(x, device=CPU)).numpy()
    assert np.max(np.abs(y - x)) < 1e-3


def test_ct_high_tier_round_trip_snr():
    """The HIGH tier through the CT route (the port's products are IEEE
    fp32 at every tier): the pipeline's round-trip at N = 16384 clears
    the 80 dB gate."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (4, 16384 * 4)).astype(np.float32)
    cfg = StftConfig(frame_size=16384, hop_size=4096, center=True,
                     fft_backend=FftBackend.MATMUL,
                     fft_precision=FftPrecision.HIGH)
    y = round_trip(x, cfg, device=CPU).numpy()
    assert snr_db(x, y) > 80.0
    y = irfft_ct(rfft_ct(_t(x[:, :16384]), 16384), 16384).numpy()
    assert snr_db(x[:, :16384], y) > 80.0


# ---------------------------------------------------------------------------
# design arrays, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [64, 1024, 2048, 4096, 8192])
def test_ct_consts_identical(m):
    assert factor(m) == jct.factor(m)
    for got, want in zip(_ct_consts(*factor(m)), jct._ct_consts(*factor(m))):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("nfft", SIZES)
def test_pack_consts_identical(nfft):
    for got, want in zip(_pack_consts(nfft), jct._pack_consts(nfft)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("nfft", [255, 1023, 1024, 4095])
def test_dense_bases_identical(nfft):
    w = np.hanning(nfft + 1)[:-1]
    pairs = [(tmm._forward_basis(nfft), jmm._forward_basis(nfft)),
             (tmm._inverse_basis(nfft), jmm._inverse_basis(nfft)),
             (tmm._windowed_forward_basis(nfft, w.tobytes()),
              jmm._windowed_forward_basis(nfft, w.tobytes()))]
    for got, want in pairs:
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nfft", SIZES)
def test_ct_real_matches_reference(nfft):
    rng = np.random.default_rng(nfft)
    x = rng.uniform(-1, 1, (3, nfft)).astype(np.float32)
    got = rfft_ct(_t(x), nfft).numpy()
    want = np.asarray(jct.rfft_ct(jnp.asarray(x), nfft))
    assert _rel(got, want, nfft) < 2e-6
    back = irfft_ct(_t(want), nfft).numpy()
    assert np.max(np.abs(back - np.asarray(jct.irfft_ct(
        jnp.asarray(want), nfft)))) < 1e-5


@pytest.mark.parametrize("nfft", [1024, 8192])
def test_ct_complex_matches_reference(nfft):
    rng = np.random.default_rng(nfft + 1)
    x = (rng.standard_normal((2, nfft)) + 1j * rng.standard_normal((2, nfft))
         ).astype(np.complex64)
    got = fft_ct(_t(x), nfft).numpy()
    want = np.asarray(jct.fft_ct(jnp.asarray(x), nfft))
    assert _rel(got, want, nfft) < 2e-6
    back = ifft_ct(_t(want), nfft).numpy()
    assert np.max(np.abs(back - np.asarray(jct.ifft_ct(
        jnp.asarray(want), nfft)))) < 1e-5


@pytest.mark.parametrize("nfft", [255, 1023])
def test_dense_matmul_matches_reference(nfft):
    rng = np.random.default_rng(nfft)
    x = rng.uniform(-1, 1, (4, nfft)).astype(np.float32)
    w = np.hanning(nfft + 2)[1:-1]
    got = tmm.rfft_matmul(_t(x), nfft).numpy()
    want = np.asarray(jmm.rfft_matmul(jnp.asarray(x), nfft))
    assert _rel(got, want, nfft) < 2e-6
    got = tmm.rfft_matmul(_t(x), nfft, w).numpy()
    want_w = np.asarray(jmm.rfft_windowed_matmul(jnp.asarray(x), nfft, w))
    assert _rel(got, want_w, nfft) < 2e-6
    back = tmm.irfft_matmul(_t(want), nfft).numpy()
    assert np.max(np.abs(back - np.asarray(jmm.irfft_matmul(
        jnp.asarray(want), nfft)))) < 1e-5
    assert np.sqrt(np.mean((back - x) ** 2)) < 1e-5


# ---------------------------------------------------------------------------
# C20: the MATMUL routes at every kind of nfft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nfft", [1023, 6000, 8192])
def test_c20_dispatch_matmul_matches_reference(nfft):
    """`dispatch.rfft` / `irfft` / `rfft_windowed` and the complex
    transforms on MATMUL: the dense product (1023), `torch.fft` (6000) and
    the CT products (8192), as the reference routes them."""
    rng = np.random.default_rng(20)
    x = rng.uniform(-1, 1, (2, nfft)).astype(np.float32)
    mm, jm = FftBackend.MATMUL, JBackend.MATMUL
    spec = dispatch.rfft(_t(x), nfft, mm).numpy()
    jspec = np.asarray(jdispatch.rfft(jnp.asarray(x), nfft, jm))
    assert spec.shape == jspec.shape == (2, nfft // 2 + 1)
    assert _rel(spec, jspec, nfft) < 2e-6
    y = dispatch.irfft(_t(jspec), nfft, mm).numpy()
    jy = np.asarray(jdispatch.irfft(jnp.asarray(jspec), nfft, jm))
    assert y.shape == jy.shape == (2, nfft)
    assert np.max(np.abs(y - jy)) < 1e-5
    w = np.hanning(nfft + 2)[1:-1]
    got = dispatch.rfft_windowed(_t(x), nfft, w, mm).numpy()
    want = np.asarray(jdispatch.rfft_windowed(jnp.asarray(x), nfft, w, jm))
    assert _rel(got, want, nfft) < 2e-6
    xc = (x + 1j * x[::-1]).astype(np.complex64)
    got = dispatch.fft_complex(_t(xc), nfft, mm).numpy()
    want = np.asarray(jdispatch.fft_complex(jnp.asarray(xc), nfft, jm))
    assert got.shape == want.shape and _rel(got, want, nfft) < 2e-6
    back = dispatch.ifft_complex(_t(want), nfft, mm).numpy()
    jback = np.asarray(jdispatch.ifft_complex(jnp.asarray(want), nfft, jm))
    assert np.max(np.abs(back - jback)) < 1e-5


@pytest.mark.parametrize("nfft", [1023, 6000, 8192])
@pytest.mark.parametrize("domain", ["REAL", "COMPLEX"])
def test_c20_plans_match_reference(nfft, domain):
    """`FftPlanDesc(..., backend=MATMUL)` at each kind of nfft: the
    reference's shapes and values (a REAL plan needs an even nfft in both
    packages)."""
    if domain == "REAL" and nfft % 2:
        with pytest.raises(ValueError):
            FftPlanDesc(domain=FftDomain.REAL, nfft=nfft)
        return
    rng = np.random.default_rng(nfft)
    plan = make_fft_plan(FftPlanDesc(domain=FftDomain[domain], nfft=nfft,
                                     backend=FftBackend.MATMUL))
    jplan = j_make(JDesc(domain=JDomain[domain], nfft=nfft,
                         backend=JBackend.MATMUL))
    if domain == "REAL":
        x = rng.uniform(-1, 1, (2, nfft)).astype(np.float32)
        got, want = plan.forward(x, device=CPU), jplan.forward(x)
        inv, jinv = plan.inverse(want, device=CPU), jplan.inverse(want)
    else:
        x = (rng.standard_normal((2, nfft))
             + 1j * rng.standard_normal((2, nfft))).astype(np.complex64)
        got, want = plan.forward_complex(x, device=CPU), jplan.forward_complex(x)
        inv = plan.inverse_complex(want, device=CPU)
        jinv = jplan.inverse_complex(want)
    want, jinv = np.asarray(want), np.asarray(jinv)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want, nfft) < 2e-6
    assert tuple(inv.shape) == jinv.shape
    assert np.max(np.abs(inv.numpy() - jinv)) < 1e-5


def test_c20_round_trip_at_8192_matches_reference():
    """`StftConfig(frame_size=8192, fft_backend=MATMUL)`: the round-trip
    runs the CT products in both packages, above 80 dB against the input
    and against each other."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-0.9, 0.9, (2, 65536)).astype(np.float32)
    cfg = StftConfig(frame_size=8192, hop_size=2048, center=True,
                     fft_backend=FftBackend.MATMUL)
    jcfg = JConfig(frame_size=8192, hop_size=2048, center=True,
                   fft_backend=JBackend.MATMUL)
    y = round_trip(x, cfg, device=CPU).numpy()
    jy = np.asarray(j_round_trip(x, jcfg))
    assert y.shape == jy.shape == x.shape
    assert snr_db(x, y) > 80.0
    assert snr_db(jy, y) > 80.0
