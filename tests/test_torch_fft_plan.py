"""The port's plan-based FFT API (`FftPlan`, `make_fft_plan`) and dispatch's
complex transforms.

Mirrors the thirteen tests of `tests/test_fft.py` with their gates (real
round-trip RMSE < 1e-6; complex round-trip max-abs < 1e-4; DC, tone and
Nyquist bins to rel 1e-5 / 1e-4; batch rows within 1e-4 of single calls;
strided within 1e-5 of direct), each on the library route (AUTO on a CPU
tensor: `torch.fft`) and on the matmul DFT (MATMUL: what AUTO runs on the
card for a REAL plan). Against the reference's plan on the same input,
stated bound (BOUND): each output within 2^-22 * sum|input| of its row
(four unit roundoffs of the row's l1 norm; measured at most 0.52 of it),
since the two libraries, and the matmul, sum in other orders.
`chip_smoke.py` phase 29 holds the card against the CPU with the same
bound.
"""

import numpy as np
import pytest
import torch

from crlot_tpu.core.types import FftDomain as JDomain
from crlot_tpu.core.types import FftPlanDesc as JDesc
from crlot_tpu.fft.api import make_fft_plan as j_make

import crlot_tpu_torch as pt
from crlot_tpu_torch.convert import plan_desc_from_reference
from crlot_tpu_torch.core.types import FftBackend, FftDomain, FftPlanDesc
from crlot_tpu_torch.fft import dispatch
from crlot_tpu_torch.fft.api import make_fft_plan

CPU = "cpu"
SIZES = [256, 512, 1024, 2048, 4096]
BACKENDS = [FftBackend.AUTO, FftBackend.MATMUL]


def _plan(nfft, domain=FftDomain.REAL, **kw):
    return make_fft_plan(FftPlanDesc(domain=domain, nfft=nfft, **kw))


def _np(t):
    return t.numpy()


def _within_bound(got, want, inp):
    """|got - want| <= 2^-22 * sum|inp| per row (BOUND)."""
    inp = np.atleast_2d(np.abs(np.asarray(inp)))
    bound = 2.0 ** -22 * inp.sum(axis=-1, keepdims=True)
    err = np.atleast_2d(np.abs(np.asarray(got) - np.asarray(want)))
    assert np.all(err <= bound), float(np.max(err / bound))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nfft", SIZES)
def test_real_round_trip_rmse(nfft, backend):
    rng = np.random.default_rng(42)
    x = rng.uniform(-1, 1, nfft).astype(np.float32)
    plan = _plan(nfft, backend=backend)
    y = _np(plan.inverse(plan.forward(x, device=CPU)))
    rmse = np.sqrt(np.mean((x - y) ** 2))
    assert rmse < 1e-6, f"N={nfft}: rmse {rmse}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_dc_component(backend):
    nfft = 1024
    spec = _np(_plan(nfft, backend=backend).forward(
        np.ones(nfft, dtype=np.float32), device=CPU))
    assert spec.shape == (nfft // 2 + 1,)
    assert abs(spec[0]) == pytest.approx(nfft, rel=1e-5)
    assert np.max(np.abs(spec[1:])) < 1e-2


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_tone_bin(backend):
    nfft, k, amp = 1024, 7, 0.5
    t = np.arange(nfft)
    x = (amp * np.cos(2 * np.pi * k * t / nfft)).astype(np.float32)
    spec = _np(_plan(nfft, backend=backend).forward(x, device=CPU))
    assert abs(spec[k]) == pytest.approx(amp * nfft / 2, rel=1e-4)
    assert np.angle(spec[k]) == pytest.approx(0.0, abs=1e-3)
    others = np.abs(spec)
    others[k] = 0
    assert np.max(others) < 1e-2


@pytest.mark.parametrize("backend", BACKENDS)
def test_nyquist(backend):
    nfft = 512
    x = np.array([1.0, -1.0] * (nfft // 2), dtype=np.float32)
    spec = _np(_plan(nfft, backend=backend).forward(x, device=CPU))
    assert abs(spec[-1]) == pytest.approx(nfft, rel=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_inverse_includes_1_over_n(backend):
    nfft = 256
    spec = np.zeros(nfft // 2 + 1, dtype=np.complex64)
    spec[0] = nfft
    y = _np(_plan(nfft, backend=backend).inverse(spec, device=CPU))
    np.testing.assert_allclose(y, np.ones(nfft), atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_per_element(backend):
    nfft, batch = 512, 8
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (batch, nfft)).astype(np.float32)
    plan = _plan(nfft, batch=batch, backend=backend)
    spec = _np(plan.forward(x, device=CPU))
    for b in range(batch):
        single = _np(_plan(nfft, backend=backend).forward(x[b], device=CPU))
        np.testing.assert_allclose(spec[b], single, atol=1e-4)
    assert plan.supports_batch()
    assert plan.max_batch_size() > 16


@pytest.mark.parametrize("stride_out", [1, 2])
def test_strided_round_trip(stride_out):
    nfft, batch, stride = 256, 4, 3
    rng = np.random.default_rng(5)
    frames = rng.uniform(-1, 1, (batch, nfft)).astype(np.float32)
    flat = np.zeros(batch * nfft * stride, dtype=np.float32)
    flat[::stride] = frames.reshape(-1)
    plan = _plan(nfft, batch=batch, stride_in=stride, stride_out=stride_out)
    spec_flat = _np(plan.forward_strided(flat, device=CPU))
    direct = _np(_plan(nfft, batch=batch).forward(frames, device=CPU))
    spec = spec_flat[::stride_out].reshape(batch, nfft // 2 + 1)
    np.testing.assert_allclose(spec, direct, atol=1e-5)
    if stride_out > 1:  # the gaps are zero-filled, as in the reference
        assert not np.any(spec_flat[1::stride_out])
    jplan = j_make(JDesc(domain=JDomain.REAL, nfft=nfft, batch=batch,
                         stride_in=stride, stride_out=stride_out))
    want = np.asarray(jplan.forward_strided(flat))
    assert want.shape == spec_flat.shape
    _within_bound(spec_flat.reshape(batch, -1), want.reshape(batch, -1),
                  frames)
    inv = plan_desc_from_reference(JDesc(
        domain=JDomain.REAL, nfft=nfft, batch=batch, stride_in=stride_out))
    y = _np(make_fft_plan(inv).inverse_strided(spec_flat, device=CPU))
    np.testing.assert_allclose(y.reshape(batch, nfft), frames, atol=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_complex_round_trip(backend):
    nfft = 512
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)).astype(
        np.complex64)
    plan = _plan(nfft, domain=FftDomain.COMPLEX, backend=backend)
    y = _np(plan.inverse_complex(plan.forward_complex(x, device=CPU)))
    assert np.max(np.abs(x - y)) < 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_inf_denormal_scrub(backend):
    nfft = 256
    x = np.zeros(nfft, dtype=np.float32)
    x[0] = np.nan
    x[1] = np.inf
    x[2] = -np.inf
    x[3] = 1e-38
    x[4:] = 0.5
    plan = _plan(nfft, backend=backend)
    spec = plan.forward(x, device=CPU)
    assert bool(torch.isfinite(spec).all())
    assert bool(torch.isfinite(plan.inverse(spec)).all())
    want = np.asarray(j_make(JDesc(domain=JDomain.REAL, nfft=nfft)).forward(x))
    _within_bound(_np(spec), want, np.nan_to_num(x, posinf=0, neginf=0))


def test_scrub_disabled_passes_nan():
    nfft = 256
    x = np.full(nfft, np.nan, dtype=np.float32)
    spec = _plan(nfft, scrub=False).forward(x, device=CPU)
    assert bool(torch.isnan(spec).any())


def test_invalid_configs():
    with pytest.raises(ValueError):
        FftPlanDesc(domain=FftDomain.REAL, nfft=1023)
    with pytest.raises(ValueError):
        FftPlanDesc(domain=FftDomain.REAL, nfft=1024, in_place=True)
    with pytest.raises(ValueError):
        FftPlanDesc(domain=FftDomain.REAL, nfft=1024, batch=0)
    with pytest.raises(ValueError):
        FftPlanDesc(domain=FftDomain.REAL, nfft=1024, stride_in=0)
    with pytest.raises(ValueError):
        FftPlanDesc(domain=FftDomain.REAL, nfft=0)
    FftPlanDesc(domain=FftDomain.COMPLEX, nfft=1023)


def test_domain_mismatch_raises():
    plan = _plan(512)
    with pytest.raises(ValueError):
        plan.forward_complex(np.zeros(512, dtype=np.complex64), device=CPU)
    cplan = _plan(512, domain=FftDomain.COMPLEX)
    with pytest.raises(ValueError):
        cplan.forward(np.zeros(512, dtype=np.float32), device=CPU)


def test_wrong_length_raises():
    plan = _plan(512)
    with pytest.raises(ValueError):
        plan.forward(np.zeros(500, dtype=np.float32), device=CPU)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nfft", [256, 1024, 4096])
def test_plan_matches_reference(nfft, backend):
    """Real and complex plans against the reference's, forward and
    inverse, batch 64, within BOUND."""
    rng = np.random.default_rng(nfft)
    x = rng.uniform(-1, 1, (64, nfft)).astype(np.float32)
    jreal = j_make(JDesc(domain=JDomain.REAL, nfft=nfft, batch=64))
    assert plan_desc_from_reference(jreal.desc) == FftPlanDesc(
        domain=FftDomain.REAL, nfft=nfft, batch=64)
    real = _plan(nfft, batch=64, backend=backend)
    spec = real.forward(x, device=CPU)
    jspec = np.asarray(jreal.forward(x))
    _within_bound(_np(spec), jspec, x)
    _within_bound(_np(real.inverse(jspec, device=CPU)),
                  np.asarray(jreal.inverse(jspec)),
                  2 * (np.abs(jspec.real) + np.abs(jspec.imag)) / nfft)
    xc = (rng.standard_normal((64, nfft))
          + 1j * rng.standard_normal((64, nfft))).astype(np.complex64)
    jc = j_make(JDesc(domain=JDomain.COMPLEX, nfft=nfft))
    cplan = _plan(nfft, domain=FftDomain.COMPLEX, backend=backend)
    cspec = cplan.forward_complex(xc, device=CPU)
    jcspec = np.asarray(jc.forward_complex(xc))
    _within_bound(_np(cspec), jcspec, np.abs(xc.real) + np.abs(xc.imag))
    _within_bound(_np(cplan.inverse_complex(jcspec, device=CPU)),
                  np.asarray(jc.inverse_complex(jcspec)),
                  (np.abs(jcspec.real) + np.abs(jcspec.imag)) / nfft)


def test_matmul_above_4096_raises_not_falls_back():
    """MATMUL beyond the matmul bases raises (queue A9); it does not
    quietly run the library FFT."""
    x = np.zeros(8192, np.float32)
    with pytest.raises(NotImplementedError):
        _plan(8192, backend=FftBackend.MATMUL).forward(x, device=CPU)
    with pytest.raises(NotImplementedError):
        _plan(8192, domain=FftDomain.COMPLEX,
              backend=FftBackend.MATMUL).forward_complex(x, device=CPU)
    spec = _plan(8192).forward(x, device=CPU)  # AUTO on the CPU: torch.fft
    assert tuple(spec.shape) == (4097,)


def test_complex_dispatch_crops_and_pads_like_numpy():
    rng = np.random.default_rng(9)
    for t in (100, 128, 160):
        x = (rng.standard_normal((3, t)) + 1j * rng.standard_normal((3, t))
             ).astype(np.complex64)
        want = np.fft.fft(x, n=128, axis=-1)
        for be in BACKENDS:
            got = dispatch.fft_complex(torch.from_numpy(x), 128, be).numpy()
            _within_bound(got, want, np.abs(x.real) + np.abs(x.imag))
        back = dispatch.ifft_complex(torch.from_numpy(want.astype(
            np.complex64)), 128, FftBackend.MATMUL).numpy()
        _within_bound(back, np.fft.ifft(want, axis=-1),
                      (np.abs(want.real) + np.abs(want.imag)) / 128)


def test_plan_defaults_to_the_card():
    plan = pt.make_fft_plan(pt.FftPlanDesc(pt.FftDomain.REAL, 64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            plan.forward(np.zeros(64, np.float32))
