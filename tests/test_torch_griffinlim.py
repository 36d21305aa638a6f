"""The port's Griffin-Lim (`crlot_tpu_torch.griffinlim`) on the CPU.

Mirrors `tests/test_griffinlim.py` (its 5 cases and gates: spectral
convergence below -20 dB on a tone at 60 iterations, its frequency within
10 Hz and level within 5 %, 30 iterations at least 6 dB better than one,
the batched shape, `stft_magnitude` within 1e-6 of |stft|, validation),
then holds the port against the reference.

The reference draws its initial phase with `jax.random`, which torch
cannot reproduce; the port hashes (`seed`, flat index) in integer ops on
the magnitude's device (ROADMAP C17). So the parity tests compute the reference's
phase with `jax.random` and feed it to the port's `_griffin_lim_from`: the
port then meets the reference's `griffin_lim` at >= 100 dB SNR after 1, 2
and 8 iterations (measured 114.6-132.0 dB; the momentum of 0.99 amplifies
the FFTs' few-ulp differences with every iteration).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crlot_tpu.core.types import StftConfig as RefConfig
from crlot_tpu.griffinlim import griffin_lim as ref_griffin_lim
from crlot_tpu.pipeline import stft as ref_stft

from crlot_tpu_torch import griffinlim
from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.griffinlim import griffin_lim, stft_magnitude
from crlot_tpu_torch.metrics import snr_db
from crlot_tpu_torch.pipeline import stft

SR = 48000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return StftConfig(frame_size=1024, hop_size=256, center=True,
                      synthesis_window=True)


def _spectral_convergence_db(mag_target, y, cfg):
    mag_got = torch.abs(stft(torch.as_tensor(y), cfg)).numpy()
    mt = np.asarray(mag_target)
    return 20 * np.log10(np.sqrt(np.sum((mag_got - mt) ** 2))
                         / np.sqrt(np.sum(mt ** 2)))


def test_griffin_lim_tone():
    t = np.arange(SR // 2) / SR
    x = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    cfg = _cfg()
    mag = torch.abs(stft(x, cfg, device="cpu"))
    y = griffin_lim(mag, cfg, iters=60, length=len(x)).numpy()
    assert y.shape == x.shape
    sc = _spectral_convergence_db(mag, y, cfg)
    assert sc < -20.0, f"spectral convergence {sc:.1f} dB"
    spec = np.abs(np.fft.rfft(y[4096:-4096] * np.hanning(len(y) - 8192)))
    dom = np.argmax(spec) * SR / (len(y) - 8192)
    assert dom == pytest.approx(440.0, abs=10.0)
    assert np.sqrt(np.mean(y**2)) == pytest.approx(0.5 / np.sqrt(2), rel=0.05)


def test_griffin_lim_improves_with_iters():
    t = np.arange(12000) / SR
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.2 * np.sin(2 * np.pi * 1337 * t)).astype(np.float32)
    cfg = _cfg()
    mag = torch.abs(stft(x, cfg, device="cpu"))
    sc1 = _spectral_convergence_db(
        mag, griffin_lim(mag, cfg, iters=1, length=len(x)), cfg)
    sc30 = _spectral_convergence_db(
        mag, griffin_lim(mag, cfg, iters=30, length=len(x)), cfg)
    assert sc30 < sc1 - 6.0, f"{sc1:.1f} -> {sc30:.1f} dB"


def test_griffin_lim_batched():
    t = np.arange(12000) / SR
    x = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                  0.5 * np.sin(2 * np.pi * 880 * t)]).astype(np.float32)
    cfg = _cfg()
    mag = torch.abs(stft(x, cfg, device="cpu"))
    y = griffin_lim(mag, cfg, iters=20, length=x.shape[-1]).numpy()
    assert y.shape == x.shape
    assert np.isfinite(y).all()


def test_stft_magnitude_matches_abs_stft():
    x = np.random.default_rng(5).uniform(-1, 1, (2, 8000)).astype(np.float32)
    cfg = _cfg()
    got = stft_magnitude(x, cfg, device="cpu").numpy()
    # |stft| of the same complex64 spectrum in float64 (numpy's complex64
    # abs itself errs by up to 2 ulps here).
    want = np.abs(stft(x, cfg, device="cpu").numpy().astype(np.complex128))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_griffin_lim_validation():
    cfg = _cfg()
    mag = torch.ones((10, 513))
    with pytest.raises(ValueError):
        griffin_lim(mag, cfg, iters=0)
    with pytest.raises(ValueError):
        griffin_lim(mag, cfg, momentum=1.5)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _tones():
    t = np.arange(12000) / SR
    return np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                     0.4 * np.sin(2 * np.pi * 1337 * t)]).astype(np.float32)


def test_stft_magnitude_matches_reference():
    from crlot_tpu.griffinlim import stft_magnitude as ref_mag

    x = np.random.default_rng(6).uniform(-1, 1, (2, 8000)).astype(np.float32)
    ref_cfg = RefConfig(frame_size=1024, hop_size=256, center=True,
                        synthesis_window=True)
    want = np.asarray(ref_mag(jnp.asarray(x), ref_cfg))
    got = stft_magnitude(x, _cfg(), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("iters", [1, 2, 8])
def test_griffin_lim_matches_reference_from_its_phase(iters):
    ref_cfg = RefConfig(frame_size=1024, hop_size=256, center=True,
                        synthesis_window=True)
    mag = np.abs(np.asarray(ref_stft(jnp.asarray(_tones()), ref_cfg)))
    want = np.asarray(ref_griffin_lim(mag, ref_cfg, iters=iters,
                                      length=12000, seed=3))
    phase = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(3), mag.shape, jnp.float32, -jnp.pi, jnp.pi))
    got = griffinlim._griffin_lim_from(
        torch.from_numpy(mag.copy()), torch.from_numpy(phase), _cfg(), iters,
        0.99, 12000)
    assert snr_db(want, got.numpy()) >= 100.0


def _phase_np(shape, seed):
    """The initial phase's hash in numpy uint32 arithmetic (a product wraps
    modulo 2^32 there), independent of the port's int64 formulation."""
    def mix(x):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x5BD1E995)
        return x ^ (x >> np.uint32(16))

    s = np.uint64(seed % 2**64)
    key = mix(mix(np.uint32(s & np.uint64(0xFFFFFFFF)))
              ^ np.uint32(s >> np.uint64(32)))
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    bits = mix(mix((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ key)
               ^ (idx >> np.uint64(32)).astype(np.uint32))
    u = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
    pi = np.float32(np.pi)
    return (u * np.float32(2.0 * np.pi) - pi).reshape(shape)


def test_initial_phase_is_seeded_and_device_independent():
    """The same seed draws the same phase, another seed another; uniform in
    [-pi, pi); and the bits are those of the same hash computed in numpy
    uint32 arithmetic: integer ops, exact on every device."""
    with np.errstate(over="ignore"):
        for shape, seed in (((3, 40, 513), 7), ((5,), -3), ((2, 9), 2**40)):
            got = griffinlim.initial_phase(shape, seed, "cpu")
            assert np.array_equal(got.numpy(), _phase_np(shape, seed))
    a = griffinlim.initial_phase((3, 40, 513), 7, "cpu")
    b = griffinlim.initial_phase((3, 40, 513), 7, torch.device("cpu"))
    c = griffinlim.initial_phase((3, 40, 513), 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.float32 and a.shape == (3, 40, 513)
    assert float(a.min()) >= -np.pi and float(a.max()) < np.pi
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 1.8138) < 0.01
    mag = torch.from_numpy(np.abs(stft(_tones(), _cfg(), device="cpu")
                                  .numpy()))
    y = griffin_lim(mag, _cfg(), iters=2, length=12000, seed=7)
    z = griffinlim._griffin_lim_from(mag, griffinlim.initial_phase(
        mag.shape, 7, "cpu"), _cfg(), 2, 0.99, 12000)
    assert torch.equal(y, z)


def test_each_iteration_runs_one_istft(monkeypatch):
    """`iters` projections, each one istft and one stft, then a last
    istft: on the card, iters + 1 launches of B1."""
    from crlot_tpu_torch import pipeline

    calls = {"istft": 0, "stft": 0}
    for name in calls:
        orig = getattr(pipeline, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(pipeline, name, counted)
    mag = torch.ones((2, 20, 513))
    griffin_lim(mag, _cfg(), iters=5)
    assert calls == {"istft": 6, "stft": 5}
