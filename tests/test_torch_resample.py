"""The port's polyphase resampler vs the reference on the CPU.

The same numpy inputs from a seed go to `crlot_tpu.resample` (JAX on the
CPU; its Pallas kernel in interpret mode) and to `crlot_tpu_torch.resample`.
Tolerances: the filter banks are byte-identical (same float64 design code);
the resampled signals agree to 1e-5 max-abs (fp32 products summed in
another order), the reference's own gate for its Pallas kernel; chunked vs
one-shot to 2e-6, the reference's gate; against scipy's float64
resample_poly with the same filter, SNR > 120 dB.
"""

import math

import numpy as np
import pytest
import torch
from scipy import signal as sps

import jax.numpy as jnp

from crlot_tpu.resample import polyphase as jp
from crlot_tpu.resample.pallas_kernel import resample_pallas

from crlot_tpu_torch.metrics import snr_db
from crlot_tpu_torch.resample import kernel as tk
from crlot_tpu_torch.resample import polyphase as tp

RATES = [(44100, 48000), (48000, 16000), (8000, 12000)]


def _lm(sr_in, sr_out):
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def _noise(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _sine(sr, seconds, freq, amp=0.7):
    t = np.arange(int(sr * seconds), dtype=np.float64) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_design_arrays_byte_identical(sr_in, sr_out):
    l, m = _lm(sr_in, sr_out)
    assert tp.kaiser_beta(120.0) == jp.kaiser_beta(120.0)
    assert tp.design_lowpass(l, m).tobytes() == jp.design_lowpass(l, m).tobytes()
    bank, tau_min, w = tp._kernel_bank(l, m, None, 120.0)
    jbank, jtau, jw = jp._kernel_bank(l, m, None, 120.0)
    assert (tau_min, w) == (jtau, jw)
    assert bank.dtype == jbank.dtype and bank.tobytes() == jbank.tobytes()
    g = tp._group_count(l)
    assert g == jp._group_count(l)
    k2, tau2, span = tp._grouped_kernel(l, m, None, 120.0, g)
    jk2, jtau2, jspan = jp._grouped_kernel(l, m, None, 120.0, g)
    assert (tau2, span) == (jtau2, jspan) and k2.tobytes() == jk2.tobytes()
    assert tp.output_length(4410, sr_in, sr_out) == jp.output_length(
        4410, sr_in, sr_out)


@pytest.mark.parametrize("sr_in,sr_out", RATES + [(44100, 16000)])
def test_compact_bank_holds_every_nonzero_tap(sr_in, sr_out):
    """B4's table: row i's taps are bank[i, offsets[i] : offsets[i] + tp]
    and every entry outside that run is exactly 0.0."""
    l, m = _lm(sr_in, sr_out)
    bank, tau_min, w = tp._kernel_bank(l, m, None, 120.0)
    taps_t, offsets, tau_c, w_c = tk.compact_bank(l, m, None, 120.0)
    assert (tau_c, w_c) == (tau_min, w)
    n_taps = taps_t.shape[0]
    assert offsets.min() >= 0 and offsets.max() + n_taps <= w
    dense = np.zeros_like(bank)
    for i in range(l):
        dense[i, offsets[i] : offsets[i] + n_taps] = taps_t[:, i]
    assert dense.tobytes() == bank.tobytes()
    expect = {(160, 147): (157, 303), (1, 3): (469, 469),
              (160, 441): (431, 869)}  # taps per output: compact, dense
    assert expect.get((l, m), (n_taps, w)) == (n_taps, w)
    assert 0 < tk.geometry(l, m).seg_floats * 4 <= tk.MAX_SHARED_BYTES


@pytest.mark.parametrize("sr_in,sr_out", RATES)
@pytest.mark.parametrize("channels", [None, 2])
def test_resample_matches_reference(sr_in, sr_out, channels):
    shape = 4410 if channels is None else (channels, 4410)
    x = _noise(shape, sr_in + sr_out)
    got = tp.resample(torch.from_numpy(x), sr_in, sr_out).numpy()
    want = np.asarray(jp.resample(jnp.asarray(x), sr_in, sr_out))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-5


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_resample_matches_scipy_resample_poly(sr_in, sr_out):
    l, m = _lm(sr_in, sr_out)
    x = _noise(4410, 0)
    h = tp.design_lowpass(l, m)
    # scipy multiplies a given window by `up`; the design carries gain L.
    want = sps.resample_poly(x.astype(np.float64), l, m, window=h / l)
    got = tp.resample(x, sr_in, sr_out, device="cpu").numpy()
    assert got.shape == want.shape == (tp.output_length(4410, sr_in, sr_out),)
    assert snr_db(want, got) > 120.0


@pytest.mark.parametrize("sr_in,sr_out,n", [
    (8000, 12000, 4000), (44100, 48000, 14700), (48000, 16000, 1200),
])
def test_bank_plain_matches_pallas_kernel(sr_in, sr_out, n):
    """B4's plain version vs the Pallas kernel it replaces (interpret
    mode), and vs the grouped form `resample` runs on the CPU."""
    l, m = _lm(sr_in, sr_out)
    x = _noise((2, n), n)
    n_out = tp.output_length(n, sr_in, sr_out)
    got = tk.resample_bank_plain(torch.from_numpy(x), l, m, n_out).numpy()
    assert got.shape == (2, n_out)
    for c in range(2):
        want = np.asarray(resample_pallas(jnp.asarray(x[c]), l, m, n_out,
                                          interpret=True))
        assert np.max(np.abs(got[c] - want)) <= 1e-5
    mono = tk.resample_bank_plain(torch.from_numpy(x[0]), l, m, n_out)
    assert mono.shape == (n_out,)
    grouped = tp.resample_grouped_plain(torch.from_numpy(x), l, m, n_out)
    assert np.max(np.abs(got - grouped.numpy())) <= 1e-5


def test_bank_plain_slabs_agree_with_one_product(monkeypatch):
    """The plain version's block slabs only bound its window copy (the
    product's own blocking may regroup sums: fp32 rounding, 1e-6)."""
    x = torch.from_numpy(_noise((2, 3000), 9))
    n_out = tp.output_length(3000, 48000, 16000)
    whole = tk.resample_bank_plain(x, 1, 3, n_out)
    monkeypatch.setattr(tk, "_SLAB", 469 * 2 * 7)  # 7 blocks per slab
    np.testing.assert_allclose(tk.resample_bank_plain(x, 1, 3, n_out).numpy(),
                               whole.numpy(), atol=1e-6)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_chunked_matches_oneshot(as_tensor):
    x = _noise((2, 44100), 2)
    want = tp.resample(x, 44100, 48000, device="cpu").numpy()
    arg = torch.from_numpy(x) if as_tensor else x
    where = {} if as_tensor else {"device": "cpu"}  # a tensor stays put
    got = tp.resample_chunked(arg, 44100, 48000, chunk=8192, **where)
    assert isinstance(got, torch.Tensor) == as_tensor
    got = got.numpy() if as_tensor else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-6)
    mono = tp.resample_chunked(x[0], 44100, 48000, chunk=8192, device="cpu")
    ref = jp.resample_chunked(x[0], 44100, 48000, chunk=8192)
    assert isinstance(mono, np.ndarray) and mono.shape == ref.shape
    assert np.max(np.abs(mono - ref)) <= 1e-5


def test_a_card_that_was_asked_for_is_not_replaced():
    """Only a CPU tensor takes a plain version: any other device goes to
    B4's wrapper, which raises (no fallback to the CPU)."""
    x = np.zeros(1000, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tp.resample_chunked(x, 44100, 48000, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tp.resample(torch.zeros((2, 1000), device="meta"), 44100, 48000)
    with pytest.raises(ValueError, match="CUDA"):
        tk.resample_cuda(torch.zeros(1000), 160, 147, 1089)
    with pytest.raises(ValueError, match="own device"):
        tp.resample_chunked(torch.zeros(1000), 44100, 48000, device="cpu")


def test_resampled_stft_matches_reference():
    from crlot_tpu.core.types import StftConfig as JCfg
    from crlot_tpu.pipeline import resampled_stft as j_rs

    from crlot_tpu_torch.core.types import StftConfig
    from crlot_tpu_torch.pipeline import resampled_stft, stft

    x = (0.9 * _noise(44100, 11)).astype(np.float32)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)
    got = resampled_stft(torch.from_numpy(x), 44100, 48000, cfg).numpy()
    want = np.asarray(j_rs(jnp.asarray(x), 44100, 48000,
                           JCfg(frame_size=1024, hop_size=256, center=False)))
    n_out = tp.output_length(44100, 44100, 48000)
    assert got.shape == want.shape == (cfg.frame_spec.num_frames(n_out), 513)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) <= 1e-5 * scale
    seq = stft(tp.resample(torch.from_numpy(x), 44100, 48000), cfg).numpy()
    np.testing.assert_array_equal(got, seq)


def test_sine_fidelity_44k_to_48k():
    y = tp.resample(_sine(44100, 1.0, 1000.0), 44100, 48000,
                    device="cpu").numpy()
    ideal = _sine(48000, len(y) / 48000, 1000.0)[: len(y)]
    edge = 4800
    assert snr_db(ideal[edge:-edge], y[edge:-edge]) > 100.0


def test_chain_44k_48k_16k():
    x = torch.from_numpy(_sine(44100, 1.0, 997.0))
    y16 = tp.resample(tp.resample(x, 44100, 48000), 48000, 16000).numpy()
    ideal = _sine(16000, len(y16) / 16000, 997.0)[: len(y16)]
    edge = 1600
    assert snr_db(ideal[edge:-edge], y16[edge:-edge]) > 90.0


def test_stopband_rejection():
    y = tp.resample(_sine(48000, 0.5, 11000.0), 48000, 16000,
                    device="cpu").numpy()
    core = y[1600:-1600].astype(np.float64)
    atten = 20 * np.log10((0.7 / np.sqrt(2)) / max(np.sqrt(np.mean(core**2)),
                                                   1e-12))
    assert atten > 80.0, f"stopband attenuation {atten:.1f} dB"


def test_dc_preservation():
    y = tp.resample(np.full(10000, 0.5, np.float32), 44100, 48000,
                    device="cpu").numpy()
    np.testing.assert_allclose(y[2000:-2000], 0.5, atol=1e-4)


def test_multichannel_is_per_channel():
    x = _noise((3, 4410), 1)
    y = tp.resample(x, 44100, 48000, device="cpu").numpy()
    assert y.shape == (3, tp.output_length(4410, 44100, 48000))
    for c in range(3):
        np.testing.assert_allclose(y[c], tp.resample(x[c], 44100, 48000,
                                                     device="cpu"),
                                   atol=2e-6)


def test_identity_rate():
    x = np.arange(100, dtype=np.float32)
    np.testing.assert_array_equal(
        tp.resample(x, 48000, 48000, device="cpu").numpy(), x)
    np.testing.assert_array_equal(
        tp.resample_chunked(x, 48000, 48000, device="cpu"), x)


@pytest.mark.parametrize("call", [
    lambda: tp.resample(np.zeros(10, np.float32), 0, 48000, device="cpu"),
    lambda: tp.resample(np.zeros((2, 3, 4), np.float32), 44100, 48000,
                        device="cpu"),
    lambda: tp.resample_chunked(np.zeros(10, np.float32), 44100, -1,
                                device="cpu"),
    lambda: tp.resample_chunked(np.zeros(10, np.float32), 44100, 48000,
                                chunk=0, device="cpu"),
])
def test_invalid(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("sr_in,sr_out,staged", [
    (44100, 48000, True), (48000, 16000, True), (141, 1, True),
    (142, 1, False), (48000, 300, False)])
def test_b4_geometry_takes_every_rate(sr_in, sr_out, staged):
    """B4's launch geometry on its own (no card needed): where the input
    segment outgrows shared memory (integer decimation above M = 141, e.g.
    48 kHz -> 300 Hz, M = 160) it reads x through the read-only cache
    instead of refusing the rate."""
    g = math.gcd(sr_in, sr_out)
    l, m = sr_out // g, sr_in // g
    _, _, _, w = tk.compact_bank(l, m, None, 120.0)
    plan = tk.geometry(l, m)
    assert (plan.kind != "windows") == staged and plan.r in (0, 1, 2, 4, 8)
    if staged:
        assert 0 < plan.seg_floats * 4 <= tk.MAX_SHARED_BYTES
    else:
        assert tk.blocks_segment(l, m, w, 1) * 4 > tk.MAX_SHARED_BYTES


def test_high_decimation_matches_reference():
    """48 kHz -> 300 Hz (M = 160) on the CPU path, against the reference's
    grouped form, within the 1e-5 of the other rates."""
    x = _noise((2, 48000), 9)
    got = tp.resample(x, 48000, 300, device="cpu").numpy()
    want = np.asarray(jp.resample(jnp.asarray(x), 48000, 300))
    assert got.shape == want.shape == (2, 300)
    assert np.max(np.abs(got - want)) <= 1e-5
    bank = tk.resample_bank_plain(torch.from_numpy(x), 1, 160, 300).numpy()
    assert np.max(np.abs(bank - want)) <= 1e-5
