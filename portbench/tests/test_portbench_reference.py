"""The float64 reference against independent float64 arithmetic (numpy's
FFT, frame by frame) at small sizes, and the TF32 rounding."""

import numpy as np
import torch

from portbench.reference import stft64

CONFIG = {"frame_size": 64, "hop_size": 16, "window": "hann",
          "periodic": True, "eps": 1e-8, "sample_rate": 48000}
EQ = {"kind": "band_gain", "edges_hz": [3000, 12000],
      "gains": [0.5, 1.0, 0.25]}
GATE = {"kind": "noise_gate", "threshold_db": -20.0, "attenuation_db": -60.0}


def _numpy_round_trip(x, n, hop, fn):
    """Frame, window, rfft, fn, irfft, overlap-add, divide by the window's
    coverage: the definition, in numpy."""
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    f = (x.shape[-1] - n) // hop + 1
    out = np.zeros(x.shape[:-1] + ((f - 1) * hop + n,))
    norm = np.zeros((f - 1) * hop + n)
    for i in range(f):
        spec = fn(np.fft.rfft(x[..., i * hop : i * hop + n] * w))
        out[..., i * hop : i * hop + n] += np.fft.irfft(spec, n)
        norm[i * hop : i * hop + n] += w
    return out / np.maximum(norm, 1e-8)


def _signal(rows=3, length=1024, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (rows, length))


def test_identity_reconstructs():
    x = _signal()
    rt = stft64.RoundTrip(CONFIG, {"kind": "identity"}, "cpu")
    y = stft64.clip_round_trip(rt, torch.from_numpy(x), center=True).numpy()
    assert np.max(np.abs(y - x)) < 1e-12


def test_eq_is_the_per_bin_gain():
    x = _signal()
    g = stft64.per_bin_gains(EQ, 64, 48000)
    assert list(g[:5]) == [0.5, 0.5, 0.5, 0.5, 0.5] and g[-1] == 0.25
    rt = stft64.RoundTrip(CONFIG, EQ, "cpu")
    y = rt.segment(torch.from_numpy(x)).numpy()
    ref = _numpy_round_trip(x, 64, 16, lambda s: s * g)
    # the first sample's coverage is w[0] = 0: its value is acc / eps
    assert np.allclose(y, ref, rtol=1e-11, atol=1e-11)


def test_gate_matches_numpy_and_counts_bins():
    x = _signal() * 0.05
    thresh, att = stft64.gate_levels(GATE)
    rt = stft64.RoundTrip(CONFIG, GATE, "cpu")
    y = rt.segment(torch.from_numpy(x)).numpy()
    ref = _numpy_round_trip(
        x, 64, 16, lambda s: np.where(np.abs(s) ** 2 >= thresh, s, s * att))
    assert np.allclose(y, ref, rtol=1e-11, atol=1e-11)
    assert 0 < rt.gated_bins < rt.bins


def test_stream_positions_are_the_one_shot():
    ring = [torch.from_numpy(_signal(2, 256, s)) for s in range(3)]
    stream = torch.cat([ring[k % 3] for k in range(6)], dim=-1)
    rt = stft64.RoundTrip(CONFIG, EQ, "cpu")
    whole = rt.segment(stream)
    part = stft64.stream_round_trip(rt, ring, 256, slice(None), 512, 768)
    assert torch.allclose(part, whole[:, 512:768], rtol=0, atol=1e-13)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12,
                      1.0 + 2 ** -10])
    y = stft64.tf32_round(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -9, -3.0, 1.0 + 2 ** -10]


def test_compare_reads_relative_errors():
    r = torch.ones(4, 8, dtype=torch.float64)
    y = r.clone()
    y[0, 0] += 0.5
    c = stft64.compare(y, r)
    assert abs(c["peak_rel"] - 0.5) < 1e-15
    assert abs(c["err_rel"] - 0.5 / np.sqrt(32)) < 1e-15
    y[1, 1] = float("nan")
    assert stft64.compare(y, r)["err_rel"] == float("inf")
