"""The opt-in DFT formulations (quarter bases, the strided conv, the packed
products) against numpy and the reference's `crlot_tpu/fft/matmul_backend.py`.

Mirrors `tests/test_fft_quad.py` (slow in the reference; the port's run in
the fast lane) at its SIZES and gates (tests/fft_test.cc:76-82: target
1e-6, hard 1e-5): forward parts RMSE / sqrt(N) < 1e-6 and inverse RMSE <
1e-6 against float64 numpy, round-trip RMSE < 1e-5, quad vs tiled RMSE <
1e-6, the gained round-trip vs the numpy spectral pipeline < 1e-5, a tone
through the quad round-trip and OLA above 90 dB. Against the reference on
the same inputs (another GEMM order): the forward parts within max-abs
2e-6 * sqrt(N), the round-trip within 2e-6, the packed round-trip within
5e-6 and the conv (an EQ of +-5 dB) within 2e-5. The f64 designers are
byte-identical. On a CUDA tensor at HIGH the products whose shapes B0's
tiles take launch it (meta tensors, a recorded fake launch); cuDNN's TF32
stays off around `conv1d`.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu.fft import matmul_backend as jm

import crlot_tpu_torch as pt
from crlot_tpu_torch import cuda_build
from crlot_tpu_torch.fft import matmul_backend as mb
from crlot_tpu_torch.fft import tf32x3
from crlot_tpu_torch.int8_gemm import MODE_TF32X3
from crlot_tpu_torch.ola.fused import ola_normalized_auto
from crlot_tpu_torch.pipeline import _norm_np
from crlot_tpu_torch.window.windows import get_window

torch.set_num_threads(1)

SIZES = [4, 8, 12, 64, 100, 256, 512, 1024, 2048]
HANN = pt.WindowType.HANN


def _parity_split(spec):
    """numpy rfft -> the quad layout (re_e, re_o, re_nyq, im_e, im_o)."""
    h = spec.shape[-1] - 1
    re, im = spec.real, spec.imag
    return (re[..., 0:h:2], re[..., 1:h:2], re[..., h : h + 1],
            im[..., 2:h:2], im[..., 1:h:2])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("nfft", SIZES)
def test_quad_forward_matches_numpy_and_the_reference(nfft):
    x = np.random.default_rng(0).uniform(-1, 1, (3, nfft)).astype(np.float32)
    got = mb.rfft_folded_quad_parts(_t(x), nfft)
    want = _parity_split(np.fft.rfft(x.astype(np.float64), axis=-1))
    ref = jm.rfft_folded_quad_parts(jnp.asarray(x), nfft)
    scale = np.sqrt(nfft)
    for g, w, r, name in zip(got, want, ref,
                             ["re_e", "re_o", "re_nyq", "im_e", "im_o"]):
        g = g.numpy()
        assert g.shape == w.shape == r.shape, name
        if g.size == 0:  # im_e is empty at N=4
            continue
        assert np.sqrt(np.mean((g - w) ** 2)) / scale < 1e-6, name
        assert np.abs(g - np.asarray(r)).max() <= 2e-6 * scale, name


@pytest.mark.parametrize("nfft", SIZES)
def test_quad_inverse_matches_numpy(nfft):
    rng = np.random.default_rng(1)
    kk = nfft // 2 + 1
    spec = rng.normal(size=(3, kk)) + 1j * rng.normal(size=(3, kk))
    spec[..., 0] = spec[..., 0].real
    spec[..., -1] = spec[..., -1].real
    want = np.fft.irfft(spec, n=nfft, axis=-1)
    got = mb.irfft_folded_quad_parts(*[_t(p) for p in _parity_split(spec)],
                                     nfft).numpy()
    assert np.sqrt(np.mean((got - want) ** 2)) < 1e-6


@pytest.mark.parametrize("nfft", SIZES)
def test_quad_round_trip_rmse_and_the_reference(nfft):
    x = np.random.default_rng(2).uniform(-1, 1, (4, nfft)).astype(np.float32)
    w = np.ones(nfft, np.float64)
    y = mb.roundtrip_folded_quad(_t(x), nfft, w).numpy()
    assert np.sqrt(np.mean((x - y) ** 2)) < 1e-5
    ref = np.asarray(jm.roundtrip_folded_quad(jnp.asarray(x), nfft, w))
    assert np.abs(y - ref).max() <= 2e-6


@pytest.mark.parametrize("nfft", SIZES)
def test_quad_designers_are_the_references_bytes(nfft):
    got, want = mb._quad_consts(nfft), jm._quad_consts(nfft)
    for a, b in zip(got[:4] + got[4] + got[5:6], want[:4] + want[4]
                    + want[5:6]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got[6] == want[6]
    gains = np.linspace(0.5, 2.0, nfft // 2 + 1).tobytes()
    (g_arr, g_nyq), (r_arr, r_nyq) = (mb._quad_inverse_gained(nfft, gains),
                                      jm._quad_inverse_gained(nfft, gains))
    assert g_nyq == r_nyq
    assert all(a.tobytes() == b.tobytes() for a, b in zip(g_arr, r_arr))


@pytest.mark.parametrize("nfft", [512, 1024])
def test_quad_matches_tiled_windowed(nfft):
    x = _t(np.random.default_rng(3).uniform(-1, 1, (6, nfft)))
    w = get_window(HANN, nfft, True, dtype=np.float64)
    a = mb.roundtrip_folded_tiled(x, nfft, w, w).numpy()
    b = mb.roundtrip_folded_quad(x, nfft, w, w).numpy()
    assert np.sqrt(np.mean((a - b) ** 2)) < 1e-6


@pytest.mark.parametrize("nfft", [512, 1024])
def test_quad_per_bin_gains_match_tiled(nfft):
    x = _t(np.random.default_rng(4).uniform(-1, 1, (5, nfft)))
    w = get_window(HANN, nfft, True, dtype=np.float64)
    gains = 10 ** np.linspace(-0.5, 0.5, nfft // 2 + 1)
    a = mb.roundtrip_folded_tiled(x, nfft, w, per_bin_gains_f64=gains)
    b = mb.roundtrip_folded_quad(x, nfft, w, per_bin_gains_f64=gains)
    assert np.sqrt(np.mean((a.numpy() - b.numpy()) ** 2)) < 1e-6


def test_quad_gains_oracle():
    nfft = 1024
    x = np.random.default_rng(5).uniform(-1, 1, (2, nfft)).astype(np.float32)
    w = np.hanning(nfft).astype(np.float64)
    gains = np.linspace(0.25, 2.0, nfft // 2 + 1)
    want = np.fft.irfft(
        np.fft.rfft(x * w.astype(np.float32), axis=-1) * gains, n=nfft)
    got = mb.roundtrip_folded_quad(_t(x), nfft, w, per_bin_gains_f64=gains)
    assert np.sqrt(np.mean((got.numpy() - want) ** 2)) < 1e-5


def test_quad_supported_gate():
    for n in (256, 512, 768, 1024, 4096, 8192):
        assert mb.quad_supported(n) == jm.quad_supported(n)
    assert mb.quad_supported(512) and not mb.quad_supported(8192)


def test_quad_tone_round_trip_snr():
    n, hop, total = 1024, 256, 48000
    t = np.arange(total)
    x = (0.5 * np.sin(2 * np.pi * 440 * t / 48000)).astype(np.float32)
    w = get_window(HANN, n, True, dtype=np.float64)
    pad = n // 2
    xp = np.pad(x, pad, mode="reflect")
    num = (len(xp) - n) // hop + 1
    frames = np.stack([xp[i * hop : i * hop + n] for i in range(num)])
    out_frames = mb.roundtrip_folded_quad(_t(frames), n, w)
    full = (num - 1) * hop + n
    cfg = pt.StftConfig(frame_size=n, hop_size=hop, center=True)
    norm = _t(_norm_np(cfg, num, full))
    y = ola_normalized_auto(out_frames, norm, hop, full, 1e-8).numpy()
    assert pt.snr_db(x, y[pad : pad + total]) > 90.0


@pytest.mark.parametrize("synthesis", [False, True])
def test_packed_round_trip(synthesis):
    nfft = 1024
    w = get_window(HANN, nfft, True, dtype=np.float64)
    ws = w if synthesis else None
    fr = np.random.default_rng(6).uniform(-1, 1, (5, nfft)).astype(np.float32)
    got = mb.roundtrip_packed_matmul(_t(fr), nfft, w, ws).numpy()
    want = np.fft.irfft(np.fft.rfft(fr * w, axis=-1), n=nfft, axis=-1)
    if synthesis:
        want = want * w
    assert np.sqrt(np.mean((got - want) ** 2)) < 1e-6
    ref = np.asarray(jm.roundtrip_packed_matmul(jnp.asarray(fr), nfft, w, ws))
    assert np.abs(got - ref).max() <= 5e-6
    wb = w.tobytes()
    assert (mb._windowed_inverse_basis(nfft, wb).tobytes()
            == jm._windowed_inverse_basis(nfft, wb).tobytes())


def test_composed_conv_against_numpy_the_frames_and_the_reference():
    nfft, hop, nf = 1024, 256, 20
    w = get_window(HANN, nfft, True, dtype=np.float64)
    g = 10 ** np.linspace(-0.25, 0.25, nfft // 2 + 1)
    sig = np.random.default_rng(7).uniform(
        -1, 1, (2, nfft + hop * (nf - 1))).astype(np.float32)
    got = mb.roundtrip_composed_conv(_t(sig), nfft, hop, nf, w, g)
    frames = np.lib.stride_tricks.sliding_window_view(
        sig.astype(np.float64), nfft, axis=-1)[:, ::hop][:, :nf]
    want = np.fft.irfft(np.fft.rfft(frames * w, axis=-1) * g, n=nfft)
    assert got.shape == (2, nf, nfft)
    assert np.sqrt(np.mean((got.numpy() - want) ** 2)) < 1e-6
    via_frames = mb.roundtrip_composed_matmul(
        _t(sig).unfold(-1, nfft, hop)[:, :nf], nfft, w, g)
    assert np.abs(got.numpy() - via_frames.numpy()).max() <= 2e-5
    ref = np.asarray(jm.roundtrip_composed_conv(jnp.asarray(sig), nfft, hop,
                                                nf, w, g))
    assert np.abs(got.numpy() - ref).max() <= 2e-5


def test_conv_keeps_cudnn_tf32_as_it_found_it():
    nfft, hop = 256, 64
    w = np.hanning(nfft)
    sig = _t(np.random.default_rng(8).uniform(-1, 1, (1, 2048)))
    prev = torch.backends.cudnn.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = flag
            mb.roundtrip_composed_conv(sig, nfft, hop, 8, w,
                                       np.ones(nfft // 2 + 1))
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.fixture
def fake_launch(monkeypatch):
    """Records the mode of every B6 launch and lets meta tensors through
    the device check."""
    calls = []

    def launch(name, device, *args):
        calls.append((name, args[0] if name == "crlot_b6_gemm" else None))

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(tf32x3, "launches", 0)
    return calls


B0 = ("crlot_b6_gemm", MODE_TF32X3)


def test_high_on_a_card_tensor_runs_b0_where_its_tiles_fit(fake_launch):
    """At N = 512 the quad cores are [128, 128] (B0) and the sine cores
    [127, *] (IEEE fp32); the packed bases' N + 2 columns never fit; the
    conv reads its windows at lda = hop."""
    w = np.hanning(512)
    meta = torch.empty((4, 512), device="meta")
    mb.roundtrip_folded_quad(meta, 512, w)
    assert fake_launch.count(B0) == tf32x3.launches == 4  # ce, co, pe, po
    fake_launch.clear()
    mb.roundtrip_folded_quad(meta, 512, w,
                             precision=pt.FftPrecision.HIGHEST)
    assert not fake_launch
    mb.roundtrip_packed_matmul(meta, 512, w)
    assert not fake_launch
    sig = torch.empty((2, 512 + 128 * 7), device="meta")
    out = mb.roundtrip_composed_conv(sig, 512, 128, 8, w, np.ones(257))
    assert fake_launch == [B0] and out.shape == (2, 8, 512)
