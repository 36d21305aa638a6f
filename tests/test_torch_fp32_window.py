"""B0 at HIGHEST: the fixed-order IEEE fp32 windowed product
(`fft/fp32_window.py`, `csrc/fp32_window.cu`; ROADMAP C6).

On the CPU: its plain version (the float64 product cast to f32) against the
m-ordered `torch.matmul` loop that `hopblock_apply` runs on the CPU, and
against the reference's `hopblock_apply`, within K * 2^-24 * sum |x||k|
per output; the exact emulation of the kernel's fmaf chain against both;
and, on meta tensors with a recorded fake launch, that every caller of the
windowed product launches the kernel at HIGHEST (and B0's 3xTF32 mode at
HIGH and INT8X2), the scan form's frames products staying `torch.matmul`.
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crlot_tpu.fft.matmul_backend as jmm

import crlot_tpu_torch as pt
from crlot_tpu_torch import cuda_build, spectral
from crlot_tpu_torch import streaming_pipeline as sp
from crlot_tpu_torch.distributed import sharded_pipeline as spl
from crlot_tpu_torch.fft import fp32_window as fw
from crlot_tpu_torch.fft import matmul_backend as mb
from crlot_tpu_torch.int8_gemm import MODE_TF32X3


def _blocked_operands(per_bin, seed, channels=2, n=20000):
    """The blocked round-trip's kernel at N = 1024, H = 256 (G = 2, K =
    2048, N 512) and a signal padded as `hopblock_apply` pads it."""
    w = np.hanning(1024)
    kern, _ = mb.blocked_runtime_kernel(
        1024, 256, 2, w.tobytes(), None,
        np.asarray(per_bin, np.complex128).tobytes())
    x = np.random.default_rng(seed).uniform(-1, 1, (channels, n)).astype(
        np.float32)
    kt = torch.from_numpy(kern)
    x_ext, mg, nb = mb._hopblock_ext(torch.from_numpy(x), kt, 512, n, 768)
    return x, x_ext, kt, nb


PER_BIN = {"identity": np.ones(513),
           "EQ": np.where(np.arange(513) < 100, 0.5, 1.5)}


@pytest.mark.parametrize("name", list(PER_BIN))
def test_plain_vs_the_m_ordered_loop(name):
    """The float64 product cast to f32 and the CPU's m-ordered fp32 loop
    agree within one fmaf chain's bound of the exact sum."""
    x, x_ext, kt, nb = _blocked_operands(PER_BIN[name], 1)
    plain = fw.gemm_plain(x_ext, kt, rows=nb, lda=512).reshape(2, -1)
    loop = mb.hopblock_apply(torch.from_numpy(x), kt, 512, x.shape[-1], 768,
                             pt.FftPrecision.HIGHEST)
    tol = fw.tolerance(x_ext, kt, rows=nb, lda=512).reshape(2, -1)
    n = x.shape[-1]
    assert ((plain[:, :n] - loop).abs().double() <= tol[:, :n]).all()
    assert float((plain[:, :n] - loop).abs().max()) < 1e-5


def test_plain_vs_the_reference_hopblock_apply():
    x, x_ext, kt, nb = _blocked_operands(PER_BIN["EQ"], 2)
    want = np.asarray(jmm.hopblock_apply(
        jnp.asarray(x), jnp.asarray(kt.numpy()), 512, x.shape[-1], 768,
        precision=jmm.jax.lax.Precision.HIGHEST))
    plain = fw.gemm_plain(x_ext, kt, rows=nb, lda=512).reshape(2, -1)
    tol = fw.tolerance(x_ext, kt, rows=nb, lda=512).reshape(2, -1)
    n = x.shape[-1]
    diff = (plain[:, :n].double() - torch.from_numpy(want).double()).abs()
    assert (diff <= tol[:, :n]).all()


def test_chain_emulation_within_the_bound_of_both():
    """The kernel's exact arithmetic (one fmaf a step, k ascending) lies
    within K * 2^-24 * sum |x||k| of the float64 product, and of the
    m-ordered loop within twice that."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 40 * 64 + 256)).astype(
        np.float32))
    kern = torch.from_numpy(rng.uniform(-1, 1, (256, 64)).astype(np.float32))
    chain = fw.chain_plain(x, kern, rows=41, lda=64)
    plain = fw.gemm_plain(x, kern, rows=41, lda=64)
    tol = fw.tolerance(x, kern, rows=41, lda=64)
    assert ((chain - plain).abs().double() <= tol).all()
    blocks = x.reshape(2, -1, 64)
    loop = sum(torch.matmul(blocks[:, m : m + 41], kern[m * 64:(m + 1) * 64])
               for m in range(4))
    assert ((chain - loop).abs().double() <= 2 * tol).all()


def test_chain_emulation_is_row_local():
    """A row's chain depends on its window alone: the rows of a slice of
    the signal equal the same rows of the whole, bit for bit (what the
    card's chunked == one-shot rests on)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 30 * 64 + 192)).astype(
        np.float32))
    kern = torch.from_numpy(rng.uniform(-1, 1, (256, 64)).astype(np.float32))
    whole = fw.chain_plain(x, kern, rows=30, lda=64)
    part = fw.chain_plain(x[:, 7 * 64:].contiguous(), kern, rows=20, lda=64)
    assert torch.equal(part, whole[:, 7:27])


def test_chain_emulation_is_an_fmaf_chain():
    """One output by hand: the chain rounds after every step, so 1 + 2^-24
    + 2^-24 - 1 is 0 (each 2^-24 is a tie lost to even), where the float64
    product gives 2^-23; both lie within the bound."""
    a = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -24, -1.0]])
    w = torch.ones((4, 1))
    assert float(fw.chain_plain(a, w)[0, 0]) == 0.0
    assert float(fw.gemm_plain(a, w)[0, 0]) == 2.0 ** -23
    assert 2.0 ** -23 <= float(fw.tolerance(a, w)[0, 0])


@pytest.fixture
def fake_launch(monkeypatch):
    calls = []

    def launch(name, device, *args):
        calls.append((name, args[0] if name == "crlot_b6_gemm" else None))

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(fw, "launches", 0)
    return calls


FP32 = ("crlot_fp32_window", None)
B0 = ("crlot_b6_gemm", MODE_TF32X3)


def _meta(shape):
    return torch.empty(shape, device="meta")


def _hopblock(precision):
    return mb.hopblock_apply(_meta((2, 3000)), _meta((4 * 128, 128)), 128,
                             3200, 384, precision)


def _round_trip(precision):
    cfg = pt.StftConfig(frame_size=256, hop_size=64, center=True,
                        fft_precision=precision)
    return pt.round_trip(_meta((2, 4000)), cfg)


def _streamer(precision):
    cfg = pt.StftConfig(frame_size=256, hop_size=64, fft_precision=precision)
    st_ = pt.BlockedChunkStreamer(cfg)
    st_.feed(_meta((1024,)), force=False)
    return st_.feed(_meta((1024,)), force=False)


def _sharded(precision):
    cfg = pt.StftConfig(frame_size=256, hop_size=64, fft_precision=precision)
    plan = mb.blocked_plan_for(cfg, mb.blocked_response(cfg, None))
    return spl._blocked_local_round_trip(
        [_meta((2, 1024)), _meta((2, 1024))], plan, cfg, 29, 1024, 2)[0]


def _convolve(precision):
    return pt.convolve(_meta((2, 3000)), np.hanning(31), "same",
                       precision=precision)


WINDOWED = {"hopblock_apply": _hopblock, "round_trip": _round_trip,
            "BlockedChunkStreamer": _streamer, "sharded blocked": _sharded,
            "convolve": _convolve}


@pytest.mark.parametrize("name", list(WINDOWED))
def test_highest_launches_the_fp32_window_kernel(fake_launch, name):
    WINDOWED[name](pt.FftPrecision.HIGHEST)
    assert FP32 in fake_launch and B0 not in fake_launch
    assert fw.launches == fake_launch.count(FP32) >= 1


@pytest.mark.parametrize("precision", ["HIGH", "INT8X2"])
@pytest.mark.parametrize("name", list(WINDOWED))
def test_high_and_int8_tiers_launch_the_3xtf32_mode(fake_launch, name,
                                                    precision):
    WINDOWED[name](getattr(pt.FftPrecision, precision))
    assert B0 in fake_launch and FP32 not in fake_launch


def test_scan_form_products_stay_torch_matmul_at_highest(fake_launch):
    cfg = pt.StftConfig(frame_size=256, hop_size=64,
                        fft_precision=pt.FftPrecision.HIGHEST,
                        fft_backend=pt.FftBackend.MATMUL)
    frames = _meta((2, 4096)).unfold(-1, 256, 64)
    eq = spectral.band_gain([1000.0], [1.0, 0.5], 48000, 256)
    sp._frames_round_trip(frames, cfg)
    sp._frames_round_trip(frames, cfg, eq)
    assert fake_launch == []


def test_wrapper_refuses_what_the_kernel_cannot_take(fake_launch):
    kern = _meta((512, 128))
    with pytest.raises(ValueError, match="f32"):
        fw.gemm_cuda(_meta((2, 4096)).to(torch.float64), kern, rows=4,
                     lda=128)
    with pytest.raises(ValueError, match="multiples of 4"):
        fw.gemm_cuda(_meta((2, 4094)), kern[:, :126].contiguous(), rows=4,
                     lda=126)
    with pytest.raises(ValueError, match="need"):
        fw.gemm_cuda(_meta((2, 1000)), kern, rows=8, lda=128)
    fw.gemm_cuda(_meta((2, 4096)), kern, rows=4, lda=128)
    assert fake_launch == [FP32]


def test_on_meta_raises_without_a_card():
    with pytest.raises(ValueError, match="one CUDA device"):
        fw.gemm_cuda(_meta((2, 4096)), _meta((512, 128)), rows=4, lda=128)


def test_cuda_source_is_in_the_build_and_bound():
    src = cuda_build.CSRC / "fp32_window.cu"
    assert src in cuda_build.sources()
    assert "crlot_fp32_window" in src.read_text()
    assert "crlot_fp32_window" in cuda_build._SIGNATURES
