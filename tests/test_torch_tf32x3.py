"""3xTF32 (the HIGH tier on Hopper), B0 and the redesigned B2 / B3 on the CPU.

What the kernels' plain versions and the routes around them hold, at small
sizes: the TF32 split (hi keeps TF32's 10 mantissa bits, |a - (hi + lo)| <=
2^-21 |a|), the plain 3xTF32 product against float64 and against the
reference's `hopblock_apply` (JAX on the CPU), the host's transposed TF32
bases, the `precision` routing of every `hopblock_apply` caller (the CPU
runs the IEEE fp32 loop; a CUDA or meta tensor at HIGH demands B0, and B3 for
the scan form's folded parts, with no fallback), the fold pass's plain
version, the frame rows B0 and B3 read in place, and the ambiguous-bin
helper of the decision-aware comparisons (ROADMAP C12).
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from crlot_tpu.fft.matmul_backend import hopblock_apply as j_hopblock_apply

import crlot_tpu_torch as pt
from crlot_tpu_torch import cuda_build, spectral
from crlot_tpu_torch import streaming_pipeline as sp
from crlot_tpu_torch.distributed import sharded_pipeline as spl
from crlot_tpu_torch.fft import fused_rt, tf32x3
from crlot_tpu_torch.fft import matmul_backend as mb
from crlot_tpu_torch.int8_gemm import MODE_TF32X3

# The split's domain: zero, and magnitudes from 1e-30 (the residual a - hi
# stays a normal float) to 1e38 (hi does not round to infinity); audio is
# many decades inside it.
_BIG, _SMALL = float(np.float32(1e38)), float(np.float32(1e-30))
F32 = st.one_of(st.just(0.0), st.builds(
    lambda m, neg: -m if neg else m,
    st.floats(width=32, min_value=_SMALL, max_value=_BIG), st.booleans()))


# --- the split -------------------------------------------------------------


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(F32, min_size=1, max_size=64))
def test_split_keeps_tf32_mantissa_and_21_bits(values):
    a = torch.tensor(values, dtype=torch.float32)
    hi, lo = tf32x3.split(a)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    a64, rebuilt = a.double(), hi.double() + lo.double()
    assert bool(((a64 - rebuilt).abs() <= 2.0 ** -21 * a64.abs()).all())


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(F32, min_size=1, max_size=64))
def test_tf32_round_is_nearest_ties_away(values):
    """hi is the float64 value rounded to 11 significant bits, half away
    from zero, as `cvt.rna.tf32.f32` rounds; numpy and torch agree."""
    a = np.asarray(values, np.float32)
    got = tf32x3.tf32_round(torch.from_numpy(a)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          tf32x3.tf32_round_np(a).view(np.uint32))
    x = a.astype(np.float64)
    m, e = np.frexp(x)  # x = m * 2^e, 0.5 <= |m| < 1
    want = np.ldexp(np.sign(m) * np.floor(np.abs(m) * 2048 + 0.5) / 2048, e)
    finite = np.isfinite(want) & (np.abs(want) < np.finfo(np.float32).max)
    np.testing.assert_array_equal(got[finite], want[finite].astype(np.float32))


def test_split_of_ties_and_edges():
    ulp = 2.0 ** -10  # of TF32 at 1.0
    a = np.array([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4, 0.0, -0.0,
                  3.0], np.float32)
    hi, lo = tf32x3.split_np(a)
    np.testing.assert_array_equal(hi, [1.0 + ulp, -(1.0 + ulp), 1.0, 0.0,
                                       0.0, 3.0])
    np.testing.assert_array_equal(hi + lo, a)


# --- B0's plain version ------------------------------------------------------


def _windows_case(seed, batch=2, rows=37, lda=64, k=256, n=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (batch, (rows - 1) * lda + k)).astype(np.float32)
    kern = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    return x, kern


@pytest.mark.parametrize("seed", range(4))
def test_plain_3xtf32_product_vs_float64(seed):
    x, kern = _windows_case(seed)
    bt = [torch.from_numpy(a) for a in tf32x3.split_t(kern)]
    got = tf32x3.gemm_plain(torch.from_numpy(x), *bt, rows=37,
                            lda=64).double()
    win = torch.from_numpy(x).unfold(-1, 256, 64)[:, :37].double()
    want = win @ torch.from_numpy(kern).double()
    scale = win.abs() @ torch.from_numpy(kern).double().abs()
    assert got.shape == (2, 37, 64)
    assert float(((got - want).abs() / scale).max()) <= tf32x3.REL_TOL


@pytest.mark.parametrize("block,mg,left", [(64, 4, 192), (128, 3, 0),
                                           (256, 2, 256)])
def test_hopblock_tf32x3_plain_vs_reference(block, mg, left):
    """The B0 route's plain version against the reference's hopblock_apply
    (JAX on the CPU, f32) within REL_TOL of sum |x||k|, and the port's fp32
    loop against it within 1e-6 of the same."""
    rng = np.random.default_rng(block + mg)
    x = rng.uniform(-1, 1, (2, 2000)).astype(np.float32)
    kern = rng.uniform(-1, 1, (mg * block, block)).astype(np.float32)
    n_out = 2000 + left
    want = np.asarray(j_hopblock_apply(jnp.asarray(x), kern, block, n_out,
                                       left)).astype(np.float64)
    tx, tk = torch.from_numpy(x), torch.from_numpy(kern)
    plain = mb.hopblock_apply_tf32x3_plain(tx, tk, block, n_out, left)
    loop = mb.hopblock_apply(tx, tk, block, n_out, left)
    x_ext, _, nb = mb._hopblock_ext(tx, tk, block, n_out, left)
    scale = (x_ext.unfold(-1, mg * block, block)[:, :nb].abs().double()
             @ tk.abs().double()).reshape(2, -1)[:, :n_out]
    assert plain.shape == loop.shape == want.shape
    assert float(((plain.double() - torch.from_numpy(want)).abs()
                  / scale).max()) <= tf32x3.REL_TOL
    assert float(((loop.double() - torch.from_numpy(want)).abs()
                  / scale).max()) <= 1e-6


# --- the host's transposed TF32 halves --------------------------------------


@pytest.mark.parametrize("nfft", [16, 256, 1024])
def test_tf32_bases_rebuild_the_folded_bases(nfft):
    c, s = mb._folded_forward_consts(nfft)
    cinv, sinv = mb._folded_inverse_consts(nfft)
    k, h, kp = nfft // 2 + 1, nfft // 2, fused_rt.padded_bins(nfft)
    b = fused_rt.tf32_bases(nfft)
    assert kp % 8 == 0 and kp >= k and all(a.shape == (kp, kp) for a in b)
    pairs = [(b[0], b[1], c.T, np.s_[:k, : h + 1]),
             (b[2], b[3], s.T, np.s_[:k, 1:h]),
             (b[4], b[5], cinv.T, np.s_[: h + 1, :k]),
             (b[6], b[7], sinv.T, np.s_[1:h, :k])]
    for hi, lo, want, where in pairs:
        full = np.zeros((kp, kp), np.float32)
        full[where] = want
        np.testing.assert_array_equal(hi, tf32x3.tf32_round_np(full))
        err = np.abs((hi.astype(np.float64) + lo) - full)
        assert np.all(err <= 2.0 ** -21 * np.abs(full))


def test_runtime_kernel_halves_rebuild_the_kernel():
    cfg = pt.StftConfig(frame_size=256, hop_size=64)
    wb = np.ascontiguousarray(pt.pipeline._window_f64(cfg)).tobytes()
    rb = np.ones(129, np.complex128).tobytes()
    kern, _ = mb.blocked_runtime_kernel(256, 64, 2, wb, None, rb)
    hi, lo = mb._runtime_bt_on(256, 64, 2, wb, None, rb, torch.device("cpu"))
    assert hi.shape == (kern.shape[1], kern.shape[0])
    np.testing.assert_array_equal(hi.numpy().T, tf32x3.tf32_round_np(kern))
    err = np.abs(hi.numpy().T.astype(np.float64) + lo.numpy().T - kern)
    assert np.all(err <= 2.0 ** -21 * np.abs(kern))


def test_tf32_bases_compute_the_folded_dft():
    """e.C and o.S with the halves summed in float64 give the rfft of the
    windowed frame, and the inverse pair gives back the frame."""
    nfft = 64
    rng = np.random.default_rng(1)
    y = rng.uniform(-1, 1, (5, nfft)).astype(np.float32)
    e, o = fused_rt.fold_plain(torch.from_numpy(y), torch.ones(nfft))
    b = [a.astype(np.float64) for a in fused_rt.tf32_bases(nfft)]
    re = e.double().numpy() @ (b[0] + b[1]).T
    im = o.double().numpy() @ (b[2] + b[3]).T
    spec = np.fft.rfft(y.astype(np.float64), axis=-1)
    k = nfft // 2 + 1
    np.testing.assert_allclose(re[:, :k], spec.real, atol=1e-4)
    np.testing.assert_allclose(im[:, :k], spec.imag, atol=1e-4)
    a = re @ (b[4] + b[5]).T
    bb = im @ (b[6] + b[7]).T
    h = nfft // 2
    frame = np.concatenate([a[:, : h + 1] + bb[:, : h + 1],
                            (a[:, 1:h] - bb[:, 1:h])[:, ::-1]], axis=-1)
    np.testing.assert_allclose(frame, y, atol=1e-5)


# --- the fold pass -----------------------------------------------------------


@pytest.mark.parametrize("nfft", [4, 64, 256, 1024])
def test_fold_plain_bit_equal_to_fold_frames(nfft):
    rng = np.random.default_rng(nfft)
    frames = torch.from_numpy(rng.uniform(-1, 1, (3, 7, nfft)).astype(
        np.float32))
    w = torch.from_numpy(np.hanning(nfft + 1)[:-1].astype(np.float32))
    e, o = fused_rt.fold_plain(frames, w)
    even, odd = mb._fold_frames(frames * w, nfft)
    h, kp = nfft // 2, fused_rt.padded_bins(nfft)
    assert e.shape == o.shape == (3, 7, kp)
    assert torch.equal(e[..., : h + 1], even)
    assert torch.equal(o[..., 1:h], odd)
    assert not bool(e[..., h + 1 :].any()) and not bool(o[..., h:].any())
    assert not bool(o[..., 0].any())


# --- frame rows read in place ------------------------------------------------


def test_frame_rows_reads_a_window_view_in_place():
    x = torch.arange(2 * 4096, dtype=torch.float32).reshape(2, 4096)
    frames = x.unfold(-1, 1024, 256)  # [2, 13, 1024], strides (4096, 256, 1)
    sig, rows, lda = tf32x3.frame_rows(frames)
    assert (rows, lda) == (13, 256) and sig.data_ptr() == x.data_ptr()
    assert torch.equal(sig.unfold(-1, 1024, lda)[:, :rows], frames)
    one = x[0].unfold(-1, 1024, 256)[:8].reshape(2, 4, 1024).reshape(-1, 1024)
    sig1, rows1, lda1 = tf32x3.frame_rows(one)
    assert (rows1, lda1) == (8, 256) and sig1.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("make", [
    lambda x: x[:, 3:].unfold(-1, 1024, 256),          # 12-byte offset
    lambda x: x.unfold(-1, 1024, 100),                 # stride off 128 B
    lambda x: x.unfold(-1, 1024, 384),                 # stride off N
    lambda x: x.unfold(-1, 1024, 256).transpose(0, 1),  # batch stride
])
def test_frame_rows_copies_what_b0_cannot_read(make):
    x = torch.randn(2, 4096)
    frames = make(x)
    sig, rows, lda = tf32x3.frame_rows(frames)
    assert lda == 1024 and sig.is_contiguous()
    assert torch.equal(sig.reshape(frames.shape), frames)


# --- precision routing ---------------------------------------------------------


@pytest.fixture
def fake_launch(monkeypatch):
    """Records (library function, first int argument) of every kernel launch
    and lets CPU / meta tensors through the device check."""
    calls = []

    def launch(name, device, *args):
        calls.append((name, args[0] if name == "crlot_b6_gemm" else None))

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(tf32x3, "launches", 0)
    monkeypatch.setattr(fused_rt, "frames_launches", 0)
    return calls


B0 = ("crlot_b6_gemm", MODE_TF32X3)
B3 = ("crlot_rt_frames", None)
CFG = pt.StftConfig(frame_size=256, hop_size=64)


def _meta(shape):
    return torch.empty(shape, device="meta")


def _hopblock(precision):
    kern = _meta((4 * 128, 128))
    return mb.hopblock_apply(_meta((2, 3000)), kern, 128, 3200, 384,
                             precision)


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
    w = pt.pipeline._window_f64(cfg)
    xs = [_meta((2, 1024)), _meta((2, 1024))]
    return spl._blocked_local_round_trip(xs, w, cfg, np.ones(129), 2, 29,
                                         1024, 2)[0]


def _convolve(precision):
    return pt.convolve(_meta((2, 3000)), np.hanning(31), "same",
                       precision=precision)


def _scan_identity(precision):
    cfg = pt.StftConfig(frame_size=256, hop_size=64, fft_precision=precision,
                        fft_backend=pt.FftBackend.MATMUL)
    frames = _meta((2, 4096)).unfold(-1, 256, 64)
    return sp._frames_round_trip(frames, cfg)


def _scan_eq(precision):
    cfg = pt.StftConfig(frame_size=256, hop_size=64, fft_precision=precision,
                        fft_backend=pt.FftBackend.MATMUL)
    frames = _meta((2, 4096)).unfold(-1, 256, 64)
    eq = spectral.band_gain([1000.0], [1.0, 0.5], 48000, 256)
    return sp._frames_round_trip(frames, cfg, eq)


CALLERS = {"hopblock_apply": (_hopblock, B0), "round_trip": (_round_trip, B0),
           "BlockedChunkStreamer": (_streamer, B0),
           "sharded blocked": (_sharded, B0), "convolve": (_convolve, B0),
           "scan identity": (_scan_identity, B3), "scan EQ": (_scan_eq, B0)}


@pytest.mark.parametrize("name", list(CALLERS))
def test_high_on_a_non_cpu_tensor_launches_the_kernel(fake_launch, name):
    fn, kernel = CALLERS[name]
    fn(pt.FftPrecision.HIGH)
    assert kernel in fake_launch


@pytest.mark.parametrize("name", list(CALLERS))
def test_highest_keeps_the_ieee_fp32_products(fake_launch, name):
    fn, kernel = CALLERS[name]
    fn(pt.FftPrecision.HIGHEST)
    assert kernel not in fake_launch
    assert B0 not in fake_launch


@pytest.mark.parametrize("name", ["hopblock_apply", "convolve",
                                  "scan identity", "scan EQ"])
def test_high_on_meta_raises_without_a_card(name):
    """No fallback: the wrapper demands one CUDA device."""
    with pytest.raises(ValueError, match="one CUDA device"):
        CALLERS[name][0](pt.FftPrecision.HIGH)


def test_cpu_runs_the_fp32_loop_at_either_tier():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 48000)).astype(np.float32))
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=True)
    hi = dict(fft_precision=pt.FftPrecision.HIGHEST)
    assert torch.equal(pt.round_trip(x, cfg),
                       pt.round_trip(x, pt.StftConfig(
                           frame_size=1024, hop_size=256, center=True, **hi)))
    taps = np.hamming(63)
    assert torch.equal(pt.convolve(x, taps), pt.convolve(x, taps, precision="highest"))


@pytest.mark.parametrize("precision,tier", [
    (None, "HIGH"), ("default", "HIGH"), ("HIGH", "HIGH"),
    ("highest", "HIGHEST"), (pt.FftPrecision.HIGHEST, "HIGHEST"),
    (pt.FftPrecision.HIGH, "HIGH")])
def test_convolve_precision_tiers(precision, tier):
    from crlot_tpu_torch.convolve import _tier

    assert _tier(precision) == getattr(pt.FftPrecision, tier)


def test_scan_form_frames_on_cpu_match_the_folded_parts():
    """The CPU plain version of B3's frames entry is the scan's former
    folded-parts computation, bit for bit."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(-1, 1, 8192).astype(np.float32))
    frames = x.unfold(-1, 256, 64)
    cfg = pt.StftConfig(frame_size=256, hop_size=64,
                        fft_backend=pt.FftBackend.MATMUL)
    gate = spectral.noise_gate(-20.0)
    got = sp._frames_round_trip(frames, cfg, gate)
    w = pt.pipeline._window_np(cfg)
    re, im = mb.rfft_folded_packed(frames, 256, w)
    want = mb.irfft_folded_parts(*gate.packed(re, im), 256)
    assert torch.equal(got, want)


# --- the ambiguous-bin helper (C12) ------------------------------------------


def test_ambiguous_bins_on_a_synthetic_gate_flip():
    """Bins at the threshold within the error bound are flagged, and only
    they flip when the spectrum moves by less than the bound."""
    thresh = float(np.float32(1e-3))
    gate = spectral.noise_gate(-30.0)
    root = np.sqrt(thresh)
    re = torch.tensor([[root * (1 + 1e-6), root * 0.5, root * 2.0, root],
                       [0.1, root * (1 - 1e-6), 0.0, 0.02]],
                      dtype=torch.float32)
    im = torch.zeros_like(re)
    delta = torch.full((2, 1), 1e-5)
    amb = fused_rt.ambiguous_bins(re, im, delta, gate.packed.epilogue)
    assert amb.tolist() == [[True, False, False, True],
                            [False, True, False, False]]
    # Move every bin by up to delta: only flagged bins change their decision.
    keep = (re * re + im * im) >= thresh
    for step in (-1e-5, 1e-5):
        moved = re + step
        flipped = ((moved * moved) >= thresh) != keep
        assert not bool((flipped & ~amb).any())
    assert bool(amb.any())


def test_ambiguous_bins_scale_with_the_ops_before_the_gate():
    """A gain before the gate scales the power the gate sees and the
    error bound with it."""
    fn = spectral.compose(spectral.gain(0.5), spectral.noise_gate(-30.0))
    thresh = float(np.float32(1e-3))
    re = torch.tensor([[2 * np.sqrt(thresh), 2 * np.sqrt(thresh) * 1.01]],
                      dtype=torch.float32)
    amb = fused_rt.ambiguous_bins(re, torch.zeros_like(re),
                                  torch.full((1, 1), 1e-6),
                                  fn.packed.epilogue)
    assert amb.tolist() == [[True, False]]


def test_ambiguous_frames_finds_a_frame_at_the_threshold():
    """On a real signal: a gate threshold put exactly on one frame's bin
    power flags that frame; a continuous fn flags nothing; frames_cover maps
    a flagged frame to the samples it overlap-adds into."""
    rng = np.random.default_rng(7)
    nfft, hop, nf = 256, 64, 20
    x = torch.from_numpy(rng.uniform(-1, 1, (1, (nf - 1) * hop + nfft))
                         .astype(np.float32))
    w = torch.from_numpy(np.hanning(nfft + 1)[:-1].astype(np.float32))
    frames = x.unfold(-1, nfft, hop)
    re, im = mb.rfft_folded_packed(frames, nfft, w)
    p = float(re[0, 7, 40]) ** 2 + float(im[0, 7, 40]) ** 2
    db = 10 * np.log10(np.float32(p))
    gate = spectral.noise_gate(float(db))
    mask = fused_rt.ambiguous_frames(x, nfft, hop, nf, w, gate.packed)
    assert mask.shape == (1, nf) and bool(mask[0, 7])
    assert int(mask.sum()) <= 3
    sub = spectral.spectral_subtraction(np.ones(nfft // 2 + 1), 1.0, 0.1)
    assert not bool(fused_rt.ambiguous_frames(x, nfft, hop, nf, w,
                                              sub.packed).any())
    cover = fused_rt.frames_cover(mask, hop, nfft, x.shape[-1])
    assert bool(cover[0, 7 * hop : 7 * hop + nfft].all())
    one = torch.zeros(1, nf, dtype=torch.bool)
    one[0, 3] = True
    covered = fused_rt.frames_cover(one, hop, nfft, x.shape[-1])[0]
    assert covered.nonzero().flatten().tolist() == list(range(3 * hop,
                                                             3 * hop + nfft))
