"""B7, the framed windowed rFFT, on the CPU: the route `dispatch.
rfft_windowed` takes and the bytes it reports, the wrapper's checks and the
arguments it launches with (a fake launch on meta tensors), the radices and
the launch plan, the tables, the plain versions against `rfft_folded_packed`
and the float64 DFT, the bound, the launch counter, and the chain's `.stft`
span. The
kernel itself runs only on a card: `tests/test_torch_resample_stream_card.py`
and `chip_smoke.py --stft-b7` hold it there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch import cuda_build, profiling
from crlot_tpu_torch.bench import launches
from crlot_tpu_torch.core.types import FftBackend
from crlot_tpu_torch.fft import dispatch
from crlot_tpu_torch.fft import fp32_window as b7
from crlot_tpu_torch.fft import matmul_backend as mm

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
F32, F64 = torch.float32, torch.float64
AUTO, MATMUL, XLA = FftBackend.AUTO, FftBackend.MATMUL, FftBackend.XLA


@pytest.mark.parametrize("nfft, device, dtype, stride, backend, route", [
    (400, CUDA, F32, 1, AUTO, "B7"),
    (400, CUDA, F32, 1, MATMUL, "B7"),
    (16, CUDA, F32, 1, AUTO, "B7"),
    (1024, CUDA, F32, 1, AUTO, "B7"),
    (98, CUDA, F32, 1, AUTO, "B7"),
    (1000, CUDA, F32, 1, AUTO, "B7"),
    (22, CUDA, F32, 1, AUTO, "folded"),
    (514, CUDA, F32, 1, AUTO, "folded"),
    (14, CUDA, F32, 1, AUTO, "folded"),
    (1026, CUDA, F32, 1, AUTO, "folded"),
    (4096, CUDA, F32, 1, AUTO, "folded"),
    (400, CUDA, F64, 1, AUTO, "folded"),
    (400, CUDA, torch.float16, 1, AUTO, "folded"),
    (400, CUDA, F32, 2, AUTO, "folded"),
    (400, CUDA, F32, 1, XLA, "torch_fft"),
    (401, CUDA, F32, 1, AUTO, "torch_fft"),
    (401, CUDA, F32, 1, MATMUL, "dense"),
    (8192, CUDA, F32, 1, AUTO, "ct"),
    (400, CPU, F32, 1, AUTO, "torch_fft"),
    (400, CPU, F32, 1, MATMUL, "folded"),
    (400, "meta", F32, 1, MATMUL, "folded"),
])
def test_the_route_follows_device_dtype_stride_and_n(nfft, device, dtype,
                                                     stride, backend, route):
    assert dispatch.windowed_route(nfft, device, dtype, stride,
                                   backend) == route
    if route == "B7" or backend == AUTO:
        assert b7.stft_takes(device, dtype, stride, nfft) == (route == "B7")


@pytest.mark.parametrize("device, dtype, stride, nfft, want", [
    (CUDA, F32, 1, 400, 0),
    (CUDA, F64, 1, 400, 2_457_600_000),
    (CUDA, F32, 3, 400, 2_457_600_000),
    (CPU, F32, 1, 400, 4 * 128 * 3000 * 400),
    (CUDA, F32, 1, 2048, mm.rfft_folded_bytes(128 * 3000, 2048)),
])
def test_the_bytes_are_the_routes(device, dtype, stride, nfft, want):
    """At the chain's feed (128 x 3000 frames): nothing on B7;
    `rfft_folded_bytes` (2.4576 GB at N 400) on the folded route; the
    windowed frames on torch.fft."""
    got = dispatch.rfft_windowed_bytes((128, 3000, nfft), nfft, device,
                                       AUTO, dtype, stride)
    assert got == want
    if dtype == F32 and stride == 1 and nfft == 400:
        assert got == dispatch.rfft_windowed_bytes((128, 3000, nfft), nfft,
                                                   device)


@pytest.fixture
def fake_launch(monkeypatch):
    calls = []

    def launch(name, device, *args):
        calls.append((name, args))

    monkeypatch.setattr(cuda_build, "launch", launch)
    monkeypatch.setattr(cuda_build, "require_cuda", lambda what, *t: None)
    monkeypatch.setattr(cuda_build, "stream_handle",
                        lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(b7, "stft_launches", 0)
    return calls


def _meta(shape, dtype=F32):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("frames, nfft, match", [
    (_meta((2, 4000)).unfold(-1, 400, 160)[..., ::2], 200, "contiguous"),
    (_meta((2, 4000)).unfold(-1, 401, 160), 401, "even N"),
    (_meta((2, 4000)).unfold(-1, 1026, 160), 1026, "even N"),
    (_meta((2, 4000)).unfold(-1, 14, 7), 14, "even N"),
    (_meta((2, 4000)).unfold(-1, 22, 7), 22, "product of 2, 3, 5 and 7"),
    (_meta((2, 4000), F64).unfold(-1, 400, 160), 400, "float32"),
    (_meta((2, 4000)).unfold(-1, 400, 160), 512, r"\[\.\.\., 512\]"),
])
def test_the_wrapper_refuses_what_b7_does_not_take(fake_launch, frames, nfft,
                                                   match):
    with pytest.raises(ValueError, match=match):
        b7.stft_cuda(frames, nfft, _meta((nfft,)))
    assert fake_launch == [] and b7.stft_launches == 0


def test_the_wrapper_refuses_a_window_of_another_length(fake_launch):
    with pytest.raises(ValueError, match="window"):
        b7.stft_cuda(_meta((2, 4000)).unfold(-1, 400, 160), 400,
                     _meta((401,)))


def test_on_meta_raises_without_a_card():
    with pytest.raises(ValueError, match="one CUDA device"):
        b7.stft_cuda(_meta((2, 4000)).unfold(-1, 400, 160), 400,
                     _meta((400,)))


@pytest.mark.parametrize("rows, length, nfft, hop", [
    (128, 480_003, 400, 160), (1, 2_000, 400, 160), (3, 9_001, 512, 1100),
    (2, 5_000, 1024, 256)])
def test_the_frames_are_read_in_place(fake_launch, rows, length, nfft, hop):
    """The `unfold` view's strides go to the kernel as they are: the row
    stride, the frame stride, no copy; one launch counted."""
    frames = _meta((rows, length)).unfold(-1, nfft, hop)
    out = b7.stft_cuda(frames, nfft, _meta((nfft,)))
    f = (length - nfft) // hop + 1
    assert out.shape == (rows, f, nfft // 2 + 1)
    assert out.dtype == torch.complex64
    [(name, args)] = fake_launch
    assert name == "crlot_stft_fp32_window" and b7.stft_launches == 1
    assert args[1:6] == (length if rows > 1 else 0, hop, nfft, f, rows)
    assert args[9:] == tuple(b7.stft_plan(nfft, hop))


def test_leading_axes_merge_or_are_copied(fake_launch):
    x = _meta((2, 3, 50, 400))
    assert b7.stft_cuda(x, 400, _meta((400,))).shape == (2, 3, 50, 201)
    assert b7.stft_cuda(x.transpose(0, 1), 400,
                        _meta((400,))).shape == (3, 2, 50, 201)
    assert b7.stft_cuda(_meta((400,)), 400, _meta((400,))).shape == (201,)
    assert b7.stft_cuda(_meta((7, 400)), 400, _meta((400,))).shape == (7,
                                                                         201)
    rows_hops = [(a[5], a[1], a[2]) for _, a in fake_launch]
    assert rows_hops == [(6, 20000, 400), (6, 20000, 400), (1, 0, 400),
                         (1, 0, 400)]


def test_no_frames_launch_nothing(fake_launch):
    out = b7.stft_cuda(_meta((3, 0, 400)), 400, _meta((400,)))
    assert out.shape == (3, 0, 201) and fake_launch == []
    assert b7.stft_launches == 0


def test_the_cells_plan():
    """N 400, H 160: 200 = 5 x 5 x 8, the odd radices first, packed 4 bits
    a pass; 32 frames a CTA (3000 frames are 94 CTAs a row); shared memory
    the tables (401 complex), two buffers a warp (8 x 2 x 213 complex: a
    slot skipped every 16), the window and the span (31 x 160 + 400), 52.3
    KiB: four CTAs an SM."""
    assert b7.stft_radices(400) == (5, 5, 8)
    assert b7.stft_plan(400, 160) == b7.StftPlan(
        5 | 5 << 4 | 8 << 8, 32, 8 * 401 + 16 * 8 * 213 + 4 * (400 + 5360))
    assert b7.stft_plan(400, 160).smem_bytes <= 56 * 1024


@pytest.mark.parametrize("nfft, want", [
    (16, (8,)), (18, (3, 3)), (24, (3, 4)), (32, (2, 8)), (64, (4, 8)),
    (98, (7, 7)), (256, (2, 8, 8)), (400, (5, 5, 8)), (512, (4, 8, 8)),
    (960, (5, 3, 4, 8)), (1000, (5, 5, 5, 4)), (1024, (8, 8, 8)),
    (22, None), (514, None), (1018, None), (14, None), (1026, None),
    (401, None)])
def test_the_radices_cover_n_half(nfft, want):
    assert b7.stft_radices(nfft) == want


def test_b7_takes_every_even_n_whose_half_is_7_smooth():
    for nfft in range(16, 1025, 2):
        radices = b7.stft_radices(nfft)
        m, r = nfft // 2, nfft // 2
        for p in (2, 3, 5, 7):
            while r % p == 0:
                r //= p
        assert (radices is not None) == (r == 1), nfft
        if radices is not None:
            assert set(radices) <= set(b7.STFT_RADICES)
            assert int(np.prod(radices)) == m
            odd = [x for x in radices if x % 2]
            assert list(radices[: len(odd)]) == sorted(odd, reverse=True)


@pytest.mark.parametrize("nfft", [16, 18, 64, 256, 400, 512, 514, 960,
                                  1000, 1024])
@pytest.mark.parametrize("hop", [0, 1, 7, 160, 256, 1024, 5000])
def test_every_plan_fits_the_kernel(nfft, hop):
    """Every plan meets `crlot_stft_fp32_window`'s checks: radices of
    2, 3, 4, 5, 7 and 8 whose product is N/2, and the shared memory of its
    frames a CTA (the tables, two buffers a warp, the window, the span;
    each frame alone where H > N) within the card's 227 KiB; as many
    frames (a multiple of 8, at most 64) as leave four CTAs an SM, or two
    where 8 frames do not leave four. N/2 of another prime factor has no
    plan."""
    if b7.stft_radices(nfft) is None:
        with pytest.raises(ValueError, match="product of 2, 3, 5 and 7"):
            b7.stft_plan(nfft, hop)
        return
    p = b7.stft_plan(nfft, hop)
    m, code, radices = nfft // 2, p.radices, []
    while code:
        radices.append(code & 15)
        code >>= 4
    assert tuple(radices) == b7.stft_radices(nfft)
    pm = m + (m - 1) // 16 + 1
    need = lambda tm: (8 * (2 * m + 1) + 16 * 8 * pm
                       + 4 * (2 * nfft + (tm - 1) * min(hop, nfft)))
    budget = 56 * 1024 if need(8) <= 56 * 1024 else 112 * 1024
    assert p.tm % 8 == 0 and 8 <= p.tm <= 64
    assert p.smem_bytes == need(p.tm) <= 227 * 1024
    assert p.tm == 8 or p.smem_bytes <= budget
    assert p.tm == 64 or need(p.tm + 8) > budget


@pytest.mark.parametrize("nfft", [16, 400, 1024])
def test_the_tables_hold_the_roots(nfft):
    """The kernel's tables: the passes' roots exp(-2 pi i t / M), t < M,
    then the split's exp(-2 pi i k / N), k <= M, float32 from float64,
    exact at the quarter turns."""
    m = nfft // 2
    tab = b7._stft_tables(nfft)
    assert tab.shape == (2 * m + 1, 2) and tab.dtype == np.float32
    t = np.arange(m)
    want = np.exp(-2j * np.pi * t / m)
    assert np.abs(tab[:m, 0] + 1j * tab[:m, 1] - want).max() <= 6e-8
    k = np.arange(m + 1)
    want = np.exp(-2j * np.pi * k / nfft)
    assert np.abs(tab[m:, 0] + 1j * tab[m:, 1] - want).max() <= 6e-8
    split = tab[m:]
    assert list(split[0]) == [1, 0] and list(split[m]) == [-1, 0]
    assert list(split[m // 2]) == [0, -1]
    if m % 4 == 0:
        assert list(tab[m // 4]) == [0, -1]
        assert list(tab[m // 2]) == [-1, 0]


def _frames(seed, rows=2, frames=30, nfft=400, hop=160):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, (frames - 1) * hop + nfft), generator=g)
    return x.unfold(-1, nfft, hop)


@pytest.mark.parametrize("nfft, hop", [(400, 160), (512, 128), (16, 7),
                                       (1024, 1100)])
@pytest.mark.parametrize("symmetric", [True, False])
def test_the_plain_versions_are_the_folded_products(nfft, hop, symmetric):
    """`stft_plain` is the float64 DFT of the windowed float32 frames and
    `rfft_folded_packed`'s products to float32 rounding; `stft_fft_plain`,
    the kernel's passes, tables and split, is that DFT to the tables'
    rounding in float64 and lies within `stft_tolerance` of it in float32
    (with room: a tenth of the bound); Im is 0 at bins 0 and h."""
    frames = _frames(nfft + hop, nfft=nfft, hop=hop)
    w = (torch.tensor(pt.get_window(pt.WindowType.HANN, nfft))
         if symmetric else torch.rand(nfft, generator=torch.Generator()
                                      .manual_seed(hop)) + 0.1)
    plain = b7.stft_plain(frames, nfft, w)
    tol = b7.stft_tolerance(frames, nfft, w)
    dft = torch.fft.rfft((frames * w).double(), dim=-1)
    assert plain.dtype == torch.complex128 and tol.shape[-1] == 1
    scale = float(dft.abs().max())
    assert float((plain - dft).abs().max()) <= 1e-12 * scale
    fft64 = b7.stft_fft_plain(frames, nfft, w)
    assert float((fft64 - plain).abs().max()) <= 2e-7 * scale
    fft32 = b7.stft_fft_plain(frames, nfft, w, torch.float32)
    assert fft32.dtype == torch.complex64
    d = fft32.to(torch.complex128) - plain
    assert bool((d.real.abs() <= 0.1 * tol.real).all())
    assert bool((d.imag.abs() <= 0.1 * tol.imag).all())
    re, im = mm.rfft_folded_packed(frames, nfft, w)
    assert float((torch.complex(re, im) - plain).abs().max()) <= 1e-5 * scale
    for z in (plain, fft64, fft32):
        assert not z.imag[..., 0].any() and not z.imag[..., -1].any()


@pytest.mark.parametrize("nfft, hop", [(400, 160), (1024, 256)])
def test_the_bound_refuses_a_frame_one_sample_off(nfft, hop):
    """The spectrum of each frame shifted by one sample, or of the window
    reversed where it is not symmetric, lies off `stft_tolerance` of the
    plain DFT: the bound is tight enough to see a wrong index."""
    x = torch.randn((2, 40 * hop + nfft + 1),
                    generator=torch.Generator().manual_seed(nfft))
    frames, shifted = (x[:, :-1].unfold(-1, nfft, hop),
                       x[:, 1:].unfold(-1, nfft, hop))
    w = torch.rand(nfft, generator=torch.Generator().manual_seed(1)) + 0.1
    plain = b7.stft_plain(frames, nfft, w)
    tol = b7.stft_tolerance(frames, nfft, w)
    for wrong in (b7.stft_fft_plain(shifted, nfft, w, torch.float32),
                  b7.stft_fft_plain(frames, nfft, w.flip(0), torch.float32)):
        d = wrong.to(torch.complex128) - plain
        assert bool(((d.real.abs() > tol.real)
                     | (d.imag.abs() > tol.imag)).all(-1).all())


def test_the_counter_is_launches_b7():
    saved = launches.launch_counts()
    try:
        b7.stft_launches = 4
        assert launches.launch_counts()["B7"] == 4
        launches.set_launch_counts(dict(saved, B7=9))
        assert b7.stft_launches == 9
        with launches.uncounted():
            b7.stft_launches += 3
        assert b7.stft_launches == 9
        launches.reset_launch_counts()
        assert b7.stft_launches == 0
    finally:
        launches.set_launch_counts(saved)


def test_rfft_windowed_on_the_cpu_launches_nothing():
    frames = _frames(5)
    w64 = pt.get_window(pt.WindowType.HANN, 400, dtype=np.float64)
    before = b7.stft_launches
    got = dispatch.rfft_windowed(frames, 400, w64, MATMUL)
    re, im = mm.rfft_folded_packed(frames, 400, w64)
    assert torch.equal(got, torch.complex(re, im))
    assert b7.stft_launches == before


@pytest.mark.parametrize("backend, route", [(AUTO, "torch_fft"),
                                            (MATMUL, "folded")])
def test_the_chains_stft_span_records_its_route(backend, route):
    cfg = pt.StftConfig(frame_size=400, hop_size=160, fft_backend=backend)
    st = pt.ResampledStftStreamer((44100, 48000, 16000), cfg, 2,
                                  device="cpu")
    x = torch.randn((2, 30_000), generator=torch.Generator().manual_seed(7))
    st.feed(x)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        st.feed(x * 0.5)
    stft = [r for r in profiling.span_log()
            if r.name == "crlot.resample_stream.stft"]
    assert stft and stft[-1].attrs["route"] == route
