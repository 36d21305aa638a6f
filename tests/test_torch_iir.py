"""The port's IIR filters (`crlot_tpu_torch.iir`) on the CPU.

Mirrors `tests/test_iir.py` (its 26 cases, same gates: > 70 dB against
scipy.signal in float64, zf within 1e-4, chunked > 90 dB against one-shot,
the designers' responses), then holds the port against the reference:

- the float64 designers (`butter_sos`, `a_weighting_sos`,
  `c_weighting_sos`, `sosfilt_zi`) byte-identical (`np.array_equal`, same
  dtype);
- `sosfilt`, `lfilter`, `sosfiltfilt` on the same seeded input at >= 90 dB
  SNR against the reference's output (the port's scan runs in float64, the
  reference's in float32: their difference is the reference's own rounding,
  which meets scipy at >= 98 dB on these Butterworth designs);
- a reference `zf` (numpy) passed to the port as `zi` continues the stream
  as the reference's own continuation does: >= 90 dB, zf within 1e-4;
- the scan's structure: log-depth (no loop over samples) and its state
  products elementwise (no einsum / matmul on them);
- the weighting filters through `sosfilt` at >= 70 dB against scipy, which
  the reference's float32 scan misses (ROADMAP C18); the witness of C18
  holds the reference's scan, this scan in float32 and this scan in
  float32 with float64 combines below that gate (on the C weighting
  filter for the last, which passes on the A filter).
"""

import numpy as np
import pytest
import scipy.signal
import torch

from crlot_tpu import iir as ref

from crlot_tpu_torch import iir
from crlot_tpu_torch.iir import (
    a_weighting_sos,
    butter_sos,
    c_weighting_sos,
    lfilter,
    sosfilt,
    sosfilt_zi,
    sosfiltfilt,
)
from crlot_tpu_torch.metrics import snr_db

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noise(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# sosfilt vs scipy (mirrors tests/test_iir.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 4, 6])
def test_sosfilt_matches_scipy(order):
    sos = scipy.signal.butter(order, 0.2, output="sos")
    x = _noise(48000)
    want = scipy.signal.sosfilt(sos, x.astype(np.float64))
    got = _np(sosfilt(sos, x, device=CPU))
    assert snr_db(want.astype(np.float32), got) > 70.0


def test_sosfilt_highpass_matches_scipy():
    sos = scipy.signal.butter(4, 0.35, btype="highpass", output="sos")
    x = _noise(20000, seed=1)
    want = scipy.signal.sosfilt(sos, x.astype(np.float64))
    got = _np(sosfilt(sos, x, device=CPU))
    assert snr_db(want.astype(np.float32), got) > 70.0


def test_sosfilt_impulse_response():
    sos = scipy.signal.butter(4, 0.25, output="sos")
    x = np.zeros(256, np.float32)
    x[0] = 1.0
    want = scipy.signal.sosfilt(sos, x.astype(np.float64))
    got = _np(sosfilt(sos, x, device=CPU))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_sosfilt_zi_state_carry_matches_scipy():
    sos = scipy.signal.butter(4, 0.2, output="sos")
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4096).astype(np.float32)
    zi = rng.standard_normal((sos.shape[0], 2)).astype(np.float32)
    want_y, want_zf = scipy.signal.sosfilt(
        sos, x.astype(np.float64), zi=zi.astype(np.float64)
    )
    got_y, got_zf = sosfilt(sos, x, zi=zi, device=CPU)
    assert snr_db(want_y.astype(np.float32), _np(got_y)) > 70.0
    np.testing.assert_allclose(_np(got_zf), want_zf, atol=1e-4)


def test_sosfilt_chunked_stream_matches_oneshot():
    sos = scipy.signal.butter(6, 0.15, output="sos")
    x = _noise(32768, seed=3)
    one = _np(sosfilt(sos, x, device=CPU))
    z = np.zeros((sos.shape[0], 2), np.float32)
    outs = []
    for chunk in np.split(x, 8):
        y, z = sosfilt(sos, torch.from_numpy(chunk), zi=z)
        outs.append(_np(y))
    assert snr_db(one, np.concatenate(outs)) > 90.0


def test_sosfilt_batched():
    sos = scipy.signal.butter(2, 0.3, output="sos")
    x = np.stack([_noise(8192, seed=i) for i in range(3)])
    got = _np(sosfilt(sos, x, device=CPU))
    for i in range(3):
        single = _np(sosfilt(sos, x[i], device=CPU))
        np.testing.assert_allclose(got[i], single, rtol=1e-5, atol=1e-6)


def test_sosfilt_validation():
    with pytest.raises(ValueError):
        sosfilt(np.zeros((2, 5)), _noise(64), device=CPU)
    bad = np.array([[1.0, 0, 0, 0.0, 0, 0]])  # a0 == 0
    with pytest.raises(ValueError):
        sosfilt(bad, _noise(64), device=CPU)
    sos = scipy.signal.butter(4, 0.2, output="sos")
    with pytest.raises(ValueError):
        sosfilt(sos, _noise(64), zi=np.zeros((1, 2), np.float32), device=CPU)


# ---------------------------------------------------------------------------
# sosfilt_zi / sosfiltfilt vs scipy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [2, 4, 7])
def test_sosfilt_zi_matches_scipy(order):
    sos = scipy.signal.butter(order, 0.22, output="sos")
    np.testing.assert_allclose(
        sosfilt_zi(sos), scipy.signal.sosfilt_zi(sos), rtol=1e-10
    )


def test_sosfilt_zi_step_has_no_transient():
    sos = scipy.signal.butter(4, 0.2, output="sos")
    step = np.ones(256, np.float32)
    zi = np.asarray(sosfilt_zi(sos), np.float32)
    y, _ = sosfilt(sos, step, zi=zi, device=CPU)
    np.testing.assert_allclose(_np(y), 1.0, atol=1e-4)


@pytest.mark.parametrize("order", [2, 4])
def test_sosfiltfilt_matches_scipy(order):
    sos = scipy.signal.butter(order, 0.2, output="sos")
    x = _noise(16384, seed=8)
    want = scipy.signal.sosfiltfilt(sos, x.astype(np.float64))
    got = _np(sosfiltfilt(sos, x, device=CPU))
    assert snr_db(want.astype(np.float32), got) > 70.0


def test_sosfiltfilt_zero_phase():
    sr = 48000
    t = np.arange(sr // 2) / sr
    x = np.sin(2 * np.pi * 500 * t).astype(np.float32)
    sos = scipy.signal.butter(4, 0.1, output="sos")
    y = _np(sosfiltfilt(sos, x, device=CPU))
    mid = slice(sr // 8, 3 * sr // 8)
    lag = np.argmax(np.correlate(y[mid], x[mid], mode="full"))
    assert lag == len(x[mid]) - 1  # zero shift
    y_fwd = _np(sosfilt(sos, x, device=CPU))
    lag_f = np.argmax(np.correlate(y_fwd[mid], x[mid], mode="full"))
    assert lag_f != len(x[mid]) - 1  # forward-only IS delayed


def test_sosfiltfilt_batched_matches_single():
    sos = scipy.signal.butter(4, 0.25, output="sos")
    x = np.stack([_noise(4096, seed=i) for i in range(3)])
    got = _np(sosfiltfilt(sos, x, device=CPU))
    for i in range(3):
        one = _np(sosfiltfilt(sos, x[i], device=CPU))
        np.testing.assert_allclose(got[i], one, rtol=1e-4, atol=1e-6)


def test_sosfiltfilt_padlen_validation():
    sos = scipy.signal.butter(4, 0.25, output="sos")
    with pytest.raises(ValueError):
        sosfiltfilt(sos, _noise(12), device=CPU)  # padlen 15 >= length


# ---------------------------------------------------------------------------
# lfilter vs scipy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 5])
def test_lfilter_matches_scipy(order):
    b, a = scipy.signal.butter(order, 0.25)
    x = _noise(16384, seed=4)
    want = scipy.signal.lfilter(b, a, x.astype(np.float64))
    got = _np(lfilter(b, a, x, device=CPU))
    assert snr_db(want.astype(np.float32), got) > 70.0


def test_lfilter_fir_only():
    b = np.array([0.25, 0.5, 0.25])
    x = _noise(1024, seed=5)
    want = scipy.signal.lfilter(b, [1.0], x.astype(np.float64))
    got = _np(lfilter(b, [1.0], x, device=CPU))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_lfilter_gain_only():
    """Order 0 (the reference's own branch): a scaled copy, no scan."""
    x = _noise(128, seed=6)
    got = _np(lfilter([2.0], [1.0], x, device=CPU))
    np.testing.assert_allclose(got, 2.0 * x, rtol=1e-6)
    y, zf = lfilter([2.0], [1.0], x, zi=np.zeros(0, np.float32), device=CPU)
    assert tuple(zf.shape) == (0,)
    np.testing.assert_array_equal(_np(y), _np(ref.lfilter([2.0], [1.0], x)))


def test_lfilter_zi_matches_scipy():
    b, a = scipy.signal.butter(3, 0.3)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(2048).astype(np.float32)
    zi = rng.standard_normal(3).astype(np.float32)
    want_y, want_zf = scipy.signal.lfilter(
        b, a, x.astype(np.float64), zi=zi.astype(np.float64)
    )
    got_y, got_zf = lfilter(b, a, x, zi=zi, device=CPU)
    assert snr_db(want_y.astype(np.float32), _np(got_y)) > 70.0
    np.testing.assert_allclose(_np(got_zf), want_zf, atol=1e-4)


# ---------------------------------------------------------------------------
# butter_sos designer vs scipy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,wn,btype", [
    (1, 0.2, "lowpass"),
    (2, 0.2, "lowpass"),
    (4, 0.1, "lowpass"),
    (5, 0.4, "lowpass"),
    (3, 0.3, "highpass"),
    (6, 0.15, "highpass"),
])
def test_butter_sos_frequency_response(order, wn, btype):
    mine = butter_sos(order, wn, btype)
    want = scipy.signal.butter(order, wn, btype=btype, output="sos")
    w, h_mine = scipy.signal.sosfreqz(mine, worN=512)
    _, h_ref = scipy.signal.sosfreqz(want, worN=512)
    np.testing.assert_allclose(np.abs(h_mine), np.abs(h_ref),
                               rtol=1e-9, atol=1e-12)
    k3 = np.argmin(np.abs(w - np.pi * wn))
    assert abs(20 * np.log10(np.abs(h_mine[k3])) + 3.01) < 0.1
    # Byte-identical to the reference's design.
    got, exp = mine, ref.butter_sos(order, wn, btype)
    assert got.dtype == exp.dtype == np.float64
    assert np.array_equal(got, exp)


def test_butter_sos_hz_api():
    a = butter_sos(4, 1000.0, "lowpass", fs=48000.0)
    b = butter_sos(4, 2 * 1000.0 / 48000.0, "lowpass")
    np.testing.assert_allclose(a, b, rtol=1e-12)


def test_butter_sos_validation():
    with pytest.raises(ValueError):
        butter_sos(0, 0.5)
    with pytest.raises(ValueError):
        butter_sos(2, 1.5)
    with pytest.raises(ValueError):
        butter_sos(2, 0.5, btype="bandpass")


# ---------------------------------------------------------------------------
# IEC 61672 weighting designers
# ---------------------------------------------------------------------------

def _analog_a_raw(f):
    f = np.asarray(f, dtype=np.float64)
    f2 = f * f
    num = (12194.217 ** 2) * f2 * f2
    den = (
        (f2 + 20.598997 ** 2)
        * np.sqrt((f2 + 107.65265 ** 2) * (f2 + 737.86223 ** 2))
        * (f2 + 12194.217 ** 2)
    )
    return 20.0 * np.log10(num / den)


def _analog_a_db(f):
    return _analog_a_raw(f) - _analog_a_raw(1000.0)


def _analog_c_raw(f):
    f = np.asarray(f, dtype=np.float64)
    f2 = f * f
    num = (12194.217 ** 2) * f2
    den = (f2 + 20.598997 ** 2) * (f2 + 12194.217 ** 2)
    return 20.0 * np.log10(num / den)


def _analog_c_db(f):
    return _analog_c_raw(f) - _analog_c_raw(1000.0)


def _digital_db(sos, f, fs):
    w, h = scipy.signal.sosfreqz(sos, worN=2 * np.pi * np.atleast_1d(f) / fs)
    return 20.0 * np.log10(np.abs(h))


@pytest.mark.parametrize("fs", [44100.0, 48000.0, 96000.0])
def test_a_weighting_matches_analog_curve(fs):
    sos = a_weighting_sos(fs)
    assert sos.shape == (3, 6)
    assert abs(_digital_db(sos, 1000.0, fs)[0]) < 1e-9
    freqs = np.array([31.5, 63.0, 125.0, 250.0, 500.0, 1000.0, 2000.0,
                      4000.0])
    np.testing.assert_allclose(_digital_db(sos, freqs, fs),
                               _analog_a_db(freqs), atol=0.06)
    assert abs(_digital_db(sos, 8000.0, fs)[0] - _analog_a_db(8000.0)) < 1.0
    exp = ref.a_weighting_sos(fs)
    assert sos.dtype == exp.dtype and np.array_equal(sos, exp)


def test_a_weighting_iec_spot_values():
    sos = a_weighting_sos(48000.0)
    for f, want in [(31.5, -39.4), (125.0, -16.1), (500.0, -3.2),
                    (2000.0, 1.2), (4000.0, 1.0)]:
        got = _digital_db(sos, f, 48000.0)[0]
        assert abs(got - want) < 0.15, (f, got, want)


@pytest.mark.parametrize("fs", [44100.0, 48000.0])
def test_c_weighting_matches_analog_curve(fs):
    sos = c_weighting_sos(fs)
    assert sos.shape == (2, 6)
    assert abs(_digital_db(sos, 1000.0, fs)[0]) < 1e-9
    freqs = np.array([31.5, 125.0, 1000.0, 4000.0])
    np.testing.assert_allclose(
        _digital_db(sos, freqs, fs), _analog_c_db(freqs), atol=0.1
    )
    exp = ref.c_weighting_sos(fs)
    assert sos.dtype == exp.dtype and np.array_equal(sos, exp)


def test_weighting_filters_run_through_sosfilt():
    sr = 48000
    t = np.arange(sr) / sr
    sos = a_weighting_sos(float(sr))
    lvl = {}
    for f in (100.0, 1000.0):
        x = np.sin(2 * np.pi * f * t).astype(np.float32)
        y = _np(sosfilt(sos, x, device=CPU))[sr // 4:]
        lvl[f] = 20 * np.log10(np.std(y) / np.std(x[sr // 4:]))
    assert abs(lvl[1000.0]) < 0.1
    assert abs(lvl[100.0] - (-19.1)) < 0.3


def test_weighting_validation():
    with pytest.raises(ValueError):
        a_weighting_sos(1000.0)
    with pytest.raises(ValueError):
        c_weighting_sos(500.0)


def test_designed_filter_end_to_end():
    sr = 48000
    t = np.arange(sr) / sr
    lo = np.sin(2 * np.pi * 200 * t).astype(np.float32)
    hi = np.sin(2 * np.pi * 8000 * t).astype(np.float32)
    sos = butter_sos(4, 1000.0, "lowpass", fs=sr)
    y_lo = _np(sosfilt(sos, lo, device=CPU))[sr // 4:]
    y_hi = _np(sosfilt(sos, hi, device=CPU))[sr // 4:]
    gain_lo = 20 * np.log10(np.std(y_lo) / np.std(lo[sr // 4:]))
    gain_hi = 20 * np.log10(np.std(y_hi) / np.std(hi[sr // 4:]))
    assert abs(gain_lo) < 1.0
    assert gain_hi < -35.0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2, 4, 7])
def test_sosfilt_zi_design_byte_identical(order):
    sos = butter_sos(order, 0.22)
    got, want = sosfilt_zi(sos), ref.sosfilt_zi(sos)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("order,wn", [(2, 0.2), (6, 0.15)])
def test_sosfilt_matches_reference(order, wn):
    sos = butter_sos(order, wn)
    x = np.random.default_rng(20).standard_normal((2, 3, 6000)).astype(
        np.float32)
    got = _np(sosfilt(sos, x, device=CPU))
    want = np.asarray(ref.sosfilt(sos, x))
    assert got.shape == want.shape
    assert snr_db(want, got) >= 90.0


@pytest.mark.parametrize("order", [1, 3, 5])
def test_lfilter_matches_reference(order):
    b, a = scipy.signal.butter(order, 0.3)
    x = _noise(9000, seed=21)
    assert snr_db(np.asarray(ref.lfilter(b, a, x)),
                  _np(lfilter(b, a, x, device=CPU))) >= 90.0


def test_sosfiltfilt_matches_reference():
    sos = butter_sos(4, 0.2)
    x = np.random.default_rng(22).standard_normal((2, 5000)).astype(
        np.float32)
    assert snr_db(np.asarray(ref.sosfiltfilt(sos, x)),
                  _np(sosfiltfilt(sos, x, device=CPU))) >= 90.0


def test_reference_zf_continues_in_the_port():
    """The reference's zf after chunk 1 (numpy) is the port's zi for chunk
    2; the port's chunk 2 meets the reference's own continuation, and the
    port's zf meets the reference's zf; and back, the port's zf continues
    in the reference."""
    sos = butter_sos(4, 0.2)
    x = np.random.default_rng(23).standard_normal((2, 8192)).astype(
        np.float32)
    z0 = np.zeros((sos.shape[0], 2, 2), np.float32)
    _, zf_ref = ref.sosfilt(sos, x[:, :4096], zi=z0)
    zf_ref = np.asarray(zf_ref)
    want2, want_zf = ref.sosfilt(sos, x[:, 4096:], zi=zf_ref)
    got2, got_zf = sosfilt(sos, x[:, 4096:], zi=zf_ref, device=CPU)
    assert snr_db(np.asarray(want2), _np(got2)) >= 90.0
    np.testing.assert_allclose(_np(got_zf), np.asarray(want_zf), atol=1e-4)
    _, zf_port = sosfilt(sos, x[:, :4096], zi=z0, device=CPU)
    back, _ = ref.sosfilt(sos, x[:, 4096:], zi=_np(zf_port))
    assert snr_db(np.asarray(want2), np.asarray(back)) >= 90.0


def test_lfilter_reference_zf_continues_in_the_port():
    b, a = scipy.signal.butter(3, 0.3)
    x = _noise(6000, seed=24)
    _, zf_ref = ref.lfilter(b, a, x[:3000], zi=np.zeros(3, np.float32))
    want2, want_zf = ref.lfilter(b, a, x[3000:], zi=np.asarray(zf_ref))
    got2, got_zf = lfilter(b, a, x[3000:], zi=np.asarray(zf_ref), device=CPU)
    assert snr_db(np.asarray(want2), _np(got2)) >= 90.0
    np.testing.assert_allclose(_np(got_zf), np.asarray(want_zf), atol=1e-4)


@pytest.mark.parametrize("design", ["a", "c"])
def test_weighting_sosfilt_matches_scipy(design):
    """The weighting filters' poles near z = 1 need the float64 scan: >= 70
    dB against scipy here, which every float32 scan misses
    (`test_c18_float32_scans_miss_scipy`, ROADMAP C18)."""
    sos = (a_weighting_sos if design == "a" else c_weighting_sos)(48000.0)
    x = np.random.default_rng(25).uniform(-1, 1, 96000).astype(np.float32)
    want = scipy.signal.sosfilt(sos, x.astype(np.float64))
    assert snr_db(want.astype(np.float32),
                  _np(sosfilt(sos, x, device=CPU))) >= 70.0


def _f32_scan(sos, x, combine64, monkeypatch):
    """sosfilt's cascade with the scan in float32, its combines optionally
    computed in float64 and rounded to float32."""
    if combine64:
        orig = iir._combine

        def combine(m1, v1, m2, v2):
            m, v = orig(m1.double(), v1.double(), m2.double(), v2.double())
            return m.float(), v.float()

        monkeypatch.setattr(iir, "_combine", combine)
    x2 = torch.from_numpy(x)[None]
    y, _ = iir._cascade(sos, x2, x2.new_zeros((sos.shape[0], 1, 2)),
                        torch.float32)
    return y[0].numpy()


@pytest.mark.parametrize("variant,design", [
    ("reference", "a"), ("reference", "c"), ("float32", "a"),
    ("float32", "c"), ("float32_f64_combines", "c")])
def test_c18_float32_scans_miss_scipy(variant, design, monkeypatch):
    """ROADMAP C18's witness: on 2 s of white noise a float32 scan of the
    weighting filters stays below the 70 dB gate against scipy, whether it
    is the reference's or this recursion in float32 (with or without
    float64 combines), so `sosfilt` scans in float64."""
    sos = (a_weighting_sos if design == "a" else c_weighting_sos)(48000.0)
    x = np.random.default_rng(25).uniform(-1, 1, 96000).astype(np.float32)
    want = scipy.signal.sosfilt(sos, x.astype(np.float64)).astype(np.float32)
    if variant == "reference":
        got = np.asarray(ref.sosfilt(sos, x))
    else:
        got = _f32_scan(sos, x, variant == "float32_f64_combines",
                        monkeypatch)
    assert snr_db(want, got) < 70.0


def test_scan_mirrors_the_reference_recursion():
    """`_scan` is the log-depth odd/even recursion (depth ceil(log2 T), no
    loop over samples), with the state products elementwise: no einsum,
    matmul or bmm is called on them; its prefix equals a sequential
    composition of the same affine maps in float64."""
    calls = []
    depth = [0, 0]
    orig = iir._scan

    def counting(m, v):
        depth[0] += 1
        depth[1] = max(depth[1], depth[0])
        try:
            return orig(m, v)
        finally:
            depth[0] -= 1

    def refuse(*a, **k):
        calls.append(a)
        raise AssertionError("a GEMM on the scan's state")

    t = 1000
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(iir, "_scan", counting)
        for name in ("einsum", "matmul", "bmm", "mm"):
            mp.setattr(torch, name, refuse)
        rng = np.random.default_rng(26)
        a_mat = torch.from_numpy(rng.uniform(-0.5, 0.5, (3, 3)))
        vecs = torch.from_numpy(rng.standard_normal((3, 2, t)))
        m_cum, v_cum = iir._scan(a_mat[:, :, None].expand(3, 3, t), vecs)
    finally:
        mp.undo()
    assert not calls
    assert depth[1] == int(np.ceil(np.log2(t)))  # 1000, 500, ..., 3, 1
    m = np.eye(3)
    s = np.zeros((3, 2))
    a = a_mat.numpy()
    for k in range(t):
        m = a @ m
        s = a @ s + vecs[:, :, k].numpy()
        if k in (0, 1, 2, 511, 998, 999):
            np.testing.assert_allclose(m_cum[:, :, k].numpy(), m, atol=1e-12)
            np.testing.assert_allclose(v_cum[:, :, k].numpy(), s, atol=1e-12)


def test_tensor_input_stays_on_its_device_and_numpy_defaults_to_cuda():
    sos = butter_sos(2, 0.2)
    x = torch.from_numpy(_noise(64))
    assert sosfilt(sos, x).device == x.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sosfilt(sos, _noise(64))
