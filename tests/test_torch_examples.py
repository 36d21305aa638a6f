"""The port's eight examples against the JAX package's (`examples/*.py`).

Each port example runs in-process (`main([...])`) with `--device cpu` on
a 0.5 s 48 kHz 16-bit WAV (a 440 Hz tone in light noise, seed 0, as
`tests/test_examples.py` makes it); the JAX example runs in-process
through `runpy` on the same WAV (the conftest pins JAX to the CPU).
Tolerances, each measured well inside:

* WAV outputs (denoise, fir_filter, analyze's stems): every 16-bit code
  within 1 (measured: at most 1);
* sharded_eq: within 1 code over [N, T - N); the first and last N samples
  divide by the eps-clamped edge norm of the uncentered stream (values
  up to about 6e3 before clipping, in both packages), where float32
  roundoff is amplified, so they are not compared;
* time_stretch / pitch_shift: the output at least 90 dB against the
  reference's (measured 96.6 / 98.1 dB): the port sums the vocoder's phase
  in float64 where the reference sums it in float32 (`vocoder.py`);
* extract_features: every array within 1e-4 of its largest |value|
  (measured at most 4.1e-5, the contrast in dB), onset frames and tempo
  equal;
* loudness: each printed level within 0.1 dB (one printed digit);
  analyze: the printed tempo and energy split equal;
* streaming_checkpoint: within 1e-6 (measured 2.4e-7); and the port's
  crashed-then-resumed run equal to its unbroken run bit for bit.

Without `--device` an example runs on the card, so here it raises.
"""

import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crlot_tpu_torch.examples import (
    analyze,
    denoise,
    extract_features,
    fir_filter,
    loudness,
    sharded_eq,
    streaming_checkpoint,
    time_stretch,
)
from crlot_tpu_torch.io.wav import read_wav, write_wav

REPO = Path(__file__).resolve().parent.parent
N = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ex") / "in.wav")
    rng = np.random.default_rng(0)
    t = np.arange(24000) / 48000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(24000)).astype(np.float32)
    write_wav(path, x, 48000, bits=16)
    return path


def _ref(script, *args) -> str:
    """The JAX example `examples/<script>.py` in-process; its stdout."""
    path = str(REPO / "examples" / f"{script}.py")
    argv = sys.argv
    sys.argv = [path, *args]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = argv
    return buf.getvalue()


def _port(module, *args) -> str:
    """The port's example in-process on the CPU; its stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main([*args, "--device", "cpu"])
    return buf.getvalue()


def _codes(path) -> np.ndarray:
    data, sr = read_wav(path)
    assert sr == 48000
    return np.rint(data.astype(np.float64) * 32767).astype(np.int64)


def _wav_pair(tmp_path, module, script, *extra, name="out.wav"):
    a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"ref_{name}")
    _port(module, *extra[:1], a, *extra[1:])
    _ref(script, *extra[:1], b, *extra[1:])
    return _codes(a), _codes(b)


@pytest.mark.parametrize("module,script,extra", [
    (denoise, "denoise", ()),
    (fir_filter, "fir_filter", ("--cutoff-hz", "2000")),
])
def test_wav_examples_within_one_code(small_wav, tmp_path, module, script,
                                      extra):
    a, b = _wav_pair(tmp_path, module, script, small_wav, *extra)
    assert a.shape == b.shape
    assert int(np.abs(a - b).max()) <= 1


def test_sharded_eq_within_one_code_inside_the_edges(small_wav, tmp_path):
    a, b = _wav_pair(tmp_path, sharded_eq, "sharded_eq", small_wav)
    assert a.shape == b.shape
    assert int(np.abs(a - b)[:, N:-N].max()) <= 1


@pytest.mark.parametrize("flag,value", [("--rate", "1.5"),
                                        ("--semitones", "-5")])
def test_time_stretch_and_pitch_shift_match_the_reference(small_wav, tmp_path,
                                                          flag, value):
    a, b = _wav_pair(tmp_path, time_stretch, "time_stretch", small_wav, flag,
                     value)
    assert a.shape == b.shape
    a, b = a.astype(np.float64), b.astype(np.float64)
    snr = 10 * np.log10(np.sum(b * b) / max(np.sum((a - b) ** 2), 1e-30))
    assert snr >= 90.0, snr


def test_analyze_matches_the_reference(small_wav, tmp_path):
    out_p = _port(analyze, small_wav, "--write-stems", str(tmp_path / "p"))
    out_r = _ref("analyze", small_wav, "--write-stems", str(tmp_path / "r"))
    for stem in ("harmonic.wav", "percussive.wav"):
        a = _codes(tmp_path / "p" / stem)
        b = _codes(tmp_path / "r" / stem)
        assert a.shape == b.shape
        assert int(np.abs(a - b).max()) <= 1, stem
    for key in ("tempo:", "harmonic/percussive energy:", "length:"):
        lp = [ln for ln in out_p.splitlines() if ln.startswith(key)]
        lr = [ln for ln in out_r.splitlines() if ln.startswith(key)]
        assert lp == lr and lp, (lp, lr)
    m = re.search(r"harmonic/percussive energy: ([\d.]+)%", out_p)
    assert m and float(m.group(1)) > 70.0, out_p


def test_extract_features_match_the_reference(small_wav, tmp_path):
    a, b = str(tmp_path / "p.npz"), str(tmp_path / "r.npz")
    _port(extract_features, small_wav, a)
    _ref("extract_features", small_wav, b)
    fa, fb = np.load(a), np.load(b)
    assert sorted(fa.files) == sorted(fb.files)
    for k in fb.files:
        x, y = fa[k], fb[k]
        assert x.shape == y.shape, k
        if k in ("onset_frames", "tempo_bpm", "sample_rate", "hop_size"):
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            scale = max(float(np.max(np.abs(y))), 1e-30)
            assert float(np.max(np.abs(x - y))) <= 1e-4 * scale, k
    assert fa["mel"].shape[-1] == 64 and fa["mfcc"].shape[-1] == 13


def test_loudness_levels_match_the_reference(small_wav):
    num = re.compile(r"-?\d+\.\d")
    lp = _port(loudness, small_wav).strip().splitlines()
    lr = _ref("loudness", small_wav).strip().splitlines()
    assert len(lp) == len(lr) == 1
    vp = [float(v) for v in num.findall(lp[0])]
    vr = [float(v) for v in num.findall(lr[0])]
    assert len(vp) == len(vr) == 5  # three levels and the range
    assert max(abs(p - r) for p, r in zip(vp, vr)) <= 0.1 + 1e-9
    assert "A-weighted" in lp[0] and "dBFS" in lp[0]


def test_streaming_checkpoint_matches_the_reference(small_wav, tmp_path):
    a, b = str(tmp_path / "p.npy"), str(tmp_path / "r.npy")
    _port(streaming_checkpoint, small_wav, a, "--ckpt",
          str(tmp_path / "p.ckpt.npz"))
    _ref("streaming_checkpoint", small_wav, b, "--ckpt",
         str(tmp_path / "r.ckpt.npz"))
    ya, yb = np.load(a), np.load(b)
    assert ya.shape == yb.shape
    assert float(np.max(np.abs(ya - yb))) <= 1e-6


def test_streaming_checkpoint_resumes_bit_identically(small_wav, tmp_path):
    whole = str(tmp_path / "whole.npy")
    _port(streaming_checkpoint, small_wav, whole, "--ckpt",
          str(tmp_path / "w.ckpt.npz"), "--ckpt-every-seconds", "0.1")
    ckpt = str(tmp_path / "c.ckpt.npz")
    resumed = str(tmp_path / "resumed.npy")
    out = _port(streaming_checkpoint, small_wav, resumed, "--ckpt", ckpt,
                "--ckpt-every-seconds", "0.1", "--crash-after-seconds", "0.2")
    assert "simulated crash" in out and not os.path.exists(resumed)
    out = _port(streaming_checkpoint, small_wav, resumed, "--ckpt", ckpt,
                "--ckpt-every-seconds", "0.1")
    assert "resuming at frame" in out
    np.testing.assert_array_equal(np.load(resumed), np.load(whole))


def test_examples_run_as_modules(small_wav, tmp_path):
    """`python -m crlot_tpu_torch.examples.<name>` works from any
    directory with the repository on the path."""
    out = str(tmp_path / "out.wav")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "crlot_tpu_torch.examples.denoise", small_wav,
         out, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 1000


def test_default_device_is_the_card(small_wav, tmp_path):
    """Without `--device` an example asks for the card; without one it
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        denoise.main([small_wav, str(tmp_path / "o.wav")])


def test_card_check_of_the_time_stretch_fails_a_broken_phase_path(tmp_path):
    """`chip_smoke.py` phase 48 holds the card's time stretch against the
    CPU's frame by frame (ROADMAP C23): in every run of STRETCH_RUN
    frames, the median per-frame STFT magnitude distance at most
    STRETCH_GATE. Here, on the CPU and on that phase's input (2 ch x 60 s
    of full-scale noise from its seed, through a 16-bit WAV), two right
    routes (torch.fft and the MATMUL products, whose codes drift apart at
    the branch cut) read at most 0.0984, and the stretch with its phase
    accumulation dropped (the vocoder's running sum zeroed, as the
    script's `_broken_stretch` does on the card) at least 0.5772 in every
    run. The gate lies a factor 2 from each: the right route at most half
    of it, the broken path at least twice it."""
    import dataclasses

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import vocoder

    smoke = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke")
    sr, gate = smoke["SR"], smoke["STRETCH_GATE"]
    x = np.random.default_rng(smoke["SEED"]).uniform(
        -1.0, 1.0, (2, sr * smoke["SECONDS"])).astype(np.float32)
    wav = str(tmp_path / "in.wav")
    write_wav(wav, x, sr, bits=16)
    x, _ = read_wav(wav)
    cfg = pt.StftConfig(frame_size=1024, hop_size=256)

    def stretched(c):
        return _roundtrip_codes(tmp_path, pt.time_stretch(x, c, 1.5,
                                                          device="cpu"))

    fft_route = stretched(cfg)
    matmul_route = stretched(dataclasses.replace(
        cfg, fft_backend=pt.FftBackend.MATMUL))
    run_sum = vocoder._running_sum
    vocoder._running_sum = lambda inc: inc.new_zeros(inc.shape)
    try:
        broken = stretched(cfg)
    finally:
        vocoder._running_sum = run_sum
    assert np.abs(fft_route - matmul_route).max() * 32767 > 1  # C23
    worst, _ = smoke["_stretch_runs"](matmul_route, fft_route)
    z_worst, z_best = smoke["_stretch_runs"](broken, fft_route)
    assert worst <= gate / 2, worst
    assert z_best >= 2 * gate, z_best


def _roundtrip_codes(tmp_path, y) -> np.ndarray:
    """`y` as the example writes it (a 16-bit WAV) and reads back, in
    [-1, 1]."""
    path = str(tmp_path / "y.wav")
    write_wav(path, y.numpy(), 48000, bits=16)
    return _codes(path) / 32767.0
