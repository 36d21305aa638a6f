"""The port's demo vs the reference's demo on the same WAV, on the CPU.

Both run end to end on a 2 s stereo 44.1 kHz 16-bit WAV written from a
seed. Their resampled WAVs (44.1 -> 48 kHz, streamed in chunks) have the
same length and differ by at most 1 LSB of 16-bit PCM (the fp32 resamplers
agree to 1e-5); their top-10 spectral peak tables name the same bins.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from crlot_tpu.demo import main as j_main

from crlot_tpu_torch.demo import main as t_main
from crlot_tpu_torch.io.wav import read_wav, write_wav
from crlot_tpu_torch.resample.polyphase import output_length

REPO = Path(__file__).resolve().parent.parent
SR = 44100


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """Five off-bin tones of distinct levels plus a little noise."""
    t = np.arange(2 * SR) / SR
    bins = [40.3, 93.7, 151.2, 230.45, 377.8]  # of the 4096-point table
    amps = [0.3, 0.2, 0.12, 0.07, 0.04]
    x = sum(a * np.sin(2 * np.pi * b * SR / 4096 * t)
            for b, a in zip(bins, amps))
    rng = np.random.default_rng(0)
    data = np.stack([x + 1e-3 * rng.standard_normal(t.size)
                     for _ in range(2)]).astype(np.float32)
    path = tmp_path_factory.mktemp("demo") / "in.wav"
    write_wav(str(path), data, SR, bits=16)
    return str(path)


def _peak_bins(text):
    table = text.split("top-10 peaks:")[1].splitlines()[2:12]
    return [int(re.split(r"\s+", row.strip())[0]) for row in table]


def test_demo_matches_reference(wav, tmp_path, capsys):
    assert j_main([wav, "--out-dir", str(tmp_path / "jax")]) == 0
    j_out = capsys.readouterr().out
    assert t_main([wav, "--out-dir", str(tmp_path / "torch"),
                   "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert _peak_bins(t_out) == _peak_bins(j_out)
    assert "== kernel == axpy_windowed(0, x, 0.5w, gain=2):" in t_out
    assert "ring cleared: True" in t_out
    snr = float(re.search(r"round-trip .*SNR ([\d.]+) dB", t_out).group(1))
    assert snr > 60.0
    got, sr_g = read_wav(str(tmp_path / "torch" / "resampled_48000.wav"))
    want, sr_w = read_wav(str(tmp_path / "jax" / "resampled_48000.wav"))
    assert sr_g == sr_w == 48000
    assert got.shape == want.shape == (1, output_length(2 * SR, SR, 48000))
    assert np.max(np.abs(got - want)) * 32767 <= 1.0 + 1e-3
    tone, _ = read_wav(str(tmp_path / "torch" / "tone440.wav"))
    assert tone.shape == (1, SR)


def test_demo_refuses_a_missing_card(tmp_path, monkeypatch):
    """--device cuda with no card raises; nothing falls back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        t_main(["--out-dir", str(tmp_path), "--device", "cuda"])
    assert not any(tmp_path.iterdir())


def test_demo_synthesizes_without_a_wav(tmp_path, capsys):
    assert t_main(["--out-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "synthesizing 2 s A440" in out
    bins = _peak_bins(out)
    assert round(bins[0] * SR / 4096) in range(430, 451)  # A440 leads


@pytest.mark.parametrize("backend", ["AUTO", "MATMUL"])
@pytest.mark.parametrize("n,nfft", [(4096, 4096), (1000, 1024), (3000, 2048)])
def test_rfft_irfft_match_reference(backend, n, nfft):
    """The peak table's non-windowed rfft (cropped / zero-padded to nfft):
    torch.fft on a CPU tensor (AUTO), the folded DFT products (MATMUL, what
    a CUDA tensor takes); vs jnp.fft within fp32 rounding (1e-4 relative
    to the spectrum's peak: 2048-term sums)."""
    import jax.numpy as jnp
    import torch

    from crlot_tpu.fft.dispatch import irfft as j_irfft, rfft as j_rfft
    from crlot_tpu_torch.core.types import FftBackend
    from crlot_tpu_torch.fft.dispatch import irfft, rfft

    x = np.random.default_rng(n).uniform(-1, 1, (2, n)).astype(np.float32)
    got = rfft(torch.from_numpy(x), nfft, FftBackend[backend]).numpy()
    want = np.array(j_rfft(jnp.asarray(x), nfft))
    assert got.shape == want.shape == (2, nfft // 2 + 1)
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
    back = irfft(torch.from_numpy(want), nfft, FftBackend[backend]).numpy()
    ref = np.asarray(j_irfft(jnp.asarray(want), nfft))
    assert np.max(np.abs(back - ref)) <= 1e-5


def test_python_dash_m_help():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "crlot_tpu_torch", "--help"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
