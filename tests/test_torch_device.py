"""Where the port's entry points put array-like input: the card by default.

A tensor stays on its own device. A numpy array goes to `device=`, which
defaults to "cuda": without a card that raises (naming device='cpu'), and
nothing runs on the CPU unless it was asked for.
"""

import numpy as np
import pytest
import torch

import crlot_tpu_torch as pt
from crlot_tpu_torch import wire
from crlot_tpu_torch.core import device as _device
from crlot_tpu_torch.streaming_pipeline import (
    BlockedChunkStreamer,
    streaming_round_trip,
    streaming_round_trip_blocks,
)

CFG = pt.StftConfig(frame_size=256, hop_size=64, center=False)
X = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 8192)).astype(np.float32)
X16 = np.clip(np.rint(X * 32768), -32768, 32767).astype(np.int16)
WIRE_CFG = pt.StftConfig(frame_size=1024, hop_size=256, center=False)

# Each entry point on numpy input, with the device keyword passed through.
CALLS = {
    "round_trip": lambda **k: pt.round_trip(X, CFG, **k),
    "stft": lambda **k: pt.stft(X, CFG, **k),
    "istft": lambda **k: pt.istft(
        pt.stft(torch.from_numpy(X), CFG).numpy(), CFG, **k),
    "resample": lambda **k: pt.resample(X, 48000, 44100, **k),
    "resample_chunked": lambda **k: pt.resample_chunked(
        X, 48000, 44100, chunk=4096, **k),
    "resampled_stft": lambda **k: pt.resampled_stft(X, 48000, 44100, CFG,
                                                    **k),
    "convolve": lambda **k: pt.convolve(X, np.hanning(31), "same", **k),
    "sharded_round_trip": lambda **k: pt.sharded_round_trip(
        X, CFG, pt.make_mesh(1, 2, devices=["cpu"] * 2), **k),
    "streaming_round_trip": lambda **k: streaming_round_trip(
        X[0], CFG, block_frames=16, **k),
    "streaming_round_trip_blocks": lambda **k: streaming_round_trip_blocks(
        np.zeros((2, 8, 256), np.float32), CFG, 8, **k),
    "BlockedChunkStreamer": lambda **k: BlockedChunkStreamer(
        WIRE_CFG, **k).feed(np.zeros((1, 8192), np.float32)),
    "i16_round_trip": lambda **k: wire.i16_round_trip(X16[:, :4096],
                                                      WIRE_CFG, **k),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_numpy_input_defaults_to_the_card(name, monkeypatch):
    """The default device is resolved from None (that is, "cuda"); here a
    spy answers with the CPU so the call completes."""
    seen = []
    real = _device.resolve

    def spy(device=None):
        seen.append(device)
        return real("cpu" if device is None else device)

    monkeypatch.setattr(_device, "resolve", spy)
    CALLS[name]()
    assert seen and seen[0] is None


@pytest.mark.parametrize("name", sorted(CALLS))
def test_numpy_input_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CALLS[name]()


@pytest.mark.parametrize("name", sorted(CALLS))
def test_device_cpu_runs_on_the_cpu(name):
    out = CALLS[name](device="cpu")
    if isinstance(out, torch.Tensor):
        assert out.device.type == "cpu"


def test_default_device_is_cuda_and_meta_is_honoured(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _device.resolve() == torch.device("cuda")
    t = _device.place(X, "meta")
    assert t.device.type == "meta" and t.shape == X.shape
    with pytest.raises(ValueError, match="own device"):
        _device.place(torch.zeros(3), "meta")
    z = torch.zeros(3, dtype=torch.float64)
    assert _device.place(z) is z
    assert _device.place(z, dtype=torch.float32).dtype == torch.float32
