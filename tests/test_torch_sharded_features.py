"""Channel-sharded features and IIR in the port: N shards == 1 device.

Mirrors `tests/test_sharded_features.py` on a CPU mesh (`make_mesh(8, 1,
devices=["cpu"] * 8)`): the channel axis split over the mesh's channel
shards, each shard computed on its device, the results gathered, and held
`torch.equal` to the one-device call — for `mel_spectrogram`, `mfcc`,
`spectral_centroid`, `sosfilt`, `hpss` (both parts), `pseudo_cqt` and
`pcen`. The reference holds `pcen` only to rtol 2e-5 (XLA fuses its pow
and scan differently per shard); the port holds it bit for bit (its
powers round once from float64, `features._pow`). On the card,
`chip_smoke.py` phases 31 and 36 hold the same property with two shards on
one card.
"""

import numpy as np
import pytest
import torch

from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.distributed.mesh import make_mesh
from crlot_tpu_torch.features import (
    mel_spectrogram,
    mfcc,
    pcen,
    pseudo_cqt,
    spectral_centroid,
)
from crlot_tpu_torch.iir import butter_sos, sosfilt

SR = 48000
CFG = StftConfig(frame_size=512, hop_size=128, center=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it leaves the cores
    to the other test workers (whose timing tests need them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sig(c, t, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.9, 0.9, (c, t)).astype(np.float32))


def _sharded(fn, x):
    """fn over the channel shards of an (8, 1) CPU mesh, gathered."""
    mesh = make_mesh(channel=8, time=1, devices=["cpu"] * 8)
    parts = x.chunk(mesh.shape["channel"], dim=0)
    outs = [fn(p.to(mesh.device(c, 0)).clone())
            for c, p in enumerate(parts)]
    return torch.cat([o.to(x.device) for o in outs], dim=0)


def test_sharded_mel_bit_identical():
    x = _sig(8, SR // 2)
    f = lambda z: mel_spectrogram(z, CFG, float(SR), n_mels=32)  # noqa: E731
    assert torch.equal(_sharded(f, x), f(x))


def test_sharded_mfcc_bit_identical():
    x = _sig(8, SR // 2, seed=1)
    f = lambda z: mfcc(z, CFG, float(SR), n_mfcc=13, n_mels=32)  # noqa: E731
    assert torch.equal(_sharded(f, x), f(x))


def test_sharded_centroid_bit_identical():
    x = _sig(8, SR // 2, seed=2)
    f = lambda z: spectral_centroid(z, CFG, float(SR))  # noqa: E731
    assert torch.equal(_sharded(f, x), f(x))


def test_sharded_sosfilt_bit_identical():
    sos = butter_sos(4, 0.2)
    x = _sig(8, SR // 2, seed=3)
    f = lambda z: sosfilt(sos, z)  # noqa: E731
    assert torch.equal(_sharded(f, x), f(x))


def test_sharded_hpss_bit_identical():
    from crlot_tpu_torch.hpss import hpss

    x = _sig(8, SR // 4, seed=4)
    f = lambda z: torch.stack(hpss(z, CFG, kernel_harm=9,  # noqa: E731
                                   kernel_perc=9))
    assert torch.equal(_sharded(lambda z: f(z).transpose(0, 1), x),
                       f(x).transpose(0, 1))


def test_sharded_pseudo_cqt_bit_identical():
    x = _sig(8, SR // 4, seed=5)
    f = lambda z: pseudo_cqt(z, CFG, float(SR), n_bins=36,  # noqa: E731
                             fmin=110.0)
    assert torch.equal(_sharded(f, x), f(x))


def test_sharded_pcen_bit_identical():
    x = _sig(8, SR // 4, seed=6)
    mel = mel_spectrogram(x, CFG, float(SR), n_mels=32)
    f = lambda z: pcen(z, float(SR) / CFG.hop_size)  # noqa: E731
    assert torch.equal(_sharded(f, mel), f(mel))
