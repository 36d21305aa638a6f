"""The port's north-star dryrun and the accounting behind it, on CPU meshes.

Mirrors `tests/test_distributed.py`'s accounting tests and its `dryrun`
hook (slow in the reference; the port's runs at CRLOT_DRYRUN_SCALE=small
in the fast lane), against the reference where it computes the same thing:

* `collective_bytes_per_step` at `test_northstar_collective_bytes_exact`'s
  shapes: two ops of (N - H) * 4 * C_local bytes a shard, exactly;
* `overlap_dot_fraction` >= 0.75 at
  `test_blocked_mesh_main_dots_independent_of_halo_permutes`'s shapes, from
  the products the step launched; the pre-split formulation (one product
  over [left | block | right]) reads under 0.1 and its output is
  bit-equal;
* `permute_bytes_from_hlo` equal to the reference's parser on both HLO
  lowerings;
* `weak_scaling_model` equal to the reference's arithmetic, key for key,
  with both packages' interconnect and device figures injected to the same
  values through their module constants;
* `dryrun(4)` and `dryrun(3)` on CPU meshes, Part C reported as not
  measured (CPU tensors run synchronously).
"""

import numpy as np
import pytest
import torch

import crlot_tpu.profiling as jprof
from crlot_tpu.core.types import StftConfig as JStftConfig
from crlot_tpu.distributed import sharded_pipeline as jspl

import crlot_tpu_torch as pt
from crlot_tpu_torch import profiling, spectral
from crlot_tpu_torch.distributed import sharded_pipeline as spl

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _mesh(channel, time):
    return pt.make_mesh(channel, time, devices=[CPU] * (channel * time))


def test_collective_bytes_exact():
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=False)
    channels, total = 4, 4 * 2560
    acct = spl.collective_bytes_per_step(cfg, _mesh(2, 4), channels, total)
    halo_bytes = (1024 - 256) * 4 * (channels // 2)
    assert acct["collective_permute_ops"] == 2, acct
    assert acct["per_op_bytes"] == [halo_bytes, halo_bytes], acct
    assert acct["bytes_per_device_per_step"] == 2 * halo_bytes, acct
    # Edges receive zeros: 2 x 3 interior edges a row move their halo.
    assert acct["moved_bytes"] == 2 * 2 * 3 * halo_bytes
    assert acct["cross_rank_bytes"] == 0


def _blocked_setup():
    cfg = pt.StftConfig(frame_size=512, hop_size=128, center=False,
                        fft_backend=pt.FftBackend.MATMUL)
    eq = spectral.band_gain([3000.0], [1.0, 0.3], 48000, 512)
    return cfg, eq


def test_interior_products_do_not_wait_for_the_halos():
    cfg, eq = _blocked_setup()
    ov = spl.overlap_dot_fraction(cfg, _mesh(1, 4), channels=2,
                                  total_len=32768, spectral_fn=eq)
    assert ov["ppermute_ops"] == 2, ov
    assert ov["dot_macs_independent_of_halo"] > 0
    assert ov["independent_fraction"] >= 0.75, ov


def test_undoing_the_split_fails_the_overlap_and_keeps_the_bits(monkeypatch):
    """With no interior rows every product reads the [left | block | right]
    concat, the formulation before the split: the fraction falls below 0.1
    and the output is the same bits."""
    cfg, eq = _blocked_setup()
    x = np.random.default_rng(31).uniform(-1, 1, (2, 32768)).astype(
        np.float32)
    split = pt.sharded_round_trip(x, cfg, _mesh(1, 4), eq, device="cpu")
    monkeypatch.setattr(spl, "_interior_rows", lambda nb, *a: (0, 0))
    ov = spl.overlap_dot_fraction(cfg, _mesh(1, 4), channels=2,
                                  total_len=32768, spectral_fn=eq)
    # Only the first shard's head patch, which reads its block alone.
    assert ov["independent_fraction"] < 0.1, ov
    joined = pt.sharded_round_trip(x, cfg, _mesh(1, 4), eq, device="cpu")
    assert torch.equal(split, joined)


@pytest.mark.parametrize("mesh", [(2, 4), (1, 3)])
def test_blocked_split_equals_the_one_shard_mesh(mesh):
    cfg = pt.StftConfig(frame_size=1024, hop_size=256, center=False)
    t = mesh[1] * 6144
    x = np.random.default_rng(3).uniform(-1, 1, (4, t)).astype(np.float32)
    assert spl.blocked_per_bin(cfg, None, t_block=t // mesh[1],
                               num_frames=(t - 1024) // 256 + 1) is not None
    got = pt.sharded_round_trip(x, cfg, _mesh(*mesh), device="cpu")
    one = pt.sharded_round_trip(x, cfg, _mesh(1, 1), device="cpu")
    assert torch.equal(got, one)


def test_masked_route_products_all_consume_the_halo():
    cfg = pt.StftConfig(frame_size=256, hop_size=64, center=False)
    ov = spl.overlap_dot_fraction(cfg, _mesh(1, 2), channels=1,
                                  total_len=8192,
                                  spectral_fn=spectral.noise_gate(-30.0))
    assert ov["ppermute_ops"] == 2
    assert ov["independent_fraction"] == 0.0
    assert ov["dot_macs_consuming_halo"] > 0


SYNC = (
    "  %cp.1 = f32[2,768]{1,0} collective-permute(f32[2,768]{1,0} "
    "%param.3), source_target_pairs={{0,1},{1,2}}\n"
)
ASYNC = (
    "  %collective-permute-start.1 = (f32[2,768]{1,0}, f32[2,768]{1,0})"
    " collective-permute-start(f32[2,768]{1,0} %param.3), "
    "source_target_pairs={{0,1}}\n"
    "  %collective-permute-done.1 = f32[2,768]{1,0} "
    "collective-permute-done((f32[2,768]{1,0}, f32[2,768]{1,0}) "
    "%collective-permute-start.1)\n"
)


@pytest.mark.parametrize("txt", [SYNC, ASYNC, SYNC + ASYNC, ""])
def test_permute_bytes_regex_sync_and_async_hlo(txt):
    got = spl.permute_bytes_from_hlo(txt)
    assert got == jspl.permute_bytes_from_hlo(txt)
    assert got == [2 * 768 * 4] * (txt.count("collective-permute(")
                                   + txt.count("collective-permute-start("))


@pytest.mark.parametrize("n,hop,ch,block", [
    (1024, 256, 2, 48000), (1024, 256, 2, 6144), (1024, 256, 64, 1 << 20),
    (512, 128, 1, 8192), (2048, 512, 4, 96000)])
def test_weak_scaling_model_matches_the_reference(monkeypatch, n, hop, ch,
                                                  block):
    hbm, high, f32 = 2.0e12, 300e12, 40e12
    monkeypatch.setattr(profiling, "_DEVICE_SPECS", {
        "TEST": profiling.DeviceSpecs(hbm, high, f32, 2 * high)})
    monkeypatch.setattr(jprof, "_DEVICE_SPECS", {"TEST": (hbm, high, f32)})
    for mod, names in ((spl, ("NVLINK", "NIC")), (jspl, ("ICI", "DCN"))):
        monkeypatch.setattr(mod, f"{names[0]}_BYTES_PER_S", 100e9)
        monkeypatch.setattr(mod, f"{names[0]}_LATENCY_S", 3e-6)
        monkeypatch.setattr(mod, f"{names[1]}_BYTES_PER_S", 20e9)
        monkeypatch.setattr(mod, f"{names[1]}_LATENCY_S", 12e-6)
    got = spl.weak_scaling_model(pt.StftConfig(frame_size=n, hop_size=hop),
                                 ch, block, device_kind="TEST")
    want = jspl.weak_scaling_model(JStftConfig(frame_size=n, hop_size=hop),
                                   ch, block, device_kind="TEST")
    for key in ("halo_samples", "comm_bytes_per_device_per_step",
                "block_samples_per_device", "t_compute_us"):
        assert got[key] == want[key], key
    assert got["nvlink"] == want["ici"]
    assert got["nic_host_edge"] == want["dcn_host_edge"]


def test_weak_scaling_model_on_the_card():
    """The model's own figures: at a 1 s block the NVLink overlap misses
    0.8 (2.4 us of compute under a 5 us message); at config 5's 2^20-sample
    block it reaches 1."""
    cfg = pt.StftConfig(frame_size=1024, hop_size=256)
    m1 = spl.weak_scaling_model(cfg, 2, 48000,
                                device_kind=spl.TARGET_DEVICE)
    assert 2.3 < m1["t_compute_us"] < 2.5
    assert m1["nvlink"]["efficiency_overlap"] < 0.8
    assert m1["nic_host_edge"]["efficiency_prefetch_limit"] == 1.0
    m5 = spl.weak_scaling_model(cfg, 2, spl.CONFIG5_BLOCK,
                                device_kind=spl.TARGET_DEVICE)
    assert m5["nvlink"]["efficiency_overlap"] >= 0.8
    assert m1["nvlink"]["min_block_for_80pct_overlap"] < spl.CONFIG5_BLOCK


@pytest.mark.parametrize("n_devices", [4, 3])
def test_dryrun_on_a_cpu_mesh(monkeypatch, capsys, n_devices):
    monkeypatch.setenv("CRLOT_DRYRUN_SCALE", "small")
    s = pt.dryrun(n_devices, devices="cpu")
    assert s["dcn_prefetch_measured"] == (
        "not measured: CPU tensors run synchronously")
    assert s["weak_scaling_gate_nic_1s_prefetch"]["pass"]
    assert s["weak_scaling_gate_nvlink_overlap"]["pass"]
    assert s["overlap_structure_blocked_formulation"][
        "independent_fraction"] >= 0.75
    assert s["config5_scale"]["channels"] == 16
    mesh = {4: {"channel": 2, "time": 2}, 3: {"channel": 1, "time": 3}}
    assert s["config"]["mesh"] == mesh[n_devices]
    assert s["collectives"]["collective_permute_ops"] == 2
    assert '"dryrun": "north-star"' in capsys.readouterr().out


def test_dryrun_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.dryrun(4)
