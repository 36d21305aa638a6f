"""The port's meshes across processes: two gloo ranks on the CPU.

Mirrors `tests/test_multihost.py` (whose two-process run is `slow` in the
reference; this one is small enough for the fast lane): two OS processes
run `python -m crlot_tpu_torch.distributed.multihost_child` on a
(channel=2, time=2) global mesh, each rank holding one time block of each
channel row, so every halo crosses the process boundary. Bounds:

* inside the port, bit-exact (asserted by the child, and here on the
  results it writes): the gathered two-rank result, the mesh metrics and
  the chunked streamer (also resumed from a one-process state) equal a
  one-process (1, 1) mesh;
* port vs reference (`torch.fft` vs XLA's FFT, another GEMM order; the
  reference child's own gates are exact and rtol 5e-6 / atol 1e-5 within
  its package): the masked identity within max-abs 1e-5 of the JAX
  `round_trip` over [N, T - N) (the center=False edges divide by the
  near-zero norm of a periodic Hann, as `tests/test_torch_distributed.py`
  states); the blocked identity within rtol 5e-6 / atol 1e-5 of the JAX
  `roundtrip_composed_blocked` over the same interior; interior SNR above
  80 dB, as the reference child gates it.

The children run one intra-op thread each, under one 120 s deadline; when
one fails the other is killed.
"""

import json
import os
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crlot_tpu.core.types import FftBackend as JFftBackend
from crlot_tpu.core.types import StftConfig as JStftConfig
from crlot_tpu.fft import dispatch as jfftd
from crlot_tpu.fft.matmul_backend import roundtrip_composed_blocked
from crlot_tpu.metrics import snr_db
from crlot_tpu.ola.norm import edge_norm
from crlot_tpu.pipeline import round_trip as j_round_trip
from crlot_tpu.window.windows import get_window

import crlot_tpu_torch as pt
from crlot_tpu_torch.distributed import (
    GlobalArray,
    multihost,
    process_allgather,
)
from crlot_tpu_torch.distributed.mesh import Mesh
from crlot_tpu_torch.distributed.multihost_child import run_ranks

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both children's output and the results rank 0 wrote."""
    out = tmp_path_factory.mktemp("mh") / "result.npz"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-m",
             "crlot_tpu_torch.distributed.multihost_child", str(rank), "2",
             str(port), "--device", "cpu"]
            + (["--out", str(out)] if rank == 0 else [])
            for rank in (0, 1)]
    ranks = run_ranks(cmds, timeout=120, env=env, cwd=str(REPO))
    for rank, (rc, log) in enumerate(ranks):
        assert rc == 0, f"rank {rank} exited {rc}:\n{log}"
    logs = [log for _, log in ranks]
    report = json.loads(next(line for line in logs[0].splitlines()
                             if line.startswith("{")))
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    return logs, report, res


def test_two_ranks_equal_one_process(two_ranks):
    logs, report, _ = two_ranks
    assert "MULTIHOST_OK" in logs[0]
    assert report["process_info"] == {
        "process_index": 0, "process_count": 2, "local_devices": 2,
        "global_devices": 4, "backend": "gloo"}
    # Time-major within a rank: each row is [rank 0's, rank 1's] block.
    assert report["mesh_ranks"] == [[0, 1], [0, 1]]
    for leg in ("masked identity", "blocked identity", "noise_gate"):
        assert report[leg]["equal_to_one_process"], leg
        assert report[leg]["cross_rank_ops"] == 2, leg
    assert report["stream"]["equal_to_one_process"]
    assert report["stream"]["resumed_from_one_process_state"]
    assert report["prefetch"] == "not measured: CPU tensors run synchronously"


def test_two_ranks_halo_accounting(two_ranks):
    _, report, _ = two_ranks
    acct = report["collectives"]
    halo_bytes = (512 - 128) * 4  # one channel a row
    assert acct["collective_permute_ops"] == 2
    assert acct["per_op_bytes"] == [halo_bytes, halo_bytes]
    # Rank 0 holds time block 0 of both rows: its right halos come from
    # rank 1, its left ones are the edge's zeros.
    assert acct["cross_rank_bytes"] == 2 * halo_bytes


def test_two_ranks_within_the_reference(two_ranks):
    _, _, res = two_ranks
    x = res["x"]
    cfg = JStftConfig(frame_size=128, hop_size=32, center=False)
    want = np.asarray(j_round_trip(jnp.asarray(x), cfg))
    inner = slice(128, x.shape[1] - 128)
    assert np.abs(res["y"][:, inner] - want[:, inner]).max() <= 1e-5
    covered = (cfg.frame_spec.num_frames(8192) - 1) * 32 + 128
    assert snr_db(x[:, 128:covered - 128], res["y"][:, 128:covered - 128]) > 80

    cfg_b = JStftConfig(frame_size=512, hop_size=128, center=False,
                        fft_backend=JFftBackend.MATMUL)
    nfr = cfg_b.frame_spec.num_frames(x.shape[-1])
    w64 = get_window(cfg_b.window, 512, cfg_b.periodic, dtype=np.float64)
    acc = roundtrip_composed_blocked(
        jnp.asarray(x), 512, 128, nfr, w64, np.ones(257),
        precision=jfftd.to_lax_precision(cfg_b.fft_precision), group=2)
    norm = edge_norm(w64, 128, nfr, x.shape[-1]).astype(np.float32)
    ref_b = np.asarray(acc) / np.maximum(norm, np.float32(cfg_b.eps))
    inner_b = slice(512, x.shape[1] - 512)
    np.testing.assert_allclose(res["yb"][:, inner_b], ref_b[:, inner_b],
                               rtol=5e-6, atol=1e-5)
    assert snr_db(x[:, inner_b], res["yb"][:, inner_b]) > 80


def test_process_info_and_initialize_without_a_group():
    assert not torch.distributed.is_initialized()
    multihost.initialize()  # no coordinator: a one-process run, a no-op
    assert not torch.distributed.is_initialized()
    assert multihost.process_info(devices="cpu") == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1, "backend": None}
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("127.0.0.1:1")


def test_initialize_is_a_noop_when_the_group_exists():
    port = _free_port()
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        multihost.initialize("127.0.0.1:1", 2, 1, devices="cpu")  # no-op
        assert torch.distributed.get_world_size() == 1
        info = multihost.process_info(devices=["cpu"] * 4)
        assert info == {"process_index": 0, "process_count": 1,
                        "local_devices": 4, "global_devices": 4,
                        "backend": "gloo"}
        mesh = multihost.global_mesh(channel=2, devices=["cpu"] * 4)
        assert mesh.shape == {"channel": 2, "time": 2}
        assert mesh.ranks == ((0, 0), (0, 0)) and not mesh.spans_processes
        x = np.random.default_rng(0).uniform(-1, 1, (2, 4096)).astype(
            np.float32)
        cfg = pt.StftConfig(frame_size=256, hop_size=64)
        y = pt.sharded_round_trip(x, cfg, mesh, device="cpu")
        one = pt.sharded_round_trip(x, cfg, pt.make_mesh(
            1, 1, devices=["cpu"]), device="cpu")
        assert torch.equal(process_allgather(y), one)
    finally:
        torch.distributed.destroy_process_group()


def test_local_devices_default_to_the_card():
    assert multihost.local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.local_devices()


def test_global_array_windows_and_writes_its_own_shards():
    """A rank's view of a result on a mesh that spans processes: it holds
    and writes only its shards' columns."""
    cpu = torch.device("cpu")
    mesh = Mesh(devices=((cpu, cpu), (cpu, cpu)), ranks=((0, 1), (0, 1)),
                rank=0)
    assert mesh.spans_processes and mesh.local(1, 0) and not mesh.local(0, 1)
    blocks = {(0, 0): torch.zeros(1, 8), (1, 0): torch.zeros(1, 8)}
    y = GlobalArray(mesh, (2, 16), blocks)
    assert y.holds(0, 6, 10) and not y.holds(0, 8, 16)
    y.write(0, 6, torch.ones(1, 4))  # columns 6..9: only 6, 7 are ours
    assert blocks[(0, 0)][0].tolist() == [0] * 6 + [1, 1]
    assert not blocks[(1, 0)].any()
    w = y.window(4, 12).window(1, 5)
    assert w.cols == (5, 9) and w.shape == (2, 4)
