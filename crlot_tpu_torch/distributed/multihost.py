"""Multi-process setup: meshes whose shards live in several processes.

Counterpart of `crlot_tpu/distributed/multihost.py` on `torch.distributed`.
Every process runs the same program: `initialize()` joins the process
group, `global_mesh()` lays every rank's devices on one (channel, time)
mesh, and the sharded round-trip and streamer compute on each rank only
the shards it holds, exchanging halos with their neighbours in other
ranks (`halo.py`).

The backend follows the ranks' devices and is fixed when the group
starts: "nccl" when every rank on a host has a card of its own, "gloo"
for CPU tensors and for ranks that share one card (NCCL refuses two ranks
on one device; gloo's sends take CPU tensors, so `halo.py` stages a card's
halos through pinned host buffers). Nothing catches a failure of one
backend to retry on the other.

The torch.distributed environment variables LOCAL_RANK and
LOCAL_WORLD_SIZE, where set, give a rank's place on its host; otherwise
every rank is taken to run on one host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh


def _local_rank(process_id: int) -> int:
    return int(os.environ.get("LOCAL_RANK", process_id))


def _local_world(num_processes: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    devices: Union[str, Sequence, None] = None,
) -> None:
    """Join the process group (`torch.distributed.init_process_group` at
    `tcp://<coordinator_address>`). A no-op when the group already exists
    or no coordinator is given (a one-process run).

    `devices` are this rank's devices as `local_devices` takes them: CPU
    devices, or ranks that share a card, run gloo; otherwise NCCL, with
    this rank's card made current."""
    if dist.is_initialized() or coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with a "
                         "coordinator_address")
    local = local_devices(devices, process_id)
    own_card = (
        all(d.type == "cuda" for d in local)
        and _local_world(num_processes) <= torch.cuda.device_count()
    )
    if own_card:
        torch.cuda.set_device(local[0])
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(
        backend="nccl" if own_card else "gloo", init_method=addr,
        world_size=num_processes, rank=process_id,
    )


def local_devices(devices: Union[str, Sequence, None] = None,
                  process_id: Optional[int] = None) -> list:
    """This rank's devices: `devices` as given (one device, or a list, a
    device repeated for several shards on it), or by default the card
    `cuda:<local rank % device count>`, which raises without a card."""
    if devices is not None:
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass devices='cpu'")
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    return [torch.device("cuda",
                         _local_rank(process_id) % torch.cuda.device_count())]


def global_mesh(channel: int = 1,
                devices: Union[str, Sequence, None] = None) -> Mesh:
    """A (channel, time) mesh over every rank's devices (`devices` as
    `local_devices` takes them, the same count on every rank).

    Time-major within a rank, so that a rank's shards are neighbours in
    time and only one block edge a channel row crosses to the next rank:
    with L local devices and L % channel == 0, row c holds, for each rank
    in order, that rank's devices c*L/channel .. (c+1)*L/channel - 1 (two
    ranks of 2 devices on channel=2: row c = [rank 0's c-th, rank 1's
    c-th]). Otherwise the ranks' devices, rank-major, fill the grid row by
    row, as the reference's reshape of `jax.devices()` does."""
    local = local_devices(devices)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        lists = [None] * world
        dist.all_gather_object(lists, [str(d) for d in local])
    else:
        rank, world, lists = 0, 1, [[str(d) for d in local]]
    per_rank = len(local)
    if any(len(v) != per_rank for v in lists):
        raise ValueError(f"ranks hold different device counts: {lists}")
    n = world * per_rank
    if n % channel != 0:
        raise ValueError(f"{n} devices not divisible by channel={channel}")
    n_time = n // channel
    if per_rank % channel == 0:
        step = per_rank // channel
        cells = [[(r, lists[r][c * step + j])
                  for r in range(world) for j in range(step)]
                 for c in range(channel)]
    else:
        flat = [(r, d) for r in range(world) for d in lists[r]]
        cells = [flat[c * n_time : (c + 1) * n_time] for c in range(channel)]
    return Mesh(
        devices=tuple(tuple(torch.device(d) for _, d in row) for row in cells),
        ranks=tuple(tuple(r for r, _ in row) for row in cells),
        rank=rank,
    )


def process_info(devices: Union[str, Sequence, None] = None) -> dict:
    """The reference's four keys (this rank, the rank count, this rank's
    devices and the mesh's) and the backend ("nccl", "gloo", or None
    without a process group)."""
    up = dist.is_initialized()
    world = dist.get_world_size() if up else 1
    n_local = len(local_devices(devices))
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_devices": n_local,
        "global_devices": world * n_local,
        "backend": dist.get_backend() if up else None,
    }
