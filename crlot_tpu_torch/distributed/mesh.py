"""Device mesh for channel x time-block sharding.

Counterpart of `crlot_tpu/distributed/mesh.py`: a 2-D logical mesh

    ('channel', 'time')

where channels are embarrassingly parallel and the time axis carries the
frame-overlap halo exchange. The reference is single-controller (one
process drives every device through `shard_map`); so is the port: one
process holds one tensor per shard on the mesh's devices. A `Mesh` is a
`[channel][time]` grid of `torch.device`s, and a device may appear more
than once, which is how one card (or the CPU) hosts a mesh of several
shards.

A mesh can also span processes (`multihost.global_mesh`, over
`torch.distributed`): each entry then names the rank that holds it beside
its device, every rank runs the same program, and each computes only the
shards it holds (`Mesh.local`). A mesh without ranks is a one-process mesh
and behaves as before.

The reference's `io_sharding` returns a JAX `NamedSharding`, the placement
`jax.device_put` takes; torch has no counterpart (a shard here is a tensor
the code places itself), so it is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


@dataclass(frozen=True)
class Mesh:
    """`devices[c][t]` holds shard (c, t). On a process-spanning mesh
    `ranks[c][t]` is the rank that holds it and `rank` is this process's;
    `ranks=None` is a one-process mesh."""

    devices: tuple
    ranks: Optional[tuple] = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {CHANNEL_AXIS: len(self.devices),
                TIME_AXIS: len(self.devices[0])}

    def device(self, channel: int, time: int) -> torch.device:
        return self.devices[channel][time]

    def owner(self, channel: int, time: int) -> int:
        """The rank that holds shard (channel, time)."""
        return self.rank if self.ranks is None else self.ranks[channel][time]

    def local(self, channel: int, time: int) -> bool:
        """Whether this process holds shard (channel, time)."""
        return self.owner(channel, time) == self.rank

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and any(
            r != self.rank for row in self.ranks for r in row)

    def local_device(self) -> torch.device:
        """This process's first device on the mesh."""
        for c, row in enumerate(self.devices):
            for t, dev in enumerate(row):
                if self.local(c, t):
                    return dev
        raise ValueError(f"rank {self.rank} holds no shard of the mesh")


def visible_devices() -> list:
    """Every visible CUDA device (none without a card). The CPU is never a
    default: a CPU mesh lists its devices (`devices=["cpu"] * n`)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _default_devices() -> list:
    devices = visible_devices()
    if not devices:
        raise RuntimeError(
            "no CUDA device is visible; pass devices=[...] (e.g. ['cpu'] * n) "
            "to build a mesh on the CPU")
    return devices


def make_mesh(
    channel: int = 1,
    time: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (channel, time) mesh from the first channel*time entries of
    `devices` (default: `visible_devices()`, which raises without a card).
    `time=None` uses all remaining devices."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _default_devices())]
    n = len(devices)
    if time is None:
        if n % channel != 0:
            raise ValueError(f"{n} devices not divisible by channel={channel}")
        time = n // channel
    if channel < 1 or time < 1 or channel * time > n:
        raise ValueError(
            f"mesh ({channel} x {time}) needs {channel * time} devices, have {n}"
        )
    return Mesh(tuple(
        tuple(devices[c * time + t] for t in range(time))
        for c in range(channel)
    ))


def auto_mesh(
    n_devices: Optional[int] = None,
    channels: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Factor n devices into a near-square (channel, time) mesh, favouring
    a longer time axis; with `channels` (the data's channel count) the
    channel axis divides it."""
    if devices is None:
        devices = _default_devices()
    n = n_devices if n_devices is not None else len(devices)
    channel = 1
    for c in range(int(n**0.5), 0, -1):
        if n % c == 0 and (channels is None or channels % c == 0):
            channel = c
            break
    return make_mesh(channel=channel, time=n // channel, devices=devices)
