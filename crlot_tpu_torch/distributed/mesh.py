"""Device mesh for channel x time-block sharding.

Counterpart of `crlot_tpu/distributed/mesh.py`: a 2-D logical mesh

    ('channel', 'time')

where channels are embarrassingly parallel and the time axis carries the
frame-overlap halo exchange. The reference is single-controller (one
process drives every device through `shard_map`); so is the port: one
process holds one tensor per shard on the mesh's devices. A `Mesh` is a
`[channel][time]` grid of `torch.device`s, and a device may appear more
than once, which is how one card (or the CPU) hosts a mesh of several
shards. Multi-process meshes (`torch.distributed`) are later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

CHANNEL_AXIS = "channel"
TIME_AXIS = "time"


@dataclass(frozen=True)
class Mesh:
    """`devices[c][t]` holds shard (c, t)."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {CHANNEL_AXIS: len(self.devices),
                TIME_AXIS: len(self.devices[0])}

    def device(self, channel: int, time: int) -> torch.device:
        return self.devices[channel][time]


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
