"""Distributed execution: (channel, time) meshes, halo exchange, the
sharded round-trip and the sharded streamer (counterpart of
`crlot_tpu/distributed/`), in one process or across processes
(`torch.distributed`: `initialize`, `global_mesh`, `process_info`), with
the reference's accounting (`collective_bytes_per_step`,
`overlap_dot_fraction`, `weak_scaling_model`) and its north-star `dryrun`.
The reference's `io_sharding` (a JAX `NamedSharding`) has no torch
counterpart and is not ported."""

from .halo import pull_left_halo, pull_right_halo, push_right_tail
from .mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, auto_mesh, make_mesh
from .multihost import global_mesh, initialize, process_info
from .sharded_pipeline import (
    GlobalArray,
    blocked_per_bin,
    collective_bytes_per_step,
    dryrun,
    metrics_report,
    overlap_dot_fraction,
    permute_bytes_from_hlo,
    process_allgather,
    sharded_round_trip,
    sharded_round_trip_jit,
    weak_scaling_model,
)
from .stream import ShardedStreamer, sharded_stream, sharded_stream_iter

__all__ = [
    "CHANNEL_AXIS",
    "GlobalArray",
    "Mesh",
    "ShardedStreamer",
    "TIME_AXIS",
    "auto_mesh",
    "blocked_per_bin",
    "collective_bytes_per_step",
    "dryrun",
    "global_mesh",
    "initialize",
    "make_mesh",
    "metrics_report",
    "overlap_dot_fraction",
    "permute_bytes_from_hlo",
    "process_allgather",
    "process_info",
    "pull_left_halo",
    "pull_right_halo",
    "push_right_tail",
    "sharded_round_trip",
    "sharded_round_trip_jit",
    "sharded_stream",
    "sharded_stream_iter",
    "weak_scaling_model",
]
