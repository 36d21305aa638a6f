"""Distributed execution: (channel, time) meshes, halo exchange, the
sharded round-trip and the sharded streamer (counterpart of
`crlot_tpu/distributed/`), single controller. Multi-process meshes and the
reference's HLO accounting are still to port."""

from .halo import pull_left_halo, pull_right_halo, push_right_tail
from .mesh import CHANNEL_AXIS, TIME_AXIS, Mesh, auto_mesh, make_mesh
from .sharded_pipeline import (
    blocked_per_bin,
    metrics_report,
    sharded_round_trip,
    sharded_round_trip_jit,
)
from .stream import ShardedStreamer, sharded_stream, sharded_stream_iter

__all__ = [
    "CHANNEL_AXIS",
    "Mesh",
    "ShardedStreamer",
    "TIME_AXIS",
    "auto_mesh",
    "blocked_per_bin",
    "make_mesh",
    "metrics_report",
    "pull_left_halo",
    "pull_right_halo",
    "push_right_tail",
    "sharded_round_trip",
    "sharded_round_trip_jit",
    "sharded_stream",
    "sharded_stream_iter",
]
