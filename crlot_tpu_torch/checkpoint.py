"""Stream-state checkpoint / resume as a plain `.npz` file.

Counterpart of `crlot_tpu/checkpoint.py`'s npz pair: the OLA ring, its
cursors and the stream position, so that a killed multi-hour job resumes
mid-stream. The file has the reference's keys, dtypes and JSON `meta`
(ring f32 [C, L], read_pos and produced int32, flushed bool), so a file
written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .convert import stream_state_to_reference
from .core import device as _device
from .core.types import OLAConfig
from .ola.streaming import OLAStreamState


def save_stream_state(
    path: str,
    state: OLAStreamState,
    cfg: OLAConfig,
    frame_index: int,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a resumable checkpoint: the ring state and the stream position.

    `frame_index` is the next frame counter the producer will push (its
    start sample is frame_index * hop). Written to a temporary file, then
    renamed."""
    meta = {
        "version": 1,
        "frame_index": int(frame_index),
        "cfg": {
            "sample_rate": cfg.sample_rate,
            "frame_size": cfg.frame_size,
            "hop_size": cfg.hop_size,
            "channels": cfg.channels,
            "eps": cfg.eps,
            "apply_window_inside": cfg.apply_window_inside,
            "ring_margin_hops": cfg.ring_margin_hops,
        },
        "extra": extra or {},
    }
    tmp = path + ".tmp.npz"
    np.savez(
        tmp, **stream_state_to_reference(state),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
    )
    os.replace(tmp, path)


def load_stream_state(path: str, device=None):
    """Returns (state, cfg, frame_index, extra); the ring goes to `device`
    (default "cuda"; `core/device.py`)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") != 1:
            raise ValueError(
                f"unsupported checkpoint version: {meta.get('version')}")
        state = OLAStreamState(
            ring=torch.from_numpy(np.array(z["ring"], dtype=np.float32)).to(
                _device.resolve(device)),
            read_pos=int(z["read_pos"]),
            produced=int(z["produced"]),
            flushed=bool(z["flushed"]),
        )
    cfg = OLAConfig(**meta["cfg"])
    return state, cfg, meta["frame_index"], meta["extra"]
