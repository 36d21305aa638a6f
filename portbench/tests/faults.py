"""Faults planted underneath the timed path, for the tests that see the
check catch them: `plant(name, setattr)` replaces a function of the
program (`setattr` is pytest's `monkeypatch.setattr`). Each is one of the faults a cell can have:

* "unchanged": the step returns its input as it came (no processing);
* "half": half of the batch left out (zeros): half of the channels, or
  of a mono clip's samples;
* "altered": one answer altered where it is produced (one sample).
"""

from __future__ import annotations

import torch

from crlot_tpu_torch import pipeline
from crlot_tpu_torch.distributed import sharded_pipeline

FAULTS = ("unchanged", "half", "altered")


def _halve(out: torch.Tensor) -> None:
    if out.shape[0] > 1:
        out[: out.shape[0] // 2] = 0.0
    else:
        out[..., out.shape[-1] // 2 :] = 0.0


def _round_trip(fault: str):
    orig = pipeline.round_trip

    def broken(signal, cfg, spectral_fn=None, device=None):
        if fault == "unchanged":
            return signal.clone()
        out = orig(signal, cfg, spectral_fn, device)
        if fault == "half":
            _halve(out)
        elif fault == "altered":
            out[0, out.shape[-1] // 2] += 0.01
        return out

    return broken


def _block_round_trip(fault: str):
    orig = sharded_pipeline._block_round_trip

    def broken(xs, norms, *args, **kwargs):
        outs, parts = orig(xs, norms, *args, **kwargs)
        if fault == "unchanged":
            outs = [None if o is None else x.float().clone()
                    for o, x in zip(outs, xs)]
        elif fault == "half":
            for o in outs:
                if o is not None:
                    _halve(o)
        elif fault == "altered":
            for o in outs:
                if o is not None:
                    o[0, o.shape[-1] // 2] += 0.01
                    break
        return outs, parts

    return broken


def plant(fault: str, entry: str, set_attr=setattr) -> None:
    """Break the program for a cell whose entry is `entry`."""
    if entry == "round_trip":
        set_attr(pipeline, "round_trip", _round_trip(fault))
    else:
        set_attr(sharded_pipeline, "_block_round_trip",
                 _block_round_trip(fault))
