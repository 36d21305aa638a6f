"""The entry "round_trip": `pipeline.round_trip` on one clip of the
configuration a call (all its channels), from a ring of distinct clips
on the card; each output checked against the float64 round-trip of its
clip."""

from portbench import drive, signals
from portbench.reference import stft64

Loop = drive.ClipLoop


def input_shape(cell) -> tuple:
    """(rows, samples) of one clip."""
    return cell.config["channels"], cell.config["samples"]


def inputs(cell, seed: int, device) -> list:
    """The ring of `traffic["ring"]` clips, made on `device` from `seed`."""
    rows, samples = input_shape(cell)
    return signals.ring(cell.traffic["signal"], int(cell.traffic["ring"]),
                        rows, samples, cell.config["sample_rate"], seed,
                        device)


def reference(cell, device, precision: str):
    """The plain round-trip of the configuration and the mix's spectral
    function, in float64 or (the control) TF32."""
    return stft64.RoundTrip(cell.config, cell.traffic["spectral"], device,
                            precision)
