"""The entry "stream": `ShardedStreamer.feed` on the mesh the mix names,
one stream whose chunk j is ring[j % ring], the ring on the card; each
completed chunk checked against the float64 one-shot round-trip over the
stream at its positions."""

from portbench import drive, signals
from portbench.reference import stft64

Loop = drive.StreamLoop


def input_shape(cell) -> tuple:
    """(rows, samples) of one chunk."""
    return cell.config["channels"], cell.config["chunk_samples_per_card"]


def inputs(cell, seed: int, device) -> list:
    """The ring of `traffic["ring"]` chunks, made on `device` from `seed`."""
    rows, samples = input_shape(cell)
    return signals.ring(cell.traffic["signal"], int(cell.traffic["ring"]),
                        rows, samples, cell.config["sample_rate"], seed,
                        device)


def reference(cell, device, precision: str):
    """The plain round-trip of the configuration and the mix's spectral
    function, in float64 or (the control) TF32."""
    return stft64.RoundTrip(cell.config, cell.traffic["spectral"], device,
                            precision)
