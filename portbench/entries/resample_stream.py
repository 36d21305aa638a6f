"""The entry "resample_stream": `ResampledStftStreamer.feed` on one
stream whose chunk j is ring[j % ring], the ring on the card, through the
configuration's rates and framing; each feed's frames checked against the
float64 chain over the stream at their positions
(`reference/resample64.py`)."""

import torch

from portbench import signals
from portbench.reference import resample64

PORT_ROLLOFF = 0.1  # the port designs every stage's filter at this rolloff


def input_shape(cell) -> tuple:
    """(rows, samples) of one chunk, at the first rate."""
    return cell.config["channels"], cell.config["chunk_samples_per_card"]


def inputs(cell, seed: int, device) -> list:
    """The ring of `traffic["ring"]` chunks, made on `device` from `seed`."""
    rows, samples = input_shape(cell)
    return signals.ring(cell.traffic["signal"], int(cell.traffic["ring"]),
                        rows, samples, cell.config["rates"][0], seed, device)


class Loop:
    """`ResampledStftStreamer.feed` of the next chunk; each feed returns the
    frames it completed, tagged with the first one's index in the stream."""

    def __init__(self, cell, ring: list, device, mesh) -> None:
        from crlot_tpu_torch import ResampledStftStreamer, StftConfig

        c = cell.config
        if (c["window"] != "hann" or not c["periodic"]
                or c["rolloff"] != PORT_ROLLOFF):
            raise ValueError("the port frames with the periodic Hann window "
                             f"and resamples at rolloff {PORT_ROLLOFF}")
        cfg = StftConfig(frame_size=c["frame_size"], hop_size=c["hop_size"],
                         center=c["center"])
        self.ring, self.chunk = ring, ring[0].shape[1]
        self.streamer = ResampledStftStreamer(
            rates=tuple(c["rates"]), cfg=cfg, channels=ring[0].shape[0],
            device=device, atten_db=float(c["atten_db"]))
        self.fed = 0
        self.samples_per_step = ring[0].shape[0] * self.chunk

    def step(self, i: int):
        f0 = self.streamer.frames_out
        out = self.streamer.feed(self.ring[self.fed % len(self.ring)])
        self.fed += 1
        return out, (f0 if out.shape[-2] else -1)

    def pieces(self, kept) -> list:
        """A feed's frames with their reference: the float64 chain over the
        stream, frames [f0, f0 + F)."""
        out, f0 = kept
        f1 = f0 + out.shape[-2]
        return [(torch.view_as_real(out),
                 lambda ref: ref.stream_frames(self.ring, self.chunk, f0, f1))]

    def free(self) -> None:
        self.streamer = None


def reference(cell, device, precision: str):
    """The plain chain of the configuration, in float64 or (the control)
    TF32."""
    return resample64.Chain(cell.config, device, precision)
