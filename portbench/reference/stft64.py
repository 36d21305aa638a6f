"""The plain reference of the STFT -> spectral function -> iSTFT -> OLA
round-trip, in float64, and the TF32 control.

Plain PyTorch on whatever device its input lies on. It imports nothing of
the program and takes nothing the program made: the window, the DFT bases,
the per-bin gains, the gate and the COLA norm are worked out here from the
configuration and the traffic mix.

Semantics (those of `round_trip` and of the sharded stream): frames of N
samples at hop H from offset 0 of the (for `center`, reflect-101 padded by
N/2) signal, times the periodic Hann window; the real DFT; the spectral
function on each bin; the inverse real DFT (the imaginary parts of DC and
Nyquist ignored); the frames summed into their places; each sample divided
by max(sum of the window over the frames that cover it, eps).

`precision="tf32"` is the control: every product's operands rounded to
TF32 (10 stored mantissa bits, to nearest even), products and sums in
float32, the rest of the arithmetic in float32 as well.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def hann(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), still float32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def per_bin_gains(spectral: dict, nfft: int, sample_rate: int):
    """A fixed real gain for each of the N/2+1 bins, or None."""
    if spectral["kind"] != "band_gain":
        return None
    freqs = np.arange(nfft // 2 + 1) * (sample_rate / nfft)
    band = np.searchsorted(np.asarray(spectral["edges_hz"], np.float64), freqs)
    return np.asarray(spectral["gains"], np.float64)[band]


def gate_levels(spectral: dict) -> tuple:
    """noise_gate's (threshold on |X|^2, gain below it), as float32 values."""
    thresh = float(np.float32(10.0 ** (spectral["threshold_db"] / 10.0)))
    att = float(np.float32(10.0 ** (spectral["attenuation_db"] / 20.0)))
    return thresh, att


class RoundTrip:
    """The round-trip of one configuration and spectral function, at one
    precision ("float64" or "tf32") on one device."""

    def __init__(self, config: dict, spectral: dict, device,
                 precision: str = "float64") -> None:
        if config["window"] != "hann" or not config["periodic"]:
            raise ValueError("the reference knows the periodic Hann window")
        n, hop = config["frame_size"], config["hop_size"]
        if n % hop:
            raise ValueError("the reference takes hop sizes that divide N")
        self.n, self.hop = n, hop
        self.eps = float(config["eps"])
        self.spectral = spectral
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        dev = torch.device(device)
        w = hann(n)
        k = np.arange(n // 2 + 1)
        ang = 2.0 * np.pi * np.outer(np.arange(n), k) / n  # [N, K]
        scale = np.where((k == 0) | (k == n // 2), 1.0, 2.0) / n
        mats = {
            "fwd_re": w[:, None] * np.cos(ang),  # window folded in
            "fwd_im": -w[:, None] * np.sin(ang),
            "inv_re": (scale[:, None] * np.cos(ang.T)),  # [K, N]
            "inv_im": (-scale[:, None] * np.sin(ang.T)),
        }
        self.mats = {key: self._operand(torch.from_numpy(m).to(dev))
                     for key, m in mats.items()}
        self.window = torch.from_numpy(w).to(dev, self.dtype)
        gains = per_bin_gains(spectral, n, config["sample_rate"])
        self.gains = (None if gains is None
                      else torch.from_numpy(gains).to(dev, self.dtype))
        self.gate = (gate_levels(spectral)
                     if spectral["kind"] == "noise_gate" else None)
        self.gated_bins = 0  # bins below the gate's threshold so far
        self.bins = 0

    def _operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return tf32_round(t) if self.tf32 else t

    def _mm(self, a: torch.Tensor, key: str) -> torch.Tensor:
        return torch.matmul(self._operand(a), self.mats[key])

    def frames_out(self, seg: torch.Tensor) -> torch.Tensor:
        """[R, L] -> the processed frames [R, F, N] of every whole frame of
        the segment from offset 0."""
        frames = seg.to(self.dtype).unfold(-1, self.n, self.hop)
        re, im = self._mm(frames, "fwd_re"), self._mm(frames, "fwd_im")
        if self.gains is not None:
            re, im = re * self.gains, im * self.gains
        if self.gate is not None:
            thresh, att = self.gate
            keep = re * re + im * im >= thresh
            self.gated_bins += int((~keep).sum())
            self.bins += keep.numel()
            s = torch.where(keep, 1.0, att).to(self.dtype)
            re, im = re * s, im * s
        return self._mm(re, "inv_re") + self._mm(im, "inv_im")

    def ola(self, frames: torch.Tensor) -> torch.Tensor:
        """[R, F, N] -> [R, (F-1)*H + N], each sample over max(its window
        coverage, eps)."""
        r_count = self.n // self.hop
        rows, f, _ = frames.shape
        acc = frames.new_zeros((rows, f + r_count - 1, self.hop))
        norm = frames.new_zeros((f + r_count - 1, self.hop))
        parts = frames.reshape(rows, f, r_count, self.hop)
        wparts = self.window.reshape(r_count, self.hop)
        for r in range(r_count):
            acc[:, r : r + f] += parts[:, :, r]
            norm[r : r + f] += wparts[r]
        out = acc / torch.clamp_min(norm, self.eps)
        return out.reshape(rows, -1)

    def segment(self, seg: torch.Tensor, row_block: int = 8) -> torch.Tensor:
        """The round-trip of every whole frame of `seg` [R, L] from offset
        0, in blocks of rows: [R, (F-1)*H + N] in the working precision."""
        outs = [self.ola(self.frames_out(seg[i : i + row_block]))
                for i in range(0, seg.shape[0], row_block)]
        return torch.cat(outs, dim=0)


def reflect101(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last axis by `pad` on both sides, mirroring about the end
    samples without repeating them."""
    left = x[..., 1 : pad + 1].flip(-1)
    right = x[..., -pad - 1 : -1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def clip_round_trip(rt: RoundTrip, x: torch.Tensor, center: bool,
                    row_block: int = 8) -> torch.Tensor:
    """`round_trip` of a clip [R, T]: the output the length of the input."""
    pad = rt.n // 2 if center else 0
    t = x.shape[-1]
    xp = reflect101(x, pad) if pad else x
    return rt.segment(xp, row_block)[..., pad : pad + t]


def stream_slice(ring: list, chunk: int, rows: slice, lo: int,
                 hi: int) -> torch.Tensor:
    """Samples [lo, hi) (stream positions, lo >= 0) of the stream whose
    chunk k is ring[k % len(ring)], on the given rows."""
    parts = []
    pos = lo
    while pos < hi:
        k, off = divmod(pos, chunk)
        take = min(hi - pos, chunk - off)
        parts.append(ring[k % len(ring)][rows, off : off + take])
        pos += take
    return torch.cat(parts, dim=-1)


def stream_round_trip(rt: RoundTrip, ring: list, chunk: int, rows: slice,
                      lo: int, hi: int, row_block: int = 8) -> torch.Tensor:
    """The one-shot round-trip over the whole stream (not centred), at
    stream positions [lo, hi) on `rows`: hop-aligned and at least N - H
    from the stream's start, where every sample has its full coverage."""
    edge = rt.n - rt.hop
    if lo % rt.hop or hi % rt.hop or lo < edge:
        raise ValueError(f"[{lo}, {hi}) is not an interior hop-aligned span")
    seg = stream_slice(ring, chunk, rows, lo - edge, hi + edge)
    return rt.segment(seg, row_block)[..., edge : edge + hi - lo]


def compare(y: torch.Tensor, ref: torch.Tensor) -> dict:
    """The two numbers the check holds: the relative RMS error and the
    largest error over the largest reference sample, in float64."""
    y64, r64 = y.double(), ref.double()
    d = y64 - r64
    err = math.sqrt(float(torch.sum(d * d)) / max(float(torch.sum(r64 * r64)),
                                                  1e-300))
    peak = float(d.abs().max()) / max(float(r64.abs().max()), 1e-300)
    if not (math.isfinite(err) and math.isfinite(peak)):
        err = peak = math.inf
    return {"err_rel": err, "peak_rel": peak}
