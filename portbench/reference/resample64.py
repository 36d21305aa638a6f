"""The plain reference of a resample chain framed at its last rate
(BASELINE config 3: 44.1 -> 48 -> 16 kHz, then Whisper's STFT), in
float64, and the TF32 control.

Plain PyTorch on whatever device its input lies on. It imports nothing of
the program and takes nothing the program made: each stage's filter and
the DFT bases are worked out here from the configuration.

Semantics (those of `resample` stage by stage, then `stft`, not
centred). A stage from rate a to rate b runs at L/M = b/a reduced. Its
filter is a Kaiser-windowed sinc: stopband attenuation `atten_db`, a
transition band `rolloff` times the output Nyquist wide and centred on the
cutoff (1 - rolloff / 2) / max(L, M) of the L-fold rate, odd length 2 *
half + 1 from the Kaiser formula (half = max(ceil((atten_db - 7.95) /
(2.285 * rolloff * pi / max(L, M))) // 2, max(L, M))), Kaiser beta from
`atten_db`, DC gain L. Output j is sum_s x[s] * h[j*M + half - s*L] over
the input samples s, x = 0 before sample 0 and past the end of a finite
signal, which gives ceil(T*L/M) outputs. Then frames of N samples at hop H
from sample 0 of the last rate, times the periodic Hann window, and their
real DFT (bins 0 .. N/2).

Each stage runs as its polyphase form, one product a block of L outputs
(a window of W inputs, stride M, times the [W, L] bank), in slabs that
bound the windows' copy; the frames' DFT as two products with the window
folded into the bases. `precision="tf32"` is the control: every
product's operands rounded to TF32 (`stft64.tf32_round`), products and
sums in float32 (the check runs it with TF32 off on the card, as
`drive.check` does). Outputs are `[rows, frames, N/2 + 1, 2]` (real and
imaginary parts), as `torch.view_as_real` gives the program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .stft64 import hann, stream_slice, tf32_round

SLAB = 1 << 24  # elements of a stage's window copy in one product


def kaiser_beta(atten_db: float) -> float:
    """Kaiser's beta for a stopband attenuation in dB."""
    a = atten_db
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def lowpass(l: int, m: int, atten_db: float, rolloff: float) -> np.ndarray:
    """The stage's filter h, float64, odd length, centred, DC gain L."""
    mx = max(l, m)
    n_total = math.ceil((atten_db - 7.95) / (2.285 * rolloff * np.pi / mx))
    half = max(n_total // 2, mx)
    k = np.arange(2 * half + 1, dtype=np.float64) - half
    fc = (1.0 - rolloff / 2.0) / mx
    h = fc * np.sinc(fc * k) * np.kaiser(2 * half + 1, kaiser_beta(atten_db))
    return h * (l / h.sum())


def operand(t: torch.Tensor, tf32: bool) -> torch.Tensor:
    """A product's operand: float64, or (the control) float32 rounded to
    TF32."""
    return tf32_round(t.float()) if tf32 else t.double()


class Stage:
    """One rate change: y[b*L + i] = sum_w bank[i, w] * x[b*M + r0 + w]."""

    def __init__(self, sr_in: int, sr_out: int, atten_db: float,
                 rolloff: float, tf32: bool, device) -> None:
        if sr_in <= 0 or sr_out <= 0:
            raise ValueError("rates must be > 0")
        g = math.gcd(sr_in, sr_out)
        self.l, self.m = sr_out // g, sr_in // g
        h = lowpass(self.l, self.m, atten_db, rolloff)
        half = (len(h) - 1) // 2
        self.r0 = -(half // self.l)  # the first input tap of output 0
        r = np.arange(self.r0, ((self.l - 1) * self.m + half) // self.l + 1)
        t = np.arange(self.l)[:, None] * self.m + half - r[None, :] * self.l
        ok = (t >= 0) & (t < len(h))
        bank = np.where(ok, h[np.clip(t, 0, len(h) - 1)], 0.0)  # [L, W]
        self.w = bank.shape[1]
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        self.bank_t = operand(torch.from_numpy(
            np.ascontiguousarray(bank.T)).to(device), tf32)  # [W, L]

    def length(self, n_in: int) -> int:
        return -(-n_in * self.l // self.m)

    def inputs_for(self, j0: int, j1: int) -> tuple:
        """The input samples [a, e) that outputs [j0, j1) read."""
        b0, b1 = j0 // self.l, -(-j1 // self.l)
        return b0 * self.m + self.r0, (b1 - 1) * self.m + self.r0 + self.w

    def outputs(self, x: torch.Tensor, x_lo: int, j0: int,
                j1: int) -> torch.Tensor:
        """Outputs [j0, j1) from x [R, n], the input samples [x_lo, x_lo +
        n); every other input sample is 0."""
        a, e = self.inputs_for(j0, j1)
        seg = x.new_zeros((x.shape[0], e - a), dtype=self.dtype)
        lo, hi = max(a, x_lo), min(e, x_lo + x.shape[-1])
        if hi > lo:
            seg[:, lo - a : hi - a] = x[:, lo - x_lo : hi - x_lo]
        win = operand(seg, self.tf32).unfold(-1, self.w, self.m)  # [R, B, W]
        blocks = win.shape[1]
        out = seg.new_empty((x.shape[0], blocks, self.l))
        step = max(1, SLAB // (self.w * x.shape[0]))
        for s in range(0, blocks, step):
            out[:, s : s + step] = torch.matmul(win[:, s : s + step],
                                                self.bank_t)
        skip = j0 - j0 // self.l * self.l
        return out.reshape(x.shape[0], -1)[:, skip : skip + j1 - j0]


class Chain:
    """The chain of one configuration (`rates`, `atten_db`, `rolloff`,
    `frame_size`, `hop_size`, a periodic Hann window, not centred), at one
    precision ("float64" or "tf32") on one device."""

    def __init__(self, config: dict, device,
                 precision: str = "float64") -> None:
        if config["window"] != "hann" or not config["periodic"]:
            raise ValueError("the reference knows the periodic Hann window")
        if config["center"]:
            raise ValueError("the reference frames the chain uncentred")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        dev = torch.device(device)
        rates = config["rates"]
        self.stages = [Stage(a, b, float(config["atten_db"]),
                             float(config["rolloff"]), self.tf32, dev)
                       for a, b in zip(rates, rates[1:])]
        self.n, self.hop = config["frame_size"], config["hop_size"]
        k = np.arange(self.n // 2 + 1)
        ang = 2.0 * np.pi * np.outer(np.arange(self.n), k) / self.n
        w = hann(self.n)[:, None]
        self.mats = [operand(torch.from_numpy(m).to(dev), self.tf32)
                     for m in (w * np.cos(ang), -w * np.sin(ang))]

    def spectrum(self, sig: torch.Tensor) -> torch.Tensor:
        """[R, L] at the last rate -> [R, F, N/2 + 1, 2]: every whole frame
        from sample 0."""
        frames = operand(sig, self.tf32).unfold(-1, self.n, self.hop)
        re, im = (torch.matmul(frames, m) for m in self.mats)
        return torch.stack([re, im], dim=-1)

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        """The chain over the finite signal x [R, T]: every frame of its
        last rate's ceil(...)-long output."""
        y = x
        for st in self.stages:
            y = st.outputs(y, 0, 0, st.length(y.shape[-1]))
        return self.spectrum(y)

    def stream_frames(self, ring: list, chunk: int, f0: int, f1: int,
                      row_block: int = 8) -> torch.Tensor:
        """Frames [f0, f1) of the chain over the unending stream whose
        chunk k is ring[k % len(ring)], in blocks of rows."""
        spans = [(f0 * self.hop, (f1 - 1) * self.hop + self.n)]
        for st in reversed(self.stages):
            spans.append(st.inputs_for(*spans[-1]))
        spans.reverse()  # spans[0]: the input read; spans[i + 1]: stage i
        lo, hi = max(0, spans[0][0]), spans[0][1]
        rows = ring[0].shape[0]
        outs = []
        for r in range(0, rows, row_block):
            y, y_lo = stream_slice(ring, chunk, slice(r, r + row_block),
                                   lo, hi), lo
            for st, (j0, j1) in zip(self.stages, spans[1:]):
                y, y_lo = st.outputs(y, y_lo, max(0, j0), j1), max(0, j0)
            outs.append(self.spectrum(y))
        return torch.cat(outs, dim=0)
