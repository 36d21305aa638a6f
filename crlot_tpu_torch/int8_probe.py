"""Probe: do the card's in-kernel int8 dots run at about twice its bf16 rate?

Counterpart of `scripts/bench_pallas_int8_probe.py`, which asked a TPU
whether Mosaic lowers in-kernel int8 dots at the double rate. Here the four
variants run on B6 (`int8_gemm`: K8, K9, K10 and K11 on the TMA + `wgmma`
modes of `csrc/b6_sm90.cu`) at the probe's
workload, [F, 512] x [512, 512] with F = 11264, on inputs made from seed 0
as the probe makes them (:113-122):

    python -m crlot_tpu_torch.int8_probe                          # the card
    python -m crlot_tpu_torch.int8_probe --device cpu --rows 256  # plain, small

On the card each variant is first held against its plain version (the
integer ones bit for bit, bf16 within 1e-6 of sum |x||b| per element), then
timed with CUDA events queued behind a busy card. One JSON line per
variant: µs per call, TOPS of one dot (2*F*N*K / t) and the µs of the one
library call computing the same function where there is one, in its
fastest operand layout (`torch._int_mm` for pl_i8;
`torch.mm(..., out_dtype=torch.float32)` for pl_bf16 where the card's
torch has it); for pl_bf16 and pl_i8 also both times with a cold L2
(`us_per_call_cold`, `library_us_cold`: 256 MB written before each timed
run), which the bytes bound assumes; then a summary line with the
int8-over-bf16 rate ratio.
On the CPU the plain versions run and nothing is timed ("not measured").
Exits 1 if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import int8_gemm as b6
from .core import device as _device

F, N, K = 11264, 512, 512
SEED = 0
BF16_REL_TOL = 1e-6  # per element, relative to sum_k |x||b|
COLD = ("pl_bf16", "pl_i8")  # variants also timed with a cold L2


def probe_inputs(rows: int = F, device="cuda") -> dict:
    """The probe's operands from seed 0 (its :113-122), the first `rows`
    rows of A, on `device`: Bt operands as [K, N] (K-contiguous) once."""
    if not 1 <= rows <= F:
        raise ValueError(f"rows must be in [1, {F}], got {rows}")
    rng = np.random.default_rng(SEED)
    x_f32 = rng.uniform(-1, 1, (F, N)).astype(np.float32)[:rows]
    b_f32 = rng.uniform(-1, 1, (N, K)).astype(np.float32)

    def to_i8(a):
        return np.clip(np.rint(a * 127), -127, 127).astype(np.int8)

    x_i8, b_i8 = to_i8(x_f32), to_i8(b_f32)
    b2_i8 = to_i8(rng.uniform(-0.5, 0.5, (N, K)).astype(np.float32))
    dev = _device.resolve(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x = put(x_f32)
    return {
        "x_f32": x,
        "x_bf16": x.to(torch.bfloat16),
        "bt_bf16": put(b_f32.T).to(torch.bfloat16),
        "xh": put(x_i8 + np.int8(1)),  # the probe's x_i8 + 1 (int8 wraps)
        "x_i8": put(x_i8),
        "b_i8": put(b_i8),
        "bt_i8": put(b_i8.T),
        "b2t_i8": put(b2_i8.T),
    }


def variants(t: dict) -> dict:
    """name -> (kernel call, plain call) on the probe's operands."""
    return {
        "pl_bf16": (lambda: b6.bf16_gemm(t["x_bf16"], t["bt_bf16"]),
                    lambda: b6.bf16_gemm_plain(t["x_bf16"], t["bt_bf16"])),
        "pl_i8": (lambda: b6.i8_gemm(t["xh"], t["bt_i8"]),
                  lambda: b6.i8_gemm_plain(t["xh"], t["bt_i8"])),
        "pl_i8_3dot": (
            lambda: b6.limb_gemm(t["xh"], t["x_i8"], t["bt_i8"], t["b2t_i8"],
                                 "probe3"),
            lambda: b6.limb_gemm_plain(t["xh"], t["x_i8"], t["bt_i8"],
                                       t["b2t_i8"], "probe3")),
        "pl_i8_fusedq": (
            lambda: b6.fusedq_gemm(t["x_f32"], t["bt_i8"], t["b2t_i8"]),
            lambda: b6.fusedq_gemm_plain(t["x_f32"], t["bt_i8"],
                                         t["b2t_i8"])),
    }


def library_calls(t: dict) -> dict:
    """name -> {label: call}: the one PyTorch call computing the same
    function, in each operand layout the card's torch takes (the caller
    keeps the fastest); never used by the port."""
    calls = {"pl_bf16": {}, "pl_i8": {}}
    x, bt = t["x_bf16"], t["bt_bf16"]
    try:
        torch.mm(x[:32], bt.T, out_dtype=torch.float32)
        calls["pl_bf16"]["torch.mm(out_dtype=float32)"] = (
            lambda: torch.mm(x, bt.T, out_dtype=torch.float32))
    except (TypeError, RuntimeError, NotImplementedError):
        pass  # no bf16 -> f32 matmul in this torch: library time null
    for label, b in (("row-major B", t["b_i8"]),
                     ("column-major B", t["bt_i8"].T)):
        try:
            torch._int_mm(t["xh"][:32], b)
        except RuntimeError:
            continue
        calls["pl_i8"][f"torch._int_mm, {label}"] = (
            lambda b=b: torch._int_mm(t["xh"], b))
    return {k: v for k, v in calls.items() if v}


def bf16_rel_err(got: torch.Tensor, t: dict) -> float:
    """max |got - plain| / sum_k |x||b| over all elements."""
    want = b6.bf16_gemm_plain(t["x_bf16"], t["bt_bf16"])
    scale = torch.matmul(t["x_bf16"].float().abs(),
                         t["bt_bf16"].float().abs().T)
    return float(((got - want).abs() / scale).max())


def check(name: str, got: torch.Tensor, want: torch.Tensor, t: dict):
    """(ok, max_abs_err) of a variant against its plain version."""
    err = float((got.double() - want.double()).abs().max())
    if name == "pl_bf16":
        return bf16_rel_err(got, t) <= BF16_REL_TOL, err
    return torch.equal(got, want), err


def run(rows: int = F, device="cuda") -> list:
    """Checks (on the card) and times every variant; returns one dict per
    variant, then a summary dict."""
    from .timing import cuda_ms

    def us(call, cold=False):
        q, per_call = cuda_ms(call, cold=cold)
        return (per_call if q is None else q) * 1e3, q is not None

    t = probe_inputs(rows, device)
    on_card = t["x_f32"].device.type == "cuda"
    flops = 2.0 * rows * N * K
    out = []
    lib = library_calls(t) if on_card else {}
    for name, (kern, plain) in variants(t).items():
        got = kern()
        rec = {"variant": name, "rows": rows, "shape": list(got.shape),
               "device": str(got.device)}
        if on_card:
            torch.cuda.synchronize()
            ok, err = check(name, got, plain(), t)
            rec.update(match_plain=bool(ok), max_abs_err=err)
            t_us, queued = us(kern)
            rec.update(us_per_call=t_us, queued=queued,
                       tops_1dot=flops / (t_us * 1e-6) / 1e12)
            rec["library_us"] = rec["library"] = None
            for label, call in lib.get(name, {}).items():
                l_us = us(call)[0]
                if rec["library_us"] is None or l_us < rec["library_us"]:
                    rec["library_us"], rec["library"] = l_us, label
            if name in COLD:
                rec["us_per_call_cold"] = us(kern, cold=True)[0]
                rec["library_us_cold"] = (
                    None if rec["library"] is None
                    else us(lib[name][rec["library"]], cold=True)[0])
        else:
            rec.update(us_per_call="not measured (cpu)", checksum=float(
                got.double().abs().sum()))
        out.append(rec)
    if on_card:
        rate = {r["variant"]: r["tops_1dot"] for r in out}
        out.append({"summary": "int8 / bf16 rate of one dot",
                    "i8_over_bf16": rate["pl_i8"] / rate["pl_bf16"],
                    "i8_3dot_over_bf16": rate["pl_i8_3dot"] / rate["pl_bf16"],
                    "device": torch.cuda.get_device_name(0)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=F,
                    help=f"rows of A (default the probe's F = {F})")
    args = ap.parse_args(argv)
    results = run(args.rows, args.device)
    for rec in results:
        print(json.dumps(rec), flush=True)
    return 0 if all(r.get("match_plain", True) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
