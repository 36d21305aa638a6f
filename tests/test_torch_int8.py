"""B6's plain versions vs the int8 probe's Pallas kernel bodies (K8-K11).

`scripts/bench_pallas_int8_probe.py` holds the four Pallas kernels. Its
bodies run on the CPU through `pl.pallas_call(..., interpret=True)` at a small
shape (F = 256, N = K = 128, TILE = 128), on inputs made from seed 0 as
the probe makes them. Tolerances: K9 and K10 bit for bit (exact int32 sums,
the same f32 epilogue); K11 bit for bit (the scale as XLA lowers it, a
product by the f32 reciprocal of 16256; the same IEEE divide x / s, round
half to even and epilogue order); K8 within 1e-6 of sum_k |x||b| per element
(f32 sums of exact bf16 products, in another order).
"""

import importlib.util
import json
import os
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crlot_tpu_torch import int8_gemm as b6
from crlot_tpu_torch import int8_probe

REPO = Path(__file__).resolve().parent.parent
F, N, K, TILE = 256, 128, 128, 128


@pytest.fixture(scope="module")
def probe():
    """The probe script as a module (its import sets a jax cache variable
    with setdefault; the environment is restored afterwards)."""
    path = REPO / "scripts" / "bench_pallas_int8_probe.py"
    spec = importlib.util.spec_from_file_location("int8_probe_ref", path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, out_dtype, ins, row_inputs=1):
    """The probe's `_grid_call` at the small shape, interpreted, with the
    first `row_inputs` operands tiled by rows. (`_grid_call` tiles only the
    first: K10's second A operand gets the fixed (N, K) block at (0, 0),
    so the probe's timing run reads the first TILE rows of xl for every
    tile. The kernel body is held here on the operands it names.)"""
    in_specs = [pl.BlockSpec((TILE, N), lambda i: (i, 0))] * row_inputs + [
        pl.BlockSpec((N, K), lambda i: (0, 0)) for _ in ins[row_inputs:]
    ]
    return np.asarray(pl.pallas_call(
        kernel, grid=(F // TILE,), in_specs=in_specs,
        out_specs=pl.BlockSpec((TILE, K), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((F, K), out_dtype), interpret=True,
    )(*ins))


@pytest.fixture(scope="module")
def inputs():
    """The probe's :113-122 at the small shape (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    x_f32 = rng.uniform(-1, 1, (F, N)).astype(np.float32)
    b_f32 = rng.uniform(-1, 1, (N, K)).astype(np.float32)

    def to_i8(a):
        return np.clip(np.rint(a * 127), -127, 127).astype(np.int8)

    x_i8, b_i8 = to_i8(x_f32), to_i8(b_f32)
    b2_i8 = to_i8(rng.uniform(-0.5, 0.5, (N, K)).astype(np.float32))
    return {"x_f32": x_f32, "b_f32": b_f32, "x_i8": x_i8,
            "xh": x_i8 + np.int8(1), "b_i8": b_i8, "b2_i8": b2_i8}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_k9_i8_plain_bit_exact_vs_pallas(probe, inputs):
    want = _interpret(probe._kernel_i8, jnp.int32,
                      [jnp.asarray(inputs["xh"]), jnp.asarray(inputs["b_i8"])])
    got = b6.i8_gemm(_t(inputs["xh"]), _t(inputs["b_i8"].T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = inputs["xh"].astype(np.int64) @ inputs["b_i8"].astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact)


def test_k10_3dot_plain_bit_exact_vs_pallas(probe, inputs):
    ins = [inputs["xh"], inputs["x_i8"], inputs["b_i8"], inputs["b2_i8"]]
    want = _interpret(probe._kernel_i8_3dot, jnp.float32,
                      [jnp.asarray(a) for a in ins], row_inputs=2)
    got = b6.limb_gemm(_t(inputs["xh"]), _t(inputs["x_i8"]),
                       _t(inputs["b_i8"].T), _t(inputs["b2_i8"].T), "probe3")
    np.testing.assert_array_equal(got.numpy(), want)


def test_k11_fusedq_plain_bit_exact_vs_pallas(probe, inputs):
    want = _interpret(probe._kernel_i8_fusedq, jnp.float32,
                      [jnp.asarray(inputs[k]) for k in ("x_f32", "b_i8",
                                                         "b2_i8")])
    got = b6.fusedq_gemm(_t(inputs["x_f32"]), _t(inputs["b_i8"].T),
                         _t(inputs["b2_i8"].T))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k8_bf16_plain_within_1e6_of_pallas(probe, inputs):
    x = jnp.asarray(inputs["x_f32"]).astype(jnp.bfloat16)
    b = jnp.asarray(inputs["b_f32"]).astype(jnp.bfloat16)
    want = _interpret(probe._kernel_bf16, jnp.float32, [x, b])
    xt = _t(inputs["x_f32"]).to(torch.bfloat16)
    bt = _t(inputs["b_f32"].T).to(torch.bfloat16)
    got = b6.bf16_gemm(xt, bt).numpy()
    scale = np.abs(xt.float().numpy()) @ np.abs(bt.float().numpy()).T
    assert np.max(np.abs(got - want) / scale) <= 1e-6


def test_k11_quantization_matches_the_probe_formula(inputs):
    """Limbs exact (q = 128*hi + lo, |hi| <= 127, |lo| <= 64) and the
    rounding half to even at a tie."""
    x = _t(inputs["x_f32"])
    hi, lo, s128 = b6.quantize_rows(x)
    q = hi.to(torch.int32) * 128 + lo.to(torch.int32)
    s = s128 / 128.0
    np.testing.assert_array_equal(q.numpy(), torch.round(x / s).numpy())
    assert int(hi.abs().max()) <= 127 and int(lo.abs().max()) <= 64
    # q = 64 puts q/128 on a tie: half to even gives hi 0, lo 64 (half
    # away from zero would give 1, -64).
    s1 = np.float32(1.0) * np.float32(1.0 / 16256.0)
    row = torch.tensor([[1.0, 64 * s1, 192 * s1]], dtype=torch.float32)
    h, l, _ = b6.quantize_rows(row)
    assert h[0].tolist() == [127, 0, 2] and l[0].tolist() == [0, 64, -64]


@pytest.mark.parametrize("rows,lda,k", [(7, 512, 2048), (5, 128, 256),
                                        (3, 64, 64)])
def test_i8_windows_equal_the_m_ordered_shifted_dots(rows, lda, k):
    """Overlapping-window rows (lda < K) equal the reference's sum of
    K/lda shifted block dots (`wire._hopblock_apply_i8`), exactly."""
    rng = np.random.default_rng(rows)
    x = rng.integers(-128, 128, (2, (rows - 1) * lda + k), dtype=np.int8)
    kern = rng.integers(-127, 128, (k, 64), dtype=np.int8)
    got = b6.i8_gemm(_t(x), _t(kern.T), rows=rows, lda=lda).numpy()
    mg = k // lda
    blocks = x.astype(np.int64).reshape(2, -1, lda)
    want = sum(blocks[:, m : m + rows] @ kern[m * lda : (m + 1) * lda]
               .astype(np.int64) for m in range(mg))
    np.testing.assert_array_equal(got, want)


def test_wire2_epilogue_matches_its_expression():
    """The "wire2" combination in the caller's order, with unsigned low
    limbs, against the same expression written out in numpy f32."""
    rng = np.random.default_rng(3)
    hi = rng.integers(-128, 128, (1, 4 * 64 + 128), dtype=np.int8)
    lo = rng.integers(0, 256, (1, 4 * 64 + 128), dtype=np.uint8)
    kh = rng.integers(-127, 128, (64, 128), dtype=np.int8)
    kl = rng.integers(-64, 65, (64, 128), dtype=np.int8)
    scale = float(np.float32(0.37 / 32768))
    got = b6.limb_gemm(_t(hi), _t(lo), _t(kh), _t(kl), "wire2", scale,
                       rows=5, lda=64).numpy()
    def dot(a, b):
        rows = np.stack([a[0, r * 64 : r * 64 + 128] for r in range(5)])
        return (rows.astype(np.int64) @ b.T.astype(np.int64)).astype(
            np.float32)

    f = np.float32
    want = ((dot(hi, kh) * f(32768) + dot(lo, kh) * f(128)
             + dot(hi, kl) * f(256) + dot(lo, kl)) * f(scale))
    np.testing.assert_array_equal(got[0], want)


def test_kernel_wrappers_refuse_non_cuda_tensors():
    meta = torch.empty((64, 128), dtype=torch.int8, device="meta")
    bt = torch.empty((64, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        b6.i8_gemm(meta, bt)
    with pytest.raises(ValueError, match="CUDA"):
        b6.limb_gemm(meta, meta, bt, bt, "probe3")
    with pytest.raises(ValueError, match="CUDA"):
        b6.fusedq_gemm(torch.empty((64, 128), device="meta"), bt, bt)
    with pytest.raises(ValueError, match="epilogue"):
        b6.limb_gemm_cuda(meta, meta, bt, bt, "wire3")


def test_int8_probe_cpu_run(capsys):
    """`python -m crlot_tpu_torch.int8_probe --device cpu --rows 256`:
    the plain versions on the probe's inputs, nothing timed; its default
    device is the card, which raises when none is visible."""
    assert int8_probe.main(["--device", "cpu", "--rows", "256"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["variant"] for r in lines] == [
        "pl_bf16", "pl_i8", "pl_i8_3dot", "pl_i8_fusedq"]
    for r in lines:
        assert r["shape"] == [256, 512]
        assert r["us_per_call"] == "not measured (cpu)"
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            int8_probe.main(["--rows", "64"])


def test_int8_probe_inputs_are_the_probes(inputs):
    """The port's probe inputs at full shape start with the same rows."""
    t = int8_probe.probe_inputs(rows=8, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (int8_probe.F, int8_probe.N)).astype(np.float32)
    np.testing.assert_array_equal(t["x_f32"].numpy(), x[:8])
    assert t["xh"].dtype == torch.int8 and int(t["xh"].max()) <= 127


def _signal(rng, batch, length, elem):
    if elem == 1:
        return torch.from_numpy(rng.integers(-128, 128, (batch, length),
                                             dtype=np.int8))
    return torch.from_numpy(rng.uniform(-1, 1, (batch, length)).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("rows,lda,k,elem,batch", [
    (4096, 512, 2048, 1, 1),  # the wire's windows: lda 512, K 2048
    (7, 512, 2048, 1, 1),
    (130, 512, 2048, 1, 2),   # batch 2 of windows
    (999, 128, 320, 1, 2),    # windows with a ragged last K tile
    (5, 576, 576, 1, 1),      # dense, K bytes % 128 = 64
    (1000, 64, 64, 1, 1),     # dense K of 64 bytes: one half-filled tile
    (9, 512, 512, 2, 1),      # bf16 dense (the probe's K)
    (9, 288, 288, 2, 1),      # bf16 dense, K bytes % 128 = 64
])
def test_tile_plan_gathers_the_windows(rows, lda, k, elem, batch):
    """The TMA kernel's reads: K tile kt from the non-overlapping
    [L // lda, lda] view at (row + m, j), zero past the view's rows and
    columns (TMA's out-of-bounds fill), concatenated over the tiles and cut
    to K, is each window of `windows` exactly."""
    length = (rows - 1 + -(-k // lda)) * lda
    x = _signal(np.random.default_rng(rows + lda), batch, length, elem)
    plan = b6.tile_plan(rows, lda, k, elem, length)
    assert plan.width * elem == b6.KTILE_BYTES
    assert len(plan.tiles) == -(-k * elem // b6.KTILE_BYTES)
    view = x[..., : plan.view_rows * lda].reshape(batch, plan.view_rows, lda)
    parts = []
    for m, j in plan.tiles:
        block = view[:, m : m + rows, j : j + plan.width]
        parts.append(torch.nn.functional.pad(
            block, (0, plan.width - block.shape[-1],
                    0, rows - block.shape[-2])))
    got = torch.cat(parts, dim=-1)[..., :k]
    assert torch.equal(got, b6.windows(x, rows, lda, k))


def test_tile_plan_of_the_wire_is_the_m_ordered_blocks():
    """lda 512, K 2048: tile kt is block m = kt // 4 of the reference's
    mg = 4 shifted dots, at column 128 * (kt % 4)."""
    plan = b6.tile_plan(4096, 512, 2048, 1, 4099 * 512)
    assert plan.view_rows == 4099
    assert plan.tiles == tuple((kt // 4, 128 * (kt % 4)) for kt in range(16))


@pytest.mark.parametrize("lda,k,elem", [(64, 2048, 1), (192, 384, 1),
                                        (320, 1024, 1), (96, 192, 2)])
def test_tile_plan_refuses_overlapping_windows_off_the_tile(lda, k, elem):
    """Overlapping windows (lda < K) whose row stride is not a multiple of
    128 bytes would put a K tile across two view rows."""
    with pytest.raises(ValueError, match="multiple of 128 bytes"):
        b6.tile_plan(4, lda, k, elem, 64 * lda)


def test_tile_plan_refuses_windows_past_the_view():
    """The view holds whole rows of lda only: a window reaching into the
    signal's ragged tail is refused, as are row strides off 16 bytes."""
    with pytest.raises(ValueError, match="do not fit"):
        b6.tile_plan(3, 512, 576, 1, 2 * 512 + 576)
    assert b6.tile_plan(3, 512, 576, 1, 4 * 512 + 100).view_rows == 4
    with pytest.raises(ValueError, match="multiples of 16"):
        b6.tile_plan(3, 520, 520, 1, 3 * 520)


def test_i8_kernel_wrapper_checks_the_tile_plan():
    """B6-i8's CUDA wrapper takes its geometry from `tile_plan`: windows
    the TMA kernel cannot read are refused before any launch."""
    x = torch.zeros((1, 64 * 39 + 2048), dtype=torch.int8)
    bt = torch.zeros((64, 2048), dtype=torch.int8)
    with mock.patch.object(b6.cuda_build, "require_cuda", lambda *a: None), \
            mock.patch.object(b6.cuda_build, "load_library",
                              side_effect=AssertionError("launched")):
        with pytest.raises(ValueError, match="multiple of 128 bytes"):
            b6.i8_gemm_cuda(x, bt, rows=40, lda=64)
