"""The tile geometry of B4's runs_kernel and of B6's TMA + wgmma modes, on
the CPU: what the CUDA sources choose, mirrored in Python and checked here.

B4 (`resample/kernel.py`): `geometry` picks J (outputs a run), R (runs a
thread), WC (classes a CTA) and the shared memory of a CTA; `runs_table`
shifts each run's taps into a zero-padded table so that the J outputs of a
run read one window. B6 (`int8_gemm.py`): `SM90_GEO` mirrors `Cfg` in
`csrc/b6_sm90.cu`, `sm90_budget` its shared memory and registers, and
`tile_plan` the windows TMA reads (256-byte stages for int16 input).
"""

from __future__ import annotations

import math
import re
from unittest import mock

import numpy as np
import pytest
import torch

from crlot_tpu_torch import cuda_build
from crlot_tpu_torch import int8_gemm as b6
from crlot_tpu_torch.resample import kernel as tk
from crlot_tpu_torch.resample.polyphase import output_length

RATES = [(44100, 48000), (48000, 16000), (48000, 44100), (16000, 48000),
         (44100, 16000), (8000, 48000), (22050, 44100), (48000, 22050)]


def _lm(sr_in, sr_out):
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


@pytest.mark.parametrize("sr_in,sr_out,plan", [
    (44100, 48000, ("runs", 8, 2, 4, 20)),
    (48000, 16000, ("runs", 7, 2, 1, 1)),
    (48000, 44100, ("runs", 8, 1, 8, 147)),
    (16000, 48000, ("runs", 7, 4, 1, 3)),
    (141, 1, ("blocks", 0, 1, 1, 0)),
    (48000, 22050, ("blocks", 0, 8, 1, 0)),
    (48000, 300, ("windows", 0, 0, 1, 0)),
])
def test_b4_tile_per_rate(sr_in, sr_out, plan):
    """The chain's two rates take runs_kernel: 44.1 -> 48 kHz with J = 8
    (Delta = 147 samples between a warp's lanes, odd), R = 2, 4 of the 20
    classes a CTA; 48 -> 16 kHz with J = 7 (Delta = 21), R = 2. Rates
    whose runs outgrow shared memory take the blocks tile, or the
    unstaged windows."""
    l, m = _lm(sr_in, sr_out)
    got = tk.geometry(l, m)
    assert (got.kind, got.j, got.r, got.wc, got.nc) == plan
    if got.kind == "runs":
        assert tk.run_period(l, m, got.j) % 2 == 1 or (l, m) == (147, 160)
        assert 0 < got.seg_floats * 4 <= tk.MAX_SHARED_BYTES
    if (sr_in, sr_out) in ((44100, 48000), (48000, 16000)):
        assert got.seg_floats * 4 <= tk.TWO_CTAS_BYTES  # two CTAs an SM


@pytest.mark.parametrize("sr_in,sr_out", RATES)
def test_runs_table_reads_each_output_as_the_compact_chain(sr_in, sr_out):
    """Output j0 + jj of a run is sum_n U[c, n, jj] * x[s_j0 + n]: the same
    products as the compact chain sum_k taps_t[k, j % L] * x[s_j + k], with
    zeros between (float64 here), and within 1e-5 of the dense bank."""
    l, m = _lm(sr_in, sr_out)
    j = tk.run_length(l, m)
    u, h0, span = tk.runs_table(l, m, None, 120.0, j)
    taps_t, offsets, tau_min, _ = tk.compact_bank(l, m, None, 120.0)
    tp = taps_t.shape[0]
    nc = tk.run_classes(l, j)
    assert u.shape == (nc, span, tk.U_COLS) and span >= tp
    x = np.random.default_rng(l + m).uniform(-1, 1, sr_in // 20 + 33)
    n_out = output_length(x.size, sr_in, sr_out)
    runs = -(-n_out // j)
    s = lambda jj: (jj * m + h0) // l - (tp - 1)  # noqa: E731
    assert all(s(b * l + i) == b * m + offsets[i] + tau_min
               for b in (0, 3) for i in range(l))
    pad = span + tp + m * (j + 1)
    xp = np.concatenate([np.zeros(pad), x, np.zeros(pad + span)])
    j0 = np.arange(runs) * j
    win = np.stack([xp[pad + s(a) : pad + s(a) + span] for a in j0])
    cls = np.arange(runs) % nc  # run rho = p*nc + c
    y_runs = np.einsum("rn,rnj->rj", win, u[cls][:, :, :j])
    y_runs = y_runs.reshape(-1)[:n_out]
    jj = np.arange(n_out)
    starts = np.array([s(a) for a in jj])
    wins = np.stack([xp[pad + a : pad + a + tp] for a in starts])
    y_compact = np.einsum("jk,kj->j", wins, taps_t[:, jj % l].astype(
        np.float64))
    np.testing.assert_allclose(y_runs, y_compact, rtol=0, atol=1e-12)
    bank = tk.resample_bank_plain(torch.from_numpy(x.astype(np.float32)), l,
                                  m, n_out).numpy()
    assert np.max(np.abs(y_runs - bank)) <= 1e-5


@pytest.mark.parametrize("sr_in,sr_out", RATES + [(48000, 16000)])
@pytest.mark.parametrize("r", [1, 2, 4, 8])
def test_runs_segment_holds_every_ctas_segment(sr_in, sr_out, r):
    """`runs_segment` is at least what each CTA of runs_kernel stages: U's
    slice and zero row, the output rows, and its input segment as the
    kernel measures it (first run's start to last run's start + span)."""
    l, m = _lm(sr_in, sr_out)
    j = tk.run_length(l, m)
    nc = tk.run_classes(l, j)
    wc = tk.class_warps(nc)
    _, h0, span = tk.runs_table(l, m, None, 120.0, j)
    tp = tk.compact_bank(l, m, None, 120.0)[0].shape[0]
    per_cta = (tk.WARPS // wc) * 32 * r
    fixed = (wc * span + 1) * tk.U_COLS + per_cta * ((wc * j) | 1) + 1
    seg = tk.runs_segment(l, m, j, r, wc, span) - fixed
    s = lambda a: (a * m + h0) // l - (tp - 1)  # noqa: E731
    p0 = np.arange(0, 40 * per_cta, per_cta, dtype=np.int64)
    for cls0 in range(0, nc, wc):
        last = min(cls0 + wc, nc) - 1
        need = s(((p0 + per_cta - 1) * nc + last) * j) + span - s(
            (p0 * nc + cls0) * j)
        assert need.max() <= seg


def test_run_length_keeps_a_warps_loads_on_distinct_banks():
    """J = 7 where 8 would put the lanes 8*M apart (L = 1: 48 -> 16 kHz)."""
    assert tk.run_length(160, 147) == 8 and tk.run_period(160, 147, 8) == 147
    assert tk.run_length(1, 3) == 7 and tk.run_period(1, 3, 7) == 21
    assert tk.run_period(1, 3, 8) == 24


def _cu_geometry():
    """{mode number: Geo<...> arguments} as b6_sm90.cu declares them."""
    src = (cuda_build.CSRC / "b6_sm90.cu").read_text()
    enum = dict(re.findall(r"(k\w+) = (\d+)", src[src.index("enum Mode"):
                                                  src.index("};", src.index(
                                                      "enum Mode"))]))
    out = {}
    for name, args in re.findall(r"struct Cfg<(k\w+)> : Geo<([^>]*)>", src):
        vals = [a.strip() for a in args.split(",")]
        out[int(enum[name])] = tuple(int(v) for v in vals[:6]) + (
            vals[6] == "true",)
    return out


def test_sm90_geometry_mirrors_the_cu():
    assert _cu_geometry() == b6.SM90_GEO
    assert ({b6._MODE_I32, b6._MODE_PROBE3, b6._MODE_BF16, b6.MODE_TF32X3}
            | set(b6.I16_MODES.values()) | set(b6.FUSEDQ_MODES.values())
            == set(b6.SM90_GEO))


@pytest.mark.parametrize("mode", sorted(b6.SM90_GEO))
def test_sm90_budget_fits_shared_memory_and_registers(mode):
    """Every mode's ring, staging and barriers fit 227 KB, and its
    accumulators (plus the int16 modes' and K11's limb fragments) stay well
    inside setmaxnreg's 232 registers a consumer thread. K11's stage holds
    128 f32 elements of K for 128 rows (64 KB) beside its two B tiles, so
    its ring has two stages; every other mode's at least three."""
    b = b6.sm90_budget(mode)
    assert b["smem"] <= b6.SM90_MAX_SMEM
    assert b["acc_regs"] <= b6.SM90_ACC_REGS
    assert b["acc_regs"] + b["frag_regs"] <= 160
    k11 = mode in b6.FUSEDQ_MODES.values()
    assert b["stages"] >= (2 if k11 else 3) and b["tile"][0] == 128
    if k11:
        assert b["stage_bytes"] == 4 * 128 * 128 + 2 * 128 * 128
        assert b["ktile_a_bytes"] == 4 * b6.KTILE_BYTES
    if mode in (0, 4):
        assert b["smem"] == 197_696  # the K8 / K9 kernel, unchanged


def test_sm90_tiles_at_the_wire_and_probe_geometry():
    """A mono wire chunk (4096 windows x 512): wire2's 128 x 64 tiles make
    256, two rounds on 132 SMs; wire1's 128 x 128 make 128; the probe's
    11264 x 512 makes 352 for probe3."""
    assert b6.sm90_tiles(6, 4096, 512) == 256
    assert b6.sm90_tiles(7, 4096, 512) == 128
    assert b6.sm90_tiles(1, 11264, 512) == 352


def test_tile_plan_of_int16_windows_takes_256_byte_stages():
    """The int16 modes read 128 samples (256 bytes) a stage: lda 512
    samples (1024 bytes) tiles the wire's windows as blocks m = kt // 4 at
    column 128 * (kt % 4), and a stride of 64 samples (128 bytes), fine for
    int8, is refused."""
    plan = b6.tile_plan(4096, 512, 2048, 2, 4099 * 512, 256)
    assert plan.width == 128
    assert plan.tiles == tuple((kt // 4, 128 * (kt % 4)) for kt in range(16))
    with pytest.raises(ValueError, match="multiple of 256 bytes"):
        b6.tile_plan(4, 64, 2048, 2, 64 * 64, 256)
    assert b6.tile_plan(4, 128, 2048, 1, 64 * 128).width == 128


def test_on_chip_limb_split_is_i16_limbs_over_all_codes():
    """The kernel's split (the high and low byte of each little-endian
    sample) equals the port's exact split on all 65 536 codes, and
    256*hi + lo gives the code back."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    hi, lo = b6.i16_limb_bytes(x.reshape(256, 256))
    want_hi, want_lo = b6.i16_limbs(x.reshape(256, 256))
    assert hi.dtype == torch.int8 and lo.dtype == torch.uint8
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    back = hi.to(torch.int32) * 256 + lo.to(torch.int32)
    assert torch.equal(back.reshape(-1), x.to(torch.int32))


@pytest.mark.parametrize("epilogue", ["wire2", "wire1"])
@pytest.mark.parametrize("batch", [1, 2])
def test_limb_gemm_i16_plain_is_the_limb_product(epilogue, batch):
    rng = np.random.default_rng(batch)
    rows, lda, k = 9, 64, 256
    x = torch.from_numpy(rng.integers(-32768, 32768,
                                      (batch, (rows + 3) * lda),
                                      dtype=np.int16))
    b0, b1 = (torch.from_numpy(rng.integers(-127, 128, (64, k),
                                            dtype=np.int8))
              for _ in range(2))
    got = b6.limb_gemm_i16(x, b0, b1, epilogue, 3e-5, rows=rows, lda=lda)
    hi, lo = b6.i16_limbs(x)
    want = b6.limb_gemm(hi, lo, b0, b1, epilogue, 3e-5, rows=rows, lda=lda)
    assert got.shape == (batch, rows, 64) and torch.equal(got, want)


def test_limb_gemm_i16_cuda_refuses_before_any_launch():
    """int16 A only, a wire epilogue only, and windows on 256-byte stages,
    all checked before the library is touched."""
    x = torch.zeros((1, 64 * 39 + 2048), dtype=torch.int16)
    bt = torch.zeros((64, 2048), dtype=torch.int8)
    with mock.patch.object(cuda_build, "require_cuda", lambda *a: None), \
            mock.patch.object(b6.cuda_build, "load_library",
                              side_effect=AssertionError("launched")):
        with pytest.raises(ValueError, match="multiple of 256 bytes"):
            b6.limb_gemm_i16_cuda(x, bt, bt, "wire2", rows=40, lda=64)
        with pytest.raises(ValueError, match="wire2"):
            b6.limb_gemm_i16_cuda(x, bt, bt, "probe3", rows=40, lda=64)
        with pytest.raises(ValueError, match="int16"):
            b6.limb_gemm_i16_cuda(x.to(torch.int8), bt, bt, "wire1",
                                  rows=40, lda=64)


@pytest.mark.parametrize("epilogue", ["wire2", "wire1", "probe4"])
def test_limb_gemm_cuda_takes_only_probe3_on_limbs(epilogue):
    """The kernel's limb modes on int8 limbs are K10's probe3 only: the
    wire epilogues take int16 samples, refused before any launch."""
    a = torch.zeros((128, 512), dtype=torch.int8)
    bt = torch.zeros((64, 512), dtype=torch.int8)
    with mock.patch.object(cuda_build, "require_cuda", lambda *a: None), \
            mock.patch.object(b6.cuda_build, "load_library",
                              side_effect=AssertionError("launched")):
        with pytest.raises(ValueError, match="probe3"):
            b6.limb_gemm_cuda(a, a, bt, bt, epilogue)
        with pytest.raises(ValueError, match="int8"):
            b6.limb_gemm_cuda(a, a.to(torch.uint8), bt, bt, "probe3")


@pytest.mark.parametrize("sr_in,sr_out", RATES + [(141, 1), (48000, 300)])
def test_geometry_is_plan_of_its_kind_and_r(sr_in, sr_out):
    """`geometry` picks a (kind, R, WC); `plan_of` derives every other field
    of that tile, the segment as the kernel stages it."""
    l, m = _lm(sr_in, sr_out)
    got = tk.geometry(l, m)
    assert tk.plan_of(l, m, got.kind, got.r, got.wc) == got
    if got.kind == "runs":
        assert got.seg_floats == tk.runs_segment(l, m, got.j, got.r, got.wc,
                                                 got.span)
    elif got.kind == "blocks":
        w = tk.compact_bank(l, m, None, 120.0)[3]
        assert got.seg_floats == tk.blocks_segment(l, m, w, got.r)


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 48000), (48000, 16000)])
def test_resample_cuda_refuses_a_stale_plan_before_any_launch(sr_in, sr_out):
    """A Plan whose R or WC changed but whose segment did not would stage
    past its shared memory: `resample_cuda` refuses any plan that is not
    `plan_of` its own fields, before the library is touched. The former blocks tile, built by `plan_of`, is taken."""
    l, m = _lm(sr_in, sr_out)
    plan = tk.geometry(l, m)
    x = torch.zeros(4096)
    n_out = output_length(x.numel(), sr_in, sr_out)
    stale = [plan._replace(r=plan.r * 2), plan._replace(wc=plan.wc * 2),
             plan._replace(seg_floats=plan.seg_floats - 1),
             plan._replace(span=plan.span - 1)]
    with mock.patch.object(cuda_build, "require_cuda", lambda *a: None), \
            mock.patch.object(cuda_build, "launch",
                              side_effect=AssertionError("launched")):
        for bad in stale:
            with pytest.raises(ValueError, match="plan_of"):
                tk.resample_cuda(x, l, m, n_out, plan=bad)
        with pytest.raises(AssertionError, match="launched"):
            tk.resample_cuda(x, l, m, n_out,
                             plan=tk.plan_of(l, m, "blocks", 8))


@pytest.mark.parametrize("sr_in,sr_out,kind,r,wc", [
    (141, 1, "runs", 1, 1), (48000, 300, "blocks", 1, 1),
    (44100, 48000, "runs", 3, 4), (44100, 48000, "runs", 2, 16)])
def test_plan_of_refuses_what_the_kernel_cannot_stage(sr_in, sr_out, kind, r,
                                                      wc):
    """A segment past 227 KB (the rates `geometry` sends to the blocks tile
    or the unstaged windows), or an R or WC the kernel has no instance of."""
    l, m = _lm(sr_in, sr_out)
    with pytest.raises(ValueError, match="shared memory|R and WC"):
        tk.plan_of(l, m, kind, r, wc)
