"""The born-int16 wire tier (`crlot_tpu_torch/wire.py`) on the CPU.

Mirrors the eight cases of `tests/test_wire_i16.py` with its thresholds
(identity >= 90 dB for both tiers, bit-exact chunk invariance, >= 85 dB
against the f32 blocked streamer, >= 60 dB for an EQ, resume bit-exact,
multichannel int16 egress, bad inputs), then holds the port's exact limb
split against the reference's:

* limb parity: for codes below 32640 both splits give the exact integer
  product; the outputs agree within 1e-6 in f32 (the limbs differ, so the
  f32 combination rounds differently: measured 6e-8) and within one
  int16 code;
* full range: codes -32768, 32639, 32640, 32767 and a full-scale square
  wave, against an int64 / float64 oracle of the interior product. The
  reference's split wraps 32640..32767 (ROADMAP C1); the port's is exact;
* the design-time kernel limbs are byte-equal to the reference's.
"""

import numpy as np
import pytest
import torch

from crlot_tpu import spectral as JS
from crlot_tpu import wire as jw
from crlot_tpu.core.types import FftBackend as JBackend
from crlot_tpu.core.types import StftConfig as JConfig
from crlot_tpu.streaming_pipeline import (
    _resolve_blocked_per_bin as j_resolve,
)
from crlot_tpu_torch import int8_gemm as b6
from crlot_tpu_torch import spectral as S
from crlot_tpu_torch import wire
from crlot_tpu_torch.core.types import StftConfig
from crlot_tpu_torch.fft import matmul_backend as mm
from crlot_tpu_torch.streaming_pipeline import BlockedChunkStreamer
from crlot_tpu_torch.wire import I16BlockedStreamer, i16_round_trip

CPU = "cpu"
CFG = StftConfig(frame_size=1024, hop_size=256, center=False)
JCFG = JConfig(frame_size=1024, hop_size=256, center=False,
               fft_backend=JBackend.MATMUL)
EDGE = 768


def _plan(fn=None):
    """The streamers' blocked plan at CFG for `fn` (the identity: None)."""
    return mm.blocked_plan_for(CFG, mm.blocked_response(CFG, fn))


def _wire_signal(total, seed=0, channels=None):
    rng = np.random.default_rng(seed)
    shape = (total,) if channels is None else (channels, total)
    x_f = rng.uniform(-0.9, 0.9, shape)
    x_i16 = np.clip(np.rint(x_f * 32768.0), -32768, 32767).astype(np.int16)
    return x_f, x_i16


def _snr_db(ref, got):
    err = got.astype(np.float64) - ref.astype(np.float64)
    return 10 * np.log10(
        np.sum(ref.astype(np.float64) ** 2)
        / max(float(np.sum(err**2)), 1e-300)
    )


def _f32_stream(x_deq, s, fn=None):
    st = BlockedChunkStreamer(CFG, spectral_fn=fn, device=CPU)
    outs = []
    for k in range(x_deq.shape[-1] // s):
        o = st.feed(x_deq[..., k * s : (k + 1) * s])
        if o is not None:
            outs.append(o)
    outs.append(st.finish())
    return np.concatenate(outs, axis=-1)


# --- the reference's eight cases -----------------------------------------


@pytest.mark.parametrize("tier", ["int8x2", "int8x1"])
def test_identity_interior_snr(tier):
    x_f, x_i16 = _wire_signal(48000)
    y = i16_round_trip(x_i16, CFG, tier=tier, emit_i16=False, device=CPU)
    assert _snr_db(x_f[EDGE:-EDGE], y[EDGE:-EDGE]) >= 90.0


def test_chunk_size_invariance_bitexact():
    _, x_i16 = _wire_signal(48000)
    ya = i16_round_trip(x_i16, CFG, chunk_samples=4096, device=CPU)
    yb = i16_round_trip(x_i16, CFG, chunk_samples=8192, device=CPU)
    yo = i16_round_trip(x_i16, CFG, device=CPU)  # single chunk
    assert ya.dtype == np.int16
    assert np.array_equal(ya, yb) and np.array_equal(ya, yo)
    # In f32 too, for chunkings that pad the stream to one length (49152).
    fa = i16_round_trip(x_i16, CFG, chunk_samples=4096, emit_i16=False,
                        device=CPU)
    fb = i16_round_trip(x_i16, CFG, chunk_samples=16384, emit_i16=False,
                        device=CPU)
    assert np.array_equal(fa, fb)


def test_matches_f32_blocked_streamer():
    _, x_i16 = _wire_signal(40960)
    x_deq = (x_i16.astype(np.float32) / 32768.0).astype(np.float32)
    y_f32 = _f32_stream(x_deq, 8192)
    y_i = i16_round_trip(x_i16, CFG, chunk_samples=8192, emit_i16=False,
                         device=CPU)
    assert _snr_db(y_f32, y_i) >= 85.0


def test_eq_per_bin_response():
    eq = S.band_gain([4000.0, 12000.0], [1.0, 0.4, 0.1], 48000, 1024)
    _, x_i16 = _wire_signal(40960, seed=3)
    x_deq = (x_i16.astype(np.float32) / 32768.0).astype(np.float32)
    y_f32 = _f32_stream(x_deq, 8192, eq)
    y_i = i16_round_trip(x_i16, CFG, spectral_fn=eq, chunk_samples=8192,
                         emit_i16=False, device=CPU)
    assert _snr_db(y_f32, y_i) >= 60.0


def test_resume_bitexact():
    _, x_i16 = _wire_signal(49152, seed=5)
    s = 8192
    chunks = [x_i16[k * s : (k + 1) * s] for k in range(6)]
    st = I16BlockedStreamer(CFG, device=CPU)
    full = [st.feed(c) for c in chunks] + [st.finish()]
    st1 = I16BlockedStreamer(CFG, device=CPU)
    for c in chunks[:3]:
        st1.feed(c)
    ck = st1.state()
    st2 = I16BlockedStreamer(CFG, device=CPU)
    st2.load_state(ck)
    resumed = [st2.feed(c) for c in chunks[3:]] + [st2.finish()]
    want = full[3:]
    assert len(resumed) == len(want)
    for a, b in zip(resumed, want):
        assert np.array_equal(a, b)


def test_multichannel_and_i16_egress_dtype():
    x_f, x_i16 = _wire_signal(24576, seed=7, channels=3)
    y = i16_round_trip(x_i16, CFG, chunk_samples=8192, device=CPU)
    assert y.dtype == np.int16 and y.shape == x_i16.shape
    snr = _snr_db(x_f[:, EDGE:-EDGE],
                  y[:, EDGE:-EDGE].astype(np.float64) / 32768.0)
    assert snr >= 90.0


def test_rejects_bad_inputs():
    st = I16BlockedStreamer(CFG, device=CPU)
    with pytest.raises(TypeError):
        st.feed(np.zeros(8192, np.float32))
    with pytest.raises(ValueError):
        st.feed(np.zeros(1000, np.int16))  # not G*hop aligned
    with pytest.raises(ValueError):
        I16BlockedStreamer(CFG, tier="int4")
    with pytest.raises(ValueError):
        I16BlockedStreamer(
            StftConfig(frame_size=1024, hop_size=256, center=True))


# --- against the reference ------------------------------------------------


@pytest.mark.parametrize("tier", ["int8x2", "int8x1"])
@pytest.mark.parametrize("eq", [False, True])
def test_kernel_limbs_byte_equal_to_reference(tier, eq):
    fn = S.band_gain([3000.0], [1.0, 0.4], 48000, 1024) if eq else None
    jfn = JS.band_gain([3000.0], [1.0, 0.4], 48000, 1024) if eq else None
    plan = _plan(fn)
    assert plan.rb == j_resolve(JCFG, jfn)
    c = wire._i16_kernel_consts(plan, tier)
    jc = jw._i16_kernel_consts(JCFG, plan.rb, tier)
    names = ["k_i8"] if tier == "int8x1" else ["k_hi", "k_lo"]
    for name in names + ["kern"]:
        a, b = np.asarray(c[name]), np.asarray(jc[name])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert c["k_scale"] == jc["k_scale"]


def _exact_products(limbs, k):
    """256*(hi . k) + lo . k in int64 from a split's limbs."""
    hi, lo = (np.asarray(v).astype(np.int64) for v in limbs)
    k = k.astype(np.int64)
    return 256 * (hi @ k) + lo @ k


@pytest.mark.parametrize("tier", ["int8x2", "int8x1"])
def test_limb_parity_below_32640(tier):
    """Both splits give the exact product for codes < 32640; the port's
    chunk output is within 1e-6 (f32) and one code (int16) of the
    reference's."""
    rng = np.random.default_rng(2)
    x = rng.integers(-32768, 32640, (64, 2048)).astype(np.int16)
    c = wire._i16_kernel_consts(_plan(), "int8x1")
    port = wire.i16_limbs(torch.from_numpy(x))
    ref = jw.i16_limbs(np.asarray(x))
    exact = x.astype(np.int64) @ c["k_i8"].astype(np.int64)
    np.testing.assert_array_equal(_exact_products(port, c["k_i8"]), exact)
    np.testing.assert_array_equal(_exact_products(ref, c["k_i8"]), exact)
    # The interior products: the port's B6 product per limb against the
    # reference's m-ordered shifted dots, recombined exactly.
    kt = torch.from_numpy(np.ascontiguousarray(c["k_i8"].T))
    xl = x.reshape(-1)[: 16 * 512 + 1536]
    hp, lp = wire.i16_limbs(torch.from_numpy(xl))
    port_acc = sum(
        w * wire._hopblock_apply_i8(v, kt, 512, 16 * 512).numpy().astype(
            np.int64) for w, v in ((256, hp), (1, lp)))
    ref_acc = sum(
        w * np.asarray(jw._hopblock_apply_i8(v, c["k_i8"], 512, 16 * 512,
                                             4)).astype(np.int64)
        for w, v in zip((256, 1), jw.i16_limbs(np.asarray(xl))))
    np.testing.assert_array_equal(port_acc, ref_acc)
    _, x_i16 = _wire_signal(40960, seed=4)
    y = i16_round_trip(x_i16, CFG, tier=tier, emit_i16=False, device=CPU)
    y_ref = np.asarray(jw.i16_round_trip(x_i16, JCFG, tier=tier,
                                         emit_i16=False))
    assert np.max(np.abs(y - y_ref)) <= 1e-6
    y16 = i16_round_trip(x_i16, CFG, tier=tier, device=CPU)
    y16_ref = np.asarray(jw.i16_round_trip(x_i16, JCFG, tier=tier))
    assert np.max(np.abs(y16.astype(np.int32) - y16_ref.astype(np.int32))) <= 1


def _full_range_signal():
    t = np.arange(16384)
    square = np.where((t // 300) % 2 == 0, 32767, -32768)
    codes = np.array([-32768, 32639, 32640, 32767, 32700, 32766],
                     np.int64)
    square[4000:4000 + 6 * 64] = np.repeat(codes, 64)
    return square.astype(np.int16)


def test_full_range_codes_are_exact():
    """Every int16 code splits exactly; the reference's split wraps
    32640..32767 (its hi becomes -128)."""
    codes = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    hi, lo = wire.i16_limbs(torch.from_numpy(codes))
    assert hi.dtype == torch.int8 and lo.dtype == torch.uint8
    back = 256 * hi.numpy().astype(np.int64) + lo.numpy().astype(np.int64)
    np.testing.assert_array_equal(back, codes.astype(np.int64))
    jhi, jlo = (np.asarray(v).astype(np.int64) for v in jw.i16_limbs(codes))
    wrong = np.nonzero(256 * jhi + jlo != codes.astype(np.int64))[0]
    assert codes[wrong].min() == 32640 and codes[wrong].max() == 32767
    assert len(wrong) == 128


@pytest.mark.parametrize("tier", ["int8x2", "int8x1"])
def test_full_range_interior_matches_float64_oracle(tier):
    """A full-scale square wave with the codes -32768, 32639, 32640 and
    32767, one chunk: the interior equals a float64 oracle of the exact
    integer product (x_ext windows . quantized kernel) * k_scale / 32768
    within 2e-6 (the f32 combination's rounding); the reference misses it
    by far at the wrapped codes."""
    x = _full_range_signal()
    c = wire._i16_kernel_consts(_plan(), tier)
    kq = (c["k_i8"].astype(np.float64) if tier == "int8x1"
          else c["k_hi"].astype(np.float64) * 128 + c["k_lo"])
    s = x.shape[-1]
    x_ext = np.concatenate([np.zeros(EDGE), x.astype(np.float64),
                            np.zeros(EDGE)])
    rows = np.stack([x_ext[r * 512 : r * 512 + 2048] for r in range(s // 512)])
    oracle = (rows @ kq).reshape(-1) * (c["k_scale"] / 32768.0)
    y = i16_round_trip(x, CFG, tier=tier, emit_i16=False, chunk_samples=s,
                       device=CPU)
    inner = slice(EDGE, s - EDGE)
    err = np.max(np.abs(y[inner] - oracle[inner]))
    assert err <= 2e-6, err
    y_ref = np.asarray(jw.i16_round_trip(x, JCFG, tier=tier, emit_i16=False,
                                         chunk_samples=s))
    assert np.max(np.abs(y_ref[inner] - oracle[inner])) > 1e-2
    # The identity reconstructs the full-scale wave (interior) to > 90 dB.
    assert _snr_db(x[inner] / 32768.0, y[inner]) >= 90.0


def test_limb_gemm_wire_epilogue_matches_the_reference_expression():
    """B6-limb's "wire2" epilogue equals the reference's f32 combination
    written out on the same int32 accumulators."""
    rng = np.random.default_rng(8)
    x = rng.integers(-32768, 32768, (1, 3 * 512 + 1536)).astype(np.int16)
    c = wire._i16_kernel_consts(_plan(), "int8x2")
    hi, lo = wire.i16_limbs(torch.from_numpy(x))
    kh, kl = wire._i16_limbs_on(_plan(), "int8x2", torch.device("cpu"))
    scale = float(np.float32(c["k_scale"] / 32768.0))
    got = b6.limb_gemm(hi, lo, kh, kl, "wire2", scale, rows=3, lda=512)
    dots = [b6.int_dot(b6.windows(a, 3, 512, 2048), k)
            for a, k in ((hi, kh), (lo, kh), (hi, kl), (lo, kl))]
    f = [d.numpy().astype(np.float32) for d in dots]
    want = ((f[0] * np.float32(32768) + f[1] * np.float32(128)
             + f[2] * np.float32(256) + f[3]) * np.float32(scale))
    np.testing.assert_array_equal(got.numpy(), want)
