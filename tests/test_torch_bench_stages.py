"""The port's stage microbenchmarks (`crlot_tpu_torch/bench/stages.py`).

`frame_take`, `frame_slices` and `ola_dus` against the JAX package's on
numpy inputs made from a seed: the framings are gathers and slices, so
bit-exact; `ola_dus` adds the frames' hops in the reference's order
(the last hop first), so bit-exact too (held within 1e-6 where a tail is
cropped, measured 0). `main` and `main_pipeline` run on the CPU at 1 s:
every stage timed, the main path's route named ("blocked"), the framed and
blocked stage sums beside `round_trip`; `stream_block_probe` carries its
tail as the reference's does (the same tail after one block within 1e-6).
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crlot_tpu.bench import stages as jst

from crlot_tpu_torch.bench import stages

GEOMS = [(1024, 256, 40), (1024, 512, 17), (512, 128, 33), (256, 64, 9),
         (4096, 1024, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: it leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(n, hop, f, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (f - 1) * hop + n + 37).astype(np.float32)


@pytest.mark.parametrize("n,hop,f", GEOMS)
def test_frame_take_equals_the_reference(n, hop, f):
    x = _signal(n, hop, f, 1)
    got = stages.frame_take(torch.from_numpy(x), n, hop, f).numpy()
    want = np.asarray(jst.frame_take(jnp.asarray(x), n, hop, f))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,hop,f", GEOMS)
def test_frame_slices_equals_the_reference(n, hop, f):
    x = _signal(n, hop, f, 2)
    got = stages.frame_slices(torch.from_numpy(x), n, hop, f).numpy()
    want = np.asarray(jst.frame_slices(jnp.asarray(x), n, hop, f))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, stages.frame_take(torch.from_numpy(x), n, hop, f).numpy())


@pytest.mark.parametrize("n,hop,f", GEOMS)
@pytest.mark.parametrize("crop", [0, 100])
def test_ola_dus_equals_the_reference(n, hop, f, crop):
    rng = np.random.default_rng(3)
    frames = rng.uniform(-1, 1, (f, n)).astype(np.float32)
    out_len = (f - 1) * hop + n - crop
    got = stages.ola_dus(torch.from_numpy(frames), hop, out_len).numpy()
    want = np.asarray(jst.ola_dus(jnp.asarray(frames), hop, out_len))
    assert got.shape == want.shape == (out_len,)
    assert float(np.max(np.abs(got - want))) <= 1e-6
    np.testing.assert_array_equal(got, want)


def test_main_times_every_stage_on_the_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = stages.main(seconds=1, device="cpu")
    assert json.loads(buf.getvalue().strip()) == res
    assert res["backend"] == "cpu" and res["frames"] == (48000 - 768) // 256
    for k in ("frame_take", "frame_slices", "window_mul", "rfft", "irfft",
              "ola_dus", "normalize"):
        assert res[f"{k}_ms"] > 0, k


def test_main_pipeline_sums_beside_the_round_trip():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = stages.main_pipeline(seconds=1, device="cpu")
    lines = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    assert len(lines) == 10
    assert res["route"] == "blocked"
    assert res["framed_stage_sum_ms"] == pytest.approx(
        res["frame_signal_ms"] + res["rt_folded_ms"] + res["ola_fused_ms"])
    assert res["blocked_stage_sum_ms"] == pytest.approx(
        res["blocked_pad_ms"] + res["blocked_b0_ms"]
        + res["blocked_edges_ms"])
    assert res["round_trip_ms"] > 0
    only = stages.main_pipeline(seconds=1, device="cpu",
                                only="blocked_b0,round_trip")
    assert set(only) == {"blocked_b0_ms", "round_trip_ms", "route"}


def test_stream_block_probe_carries_the_tail_as_the_reference():
    from crlot_tpu.core.types import StftConfig as JCfg

    from crlot_tpu_torch.core.types import StftConfig

    one, tail = stages.stream_block_probe(
        StftConfig(frame_size=1024, hop_size=256, center=False), "cpu")
    jone, jtail = jst.stream_block_probe(
        JCfg(frame_size=1024, hop_size=256, center=False))
    got = one(one(tail))
    want = np.asarray(jone(jone(jtail)))
    assert got.shape == want.shape == (768,)
    assert float(np.max(np.abs(got.numpy() - want))) <= 1e-6
