"""Benchmark suite: twelve sections, one JSON line each, then the whole.

Counterpart of `crlot_tpu/bench/suite.py` with the reference's sections,
sizes and metric names wherever the port measures the same thing: `fft`,
`kernels`, `ola`, `e2e`, `spectral`, `multichannel`, `sweep`, `resample`,
`convolve`, `features`, `iir` and `streaming`. Device times are one
CUDA-event median a call on the card (`stages._time`) and the host clock
around a synchronous call on the CPU; "sustained" rates are the host
clock around a synchronized loop, as in the reference. The reference's
`fft_roundtrip_xla_*` names keep their meaning: the library FFT
(`torch.fft` here). The `_pallas` kernel rows time the CUDA kernel, the
`_jnp` rows its plain version, both on the card (on the CPU only the plain
version exists, so the `_pallas` rows are left out, as the reference
leaves them out off the TPU).

The reference's assertions stay assertions (the streamed blocked chunks
bit-exact against the one-shot, the resident ring against the dispatch
loop, the checkpoint resume), and `check(results)` fails on a NaN, a
bit-exact flag of 0 or an SNR under its gate (`SNR_GATES`). Not copied,
because they exist for the reference's tunnel: the NaN retry loop across
rate regimes (a CUDA-event median does not land in another regime: the
port reports a number or fails, so `_nan_annotations` is never written
and `_nan_retry_attempts` is 0), and `JAX_COMPILATION_CACHE_DIR`.

The reference's one-program streaming variants (a `lax.scan` over chunks,
the resident ring, the tiled scan) are each one CUDA-graph replay of the
chunk loop here: the loop is captured once after a warm run, and replayed.
Where a capture fails, that variant's keys are left out and the reason is
written under `_not_captured`; they are never filled with the dispatch
loop's numbers.

`_launches` holds, for each section, the launches of each kernel during
it (`launches.launch_counts`) outside the timed repeats and the graph
captures: those run inside `launches.uncounted()` (`_time` and
`device_ms` too), so each counted launch is one whose output the section
uses or checks. On the card the section `kernels` holds K5 and K6
against their plain versions (torch.equal) and `resample` each B4 step
(max-abs 1e-5), untimed.

    python -m crlot_tpu_torch.bench.suite [--out results.json]
        [--suites fft,ola,...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from .launches import launch_counts, uncounted
from .probes import device_ms
from .stages import _time, backend_name

SECTIONS = ("fft", "kernels", "ola", "e2e", "spectral", "multichannel",
            "sweep", "resample", "convolve", "features", "iir", "streaming")

# The lowest SNR each quality metric may read, with its source: the
# identity / fixed-response round-trip's 60 dB floor (tests/test_pipeline.py,
# the reference's bench gate), the wire tier against the f32 streamer
# (chip_smoke.py phase 21's gate).
SNR_GATES = {"stream_i16_int8x2_vs_f32_snr_db": 85.0}
SNR_FLOOR_DB = 60.0


def _on(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_fft(results: Dict[str, float], dev) -> None:
    from ..fft import dispatch as _fft

    rng = np.random.default_rng(0)
    for nfft in (512, 1024, 2048):
        for batch in (1, 4, 64):
            x = _on(rng.uniform(-1, 1, (batch, nfft)).astype(np.float32), dev)

            def fwd_inv(v):  # backend-dispatched (folded products on a card)
                return _fft.irfft(_fft.rfft(v, nfft), nfft)

            def fwd_inv_lib(v):  # the library FFT
                return torch.fft.irfft(torch.fft.rfft(v, dim=-1), n=nfft,
                                       dim=-1)

            us = _time(fwd_inv, x) * 1e6
            results[f"fft_roundtrip_n{nfft}_b{batch}_us"] = round(us, 2)
            us = _time(fwd_inv_lib, x) * 1e6
            results[f"fft_roundtrip_xla_n{nfft}_b{batch}_us"] = round(us, 2)


def bench_kernels(results: Dict[str, float], dev) -> None:
    """B5's size sweep n = 16 .. 32768 (+1M) (the reference's
    bench/kernels_benchmark.cc:259-281 sweep): the auto-dispatched call at
    the legacy sizes, the CUDA kernel (`_pallas`, use_pallas=True) and its
    plain version (`_jnp`) at every size."""
    from ..ola import kernels as K

    cuda = dev.type == "cuda"
    rng = np.random.default_rng(1)
    for n in (16, 64, 256, 1024, 4096, 16384, 32768, 1 << 20):
        dst = _on(rng.uniform(-1, 1, n).astype(np.float32), dev)
        src = _on(rng.uniform(-1, 1, n).astype(np.float32), dev)
        win = _on(rng.uniform(0, 1, n).astype(np.float32), dev)
        if cuda:  # the kernels against their plain versions, untimed
            assert torch.equal(
                K.axpy_windowed(dst, src, win, 1.5, use_pallas=True),
                K.axpy_windowed_reference(dst, src, win, 1.5)), f"K5 n={n}"
            got, cleared = K.normalize_and_clear(dst, win, use_pallas=True)
            assert torch.equal(got, K.normalize_and_clear_reference(
                dst, win, 1e-8)[0]) and not cleared.any(), f"K6 n={n}"
        rows = {
            "": (lambda d: K.axpy_windowed(d, src, win, 1.5),
                 lambda d: K.normalize_and_clear(d, win)[0]),
            "_pallas": (
                lambda d: K.axpy_windowed(d, src, win, 1.5, use_pallas=True),
                lambda d: K.normalize_and_clear(d, win, use_pallas=True)[0]),
            "_jnp": (
                lambda d: K.axpy_windowed_reference(d, src, win, 1.5),
                lambda d: K.normalize_and_clear_reference(d, win, 1e-8)[0]),
        }
        for label, (axpy_w, norm) in rows.items():
            if label == "" and n not in (1024, 32768, 1 << 20):
                continue  # auto-dispatch rows only at the legacy sizes
            if label == "_pallas" and not cuda:
                continue  # the kernel exists only on the card
            ns = _time(axpy_w, dst) * 1e9 / n
            results[f"kernel_axpy_windowed{label}_n{n}_ns_per_elem"] = round(
                ns, 4)
            ns = _time(norm, dst) * 1e9 / n
            results[f"kernel_normalize{label}_n{n}_ns_per_elem"] = round(ns, 4)


def bench_ola(results: Dict[str, float], dev) -> None:
    from ..ola.reference import overlap_add

    rng = np.random.default_rng(2)
    for n in (1024, 4096):
        for ratio in (2, 4):
            hop = n // ratio
            f = 48000 * 4 // hop
            frames = _on(rng.uniform(-1, 1, (f, n)).astype(np.float32), dev)
            us = _time(lambda fr: overlap_add(fr, hop), frames) * 1e6
            results[f"ola_n{n}_h{hop}_f{f}_us"] = round(us, 2)


def _rt_time_capped(fn, x: torch.Tensor, frame_size: int, hop: int) -> float:
    """_time of a round-trip, held under 1.35x the fastest bound any
    formulation could reach on the card (`profiling.
    roofline_samples_per_sec`, framed and blocked): a reading above it is
    a measurement fault and raises. On the CPU there is no device peak to
    hold it to."""
    sec = _time(fn, x)
    if x.device.type == "cuda":
        from ..profiling import roofline_samples_per_sec

        cap = 1.35 * max(
            roofline_samples_per_sec(frame_size, hop, formulation=form)[b]
            for form in ("framed", "blocked")
            for b in ("bandwidth_bound_samples_per_sec",
                      "compute_bound_samples_per_sec"))
        if not (sec > 0) or x.numel() / sec > cap:
            raise RuntimeError(f"{x.numel() / sec:.4g} samples/s is above "
                               f"1.35x the roofline ({cap:.4g})")
    return sec


def bench_e2e(results: Dict[str, float], dev) -> None:
    from ..core.types import StftConfig
    from ..metrics import snr_db
    from ..pipeline import round_trip

    sr = 48000
    seconds = 16  # measured over 16 s, reported per 1 s (as the reference)
    for hop in (256, 512):
        cfg = StftConfig(frame_size=1024, hop_size=hop, center=True)
        rng = np.random.default_rng(3)
        x_np = rng.uniform(-0.9, 0.9, seconds * sr).astype(np.float32)
        x = _on(x_np, dev)
        snr = snr_db(x_np, round_trip(x, cfg).cpu().numpy())
        sec = _rt_time_capped(lambda s: round_trip(s, cfg), x, 1024,
                              hop) / seconds
        results[f"e2e_1s48k_n1024_h{hop}_ms"] = round(sec * 1e3, 3)
        results[f"e2e_1s48k_n1024_h{hop}_rtf"] = round(1.0 / sec, 1)
        results[f"e2e_1s48k_n1024_h{hop}_snr_db"] = round(snr, 1)


def bench_spectral(results: Dict[str, float], dev) -> None:
    """Round-trip with a fixed EQ (blocked, B0 on the card), a nonlinear
    noise gate (B2 on the card) and the sharded blocked EQ across the
    mesh of every visible device (one on one card)."""
    from ..core.types import FftBackend, StftConfig
    from ..distributed.mesh import auto_mesh
    from ..distributed.sharded_pipeline import sharded_round_trip
    from ..pipeline import round_trip
    from ..spectral import band_gain, noise_gate

    sr = 48000
    seconds = 16
    cfg = StftConfig(frame_size=1024, hop_size=256, center=True)
    eq = band_gain([2000.0, 8000.0], [1.0, 0.5, 0.1], sr, 1024)
    rng = np.random.default_rng(7)
    x_np = rng.uniform(-0.9, 0.9, seconds * sr).astype(np.float32)
    x = _on(x_np, dev)
    assert bool(torch.isfinite(round_trip(x, cfg, eq)).all())
    sec = _rt_time_capped(lambda s: round_trip(s, cfg, eq), x, 1024,
                          256) / seconds
    results["eq_composed_1s48k_ms"] = round(sec * 1e3, 3)
    results["eq_composed_msamples_per_s"] = round(sr / sec / 1e6, 1)

    gate = noise_gate(-40.0, attenuation_db=-30.0)
    assert bool(torch.isfinite(round_trip(x, cfg, gate)).all())
    sec = _rt_time_capped(lambda s: round_trip(s, cfg, gate), x, 1024,
                          256) / seconds
    results["mask_gate_1s48k_ms"] = round(sec * 1e3, 3)
    results["mask_gate_msamples_per_s"] = round(sr / sec / 1e6, 1)

    scfg = StftConfig(frame_size=1024, hop_size=256, center=False,
                      fft_backend=FftBackend.MATMUL)
    mesh = auto_mesh(channels=1,
                     devices=None if dev.type == "cuda" else [dev])
    unit = mesh.shape["time"] * 512  # group * hop a device
    total = (seconds * sr // unit) * unit
    xs = x[:total].reshape(1, total)
    assert bool(torch.isfinite(sharded_round_trip(xs, scfg, mesh, eq)).all())
    sec = _rt_time_capped(lambda s: sharded_round_trip(s, scfg, mesh, eq),
                          xs, 1024, 256) / (total / sr)
    results["eq_sharded_blocked_1s48k_ms"] = round(sec * 1e3, 3)
    results["eq_sharded_blocked_msamples_per_s"] = round(sr / sec / 1e6, 1)


def bench_multichannel(results: Dict[str, float], dev) -> None:
    """BASELINE config 4: a 64-channel batch, the round-trip and a FIR."""
    from ..core.types import StftConfig
    from ..pipeline import round_trip
    from ..spectral import fir_frequency_response, per_bin_filter

    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)
    rng = np.random.default_rng(4)
    x = _on(rng.uniform(-0.9, 0.9, (64, 48000)).astype(np.float32), dev)
    total = 64 * 48000
    sec = _rt_time_capped(lambda s: round_trip(s, cfg), x, 1024, 256)
    results["mc64_1s48k_ms"] = round(sec * 1e3, 3)
    results["mc64_msamples_per_s"] = round(total / sec / 1e6, 1)
    taps = np.hamming(127)
    fir = per_bin_filter(fir_frequency_response(taps / taps.sum(), 1024))
    sec = _rt_time_capped(lambda s: round_trip(s, cfg, fir), x, 1024, 256)
    results["mc64_fir_1s48k_ms"] = round(sec * 1e3, 3)
    results["mc64_fir_msamples_per_s"] = round(total / sec / 1e6, 1)


def bench_sweep(results: Dict[str, float], dev) -> None:
    """BASELINE config 2: FFT 256 .. 16384 at hop ratios 1/2 and 1/4,
    samples/s and SNR, each cell beside the main path's round-trip (N=1024,
    H=256) measured right after it (`_sentinel_*`, `_vs_sentinel`), and
    one Hamming point."""
    from ..core.types import StftConfig, WindowType
    from ..metrics import snr_db
    from ..pipeline import round_trip

    sr = 48000
    rng = np.random.default_rng(5)
    sent_cfg = StftConfig(frame_size=1024, hop_size=256, center=True)
    x_sent = _on(rng.uniform(-0.9, 0.9, 4 * sr).astype(np.float32), dev)

    def sentinel_gsps():
        sec = _rt_time_capped(lambda s: round_trip(s, sent_cfg), x_sent,
                              1024, 256)
        return x_sent.numel() / sec / 1e9

    for n in (256, 1024, 4096, 16384):
        seconds = 4 if n <= 1024 else 16
        x_np = rng.uniform(-0.9, 0.9, seconds * sr).astype(np.float32)
        x = _on(x_np, dev)
        for ratio in (2, 4):
            cfg = StftConfig(frame_size=n, hop_size=n // ratio, center=True)
            snr = snr_db(x_np, round_trip(x, cfg).cpu().numpy())
            sec = _rt_time_capped(lambda s, c=cfg: round_trip(s, c), x, n,
                                  n // ratio)
            sent = sentinel_gsps()
            key = f"sweep_n{n}_r{ratio}"
            cell = x.numel() / sec / 1e9
            results[f"{key}_gsamples_per_s"] = round(cell, 3)
            results[f"{key}_snr_db"] = round(snr, 1)
            results[f"{key}_sentinel_gsamples_per_s"] = round(sent, 3)
            results[f"{key}_vs_sentinel"] = round(cell / sent, 4)
    x_np = rng.uniform(-0.9, 0.9, 4 * sr).astype(np.float32)
    x = _on(x_np, dev)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=True,
                     window=WindowType.HAMMING)
    results["sweep_n1024_r4_hamming_snr_db"] = round(
        snr_db(x_np, round_trip(x, cfg).cpu().numpy()), 1)
    sec = _time(lambda s: round_trip(s, cfg), x)
    results["sweep_n1024_r4_hamming_gsamples_per_s"] = round(
        x.numel() / sec / 1e9, 3)


def bench_convolve(results: Dict[str, float], dev) -> None:
    """Direct FIR convolution (the Toeplitz product, B0 on the card),
    255 taps."""
    from ..convolve import convolve

    rng = np.random.default_rng(8)
    x = _on(rng.uniform(-0.9, 0.9, 48000 * 4).astype(np.float32), dev)
    taps = (np.hamming(255) / 127.0).astype(np.float32)
    assert bool(torch.isfinite(convolve(x, taps, mode="same")).all())
    sec = _time(lambda s: convolve(s, taps, mode="same"), x)
    results["convolve_255tap_4s_ms"] = round(sec * 1e3, 3)
    results["convolve_255tap_msamples_per_s"] = round(x.numel() / sec / 1e6,
                                                      1)


def bench_features(results: Dict[str, float], dev) -> None:
    """Mel spectrogram, MFCC, HPSS and PCEN of the mel on 4 s."""
    from ..core.types import StftConfig
    from ..features import mel_spectrogram, mfcc, pcen
    from ..hpss import hpss

    rng = np.random.default_rng(9)
    sr = 48000
    x = _on(rng.uniform(-0.9, 0.9, sr * 4).astype(np.float32), dev)
    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)

    def mel_fn(v):
        return mel_spectrogram(v, cfg, float(sr), n_mels=64)

    def mfcc_fn(v):
        return mfcc(v, cfg, float(sr), n_mfcc=13, n_mels=64)

    def hpss_fn(v):
        h, p = hpss(v, cfg, kernel_harm=17, kernel_perc=17)
        return h + p

    def pcen_fn(v):
        return pcen(mel_spectrogram(v, cfg, float(sr), n_mels=64),
                    float(sr) / cfg.hop_size)

    for key, fn in (("mel64", mel_fn), ("mfcc13", mfcc_fn),
                    ("hpss17", hpss_fn), ("pcen_mel64", pcen_fn)):
        assert bool(torch.isfinite(fn(x)).all()), key
        sec = _time(fn, x)
        results[f"{key}_4s_ms"] = round(sec * 1e3, 3)
        results[f"{key}_msamples_per_s"] = round(x.numel() / sec / 1e6, 1)


def bench_iir(results: Dict[str, float], dev) -> None:
    """The log-depth scan IIR: a butter(4) lowpass cascade on 4 s."""
    from ..iir import butter_sos, sosfilt

    rng = np.random.default_rng(10)
    x = _on(rng.uniform(-0.9, 0.9, 48000 * 4).astype(np.float32), dev)
    sos = butter_sos(4, 0.1, "lowpass")
    assert bool(torch.isfinite(sosfilt(sos, x)).all())
    sec = _time(lambda v: sosfilt(sos, v), x)
    results["iir_butter4_4s_ms"] = round(sec * 1e3, 3)
    results["iir_butter4_msamples_per_s"] = round(x.numel() / sec / 1e6, 1)


def bench_resample(results: Dict[str, float], dev) -> None:
    """BASELINE config 3: the polyphase chain 44.1k -> 48k -> 16k (B4 on
    the card), and `resampled_stft` beside the same two steps as two
    calls."""
    from ..core.types import StftConfig
    from ..pipeline import resampled_stft, stft
    from ..resample.kernel import resample_bank_plain
    from ..resample.polyphase import _rate, resample

    rng = np.random.default_rng(6)
    x = _on(rng.uniform(-0.9, 0.9, 44100 * 4).astype(np.float32), dev)

    def chain(v):
        return resample(resample(v, 44100, 48000), 48000, 16000)

    y = chain(x)
    if dev.type == "cuda":  # each B4 step against its plain version
        v = x
        for sr_in, sr_out in ((44100, 48000), (48000, 16000)):
            l, m = _rate(sr_in, sr_out)
            got = resample(v, sr_in, sr_out)
            want = resample_bank_plain(v, l, m, got.shape[-1])
            err = float((got - want).abs().max())
            assert err <= 1e-5, f"B4 {sr_in} -> {sr_out}: max-abs {err:.3g}"
            v = got
    sec = _time(chain, x)
    results["resample_chain_4s_ms"] = round(sec * 1e3, 3)
    results["resample_chain_msamples_per_s"] = round(x.numel() / sec / 1e6,
                                                     1)
    results["resample_chain_out_len"] = int(y.shape[-1])

    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)

    def fused(v):
        return resampled_stft(v, 44100, 48000, cfg).abs()

    def unfused(v):
        return stft(resample(v, 44100, 48000), cfg).abs()

    sec = _time(fused, x)
    results["resample_stft_fused_4s_ms"] = round(sec * 1e3, 3)
    results["resample_stft_fused_msamples_per_s"] = round(
        x.numel() / sec / 1e6, 1)
    unfused(x)
    _sync(dev)
    with uncounted():
        t0 = time.perf_counter()
        for _ in range(8):
            unfused(x)
            _sync(dev)
        results["resample_stft_unfused_wall_ms"] = round(
            (time.perf_counter() - t0) / 8 * 1e3, 3)


def _graph(fn):
    """fn captured in a CUDA graph after one warm run on a side stream:
    (graph, static output). Replaying the graph reruns fn's launches. The
    warm run repeats launches the section has made, and the capture's do
    not run: neither is counted."""
    with uncounted():
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            fn()
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = fn()
    return g, out


# The launch variants of the device-resident blocked stream, by name.
_VARIANT_CELLS = {
    "per-chunk dispatch loop":
        "stream_sustained_device_resident_dispatch_gsamples_per_s",
    "bigchunk dispatch loop":
        "stream_sustained_device_resident_bigchunk_gsamples_per_s",
    "scan-over-chunks one-program (CUDA graph)":
        "stream_sustained_device_resident_scan_gsamples_per_s",
    "scan-over-chunks one-program (CUDA-event device time)":
        "stream_sustained_device_resident_scan_chained_gsamples_per_s",
    "resident-ring unrolled one-program (CUDA graph)":
        "stream_sustained_device_resident_ring_gsamples_per_s",
    "resident-ring unrolled (CUDA-event device time)":
        "stream_sustained_device_resident_ring_chained_gsamples_per_s",
}


def bench_streaming(results: Dict[str, float], dev) -> None:
    """BASELINE config 5's one-device analog: the reference bench's stream
    (mono 48 kHz, 13 chunks of 2 097 152 samples of uniform noise in
    +-0.9 from seed 9 at the default CRLOT_BENCH_STREAM_MIN=10 minutes),
    N=1024, H=256, center=False.

    The tiled scan stream (B3) fed from the host, f32 and int16 on the
    wire (double-buffered egress), the egress and link probes, the
    device-resident tiled loop, the blocked `BlockedChunkStreamer` (B0)
    and its 4x chunks, the blocked stream against its one-shot (asserted
    bit-exact), both wire tiers (`I16BlockedStreamer`, B6), the
    one-program variants as CUDA-graph replays (the middle chunk asserted
    bit-exact against the dispatch loop's), the best launch variant, a
    mid-stream checkpoint resumed (asserted bit-exact), the tail chunk's
    SNR, and one hop block's latency."""
    from ..core.types import FftBackend, StftConfig
    from ..fft.matmul_backend import (
        blocked_plan_for,
        blocked_response,
        hopblock_apply,
    )
    from ..frame.framing import hop_block_frames
    from ..metrics import snr_db
    from ..pipeline import blocked_composed_round_trip
    from ..streaming_pipeline import (
        BlockedChunkStreamer,
        blocked_stream_supported,
        streaming_round_trip_blocks,
    )
    from ..wire import I16BlockedStreamer
    from .stages import stream_block_probe

    cuda = dev.type == "cuda"
    sr = 48000
    minutes = float(os.environ.get("CRLOT_BENCH_STREAM_MIN", "10"))
    cfg = StftConfig(frame_size=1024, hop_size=256, center=False)
    n, hop = cfg.frame_size, cfg.hop_size
    block_frames, blocks_per_chunk = 64, 128
    chunk_frames = block_frames * blocks_per_chunk
    chunk_samples = chunk_frames * hop  # 2 097 152
    n_chunks = max(int(minutes * 60 * sr) // chunk_samples, 2)
    rng = np.random.default_rng(9)
    x = rng.uniform(-0.9, 0.9, n_chunks * chunk_samples + (n - hop)).astype(
        np.float32)
    span = chunk_samples + (n - hop)
    zero_tail = torch.zeros(n - hop, dtype=torch.float32, device=dev)
    total = n_chunks * chunk_samples
    not_captured = {}

    def chunk_program(x_chunk, tail):
        frames = hop_block_frames(x_chunk, n, hop, chunk_frames)
        frames = frames.reshape(blocks_per_chunk, block_frames, n)
        return streaming_round_trip_blocks(
            frames, cfg, block_frames, None, carry_tail=tail,
            return_carry=True)

    def run_chunk(k, tail):
        seg = _on(x[k * chunk_samples : k * chunk_samples + span], dev)
        return chunk_program(seg, zero_tail if tail is None else tail)

    run_chunk(0, None)  # warm
    _sync(dev)
    half = n_chunks // 2
    with uncounted():
        t0 = time.perf_counter()
        tail = None
        mid_tail = None
        for k in range(n_chunks):
            out, tail = run_chunk(k, tail)
            if k == half - 1:
                mid_tail = tail.cpu().numpy()  # for the restore check
        _sync(dev)
        wall = time.perf_counter() - t0
    results["stream_minutes_audio"] = round(total / sr / 60, 1)
    results["stream_sustained_gsamples_per_s"] = round(total / wall / 1e9, 4)
    results["stream_wall_s"] = round(wall, 2)

    # The int16 wire, double-buffered: chunk k is dispatched before chunk
    # k-1's output is read back.
    x_i16 = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)

    def chunk_program_i16(seg_i16, tail):
        xf = seg_i16.float() * (1.0 / 32768.0)
        y, tail2 = chunk_program(xf, tail)
        y_i16 = torch.clamp(torch.round(y * 32768.0), -32768.0,
                            32767.0).to(torch.int16)
        return y_i16, tail2

    def run_chunk_i16(k, tail):
        seg = _on(x_i16[k * chunk_samples : k * chunk_samples + span], dev)
        return chunk_program_i16(seg, tail)

    run_chunk_i16(0, zero_tail)  # warm
    _sync(dev)
    with uncounted():
        t0 = time.perf_counter()
        tail16 = zero_tail
        pending = None
        for k in range(n_chunks):
            out_i16, tail16 = run_chunk_i16(k, tail16)
            if pending is not None:
                pending.cpu()
            pending = out_i16
        y_last_i16 = pending.cpu().numpy()
        wall16 = time.perf_counter() - t0
    results["stream_sustained_i16_gsamples_per_s"] = round(
        total / wall16 / 1e9, 4)
    results["stream_i16_wall_s"] = round(wall16, 2)
    delta = np.max(np.abs(y_last_i16.astype(np.float32) / 32768.0
                          - out.cpu().numpy()))
    results["stream_i16_vs_f32_max_delta_lsb"] = round(float(delta * 32768.0),
                                                       2)

    # Egress anatomy: one chunk's readback, 8 chunks in one readback, and
    # the int16 loop with its egress batched every 8 chunks.
    ready = pending
    _sync(dev)
    t0 = time.perf_counter()
    ready.cpu()
    dt1 = time.perf_counter() - t0
    nb = ready.numel() * ready.element_size()
    results["egress_readback_ms_per_chunk"] = round(dt1 * 1e3, 1)
    results["egress_readback_mb_per_s"] = round(nb / dt1 / 1e6, 1)
    stack8 = torch.stack([ready] * 8)
    _sync(dev)
    t0 = time.perf_counter()
    stack8.cpu()
    dt8 = time.perf_counter() - t0
    results["egress_batched8_mb_per_s"] = round(8 * nb / dt8 / 1e6, 1)
    results["egress_batched8_ms_per_chunk"] = round(dt8 / 8 * 1e3, 1)
    del stack8
    with uncounted():
        t0 = time.perf_counter()
        tail16 = zero_tail
        pend = []
        for k in range(n_chunks):
            o_k, tail16 = run_chunk_i16(k, tail16)
            pend.append(o_k)
            if len(pend) == 8:
                torch.stack(pend).cpu()  # one readback for 8 chunks
                pend = []
        if pend:
            torch.stack(pend).cpu()
        results["stream_sustained_i16_batched_egress_gsamples_per_s"] = round(
            total / (time.perf_counter() - t0) / 1e9, 4)

    # The raw link: one chunk of f32 to the device and back.
    probe = np.ascontiguousarray(x[:chunk_samples])
    _sync(dev)
    t0 = time.perf_counter()
    on_dev = torch.from_numpy(probe).to(dev)
    _sync(dev)
    up_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_dev.cpu()
    down_s = time.perf_counter() - t0
    results["link_host_to_device_mb_per_s"] = round(
        probe.nbytes / up_s / 1e6, 1)
    results["link_device_to_host_mb_per_s"] = round(
        probe.nbytes / down_s / 1e6, 1)

    # Device-resident tiled loop: inputs staged first.
    segs = [_on(x[k * chunk_samples : k * chunk_samples + span], dev)
            for k in range(n_chunks)]
    _sync(dev)
    with uncounted():
        t0 = time.perf_counter()
        tail_dev = zero_tail
        last_dev = None
        for k in range(n_chunks):
            last_dev, tail_dev = chunk_program(segs[k], tail_dev)
        _sync(dev)
        results["stream_sustained_device_resident_tiled_gsamples_per_s"] = (
            round(total / (time.perf_counter() - t0) / 1e9, 4))

    # The blocked stream (B0), device-resident: the metric of record.
    cfg_blk = StftConfig(frame_size=n, hop_size=hop, center=False,
                         fft_backend=FftBackend.MATMUL)
    assert blocked_stream_supported(cfg_blk, chunk_samples)
    chunks_dev = [_on(x[k * chunk_samples : (k + 1) * chunk_samples], dev)
                  for k in range(n_chunks)]
    _sync(dev)

    def run_blocked(chunks):
        st = BlockedChunkStreamer(cfg_blk, device=dev)
        outs = [o for o in (st.feed(c, force=False) for c in chunks)
                if o is not None]
        outs.append(st.finish(force=False))
        return outs

    run_blocked(chunks_dev)  # warm
    _sync(dev)
    with uncounted():
        t0 = time.perf_counter()
        outs_blk = run_blocked(chunks_dev)
        _sync(dev)
        results["stream_sustained_device_resident_gsamples_per_s"] = round(
            total / (time.perf_counter() - t0) / 1e9, 4)
    results["stream_device_resident_formulation"] = (
        "blocked hop-block Toeplitz (BlockedChunkStreamer)")

    big = 4 * chunk_samples
    k_big_c = total // big
    if k_big_c >= 2:
        chunks_big = [_on(x[k * big : (k + 1) * big], dev)
                      for k in range(k_big_c)]
        run_blocked(chunks_big)
        _sync(dev)
        with uncounted():
            t0 = time.perf_counter()
            run_blocked(chunks_big)
            _sync(dev)
            results[
                "stream_sustained_device_resident_bigchunk_gsamples_per_s"
            ] = round(k_big_c * big / (time.perf_counter() - t0) / 1e9, 4)
        del chunks_big

    # Streamed chunks vs the blocked one-shot over the same 3 chunks.
    k3 = min(3, n_chunks)
    x3 = x[: k3 * chunk_samples]
    st3 = BlockedChunkStreamer(cfg_blk, device=dev)
    outs3 = [st3.feed(x3[k * chunk_samples : (k + 1) * chunk_samples])
             for k in range(k3)]
    outs3.append(st3.finish())
    y3 = np.concatenate([o for o in outs3 if o is not None])
    y3_once = blocked_composed_round_trip(
        _on(x3, dev), cfg_blk, np.ones(n // 2 + 1)).cpu().numpy()
    results["stream_blocked_vs_oneshot_bitexact"] = int(
        np.array_equal(y3, y3_once))
    results["stream_blocked_vs_oneshot_max_abs_delta"] = float(
        np.max(np.abs(y3 - y3_once)))
    assert results["stream_blocked_vs_oneshot_bitexact"], (
        "blocked stream diverged from the blocked one-shot")

    # The born-int16 wire tiers, device-resident (B6's limb modes).
    chunks_i16 = [_on(x_i16[k * chunk_samples : (k + 1) * chunk_samples],
                      dev) for k in range(n_chunks)]
    _sync(dev)
    outs_by_tier = {}
    for tier in ("int8x2", "int8x1"):
        def run_i16(tier=tier):
            st = I16BlockedStreamer(cfg_blk, tier=tier, emit_i16=True,
                                    device=dev)
            outs = [o for o in (st.feed(c, force=False) for c in chunks_i16)
                    if o is not None]
            outs.append(st.finish(force=False))
            return outs

        run_i16()
        _sync(dev)
        with uncounted():
            t0 = time.perf_counter()
            outs_i = run_i16()
            _sync(dev)
            results[
                f"stream_sustained_device_resident_i16_{tier}_gsamples_per_s"
            ] = round(total / (time.perf_counter() - t0) / 1e9, 4)
        outs_by_tier[tier] = outs_i
    err_sum = ref_sum = 0.0
    for o_i, o_f in zip(outs_by_tier["int8x2"], outs_blk):
        e = o_i.float() * (1.0 / 32768.0) - o_f
        err_sum += float((e * e).sum())
        ref_sum += float((o_f * o_f).sum())
    results["stream_i16_int8x2_vs_f32_snr_db"] = round(
        10.0 * math.log10(max(ref_sum, 1e-300) / max(err_sum, 1e-300)), 1)
    del outs_by_tier, chunks_i16

    # The one-program variants: the chunk loop as one CUDA-graph replay.
    plan = blocked_plan_for(cfg_blk, blocked_response(cfg_blk, None))
    kern_b, bt_b = plan.operands(dev, cfg_blk.fft_precision)
    gh_b, edge_b, rctx_b = plan.gh, plan.edge, plan.right_ctx
    span_b = edge_b + chunk_samples + rctx_b
    x_pad = np.pad(x[:total], (edge_b, rctx_b))
    segs_blk = torch.stack([_on(x_pad[k * chunk_samples :
                                      k * chunk_samples + span_b], dev)
                            for k in range(n_chunks)])
    x_ext_res = _on(x_pad, dev)

    def blocked_chunk(seg):
        return hopblock_apply(seg, kern_b, gh_b, chunk_samples, 0,
                              cfg_blk.fft_precision, bt_b)

    def scan_blocked():
        return torch.stack([blocked_chunk(segs_blk[k])
                            for k in range(n_chunks)])

    def ring_unrolled():
        return torch.stack([blocked_chunk(
            x_ext_res[k * chunk_samples : k * chunk_samples + span_b])
            for k in range(n_chunks)])

    def tiled_scan():
        t = zero_tail
        ys = []
        for k in range(n_chunks):
            y, t = chunk_program(segs[k], t)
            ys.append(y)
        return torch.stack(ys), t

    def replayed(name, fn):
        """(wall s of one replay, CUDA-event s of one replay, output), or
        None with the reason under _not_captured."""
        if not cuda:
            not_captured[name] = "no CUDA graphs on the CPU"
            return None
        try:
            g, ys = _graph(fn)
        except RuntimeError as e:
            not_captured[name] = f"{type(e).__name__}: {e}"
            return None
        _sync(dev)
        t0 = time.perf_counter()
        g.replay()  # passes no wrapper: nothing to count
        _sync(dev)
        wall_g = time.perf_counter() - t0
        return wall_g, device_ms(g.replay, dev) / 1e3, ys

    mid_disp = outs_blk[1] if n_chunks >= 3 else None
    got = replayed("scan", scan_blocked)
    if got is not None:
        wall_s, dev_s, ys = got
        results["stream_sustained_device_resident_scan_gsamples_per_s"] = (
            round(total / wall_s / 1e9, 4))
        results["stream_sustained_device_resident_scan_chained_gsamples_per_s"
                ] = round(total / dev_s / 1e9, 4)
        if mid_disp is not None:
            results["stream_blocked_scan_vs_dispatch_bitexact"] = int(
                torch.equal(ys[1], mid_disp))
    got = replayed("ring", ring_unrolled)
    if got is not None:
        wall_s, dev_s, ys = got
        if mid_disp is not None:
            results["stream_blocked_ring_vs_dispatch_bitexact"] = int(
                torch.equal(ys[1], mid_disp))
            assert results["stream_blocked_ring_vs_dispatch_bitexact"], (
                "ring-unrolled diverged from the dispatch-loop streamer")
        results["stream_sustained_device_resident_ring_gsamples_per_s"] = (
            round(total / wall_s / 1e9, 4))
        results["stream_sustained_device_resident_ring_chained_gsamples_per_s"
                ] = round(total / dev_s / 1e9, 4)
    del segs_blk, x_ext_res

    results["stream_sustained_device_resident_dispatch_gsamples_per_s"] = (
        results["stream_sustained_device_resident_gsamples_per_s"])
    # The metric of record: the best measured launch variant, named.
    variants = {nm: results[k] for nm, k in _VARIANT_CELLS.items()
                if k in results}
    best = max(variants, key=variants.get)
    results["stream_sustained_device_resident_gsamples_per_s"] = variants[best]
    results["stream_device_resident_formulation"] = (
        "blocked hop-block Toeplitz (BlockedChunkStreamer); best launch "
        f"variant: {best}")

    # Mid-stream checkpoint: save / load the carried tail, continue one
    # chunk, bit-identical to the unbroken stream.
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "stream.npz")
        t0 = time.perf_counter()
        np.savez(ckpt, tail=mid_tail, next_chunk=half)
        results["stream_ckpt_save_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        t0 = time.perf_counter()
        with np.load(ckpt) as z:
            tail_r, k_r = _on(z["tail"], dev), int(z["next_chunk"])
        results["stream_ckpt_restore_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
    want, _ = run_chunk(half, _on(mid_tail, dev))
    got_r, _ = run_chunk(k_r, tail_r)
    results["stream_ckpt_resume_bitexact"] = int(torch.equal(got_r, want))
    assert results["stream_ckpt_resume_bitexact"], "checkpoint resume diverged"

    y = out.cpu().numpy()[hop : -(n - hop)]
    ref = x[(n_chunks - 1) * chunk_samples + hop :][: len(y)]
    results["stream_tail_chunk_snr_db"] = round(snr_db(ref, y), 1)

    # One hop block through the scan step with its carried tail: its
    # device time against its own duration (H / sr).
    one_block, tail_in = stream_block_probe(cfg, dev)
    results["stream_block_latency_ms"] = round(
        device_ms(lambda: one_block(tail_in), dev), 4)
    one_block(tail_in).cpu()
    _sync(dev)
    with uncounted():
        t0 = time.perf_counter()
        one_block(tail_in).cpu()
        results["stream_block_dispatch_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 2)
    results["stream_block_budget_ms"] = round(hop / sr * 1e3, 3)
    results["stream_algorithmic_latency_ms"] = round(n / sr * 1e3, 2)

    got = replayed("tiled_scan", tiled_scan)
    if got is not None:
        wall_s, _, (ys, tail_scan) = got
        results["stream_sustained_device_resident_tiled_scan_gsamples_per_s"
                ] = round(total / wall_s / 1e9, 4)
        results["stream_scan_vs_dispatch_bitexact"] = int(
            torch.equal(ys[-1], last_dev) and torch.equal(tail_scan, tail_dev))
        results["stream_scan_vs_dispatch_max_abs_delta"] = float(
            (ys[-1] - last_dev).abs().max())
    if not_captured:
        results["_not_captured"] = not_captured


BENCHES = {
    "fft": bench_fft, "kernels": bench_kernels, "ola": bench_ola,
    "e2e": bench_e2e, "spectral": bench_spectral,
    "multichannel": bench_multichannel, "sweep": bench_sweep,
    "resample": bench_resample, "convolve": bench_convolve,
    "features": bench_features, "iir": bench_iir,
    "streaming": bench_streaming,
}


def check(results: dict) -> None:
    """Raise on a NaN, a bit-exact flag of 0 or an SNR under its gate."""
    bad = []
    for k, v in results.items():
        if k.startswith("_") or not isinstance(v, (int, float)):
            continue
        if isinstance(v, float) and math.isnan(v):
            bad.append(f"{k} is NaN")
        elif k.endswith("_bitexact") and v != 1:
            bad.append(f"{k} = {v}")
        elif k.endswith("_snr_db") and v < SNR_GATES.get(k, SNR_FLOOR_DB):
            bad.append(f"{k} = {v} dB < {SNR_GATES.get(k, SNR_FLOOR_DB)}")
    if bad:
        raise AssertionError("; ".join(bad))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--suites", default=",".join(SECTIONS),
                    help="comma-separated subset")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..core.device import resolve_indexed

    dev = resolve_indexed(args.device)
    suites = set(args.suites.split(","))
    unknown = suites - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown suites {sorted(unknown)}; one of "
                         f"{SECTIONS}")
    backend = backend_name(dev)
    results: Dict[str, object] = {}
    launches: Dict[str, Dict[str, int]] = {}
    t0 = time.perf_counter()
    for name in SECTIONS:
        if name not in suites:
            continue
        before = set(results)
        counts0 = launch_counts()
        BENCHES[name](results, dev)
        _sync(dev)
        counts1 = launch_counts()
        launches[name] = {k: counts1[k] - counts0[k] for k in counts1
                          if counts1[k] != counts0[k]}
        section = {k: v for k, v in results.items() if k not in before}
        print(json.dumps({"suite": name, **section,
                          "_launches": launches[name]}), flush=True)
        if args.out:  # incremental: a failure later keeps what finished
            snap = dict(results, _backend=backend, _launches=launches,
                        _wall_s=round(time.perf_counter() - t0, 1),
                        _partial=name)
            with open(args.out, "w") as f:
                f.write(json.dumps(snap) + "\n")
    results["_nan_retry_attempts"] = 0
    results["_backend"] = backend
    results["_launches"] = launches
    results["_wall_s"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(results)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return results


if __name__ == "__main__":
    main()
