#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `crlot_tpu_torch/csrc/` (nvcc, sm_90a),
holds each kernel against its plain PyTorch version on the card, then runs
twelve paths through the public entry points, each with the kernels' launch
counters reset just before and read just after: on 2 channels x 60 s at
48 kHz, N=1024 / H=256, Hann, seed 0, the round-trip path (`round_trip`,
`stft`, `istft`; centered) and the fused-frames and sharded path
(`round_trip` with `fused_roundtrip`, `sharded_round_trip`); the resample
and demo path (`resample`, `resample_chunked`, `resampled_stft`,
`convolve`, the demo); the streaming, wire and probe path
(`BlockedChunkStreamer`, `I16BlockedStreamer`, `i16_round_trip`,
`process_wav_file`, `python -m crlot_tpu_torch.int8_probe`'s `run`); the
INT8X2 path (`round_trip` at N=1024 / H=480, the tiled int8 route); and
the streaming layer (`ShardedStreamer`, `sharded_stream`, `Framer`,
`OLAAccumulator`, `checkpoint`, `FftPlan`) at BASELINE config 5's width;
the multi-process path (`dryrun`, two ranks through `initialize`,
`global_mesh` and `process_allgather`, the halo accounting, the quad,
conv and packed formulations); and the tooling path (the native host
runtime `io/native.py`, `python -m crlot_tpu_torch.bench.suite`,
`bench.stages`, `bench.regression` with `bench.probes`, and the eight
`python -m crlot_tpu_torch.examples.<name>`); the frames-level routes
(`round_trip`'s "folded" and "composed", and the packed products the
reference keeps for an odd N); and the large frames (`round_trip`'s
"packed_parts" at N 2048 and 4096 on B2's kernels launched one by one);
B1's seeded variant, the masked stream's overlap-add; the resample
chain's stream (`ResampledStftStreamer`) at BASELINE config 3's cell;
and B7, the framed windowed rFFT.
`python3 chip_smoke.py --large-frames` runs the large frames alone,
`python3 chip_smoke.py --seeded-ola` the seeded variant, and
`python3 chip_smoke.py --chain-stream` the chain's stream, and
`python3 chip_smoke.py --stft-b7` B7.

Phases (each prints one line; the script exits 1 if any fails):
  1. B1 (fused OLA + normalize) vs plain on [2, 11251, 1024] frames, and
     at the edges of its tiles: H = 480 (R = 3: the tiled route's), H =
     300 (N % H != 0), H = 7 (one sample a thread, R at run time) and an
     odd output length: bit-exact (torch.equal).
  2. B2 (3xTF32 round-trip frames, then B1's OLA) vs plain for
     noise_gate(-30), spectral_subtraction(noise_mag, 1.0, 0.05) and
     compose(band_gain, noise_gate), over the cropped signal span: SNR
     between them >= 100 dB, and max-abs <= 1e-5 against plain on the card
     and on the host CPU outside the frames whose gate decision is
     ambiguous (a bin power within the products' error of the threshold,
     `fused_rt.ambiguous_frames`: ROADMAP C12) and the samples they
     overlap; prints how many frames it left out (fails above 0.1 %) and
     whether the worst sample lies in one. (Products may be summed in
     another order; the center padding divides by the near-zero edge norm,
     and every caller crops it.) Then the gate batch of
     `multich64.denoise_resident` (64 channels x 60 s, the GEMMs in
     clusters of 2 row blocks): one channel of it torch.equal to the
     channel alone and, over its first 100 hops, to its first 100 frames
     alone (a cluster of 1); each GEMM's device time there and the TF32
     rate it issues.
  3. round_trip identity ("blocked", one B0 launch): SNR vs input >= 60 dB.
  4. round_trip with a 3-band band_gain ("blocked", one B0 launch): the
     first 1 s against a float64 numpy STFT * g * iSTFT oracle, SNR >= 80
     dB; then on 64 channels x 60 s (`multich64.eq_resident`'s batch):
     one B0 launch, and torch.equal to the composition the route ran
     before it wrote the signal once (the centre pad, `F.pad`, the cat).
  5. istft(stft(x)): SNR >= 60 dB, B1 launched.
  6. round_trip with noise_gate(-30) ("fused_rt_ola"): SNR vs input >=
     60 dB, B2 launched.
  7. B3 (fused round-trip frames) vs plain for the identity and the three
     fns of phase 2, on the centered signal ([2, 11251, 1024] frames): SNR
     >= 100 dB, and max-abs <= 1e-5 against the plain version on the card
     and on the host CPU outside the ambiguous frames (as phase 2); the
     gate batch's channel hold of phase 2 on the frames; the library's
     launch plan (`crlot_rt_plan`) equal to `fused_rt.gemm_plan` at 56
     shapes.
  8. round_trip with cfg.fused_roundtrip ("fused_rt_frames"): SNR vs input
     >= 60 dB, B3 and B1 launched.
  9. sharded_round_trip with noise_gate(-30), center=False, T = 2879488
     (59.99 s: every time block a multiple of 2*hop), on a (channel=2,
     time=2) mesh whose four shards all sit on cuda:0: one B3 launch per
     shard, torch.equal to the (1, 1) mesh, and within max-abs 1e-5 of the
     one-shot round_trip (B2) over [N, T-N) (prints whether bit-identical).
 10. sharded identity (blocked route) on the same mesh and signal: blocked
     engaged, two B0 launches a shard (its interior rows, then its head
     and tail rows together once the halos are in) and one for each
     channel group's head and tail patch, interior SNR vs input >= 60 dB, torch.equal to
     the (1, 1) mesh, and the in-mesh metrics' SNR within 0.01 dB of the
     host's SNR of the gathered output; then at HIGHEST: the same launches
     of B0's fp32 kernel, (2, 2) torch.equal to (1, 1).
The resample and demo path runs on 2 channels x 60 s at 44.1 kHz (uniform
noise from seed 0 for the kernel checks, a 997 Hz / 1 kHz sine pair for
fidelity), BASELINE config 3's long streams, fp32 with TF32 off:
 11. B4 (polyphase resampler) vs plain at 44.1 -> 48 kHz and 48 -> 16 kHz:
     max-abs <= 1e-5 against `resample_bank_plain` on the card and on the
     host CPU, and SNR >= 120 dB against a float64 scipy resample_poly
     oracle over the first 1 s (computed on the first 1 s plus W input
     samples, which gives the full-signal values there); prints whether
     the card's result is bit-identical.
 12. B5 (axpy, axpy_windowed, normalize_and_clear) vs plain over the
     reference's SIZES and n = 2 x 2 880 000, aligned and misaligned:
     torch.equal (NaN positions equal), `cleared` all zero, norm rows with
     a NaN and a zero.
Then, with the B4 and B5 counters reset just before:
 13. resample(resample(x, 44100, 48000), 48000, 16000): one B4 launch per
     stage, lengths equal output_length, sine fidelity away from the edges
     (chain >= 90 dB, 44.1 -> 48 kHz >= 100 dB).
 14. resample_chunked(x, 44100, 48000, chunk=65536) on the card, tensor and
     numpy input: torch.equal to one-shot resample, one B4 launch a chunk.
 15. resampled_stft(x, 44100, 48000, N=1024/H=256, center=False) vs
     stft(resample(x)): max-abs <= 1e-5 * scale, B4 launched.
 16. convolve(x48, hamming(255)/127, "same") vs float64 numpy.convolve on
     the first 1 s: rel RMSE < 1e-5, one B0 launch.
 17. The demo (`crlot_tpu_torch.demo.main --device cuda`) on a 2-ch 60 s
     44.1 kHz 16-bit WAV written from seed 0: exits 0, launches B4 and B5,
     and writes a resampled WAV of output_length frames.
Kernel checks of B6 and B4's unstaged path (not counted on a path):
 18. B6 vs plain at the int8 probe's full shape (F = 11264, N = K = 512,
     inputs from seed 0 as `scripts/bench_pallas_int8_probe.py` makes
     them): K9, K10, K11 torch.equal, K8 within 1e-6 of sum|x||b|; B6-i8
     at the wire geometry (lda 512, K 2048, 1 and 2 x 4096 rows)
     torch.equal; and at the edges of the TMA kernel's tiles (M = 1000,
     N = 64 and 192, a dense K of 64 bytes, batch 2 of overlapping
     windows): B6-i8 torch.equal, B6-bf16 within 1e-6 of sum|x||b|;
     B6-limb probe3 at M = 1000, N = 64 and 192 and batch 2 of windows,
     and its int16 wire modes at lda 512 (2 x 4096 rows; 1000 rows at N =
     64 and 192): torch.equal; K11's two variants at M = 1000, N = 64 and
     192, K = 64 (half a stage), 576 (a ragged last stage) and 4096 (the
     composed basis at N = 4096, past the former kernel's 1024):
     torch.equal.
 19. B4 at 48 kHz -> 300 Hz (M = 160: the input segment outgrows shared
     memory, so B4 reads each window from L2) vs `resample_bank_plain` and
     the grouped form on 2 x 60 s: max-abs <= 1e-5.
Then the streaming, wire and probe path on the reference bench's stream
(`crlot_tpu/bench/suite.py`: mono 48 kHz, center=False, 13 chunks of
2 097 152 samples of uniform noise in +-0.9 from seed 9, device-resident),
with the B6 counters reset just before:
 20. BlockedChunkStreamer (identity) vs the one-shot
     `blocked_composed_round_trip`: torch.equal, one B0 launch a chunk; the
     same at HIGHEST, one launch of B0's fp32 kernel a chunk.
 21. The wire tier on the same stream as int16, int8x2 and int8x1: one
     B6-limb launch per chunk; chunks of 2 097 152, 524 288 and one chunk
     bit-identical (int16 egress); identity interior >= 90 dB vs the float
     source; int8x2 vs the f32 streamer >= 85 dB.
 22. band_gain EQ int8x2 vs the f32 EQ streamer >= 60 dB; a full-scale
     square wave with the codes -32768, 32639, 32640, 32767 (both tiers):
     interior within 2e-6 of a float64 oracle of the exact product and
     bit-identical to the plain version on the host CPU.
 23. process_wav_file on a 2-ch 60 s 48 kHz 16-bit WAV from seed 0 vs the
     unbroken stream (the scan form, its frames on B3's kernels): every
     16-bit code equal.
 24. The int8 probe (`int8_probe.run`): each variant held against its
     plain version (K11 on its TMA + wgmma mode), then its us per call,
     TOPS and library time (`torch._int_mm`, `torch.mm(...,
     out_dtype=float32)`), for K8 and K9 both also with a cold L2.
Then:
 25. B0 (`hopblock_apply`'s windowed product, 3xTF32 in `b6_sm90.cu`) vs
     its plain emulation within 2^-18 of sum|x||k| per output, at the
     main path's identity and EQ kernels and at the edges of the f32
     window tiles (M = 1000, N = 192, a batch of 2), and 1000 of its rows
     alone torch.equal to the same rows of the whole. B0's fp32 kernel
     (HIGHEST, `fp32_window.cu`) at the same kernels within K * 2^-24 *
     sum|x||k| of the float64 product, torch.equal to the exact emulation
     of its fmaf chain on 2 x 64 rows, at the tile edges, and 1000 rows
     alone torch.equal to the same rows of the whole.
Then the INT8X2 path, with the K11 and B1 counters reset just before:
 26. round_trip(x, N = 1024, H = 480 (10 ms), center=True, INT8X2) on the
     main path's 2 ch x 60 s: route "tiled_i8", four K11 launches
     (`dot_i8x2`'s variant) each torch.equal to its plain version on its
     own operands, one B1 launch, identity >= 60 dB; the same at HIGH
     (route "tiled", IEEE fp32 products), and the int8 tier's SNR against
     it; `roundtrip_composed_i8` with a +-10 dB EQ on the path's frames
     (K = N = 1024, one K11 launch, torch.equal to plain), >= 62 dB
     against a float64 oracle over the first 64 frames.
Then the streaming layer, with the B0, B3 and K6 counters reset just
before:
 27. BASELINE config 5: `ShardedStreamer` on 128 channels in chunks of
     2^20 samples (uniform noise in +-0.9 made on the card from seed 5),
     N=1024, H=256, Hann, center=False, on the (1, 1) and (2, 2) meshes of
     the card. Over 4 chunks, for the identity at HIGH (B0) and at HIGHEST
     (B0's fp32 kernel), the band_gain EQ (blocked, B0) and noise_gate
     (masked, B3): chunked torch.equal to the one-shot
     `sharded_round_trip` of the whole stream on each mesh, (2, 2) equal
     to (1, 1), the launches counted exactly; `sharded_stream` (the masked
     array form, noise_gate) equal to its one-shot with
     allow_blocked=False; `state()` after chunk 2 loaded into a fresh
     streamer resumes equal to the unbroken stream (identity and
     noise_gate). Then an hour (165 chunks, 128 x 173 015 040 samples) at
     the identity on (1, 1) with force=False, each output reduced on the
     card to its interior SNR against its input: samples/s on the host
     clock, the worst chunk's SNR (> 60 dB), the B0 launches; and the
     card's idle share over 6 profiled chunks (`torch.profiler`).
 28. `Framer` (interleaved 10 ms pushes) feeding `OLAAccumulator` (Hann
     inside, one frame at k*H and produce(H) a frame, then flush and
     drain) on the main path's 2 ch x 60 s: every K6 launch of the drain
     torch.equal to its plain version, the output torch.equal to the same
     stream on the CPU, a `checkpoint.save_stream_state` at frame 2000
     loaded and resumed equal to the unbroken run, interior SNR > 60 dB;
     frames/s and the time per frame on the host clock, K6's time a launch
     at [2, 256].
 29. `FftPlan` REAL and COMPLEX at N=1024, batch 64 on the card (the matmul
     DFT): round-trips within `tests/test_fft.py`'s gates (RMSE < 1e-6;
     max-abs < 1e-4) and every output within 2^-22 * sum|input| of its row
     of the CPU's (`torch.fft`), the bound `tests/test_torch_fft_plan.py`
     states.
Then the analysis path, with the B1 and B0 fp32 counters reset just
before (the features' filterbank products run on B0's fp32 kernel), on the main
path's 2 ch x 60 s (N=1024, H=256, Hann, centered). Its counts are those of
its untimed calls (each timed or profiled repeat puts them back), and every
B0 fp32 launch of those calls is held torch.equal to the fmaf chain
(`fp32_window.chain_plain`) on its own operands (`ProductHold`):
 30. The IIR filters (the log-depth scan, float64): `sosfilt` with
     `butter_sos(8, 1 kHz)` and `a_weighting_sos(48 kHz)`, `lfilter` of
     scipy's `butter(4, 0.25)`, `sosfiltfilt`, `deemphasis(preemphasis(x))`:
     each >= 70 dB against scipy.signal in float64 on the host (the
     round-trip >= 100 dB against x) and torch.equal to the port on the
     host CPU; `sosfilt` in chunks of 2^18 with a carried zi > 90 dB
     against one-shot (tests/test_iir.py's gate); then at BASELINE config
     5's width (128 x 2^20, uniform noise in +-0.9 made on the card from
     seed 5): samples/s on the host clock (median of 3), device time and
     idle share (`torch.profiler`, 2 calls), peak device memory. C18: the
     A and C weighting filters' cascade in float64 (>= 70 dB), float32 and
     float32 with float64 combines against scipy, and each variant's time
     for `a_weighting_sos` at config 5's width.
 31. The features (`mel_spectrogram`, `mfcc`, `pcen` of the mel, spectral
     centroid / bandwidth / rolloff / flatness / contrast, `chroma`,
     `chroma_cqt`, `lpc`, zero-crossing rate, `frame_rms`, `envelope`):
     the first 1 s of frames (the envelope: the whole signal) within
     FEATURE_TOL of a float64 numpy / scipy computation, on the card and in
     the port on the host CPU, and card vs host CPU within twice it; two
     1-channel shards on the card torch.equal to the 2-channel call for
     each of them but the envelope, and `sosfilt`, `pseudo_cqt`, `tonnetz`;
     `mel_spectrogram` + `pcen` at config 5's width as in phase 30.
 32. `griffin_lim` (32 iterations, synthesis window) of the magnitude of 2
     ch x 60 s of tones and a 100 Hz -> 8 kHz chirp: 33 B1 launches,
     spectral convergence <= -20 dB (tests/test_griffinlim.py's gate), wall
     and device time; card vs host CPU from one initial phase at 2
     iterations >= 90 dB (the initial phase, hashed on the card,
     torch.equal to the host CPU's); `mel_to_audio` once (128 mels), wall
     and device time.
 33. `split_silence` / `trim_silence` (top_db 40) of 60 s of tones with 2 s
     of digital silence between them: the same intervals as the port on
     the host CPU, each covering its tone within a frame.
Then the last analysis path, with the B1, B4 and B0 fp32 counters reset
just before, on the main path's 2 ch x 60 s unless a phase says otherwise;
its counts are those of its untimed calls, every B0 fp32 launch is held
torch.equal to the fmaf chain (`ProductHold`), and in phases 36 and 38
every B1 launch torch.equal to its plain version and every B4 launch within
1e-5 of `resample_bank_plain` on its own operands (`LaunchHold`):
 34. The FFT backends on MATMUL (C20): `dispatch.rfft` / `irfft` and the
     complex transforms of 64 rows at N = 8192 and 16384 (Cooley-Tukey
     products), 1023 (the dense basis) and 6000 (`torch.fft`), against
     float64 numpy within `tests/test_fft_ct.py`'s gates (rfft and fft
     max-abs / N < 2e-6, round-trip RMSE < 1e-5, inverse back within
     1e-3); `round_trip` at N = 8192, H = 2048, MATMUL above 80 dB, with
     its wall and device time; two 1-channel shards of that STFT
     torch.equal to the 2-channel call.
 35. `welch_psd` (density, spectrum) and `coherence` of noise plus tones
     against `scipy.signal` in float64 (relative RMSE < 1e-4,
     `tests/test_psd.py`'s gate), card vs host CPU within 1e-5 of the
     largest value, two 1-channel shards torch.equal.
 36. `hpss` (kernels 31) of tones plus a click train: harmonic +
     percussive vs `istft(stft(x))` above 60 dB, exactly 2 B1 launches,
     the masks on the card vs the host CPU's from one power within 2^-21,
     two shards torch.equal; wall and device time, peak device memory.
 37. `yin_f0` of 110 / 440 and 220 / 880 Hz tones (30 s each) within 1 %
     (`tests/test_pitch.py`'s gate); `detect_onsets` (uncentered) of noise
     bursts every 97 hops in digital silence: each found within a frame,
     none extra; `tempo` of 120 and 90 BPM click tracks within 5 % and
     `tempogram` peaking within 2 lags of the period
     (`tests/test_rhythm.py`'s gates); each card vs host CPU within 1e-5 of
     the largest value (onset masks equal); two shards torch.equal for
     each.
 38. `time_stretch` at rate 1 on 30 s of 440 Hz, interior above 60 dB
     (`tests/test_vocoder.py`'s slow gate); at rates 0.8, 1.1, 1.5 on 440
     / 880 Hz: the length (F - 1) * Hs + N within 2 % of rate * T and the
     dominant frequencies within 3 Hz; `pitch_shift` by -12, -1, +3, +7,
     +12 semitones: the length kept and the dominant frequency within 5 Hz
     of 440 * 2^(s/12); 8 B1 launches (the synthesis hops 205, 282, 384,
     128, 242, 304, 384, 512) and 5 B4 launches (L/M 2/1, 53/50, 37/44,
     2/3, 1/2) held against plain; wall and device times.
 39. `dtw` of the chroma (N = 4096, H = 1024) of 60 s of notes against a
     time-warped copy of it (2 813 x 2 813 frames): the accumulated matrix
     on the card torch.equal to the host CPU's accumulation of the card's
     cost matrix, the
     total within (N + M) 2^-24 of it of a float64 DP on the same costs,
     the path equal to the host CPU's; `dtw`'s host-clock time and device
     launches a row.
Then the multi-process path, with the B0 and B3 counters reset just
before; its counts are those of its untimed calls, here and in the two
ranks of phase 41, and every B0 and B3 launch of those calls is held
against its plain version at once (`KernelHold`: B0 within 2^-18 of
sum|x||k|, B3 within 1e-5 outside ambiguous gate frames); the timed runs
of the depth-3 prefetch are neither held nor counted:
 40. The port's `dryrun(4)` on a (2, 2) mesh whose shards all sit on
     cuda:0: Part A (the blocked and masked chunked streamers bit-exact
     against their one-shots, a checkpoint through npz resumed bit-exact,
     interior SNR >= 60 dB, 2 halo ops of (N - H) * 4 * 2 bytes a shard,
     the NVLink weak-scaling gate >= 0.8 at config 5's 2^20-sample block
     with the 1 s figure beside it, the independent MAC fraction >= 0.75 at
     a 1 s block), Part B at config 5's shape (128 channels x 2 887 680
     samples in 20 chunks, bit-exact against the one-shot, the state's
     bytes constant) and Part C (depth 1 vs depth 3 under an injected delay
     a chunk, at 128 channels in config 5's 2^20-sample chunks: >= 0.8 of
     the device's hidable time recovered); its JSON line.
 41. Two ranks sharing the card (`python3 chip_smoke.py --multihost-child
     <rank> 2 <port>`, each running `crlot_tpu_torch.distributed.
     multihost_child --device cuda` under `KernelHold`; gloo, halos staged
     through pinned host memory) on a (channel=2, time=2) global mesh,
     every halo crossing the process boundary: the identity (blocked, B0)
     and noise_gate(-30) (masked, B3) on phase 9's 2 x 2 879 488 samples
     and one 128 x 2^20 chunk of config 5, gathered torch.equal to a
     one-process (1, 1) mesh with equal mesh metrics; the blocked streamer
     torch.equal to one process and resumed from a one-process state; the
     depth-3 prefetch across the boundary at 128 x 2^20 (the reference
     child's gate: depth 3 recovers >= 20 % of the hidable time); the bytes
     each exchange moved and the host-staging and receive-wait time.
 42. The accounting on phase 10's (2, 2) mesh: `collective_bytes_per_step`
     2 ops of (N - H) * 4 * C_local bytes, `overlap_dot_fraction` >= 0.75
     at a 49 152-sample block a shard, `weak_scaling_model` with the card's
     name at 1 s and 2^20, the main path's roofline (`profiling`).
 43. A9's formulations on the card, each against float64 numpy: the quad
     parts and round-trip at N = 512, 1024, 2048, 4096 on 64 rows
     (`tests/test_fft_quad.py`'s gates: forward and inverse RMSE < 1e-6,
     round-trip < 1e-5), the packed round-trip and the composed conv (the
     3-band EQ; at HIGH on B0, at HIGHEST `conv1d` with cuDNN's TF32 off)
     on the main path's [2, 11251, 1024] frames (RMSE < 1e-5 hard, the
     1e-6 target reported over the first second's frames), each with its
     CUDA-event ms.
Then the tooling path, with every kernel counter reset just before
(`bench.launches.reset_launch_counts`). Its counts are those of every
launch it makes on the card in this process outside the timed repeats and
the CUDA-graph captures, which run inside `bench.launches.uncounted()` and
leave no count; each counted launch is held against its plain version as
it is made (`ToolingHold`), and the phase "44-48 held launches" fails
unless every one of them was:
 44. The native runtime (`crlot_tpu_torch/io/native.py`, the library built
     with g++ under `build/`) on the main path's 2 ch x 60 s: WAV encode
     and decode at 16, 24, 32 bits and float32 byte-identical to the
     port's Python codec; `NativeFramer` fed phase 28's 10 ms interleaved
     pushes, every batch np.array_equal to `Framer`'s; its batches, one
     copy to the card each, through phase 28's `OLAAccumulator`: every K6
     launch torch.equal to plain, the output torch.equal to phase 28's;
     frames/s on the host clock beside phase 28's.
 45. `python -m crlot_tpu_torch.bench.suite --out <tmp>` (in this
     process: `suite.main`), all twelve sections at the reference's
     sizes, each section's line (with its launches per kernel) printed;
     fails on a NaN, a bit-exact flag of 0 or an SNR under its gate
     (`suite.check`). The one-program streaming variants are CUDA-graph
     replays; a variant whose capture fails is named, its keys left out.
 46. `bench.stages.main()` and `main_pipeline()` on the card: each stage's
     ms, the framed and the blocked stage sums beside the whole
     `round_trip` (route "blocked").
 47. `bench.regression --current <phase 45's JSON>` against the committed
     card key of `crlot_tpu_torch/bench/baseline.json`: fails on an
     exception, a band "armed but not measured" or a failed SNR band; the
     timing bands' verdicts are printed, not gated (a 10 % band is a
     same-machine guard, and this may be another H100); its
     `quick_headline_duty`: bf16 TFLOP/s against 989, HBM GB/s against
     3350, the main path's share of the blocked roofline and the
     chip-adjusted share.
 48. The eight examples as `python -m crlot_tpu_torch.examples.<name>`
     (`runpy.run_module` in this process, so their launches count and are
     held; the wall time of a second run, unheld) on a 2 ch x 60 s 48 kHz
     16-bit WAV from seed 0, each
     against the same example run with `--device cpu` in a subprocess
     (exit 0): WAV outputs within one 16-bit code (outside the first and
     last N samples of the uncentered `sharded_eq`, whose eps-clamped edge
     norm amplifies roundoff: its largest difference is printed); the
     time stretch frame by frame (ROADMAP C23: its phase advance is cut at
     +-pi, so roundoff moves a bin's phase for good, and codes drift
     apart): the median per-frame STFT magnitude distance of every run of
     16 frames at most 0.25, and the same stretch on the card with its
     phase accumulation dropped must read above it; features within
     1e-4 of their largest value with onsets and tempo equal, levels
     within 0.1 dB, the streaming output within 1e-5.
Then the frames-level routes, with the B0 and B1 counters reset just
before, on the main path's 2 ch x 60 s at 48 kHz; every B1 launch held
torch.equal to plain (`LaunchHold`), every B0 launch within 2^-18 of
sum|x||k| of plain (`KernelHold`):
 49. (a) the identity at N = 960, H = 240 (20 ms / 5 ms: no blocked group,
     N % 256 != 0): route "folded", > 60 dB against the input; (b) the
     3-band band_gain there: route "composed" (B0), the first 1 s >= 80 dB
     against the float64 oracle; (c) N = 1323, H = 441 (30 ms / 10 ms at
     44.1 kHz's sizes): `StftConfig` refuses an odd N, so the reference's
     packed branch is driven as its round_trip composes it (frames,
     `roundtrip_packed_matmul`, B1 with the edge norm at an odd hop), > 60
     dB; (d) the band_gain on 128 clips of 1 200 samples at N = 1024, H =
     256 (5 frames, under the blocked gate's 6): route "composed" (B0),
     every clip >= 80 dB against the float64 oracle. Exactly 4 B1 and 2 B0
     launches; whether B0 reads the frame rows in place or copies them.
     Then each case's CUDA-event time (median of 10, queued) beside the
     `stft_istft` route it replaces (at N = 1323: frames, `torch.fft`, B1),
     in turns, outside the counts.
Then the large frames, with the split path's and B1's counters reset just
before, on the cell `large4096.gate_tracks`'s configuration, gate and
tones (16 ch x 3 s at 44.1 kHz):
 50. `round_trip`'s "packed_parts" route at N 2048 and 4096, hop N/4. At
     HIGH the split path (B2's fold pass, forward GEMM and inverse GEMM
     launched one by one, the gate in torch between them): every launch
     held against plain on its own operands (`SplitHold`: the fold
     torch.equal, each GEMM within 2^-18 of sum|a||b|), exactly one of
     each a call, max-abs <= 1e-5 against the plain split path outside
     the frames whose gate decision the kernel's and the plain spectrum
     flip (at most 5 % of them), and err_rel / peak_rel within the cell's
     limits against `portbench/reference/stft64.py`'s float64 round trip;
     at HIGHEST no launch of the split path, the same limits. Then, at the
     cell's full 16 x 200 s, each kernel's CUDA-event time with the TF32
     rate the GEMMs issue and the DFT's bound, and the whole call's.
Then B1's seeded variant, with its counter reset just before:
 51. `ola.fused.ola_seeded` torch.equal to its plain version, one launch
     a call, at `nrstream128.gate_stream`'s feed (128 x 2352 frames of
     1024, hop 256: the block with the tail seeded first and the divide,
     and the tail window) and at odd shapes (R 2 and 5, N off the hop,
     hops 21 and 7, windows off the hop grid, frames off 16 bytes, an
     empty frame range); then the block's and the tail's CUDA-event times
     at the feed beside their bound, the plain version's, and the former
     `where` + two `overlap_add` passes + divide.
Then BASELINE config 3's chain as the cell `rschain128.chain_stream` feeds
it, with B4's counter reset just before:
 52. `ResampledStftStreamer` (44.1 -> 48 -> 16 kHz, N 400, H 160) fed
     three 128 x 1 323 000 chunks of noise: two B4 launches a feed, 3000
     frames a feed after the first; each launch within 1e-5 of its largest
     output of `resample_bank_plain` on the same joined buffer; the frames
     within 1e-5 of the largest bin of `stft` over the plain chain of the
     whole stream (`resample_bank_plain` a stage).
Then B7, the framed windowed rFFT, with its counter reset just before:
 53. `fp32_window.stft_cuda` on `unfold` views read in place (one row and
     128, rows of a length off 4, frame counts off the tile, N 400 / H
     160, N 512 and 1024 at hops below and above N, N 16; Hann and a
     window that is not symmetric): one launch a call, every output
     within (h+1) 2^-24 sum|a||b| of the float64 products on its own
     folded operands, torch.equal to its emulated fmaf chains where
     small; `ResampledStftStreamer` in uneven feeds torch.equal to the
     one-shot `resampled_stft` (one stage) and `stft` of the one-shot
     chain; then B7's time at the chain's feed beside its bound and the
     folded route's.
Then CUDA-event timings (warm-up, then median of 10 runs queued behind a
busy card, so that host launch time is not counted, checked to have been
queued before the card woke, and else reported as not queued; beside it
the median of 10 runs timed one at a time, synchronized after each): each
kernel vs its plain
version (B1 beside its former design's time as PERF.md gives it; B0 and
its fp32 kernel also against the former cuBLAS fp32 loop, their library
time; K11 at the probe's shape beside its former design's PERF.md time,
and at the tiled route's 2 x 6001 frames x 512;
B4 at both rates against its former design, the blocks tile, in the
same run and as PERF.md gives it, against `resample_bank_plain` and
against `resample_grouped_plain`, the JAX default's math; B5 at n =
5 760 000; B0's rate in samples/s beside the main path's roofline), and
end-to-end samples/s of phases 3, 6, 8, 9 (phase 9 on both meshes; the
(2, 2) mesh runs its four shards one after another on one card, so it is no
scaling figure), 13, 14 and 15, and the demo's wall time; the library
calls beside B4 (`conv1d`) and B5 (`torch.add`, `torch.addcmul`); the
sustained samples/s of the f32 streamer and both wire tiers (phases 20,
21); B6's plain versions at the probe shape, B6-limb at one wire chunk
(on the int16 samples, as the path runs it, beside the former mma.sync
design from PERF.md), B6-i8 at the wire geometry and B4 at 48 kHz -> 300
Hz against theirs.

The last three lines: a JSON object describing each kernel (with its
bound from this run's bytes and operations at the H100 SXM peaks, and the
one library call's time or null); the card's name and power limit; and
{"ok": true, "device": {...}}. Without
CUDA, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SR = 48000
SECONDS = 60
NFFT, HOP = 1024, 256
SEED = 0
REPS = 10
T_SHARDED = 2_879_488  # 59.99 s; T / 2 is a multiple of 2 * HOP
SR_IN = 44100  # the resample path's input rate
SIZES = [1, 7, 15, 16, 17, 127, 128, 129, 1023, 1024, 1025, 4096, 16384]
N_B5 = 2 * 2_880_000  # a 60 s stereo 48 kHz accumulator
# H100 SXM peaks for the bounds (NVIDIA's data sheet, dense): HBM bytes/s,
# and operations/s by type.
HBM_BPS = 3.35e12
PEAK_OPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}
# A 3xTF32 product is three TF32 products: its operations at "tf32" are
# three times the f32 product's.


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def kernel_name(line: str) -> str:
    """The kernel named in a ptxas "Compiling entry function" line, from
    its mangled name (length-prefixed identifiers), with its template
    argument where there is one: "b6_sm90_kernel<4>"."""
    for i in range(len(line)):
        if not line[i].isdigit():
            continue
        j = i
        while j < len(line) and line[j].isdigit():
            j += 1
        name = line[j : j + int(line[i:j])]
        if name.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", name):
            arg = re.match(r"IL([ib])(\d+)E", line[j + len(name):])
            if arg is None:
                return name
            val = arg.group(2)
            if arg.group(1) == "b":
                val = "true" if val == "1" else "false"
            return f"{name}<{val}>"
    return line.strip()


# The former designs of K1, K2, K3, K7, K10 and K11 and B0's former cuBLAS
# loop, as
# PERF.md's table gives them (NVIDIA H100 80GB HBM3, 700.00 W; ms, CUDA
# events, queued): printed beside the new times.
OLD_MS = {"K7 44.1->48": "0.1568-0.1581 ms",
          "K7 48->16": "0.1684 ms",
          "K10 probe": "0.0595-0.0601 ms",
          "K10 wire chunk": "0.0756-0.0762 ms",
          "K1": "0.0771-0.0776 ms (one sample a thread, PR 1-7)",
          "K11 probe": "0.0860-0.0875 ms (mma.sync, int8_gemm.cu, PR 4-7)",
          "K2": "1.9525-1.9759 ms (fp32 FMA, register-tiled)",
          "K3": "1.8900-1.9048 ms (fp32 FMA, register-tiled)",
          "B0": "0.5819 ms of cuBLAS GEMMs + 0.072 ms of adds (PERF.md 5)"}


def timed(timing, key, fn) -> None:
    """Stores fn's time under key (queued, or per call where the host fell
    behind the card), its per-call time under key + "_call", and whether
    it was queued under key + "_queued"."""
    from crlot_tpu_torch.timing import cuda_ms

    queued, per_call = cuda_ms(fn, REPS)
    timing[key] = per_call if queued is None else queued
    timing[key + "_call"] = per_call
    timing[key + "_queued"] = queued is not None


def ms(timing, key) -> str:
    """A timing as printed: queued ms, then the per-call ms."""
    if not timing[key + "_queued"]:
        return (f"{timing[key]:.4f} ms per call (not queued: the host fell "
                f"behind the card)")
    return f"{timing[key]:.4f} ms ({timing[key + '_call']:.4f} per call)"


def bound(nbytes, ops=0.0, kind="fp32") -> dict:
    """The least time the card could take for the work: the larger of its
    bytes (each input read once, each output written once) over the HBM
    rate and its operations over the type's peak rate, in ms."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def e2e_seconds(fn) -> float:
    """Median host-clock time of a synchronized call over REPS runs (s)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import crlot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: crlot_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 2
    import numpy as np

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import cuda_build, spectral
    from crlot_tpu_torch import int8_gemm as b6
    from crlot_tpu_torch.core.padding import pad_signal
    from crlot_tpu_torch.fft import fp32_window as b0f
    from crlot_tpu_torch.fft import fused_rt as b2
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.distributed import sharded_pipeline as spl
    from crlot_tpu_torch.pipeline import _norm_np, _window_f64

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = smi()
    log(f"nvidia-smi: {card}")
    log(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    cuda_build.load_library()
    log(f"kernel build: {cuda_build.build_seconds:.2f} s "
        f"({len(cuda_build.sources())} sources, nvcc)")
    kernel = "?"
    for line in cuda_build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = kernel_name(line)
        if "registers" in line or "spill" in line or "arning" in line:
            log(f"  ptxas {kernel}: {line.strip()}")

    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    rng = np.random.default_rng(SEED)
    n = SR * SECONDS
    x_np = rng.uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    spec_ = cfg.frame_spec
    pad = spec_.pad_amount
    n_frames = spec_.num_frames(n)
    full = (n_frames - 1) * HOP + NFFT
    norm = torch.from_numpy(_norm_np(cfg, n_frames, full).copy()).to(dev)
    w32 = torch.from_numpy(np.asarray(_window_f64(cfg), np.float32)).to(dev)
    padded = pad_signal(x, pad, pad, spec_.pad_mode).contiguous()
    noise_mag = np.full(NFFT // 2 + 1, 5.0, np.float32)
    band = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, NFFT)
    fns = {
        "noise_gate(-30)": spectral.noise_gate(-30.0),
        "spectral_subtraction": spectral.spectral_subtraction(
            noise_mag, 1.0, 0.05),
        "compose(band_gain, noise_gate)": spectral.compose(
            spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, NFFT),
            spectral.noise_gate(-30.0)),
    }
    failures = []
    results = {}

    def phase(name, fn):
        try:
            msg = fn()
            sync()
            log(f"PASS {name}: {msg}")
        except Exception as e:  # report every phase, then exit non-zero
            failures.append(name)
            log(f"FAIL {name}: {type(e).__name__}: {e}")

    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    def finite(t, shape):
        check(tuple(t.shape) == tuple(shape), f"shape {tuple(t.shape)}")
        check(bool(torch.isfinite(t).all()), "non-finite output")

    # 1. B1 vs plain.
    frames = torch.from_numpy(
        rng.standard_normal((2, n_frames, NFFT), dtype=np.float32)).to(dev)

    def p1():
        got = b1.ola_normalized_cuda(frames, norm, HOP, full, cfg.eps)
        sync()
        want = b1.ola_normalized_plain(frames, norm, HOP, full, cfg.eps)
        finite(got, (2, full))
        err = float((got - want).abs().max())
        results["b1_err"] = err
        check(torch.equal(got, want), f"not bit-exact, max-abs {err:.3g}")
        edges = []
        g1 = torch.Generator(device=dev).manual_seed(1)
        for hop, nfft, nf, out_len in ((480, NFFT, 6001, 6000 * 480 + NFFT),
                                       (300, NFFT, 777, 777 * 300 + 724),
                                       (7, 64, 3001, 3001 * 7 + 57),
                                       (HOP, NFFT, 999, 998 * HOP + 1021)):
            fr = torch.randn((2, nf, nfft), generator=g1, device=dev)
            nrm = torch.rand(out_len + 5, generator=g1, device=dev) + 0.5
            nrm[::97] = 0.0  # below eps: divided by eps
            a = b1.ola_normalized_cuda(fr, nrm, hop, out_len, cfg.eps)
            sync()
            b = b1.ola_normalized_plain(fr, nrm, hop, out_len, cfg.eps)
            e = float((a - b).abs().max())
            results["b1_err"] = max(results["b1_err"], e)
            check(torch.equal(a, b), f"H {hop}, N {nfft}, {nf} frames, "
                  f"{out_len} out: not bit-exact, max-abs {e:.3g}")
            edges.append(f"H {hop} N {nfft} out {out_len}")
        return (f"bit-exact on [2, {n_frames}, {NFFT}], max-abs {err}; and "
                f"at {'; '.join(edges)}")

    phase("1 B1 vs plain", p1)

    # Frames with an ambiguous gate decision (ROADMAP C12): their bins may
    # flip between any two orders of summing the products, so the max-abs
    # gates of phases 2 and 7 leave them (and, for B2's OLA output, the
    # samples they overlap) out, and fail if they are more than 0.1 %.
    n_rows = 2 * n_frames

    def ambiguous(fn):
        mask = b2.ambiguous_frames(padded, NFFT, HOP, n_frames, w32,
                                   None if fn is None else fn.packed)
        return mask, int(mask.sum())

    def host_f64(fn, ola: bool):
        """B3's function (ola=False: [2, F, N] frames) or B2's (ola=True:
        the overlap-added, normalized signal) in float64 on the host CPU
        (`torch.fft`, the spectral fn's packed form on float64 parts): the
        independent reference of phases 2 and 7, beside the fp32 plain
        version there (`host_fp32`)."""
        from crlot_tpu_torch.ola.reference import overlap_add

        frames = padded.cpu().double().unfold(-1, NFFT, HOP)[:, :n_frames]
        spec = torch.fft.rfft(frames * w32.cpu().double(), dim=-1)
        if fn is not None:
            spec = torch.complex(*fn.packed(spec.real, spec.imag))
        of = torch.fft.irfft(spec, n=NFFT, dim=-1)
        if not ola:
            return of
        acc = overlap_add(of, HOP, full)
        return acc / torch.clamp_min(norm.cpu().double(), cfg.eps)

    def host_fp32(fn, ola: bool):
        """B3's (ola=False) or B2's (ola=True) fp32 plain version on the
        host CPU, computed three times: (the result, a note). Twice in two
        runs a single such computation missed the card by 8e-5 while the
        card matched the float64 host reference and its plain version on
        the card (ROADMAP C16), so each computation reads its inputs back
        from the card anew, the readbacks must be bit-equal (a readback
        racing a kernel would differ), and a computation that differs from
        the other two, which agree, is a host fault: it is named, with
        whether its frames or only its overlap-add differ, and left out.
        Raises when no two of the three agree."""
        from crlot_tpu_torch.ola.reference import normalize, overlap_add

        packed = None if fn is None else fn.packed
        runs, first = [], None
        for _ in range(3):
            inp = (padded.cpu(), w32.cpu(), norm.cpu())
            first = first or inp
            check(all(torch.equal(a, b) for a, b in zip(inp, first)),
                  "the inputs read back from the card differ between "
                  "readbacks")
            fr = b2.roundtrip_frames_plain(inp[0], NFFT, HOP, n_frames,
                                           inp[1], packed)
            sig = (normalize(overlap_add(fr, HOP, full), inp[2][:full],
                             cfg.eps)[..., :full] if ola else None)
            runs.append((fr, sig))
        res = [r[1] if ola else r[0] for r in runs]
        agree = [i for i in range(3)
                 if sum(torch.equal(res[i], res[j]) for j in range(3)) >= 2]
        check(agree, "the three host fp32 computations all differ")
        odd = [i for i in range(3) if i not in agree]
        if not odd:
            return res[agree[0]], "bit-equal in 3 host computations"
        i, j = odd[0], agree[0]
        d = (res[i] - res[j]).abs()
        at = tuple(int(v) for v in np.unravel_index(int(d.argmax()),
                                                     d.shape))
        frames_same = torch.equal(runs[i][0], runs[j][0])
        return res[j], (
            f"host computation {i + 1} of 3 differed from the other two, "
            f"which agree (max-abs {float(d.max()):.3e} at {at}, "
            f"{int((d > 0).sum())} values; its frames "
            f"{'equal, its overlap-add not' if frames_same else 'differ'}) "
            f"and is left out (ROADMAP C16)")

    # The gate batch of `multich64.denoise_resident`: 64 channels x 60 s a
    # call, whose GEMMs run in clusters of 2 row blocks. Channel ALONE of
    # it must equal, bit for bit, the channel computed alone (clusters of 2
    # at other row offsets) and its first SHORT frames alone (one row
    # block: a cluster of 1).
    from crlot_tpu_torch.profile_paths import _device_events

    BATCH, ALONE, SHORT = 64, 5, 100
    g64 = torch.Generator(device=dev).manual_seed(SEED)
    padded64 = pad_signal(
        torch.rand((BATCH, n), generator=g64, device=dev) * 2 - 1, pad, pad,
        spec_.pad_mode).contiguous()
    one64 = padded64[ALONE:ALONE + 1].contiguous()
    short64 = padded64[ALONE:ALONE + 1, :(SHORT - 1) * HOP + NFFT].contiguous()

    def batch_hold(got, alone, short, upto, what):
        """Channel ALONE of the batch's `got` against `alone` and, over its
        first `upto` entries, against `short`."""
        rows = (b2.gemm_plan(BATCH * n_frames, NFFT).cluster,
                b2.gemm_plan(n_frames, NFFT).cluster,
                b2.gemm_plan(SHORT, NFFT).cluster)
        check(rows[2] == 1 < rows[1], f"clusters {rows}")
        check(torch.equal(got[ALONE], alone[0]),
              f"{what}: channel {ALONE} of the {BATCH}-channel call != the "
              f"channel alone")
        check(torch.equal(got[ALONE, :upto], short[0, :upto]),
              f"{what}: channel {ALONE} of the {BATCH}-channel call != its "
              f"first {SHORT} frames alone")
        return (f"{what}: channel {ALONE} of {BATCH} x 60 s (clusters of "
                f"{rows[0]}) torch.equal to the channel alone (clusters of "
                f"{rows[1]}) and to its first {SHORT} frames alone (a "
                f"cluster of {rows[2]})")

    # 2. B2 vs plain.
    def p2():
        worst, lines = 0.0, []
        crop = slice(pad, pad + n)
        for name, fn in fns.items():
            got = b2.roundtrip_signal_cuda(
                padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
                fn.packed)
            sync()
            want = b2.roundtrip_signal_plain(
                padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
                fn.packed)
            finite(got[:, crop], (2, n))
            mask, left = ambiguous(fn)
            keep = ~b2.frames_cover(mask, HOP, NFFT, full)[:, crop]
            d = (got[:, crop] - want[:, crop]).abs()
            err = float(torch.where(keep, d, 0.0).max())
            snr = pt.snr_db(want[:, crop], got[:, crop])
            # An independent second reference: the function in float64 on
            # the host CPU; beside it the fp32 plain version there.
            keep_h = keep.cpu()
            ref = host_f64(fn, ola=True)[:, crop]
            diff = (got[:, crop].cpu().double() - ref).abs()
            err_f64 = float(torch.where(keep_h, diff, 0.0).max())
            i = int(diff.argmax())
            at = divmod(i, n)  # (channel, sample)
            host, note = host_fp32(fn, ola=True)
            err_host = float(torch.where(
                keep_h, (got[:, crop].cpu() - host[:, crop]).abs(), 0.0).max())
            lines.append(
                f"{name}: {left} ambiguous frames of {n_rows} left out; "
                f"max-abs {err:.3e} snr {snr:.1f} dB (all samples: max-abs "
                f"{float(d.max()):.3e}); vs float64 on the host CPU: max-abs "
                f"{err_f64:.3e} (all samples: {float(diff.max()):.3e} at "
                f"{at}, in an ambiguous frame: "
                f"{not bool(keep_h.reshape(-1)[i])}); vs the fp32 plain "
                f"version on the host CPU: max-abs {err_host:.3e} ({note})")
            worst = max(worst, err)
            check(err <= 1e-5 and snr >= 100.0 and err_f64 <= 1e-5
                  and err_host <= 1e-5 and left <= 1e-3 * n_rows, lines[-1])
        results["b2_err"] = worst
        gate = fns["noise_gate(-30)"].packed

        def b2_call(p, frames_):
            return b2.roundtrip_signal_cuda(p, NFFT, HOP, frames_, w32, norm,
                                            cfg.eps, p.shape[-1], gate)

        got = b2_call(padded64, n_frames)
        lines.append(batch_hold(got, b2_call(one64, n_frames),
                                b2_call(short64, SHORT), SHORT * HOP,
                                "B2 signal"))
        del got
        # Each GEMM's device time at the gate batch (torch.profiler), and
        # the TF32 rate it issues: rows and columns padded to whole tiles,
        # the k8 steps the plan runs, 2 accumulators x 3 passes x 2 FLOP.
        plan = b2.gemm_plan(BATCH * n_frames, NFFT)
        steps = 4 * (plan.k_stages - 1) + plan.k_last
        b2_call(padded64, n_frames)
        sync()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                b2_call(padded64, n_frames)
            sync()
        events = _device_events(prof)
        for inverse, cb in zip(("false", "true"), plan.col_blocks):
            t_ms = sum(us for name, (_, us) in events.items()
                       if "rt_gemm_kernel" in name and inverse in name
                       ) / REPS / 1e3
            check(t_ms > 0, f"no rt_gemm_kernel<{inverse}> in the trace")
            flop = (plan.row_blocks * b2.GEMM_ROWS * cb * b2.GEMM_COLS * 8
                    * steps * 12)
            key = "b2_gemm_inverse" if inverse == "true" else "b2_gemm_forward"
            results[key + "_ms"] = t_ms
            results[key + "_tflops"] = flop / t_ms / 1e9
            lines.append(
                f"time rt_gemm_kernel<{inverse}> at {BATCH} x 60 s: "
                f"{t_ms:.4f} ms, {flop / t_ms / 1e9:.1f} TFLOP/s TF32 issued "
                f"({flop / 1e12:.3f} TFLOP; clusters of {plan.cluster}, "
                f"{plan.stage_bytes} L2 bytes a CTA stage; torch.profiler, "
                f"mean of {REPS})")
        return "; ".join(lines)

    phase("2 B2 vs plain", p2)

    # Main path through the public entry points, counters reset just before.
    b1.launches = 0
    b2.launches = 0
    b0.launches = 0

    def p3():
        check(pt.formulation_for(cfg, None, n) == "blocked", "route")
        before = b0.launches
        y = pt.round_trip(x, cfg)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b0.launches == before + 1, "B0 not launched once")
        return f"route blocked, snr {snr:.2f} dB, B0 (3xTF32) launches +1"

    def p4():
        check(pt.formulation_for(cfg, band, n) == "blocked", "route")
        before = b0.launches
        y = pt.round_trip(x, cfg, band)
        finite(y, (2, n))
        want = _oracle(x_np, band.per_bin_gains(NFFT), cfg)
        snr = min(pt.snr_db(want[c], y[c, :SR]) for c in range(2))
        check(snr >= 80.0, f"snr vs f64 oracle {snr:.2f} dB")
        check(b0.launches == before + 1, "B0 not launched once")
        # The batch of `multich64.eq_resident`: the route writes the signal
        # once, and its bits are the composition's with three copies.
        g64 = torch.Generator(device=dev).manual_seed(SEED + 64)
        x64 = torch.rand((64, n), generator=g64, device=dev) * 2 - 1
        before = b0.launches
        y64 = pt.round_trip(x64, cfg, band)
        sync()
        launched = b0.launches - before
        check(launched == 1, f"{launched} B0 launches for 64 ch x 60 s")
        # The composition's own B0 launch is not the main path's: the
        # count printed after phase 6 leaves it out.
        counted = b0.launches
        want64 = _blocked_composition(x64, cfg, band)
        b0.launches = counted
        same = bool(torch.equal(y64, want64))
        check(same, "64 ch x 60 s: not torch.equal to the composition")
        return (f"route blocked, first 1 s vs f64 oracle {snr:.2f} dB, B0 "
                f"(3xTF32) launches +1; 64 ch x 60 s torch.equal to the "
                f"pad, F.pad and cat composition, B0 launches +1")

    def p5():
        before = b1.launches
        y = pt.istft(pt.stft(x, cfg), cfg, length=n)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b1.launches > before, "B1 not launched")
        return f"snr {snr:.2f} dB, B1 launches +{b1.launches - before}"

    def p6():
        gate = fns["noise_gate(-30)"]
        check(pt.formulation_for(cfg, gate, n) == "fused_rt_ola", "route")
        before = b2.launches
        y = pt.round_trip(x, cfg, gate)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b2.launches > before, "B2 not launched")
        return (f"route fused_rt_ola, snr {snr:.2f} dB, B2 launches "
                f"+{b2.launches - before}")

    phase("3 round_trip identity", p3)
    phase("4 round_trip band_gain", p4)
    phase("5 istft(stft)", p5)
    phase("6 round_trip noise_gate", p6)
    counts = {"b1": b1.launches, "b2": b2.launches, "b0": b0.launches}
    log(f"main-path launches: B0 {counts['b0']}, B1 {counts['b1']}, B2 "
        f"{counts['b2']}")
    if not all(counts.values()):
        failures.append("launch counts")
        log("FAIL launch counts: a kernel of the path was not launched")

    # 7. B3 vs plain.
    frames_fns = {"identity": None, **fns}

    def p7():
        worst, lines = 0.0, []
        for name, fn in frames_fns.items():
            packed = fn.packed if fn is not None else None
            got = b2.roundtrip_frames_cuda(padded, NFFT, HOP, n_frames, w32,
                                           packed)
            sync()
            want = b2.roundtrip_frames_plain(padded, NFFT, HOP, n_frames,
                                             w32, packed)
            finite(got, (2, n_frames, NFFT))
            mask, left = ambiguous(fn)
            keep = ~mask[..., None]
            err = float(torch.where(keep, (got - want).abs(), 0.0).max())
            snr = pt.snr_db(want, got)
            err_f64 = float(torch.where(
                keep.cpu(), (got.cpu().double() - host_f64(fn, False)).abs(),
                0.0).max())
            host, note = host_fp32(fn, ola=False)
            err_host = float(torch.where(keep.cpu(), (got.cpu() - host).abs(),
                                         0.0).max())
            lines.append(f"{name}: {left} ambiguous frames of {n_rows} left "
                         f"out; max-abs {err:.3e} snr {snr:.1f} dB (all "
                         f"frames: {float((got - want).abs().max()):.3e}); "
                         f"vs float64 on the host CPU: max-abs {err_f64:.3e}; "
                         f"vs the fp32 plain version on the host CPU: max-abs "
                         f"{err_host:.3e} ({note})")
            worst = max(worst, err)
            check(err <= 1e-5 and err_f64 <= 1e-5 and err_host <= 1e-5
                  and snr >= 100.0 and left <= 1e-3 * n_rows, lines[-1])
        # A signal shorter than its frames' span: reads past its end are 0.
        short = padded[:, :5000].contiguous()
        got = b2.roundtrip_frames_cuda(short, NFFT, HOP, 30, w32, None)
        host = b2.roundtrip_frames_plain(short.cpu(), NFFT, HOP, 30,
                                         w32.cpu(), None)
        err = float((got.cpu() - host).abs().max())
        lines.append(f"short signal (30 frames over 5000 samples): max-abs "
                     f"{err:.3e} vs plain on the host CPU")
        check(err <= 1e-5, lines[-1])
        results["b3_err"] = worst
        gate = fns["noise_gate(-30)"].packed

        def b3_call(p, frames_):
            return b2.roundtrip_frames_cuda(p, NFFT, HOP, frames_, w32, gate)

        lines.append(batch_hold(b3_call(padded64, n_frames),
                                b3_call(one64, n_frames),
                                b3_call(short64, SHORT), SHORT, "B3 frames"))
        # The library's plan (crlot_rt_plan) is fused_rt.gemm_plan.
        import ctypes

        lib = cuda_build.load_library()
        got = (ctypes.c_int * 6)()
        for rows in (1, 127, 128, 129, 511, 512, 11251, BATCH * n_frames):
            for nfft in (4, 8, 256, 512, 1024, 2048, 4096):
                check(lib.crlot_rt_plan(rows, nfft, got) == 0, "plan refused")
                pl = b2.gemm_plan(rows, nfft)
                want = (pl.cluster, pl.stage_bytes, pl.k_last, pl.row_groups,
                        *pl.col_blocks)
                check(tuple(got) == want, f"crlot_rt_plan({rows}, {nfft}) "
                      f"{tuple(got)} != gemm_plan's {want}")
        lines.append("crlot_rt_plan == gemm_plan at 56 shapes")
        return "; ".join(lines)

    phase("7 B3 vs plain", p7)
    del padded64, one64, short64

    # The fused-frames and sharded path, counters reset just before.
    cfg_frames = dataclasses.replace(cfg, fused_roundtrip=True)
    cfg_nc = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)
    x9 = x[:, :T_SHARDED].contiguous()
    x9_np = x_np[:, :T_SHARDED]
    mesh22 = pt.make_mesh(channel=2, time=2, devices=[dev] * 4)
    mesh11 = pt.make_mesh(channel=1, time=1, devices=[dev])
    inner = slice(NFFT, T_SHARDED - NFFT)
    b1.launches = 0
    b2.launches = 0
    b2.frames_launches = 0
    b0.launches = 0
    b0f.launches = 0

    def p8():
        check(pt.formulation_for(cfg_frames, None, n) == "fused_rt_frames",
              "route")
        b1_0, b3_0 = b1.launches, b2.frames_launches
        y = pt.round_trip(x, cfg_frames)
        finite(y, (2, n))
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"snr {snr:.2f} dB")
        check(b2.frames_launches > b3_0 and b1.launches > b1_0,
              "B3 or B1 not launched")
        return (f"route fused_rt_frames, snr {snr:.2f} dB, B3 launches "
                f"+{b2.frames_launches - b3_0}, B1 +{b1.launches - b1_0}")

    def p9():
        gate = fns["noise_gate(-30)"]
        check(spl.shard_route(cfg_nc, gate) == "fused_rt_frames", "route")
        before = b2.frames_launches
        y = pt.sharded_round_trip(x9, cfg_nc, mesh22, gate)
        sync()
        launched = b2.frames_launches - before
        finite(y, (2, T_SHARDED))
        check(launched == 4, f"{launched} B3 launches for 4 shards")
        one = pt.sharded_round_trip(x9, cfg_nc, mesh11, gate)
        check(torch.equal(y, one), "(2, 2) mesh != (1, 1) mesh")
        check(pt.formulation_for(cfg_nc, gate, T_SHARDED) == "fused_rt_ola",
              "one-shot route")
        shot = pt.round_trip(x9, cfg_nc, gate)
        err = float((y[:, inner] - shot[:, inner]).abs().max())
        same = torch.equal(y[:, inner], shot[:, inner])
        results["sharded_b2_err"] = err
        check(err <= 1e-5, f"vs one-shot B2: max-abs {err:.3e}")
        return (f"B3 launches +{launched}; (2, 2) == (1, 1) bit for bit; "
                f"vs one-shot B2 over [N, T-N): max-abs {err:.3e}, "
                f"bit-identical {same}")

    def p10():
        with EdgePatchHold(check) as hold:
            return p10_held(hold)

    def p10_held(hold):
        calls = []
        orig = spl._blocked_local_round_trip

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        spl._blocked_local_round_trip = spy
        before = b0.launches
        try:
            y, metrics = pt.sharded_round_trip(x9, cfg_nc, mesh22,
                                               return_metrics=True)
        finally:
            spl._blocked_local_round_trip = orig
        launched = b0.launches - before
        held = hold.verify()
        check(held["HIGH"] == 4, f"{held['HIGH']} edge patches held on the "
              f"(2, 2) mesh, 4 expected")
        check(len(calls) == 2, f"blocked route engaged {len(calls)} times")
        # Each shard: its interior rows, then its head and tail rows once
        # the halos are in; and each channel group's two edge patches.
        check(launched == 12, f"{launched} B0 launches for 4 shards x 2 "
              f"and 2 x 2 edge patches")
        finite(y, (2, T_SHARDED))
        one = pt.sharded_round_trip(x9, cfg_nc, mesh11)
        held = hold.verify()
        check(held["HIGH"] == 2, f"{held['HIGH']} edge patches held on the "
              f"(1, 1) mesh, 2 expected")
        ones = np.ones(NFFT // 2 + 1)
        edges = [edge_check(check, "HIGH", x9, y, cfg_nc, ones)]
        snr = pt.snr_db(x9_np[:, inner], y[:, inner])
        check(snr >= 60.0, f"interior snr {snr:.2f} dB")
        check(torch.equal(y, one),
              f"(2, 2) mesh != (1, 1), max-abs "
              f"{float((y - one).abs().max()):.3e}")
        mesh_snr = pt.metrics_report(metrics)["snr_db"]
        host_snr = pt.snr_db(x9_np, y)
        check(abs(mesh_snr - host_snr) < 0.01,
              f"metrics snr {mesh_snr:.4f} vs host {host_snr:.4f}")
        # HIGHEST: B0's fp32 kernel, one fmaf chain an output.
        cfg_hst = dataclasses.replace(
            cfg_nc, fft_precision=pt.FftPrecision.HIGHEST)
        before = b0f.launches
        y_h = pt.sharded_round_trip(x9, cfg_hst, mesh22)
        launched_h = b0f.launches - before
        check(launched_h == 12, f"{launched_h} fp32 B0 launches for 4 "
              f"shards x 2 and 2 x 2 edge patches")
        one_h = pt.sharded_round_trip(x9, cfg_hst, mesh11)
        held = hold.verify()
        check(held["HIGHEST"] == 6, f"{held['HIGHEST']} fp32 edge patches "
              f"held on (2, 2) and (1, 1), 6 expected")
        edges.append(edge_check(check, "HIGHEST", x9, y_h, cfg_hst, ones))
        check(torch.equal(y_h, one_h),
              f"HIGHEST: (2, 2) mesh != (1, 1), max-abs "
              f"{float((y_h - one_h).abs().max()):.3e}")
        snr_h = pt.snr_db(x9_np[:, inner], y_h[:, inner])
        check(snr_h >= 60.0, f"HIGHEST interior snr {snr_h:.2f} dB")
        return (f"blocked engaged, B0 (3xTF32) launches +{launched}; "
                f"interior snr {snr:.2f} dB; (2, 2) == (1, 1) bit for bit; "
                f"metrics snr {mesh_snr:.4f} dB vs host {host_snr:.4f} dB; "
                f"HIGHEST: B0 fp32 launches +{launched_h}, (2, 2) == (1, 1) "
                f"bit for bit, interior snr {snr_h:.2f} dB; "
                f"{hold.summary()}; " + "; ".join(edges))

    phase("8 round_trip fused_roundtrip", p8)
    phase("9 sharded noise_gate (B3)", p9)
    phase("10 sharded identity (blocked)", p10)
    counts2 = {"b1": b1.launches, "b3": b2.frames_launches, "b0": b0.launches,
               "b0_fp32": b0f.launches}
    log(f"fused-frames and sharded path launches: B3 {counts2['b3']}, "
        f"B1 {counts2['b1']}, B0 {counts2['b0']}, B0 fp32 "
        f"{counts2['b0_fp32']}")
    if not all(counts2.values()):
        failures.append("launch counts (path 2)")
        log("FAIL launch counts: a kernel of the path was not launched")

    path3 = resample_path(dev, phase, check, failures)
    path_b6 = b6_checks(dev, phase, check)
    path_b0 = b0_checks(dev, phase, check, cfg, padded, n_frames, band)
    path4 = wire_path(dev, phase, check, failures)
    path5 = int8_tier_path(dev, phase, check, failures, x, x_np)
    path6 = stream_path(dev, phase, check, failures, x_np)
    path7 = analysis_path(dev, phase, check, failures, x_np)
    path8 = last_analysis_path(dev, phase, check, failures, x_np)
    path9 = multiprocess_path(dev, phase, check, failures, x_np)
    path10 = tooling_path(dev, phase, check, failures, x_np, path6)
    path11 = routes_path(dev, phase, check, failures, x, x_np)
    large_frames_path(dev, phase, check, failures)
    seeded_ola_path(dev, phase, check, failures)
    chain_stream_path(dev, phase, check, failures)
    stft_b7_path(dev, phase, check, failures)

    # Timings.
    def e2e_rate(fn, samples=2 * n):
        return samples / e2e_seconds(fn)

    gate = fns["noise_gate(-30)"]
    timing = {}
    try:
        timed(timing, "b1",
              lambda: b1.ola_normalized_cuda(frames, norm, HOP, full, cfg.eps))
        timed(timing, "b1_plain",
              lambda: b1.ola_normalized_plain(frames, norm, HOP, full, cfg.eps))
        timed(timing, "b2", lambda: b2.roundtrip_signal_cuda(
            padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
            gate.packed))
        timed(timing, "b2_plain", lambda: b2.roundtrip_signal_plain(
            padded, NFFT, HOP, n_frames, w32, norm, cfg.eps, full,
            gate.packed))
        timed(timing, "b3", lambda: b2.roundtrip_frames_cuda(
            padded, NFFT, HOP, n_frames, w32, gate.packed))
        timed(timing, "b3_plain", lambda: b2.roundtrip_frames_plain(
            padded, NFFT, HOP, n_frames, w32, gate.packed))
        x_ext, kern0, bt0, rows0, gh0 = path_b0["inputs"]
        blocks0 = x_ext.reshape(x_ext.shape[0], -1, gh0)

        def b0_loop():  # the former route: mg cuBLAS fp32 GEMMs and adds
            acc = None
            for m in range(kern0.shape[0] // gh0):
                t = torch.matmul(blocks0[:, m : m + rows0],
                                 kern0[m * gh0 : (m + 1) * gh0])
                acc = t if acc is None else acc + t
            return acc

        timed(timing, "b0", lambda: b0.gemm_cuda(x_ext, *bt0, rows=rows0,
                                                 lda=gh0))
        timed(timing, "b0_plain", lambda: b0.gemm_plain(
            x_ext, *bt0, rows=rows0, lda=gh0))
        timed(timing, "b0_library", b0_loop)
        timing["rt_identity"] = e2e_rate(lambda: pt.round_trip(x, cfg))
        timing["rt_gate"] = e2e_rate(lambda: pt.round_trip(x, cfg, gate))
        timing["rt_frames"] = e2e_rate(lambda: pt.round_trip(x, cfg_frames))
        for name, mesh in (("sharded_11", mesh11), ("sharded_22", mesh22)):
            timing[name] = e2e_rate(
                lambda: pt.sharded_round_trip(x9, cfg_nc, mesh, gate),
                2 * T_SHARDED)
        log(f"time B1 kernel {ms(timing, 'b1')}, plain "
            f"{ms(timing, 'b1_plain')}; the former design {OLD_MS['K1']} in "
            f"PERF.md ([2, {n_frames}, {NFFT}] frames; CUDA events, median "
            f"of {REPS}, queued)")
        log(f"time B2 kernel {ms(timing, 'b2')} (3xTF32 wgmma: fold, "
            f"forward, inverse, then B1's OLA), plain "
            f"{ms(timing, 'b2_plain')}; the former design {OLD_MS['K2']} "
            f"in PERF.md (noise_gate, 2 x {SECONDS} s; CUDA events, median "
            f"of {REPS}, queued)")
        log(f"time B3 kernel {ms(timing, 'b3')} (3xTF32 wgmma: fold, "
            f"forward, inverse), plain {ms(timing, 'b3_plain')}; the former "
            f"design {OLD_MS['K3']} in PERF.md (noise_gate, [2, {n_frames}, "
            f"{NFFT}] frames; CUDA events, median of {REPS}, queued)")
        log(f"time B0 kernel {ms(timing, 'b0')} (3xTF32, {x_ext.shape[0]} x "
            f"{rows0} windows x {gh0}, K {kern0.shape[0]}), plain emulation "
            f"{ms(timing, 'b0_plain')}, the former cuBLAS fp32 loop "
            f"{ms(timing, 'b0_library')} in this run; {OLD_MS['B0']}")
        roof = path9["results"].get("roofline")
        if roof is not None:
            b0_rate = x_ext.shape[0] * rows0 * gh0 / (timing["b0"] / 1e3)
            log(f"B0 at {b0_rate:.4e} output samples/s (the main path's "
                f"windows over its CUDA-event time) against the blocked "
                f"round-trip's roofline {roof['roofline_samples_per_sec']:.4e}"
                f" samples/s ({roof['flops_per_sample']:.0f} FLOP a sample "
                f"at TF32 / 3; `profiling.roofline_samples_per_sec`): "
                f"{b0_rate / roof['roofline_samples_per_sec']:.3f} of it")
        log(f"e2e round_trip identity {timing['rt_identity']:.4e} samples/s; "
            f"noise_gate {timing['rt_gate']:.4e} samples/s; fused_roundtrip "
            f"{timing['rt_frames']:.4e} samples/s (host clock, "
            f"synchronized, median of {REPS})")
        log(f"e2e sharded noise_gate (B3 route), 2 x {T_SHARDED} samples: "
            f"(1, 1) mesh {timing['sharded_11']:.4e} samples/s; (2, 2) mesh "
            f"on one card, shards run in turn, {timing['sharded_22']:.4e} "
            f"samples/s (host clock, synchronized, median of {REPS})")
        timed(timing, "b0_fp32", lambda: b0f.gemm_cuda(
            x_ext, kern0, rows=rows0, lda=gh0))
        timed(timing, "b0_fp32_plain", lambda: b0f.gemm_plain(
            x_ext, kern0, rows=rows0, lda=gh0))
        log(f"time B0 fp32 kernel (HIGHEST, fmaf chains) {ms(timing, 'b0_fp32')}"
            f", plain (float64 product) {ms(timing, 'b0_fp32_plain')}, the "
            f"former cuBLAS fp32 loop {ms(timing, 'b0_library')} in this run "
            f"(the same {x_ext.shape[0]} x {rows0} windows)")
        xq, bh, bl, cs = path5["inputs"]
        timed(timing, "k11_ref", lambda: b6.fusedq_ref_gemm_cuda(
            xq, bh, bl, cs))
        timed(timing, "k11_ref_plain", lambda: b6.fusedq_ref_gemm_plain(
            xq, bh, bl, cs))
        timing["rt_tiled_i8"] = e2e_rate(
            lambda: pt.round_trip(x, path5["cfg"]))
        timing["rt_tiled"] = e2e_rate(
            lambda: pt.round_trip(x, path5["cfg_hi"]))
        log(f"time K11 (dot_i8x2's variant) at the tiled route's "
            f"{xq.shape[0]} x {xq.shape[1]} x {bh.shape[0]} (one of its four "
            f"launches a call) {ms(timing, 'k11_ref')}, plain "
            f"{ms(timing, 'k11_ref_plain')}; e2e round_trip N {NFFT} H 480: "
            f"tiled_i8 {timing['rt_tiled_i8']:.4e} samples/s, tiled (HIGH, "
            f"fp32 products) {timing['rt_tiled']:.4e} samples/s (host clock, "
            f"synchronized, median of {REPS})")
        timing.update(resample_timings(dev, path3))
        timing.update(wire_timings(dev, path4, path_b6))
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    except Exception as e:
        failures.append("timings")
        log(f"FAIL timings: {type(e).__name__}: {e}")

    if failures:
        log(f"chip_smoke: {len(failures)} phase(s) failed: {failures}")
        return 1
    # Bounds from this run's inputs. The folded DFT round-trip of B2 / B3
    # does four products per frame: 4 * frames * (N/2 + 1) * N * 2 / 2.
    from crlot_tpu_torch.resample import kernel as b4

    tf32_bases = b2.kernel_bases_on(NFFT, dev)
    dft_ops = 4.0 * 2 * n_frames * (NFFT // 2 + 1) * NFFT
    # B2 and B3: 3 TF32 products per f32 product; beside it, the bound of
    # the same f32 products on the FMA pipe (the former design's).
    b23_fp32 = {"bound_fp32_ms": dft_ops / PEAK_OPS["fp32"] * 1e3}
    x_ext, kern0, bt0, rows0, gh0 = path_b0["inputs"]
    b0_ops = 2.0 * x_ext.shape[0] * rows0 * gh0 * kern0.shape[0]
    x44, l44, m44, n44 = path3["geometry"]["44.1->48"]
    taps44, offs44, _, _ = b4.compact_bank(l44, m44, None, 120.0)
    pt_ = path_b6["probe_inputs"]
    f_, n_ = pt_["x_f32"].shape
    k_ = pt_["bt_i8"].shape[0]
    out_f32 = f_ * k_ * 4
    probe_rows = {r["variant"]: r for r in path4["probe"]["rows"]
                  if "variant" in r}

    def probe_ms(name):
        return probe_rows[name]["us_per_call"] / 1e3

    def probe_lib(name):
        us = probe_rows[name]["library_us"]
        return None if us is None else us / 1e3

    n5 = 4 * N_B5
    kernels = [
        {"name": "hopblock_apply (B0)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/b6_sm90.cu",
         "replaces": "crlot_tpu/fft/matmul_backend.py:633",
         "launches": (counts["b0"] + path6["counts"]["b0"]
                      + path9["counts"]["b0"] + path10["counts"]["B0"]
                      + path11["counts"]["b0"]),
         "max_abs_err": path_b0["err"],
         "ms": timing["b0"], "plain_ms": timing["b0_plain"],
         **bound(nbytes(x_ext, *bt0) + x_ext.shape[0] * rows0 * gh0 * 4,
                 3 * b0_ops, "tf32"),
         "bound_fp32_ms": b0_ops / PEAK_OPS["fp32"] * 1e3,
         "library_ms": timing["b0_library"]},
        {"name": "ola_normalized (B1)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/ola_fused.cu",
         "replaces": "crlot_tpu/ola/fused.py:39",
         "launches": (counts["b1"] + path7["counts"]["b1"]
                      + path8["counts"]["b1"] + path10["counts"]["B1"]
                      + path11["counts"]["b1"]),
         "max_abs_err": results["b1_err"], "ms": timing["b1"],
         "plain_ms": timing["b1_plain"],
         **bound(nbytes(frames, norm) + 2 * full * 4, frames.numel()),
         "library_ms": None},
        {"name": "rt_ola (B2)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/fused_rt.cu",
         "replaces": "crlot_tpu/fft/pallas_rt.py:429",
         "launches": counts["b2"] + path10["counts"]["B2"],
         "max_abs_err": results["b2_err"],
         "ms": timing["b2"], "plain_ms": timing["b2_plain"],
         **bound(nbytes(padded, w32, norm, *tf32_bases) + 2 * full * 4,
                 3 * dft_ops, "tf32"), **b23_fp32,
         "library_ms": None},
        {"name": "rt_frames (B3)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/fused_rt.cu",
         "replaces": "crlot_tpu/fft/pallas_rt.py:277",
         "launches": (counts2["b3"] + path6["counts"]["b3"]
                      + path9["counts"]["b3"] + path10["counts"]["B3"]),
         "max_abs_err": results["b3_err"],
         "ms": timing["b3"], "plain_ms": timing["b3_plain"],
         **bound(nbytes(padded, w32, *tf32_bases) + 2 * n_frames * NFFT * 4,
                 3 * dft_ops, "tf32"), **b23_fp32,
         "library_ms": None},
        {"name": "resample (B4)", "route": "cuda",
         "source": "crlot_tpu_torch/csrc/resample.cu",
         "replaces": "crlot_tpu/resample/pallas_kernel.py:32",
         "launches": (path3["counts"]["b4"] + path8["counts"]["b4"]
                      + path10["counts"]["B4"]),
         "max_abs_err": max(path3["results"]["b4_err"],
                            path_b6["results"]["b4_300_err"]),
         "ms": timing["b4_44.1->48"], "plain_ms": timing["b4_44.1->48_bank"],
         **bound(nbytes(x44) + x44.shape[0] * n44 * 4 + taps44.nbytes
                 + offs44.nbytes, 2.0 * x44.shape[0] * n44 * taps44.shape[0]),
         "library_ms": timing["b4_conv1d"]},
    ]
    b5_io = {"axpy": 3, "axpy_windowed": 4, "normalize_and_clear": 4}
    b5_lib = {"axpy": timing["axpy_library"],
              "axpy_windowed": timing["axpy_windowed_library"],
              "normalize_and_clear": None}
    for name, line, k5 in (("axpy", 84, "K4"), ("axpy_windowed", 135, "K5"),
                           ("normalize_and_clear", 182, "K6")):
        kernels.append({
            "name": f"{name} (B5)", "route": "cuda",
            "source": "crlot_tpu_torch/csrc/ola_kernels.cu",
            "replaces": f"crlot_tpu/ola/kernels.py:{line}",
            "launches": path3["counts"][name] + path10["counts"][k5] + (
                path6["counts"]["k6"] if name == "normalize_and_clear" else 0),
            "max_abs_err": path3["results"][f"{name}_err"],
            "ms": timing[name], "plain_ms": timing[f"{name}_plain"],
            **bound(b5_io[name] * n5, 2.0 * N_B5),
            "library_ms": b5_lib[name]})
    probe_src = "scripts/bench_pallas_int8_probe.py"
    kernels.append({
        "name": "hopblock_apply fp32 (B0, HIGHEST)", "route": "cuda",
        "source": "crlot_tpu_torch/csrc/fp32_window.cu",
        "replaces": "crlot_tpu/fft/matmul_backend.py:633",
        "launches": (counts2["b0_fp32"] + path4["counts"]["b0_fp32"]
                     + path6["counts"]["b0_fp32"]
                     + path7["counts"]["b0_fp32"]
                     + path8["counts"]["b0_fp32"]
                     + path10["counts"]["B0_fp32"]),
        "max_abs_err": path_b0["fp32_err"], "ms": timing["b0_fp32"],
        "plain_ms": timing["b0_fp32_plain"],
        **bound(nbytes(x_ext, kern0) + x_ext.shape[0] * rows0 * gh0 * 4,
                b0_ops, "fp32"),
        "library_ms": timing["b0_library"]})
    xq, bh, bl, cs = path5["inputs"]
    mq, kq, nq = xq.shape[0], xq.shape[1], bh.shape[0]
    kernels.append({
        "name": "dot_i8x2 (B6, K11, the reference's variant)",
        "route": "cuda", "source": "crlot_tpu_torch/csrc/b6_sm90.cu",
        "replaces": f"{probe_src}:64",
        "launches": (path5["counts"]["k11_ref"]
                     + path10["counts"]["B6_fusedq_ref"]),
        "max_abs_err": path5["results"]["err"], "ms": timing["k11_ref"],
        "plain_ms": timing["k11_ref_plain"],
        **bound(nbytes(xq, bh, bl, cs) + mq * nq * 4, 6.0 * mq * kq * nq,
                "int8"),
        "library_ms": None})
    b6_rows = [
        ("bf16 (B6, K8)", "bf16", "pl_bf16", 32,
         bound(2 * f_ * n_ + 2 * k_ * n_ + out_f32, 2.0 * f_ * n_ * k_,
               "bf16")),
        ("i8 (B6, K9)", "i8", "pl_i8", 41,
         bound(f_ * n_ + k_ * n_ + out_f32, 2.0 * f_ * n_ * k_, "int8")),
        ("limb (B6, K10)", "limb", "pl_i8_3dot", 50,
         bound(2 * f_ * n_ + 2 * k_ * n_ + out_f32, 6.0 * f_ * n_ * k_,
               "int8")),
        ("fusedq (B6, K11)", "fusedq", "pl_i8_fusedq", 64,
         bound(4 * f_ * n_ + 2 * k_ * n_ + out_f32, 6.0 * f_ * n_ * k_,
               "int8")),
    ]
    for name, key, variant, line, bnd in b6_rows:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "crlot_tpu_torch/csrc/b6_sm90.cu",
            "replaces": f"{probe_src}:{line}",
            "launches": path4["counts"][key] + path10["counts"][f"B6_{key}"],
            "max_abs_err": path_b6["results"][variant],
            "ms": probe_ms(variant), "plain_ms": timing[f"{variant}_plain"],
            **bnd, "library_ms": probe_lib(variant)})
    log(f"K10 at the probe shape {probe_ms('pl_i8_3dot'):.4f} ms (TMA + "
        f"wgmma); the former mma.sync design {OLD_MS['K10 probe']} in "
        f"PERF.md")
    log(f"K11 at the probe shape {probe_ms('pl_i8_fusedq'):.4f} ms (row "
        f"scale pass, then TMA + wgmma with the limbs made in registers); "
        f"the former design {OLD_MS['K11 probe']} in PERF.md")
    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
        f"(kernel build included)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def resample_path(dev, phase, check, failures, seconds=SECONDS) -> dict:
    """Phases 11-17 on 2 x `seconds` at 44.1 kHz: B4 and B5 against their
    plain versions, then the resample and demo path through the public
    entry points with the B4 and B5 counters reset just before. Returns
    the inputs, errors and main-path launch counts for the timings."""
    import os
    import tempfile

    import numpy as np
    import torch
    from scipy import signal as sps

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import demo
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.ola import kernels as b5
    from crlot_tpu_torch.resample import kernel as b4
    from crlot_tpu_torch.resample.polyphase import (
        _kernel_bank, design_lowpass, output_length)

    n = SR_IN * seconds
    rng = np.random.default_rng(SEED)
    noise_np = rng.uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    noise48_np = rng.uniform(-1.0, 1.0, (2, 48000 * seconds)).astype(
        np.float32)
    t = np.arange(n, dtype=np.float64) / SR_IN
    freqs = np.array([[997.0], [1000.0]])
    sines_np = (0.7 * np.sin(2 * np.pi * freqs * t)).astype(np.float32)
    noise, noise48, sines = (torch.from_numpy(a).to(dev)
                             for a in (noise_np, noise48_np, sines_np))
    rates = {"44.1->48": (44100, 48000, noise), "48->16": (48000, 16000, noise48)}
    geometry = {}
    for key, (sr_in, sr_out, x) in rates.items():
        g = math.gcd(sr_in, sr_out)
        geometry[key] = (x, sr_out // g, sr_in // g,
                         output_length(x.shape[-1], sr_in, sr_out))
    results = {}

    # 11. B4 vs plain.
    def p11():
        lines = []
        for key, (sr_in, sr_out, _) in rates.items():
            x, l, m, n_out = geometry[key]
            got = b4.resample_cuda(x, l, m, n_out)
            want = b4.resample_bank_plain(x, l, m, n_out)
            check(tuple(got.shape) == (2, n_out), f"shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), "non-finite output")
            err = float((got - want).abs().max())
            host = b4.resample_bank_plain(x.cpu(), l, m, n_out)
            got_h = got.cpu()
            err_host = float((got_h - host).abs().max())
            _, _, w = _kernel_bank(l, m, None, 120.0)
            h = design_lowpass(l, m)
            prefix = x[:, : sr_in + w].cpu().numpy().astype(np.float64)
            oracle = sps.resample_poly(prefix, l, m, window=h / l, axis=-1)
            k = output_length(sr_in, sr_in, sr_out)
            snr = min(pt.snr_db(oracle[c, :k], got_h[c, :k].numpy())
                      for c in range(2))
            lines.append(f"{key}: max-abs {err:.3e} (bit-identical "
                         f"{torch.equal(got, want)}; vs plain on the host "
                         f"CPU {err_host:.3e}); first 1 s vs f64 scipy "
                         f"{snr:.2f} dB")
            results["b4_err"] = max(results.get("b4_err", 0.0), err)
            check(err <= 1e-5 and err_host <= 1e-5 and snr >= 120.0,
                  lines[-1])
        return "; ".join(lines)

    # 12. B5 vs plain.
    def same(a, b):
        return (torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))

    def p12():
        worst = {"axpy": 0.0, "axpy_windowed": 0.0, "normalize_and_clear": 0.0}
        for size in SIZES + [N_B5]:
            g = torch.Generator(device=dev).manual_seed(size)
            a, b, c = (torch.rand(size + 1, generator=g, device=dev) * 4 - 2
                       for _ in range(3))
            norm = c.abs()
            norm[::5] = 0.0
            norm[3::7] = float("nan")
            for off in (0, 1):  # 16-byte aligned (float4 path) and not
                av, bv, cv, nv = (v[off : off + size] for v in (a, b, c, norm))
                pairs = {
                    "axpy": (b5.axpy_cuda(av, bv, 1.5),
                             b5.axpy_reference(av, bv, 1.5)),
                    "axpy_windowed": (b5.axpy_windowed_cuda(av, bv, cv, 0.75),
                                      b5.axpy_windowed_reference(av, bv, cv,
                                                                 0.75)),
                }
                out, cleared = b5.normalize_and_clear_cuda(av, nv, 1e-8)
                pairs["normalize_and_clear"] = (
                    out, b5.normalize_and_clear_reference(av, nv, 1e-8)[0])
                check(not bool(cleared.any()), f"cleared not zero, n={size}")
                for name, (got, want) in pairs.items():
                    check(same(got, want),
                          f"{name} n={size} offset {off}: not bit-identical")
                    diff = (got - want).nan_to_num(0.0).abs().max()
                    worst[name] = max(worst[name], float(diff))
        rows = b5.normalize_and_clear_cuda(
            torch.tensor([1.0, 1.0, -3.0], device=dev),
            torch.tensor([float("nan"), 0.0, 2.0], device=dev), 0.5)[0]
        check(bool(torch.isnan(rows[0])) and rows[1:].tolist() == [2.0, -1.5],
              f"NaN / zero norm rows: {rows.tolist()}")
        for name, err in worst.items():
            results[f"{name}_err"] = err
        return (f"axpy, axpy_windowed, normalize_and_clear bit-identical to "
                f"plain over {len(SIZES)} sizes and n={N_B5}, aligned and "
                f"misaligned; NaN and zero norm rows as plain")

    phase("11 B4 vs plain", p11)
    phase("12 B5 vs plain", p12)

    # The resample and demo path, counters reset just before.
    b4.launches = 0
    b0.launches = 0
    for name in b5.launches:
        b5.launches[name] = 0
    cfg15 = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)

    def ideal(sr, length, f):
        return 0.7 * np.sin(2 * np.pi * f * np.arange(length) / sr)

    def p13():
        before = b4.launches
        y48 = pt.resample(sines, 44100, 48000)
        y16 = pt.resample(y48, 48000, 16000)
        launched = b4.launches - before
        check(launched == 2, f"{launched} B4 launches for 2 stages")
        n48, n16 = output_length(n, 44100, 48000), output_length(
            output_length(n, 44100, 48000), 48000, 16000)
        check(tuple(y48.shape) == (2, n48) and tuple(y16.shape) == (2, n16),
              f"lengths {tuple(y48.shape)} {tuple(y16.shape)}")
        y48_h, y16_h = y48.cpu().numpy(), y16.cpu().numpy()
        snr48 = pt.snr_db(ideal(48000, n48, 1000.0)[4800:-4800],
                          y48_h[1, 4800:-4800])
        snr16 = pt.snr_db(ideal(16000, n16, 997.0)[1600:-1600],
                          y16_h[0, 1600:-1600])
        msg = (f"B4 launches +{launched}; 44.1 -> 48 kHz 1 kHz sine "
               f"{snr48:.2f} dB; chain 997 Hz {snr16:.2f} dB")
        check(snr48 >= 100.0 and snr16 >= 90.0, msg)
        return msg

    def p14():
        chunk = 65536
        before = b4.launches
        got = pt.resample_chunked(noise, 44100, 48000, chunk=chunk)
        launched = b4.launches - before
        n_chunks = -(-n // chunk)
        check(launched == n_chunks, f"{launched} B4 launches, {n_chunks} chunks")
        one = pt.resample(noise, 44100, 48000)
        check(got.device == dev and torch.equal(got, one),
              f"chunked != one-shot, max-abs "
              f"{float((got - one).abs().max()):.3e}")
        host = pt.resample_chunked(noise_np, 44100, 48000, chunk=chunk,
                                   device=dev)
        check(isinstance(host, np.ndarray)
              and np.array_equal(host, one.cpu().numpy()),
              "numpy input on the card != one-shot")
        return (f"torch.equal to one-shot, tensor and numpy input; B4 "
                f"launches +{launched} for {n_chunks} chunks")

    def p15():
        before = b4.launches
        spec = pt.resampled_stft(noise, 44100, 48000, cfg15)
        check(b4.launches > before, "B4 not launched")
        seq = pt.stft(pt.resample(noise, 44100, 48000), cfg15)
        n48 = output_length(n, 44100, 48000)
        shape = (2, cfg15.frame_spec.num_frames(n48), NFFT // 2 + 1)
        check(tuple(spec.shape) == shape, f"shape {tuple(spec.shape)}")
        err = float((spec - seq).abs().max())
        scale = float(seq.abs().max())
        check(err <= 1e-5 * scale, f"max-abs {err:.3e}, scale {scale:.3e}")
        return f"{tuple(spec.shape)} max-abs {err:.3e} (scale {scale:.3e})"

    def p16():
        taps = (np.hamming(255) / 127.0).astype(np.float32)
        before = b0.launches
        y = pt.convolve(noise48, taps, "same")
        check(b0.launches == before + 1, "B0 not launched once")
        check(tuple(y.shape) == tuple(noise48.shape), f"shape {tuple(y.shape)}")
        k = 48000
        worst = 0.0
        for c in range(2):
            want = np.convolve(noise48_np[c, : k + 255].astype(np.float64),
                               taps.astype(np.float64), "full")[127 : 127 + k]
            got = y[c, :k].cpu().numpy()
            rel = np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))
            worst = max(worst, float(rel))
        check(worst < 1e-5, f"rel RMSE {worst:.3e}")
        return (f"first 1 s vs f64 numpy.convolve: rel RMSE {worst:.3e}; "
                f"B0 (3xTF32) launches +1")

    demo_wall = []

    def p17():
        with tempfile.TemporaryDirectory() as tmp:
            wav = os.path.join(tmp, "in.wav")
            pt.write_wav(wav, 0.5 * sines_np + 0.05 * noise_np, SR_IN,
                         bits=16)
            b4_0, axw_0 = b4.launches, b5.launches["axpy_windowed"]
            t0 = time.perf_counter()
            rc = demo.main([wav, "--out-dir", tmp, "--device", str(dev)])
            demo_wall.append(time.perf_counter() - t0)
            check(rc == 0, f"demo exit code {rc}")
            check(b4.launches > b4_0 and b5.launches["axpy_windowed"] > axw_0,
                  "B4 or axpy_windowed not launched")
            y, sr = pt.read_wav(os.path.join(tmp, "resampled_48000.wav"))
            want = output_length(n, SR_IN, 48000)
            check(sr == 48000 and y.shape[-1] == want,
                  f"resampled wav {y.shape} @ {sr}")
        return (f"exit 0 in {demo_wall[0]:.3f} s; B4 launches "
                f"+{b4.launches - b4_0}; resampled wav {want} frames")

    phase("13 resample chain", p13)
    phase("14 resample_chunked", p14)
    phase("15 resampled_stft", p15)
    phase("16 convolve", p16)
    phase("17 demo", p17)
    counts = {"b4": b4.launches, **b5.launches, "b0": b0.launches}
    log("resample and demo path launches: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()))
    if not all(counts.values()):
        failures.append("launch counts (path 3)")
        log("FAIL launch counts: a kernel of the path was not launched")
    return {"counts": counts, "results": results, "geometry": geometry,
            "noise": noise, "sines": sines, "cfg": cfg15,
            "demo_wall": demo_wall, "n": n}


def resample_timings(dev, path3) -> dict:
    """CUDA-event times of B4 (both rates, against both plain versions)
    and B5 (n = N_B5) against their plain versions, end-to-end rates of
    the resample path, and the demo's wall time; logs them."""
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch.ola import kernels as b5
    from crlot_tpu_torch.resample import kernel as b4
    from crlot_tpu_torch.resample.polyphase import (
        _kernel_bank, resample_grouped_plain)

    timing = {}
    for key, (x, l, m, n_out) in path3["geometry"].items():
        plan = b4.geometry(l, m)
        taps = b4.compact_bank(l, m, None, 120.0)[0]
        old = b4.plan_of(l, m, "blocks", 8)  # the former design
        timed(timing, f"b4_{key}", lambda: b4.resample_cuda(x, l, m, n_out))
        timed(timing, f"b4_{key}_old",
              lambda: b4.resample_cuda(x, l, m, n_out, plan=old))
        timed(timing, f"b4_{key}_bank",
              lambda: b4.resample_bank_plain(x, l, m, n_out))
        timed(timing, f"b4_{key}_grouped",
              lambda: resample_grouped_plain(x, l, m, n_out))
        taps_ops = 2.0 * x.shape[0] * n_out * taps.shape[0]
        timing[f"b4_{key}_bound"] = bound(
            nbytes(x) + x.shape[0] * n_out * 4 + taps.nbytes, taps_ops)
        log(f"time B4 {key} kernel {ms(timing, f'b4_{key}')} (runs_kernel, "
            f"J {plan.j}, R {plan.r}, {plan.wc} classes a CTA), the former "
            f"design (blocks tile, R 8) {ms(timing, f'b4_{key}_old')} in "
            f"this run, {OLD_MS[f'K7 {key}']} in PERF.md; plain "
            f"(resample_bank_plain) {ms(timing, f'b4_{key}_bank')}; bound "
            f"{timing[f'b4_{key}_bound']['bound_ms']:.4f} ms "
            f"({timing[f'b4_{key}_bound']['bound_by']}) ([2, {x.shape[-1]}] "
            f"-> [2, {n_out}]; CUDA events, median of {REPS}, queued)")
        log(f"time B4 {key} vs the JAX default's math (resample_grouped_plain)"
            f" {ms(timing, f'b4_{key}_grouped')}")
    # The one PyTorch call computing B4's sum: a strided conv1d (cuDNN,
    # TF32 off) with the [L, W] bank as L output channels, on the
    # zero-padded input; the phase interleave (a view) is not timed.
    x, l, m, n_out = path3["geometry"]["44.1->48"]
    bank, tau_min, w = _kernel_bank(l, m, None, 120.0)
    blocks = -(-n_out // l)
    xp = torch.nn.functional.pad(
        x, (-tau_min, max(0, (blocks - 1) * m + w - x.shape[-1] + tau_min)))
    xp = xp[:, None, :].contiguous()
    wt = torch.from_numpy(bank).to(dev)[:, None, :].contiguous()
    lib = torch.nn.functional.conv1d(xp, wt, stride=m)[..., :blocks]
    got = lib.transpose(1, 2).reshape(x.shape[0], -1)[:, :n_out]
    err = float((got - b4.resample_cuda(x, l, m, n_out)).abs().max())
    timed(timing, "b4_conv1d",
          lambda: torch.nn.functional.conv1d(xp, wt, stride=m))
    log(f"time B4 44.1->48 library conv1d {ms(timing, 'b4_conv1d')} "
        f"(max-abs {err:.3e} from B4)")
    g = torch.Generator(device=dev).manual_seed(0)
    a, b, c = (torch.rand(N_B5, generator=g, device=dev) * 4 - 2
               for _ in range(3))
    norm = c.abs()
    timed(timing, "axpy_library", lambda: torch.add(a, b, alpha=1.5))
    timed(timing, "axpy_windowed_library",
          lambda: torch.addcmul(a, b, c, value=0.75))
    log(f"time B5 library calls: torch.add(dst, src, alpha) "
        f"{ms(timing, 'axpy_library')}; torch.addcmul(dst, src, win, value) "
        f"{ms(timing, 'axpy_windowed_library')}")
    timed(timing, "axpy", lambda: b5.axpy_cuda(a, b, 1.5))
    timed(timing, "axpy_plain", lambda: b5.axpy_reference(a, b, 1.5))
    timed(timing, "axpy_windowed",
          lambda: b5.axpy_windowed_cuda(a, b, c, 0.75))
    timed(timing, "axpy_windowed_plain",
          lambda: b5.axpy_windowed_reference(a, b, c, 0.75))
    timed(timing, "normalize_and_clear",
          lambda: b5.normalize_and_clear_cuda(a, norm, 1e-8))
    timed(timing, "normalize_and_clear_plain",
          lambda: b5.normalize_and_clear_reference(a, norm, 1e-8))
    log("time B5 at n=" + str(N_B5) + ": " + "; ".join(
        f"{k} kernel {ms(timing, k)}, plain {ms(timing, k + '_plain')}"
        for k in ("axpy", "axpy_windowed", "normalize_and_clear"))
        + f" (CUDA events, median of {REPS}, queued)")
    noise, sines, n = path3["noise"], path3["sines"], path3["n"]
    samples = 2 * n
    timing["chain"] = samples / e2e_seconds(lambda: pt.resample(
        pt.resample(sines, 44100, 48000), 48000, 16000))
    timing["resampled_stft"] = samples / e2e_seconds(
        lambda: pt.resampled_stft(noise, 44100, 48000, path3["cfg"]))
    timing["chunked"] = samples / e2e_seconds(
        lambda: pt.resample_chunked(noise, 44100, 48000, chunk=65536))
    log(f"e2e resample chain 44.1 -> 48 -> 16 kHz {timing['chain']:.4e} "
        f"samples/s; resampled_stft {timing['resampled_stft']:.4e} "
        f"samples/s; resample_chunked (chunk 65536) {timing['chunked']:.4e} "
        f"samples/s (input samples, 2 x {n}; host clock, synchronized, "
        f"median of {REPS})")
    walls = path3["demo_wall"]
    log(f"e2e demo wall time on a 2-ch {n / SR_IN:.0f} s WAV: "
        + (f"{walls[0]:.3f} s (one run, first use in the process)"
           if walls else "not measured (phase 17 failed)"))
    return timing


# The wire and probe path: the reference bench's stream (`bench/suite.py`
# :471-482, 699-733, 800-857): mono 48 kHz, N=1024 / H=256, center=False,
# 13 chunks of 2 097 152 samples of uniform noise in +-0.9 from seed 9.
WIRE_CHUNK = 2_097_152
WIRE_CHUNKS = 13
WIRE_SEED = 9
FULL_RANGE = [-32768, 32639, 32640, 32767]


def b6_edge_cases(dev) -> list:
    """B6-i8 and B6-bf16 at the edges of the TMA kernel's 128 x 128 x 128-byte
    tiles, from seed 18: (label, dtype, kernel call, plain call, A, Bt). A
    ragged last row block (M = 1000), N = 64 and 192, a dense K of 64 bytes
    (one half-filled K tile), and batch 2 of overlapping windows (lda 128,
    K 320: a ragged last K tile)."""
    import numpy as np
    import torch

    from crlot_tpu_torch import int8_gemm as b6

    rng = np.random.default_rng(18)

    def operands(dtype, shape_a, n, k):
        if dtype == "i8":
            a = rng.integers(-128, 128, shape_a, dtype=np.int8)
            b = rng.integers(-127, 128, (n, k), dtype=np.int8)
            return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
        a = rng.uniform(-1, 1, shape_a).astype(np.float32)
        b = rng.uniform(-1, 1, (n, k)).astype(np.float32)
        return (torch.from_numpy(a).to(dev).to(torch.bfloat16),
                torch.from_numpy(b).to(dev).to(torch.bfloat16))

    cases = []
    for dtype in ("i8", "bf16"):
        es = 1 if dtype == "i8" else 2
        kern = b6.i8_gemm_cuda if dtype == "i8" else b6.bf16_gemm_cuda
        plain = b6.i8_gemm_plain if dtype == "i8" else b6.bf16_gemm_plain
        for label, m, n, k in (("M 1000", 1000, 512, 512),
                               ("N 64", 1000, 64, 512),
                               ("N 192", 1000, 192, 512),
                               ("K 64 bytes", 1000, 512, 64 // es)):
            a, bt = operands(dtype, (m, k), n, k)
            cases.append((f"{dtype} {label}", dtype,
                          lambda a=a, bt=bt, f=kern: f(a, bt),
                          lambda a=a, bt=bt, f=plain: f(a, bt), a, bt))
    rows, lda, k = 999, 128, 320
    x, bt = operands("i8", (2, (rows - 1 + 3) * lda), 512, k)
    cases.append(("i8 batch 2 windows (lda 128, K 320, 999 rows)", "i8",
                  lambda: b6.i8_gemm_cuda(x, bt, rows=rows, lda=lda),
                  lambda: b6.i8_gemm_plain(x, bt, rows=rows, lda=lda),
                  b6.windows(x, rows, lda, k), bt))
    return cases


def limb_edge_cases(dev) -> list:
    """B6-limb at the edges of the TMA kernel's tiles, from seed 18: (label,
    kernel call, plain call). probe3 on int8 limbs at a ragged last row
    block (M = 1000), at N = 64 and 192 (its tile is 128 x 128) and on
    batch 2 of overlapping windows (lda 128, K 320: a ragged last K tile);
    the int16 wire modes on windows at lda 512, K 2048 (the wire geometry,
    2 x 4096 rows, and a ragged 1000 rows at N = 64 and 192; wire2's tile
    is 128 x 64)."""
    import numpy as np
    import torch

    from crlot_tpu_torch import int8_gemm as b6

    rng = np.random.default_rng(18)

    def put(a):
        return torch.from_numpy(a).to(dev)

    def limbs(shape):
        return [put(rng.integers(-128, 128, shape, dtype=np.int8))
                for _ in range(2)]

    def kernel_b(n, k):
        return [put(rng.integers(-127, 128, (n, k), dtype=np.int8))
                for _ in range(2)]

    cases = []
    for label, m, n in (("M 1000", 1000, 512), ("N 64", 1000, 64),
                        ("N 192", 1000, 192)):
        args = (*limbs((m, 512)), *kernel_b(n, 512), "probe3")
        cases.append((f"probe3 {label}",
                      lambda a=args: b6.limb_gemm_cuda(*a),
                      lambda a=args: b6.limb_gemm_plain(*a)))
    rows, lda = 999, 128
    args = (*limbs((2, (rows + 2) * lda)), *kernel_b(512, 320), "probe3")
    cases.append(("probe3 batch 2 windows (lda 128, K 320, 999 rows)",
                  lambda a=args, r=rows: b6.limb_gemm_cuda(*a, rows=r,
                                                           lda=lda),
                  lambda a=args, r=rows: b6.limb_gemm_plain(*a, rows=r,
                                                            lda=lda)))
    for ep in ("wire2", "wire1"):
        for label, c, rows, n in (("2 x 4096 rows", 2, 4096, 512),
                                  ("1000 rows, N 64", 1, 1000, 64),
                                  ("1000 rows, N 192", 1, 1000, 192)):
            x = put(rng.integers(-32768, 32768, (c, (rows - 1) * 512 + 2048),
                                 dtype=np.int16))
            b0, b1 = kernel_b(n, 2048)
            args = (x, b0, b1, ep, 3e-5)
            cases.append((f"{ep} int16 at lda 512, K 2048, {label}",
                          lambda a=args, r=rows: b6.limb_gemm_i16_cuda(
                              *a, rows=r, lda=512),
                          lambda a=args, r=rows: b6.limb_gemm_i16_plain(
                              *a, rows=r, lda=512)))
    return cases


def k11_edge_cases(dev) -> list:
    """K11's two variants at the edges of its tiles, from seed 26: (label,
    kernel call, plain call). A ragged last row block (M = 1000) with a
    zero row, rows below the 1e-30 floor, rows from 1e-29 to 1e30 and
    subnormal values, N = 64 and 192 (its tile is
    128 x 128), K = 64 (half of its 128-deep stage), 576 (a ragged last
    stage) and 4096 (the composed basis at N = 4096)."""
    import numpy as np
    import torch

    from crlot_tpu_torch import int8_gemm as b6

    rng = np.random.default_rng(26)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cases = []
    for label, m, n, k in (("M 1000, N 64, K 64", 1000, 64, 64),
                           ("M 1000, N 192, K 576", 1000, 192, 576),
                           ("M 300, N 128, K 4096", 300, 128, 4096)):
        x = rng.uniform(-1, 1, (m, k)) * 10 ** rng.uniform(-4, 1, (m, 1))
        x[3] = 0.0
        x[5, 7] = 1e-33
        for r, scale in ((6, 1e-29), (7, 1e-36), (8, 1e20), (9, 1e30)):
            x[r] *= scale  # extreme row scales: the divide's whole range
        x[10, ::3] = 1e-41  # subnormal values beside a normal row max
        x = put(x.astype(np.float32))
        b = put(rng.integers(-127, 128, (n, k), dtype=np.int8))
        b2 = put(rng.integers(-64, 65, (n, k), dtype=np.int8))
        cs = put(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
        cases.append((f"probe {label}",
                      lambda a=(x, b, b2): b6.fusedq_gemm_cuda(*a),
                      lambda a=(x, b, b2): b6.fusedq_gemm_plain(*a)))
        cases.append((f"ref {label}",
                      lambda a=(x, b, b2, cs): b6.fusedq_ref_gemm_cuda(*a),
                      lambda a=(x, b, b2, cs): b6.fusedq_ref_gemm_plain(*a)))
    return cases


def b6_edge_check(dtype, got, want, a, bt):
    """(ok, max-abs, error as printed): int8 equal; bf16 within
    BF16_REL_TOL of sum_k |x||b| per element."""
    import torch

    from crlot_tpu_torch import int8_probe

    err = float((got.double() - want.double()).abs().max())
    if dtype == "i8":
        return torch.equal(got, want), err, "equal" if torch.equal(
            got, want) else "DIFFERS"
    scale = torch.matmul(a.float().abs(), bt.float().abs().T)
    rel = float(((got - want).abs() / scale).max())
    return rel <= int8_probe.BF16_REL_TOL, err, f"rel {rel:.3e}"


def b6_checks(dev, phase, check) -> dict:
    """Phase 18: B6 vs plain at the probe's full shape, at the wire
    geometry and at the TMA kernel's tile edges; phase 19: B4 at 48 kHz ->
    300 Hz (its unstaged path) vs both plain forms. Kernel-vs-plain
    launches: not counted on a path."""
    import numpy as np
    import torch

    from crlot_tpu_torch import int8_gemm as b6
    from crlot_tpu_torch import int8_probe
    from crlot_tpu_torch.resample import kernel as b4
    from crlot_tpu_torch.resample.polyphase import resample_grouped_plain

    results = {}
    t = int8_probe.probe_inputs(int8_probe.F, dev)

    def p18():
        lines = []
        for name, (kern, plain) in int8_probe.variants(t).items():
            got = kern()
            torch.cuda.synchronize()
            ok, err = int8_probe.check(name, got, plain(), t)
            extra = (f", rel to sum|x||b| "
                     f"{int8_probe.bf16_rel_err(got, t):.3e}"
                     if name == "pl_bf16" else "")
            lines.append(f"{name}: {'equal' if ok else 'DIFFERS'} "
                         f"(max-abs {err:.3e}{extra})")
            results[name] = err
            check(ok, lines[-1])
        rng = np.random.default_rng(18)
        for c in (1, 2):  # the wire's rows: lda 512, K 2048, 4096 rows
            x = torch.from_numpy(rng.integers(
                -128, 128, (c, 4095 * 512 + 2048), dtype=np.int8)).to(dev)
            kt = torch.from_numpy(rng.integers(
                -127, 128, (512, 2048), dtype=np.int8)).to(dev)
            got = b6.i8_gemm_cuda(x, kt, rows=4096, lda=512)
            want = b6.i8_gemm_plain(x, kt, rows=4096, lda=512)
            check(torch.equal(got, want), f"B6-i8 wire geometry, {c} ch")
            lines.append(f"B6-i8 at lda 512, K 2048, {c} x 4096 rows: equal")
            results["i8_wire"] = (x, kt)
        for label, dtype, kern, plain, a, bt in b6_edge_cases(dev):
            got = kern()
            torch.cuda.synchronize()
            ok, err, how = b6_edge_check(dtype, got, plain(), a, bt)
            lines.append(f"B6-{label}: {how} (max-abs {err:.3e})")
            key = "pl_i8" if dtype == "i8" else "pl_bf16"
            results[key] = max(results[key], err)
            check(ok, lines[-1])
        for label, kern, plain in limb_edge_cases(dev):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            ok = torch.equal(got, want)
            err = float((got.double() - want.double()).abs().max())
            lines.append(f"B6-limb {label}: {'equal' if ok else 'DIFFERS'} "
                         f"(max-abs {err:.3e})")
            results["pl_i8_3dot"] = max(results["pl_i8_3dot"], err)
            check(ok, lines[-1])
        for label, kern, plain in k11_edge_cases(dev):
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            ok = torch.equal(got, want)
            err = float((got.double() - want.double()).abs().max())
            lines.append(f"K11 {label}: {'equal' if ok else 'DIFFERS'} "
                         f"(max-abs {err:.3e})")
            results["pl_i8_fusedq"] = max(results["pl_i8_fusedq"], err)
            check(ok, lines[-1])
        return "; ".join(lines)

    def p19():
        x = torch.from_numpy(np.random.default_rng(19).uniform(
            -1, 1, (2, 48000 * SECONDS)).astype(np.float32)).to(dev)
        l, m = 1, 160
        n_out = -(-x.shape[-1] * l // m)
        _, _, _, w = b4.compact_bank(l, m, None, 120.0)
        check(b4.geometry(l, m).kind == "windows",
              "expected the unstaged path")
        got = b4.resample_cuda(x, l, m, n_out)
        bank = b4.resample_bank_plain(x, l, m, n_out)
        grouped = resample_grouped_plain(x, l, m, n_out)
        e1 = float((got - bank).abs().max())
        e2 = float((got - grouped).abs().max())
        results["b4_300_err"] = max(e1, e2)
        results["b4_300"] = (x, l, m, n_out)
        msg = (f"48 kHz -> 300 Hz (M = 160, W = {w}, windows read from L2):"
               f" max-abs {e1:.3e} vs resample_bank_plain (bit-identical "
               f"{torch.equal(got, bank)}), {e2:.3e} vs the grouped form")
        check(e1 <= 1e-5 and e2 <= 1e-5, msg)
        return msg

    phase("18 B6 vs plain", p18)
    phase("19 B4 high decimation", p19)
    return {"results": results, "probe_inputs": t}


def b0_inputs(cfg, padded, n_frames, per_bin):
    """B0's operands on the blocked round-trip's main path, as
    `blocked_composed_round_trip` takes them from its plan: (x_ext [C, L]
    padded signal, kernel [mg*gh, gh], its TF32 halves, rows, gh)."""
    from crlot_tpu_torch.core.types import FftPrecision
    from crlot_tpu_torch.fft import matmul_backend as mb

    plan = mb.blocked_plan_for(cfg, per_bin)
    full = (n_frames - 1) * HOP + NFFT
    kern, bt = plan.operands(padded.device, FftPrecision.HIGH)
    x_ext, _, rows = mb._hopblock_ext(padded[..., :full].float(), kern,
                                      plan.gh, full, plan.edge)
    return x_ext.contiguous(), kern, bt, rows, plan.gh


def b0_checks(dev, phase, check, cfg, padded, n_frames, band) -> dict:
    """Phase 25: B0 (3xTF32, `b6_sm90.cu` mode 8) against its plain
    emulation (`tf32x3.gemm_plain`) within tf32x3.REL_TOL of sum |x||k| per
    output: at the identity and EQ kernels of the main path, and at the
    edges of the f32 window tiles (M = 1000 rows, N = 192, a batch of 2);
    and a row range of the windows torch.equal to the same rows of the whole
    (a row's sum does not depend on the rows around it). Not counted on a
    path."""
    import numpy as np
    import torch

    from crlot_tpu_torch.fft import fp32_window as b0f
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.int8_gemm import windows

    out = {"err": 0.0, "fp32_err": 0.0}

    def held_fp32(label, x, kern, rows, lda):
        """B0's fp32 kernel against the float64 product, within one fmaf
        chain's bound K * 2^-24 * sum|x||k| per output."""
        got = b0f.gemm_cuda(x, kern, rows=rows, lda=lda)
        torch.cuda.synchronize()
        want = b0f.gemm_plain(x, kern, rows=rows, lda=lda)
        tol = b0f.tolerance(x, kern, rows=rows, lda=lda)
        d = (got.double() - want.double()).abs()
        rel = float((d / tol.clamp_min(1e-300)).max())
        err = float(d.max())
        out["fp32_err"] = max(out["fp32_err"], err)
        line = (f"fp32 {label}: max-abs {err:.3e}, {rel:.3e} of the bound "
                f"K * 2^-24 * sum|x||k|")
        check(rel <= 1.0, line)
        return got, line

    def held(label, x, bt, rows, lda, kern):
        got = b0.gemm_cuda(x, *bt, rows=rows, lda=lda)
        torch.cuda.synchronize()
        want = b0.gemm_plain(x, *bt, rows=rows, lda=lda)
        a = windows(x, rows, lda, kern.shape[0])
        scale = torch.matmul(a.abs(), kern.abs())
        rel = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
        err = float((got - want).abs().max())
        out["err"] = max(out["err"], err)
        line = (f"{label}: max-abs {err:.3e}, {rel:.3e} of sum|x||k| "
                f"(bound {b0.REL_TOL:.3e})")
        check(rel <= b0.REL_TOL, line)
        return got, line

    def p25():
        lines = []
        ones = np.ones(NFFT // 2 + 1)
        for label, per_bin in (("identity kernel", ones),
                               ("EQ kernel", band.per_bin_gains(NFFT))):
            x_ext, kern, bt, rows, gh = b0_inputs(cfg, padded, n_frames,
                                                  per_bin)
            got, line = held(f"{label} ({x_ext.shape[0]} x {rows} rows x "
                             f"{gh}, K {kern.shape[0]})", x_ext, bt, rows,
                             gh, kern)
            lines.append(line)
            if label == "identity kernel":
                out["inputs"] = (x_ext, kern, bt, rows, gh)
                r0, r1 = 37, 37 + 1000
                part = b0.gemm_cuda(x_ext[:, r0 * gh:].contiguous(), *bt,
                                    rows=r1 - r0, lda=gh)
                same = torch.equal(part, got[:, r0:r1])
                check(same, "rows 37..1036 alone != the same rows of all")
                lines.append(f"rows {r0}..{r1 - 1} alone: torch.equal to the "
                             f"same rows of the whole")
            got32, line = held_fp32(label, x_ext, kern, rows, gh)
            lines.append(line)
            if label == "EQ kernel":
                r0, r1 = 37, 37 + 1000
                part = b0f.gemm_cuda(x_ext[:, r0 * gh:].contiguous(), kern,
                                     rows=r1 - r0, lda=gh)
                check(torch.equal(part, got32[:, r0:r1]),
                      "fp32: rows 37..1036 alone != the same rows of all")
                small = x_ext[:, : (64 - 1) * gh + kern.shape[0]].contiguous()
                chain = b0f.chain_plain(small, kern, rows=64, lda=gh)
                check(torch.equal(got32[:, :64], chain),
                      f"fp32: 2 x 64 rows != the fmaf chain emulation, "
                      f"max-abs {float((got32[:, :64] - chain).abs().max()):.3e}")
                lines.append(f"fp32 rows {r0}..{r1 - 1} alone: torch.equal to "
                             f"the same rows of the whole; 2 x 64 rows "
                             f"torch.equal to the exact fmaf chain emulation")
        rng = np.random.default_rng(25)
        for label, m, n in (("M 1000", 1000, 512), ("M 1000, N 192", 1000,
                                                     192)):
            x = torch.from_numpy(rng.uniform(
                -1, 1, (2, (m - 1) * 512 + 2048)).astype(np.float32)).to(dev)
            kern = torch.from_numpy(rng.uniform(
                -1, 1, (2048, n)).astype(np.float32)).to(dev)
            lines.append(held(f"batch 2 windows (lda 512, K 2048), {label}",
                              x, b0.split_t(kern), m, 512, kern)[1])
            lines.append(held_fp32(f"batch 2 windows (lda 512, K 2048), "
                                   f"{label}", x, kern, m, 512)[1])
        # The fp32 tiles' ragged K (K = 2044, not a multiple of the 8-deep
        # slab) and N = 100 (a ragged column tile), a matrix at lda = K.
        x = torch.from_numpy(rng.uniform(-1, 1, (300, 2044)).astype(
            np.float32)).to(dev)
        kern = torch.from_numpy(rng.uniform(-1, 1, (2044, 100)).astype(
            np.float32)).to(dev)
        lines.append(held_fp32("matrix M 300, K 2044, N 100", x, kern, None,
                               None)[1])
        return "; ".join(lines)

    phase("25 B0 vs plain", p25)
    return out


class EdgePatchHold:
    """Every B0 launch at the sharded edge patch's shapes (`blocked_edge_patch`
    with `fixed_order`: an [N, N] composed basis over the R-1 boundary
    frames, read in place at lda = hop) while the context is open, kept
    with its operands and held against its plain version on them by
    `verify`: at HIGH `tf32x3.gemm_plain` within tf32x3.REL_TOL of
    sum |x||k| per output, at HIGHEST `fp32_window.chain_plain` (the
    kernel's fmaf chain) bit for bit. The operands' version counters show
    that nothing wrote them between the launch and the check."""

    def __init__(self, check):
        from crlot_tpu_torch.fft import fp32_window, tf32x3

        self.b0, self.b0f, self.check = tf32x3, fp32_window, check
        self.rows = NFFT // HOP - 1
        self.kept = []
        self.worst = 0.0
        self.held = {"HIGH": 0, "HIGHEST": 0}

    def __enter__(self):
        self.orig = high, fp32 = self.b0.gemm_cuda, self.b0f.gemm_cuda

        def keep(tier, a, b, rows, lda, out):
            self.kept.append((tier, a, b, rows, lda, out, a._version,
                              out._version))

        def spy_high(a, bt_hi, bt_lo, rows=None, lda=None):
            out = high(a, bt_hi, bt_lo, rows=rows, lda=lda)
            if rows == self.rows and tuple(bt_hi.shape) == (NFFT, NFFT):
                keep("HIGH", a, (bt_hi, bt_lo), rows, lda, out)
            return out

        def spy_fp32(a, kern, rows=None, lda=None):
            out = fp32(a, kern, rows=rows, lda=lda)
            if rows == self.rows and tuple(kern.shape) == (NFFT, NFFT):
                keep("HIGHEST", a, kern, rows, lda, out)
            return out

        self.b0.gemm_cuda, self.b0f.gemm_cuda = spy_high, spy_fp32
        return self

    def __exit__(self, *exc):
        self.b0.gemm_cuda, self.b0f.gemm_cuda = self.orig

    def verify(self) -> dict:
        """Hold the launches kept since the last call; returns the counts
        held at each tier since the last call."""
        import torch

        from crlot_tpu_torch.int8_gemm import windows

        counts = {"HIGH": 0, "HIGHEST": 0}
        for tier, a, b, rows, lda, out, va, vo in self.kept:
            self.check(a._version == va and out._version == vo,
                       f"edge patch ({tier}): operands written after launch")
            what = (f"edge patch ({tier}, [{a.shape[0]} x {rows} rows] at "
                    f"lda {lda})")
            if tier == "HIGH":
                want = self.b0.gemm_plain(a, *b, rows=rows, lda=lda)
                kern = (b[0] + b[1]).T
                scale = torch.matmul(
                    windows(a, rows, lda, kern.shape[0]).abs(), kern.abs())
                rel = float(((out - want).abs()
                             / scale.clamp_min(1e-30)).max())
                self.worst = max(self.worst, rel)
                self.check(rel <= self.b0.REL_TOL,
                           f"{what}: {rel:.3e} of sum|x||k| from plain "
                           f"(bound {self.b0.REL_TOL:.3e})")
            else:
                want = self.b0f.chain_plain(a, b, rows=rows, lda=lda)
                self.check(torch.equal(out, want),
                           f"{what}: != the fmaf chain emulation, max-abs "
                           f"{float((out - want).abs().max()):.3e}")
            counts[tier] += 1
            self.held[tier] += 1
        self.kept.clear()
        return counts

    def summary(self) -> str:
        return (f"edge-patch launches held against plain: "
                f"{self.held['HIGH']} at HIGH (worst "
                f"{self.worst:.3e} of sum|x||k|, bound "
                f"{self.b0.REL_TOL:.3e}), {self.held['HIGHEST']} at "
                f"HIGHEST (each torch.equal to the fmaf chain)")


class ProductHold:
    """Every launch of B0's fp32 kernel while the context is open (in
    phases 31 and 32 the features' filterbank and DCT products,
    `features._product`, at the shapes the path gives them), kept with its
    operands and held bit for bit against `fp32_window.chain_plain` (the
    kernel's fmaf chain) on them by `verify`. The operands' version
    counters show that nothing wrote them between the launch and the
    check."""

    def __init__(self, check):
        from crlot_tpu_torch.fft import fp32_window

        self.b0f, self.check = fp32_window, check
        self.kept = []
        self.held = 0
        self.shapes = set()

    def __enter__(self):
        self.orig = launch = self.b0f.gemm_cuda

        def spy(a, kern, rows=None, lda=None):
            out = launch(a, kern, rows=rows, lda=lda)
            self.kept.append((a, kern, rows, lda, out, a._version,
                              kern._version, out._version))
            return out

        self.b0f.gemm_cuda = spy
        return self

    def __exit__(self, *exc):
        self.b0f.gemm_cuda = self.orig

    def verify(self) -> None:
        """Hold the launches kept since the last call."""
        import torch

        for a, kern, rows, lda, out, va, vk, vo in self.kept:
            what = f"B0 fp32 {list(a.shape)} x {list(kern.shape)}"
            self.check((a._version, kern._version, out._version)
                       == (va, vk, vo),
                       f"{what}: operands written after launch")
            want = self.b0f.chain_plain(a, kern, rows=rows, lda=lda)
            self.check(torch.equal(out, want),
                       f"{what}: != the fmaf chain emulation, max-abs "
                       f"{float((out - want).abs().max()):.3e}")
            self.held += 1
            self.shapes.add((tuple(a.shape), tuple(kern.shape)))
        self.kept.clear()

    def summary(self) -> str:
        return (f"{self.held} launches of B0 fp32 (the features' products) "
                f"held torch.equal to the fmaf chain on their operands, "
                f"{len(self.shapes)} shapes")


class KernelHold:
    """Every launch of B0 (3xTF32, `tf32x3.gemm_cuda`) and B3
    (`fused_rt.roundtrip_frames_cuda`) while the context is open, held at
    once against its plain version on its own operands: B0 within
    tf32x3.REL_TOL of sum |x||k| per output (`gemm_plain`, as
    `EdgePatchHold` holds it), B3 within max-abs 1e-5 of
    `roundtrip_frames_plain` outside the frames whose gate decision is
    ambiguous (C12, as phase 7 holds it; `summary` fails when those pass
    0.1 % of the frames of every B3 launch held).
    The timed runs of the depth-3 prefetch
    (`sharded_pipeline.prefetch_walls`) run unheld, and put the launch
    counters back as they found them: a timed repeat is not counted."""

    def __init__(self, check):
        from crlot_tpu_torch.distributed import sharded_pipeline
        from crlot_tpu_torch.fft import fused_rt, tf32x3

        self.b0, self.b3, self.spl, self.check = (tf32x3, fused_rt,
                                                  sharded_pipeline, check)
        self.paused = False
        self.held = {"b0": 0, "b3": 0}
        self.worst = {"b0": 0.0, "b3": 0.0}
        self.left_out = self.frames = 0

    def __enter__(self):
        import torch

        from crlot_tpu_torch.int8_gemm import _as_signal, windows

        b0, b3, spl = self.b0, self.b3, self.spl
        self.orig = gemm, frames, prefetch = (b0.gemm_cuda,
                                              b3.roundtrip_frames_cuda,
                                              spl.prefetch_walls)

        def b0_spy(a, bt_hi, bt_lo, rows=None, lda=None):
            out = gemm(a, bt_hi, bt_lo, rows=rows, lda=lda)
            if self.paused:
                return out
            want = b0.gemm_plain(a, bt_hi, bt_lo, rows=rows, lda=lda)
            x, r, ld = _as_signal(a, rows, lda)
            scale = torch.matmul(windows(x, r, ld, bt_hi.shape[1]).abs(),
                                 (bt_hi + bt_lo).T.abs())
            rel = float(((out - want).abs() / scale.clamp_min(1e-30)).max())
            self.worst["b0"] = max(self.worst["b0"], rel)
            self.check(rel <= b0.REL_TOL,
                       f"B0 [{list(x.shape)}, {r} rows at lda {ld}] x "
                       f"{list(bt_hi.shape)}: {rel:.3e} of sum|x||k| from "
                       f"plain (bound {b0.REL_TOL:.3e})")
            self.held["b0"] += 1
            return out

        def b3_spy(padded, nfft, hop, n_frames, window_f32,
                   spectral_packed=None):
            out = frames(padded, nfft, hop, n_frames, window_f32,
                         spectral_packed)
            if self.paused:
                return out
            want = b3.roundtrip_frames_plain(padded, nfft, hop, n_frames,
                                             window_f32, spectral_packed)
            mask = b3.ambiguous_frames(padded, nfft, hop, n_frames,
                                       window_f32, spectral_packed)
            err = float(torch.where(~mask[..., None], (out - want).abs(),
                                    0.0).max())
            left = int(mask.sum())
            self.worst["b3"] = max(self.worst["b3"], err)
            self.left_out += left
            self.frames += mask.numel()
            self.check(err <= 1e-5, f"B3 {list(padded.shape)}, {n_frames} "
                       f"frames: max-abs {err:.3e} from plain outside "
                       f"{left} ambiguous frames")
            self.held["b3"] += 1
            return out

        def prefetch_spy(*a, **k):
            counted = b0.launches, b3.frames_launches
            self.paused = True
            try:
                return prefetch(*a, **k)
            finally:
                self.paused = False
                b0.launches, b3.frames_launches = counted

        b0.gemm_cuda, b3.roundtrip_frames_cuda = b0_spy, b3_spy
        spl.prefetch_walls = prefetch_spy
        return self

    def __exit__(self, *exc):
        (self.b0.gemm_cuda, self.b3.roundtrip_frames_cuda,
         self.spl.prefetch_walls) = self.orig

    def summary(self) -> str:
        """The launches held so far; fails if the frames left out as
        ambiguous, over every B3 launch held, pass 0.1 %."""
        self.check(self.left_out <= 1e-3 * self.frames,
                   f"B3: {self.left_out} of {self.frames} frames ambiguous")
        return (f"held against plain: B0 x{self.held['b0']} (worst "
                f"{self.worst['b0']:.3e} of sum|x||k|, bound "
                f"{self.b0.REL_TOL:.3e}), B3 x{self.held['b3']} (worst "
                f"max-abs {self.worst['b3']:.3e} outside "
                f"{self.left_out} ambiguous frames of {self.frames})")


EDGE_BOUND = 2.0 ** -14  # K * 2^-24 at K = N = 1024


def edge_check(check, label, x, y, cfg, per_bin) -> str:
    """The first and last (R-1)*hop samples of a center=False blocked
    round-trip `y` of `x` against the same samples computed in float64 on
    the host CPU (`torch.fft`): the R-1 frames that reach them, windowed
    (periodic Hann), times the per-bin response, inverted (and windowed
    again with a synthesis window), overlap-added. Compared before the
    norm divide (y times its eps-clamped f32 norm, as the tests compare
    edges), within EDGE_BOUND * sum|x||k| (the f64 basis's magnitudes,
    over the same frames) + 2^-23 |ref| + 2^-40 sum|x|: the bound of one
    f32 fmaf chain of K = N terms, which also covers 3xTF32, the f32
    basis, the overlap-add and the divide; the last term is the float64
    designs' own noise (an entry that is 0 in exact arithmetic is ~1e-17
    in either basis)."""
    import numpy as np
    import torch

    n, hop = cfg.frame_size, cfg.hop_size
    r_count = n // hop
    edge, span = (r_count - 1) * hop, (r_count - 2) * hop + n
    w = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(
        n, dtype=torch.float64) / n)
    g = torch.from_numpy(np.asarray(per_bin, np.complex128))
    kern = torch.fft.irfft(torch.fft.rfft(torch.diag(w), dim=-1) * g, n=n,
                           dim=-1)
    contrib = w
    if cfg.synthesis_window:
        kern, contrib = kern * w, w * w
    worst, worst_abs = 0.0, 0.0
    for side in ("head", "tail"):
        seg = (x[:, :span] if side == "head"
               else x[:, x.shape[1] - span:]).cpu().double()
        frames = seg.unfold(-1, n, hop)[:, : r_count - 1]
        of = frames @ kern
        sc = frames.abs() @ kern.abs() + 2.0 ** -40 * frames.abs().sum(
            -1, keepdim=True) / EDGE_BOUND
        acc = seg.new_zeros(seg.shape)
        scale = seg.new_zeros(seg.shape)
        norm = torch.zeros(span, dtype=torch.float64)
        for f in range(r_count - 1):
            acc[:, f * hop : f * hop + n] += of[:, f]
            scale[:, f * hop : f * hop + n] += sc[:, f]
            norm[f * hop : f * hop + n] += contrib
        part = slice(0, edge) if side == "head" else slice(span - edge, span)
        got = (y[:, :edge] if side == "head"
               else y[:, y.shape[1] - edge:]).cpu().double()
        norm32 = torch.clamp_min(norm[part], cfg.eps).float().double()
        ref = acc[:, part]
        d = (got * norm32 - ref).abs()
        tol = EDGE_BOUND * scale[:, part] + 2.0 ** -23 * ref.abs()
        ratio = float(torch.where(d > 0, d / tol.clamp_min(1e-300),
                                  0.0).max())
        worst, worst_abs = max(worst, ratio), max(worst_abs, float(d.max()))
        check(ratio <= 1.0, f"{label} {side} edge vs float64: {ratio:.3e} "
              f"of the bound, max-abs {float(d.max()):.3e} before the norm")
    return (f"{label}: first and last {edge} samples vs float64 on the host "
            f"CPU, before the norm: max-abs {worst_abs:.3e}, {worst:.3e} of "
            f"the bound")


def wire_path(dev, phase, check, failures) -> dict:
    """Phases 20-24, with the B6 counters reset just before: the f32
    blocked streamer, the born-int16 wire tier (both tiers), the full-range
    codes, `process_wav_file`, and the int8 probe."""
    import os
    import tempfile

    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import int8_gemm as b6
    from crlot_tpu_torch import int8_probe, spectral, wire
    from crlot_tpu_torch.fft import fp32_window as b0f
    from crlot_tpu_torch.fft import fused_rt as b3
    from crlot_tpu_torch.fft import matmul_backend as mb
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.pipeline import blocked_composed_round_trip
    from crlot_tpu_torch.streaming_pipeline import BlockedChunkStreamer

    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)
    edge = NFFT - HOP
    total = WIRE_CHUNK * WIRE_CHUNKS
    rng = np.random.default_rng(WIRE_SEED)
    x_np = rng.uniform(-0.9, 0.9, total + edge).astype(np.float32)[:total]
    x16_np = np.clip(np.rint(x_np * 32768.0), -32768, 32767).astype(np.int16)
    x = torch.from_numpy(x_np).to(dev)
    x16 = torch.from_numpy(x16_np).to(dev)
    chunks = list(x.split(WIRE_CHUNK))
    eq = spectral.band_gain([4000.0, 12000.0], [1.0, 0.4, 0.1], SR, NFFT)
    out = {"results": {}, "rates": {}}

    def stream_f32(fn=None, src=None, cfg_=cfg):
        st = BlockedChunkStreamer(cfg_, fn)
        ys = [st.feed(c, force=False)
              for c in (chunks if src is None else src)]
        ys.append(st.finish(force=False))
        return torch.cat([y for y in ys if y is not None])

    def stream_i16(tier, chunk=WIRE_CHUNK, fn=None, emit=True):
        st = wire.I16BlockedStreamer(cfg, fn, tier, emit)
        ys = [st.feed(c, force=False) for c in x16.split(chunk)]
        ys.append(st.finish(force=False))
        return torch.cat([y for y in ys if y is not None])

    def snr(ref, got):
        ref, got = ref.double(), got.double()
        return float(10 * torch.log10((ref * ref).sum()
                                      / ((got - ref) ** 2).sum()))

    def finite(t, shape):
        check(tuple(t.shape) == tuple(shape), f"shape {tuple(t.shape)}")
        check(bool(torch.isfinite(t.float()).all()), "non-finite output")

    for k in b6.launches:
        b6.launches[k] = 0
    b0.launches = 0
    b0f.launches = 0
    b3.frames_launches = 0
    y_f32 = {}

    def p20():
        before = b0.launches
        y = stream_f32()
        launched = b0.launches - before
        one = blocked_composed_round_trip(x[None], cfg,
                                          np.ones(NFFT // 2 + 1))[0]
        finite(y, (total,))
        same = torch.equal(y, one)
        err = float((y - one).abs().max())
        y_f32["identity"] = y
        out["results"]["streamer_bitexact"] = same
        msg = (f"{WIRE_CHUNKS} chunks of {WIRE_CHUNK} vs one-shot: "
               f"bit-identical {same}, max-abs {err:.3e}; B0 (3xTF32) "
               f"launches +{launched}, one a chunk; interior snr vs input "
               f"{snr(x[edge:-edge], y[edge:-edge]):.2f} dB")
        check(same and launched == WIRE_CHUNKS, msg)
        # HIGHEST: B0's fp32 kernel, one fmaf chain an output.
        cfg_hst = dataclasses.replace(cfg,
                                      fft_precision=pt.FftPrecision.HIGHEST)
        before = b0f.launches
        y_h = stream_f32(cfg_=cfg_hst)
        launched_h = b0f.launches - before
        one_h = blocked_composed_round_trip(x[None], cfg_hst,
                                            np.ones(NFFT // 2 + 1))[0]
        same_h = torch.equal(y_h, one_h)
        msg += (f"; HIGHEST: bit-identical {same_h}, max-abs "
                f"{float((y_h - one_h).abs().max()):.3e}, B0 fp32 launches "
                f"+{launched_h}; interior snr vs input "
                f"{snr(x[edge:-edge], y_h[edge:-edge]):.2f} dB")
        check(same_h and launched_h == WIRE_CHUNKS, msg)
        return msg

    def p21():
        lines = []
        for tier in ("int8x2", "int8x1"):
            before = b6.launches["limb"]
            y16 = stream_i16(tier)
            launched = b6.launches["limb"] - before
            check(launched == WIRE_CHUNKS,
                  f"{tier}: {launched} B6-limb launches, {WIRE_CHUNKS} chunks")
            finite(y16, (total,))
            small = stream_i16(tier, 524_288)
            one = stream_i16(tier, total)
            check(torch.equal(y16, small) and torch.equal(y16, one),
                  f"{tier}: chunkings differ")
            yf = stream_i16(tier, emit=False)
            s_id = snr(x[edge:-edge], yf[edge:-edge])
            check(s_id >= 90.0, f"{tier}: identity {s_id:.2f} dB")
            line = (f"{tier}: B6-limb launches +{launched} for {WIRE_CHUNKS}"
                    f" chunks; 2097152 / 524288 / one chunk bit-identical "
                    f"(int16 egress); identity interior {s_id:.2f} dB")
            if tier == "int8x2":
                s_f = snr(y_f32["identity"], y16.float() / 32768.0)
                check(s_f >= 85.0, f"vs f32 streamer {s_f:.2f} dB")
                line += f"; vs the f32 streamer {s_f:.2f} dB"
            out["results"][f"snr_{tier}"] = s_id
            lines.append(line)
        return "; ".join(lines)

    def p22():
        x_deq = x16.float() * (1.0 / 32768.0)
        ref = stream_f32(eq, list(x_deq.split(WIRE_CHUNK)))
        got = stream_i16("int8x2", fn=eq, emit=False)
        s_eq = snr(ref, got)
        check(s_eq >= 60.0, f"EQ int8x2 vs f32 EQ stream {s_eq:.2f} dB")
        # Full range: a full-scale square wave with the codes the
        # reference's split wraps, one chunk, against a float64 oracle of
        # the exact interior product and against the plain version.
        n_full = 16384
        sq = np.where((np.arange(n_full) // 300) % 2 == 0, 32767, -32768)
        sq[4000:4000 + 64 * len(FULL_RANGE)] = np.repeat(FULL_RANGE, 64)
        sq = sq.astype(np.int16)
        lines = [f"band_gain EQ int8x2 vs the f32 EQ streamer {s_eq:.2f} dB"]
        inner = slice(edge, n_full - edge)
        for tier in ("int8x2", "int8x1"):
            y = wire.i16_round_trip(torch.from_numpy(sq).to(dev), cfg,
                                    tier=tier, emit_i16=False,
                                    chunk_samples=n_full).cpu()
            host = wire.i16_round_trip(torch.from_numpy(sq), cfg, tier=tier,
                                       emit_i16=False, chunk_samples=n_full)
            c = wire._i16_kernel_consts(
                mb.blocked_plan_for(cfg, mb.blocked_response(cfg, None)),
                tier)
            kq = (c["k_i8"].astype(np.float64) if tier == "int8x1"
                  else c["k_hi"].astype(np.float64) * 128 + c["k_lo"])
            x_ext = np.concatenate([np.zeros(edge), sq.astype(np.float64),
                                    np.zeros(edge)])
            rows = np.stack([x_ext[r * 512 : r * 512 + 2048]
                             for r in range(n_full // 512)])
            oracle = (rows @ kq).reshape(-1) * (c["k_scale"] / 32768.0)
            err = float(np.max(np.abs(y.numpy()[inner] - oracle[inner])))
            same = torch.equal(y[inner], host[inner])
            check(err <= 2e-6 and same,
                  f"full range {tier}: vs oracle {err:.3e}, vs host {same}")
            lines.append(f"full-range codes {FULL_RANGE} {tier}: interior "
                         f"vs float64 oracle {err:.3e}, bit-identical to the "
                         f"plain version on the host CPU")
        return "; ".join(lines)

    def p23():
        with tempfile.TemporaryDirectory() as tmp:
            src = np.random.default_rng(SEED).uniform(
                -0.8, 0.8, (2, SR * SECONDS)).astype(np.float32)
            infile = os.path.join(tmp, "in.wav")
            outfile = os.path.join(tmp, "out.wav")
            pt.write_wav(infile, src, SR, bits=16)
            data, _ = pt.read_wav(infile)
            before = b3.frames_launches
            n_written = pt.process_wav_file(infile, outfile, cfg)
            launched = b3.frames_launches - before
            y, _ = pt.read_wav(outfile)
            check(n_written == data.shape[-1] and y.shape == data.shape,
                  f"wrote {n_written}, shape {y.shape}")
            chunk = 64 * 16 * HOP
            frames = -(-data.shape[-1] // chunk) * (chunk // HOP)
            need = (frames - 1) * HOP + NFFT
            xp = np.pad(data, [(0, 0), (0, need - data.shape[-1])])
            want = np.stack([
                pt.streaming_round_trip(torch.from_numpy(xp[c]).to(dev),
                                        cfg)[0][: data.shape[-1]].cpu().numpy()
                for c in range(2)])
            codes = np.rint(np.clip(want, -1, 1) * 32767.0)
            got_codes = np.rint(y * 32767.0)
            diff = np.abs(codes - got_codes)
            msg = (f"2 ch x {SECONDS} s 16-bit WAV: {n_written} samples per "
                   f"channel, B3 (3xTF32 frames) launches +{launched}; 16-bit "
                   f"codes equal to the unbroken stream's at "
                   f"{int((diff == 0).sum())} of {diff.size}")
            check(launched > 0 and not diff.any(), msg)
            return msg

    probe = {}

    def p24():
        probe["rows"] = int8_probe.run()
        lines = []
        for r in probe["rows"]:
            if "variant" in r:
                check(r["match_plain"], f"{r['variant']} differs from plain")
                lib = ("null" if r["library_us"] is None
                       else f"{r['library_us']:.2f} us, {r['library']}")
                cold = ("" if "us_per_call_cold" not in r else
                        f"; cold L2 {r['us_per_call_cold']:.2f} us, library "
                        + ("null" if r["library_us_cold"] is None
                           else f"{r['library_us_cold']:.2f} us"))
                lines.append(f"{r['variant']} {r['us_per_call']:.2f} us "
                             f"{r['tops_1dot']:.1f} TOPS (library {lib}{cold})")
            else:
                lines.append(f"int8/bf16 rate {r['i8_over_bf16']:.3f}, "
                             f"3-dot/bf16 {r['i8_3dot_over_bf16']:.3f}")
        return "; ".join(lines)

    phase("20 blocked f32 streamer", p20)
    phase("21 wire tier, both tiers", p21)
    phase("22 wire EQ and full range", p22)
    phase("23 process_wav_file", p23)
    phase("24 int8 probe", p24)
    counts = {k: v for k, v in b6.launches.items() if k != "fusedq_ref"}
    counts.update(b0=b0.launches, b0_fp32=b0f.launches,
                  b3=b3.frames_launches)
    log("wire and probe path launches: " + ", ".join(
        f"{'B6-' + k if k in b6.launches else k.upper()} {v}"
        for k, v in counts.items()))
    if not all(counts.values()):
        failures.append("launch counts (path 4)")
        log("FAIL launch counts: a kernel of the path was not launched")
    out.update(counts=counts, probe=probe, x=x, x16=x16, chunks=chunks,
               stream_f32=stream_f32, stream_i16=stream_i16)
    return out


def int8_tier_path(dev, phase, check, failures, x, x_np) -> dict:
    """Phase 26, with the K11 and B1 counters reset just before: the
    INT8X2 tier's round-trip at N = 1024, H = 480 on the main path's
    signal ("tiled_i8": four K11 launches and one of B1), beside it the
    same at HIGH ("tiled") and `roundtrip_composed_i8` on the path's
    frames. Every K11 launch is held against its plain version on its own
    operands."""
    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import int8_gemm as b6
    from crlot_tpu_torch.fft import int8_backend as ib
    from crlot_tpu_torch.frame.framing import frame_signal
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.pipeline import _window_f64

    n = x.shape[-1]
    cfg = pt.StftConfig(frame_size=NFFT, hop_size=480, center=True,
                        fft_precision=pt.FftPrecision.INT8X2)
    cfg_hi = dataclasses.replace(cfg, fft_precision=pt.FftPrecision.HIGH)
    out = {"results": {}, "cfg": cfg, "cfg_hi": cfg_hi}
    seen = []
    kernel = b6.fusedq_ref_gemm_cuda

    def spy(xq, bh, bl, cs):
        y = kernel(xq, bh, bl, cs)
        seen.append((xq, bh, bl, cs, y))
        return y

    def held(launches):
        """(all equal, max-abs) of the recorded K11 launches vs plain."""
        ok, worst = True, 0.0
        for xq, bh, bl, cs, y in launches:
            want = b6.fusedq_ref_gemm_plain(xq, bh, bl, cs)
            ok = ok and torch.equal(y, want)
            worst = max(worst, float((y - want).abs().max()))
        return ok, worst

    b6.launches["fusedq_ref"] = 0
    b1.launches = 0
    b6.fusedq_ref_gemm_cuda = spy

    def p26():
        check(pt.formulation_for(cfg, None, n) == "tiled_i8", "route")
        k0, b0_ = b6.launches["fusedq_ref"], b1.launches
        y = pt.round_trip(x, cfg)
        torch.cuda.synchronize()
        k11, ola = b6.launches["fusedq_ref"] - k0, b1.launches - b0_
        check(tuple(y.shape) == (2, n) and bool(torch.isfinite(y).all()),
              f"shape {tuple(y.shape)} or non-finite")
        check(k11 == 4 and ola == 1, f"K11 launches +{k11}, B1 +{ola}")
        ok, err = held(seen)
        out["inputs"] = seen[0][:4]
        seen.clear()
        check(ok, f"K11 (dot_i8x2) != plain on the path's operands, max-abs "
              f"{err:.3e}")
        snr = pt.snr_db(x_np, y)
        check(snr >= 60.0, f"identity {snr:.2f} dB")
        check(pt.formulation_for(cfg_hi, None, n) == "tiled", "HIGH route")
        y_hi = pt.round_trip(x, cfg_hi)
        snr_hi = pt.snr_db(x_np, y_hi)
        check(snr_hi >= 60.0, f"HIGH identity {snr_hi:.2f} dB")
        vs_hi = pt.snr_db(y_hi, y)
        # The composed response round-trip on the path's frames (K = 1024).
        rng = np.random.default_rng(8)
        k = np.arange(NFFT // 2 + 1)
        g = (10 ** rng.uniform(-0.5, 0.5, NFFT // 2 + 1)) * np.exp(
            -2j * np.pi * k * 3 / NFFT)
        w64 = _window_f64(cfg)
        frames = frame_signal(x, cfg.frame_spec)
        k0 = b6.launches["fusedq_ref"]
        yc = ib.roundtrip_composed_i8(frames, NFFT, w64, g)
        torch.cuda.synchronize()
        kc = b6.launches["fusedq_ref"] - k0
        okc, errc = held(seen)
        seen.clear()
        check(kc == 1 and okc, f"composed: K11 launches +{kc}, equal to "
              f"plain {okc} (max-abs {errc:.3e})")
        fr64 = frames[0, :64].double().cpu().numpy()
        ref = np.fft.irfft(np.fft.rfft(fr64 * w64, axis=-1) * g, n=NFFT,
                           axis=-1)
        snr_c = pt.snr_db(ref, yc[0, :64].cpu().numpy())
        check(snr_c >= 62.0, f"composed vs f64 oracle {snr_c:.2f} dB")
        out["results"].update(err=max(err, errc), snr=snr, snr_hi=snr_hi,
                              vs_hi=vs_hi, snr_composed=snr_c)
        return (f"route tiled_i8 (N {NFFT}, H 480, 2 x {n}): K11 "
                f"(dot_i8x2's variant) launches +{k11}, each torch.equal to "
                f"plain on its operands; B1 +{ola}; identity {snr:.2f} dB; "
                f"HIGH (route tiled, fp32 products) {snr_hi:.2f} dB; int8 "
                f"tier vs HIGH {vs_hi:.2f} dB; roundtrip_composed_i8 (+-10 "
                f"dB EQ, K = {NFFT}, [2, {frames.shape[-2]}, {NFFT}] "
                f"frames): K11 +{kc}, torch.equal to plain, first 64 frames "
                f"vs f64 oracle {snr_c:.2f} dB")

    try:
        phase("26 INT8X2 round_trip (tiled_i8)", p26)
    finally:
        b6.fusedq_ref_gemm_cuda = kernel
    out["counts"] = {"k11_ref": b6.launches["fusedq_ref"],
                     "b1": b1.launches}
    log(f"INT8X2 path launches: K11 (dot_i8x2) {out['counts']['k11_ref']}, "
        f"B1 {out['counts']['b1']}")
    if not all(out["counts"].values()):
        failures.append("launch counts (path 5)")
        log("FAIL launch counts: a kernel of the path was not launched")
    return out


# The streaming slice: BASELINE config 5's sharded stream (128 channels, an
# hour at 48 kHz in chunks of 2^20), the Framer feeding the OLAAccumulator
# on the main path's signal, and FftPlan.
STREAM_CH = 128
STREAM_CHUNK = 1 << 20
STREAM_HOUR = 3600 * SR
STREAM_SEED = 5
STREAM_PROFILED = 6  # chunks under torch.profiler for the idle share
OLA_SAVE_AT = 2000  # the accumulator's checkpoint frame
PLAN_BATCH = 64
PLAN_NFFTS = (NFFT, 4096)  # 4096: the largest N the matmul DFT takes


def stream_path(dev, phase, check, failures, x_np) -> dict:
    """Phases 27-29, with the B0, B3 and K6 counters reset just before:
    the sharded streamer at BASELINE config 5's width, the Framer feeding
    the OLAAccumulator, and FftPlan on the card."""
    import os
    import tempfile

    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import checkpoint, spectral
    from crlot_tpu_torch.fft import fp32_window as b0f
    from crlot_tpu_torch.fft import fused_rt as b3
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.ola import kernels as b5
    from crlot_tpu_torch.profile_paths import _device_events

    sync = torch.cuda.synchronize
    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)
    cfg_hst = dataclasses.replace(cfg, fft_precision=pt.FftPrecision.HIGHEST)
    gate = spectral.noise_gate(-30.0)
    band = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, NFFT)
    meshes = {"(1, 1)": pt.make_mesh(1, 1, devices=[dev]),
              "(2, 2)": pt.make_mesh(2, 2, devices=[dev] * 4)}
    out = {"results": {}}
    for k in b5.launches:
        b5.launches[k] = 0
    b0.launches = 0
    b0f.launches = 0
    b3.frames_launches = 0

    def chunk_source(seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def make():  # uniform in +-0.9, made on the card
            return torch.rand((STREAM_CH, STREAM_CHUNK), generator=g,
                              device=dev) * 1.8 - 0.9
        return make

    def stream(chunks, cfg_, mesh, fn=None):
        st = pt.ShardedStreamer(cfg_, mesh, fn)
        ys = [st.feed(c, force=False) for c in chunks]
        ys.append(st.finish(force=False))
        return torch.cat([y for y in ys if y is not None], dim=1), st

    def snr(ref, got):
        noise = float(((got.double() - ref.double()) ** 2).sum())
        sig = float((ref.double() ** 2).sum())
        return math.inf if noise == 0 else 10 * math.log10(sig / noise)

    def p27():
        with EdgePatchHold(check) as hold:
            lines = p27_held(hold)
        return p27_hour(lines)

    def p27_held(hold):
        """The 4-chunk checks, every edge-patch launch held against plain
        (`EdgePatchHold`)."""
        make = chunk_source(STREAM_SEED)
        chunks = [make() for _ in range(4)]
        x = torch.cat(chunks, dim=1)
        total = x.shape[1]
        inner = slice(NFFT, total - NFFT)
        lines = []
        per_bin = {None: np.ones(NFFT // 2 + 1),
                   band: band.per_bin_gains(NFFT)}
        tier = {"b0": "HIGH", "b0f": "HIGHEST"}
        modes = (("identity HIGH (B0 3xTF32)", cfg, None, True, "b0"),
                 ("identity HIGHEST (B0 fp32)", cfg_hst, None, True, "b0f"),
                 ("band_gain EQ (B0 3xTF32)", cfg, band, True, "b0"),
                 ("noise_gate (B3)", cfg, gate, False, "b3"))
        counters = {"b0": lambda: b0.launches, "b0f": lambda: b0f.launches,
                    "b3": lambda: b3.frames_launches}
        kept = {}
        for name, cfg_, fn, blocked, key in modes:
            ys = {}
            for mname, mesh in meshes.items():
                before = counters[key]()
                y, st = stream(chunks, cfg_, mesh, fn)
                sync()
                launched = counters[key]() - before
                groups = mesh.shape["channel"]
                shards = groups * mesh.shape["time"]
                # A blocked chunk program runs two products a shard (the
                # interior rows, then the head and tail rows) and patches
                # its in-mesh head and tail on each channel group (in the
                # discarded context); the stream's own head and tail
                # patches come on top.
                want = (4 * (2 * shards + 2 * groups) + 2 * groups if blocked
                        else 4 * shards)
                check(st.blocked == blocked,
                      f"{name} {mname}: blocked {st.blocked}")
                check(launched == want,
                      f"{name} {mname}: {launched} launches for 4 chunks on "
                      f"{shards} shards, {want} expected")
                one = pt.sharded_round_trip(x, cfg_, mesh, fn)
                # Each chunk's two in-mesh patches and the stream's head and
                # tail on every channel group, and the one-shot's two.
                held = hold.verify()
                want = 12 * groups if blocked else 0
                check(held.get(tier.get(key), 0) == want
                      and sum(held.values()) == want,
                      f"{name} {mname}: edge patches held {held}, {want} "
                      f"expected")
                same = torch.equal(y, one)
                check(same, f"{name} {mname}: chunked != one-shot, max-abs "
                      f"{float((y - one).abs().max()):.3e}")
                check(bool(torch.isfinite(y).all())
                      and tuple(y.shape) == tuple(x.shape), f"{name} output")
                ys[mname] = y
                del one
            check(torch.equal(ys["(2, 2)"], ys["(1, 1)"]),
                  f"{name}: (2, 2) != (1, 1), max-abs "
                  f"{float((ys['(2, 2)'] - ys['(1, 1)']).abs().max()):.3e}")
            msg = (f"{name}: chunked == one-shot on (1, 1) and (2, 2), "
                   f"(2, 2) == (1, 1)")
            if blocked:
                msg += "; " + edge_check(check, name, x, ys["(1, 1)"], cfg_,
                                         per_bin[fn])
            if fn is None:
                s = snr(x[:, inner], ys["(1, 1)"][:, inner])
                check(s > 60.0, f"{name}: interior snr {s:.2f} dB")
                msg += f", interior snr {s:.2f} dB"
            lines.append(msg)
            if key != "b0f" and fn is not band:
                kept[name] = ys["(1, 1)"]
        # The masked array form against its one-shot.
        y = pt.sharded_stream(x, cfg, meshes["(1, 1)"], STREAM_CHUNK, gate)
        one = pt.sharded_round_trip(x, cfg, meshes["(1, 1)"], gate,
                                    allow_blocked=False)
        check(torch.equal(y, one), "sharded_stream != one-shot "
              f"(allow_blocked=False), max-abs "
              f"{float((y - one).abs().max()):.3e}")
        lines.append("sharded_stream (masked, noise_gate) == one-shot with "
                     "allow_blocked=False")
        del y, one
        # Resume: state() after chunk 2 into a fresh streamer.
        for name, fn in (("identity HIGH (B0 3xTF32)", None),
                         ("noise_gate (B3)", gate)):
            st = pt.ShardedStreamer(cfg, meshes["(1, 1)"], fn)
            st.feed(chunks[0], force=False)
            st.feed(chunks[1], force=False)
            saved = st.state()
            st2 = pt.ShardedStreamer(cfg, meshes["(1, 1)"], fn)
            st2.load_state(saved)
            rest = [st2.feed(c, force=False) for c in chunks[2:]]
            rest.append(st2.finish(force=False))
            got = torch.cat(rest, dim=1)
            want = kept[name][:, STREAM_CHUNK:]
            check(torch.equal(got, want), f"{name}: resumed != unbroken, "
                  f"max-abs {float((got - want).abs().max()):.3e}")
            held = sum(hold.verify().values())
            check(held == (10 if fn is None else 0),
                  f"{name}: {held} edge patches held over the resumed run")
        lines.append("state() after chunk 2 resumed in a fresh streamer == "
                     "the unbroken stream (identity, noise_gate)")
        lines.append(hold.summary() + " (the hour's and the profiled "
                     "chunks' are not: a spy there would be in the timing)")
        out["results"]["stream_4"] = lines
        return lines

    def p27_hour(lines):
        torch.cuda.empty_cache()
        # An hour of 128 channels at 48 kHz, identity, (1, 1), force=False.
        n_chunks = -(-STREAM_HOUR // STREAM_CHUNK)
        make = chunk_source(STREAM_SEED + 1)
        st = pt.ShardedStreamer(cfg, meshes["(1, 1)"])
        sums = []

        def reduce(xk, yk, first, last):
            a = NFFT if first else 0
            b = STREAM_CHUNK - NFFT if last else STREAM_CHUNK
            d = yk[:, a:b] - xk[:, a:b]
            sums.append(torch.stack([(xk[:, a:b] ** 2).sum(),
                                     (d * d).sum()]))

        before = b0.launches
        sync()
        t0 = time.perf_counter()
        prev = None
        for k in range(n_chunks):
            c = make()
            y = st.feed(c, force=False)
            if y is not None:
                reduce(prev, y, k == 1, False)
            prev = c
        reduce(prev, st.finish(force=False), n_chunks == 1, True)
        sync()
        wall = time.perf_counter() - t0
        hour_b0 = b0.launches - before
        sig, noise = torch.stack(sums).double().cpu().unbind(1)
        per_chunk = [math.inf if float(e) == 0 else
                     10 * math.log10(float(s) / float(e))
                     for s, e in zip(sig, noise)]
        worst = min(per_chunk)
        rate = STREAM_CH * n_chunks * STREAM_CHUNK / wall
        check(worst > 60.0, f"hour: worst chunk snr {worst:.2f} dB")
        check(hour_b0 == 4 * n_chunks + 2, f"hour: {hour_b0} B0 launches "
              f"for {n_chunks} chunks (a chunk's interior rows, its head "
              f"and tail rows, its two in-mesh patches; the stream's two "
              f"patches)")
        # The card's idle share over a few profiled chunks.
        make = chunk_source(STREAM_SEED + 2)
        st = pt.ShardedStreamer(cfg, meshes["(1, 1)"])
        for _ in range(2):
            st.feed(make(), force=False)
        sync()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STREAM_PROFILED):
                st.feed(make(), force=False)
            sync()
            wall_p = time.perf_counter() - t0
        rows = _device_events(prof)
        device_ms = sum(us for _, us in rows.values()) / 1e3
        idle = 1 - device_ms / (wall_p * 1e3)
        top = sorted(rows.items(), key=lambda r: -r[1][1])[:6]
        out["results"].update(
            hour_chunks=n_chunks, hour_wall=wall, hour_rate=rate,
            hour_worst_snr=worst, hour_b0=hour_b0, idle=idle,
            profiled_wall_ms=wall_p * 1e3 / STREAM_PROFILED,
            profiled_device_ms=device_ms / STREAM_PROFILED)
        lines.append(
            f"an hour of {STREAM_CH} ch at {SR} Hz: {n_chunks} chunks of "
            f"{STREAM_CHUNK} (no cut), identity on (1, 1), force=False: "
            f"{rate:.4e} samples/s ({wall:.3f} s host clock, chunks made "
            f"on the card and reduced to their interior snr there), worst "
            f"chunk snr {worst:.2f} dB, B0 launches {hour_b0}; "
            f"{STREAM_PROFILED} profiled chunks: "
            f"{wall_p * 1e3 / STREAM_PROFILED:.3f} ms a chunk end to end, "
            f"device {device_ms / STREAM_PROFILED:.3f} ms, idle share "
            f"{idle:.3f}; device events "
            + ", ".join(f"{k[:40]} x{c / STREAM_PROFILED:g} "
                        f"{us / STREAM_PROFILED / 1e3:.3f} ms"
                        for k, (c, us) in top))
        return "; ".join(lines)

    def p28():
        from crlot_tpu_torch.window.windows import get_window

        ocfg = pt.OLAConfig(sample_rate=SR, frame_size=NFFT, hop_size=HOP,
                            channels=2, apply_window_inside=True)
        w = get_window(pt.WindowType.HANN, NFFT, periodic=True)
        aos = np.ascontiguousarray(x_np.T).reshape(-1)  # interleaved
        block = 2 * (SR // 100)  # 10 ms of both channels

        def run(device, start=0, state=None, save=None):
            fr = pt.Framer(NFFT, HOP, 2, device=device)
            acc = pt.OLAAccumulator(ocfg, device=device)
            acc.set_window(w)
            if state is not None:
                acc.load_state(state)
            outs, k, spans = [], start, 0

            def produce(count):
                """acc.produce, counting the ring spans it drains (one K6
                launch each) from the read cursor."""
                nonlocal spans
                lo = acc.state.read_pos % ocfg.ring_len
                o = acc.produce(count)
                got = o.shape[1]
                spans += (got > 0) + (lo + got > ocfg.ring_len)
                return o

            def drain_frames():
                nonlocal k
                while (f := fr.pop()) is not None:
                    if save is not None and k == OLA_SAVE_AT:
                        checkpoint.save_stream_state(save, acc.state, ocfg, k)
                    acc.add_frame_soa(f, k * HOP)
                    outs.append(produce(HOP))
                    k += 1

            src = aos[start * HOP * 2:]
            for i in range(0, src.size, block):
                fr.push(src[i : i + block])
                drain_frames()
            fr.flush()
            drain_frames()
            acc.flush()
            while (o := produce(ocfg.ring_len)).shape[1]:
                outs.append(o)
            return torch.cat(outs, dim=1), k, spans

        kernel = b5.normalize_and_clear_cuda
        bad = []

        def spy(acc, norm, eps):  # every K6 launch against its plain version
            o, cleared = kernel(acc, norm, eps)
            want = b5.normalize_and_clear_reference(acc, norm, eps)[0]
            bad.append((o != want).sum() + (cleared != 0).sum())
            return o, cleared

        tmp = tempfile.mkdtemp()
        path = os.path.join(tmp, "stream.ckpt.npz")
        b5.normalize_and_clear_cuda = spy
        before = b5.launches["normalize_and_clear"]
        try:
            y, frames, spans = run(dev, save=path)
            sync()
        finally:
            b5.normalize_and_clear_cuda = kernel
        k6 = b5.launches["normalize_and_clear"] - before
        mism = int(torch.stack(bad).sum()) if bad else 0
        check(mism == 0, f"{mism} K6 outputs differ from plain")
        check(k6 == spans, f"{k6} K6 launches for {spans} drained ring "
              f"spans ({frames} frames)")
        y_cpu = run("cpu")[0]
        check(torch.equal(y.cpu(), y_cpu), f"card != CPU, max-abs "
              f"{float((y.cpu() - y_cpu).abs().max()):.3e}")
        state, cfg2, fi, _ = checkpoint.load_stream_state(path, device=dev)
        check(cfg2 == ocfg and fi == OLA_SAVE_AT, "checkpoint meta")
        y_res = run(dev, start=fi, state=state)[0]
        tail = y[:, y.shape[1] - y_res.shape[1]:]
        check(torch.equal(y_res, tail), "resumed != unbroken, max-abs "
              f"{float((y_res - tail).abs().max()):.3e}")
        n = x_np.shape[1]
        s = pt.snr_db(x_np[:, NFFT:n - NFFT], y[:, NFFT:n - NFFT])
        check(s > 60.0, f"interior snr {s:.2f} dB")
        sync()
        t0 = time.perf_counter()
        run(dev)
        sync()
        wall = time.perf_counter() - t0
        a = torch.rand((2, HOP), device=dev)
        nrm = torch.rand((2, HOP), device=dev) + 0.5
        from crlot_tpu_torch.timing import cuda_ms

        counted = b5.launches["normalize_and_clear"]
        q, per_call = cuda_ms(lambda: kernel(a, nrm, ocfg.eps))
        b5.launches["normalize_and_clear"] = counted  # timing, not the path
        k6_ms = per_call if q is None else q
        out["ola_y"] = y  # phase 44 holds the native-fed path against it
        out["results"].update(ola_frames=frames, ola_wall=wall, ola_k6=k6,
                              ola_k6_ms=k6_ms, ola_snr=s)
        return (f"2 ch x {SECONDS} s through Framer (10 ms interleaved "
                f"pushes) and OLAAccumulator (N {NFFT}, H {HOP}, Hann "
                f"inside): {frames} frames, K6 launches {k6} (one a "
                f"drained ring span), each torch.equal to plain; card == CPU bit for bit; "
                f"save_stream_state at frame {OLA_SAVE_AT} resumed == "
                f"unbroken; interior snr {s:.2f} dB; {frames / wall:.1f} "
                f"frames/s ({wall / frames * 1e6:.1f} us a frame, host "
                f"clock, synchronized); K6 at [2, {HOP}] "
                f"{k6_ms * 1e3:.2f} us a launch "
                f"({'queued' if q else 'per call'}, CUDA events, median of "
                f"{REPS})")

    def p29():
        return "; ".join(plan_check(nfft) for nfft in PLAN_NFFTS)

    def plan_check(nfft):
        rng = np.random.default_rng(29)
        xr = rng.uniform(-1, 1, (PLAN_BATCH, nfft)).astype(np.float32)
        xc = (rng.standard_normal((PLAN_BATCH, nfft)) + 1j
              * rng.standard_normal((PLAN_BATCH, nfft))).astype(np.complex64)

        def within(got, want, inp):
            """|got - want| <= 2^-22 * sum|inp| per row (the bound stated in
            tests/test_torch_fft_plan.py); returns the worst ratio."""
            bound = 2.0 ** -22 * np.abs(inp).sum(axis=-1, keepdims=True)
            r = float(np.max(np.abs(got.cpu().numpy() - want.numpy())
                             / bound))
            check(r <= 1.0, f"N {nfft}: card vs CPU at {r:.3f} of the bound")
            return r

        real = pt.make_fft_plan(pt.FftPlanDesc(pt.FftDomain.REAL, nfft,
                                               batch=PLAN_BATCH))
        spec, spec_c = real.forward(xr), real.forward(xr, device="cpu")
        y = real.inverse(spec)
        rmse = float(((y.cpu() - torch.from_numpy(xr)) ** 2).mean().sqrt())
        check(rmse < 1e-6, f"N {nfft}: REAL round-trip rmse {rmse:.3e}")
        sc = spec_c.numpy()
        r1 = within(spec, spec_c, xr)
        r2 = within(y, real.inverse(spec_c), 2 * (np.abs(sc.real)
                                                  + np.abs(sc.imag)) / nfft)
        cplx = pt.make_fft_plan(pt.FftPlanDesc(pt.FftDomain.COMPLEX, nfft))
        cs, cs_c = cplx.forward_complex(xc), cplx.forward_complex(
            xc, device="cpu")
        yc = cplx.inverse_complex(cs)
        err = float((yc.cpu() - torch.from_numpy(xc)).abs().max())
        check(err < 1e-4, f"N {nfft}: COMPLEX round-trip max-abs {err:.3e}")
        cc = cs_c.numpy()
        r3 = within(cs, cs_c, np.abs(xc.real) + np.abs(xc.imag))
        r4 = within(yc, cplx.inverse_complex(cs_c),
                    (np.abs(cc.real) + np.abs(cc.imag)) / nfft)
        return (f"N {nfft}, batch {PLAN_BATCH} on the card: REAL (matmul "
                f"DFT) round-trip rmse {rmse:.3e} (< 1e-6), COMPLEX "
                f"(torch.fft) max-abs {err:.3e} (< 1e-4); vs the CPU "
                f"(torch.fft) forward / inverse at {r1:.3f} / {r2:.3f} "
                f"(REAL) and {r3:.3f} / {r4:.3f} (COMPLEX) of 2^-22 * "
                f"sum|input| a row")

    phase("27 sharded streamer, 128 ch (config 5)", p27)
    phase("28 Framer + OLAAccumulator (K6)", p28)
    phase("29 FftPlan", p29)
    out["counts"] = {"b0": b0.launches, "b0_fp32": b0f.launches,
                     "b3": b3.frames_launches,
                     "k6": b5.launches["normalize_and_clear"]}
    log(f"streaming path launches: B0 {out['counts']['b0']}, B0 fp32 "
        f"{out['counts']['b0_fp32']}, B3 {out['counts']['b3']}, K6 "
        f"{out['counts']['k6']}")
    if not all(out["counts"].values()):
        failures.append("launch counts (path 6)")
        log("FAIL launch counts: a kernel of the path was not launched")
    return out


ANALYSIS_SEED = 5  # the config-5 width signal, made on the card
IIR_CHUNK = 1 << 18  # phase 30's chunked stream
GL_ITERS = 32
GL_CHECK_ITERS = 2  # phase 32's card vs host CPU, from one initial phase
FEATURE_FRAMES = SR // HOP  # frames held against float64: the first 1 s
C18_VARIANTS = ("float64", "float32", "float32_f64_combines")
# Phase 31's bounds against the float64 host computation of the same
# function, each relative to the largest |value| of the feature over the
# compared frames, except mfcc (absolute, in the dB domain: the atol of
# tests/test_features.py::test_mfcc_matches_scipy_dct_of_logmel) and lpc
# (|a - a64| <= 5e-3 |a64| + 5e-4: the gate of
# tests/test_features.py::test_lpc_matches_normal_equation_oracle).
# spectral_rolloff is held to one bin (SR / NFFT Hz). The card and the
# port on the host CPU each meet these bounds; card vs host CPU, twice them.
FEATURE_TOL = {
    "mel_spectrogram": 1e-5, "mfcc": 2e-3, "pcen": 1e-5,
    "spectral_centroid": 1e-5, "spectral_bandwidth": 1e-5,
    "spectral_flatness": 1e-4, "spectral_contrast": 1e-3, "chroma": 1e-5,
    "chroma_cqt": 1e-5, "lpc": 5e-3, "zero_crossing_rate": 1e-6,
    "frame_rms": 1e-6, "envelope": 1e-5,
}
LPC_ORDER = 16


def _f64_features(x_np, cfg) -> dict:
    """Phase 31's float64 host computations of the first FEATURE_FRAMES
    frames of each channel (envelope: the whole signal), from numpy and
    scipy and the port's float32 design arrays read as float64."""
    import numpy as np
    import scipy.linalg
    import scipy.signal

    from crlot_tpu_torch import features as F
    from crlot_tpu_torch.pipeline import _window_f64

    x64 = x_np.astype(np.float64)
    w = _window_f64(cfg)
    pad = NFFT // 2
    xp = np.pad(x64[:, : SR + 2 * NFFT], ((0, 0), (pad, pad)),
                mode="reflect")  # numpy's reflect is reflect101
    idx = np.arange(FEATURE_FRAMES)[:, None] * HOP + np.arange(NFFT)[None]
    frames = xp[:, idx]  # [C, F0, N]
    p = np.abs(np.fft.rfft(frames * w, axis=-1)) ** 2
    freqs = np.fft.rfftfreq(NFFT, 1.0 / SR)
    mag = np.sqrt(p)
    out = {}
    mel = p @ F.mel_filterbank(SR, NFFT, 64).astype(np.float64).T
    out["mel_spectrogram"] = mel
    logmel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    out["mfcc"] = logmel @ F._dct_ii_ortho(13, 64).astype(np.float64).T
    t = 0.4 * SR / HOP
    s = (np.sqrt(1.0 + 4.0 * t * t) - 1.0) / (2.0 * t * t)
    m = np.empty_like(mel)
    prev = mel[:, 0]
    for k in range(mel.shape[1]):
        prev = (1 - s) * prev + s * mel[:, k]
        m[:, k] = prev
    out["pcen"] = (mel / (1e-6 + m) ** 0.98 + 2.0) ** 0.5 - 2.0 ** 0.5
    den = mag.sum(-1)
    cent = (mag * freqs).sum(-1) / den
    out["spectral_centroid"] = cent
    out["spectral_bandwidth"] = np.sqrt(
        (mag * (freqs - cent[..., None]) ** 2).sum(-1) / den)
    csum = np.cumsum(p, axis=-1)
    out["spectral_rolloff"] = freqs[np.argmax(csum >= 0.85 * csum[..., -1:],
                                              axis=-1)]
    pe = p + 1e-10
    out["spectral_flatness"] = np.exp(np.log(pe).mean(-1)) / pe.mean(-1)
    cols = []
    for lo, hi in F._contrast_band_slices(SR, NFFT, 6, 200.0):
        nb = hi - lo
        k = max(1, int(round(0.02 * nb)))
        srt = np.sort(p[..., lo:hi], axis=-1)
        cols.append(10.0 * np.log10(
            np.maximum(srt[..., nb - k:].mean(-1), 1e-20)
            / np.maximum(srt[..., :k].mean(-1), 1e-20)))
    out["spectral_contrast"] = np.stack(cols, axis=-1)
    out["chroma"] = p @ F.chroma_filterbank(SR, NFFT).astype(np.float64).T
    cqt = p @ F.cqt_filterbank(SR, NFFT, 84, 12, 32.703194).astype(
        np.float64).T
    out["chroma_cqt"] = cqt.reshape(cqt.shape[:-1] + (7, 12)).sum(-2)
    fw = frames * w
    r = np.stack([(fw[..., : NFFT - k] * fw[..., k:]).sum(-1)
                  for k in range(LPC_ORDER + 1)], axis=-1)
    a = np.zeros(r.shape)
    for c in range(r.shape[0]):
        for f in range(r.shape[1]):
            rr = r[c, f]
            toe = scipy.linalg.toeplitz(rr[:LPC_ORDER])
            a[c, f] = np.concatenate(
                [[1.0], np.linalg.solve(toe, -rr[1 : LPC_ORDER + 1])])
    out["lpc"] = a
    pos = frames >= 0
    out["zero_crossing_rate"] = (pos[..., 1:] != pos[..., :-1]).mean(-1)
    out["frame_rms"] = np.sqrt((frames ** 2).mean(-1))
    out["envelope"] = np.abs(scipy.signal.hilbert(x64, axis=-1))
    return out


def _feature_calls(cfg) -> dict:
    """Phase 31's functions of a signal tensor, by name."""
    import crlot_tpu_torch as pt

    def mel(x):
        return pt.mel_spectrogram(x, cfg, SR)

    return {
        "mel_spectrogram": mel,
        "mfcc": lambda x: pt.mfcc(x, cfg, SR),
        "pcen": lambda x: pt.pcen(mel(x), SR / HOP),
        "spectral_centroid": lambda x: pt.spectral_centroid(x, cfg, SR),
        "spectral_bandwidth": lambda x: pt.spectral_bandwidth(x, cfg, SR),
        "spectral_rolloff": lambda x: pt.spectral_rolloff(x, cfg, SR),
        "spectral_flatness": lambda x: pt.spectral_flatness(x, cfg),
        "spectral_contrast": lambda x: pt.spectral_contrast(x, cfg, SR),
        "chroma": lambda x: pt.chroma(x, cfg, SR),
        "chroma_cqt": lambda x: pt.chroma_cqt(x, cfg, SR),
        "lpc": lambda x: pt.lpc(x, cfg, order=LPC_ORDER),
        "zero_crossing_rate": lambda x: pt.zero_crossing_rate(x, cfg),
        "frame_rms": lambda x: pt.frame_rms(x, cfg),
        "envelope": lambda x: pt.envelope(x),
    }


def _feature_err(name, got, want) -> float:
    """got (float32, numpy) against want (float64) as FEATURE_TOL measures
    it: the fraction of the bound used (<= 1 passes)."""
    import numpy as np

    d = np.abs(got.astype(np.float64) - want)
    if name == "spectral_rolloff":
        return float(d.max()) / (SR / NFFT)
    if name == "mfcc":
        return float(d.max()) / FEATURE_TOL[name]
    if name == "lpc":
        return float((d / (FEATURE_TOL[name] * np.abs(want) + 5e-4)).max())
    return float(d.max()) / (FEATURE_TOL[name] * float(np.abs(want).max()))


def _silence_signal():
    """Phase 33's 60 s mono signal: ten 6 s blocks of 2 s of digital
    silence then a 4 s tone (220 + 110 k Hz, amplitude 0.5); returns it
    and the tones' sample spans."""
    import numpy as np

    block, gap = 6 * SR, 2 * SR
    x = np.zeros(SECONDS * SR, np.float32)
    spans = []
    t = np.arange(block - gap) / SR
    for k in range(SECONDS // 6):
        s = k * block + gap
        x[s : s + block - gap] = 0.5 * np.sin(2 * np.pi * (220 + 110 * k) * t)
        spans.append((s, s + block - gap))
    return x, spans


def _c18_scan(sos, x2, variant):
    """`iir._cascade` on x2 [B, T] from a zero state in one of C18's scan
    variants: "float64" (sosfilt's), "float32", or "float32_f64_combines"
    (float32 storage, each combine computed in float64 and rounded)."""
    import torch

    from crlot_tpu_torch import iir

    orig = iir._combine

    def combine(m1, v1, m2, v2):
        m, v = orig(m1.double(), v1.double(), m2.double(), v2.double())
        return m.float(), v.float()

    dtype = torch.float64 if variant == "float64" else torch.float32
    if variant == "float32_f64_combines":
        iir._combine = combine
    try:
        y, _ = iir._cascade(sos, x2, x2.new_zeros((sos.shape[0],
                                                   x2.shape[0], 2)), dtype)
    finally:
        iir._combine = orig
    return y.float()


def analysis_path(dev, phase, check, failures, x_np) -> dict:
    """Phases 30-33, with the B1 and B0 fp32 counters reset just before:
    the IIR filters, the features, Griffin-Lim and the segmentation on the
    card. The counts are those of the path's untimed calls: every timed or
    profiled repeat puts them back as it found them. Every B0 fp32 launch
    of those calls is held against its plain version (`ProductHold`)."""
    import numpy as np
    import scipy.signal
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import griffinlim
    from crlot_tpu_torch.fft import fp32_window as b0f
    from crlot_tpu_torch.metrics import snr_db
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.profile_paths import _activities, _device_events

    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    x = torch.from_numpy(x_np).to(dev)
    x_cpu = torch.from_numpy(x_np)
    out = {"results": {}}
    b1.launches = 0
    b0f.launches = 0
    hold = ProductHold(check)

    def held(fn):
        """One untimed call of the path, its B0 fp32 launches held."""
        with hold:
            got = fn()
            sync()
        hold.verify()
        return got

    def uncounted(fn):
        """A timing repeat: the launch counts are put back afterwards."""
        counted = b1.launches, b0f.launches
        try:
            return fn()
        finally:
            b1.launches, b0f.launches = counted

    def host_rate(fn, samples, reps=3):
        def run():
            fn()
            sync()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                sync()
                times.append(time.perf_counter() - t0)
            return times

        times = uncounted(run)
        return samples / statistics.median(times), statistics.median(times)

    def profiled(fn, calls=2):
        """(device ms a call, top device events) over `calls` calls."""
        def run():
            with torch.profiler.profile(activities=_activities(dev)) as prof:
                for _ in range(calls):
                    fn()
                sync()
            return prof

        rows = _device_events(uncounted(run))
        dev_ms = sum(us for _, us in rows.values()) / 1e3 / calls
        top = sorted(rows.items(), key=lambda r: -r[1][1])[:4]
        return dev_ms, ", ".join(f"{k[:32]} x{c / calls:g} "
                                 f"{us / calls / 1e3:.2f} ms"
                                 for k, (c, us) in top)

    def wide_signal():
        g = torch.Generator(device=dev).manual_seed(ANALYSIS_SEED)
        return torch.rand((STREAM_CH, STREAM_CHUNK), generator=g,
                          device=dev) * 1.8 - 0.9

    def wide(label, fn):
        """One untimed call of fn at config 5's width (its B0 fp32 launches
        held), then its samples/s, idle share and peak memory."""
        x5 = wide_signal()
        got = held(lambda: fn(x5))
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite at "
              f"{STREAM_CH} x {STREAM_CHUNK}")
        del got
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        rate, wall = host_rate(lambda: fn(x5), x5.numel())
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
        dev_ms, top = profiled(lambda: fn(x5))
        idle = 1 - dev_ms / (wall * 1e3)
        out["results"][label] = dict(rate=rate, wall_ms=wall * 1e3,
                                     device_ms=dev_ms, idle=idle, peak=peak)
        return (f"{label} at {STREAM_CH} x {STREAM_CHUNK}: {rate:.4e} "
                f"samples/s ({wall * 1e3:.2f} ms host clock, median of 3), "
                f"device {dev_ms:.2f} ms, idle share {idle:.3f}, peak "
                f"memory {peak:.2f} GiB; device events {top}")

    def p30():
        lines = []
        x64 = x_np.astype(np.float64)
        sos8 = pt.butter_sos(8, 1000.0, "lowpass", fs=SR)
        sos_a = pt.a_weighting_sos(float(SR))
        b4, a4 = scipy.signal.butter(4, 0.25)
        filters = {
            "sosfilt butter_sos(8, 1 kHz)": (
                lambda z: pt.sosfilt(sos8, z),
                lambda: scipy.signal.sosfilt(sos8, x64, axis=-1), 70.0),
            "sosfilt a_weighting_sos(48 kHz)": (
                lambda z: pt.sosfilt(sos_a, z),
                lambda: scipy.signal.sosfilt(sos_a, x64, axis=-1), 70.0),
            "lfilter butter(4, 0.25)": (
                lambda z: pt.lfilter(b4, a4, z),
                lambda: scipy.signal.lfilter(b4, a4, x64, axis=-1), 70.0),
            "sosfiltfilt butter_sos(8, 1 kHz)": (
                lambda z: pt.sosfiltfilt(sos8, z),
                lambda: scipy.signal.sosfiltfilt(sos8, x64, axis=-1), 70.0),
            "deemphasis(preemphasis(x))": (
                lambda z: pt.deemphasis(pt.preemphasis(z)),
                lambda: x64, 100.0),
        }
        for name, (fn, oracle, gate) in filters.items():
            got = fn(x)
            sync()
            check(tuple(got.shape) == tuple(x.shape), f"{name}: shape")
            g = got.cpu()
            snr = snr_db(oracle().astype(np.float32), g.numpy())
            check(snr >= gate, f"{name}: {snr:.2f} dB vs float64 (< {gate})")
            same = torch.equal(g, fn(x_cpu))
            check(same, f"{name}: card != the port on the host CPU")
            lines.append(f"{name} {snr:.2f} dB vs float64, == host CPU")
        y1 = pt.sosfilt(sos8, x)
        z = torch.zeros((sos8.shape[0], 2, 2), device=dev)
        parts = []
        for c in x.split(IIR_CHUNK, dim=-1):
            y, z = pt.sosfilt(sos8, c, zi=z)
            parts.append(y)
        chunked = torch.cat(parts, dim=-1)
        sync()
        snr = snr_db(y1.cpu().numpy(), chunked.cpu().numpy())
        check(snr > 90.0, f"chunked vs one-shot {snr:.2f} dB (<= 90)")
        lines.append(f"chunks of {IIR_CHUNK} with carried zi vs one-shot "
                     f"{snr:.2f} dB (> 90, tests/test_iir.py's gate; "
                     f"bit-equal {torch.equal(y1, chunked)})")
        lines.append(wide("sosfilt butter_sos(8)",
                          lambda z: pt.sosfilt(sos8, z)))
        # C18: what a float32 scan would lose, and what float64 costs.
        c18 = {}
        for dname, sos in (("A", sos_a), ("C", pt.c_weighting_sos(float(SR)))):
            want = scipy.signal.sosfilt(sos, x64, axis=-1).astype(np.float32)
            for v in C18_VARIANTS:
                got = _c18_scan(sos, x, v).cpu().numpy()
                c18[f"{dname} {v} dB"] = snr_db(want, got)
        check(min(c18["A float64 dB"], c18["C float64 dB"]) >= 70.0,
              f"C18: the float64 scan of the weighting filters: {c18}")
        x5 = wide_signal()
        for v in C18_VARIANTS:
            c18[f"{v} ms"] = 1e3 * host_rate(
                lambda: _c18_scan(sos_a, x5, v), x5.numel())[1]
        del x5
        out["results"]["c18"] = c18
        lines.append(
            "C18 (sosfilt's cascade in each scan variant) vs scipy float64: "
            + ", ".join(f"{d} {v} {c18[f'{d} {v} dB']:.2f} dB"
                        for d in "AC" for v in C18_VARIANTS)
            + f"; a_weighting_sos ({sos_a.shape[0]} sections) at "
            f"{STREAM_CH} x {STREAM_CHUNK}: " + ", ".join(
                f"{v} {c18[f'{v} ms']:.2f} ms" for v in C18_VARIANTS)
            + " (host clock, median of 3)")
        return "; ".join(lines)

    def p31():
        lines = []
        want = _f64_features(x_np, cfg)
        f0 = FEATURE_FRAMES
        worst = {}
        for name, fn in _feature_calls(cfg).items():
            g = held(lambda: fn(x)).cpu().numpy()
            h = fn(x_cpu).numpy()
            check(g.shape == h.shape and np.isfinite(g).all(),
                  f"{name}: shape {g.shape} or non-finite")
            ref = want[name]
            sl = (slice(None),) if name == "envelope" else (
                slice(None), slice(0, f0))
            e_card = _feature_err(name, g[sl], ref)
            e_cpu = _feature_err(name, h[sl], ref)
            e_pair = _feature_err(name, g, h.astype(np.float64)) / 2
            worst[name] = (e_card, e_cpu, e_pair)
            check(max(e_card, e_cpu, e_pair) <= 1.0,
                  f"{name}: card {e_card:.3g}, host CPU {e_cpu:.3g}, card vs "
                  f"host CPU {e_pair:.3g} of the bound")
        lines.append("fraction of the bound vs float64 (card / host CPU port "
                     "/ card vs host CPU at twice it): " + ", ".join(
                         f"{k} {a:.3g}/{b:.3g}/{c:.3g}"
                         for k, (a, b, c) in worst.items()))
        out["results"]["feature_worst"] = max(
            max(v) for v in worst.values())
        sos8 = pt.butter_sos(8, 1000.0, "lowpass", fs=SR)
        # The envelope's FFT runs over whole channels, batched by the FFT
        # library (the CPU's vectorizes across rows): not held here.
        split = dict(_feature_calls(cfg), **{
            "sosfilt": lambda z: pt.sosfilt(sos8, z),
            "pseudo_cqt": lambda z: pt.pseudo_cqt(z, cfg, SR),
            "tonnetz": lambda z: pt.tonnetz(z, cfg, SR),
        })
        del split["envelope"]
        equal = {}
        for name, fn in split.items():
            whole = held(lambda: fn(x))
            shards = torch.cat([held(lambda: fn(x[:1].clone())),
                                held(lambda: fn(x[1:].clone()))])
            equal[name] = torch.equal(whole, shards)
            if not equal[name]:
                err = float((whole - shards).abs().max())
                equal[name] = f"max-abs {err:.3g}"
        out["results"]["split"] = equal
        check(all(v is True for v in equal.values()),
              f"two 1-channel shards != the 2-channel call: {equal}")
        lines.append("two 1-channel shards torch.equal to the 2-channel "
                     "call: " + ", ".join(equal))
        lines.append(wide("mel_spectrogram + pcen", lambda z: pt.pcen(
            pt.mel_spectrogram(z, cfg, SR), SR / HOP)))
        lines.append(hold.summary())
        return "; ".join(lines)

    def p32():
        lines = []
        cfg_s = dataclasses.replace(cfg, synthesis_window=True)
        n = x_np.shape[-1]
        t = np.arange(n) / SR
        tones = (0.3 * np.sin(2 * np.pi * 440 * t)
                 + 0.2 * np.sin(2 * np.pi * 1337 * t)
                 + 0.1 * np.sin(2 * np.pi * 3000 * t))
        dur = n / SR
        chirp = 0.4 * np.sin(2 * np.pi * (100 * t + (8000 - 100) / (2 * dur)
                                          * t * t))
        xg = torch.from_numpy(np.stack([tones, chirp]).astype(np.float32))
        mag = pt.stft_magnitude(xg.to(dev), cfg_s)
        before = b1.launches
        y = pt.griffin_lim(mag, cfg_s, iters=GL_ITERS, length=n)
        sync()
        gl_b1 = b1.launches - before
        check(tuple(y.shape) == (2, n) and bool(torch.isfinite(y).all()),
              "griffin_lim: shape or non-finite")
        if cuda:
            check(gl_b1 == GL_ITERS + 1,
                  f"griffin_lim launched B1 {gl_b1} times, not {GL_ITERS + 1}")
        m2 = pt.stft_magnitude(y, cfg_s)
        sc = 20 * math.log10(float(torch.linalg.norm(m2 - mag))
                             / float(torch.linalg.norm(mag)))
        check(sc <= -20.0, f"spectral convergence {sc:.2f} dB (> -20)")
        _, wall = host_rate(lambda: pt.griffin_lim(
            mag, cfg_s, iters=GL_ITERS, length=n), 1)
        dev_ms, top = profiled(lambda: pt.griffin_lim(
            mag, cfg_s, iters=GL_ITERS, length=n))
        out["results"].update(gl_sc=sc, gl_wall_ms=wall * 1e3,
                              gl_device_ms=dev_ms, gl_b1=gl_b1)
        lines.append(f"griffin_lim 2 x {n} (tones + chirp), {GL_ITERS} iters: "
                     f"spectral convergence {sc:.2f} dB (<= -20), B1 "
                     f"launches {gl_b1} (iters + 1); {wall * 1e3:.2f} ms host "
                     f"clock (median of 3), device {dev_ms:.2f} ms, idle "
                     f"share {1 - dev_ms / (wall * 1e3):.3f}; device events "
                     f"{top}")
        mag_cpu = mag.cpu()
        ph0 = griffinlim.initial_phase(mag.shape, 0, "cpu")
        ph0_card = griffinlim.initial_phase(mag.shape, 0, dev)
        check(torch.equal(ph0_card.cpu(), ph0),
              "griffin_lim's initial phase: card != host CPU")
        lines.append(f"initial phase ({ph0.numel()} values, hashed on the "
                     f"magnitude's device) torch.equal to the host CPU's")
        yc = griffinlim._griffin_lim_from(mag, ph0_card, cfg_s,
                                          GL_CHECK_ITERS, 0.99, n)
        yh = griffinlim._griffin_lim_from(mag_cpu, ph0, cfg_s,
                                          GL_CHECK_ITERS, 0.99, n)
        snr = snr_db(yh.numpy(), yc.cpu().numpy())
        check(snr >= 90.0, f"card vs host CPU at {GL_CHECK_ITERS} iters "
              f"{snr:.2f} dB (< 90)")
        lines.append(f"card vs host CPU from one initial phase at "
                     f"{GL_CHECK_ITERS} iters: {snr:.2f} dB (>= 90)")
        mel = held(lambda: pt.mel_spectrogram(xg.to(dev), cfg_s, SR,
                                              n_mels=128))
        with hold:
            t0 = time.perf_counter()
            ya = pt.mel_to_audio(mel, cfg_s, SR, n_mels=128, length=n)
            sync()
            wall = time.perf_counter() - t0
        hold.verify()
        check(tuple(ya.shape) == (2, n) and bool(torch.isfinite(ya).all()),
              "mel_to_audio: shape or non-finite")
        dev_ms, top = profiled(lambda: pt.mel_to_audio(
            mel, cfg_s, SR, n_mels=128, length=n))
        out["results"].update(m2a_wall_ms=wall * 1e3, m2a_device_ms=dev_ms)
        lines.append(f"mel_to_audio (128 mels, 32 NNLS + 32 Griffin-Lim "
                     f"iters) once: {wall * 1e3:.2f} ms host clock, device "
                     f"{dev_ms:.2f} ms (two more, profiled calls); device "
                     f"events {top}")
        lines.append(f"phases 31-32 together: {hold.summary()}")
        return "; ".join(lines)

    def p33():
        xs, spans = _silence_signal()
        xd = torch.from_numpy(xs).to(dev)
        iv = pt.split_silence(xd, cfg, top_db=40.0)
        iv_cpu = pt.split_silence(xs, cfg, top_db=40.0, device="cpu")
        check(iv == iv_cpu, f"split_silence: card {iv} != host CPU {iv_cpu}")
        check(len(iv) == len(spans), f"{len(iv)} regions, not {len(spans)}")
        for (s, e), (ts, te) in zip(iv, spans):
            check(ts - NFFT < s <= ts and te <= e < te + NFFT,
                  f"region ({s}, {e}) vs the tone ({ts}, {te})")
        trimmed, se = pt.trim_silence(xd, cfg, top_db=40.0)
        _, se_cpu = pt.trim_silence(xs, cfg, top_db=40.0, device="cpu")
        check(se == se_cpu and se == (iv[0][0], iv[-1][1]),
              f"trim_silence: card {se}, host CPU {se_cpu}")
        check(torch.equal(trimmed, xd[se[0] : se[1]]), "trimmed slice")
        return (f"{len(iv)} regions on a {SECONDS} s signal with 2 s gaps, "
                f"equal to the host CPU's, each covering its tone within a "
                f"frame; trim_silence {se}")

    phase("30 IIR on the card (sosfilt, lfilter, sosfiltfilt, effects)", p30)
    phase("31 features on the card", p31)
    phase("32 Griffin-Lim on the card (B1 each iteration)", p32)
    phase("33 trim_silence / split_silence", p33)
    out["counts"] = {"b1": b1.launches, "b0_fp32": b0f.launches}
    log(f"analysis path launches (its untimed calls): B1 "
        f"{out['counts']['b1']}, B0 fp32 (the features' filterbank "
        f"products) {out['counts']['b0_fp32']}, of which held against plain "
        f"{hold.held}")
    if cuda and (not all(out["counts"].values())
                 or hold.held != out["counts"]["b0_fp32"]):
        failures.append("launch counts (path 7)")
        log("FAIL launch counts: a kernel of the path was not launched, or "
            "a B0 fp32 launch was not held against plain")
    return out


CT_NFFTS = (8192, 16384, 1023, 6000)  # phase 34: CT, CT, dense, torch.fft
CT_ROWS = 64
HPSS_KERNEL = 31
YIN_TONES = ((110.0, 440.0), (220.0, 880.0))  # per channel, 30 s each
STRETCH_RATES = (0.8, 1.1, 1.5)
SHIFT_SEMITONES = (-12.0, -1.0, 3.0, 7.0, 12.0)
DTW_NFFT, DTW_HOP = 4096, 1024
PITCH_TOL = 1e-5  # card vs host CPU, of the largest |value|


class LaunchHold:
    """Every launch of a kernel wrapper while the context is open, held at
    once against its plain version on the same operands: B1
    (`ola_normalized_cuda`) torch.equal to `ola_normalized_plain`, as phase
    1 holds it; B4 (`resample_cuda`, as `resample` calls it) within max-abs
    1e-5 of `resample_bank_plain`, as phase 11 holds it. Records each
    launch's geometry and error."""

    def __init__(self, check):
        from crlot_tpu_torch.ola import fused as b1
        from crlot_tpu_torch.resample import kernel as b4
        from crlot_tpu_torch.resample import polyphase

        self.mods, self.check = (b1, b4, polyphase), check
        self.seen = {"b1": [], "b4": []}

    def __enter__(self):
        import torch

        b1, b4, polyphase = self.mods
        self.orig = b1.ola_normalized_cuda, polyphase.resample_cuda
        ola, res = self.orig

        def ola_spy(frames, norm, hop, out_len, eps=1e-8):
            out = ola(frames, norm, hop, out_len, eps)
            want = b1.ola_normalized_plain(frames, norm, hop, out_len, eps)
            err = float((out - want).abs().max())
            self.check(torch.equal(out, want), f"B1 at hop {hop}, "
                       f"{tuple(frames.shape)}: not bit-exact, {err:.3g}")
            self.seen["b1"].append((hop, tuple(frames.shape), err))
            return out

        def res_spy(x, l, m, n_out, taps_per_phase=None, atten_db=120.0,
                    plan=None):
            out = res(x, l, m, n_out, taps_per_phase, atten_db, plan)
            want = b4.resample_bank_plain(x, l, m, n_out, taps_per_phase,
                                          atten_db)
            err = float((out - want).abs().max())
            self.check(err <= 1e-5, f"B4 at L/M {l}/{m}: max-abs {err:.3g}")
            self.seen["b4"].append((f"{l}/{m}", tuple(x.shape), err))
            return out

        b1.ola_normalized_cuda, polyphase.resample_cuda = ola_spy, res_spy
        return self

    def __exit__(self, *exc):
        b1, _, polyphase = self.mods
        b1.ola_normalized_cuda, polyphase.resample_cuda = self.orig


class ToolingHold:
    """Every kernel launch of the tooling path (phases 44-48) that the
    counters count, held at once against its plain version on its own
    operands. The timed repeats and graph captures run inside
    `bench.launches.uncounted()`: they pass unheld and leave no count.
    Tolerances as the earlier phases hold each kernel: B0 (3xTF32) within
    tf32x3.REL_TOL of sum |x||k| per output (`KernelHold`); B0 fp32
    torch.equal to the fmaf chain (`ProductHold`); B1 and its seeded
    variant torch.equal (phases 1, 51); B2 and B3 within max-abs 1e-5 outside the frames whose gate
    decision is ambiguous (phases 2 and 7; B2's output times the norm
    over its peak, so the ends where the norm tends to 0 do not amplify
    the frames' roundoff); B4 within max-abs 1e-5 of
    `resample_bank_plain` (phase 11); K5, K6 torch.equal, K6's cleared
    ring all zero (phase 12); B6's int16 limb modes torch.equal (phase
    18); B7 within (h+1) 2^-24 sum |a||b| of its float64 products
    (`stft_tolerance`, phase 53). The scan form of B3 runs ungated on this path, so it has no
    ambiguous frames. `verify` fails unless every launch counted was
    held (B1 counts B2's own overlap-add launch, held with B2) and the
    ambiguous frames stay under 0.1 % of those held."""

    def __init__(self, check):
        from crlot_tpu_torch import int8_gemm, streaming_pipeline
        from crlot_tpu_torch.bench import launches
        from crlot_tpu_torch.fft import fp32_window, fused_rt, tf32x3
        from crlot_tpu_torch.ola import fused
        from crlot_tpu_torch.ola import kernels as b5
        from crlot_tpu_torch.resample import kernel as b4
        from crlot_tpu_torch.resample import polyphase

        self.check, self.launches = check, launches
        self.mods = dict(b0=tf32x3, b0f=fp32_window, b1=fused, b3=fused_rt,
                         sp=streaming_pipeline, b4=b4, poly=polyphase, b5=b5,
                         b6=int8_gemm)
        self.held = dict.fromkeys(launches.launch_counts(), 0)
        self.worst = {"B0": 0.0, "B2": 0.0, "B3": 0.0, "B4": 0.0,
                      "B7": 0.0}
        self.exact = []  # (kernel, what, mismatches on the card)
        self.left_out = self.frames = 0

    # The spies: (module key, attribute, kernel, holder).
    def _spies(self):
        return [("b0", "gemm_cuda", "B0", self._b0),
                ("b0f", "gemm_cuda", "B0_fp32", self._b0f),
                ("b0f", "stft_cuda", "B7", self._b7),
                ("b1", "ola_normalized_cuda", "B1", self._b1),
                ("b1", "ola_seeded_cuda", "B1_seeded", self._b1_seeded),
                ("b3", "roundtrip_signal_cuda", "B2", self._b2),
                ("b3", "roundtrip_frames_cuda", "B3", self._b3),
                ("sp", "roundtrip_of_frames", "B3", self._b3_scan),
                ("poly", "resample_cuda", "B4", self._b4),
                ("b5", "axpy_windowed_cuda", "K5", self._k5),
                ("b5", "normalize_and_clear_cuda", "K6", self._k6),
                ("b6", "limb_gemm_i16_cuda", "B6_limb", self._limb)]

    def __enter__(self):
        self.orig = []
        for mod, attr, kernel, holder in self._spies():
            m = self.mods[mod]
            launch = getattr(m, attr)
            self.orig.append((m, attr, launch))

            def spy(*a, _launch=launch, _kernel=kernel, _holder=holder,
                    **k):
                out = _launch(*a, **k)
                if self.launches.counting() and _holder(out, *a, **k):
                    self.held[_kernel] += 1
                return out

            setattr(m, attr, spy)
        return self

    def __exit__(self, *exc):
        for m, attr, launch in self.orig:
            setattr(m, attr, launch)

    def _equal(self, kernel, what, got, want):
        self.exact.append((kernel, what, (got != want).sum()))

    def _b0(self, out, a, bt_hi, bt_lo, rows=None, lda=None):
        import torch

        from crlot_tpu_torch.int8_gemm import _as_signal, windows

        b0 = self.mods["b0"]
        want = b0.gemm_plain(a, bt_hi, bt_lo, rows=rows, lda=lda)
        x, r, ld = _as_signal(a, rows, lda)
        scale = torch.matmul(windows(x, r, ld, bt_hi.shape[1]).abs(),
                             (bt_hi + bt_lo).T.abs())
        rel = float(((out - want).abs() / scale.clamp_min(1e-30)).max())
        self.worst["B0"] = max(self.worst["B0"], rel)
        self.check(rel <= b0.REL_TOL, f"B0 [{list(x.shape)}, {r} rows at "
                   f"lda {ld}]: {rel:.3e} of sum|x||k| from plain")
        return True

    def _b0f(self, out, a, kern, rows=None, lda=None):
        want = self.mods["b0f"].chain_plain(a, kern, rows=rows, lda=lda)
        self._equal("B0_fp32", f"{list(a.shape)} x {list(kern.shape)}", out,
                    want)
        return True

    def _b7(self, out, frames, nfft, window):
        import torch

        b7 = self.mods["b0f"]
        want = b7.stft_plain(frames, nfft, window)
        tol = b7.stft_tolerance(frames, nfft, window)
        d = out.to(torch.complex128) - want
        over = int(((d.real.abs() > tol.real)
                    | (d.imag.abs() > tol.imag)).sum())
        rel = float(d.abs().max() / want.abs().max().clamp_min(1e-30))
        self.worst["B7"] = max(self.worst["B7"], rel)
        self.check(over == 0, f"B7 {list(frames.shape)} at N {nfft}: {over}"
                   " outputs off their bound from the float64 DFT")
        return True

    def _b1(self, out, frames, norm, hop, out_len, eps=1e-8):
        want = self.mods["b1"].ola_normalized_plain(frames, norm, hop,
                                                    out_len, eps)
        self._equal("B1", f"hop {hop}, {list(frames.shape)}", out, want)
        return True

    def _b1_seeded(self, out, frames, hop, t0, length, f_lo, f_hi,
                   seed=None, norm=None, eps=1e-8):
        want = self.mods["b1"].ola_seeded_plain(frames, hop, t0, length,
                                                f_lo, f_hi, seed, norm, eps)
        self._equal("B1_seeded", f"hop {hop}, {list(frames.shape)}, "
                    f"[{t0}, +{length}), frames [{f_lo}, {f_hi})", out, want)
        return True

    def _gate_err(self, kernel, what, out, want, mask, cover=None,
                  weight=1.0):
        import torch

        keep = ~(mask[..., None] if cover is None else cover)
        err = float(torch.where(keep, (out - want).abs() * weight,
                                0.0).max())
        self.worst[kernel] = max(self.worst[kernel], err)
        self.left_out += int(mask.sum())
        self.frames += mask.numel()
        self.check(err <= 1e-5, f"{kernel} {what}: max-abs {err:.3e} from "
                   f"plain outside {int(mask.sum())} ambiguous frames")
        return True

    def _b2(self, out, padded, nfft, hop, n_frames, window_f32, norm, eps,
            out_len, spectral_packed=None):
        b3 = self.mods["b3"]
        want = b3.roundtrip_signal_plain(padded, nfft, hop, n_frames,
                                         window_f32, norm, eps, out_len,
                                         spectral_packed)
        mask = b3.ambiguous_frames(padded, nfft, hop, n_frames, window_f32,
                                   spectral_packed)
        full = (n_frames - 1) * hop + nfft
        cover = b3.frames_cover(mask, hop, nfft, full)[..., :out_len]
        # The overlap-added frames, before the divide: at the padded
        # signal's ends the norm tends to 0 and the divide amplifies the
        # frames' roundoff (phase 2 holds the interior, where it is flat).
        n = norm.reshape(-1)[:out_len].clamp_min(eps)
        return self._gate_err("B2", f"{list(padded.shape)}, {n_frames} "
                              "frames (times norm / its peak)", out, want,
                              mask, cover, n / n.max())

    def _b3(self, out, padded, nfft, hop, n_frames, window_f32,
            spectral_packed=None):
        b3 = self.mods["b3"]
        want = b3.roundtrip_frames_plain(padded, nfft, hop, n_frames,
                                         window_f32, spectral_packed)
        mask = b3.ambiguous_frames(padded, nfft, hop, n_frames, window_f32,
                                   spectral_packed)
        return self._gate_err("B3", f"{list(padded.shape)}, {n_frames} "
                              "frames", out, want, mask)

    def _b3_scan(self, out, frames, nfft, window_f32, spectral_packed=None):
        """B3 on a frame tensor (the scan form); on the CPU it runs its
        plain version and launches nothing."""
        import torch

        if frames.device.type == "cpu":
            return False
        b3 = self.mods["b3"]
        w = window_f32.to(frames.device, torch.float32)
        want = b3.roundtrip_of_frames_plain(frames.float(), nfft, w,
                                            spectral_packed)
        mask = torch.zeros(frames.shape[:-1], dtype=torch.bool,
                           device=frames.device)  # the path's are ungated
        return self._gate_err("B3", f"frames {list(frames.shape)}", out,
                              want, mask)

    def _b4(self, out, x, l, m, n_out, taps_per_phase=None, atten_db=120.0,
            plan=None):
        want = self.mods["b4"].resample_bank_plain(x, l, m, n_out,
                                                   taps_per_phase, atten_db)
        err = float((out - want).abs().max())
        self.worst["B4"] = max(self.worst["B4"], err)
        self.check(err <= 1e-5, f"B4 at L/M {l}/{m} on {list(x.shape)}: "
                   f"max-abs {err:.3g} from plain")
        return True

    def _k5(self, out, dst, src, win, gain):
        self._equal("K5", f"n {dst.numel()}", out,
                    self.mods["b5"].axpy_windowed_reference(dst, src, win,
                                                            gain))
        return True

    def _k6(self, out, acc, norm, eps):
        o, cleared = out
        want = self.mods["b5"].normalize_and_clear_reference(acc, norm, eps)
        self._equal("K6", f"n {acc.numel()}", o, want[0])
        self._equal("K6", f"n {acc.numel()} (cleared)", cleared, want[1])
        return True

    def _limb(self, out, x, b0, b1, epilogue, scale=1.0, rows=None,
              lda=None):
        self._equal("B6_limb", f"{epilogue} {list(x.shape)}, {rows} rows",
                    out, self.mods["b6"].limb_gemm_i16_plain(
                        x, b0, b1, epilogue, scale, rows, lda))
        return True

    def verify(self, counts) -> str:
        """Resolve the exact holds; fail unless every launch in `counts`
        (the counters since the reset) was held. Returns the summary."""
        import torch

        if self.exact:
            bad = torch.stack([d for _, _, d in self.exact]).cpu().tolist()
            for (kernel, what, _), n in zip(self.exact, bad):
                self.check(n == 0, f"{kernel} {what}: {n} values differ from"
                           " plain")
            self.exact.clear()
        want = dict(self.held)
        want["B1"] += counts["B2"]  # B2's own overlap-add launch
        unheld = {k: counts[k] - want[k] for k in counts
                  if counts[k] != want[k]}
        self.check(not unheld, f"launches counted but not held: {unheld}")
        self.check(self.left_out <= 1e-3 * max(self.frames, 1),
                   f"{self.left_out} of {self.frames} frames ambiguous")
        return ("every counted launch held against plain: " + ", ".join(
            f"{k} {v}" for k, v in self.held.items() if v)
            + f" (B0 worst {self.worst['B0']:.3e} of sum|x||k|; B2, B3 "
            f"max-abs {self.worst['B2']:.3e}, {self.worst['B3']:.3e} "
            f"outside {self.left_out} ambiguous frames of {self.frames}; "
            f"B4 {self.worst['B4']:.3e}; B7 {self.worst['B7']:.3e} of the "
            f"largest bin; the rest torch.equal)")


def _dtw_f64(c) -> "np.ndarray":
    """The accumulated-cost matrix of c in float64, by anti-diagonals (each
    depends only on the two before it)."""
    import numpy as np

    n, m = c.shape
    d = np.full((n, m), np.inf)
    d[0] = np.cumsum(c[0])
    d[:, 0] = np.cumsum(c[:, 0])
    for s in range(2, n + m - 1):
        i = np.arange(max(1, s - m + 1), min(n, s))
        j = s - i
        d[i, j] = c[i, j] + np.minimum(np.minimum(d[i - 1, j], d[i, j - 1]),
                                       d[i - 1, j - 1])
    return d


def _note_sequence(seed, seconds, warp):
    """A mono sequence of 0.25-1 s notes (a fundamental and two partials,
    frequencies from `seed`) filling `seconds`; `warp` scales each note's
    length by its own factor in [0.75, 1.33] and rescales the whole to the
    same span, so two calls differ by a monotone time warp."""
    import numpy as np

    rng = np.random.default_rng(seed)
    durs = rng.uniform(0.25, 1.0, 400)
    freqs = 110.0 * 2.0 ** (rng.integers(0, 36, 400) / 12.0)
    scale = rng.uniform(0.75, 1.33, 400)
    k = int(np.searchsorted(np.cumsum(durs), seconds))
    durs = durs[:k] * (scale[:k] if warp else 1.0)
    durs = durs * (seconds / durs.sum())
    out = []
    for d, f in zip(durs, freqs[:k]):
        t = np.arange(int(d * SR)) / SR
        env = np.minimum(1.0, np.minimum(t, d - t) / 0.01)
        out.append(env * (0.5 * np.sin(2 * np.pi * f * t)
                          + 0.2 * np.sin(4 * np.pi * f * t)
                          + 0.1 * np.sin(6 * np.pi * f * t)))
    x = np.concatenate(out)[: SR * seconds]
    return np.pad(x, (0, SR * seconds - x.size)).astype(np.float32)


def last_analysis_path(dev, phase, check, failures, x_np) -> dict:
    """Phases 34-39, with the B1, B4 and B0 fp32 counters reset just
    before: the FFT backends (C20), psd, hpss, pitch, the vocoder and DTW
    on the card. Counts are those of the untimed calls; every B0 fp32
    launch is held against its plain version (`ProductHold`), and in
    phases 36 and 38 every B1 and B4 launch too (`LaunchHold`)."""
    import numpy as np
    import scipy.signal
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import align
    from crlot_tpu_torch.fft import dispatch
    from crlot_tpu_torch.fft import fp32_window as b0f
    from crlot_tpu_torch.hpss import hpss_masks
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.profile_paths import _activities, _device_events
    from crlot_tpu_torch.resample import kernel as b4

    def sync():
        torch.cuda.synchronize(dev)

    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    n = x_np.shape[-1]
    x = torch.from_numpy(x_np).to(dev)
    out = {"results": {}}
    b1.launches = b4.launches = b0f.launches = 0
    hold = ProductHold(check)
    mm = pt.FftBackend.MATMUL

    def held(fn):
        with hold:
            got = fn()
            sync()
        hold.verify()
        return got

    def uncounted(fn):
        counted = b1.launches, b4.launches, b0f.launches
        try:
            return fn()
        finally:
            b1.launches, b4.launches, b0f.launches = counted

    def timed_call(fn, reps=3):
        """(median host-clock s, device ms a call, top device events) of
        fn, its launches not counted."""
        def run():
            fn()
            sync()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                sync()
                times.append(time.perf_counter() - t0)
            with torch.profiler.profile(activities=_activities(dev)) as prof:
                fn()
                sync()
            return statistics.median(times), _device_events(prof)

        wall, rows = uncounted(run)
        dev_ms = sum(us for _, us in rows.values()) / 1e3
        top = sorted(rows.items(), key=lambda r: -r[1][1])[:4]
        return wall, dev_ms, ", ".join(f"{k[:32]} x{c:g} {us / 1e3:.2f} ms"
                                       for k, (c, us) in top)

    def halves(fn, z):
        """fn of two 1-channel shards, concatenated on the channel axis."""
        return torch.cat([fn(z[:1].clone()), fn(z[1:].clone())])

    def rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def p34():
        lines = []
        g = np.random.default_rng(SEED)
        for nfft in CT_NFFTS:
            xr = g.uniform(-1, 1, (CT_ROWS, nfft)).astype(np.float32)
            xc = (g.standard_normal((CT_ROWS, nfft))
                  + 1j * g.standard_normal((CT_ROWS, nfft))).astype(
                      np.complex64)
            tr, tc = torch.from_numpy(xr).to(dev), torch.from_numpy(xc).to(dev)
            spec = dispatch.rfft(tr, nfft, mm)
            back = dispatch.irfft(spec, nfft, mm)
            cs = dispatch.fft_complex(tc, nfft, mm)
            cb = dispatch.ifft_complex(cs, nfft, mm)
            sync()
            want = np.fft.rfft(xr.astype(np.float64), axis=-1)
            wc = np.fft.fft(xc.astype(np.complex128), axis=-1)
            e_r = np.max(np.abs(spec.cpu().numpy() - want)) / nfft
            rmse = float(np.sqrt(np.mean((back.cpu().numpy() - xr) ** 2)))
            e_c = np.max(np.abs(cs.cpu().numpy() - wc)) / nfft
            e_cb = float(np.max(np.abs(cb.cpu().numpy() - xc)))
            check(e_r < 2e-6 and rmse < 1e-5 and e_c < 2e-6 and e_cb < 1e-3,
                  f"nfft {nfft}: rfft {e_r:.3g}/N, round trip rmse "
                  f"{rmse:.3g}, fft {e_c:.3g}/N, ifft {e_cb:.3g}")
            lines.append(f"N {nfft}: rfft {e_r:.2e}/N (< 2e-6), rmse "
                         f"{rmse:.2e} (< 1e-5), fft {e_c:.2e}/N, ifft back "
                         f"{e_cb:.2e} (< 1e-3)")
        c8 = pt.StftConfig(frame_size=8192, hop_size=2048, center=True,
                           fft_backend=mm)
        y = pt.round_trip(x, c8)
        snr = pt.snr_db(x_np, y.cpu().numpy())
        check(snr > 80.0, f"round_trip at N 8192 (CT) {snr:.2f} dB")
        whole = pt.stft(x, c8)
        split = halves(lambda z: pt.stft(z, c8), x)
        eq = torch.equal(whole, split)
        out["results"]["ct_split"] = eq
        check(eq, f"STFT at N 8192: shards != the 2-channel call, max-abs "
              f"{float((whole - split).abs().max()):.3g}")
        wall, dev_ms, top = timed_call(lambda: pt.round_trip(x, c8))
        out["results"]["rt8192"] = (wall * 1e3, dev_ms)
        lines.append(f"round_trip N 8192 H 2048 MATMUL (CT) {snr:.2f} dB "
                     f"(> 80), {wall * 1e3:.2f} ms host clock, device "
                     f"{dev_ms:.2f} ms ({top}); two 1-channel shards of its "
                     f"STFT torch.equal to the 2-channel call")
        return "; ".join(lines)

    def p35():
        t = np.arange(n) / SR
        g = np.random.default_rng(SEED + 1)
        xp = (0.3 * g.standard_normal((2, n))
              + 0.5 * np.sin(2 * np.pi * np.array([[1000.0], [3000.0]]) * t)
              ).astype(np.float32)
        yp = (0.6 * xp + 0.3 * g.standard_normal((2, n))).astype(np.float32)
        xd, yd = torch.from_numpy(xp).to(dev), torch.from_numpy(yp).to(dev)
        lines = []
        calls = {
            "welch density": (lambda a, b: pt.welch_psd(a, cfg, SR),
                              lambda: scipy.signal.welch(
                                  xp.astype(np.float64), fs=SR, window="hann",
                                  nperseg=NFFT, noverlap=NFFT - HOP,
                                  detrend=False, scaling="density")[1]),
            "welch spectrum": (lambda a, b: pt.welch_psd(
                a, cfg, SR, "spectrum"), lambda: scipy.signal.welch(
                    xp.astype(np.float64), fs=SR, window="hann", nperseg=NFFT,
                    noverlap=NFFT - HOP, detrend=False,
                    scaling="spectrum")[1]),
            "coherence": (lambda a, b: pt.coherence(a, b, cfg),
                          lambda: scipy.signal.coherence(
                              xp.astype(np.float64), yp.astype(np.float64),
                              window="hann", nperseg=NFFT,
                              noverlap=NFFT - HOP, detrend=False)[1]),
        }
        for name, (fn, oracle) in calls.items():
            got = fn(xd, yd)
            want = oracle()
            g_np = got.cpu().numpy()
            err = float(np.sqrt(np.mean((g_np - want) ** 2))
                        / np.sqrt(np.mean(want ** 2)))
            host = fn(torch.from_numpy(xp), torch.from_numpy(yp))
            e_host = rel(got, host)
            split = torch.cat([fn(xd[:1].clone(), yd[:1].clone()),
                               fn(xd[1:].clone(), yd[1:].clone())])
            eq = torch.equal(split, got)
            check(err < 1e-4 and e_host <= PITCH_TOL and eq,
                  f"{name}: rel rmse vs scipy {err:.3g}, vs host CPU "
                  f"{e_host:.3g}, shards equal {eq}")
            lines.append(f"{name} rel rmse vs scipy float64 {err:.2e} "
                         f"(< 1e-4), vs host CPU {e_host:.2e} of the largest "
                         f"(<= {PITCH_TOL}), shards torch.equal")
        wall, dev_ms, top = timed_call(lambda: pt.welch_psd(xd, cfg, SR))
        out["results"]["welch"] = (wall * 1e3, dev_ms)
        lines.append(f"welch_psd {wall * 1e3:.2f} ms host clock, device "
                     f"{dev_ms:.2f} ms ({top})")
        return "; ".join(lines)

    def p36():
        t = np.arange(n) / SR
        tones = 0.4 * np.sin(2 * np.pi * np.array([[440.0], [660.0]]) * t)
        clicks = np.zeros((2, n))
        for p in range(2400, n - 16, 9600):
            clicks[:, p : p + 8] = 1.0
        xh_np = (tones + 0.5 * clicks).astype(np.float32)
        xh = torch.from_numpy(xh_np).to(dev)
        before = b1.launches
        with LaunchHold(check) as lh:
            h, p = pt.hpss(xh, cfg, HPSS_KERNEL, HPSS_KERNEL)
            sync()
        n_b1 = b1.launches - before
        check(n_b1 == 2, f"hpss launched B1 {n_b1} times, not 2")
        rt = pt.istft(pt.stft(xh, cfg), cfg, length=n)
        snr = pt.snr_db(rt.cpu().numpy(), (h + p).cpu().numpy())
        check(snr > 60.0, f"harmonic + percussive vs istft(stft) {snr:.2f} dB")
        e_h = (float(torch.sum(h.double() ** 2)), float(torch.sum(
            p.double() ** 2)))
        spec = pt.stft(xh, cfg)
        power = torch.abs(spec) ** 2
        mh, mp = hpss_masks(power, HPSS_KERNEL, HPSS_KERNEL)
        hh, hp = hpss_masks(power.cpu(), HPSS_KERNEL, HPSS_KERNEL)
        e_mask = max(float((mh.cpu() - hh).abs().max()),
                     float((mp.cpu() - hp).abs().max()))
        same = torch.equal(mh.cpu(), hh) and torch.equal(mp.cpu(), hp)
        check(e_mask <= 2.0 ** -21, f"masks card vs host CPU {e_mask:.3g}")
        fn = lambda z: torch.stack(pt.hpss(z, cfg), dim=1)  # noqa: E731
        whole = fn(xh)
        eq = torch.equal(halves(fn, xh), whole)
        out["results"]["hpss_split"] = eq
        check(eq, "hpss: two 1-channel shards != the 2-channel call")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) / 2**30
        wall, dev_ms, top = timed_call(lambda: pt.hpss(xh, cfg))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        out["results"]["hpss"] = dict(wall_ms=wall * 1e3, device_ms=dev_ms,
                                      peak_gib=peak, base_gib=base)
        return (f"kernels {HPSS_KERNEL}: harmonic + percussive vs "
                f"istft(stft(x)) {snr:.2f} dB (> 60), energies h {e_h[0]:.4g} "
                f"p {e_h[1]:.4g}; B1 launched {n_b1} times, each torch.equal "
                f"to plain ({lh.seen['b1']}); masks card vs host CPU from one "
                f"power: max-abs {e_mask:.3g} (<= 2^-21, torch.equal {same}); "
                f"two 1-channel shards torch.equal; {wall * 1e3:.2f} ms host "
                f"clock, device {dev_ms:.2f} ms, idle share "
                f"{1 - dev_ms / (wall * 1e3):.3f}, peak device memory "
                f"{peak:.3f} GiB ({base:.3f} GiB held before the call); "
                f"device events {top}")

    def p37():
        lines = []
        t = np.arange(n) / SR
        half = n // 2
        xy = np.zeros((2, n))
        for c, (f1, f2) in enumerate(YIN_TONES):
            xy[c, :half] = 0.8 * np.sin(2 * np.pi * f1 * t[:half])
            xy[c, half:] = 0.8 * np.sin(2 * np.pi * f2 * t[half:])
        xy = xy.astype(np.float32)
        xyd = torch.from_numpy(xy).to(dev)
        f0, ap = pt.yin_f0(xyd, cfg, float(SR))
        f0h, aph = pt.yin_f0(torch.from_numpy(xy), cfg, float(SR))
        fr = f0.cpu().numpy()
        starts = np.arange(fr.shape[-1]) * HOP - NFFT // 2
        worst = 0.0
        for c, (f1, f2) in enumerate(YIN_TONES):
            for lo, hi, f in ((NFFT, half - 2 * NFFT, f1),
                              (half + NFFT, n - 2 * NFFT, f2)):
                sel = (starts >= lo) & (starts < hi)
                e = float(np.max(np.abs(fr[c, sel] - f)) / f)
                worst = max(worst, e)
        check(worst < 0.01, f"yin_f0: worst relative error {worst:.3g}")
        e_yin = max(rel(f0, f0h), rel(ap, aph))
        check(e_yin <= PITCH_TOL, f"yin_f0 card vs host CPU {e_yin:.3g}")
        lines.append(f"yin_f0 at {[f for p in YIN_TONES for f in p]} Hz: "
                     f"worst {worst:.2e} (< 1 %), card vs host CPU "
                     f"{e_yin:.2e} of the largest")
        cfg_u = dataclasses.replace(cfg, center=False)
        g = np.random.default_rng(SEED + 2)
        clicks = np.arange(20, n // HOP - 20, 97) * HOP
        xo = np.zeros((2, n))
        for p in clicks:
            xo[:, p : p + 64] += g.standard_normal(64)
        xo = xo.astype(np.float32)
        xod = torch.from_numpy(xo).to(dev)
        mask, env = held(lambda: pt.detect_onsets(xod, cfg_u, float(SR)))
        mh, envh = pt.detect_onsets(torch.from_numpy(xo), cfg_u, float(SR))
        entry = NFFT // HOP - 1
        for c in range(2):
            idx = np.nonzero(mask[c].cpu().numpy())[0]
            want = clicks // HOP - entry
            found = all(np.any(np.abs(idx - w) <= 1) for w in want)
            check(found and len(idx) == len(want),
                  f"detect_onsets ch {c}: {len(idx)} onsets for "
                  f"{len(want)} clicks, all found {found}")
        e_env = rel(env, envh)
        same_mask = torch.equal(mask.cpu(), mh)
        check(e_env <= PITCH_TOL and same_mask,
              f"onsets card vs host CPU: envelope {e_env:.3g}, masks equal "
              f"{same_mask}")
        lines.append(f"detect_onsets: {len(clicks)} clicks a channel found "
                     f"within a frame, no extra; envelope card vs host CPU "
                     f"{e_env:.2e}, masks equal")
        period = int(round(60.0 / 120.0 * SR))
        xt = np.zeros((2, n))
        for p in range(0, n - 32, period):
            xt[0, p : p + 32] += 1.0
        for p in range(0, n - 32, int(round(60.0 / 90.0 * SR))):
            xt[1, p : p + 32] += 1.0
        xt = xt.astype(np.float32)
        xtd = torch.from_numpy(xt).to(dev)
        bpm = held(lambda: pt.tempo(xtd, cfg, SR)).cpu().numpy()
        bpmh = pt.tempo(torch.from_numpy(xt), cfg, SR).numpy()
        check(abs(bpm[0] - 120.0) / 120.0 < 0.05
              and abs(bpm[1] - 90.0) / 90.0 < 0.05, f"tempo {bpm}")
        e_bpm = float(np.max(np.abs(bpm - bpmh) / bpmh))
        check(e_bpm <= PITCH_TOL, f"tempo card vs host CPU {e_bpm:.3g}")
        tg = held(lambda: pt.tempogram(xtd, cfg, SR))
        tgh = pt.tempogram(torch.from_numpy(xt), cfg, SR)
        mid = tg[0, tg.shape[1] // 2].cpu().numpy()
        peak = 20 + int(np.argmax(mid[20:]))
        lag = 60.0 / 120.0 * SR / HOP
        e_tg = rel(tg, tgh)
        check(abs(peak - lag) <= 2.0 and e_tg <= PITCH_TOL,
              f"tempogram: peak lag {peak} vs {lag}, card vs host CPU "
              f"{e_tg:.3g}")
        lines.append(f"tempo {bpm[0]:.3f} / {bpm[1]:.3f} BPM for 120 / 90 "
                     f"(< 5 %), card vs host CPU {e_bpm:.2e}; tempogram "
                     f"{tuple(tg.shape)}, peak lag {peak} for {lag:.2f}, card "
                     f"vs host CPU {e_tg:.2e}")
        split = {
            "yin_f0": (lambda z: torch.stack(pt.yin_f0(z, cfg, float(SR)),
                                             dim=1), xyd),
            "detect_onsets": (lambda z: torch.stack(
                [v.float() for v in pt.detect_onsets(z, cfg_u, float(SR))],
                dim=1), xod),
            "tempogram": (lambda z: pt.tempogram(z, cfg, SR), xtd),
            "tempo": (lambda z: pt.tempo(z, cfg, SR), xtd),
        }
        equal = {}
        for name, (fn, z) in split.items():
            whole = held(lambda: fn(z))
            parts = held(lambda: halves(fn, z))
            equal[name] = torch.equal(whole, parts)
        out["results"]["pitch_split"] = equal
        check(all(equal.values()), f"two 1-channel shards: {equal}")
        wall, dev_ms, top = timed_call(lambda: pt.yin_f0(xyd, cfg, float(SR)))
        out["results"]["yin"] = (wall * 1e3, dev_ms)
        lines.append(f"two 1-channel shards torch.equal to the 2-channel "
                     f"call: {', '.join(equal)}; yin_f0 {wall * 1e3:.2f} ms "
                     f"host clock, device {dev_ms:.2f} ms ({top})")
        return "; ".join(lines)

    def dominant_hz(y):
        y = np.asarray(y, np.float64)
        spec = np.abs(np.fft.rfft(y * np.hanning(y.size)))
        return np.argmax(spec) * SR / y.size

    def p38():
        lines = []
        t30 = np.arange(30 * SR) / SR
        x30 = (0.5 * np.sin(2 * np.pi * 440.0 * t30)).astype(np.float32)
        y = pt.time_stretch(torch.from_numpy(x30).to(dev), cfg, 1.0)
        yc = y.cpu().numpy()
        k = min(yc.size, x30.size)
        a, b = x30[2048 : k - 2048], yc[2048 : k - 2048]
        snr = 10 * np.log10(np.sum(a.astype(np.float64) ** 2)
                            / np.sum((a - b).astype(np.float64) ** 2))
        check(snr > 60.0, f"time_stretch rate 1 on 30 s: {snr:.2f} dB")
        lines.append(f"time_stretch rate 1, 30 s of 440 Hz: interior "
                     f"{snr:.2f} dB (> 60, tests/test_vocoder.py's slow gate)")
        t = np.arange(n) / SR
        xv = (0.5 * np.sin(2 * np.pi * np.array([[440.0], [880.0]]) * t)
              ).astype(np.float32)
        xvd = torch.from_numpy(xv).to(dev)
        with LaunchHold(check) as lh:
            for rate in STRETCH_RATES:
                y = pt.time_stretch(xvd, cfg, rate)
                sync()
                hs = max(1, int(round(rate * HOP)))
                frames = (n - NFFT) // HOP + 1
                check(y.shape[-1] == (frames - 1) * hs + NFFT
                      and abs(y.shape[-1] / n - rate) < 0.02 * rate,
                      f"rate {rate}: length {y.shape[-1]}")
                got = [dominant_hz(y[c].cpu().numpy()) for c in range(2)]
                check(abs(got[0] - 440.0) <= 3.0 and abs(got[1] - 880.0)
                      <= 3.0, f"rate {rate}: dominant {got} Hz")
                lines.append(f"rate {rate} (Hs {hs}): {y.shape[-1]} samples, "
                             f"dominant {got[0]:.3f} / {got[1]:.3f} Hz")
            for semi in SHIFT_SEMITONES:
                y = pt.pitch_shift(xvd[:1], cfg, semi)
                sync()
                want = 440.0 * 2.0 ** (semi / 12.0)
                got = dominant_hz(y[0].cpu().numpy())
                check(y.shape[-1] == n and abs(got - want) <= 5.0,
                      f"pitch_shift {semi}: {y.shape[-1]} samples, {got} Hz "
                      f"for {want}")
                lines.append(f"shift {semi:+g}: {got:.3f} Hz for {want:.3f}")
        out["results"]["vocoder_held"] = dict(lh.seen)
        n_b1 = len(lh.seen["b1"])
        n_b4 = len(lh.seen["b4"])
        want_b1 = len(STRETCH_RATES) + len(SHIFT_SEMITONES)
        check(n_b1 == want_b1 and n_b4 == len(SHIFT_SEMITONES),
              f"B1 {n_b1} (want {want_b1}), B4 {n_b4} launches held")
        lines.append(f"B1 launches held torch.equal to plain at hops "
                     f"{sorted({h for h, _, _ in lh.seen['b1']})}; B4 "
                     f"launches within 1e-5 of plain at L/M "
                     f"{[r for r, _, _ in lh.seen['b4']]} (max-abs "
                     f"{max((e for _, _, e in lh.seen['b4']), default=0):.2e})")
        for key, fn in (("time_stretch", lambda: pt.time_stretch(
                xvd, cfg, 1.1)), ("pitch_shift", lambda: pt.pitch_shift(
                    xvd, cfg, 3.0))):
            wall, dev_ms, top = timed_call(fn)
            out["results"][key] = (wall * 1e3, dev_ms)
            lines.append(f"{key} 2 x {SECONDS} s {wall * 1e3:.2f} ms host "
                         f"clock, device {dev_ms:.2f} ms ({top})")
        return "; ".join(lines)

    def p39():
        cfg_d = pt.StftConfig(frame_size=DTW_NFFT, hop_size=DTW_HOP,
                              center=True)
        xs = np.stack([_note_sequence(SEED, SECONDS, False),
                       _note_sequence(SEED, SECONDS, True)])
        chroma = held(lambda: pt.chroma(torch.from_numpy(xs).to(dev), cfg_d,
                                        SR))
        fx, fy = chroma[0].contiguous(), chroma[1].contiguous()
        t0 = time.perf_counter()
        cost, acc = pt.dtw(fx, fy)
        sync()
        wall = time.perf_counter() - t0
        c = pt.dtw_cost(fx, fy)
        acc_h = align._accumulate(c.cpu())
        same = torch.equal(acc.cpu(), acc_h)
        check(same, f"acc card vs host CPU from one cost matrix: max-abs "
              f"{float((acc.cpu() - acc_h).abs().max()):.3g}")
        c64 = c.cpu().double().numpy()
        want = _dtw_f64(c64)
        rows, cols = c.shape
        total = float(cost)
        bound = (rows + cols) * 2.0 ** -24 * want[-1, -1]
        err = abs(total - want[-1, -1])
        check(err <= bound, f"total {total} vs float64 {want[-1, -1]}: "
              f"{err:.3g} > {bound:.3g}")
        path = pt.dtw_path(acc)
        same_path = path == pt.dtw_path(acc_h)
        check(same_path, "path card != host CPU")
        with torch.profiler.profile(activities=_activities(dev)) as prof:
            align._accumulate(c[:64])
            sync()
        per_row = sum(cnt for cnt, _ in _device_events(prof).values()) / 64
        out["results"]["dtw"] = dict(rows=rows, cols=cols, wall_s=wall,
                                     launches_per_row=per_row)
        return (f"chroma of {SECONDS} s of notes vs a time-warped copy (N "
                f"{DTW_NFFT}, H {DTW_HOP}): {rows} x {cols} frames; dtw "
                f"{wall:.3f} s host clock "
                f"({wall / rows * 1e3:.3f} ms a row, {per_row:.1f} device "
                f"launches a row); acc torch.equal to the host CPU's "
                f"accumulation of the same costs; total {total:.4f} vs float64 DP "
                f"{want[-1, -1]:.4f} (|err| {err:.3g} <= (N + M) 2^-24 total "
                f"= {bound:.3g}); path of {len(path)} steps equal to the "
                f"host CPU's")

    phase("34 FFT backends on the card (C20: CT, dense, torch.fft)", p34)
    phase("35 welch_psd / coherence", p35)
    phase("36 hpss (B1 twice)", p36)
    phase("37 yin_f0, onsets, tempo, tempogram", p37)
    phase("38 time_stretch / pitch_shift (B1 at the synthesis hops, B4)", p38)
    phase("39 dtw on chroma", p39)
    out["counts"] = {"b1": b1.launches, "b4": b4.launches,
                     "b0_fp32": b0f.launches}
    log(f"last analysis path launches (its untimed calls): B1 "
        f"{out['counts']['b1']}, B4 {out['counts']['b4']}, B0 fp32 (the mel "
        f"and chroma products) {out['counts']['b0_fp32']}, of which held "
        f"against plain {hold.held}")
    if not all(out["counts"].values()) or hold.held != out["counts"]["b0_fp32"]:
        failures.append("launch counts (path 8)")
        log("FAIL launch counts: a kernel of the path was not launched, or "
            "a B0 fp32 launch was not held against plain")
    return out


def wire_timings(dev, path4, path_b6) -> dict:
    """Sustained samples/s of the f32 streamer and both wire tiers on the
    device-resident stream; B6's plain versions at the probe shape (the
    kernels were timed by the probe, phase 24); B6-limb at one wire chunk
    and B4 at 48 kHz -> 300 Hz against their plain versions; logs them."""
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import int8_gemm as b6
    from crlot_tpu_torch import int8_probe, wire
    from crlot_tpu_torch.fft import matmul_backend as mb

    cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)
    timing = {}
    total = WIRE_CHUNK * WIRE_CHUNKS
    timing["stream_f32"] = total / e2e_seconds(path4["stream_f32"])
    for tier in ("int8x2", "int8x1"):
        timing[f"stream_{tier}"] = total / e2e_seconds(
            lambda: path4["stream_i16"](tier))
    log(f"e2e sustained stream, {WIRE_CHUNKS} device-resident chunks of "
        f"{WIRE_CHUNK} (mono, {total} samples): f32 BlockedChunkStreamer "
        f"{timing['stream_f32']:.4e} samples/s; wire int8x2 "
        f"{timing['stream_int8x2']:.4e}; wire int8x1 "
        f"{timing['stream_int8x1']:.4e} (int16 egress; host clock, "
        f"synchronized, median of {REPS})")
    t = path_b6["probe_inputs"]
    for name, (_, plain) in int8_probe.variants(t).items():
        timed(timing, f"{name}_plain", plain)
    log("time B6 plain versions at the probe shape: " + "; ".join(
        f"{name} {ms(timing, name + '_plain')}"
        for name in int8_probe.variants(t)))
    x16 = path4["x16"][: WIRE_CHUNK + 2 * (NFFT - HOP)][None].contiguous()
    plan = mb.blocked_plan_for(cfg, mb.blocked_response(cfg, None))
    kh, kl = wire._i16_limbs_on(plan, "int8x2", x16.device)
    rows = WIRE_CHUNK // 512
    timed(timing, "limb_wire", lambda: b6.limb_gemm_i16_cuda(
        x16, kh, kl, "wire2", 1e-5, rows=rows, lda=512))
    timed(timing, "limb_wire_plain", lambda: b6.limb_gemm_i16_plain(
        x16, kh, kl, "wire2", 1e-5, rows=rows, lda=512))
    ops = 4 * 2.0 * rows * 512 * 2048
    timing["limb_wire_bound"] = bound(nbytes(x16, kh, kl) + rows * 512 * 4,
                                      ops, "int8")
    log(f"time B6-limb at one wire chunk (int8x2, {rows} rows x 512 x 2048, "
        f"4 limb products, {ops / 1e9:.1f} G int8 ops): kernel on the int16 "
        f"samples (the path's) {ms(timing, 'limb_wire')}; the former mma.sync "
        f"design "
        f"{OLD_MS['K10 wire chunk']} in PERF.md; plain "
        f"{ms(timing, 'limb_wire_plain')}; bound "
        f"{timing['limb_wire_bound']['bound_ms']:.4f} ms; "
        f"{ops / (timing['limb_wire'] * 1e-3) / 1e12:.1f} TOPS")
    xw, kw = path_b6["results"]["i8_wire"]  # 2 x 4096 rows, lda 512, K 2048
    timed(timing, "i8_wire", lambda: b6.i8_gemm_cuda(xw, kw, rows=4096,
                                                     lda=512))
    timed(timing, "i8_wire_plain", lambda: b6.i8_gemm_plain(xw, kw, rows=4096,
                                                            lda=512))
    ops = 2.0 * xw.shape[0] * 4096 * 512 * 2048
    log(f"time B6-i8 at the wire geometry ({xw.shape[0]} x 4096 rows x 512 x "
        f"2048, windows lda 512, {ops / 1e9:.1f} G int8 ops): kernel "
        f"{ms(timing, 'i8_wire')}, plain {ms(timing, 'i8_wire_plain')}; "
        f"{ops / (timing['i8_wire'] * 1e-3) / 1e12:.1f} TOPS")
    x300, l, m, n_out = path_b6["results"]["b4_300"]
    from crlot_tpu_torch.resample import kernel as b4

    timed(timing, "b4_300", lambda: b4.resample_cuda(x300, l, m, n_out))
    timed(timing, "b4_300_bank",
          lambda: b4.resample_bank_plain(x300, l, m, n_out))
    log(f"time B4 48->0.3 kHz (unstaged) kernel {ms(timing, 'b4_300')}, "
        f"plain (resample_bank_plain) {ms(timing, 'b4_300_bank')} "
        f"([2, {x300.shape[-1]}] -> [2, {n_out}])")
    return timing


MH_TIMEOUT = 300  # s: the deadline of the two ranks of phase 41
QUAD_NFFTS = (512, 1024, 2048, 4096)  # phase 43: every N quad_supported takes
QUAD_ROWS = 64
A9_FRAMES = SR // HOP  # frames of the 2 x 60 s held against float64: 1 s


def multihost_child(argv) -> int:
    """`python3 chip_smoke.py --multihost-child <rank> <nproc> <port>`: one
    rank of phase 41, `python -m crlot_tpu_torch.distributed.multihost_child
    <rank> <nproc> <port> --device cuda` with every B0 and B3 launch held
    against its plain version (`KernelHold`); prints its launch counts on a
    line "HOLD {...}"."""
    import torch

    sys.path.insert(0, str(ROOT))
    from crlot_tpu_torch.distributed import multihost_child as child
    from crlot_tpu_torch.fft import fused_rt as b2
    from crlot_tpu_torch.fft import tf32x3 as b0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    b0.launches = b2.frames_launches = 0
    with KernelHold(check) as hold:
        rc = child.main(list(argv) + ["--device", "cuda"])
    print("HOLD " + json.dumps({"rank": int(argv[0]), "b0": b0.launches,
                                "b3": b2.frames_launches,
                                "held": hold.held,
                                "summary": hold.summary()}), flush=True)
    return rc


def run_multihost(nproc: int) -> tuple:
    """`nproc` ranks of `--multihost-child` at once (`run_ranks`, killed at
    MH_TIMEOUT or when one fails): (rank 0's report, every rank's HOLD
    line, the wall in s). Raises unless every rank exits 0 with its
    launches all held and rank 0 reports OK."""
    import socket

    from crlot_tpu_torch.distributed.multihost_child import run_ranks

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ranks = run_ranks(
        [[sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-child",
          str(rank), str(nproc), str(port)] for rank in range(nproc)],
        MH_TIMEOUT, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    for rank, (rc, text) in enumerate(ranks):
        if rc != 0:
            raise AssertionError(
                f"rank {rank} exited {rc} (killed if < 0, at {MH_TIMEOUT} s "
                f"or when another failed):\n{text[-4000:]}")
    logs = [text for _, text in ranks]
    if "MULTIHOST_OK" not in logs[0]:
        raise AssertionError("rank 0 did not report OK")
    report = json.loads(next(line for line in logs[0].splitlines()
                             if line.startswith("{")))
    holds = [json.loads(line[5:]) for text in logs
             for line in text.splitlines() if line.startswith("HOLD ")]
    if len(holds) != nproc or any(
            h["held"] != {"b0": h["b0"], "b3": h["b3"]} for h in holds):
        raise AssertionError(f"launches not all held: {holds}")
    return report, holds, wall


def multiprocess_path(dev, phase, check, failures, x_np) -> dict:
    """Phases 40-43, with the B0 and B3 counters reset just before: the
    port's `dryrun(4)`, two ranks sharing the card, the halo accounting and
    the weak-scaling model, and A9's formulations. Every B0 and B3 launch
    of the untimed calls, here and in the two ranks, is held against its
    plain version (`KernelHold`); timed repeats are not counted."""
    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import profiling
    from crlot_tpu_torch.core.padding import pad_signal
    from crlot_tpu_torch.distributed import sharded_pipeline as spl
    from crlot_tpu_torch.fft import fused_rt as b2
    from crlot_tpu_torch.fft import matmul_backend as mb
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.pipeline import _window_f64
    from crlot_tpu_torch.timing import cuda_ms

    def sync():
        torch.cuda.synchronize(dev)

    out = {"results": {}}
    b0.launches = b2.frames_launches = 0
    children = {"b0": 0, "b3": 0}
    hold = KernelHold(check)

    def held(fn):
        with hold:
            got = fn()
            sync()
        return got

    def event_ms(fn):
        """fn's device ms (CUDA events, queued, median of REPS), its
        launches not counted."""
        counted = b0.launches, b2.frames_launches
        try:
            queued, per_call = cuda_ms(fn, REPS)
        finally:
            b0.launches, b2.frames_launches = counted
        return per_call if queued is None else queued

    def p40():
        s = held(lambda: pt.dryrun(4, devices=[dev]))
        out["results"]["dryrun"] = s
        a, c = s["config5_scale"], s["dcn_prefetch_measured"]
        g = s["weak_scaling_gate_nvlink_overlap"]
        return (f"Part A bit-exact (blocked, masked, checkpoint), interior "
                f"{s['interior_snr_db']} dB, halo ops "
                f"{s['collectives']['per_op_bytes']} B; Part B "
                f"{a['channels']} ch x {a['samples_per_channel']} samples in "
                f"{a['chunks']} chunks bit-exact, state "
                f"{a['state_bytes_constant']} B constant, {a['wall_s']} s "
                f"({a['sustained_msamples_per_s_all_channels']} Msamples/s, "
                f"host clock, numpy in and out), checkpoint "
                f"{a['checkpoint_save_restore_ms']} ms; Part C at "
                f"{c['channels']} ch x {c['chunk_samples']}: c_dev "
                f"{c['device_hidable_ms']} ms, "
                f"h_host {c['host_dispatch_side_ms']} ms, injected "
                f"{c['injected_transport_ms']} ms, wall1 "
                f"{c['depth1_wall_per_chunk_ms']} ms, wall3 "
                f"{c['depth3_wall_per_chunk_ms']} ms (its wait "
                f"{c['depth3_wait_per_chunk_ms']} ms), recovered "
                f"{c['measured_overlap_efficiency_of_hidable']} of the "
                f"hidable (gate 0.8); NVLink overlap {g['efficiency']} at a "
                f"{g['block_samples']}-sample block (1 s block: "
                f"{g['efficiency_1s_block']}; 0.8 from "
                f"{g['min_block_for_80pct_overlap']} samples); "
                f"{hold.summary()}")

    def p41():
        torch.cuda.empty_cache()
        report, holds, wall = run_multihost(2)
        for h in holds:
            children["b0"] += h["b0"]
            children["b3"] += h["b3"]
        check(children["b0"] > 0 and children["b3"] > 0,
              f"the ranks launched B0 {children['b0']}, B3 "
              f"{children['b3']} times")
        log(f"two-rank report (rank 0): {json.dumps(report)}")
        out["results"]["two_ranks"] = report
        legs = []
        for name in ("identity", "noise_gate", "config 5 chunk (128 x 2^20)"):
            r = report[name]
            each = r["cross_rank_bytes"] // max(1, r["cross_rank_ops"])
            legs.append(f"{name}: == one process, {r['cross_rank_ops']} "
                        f"halos of {each} B from rank 1, staging "
                        f"{r['staging_ms']} ms, receive wait "
                        f"{r['receive_wait_ms']} ms, wall {r['wall_ms']} ms "
                        f"(launches held)")
        pf = report["prefetch"]
        return (f"gloo on one card, (2, 2) global mesh "
                f"{report['mesh_ranks']}; "
                + "; ".join(legs)
                + f"; streamer == one process and resumed from a one-process "
                f"state; prefetch at {pf['channels']} ch x 2^20: chunk "
                f"{pf['per_chunk_ms']} ms, injected {pf['injected_ms']} ms, "
                f"depth 1 {pf['depth1_ms']} ms, depth 3 {pf['depth3_ms']} ms, "
                f"recovered {pf['recovered_of_hidable']} of the hidable "
                f"(gate 0.2); launches B0 {children['b0']}, B3 "
                f"{children['b3']}, " + "; ".join(h["summary"] for h in holds)
                + f"; {wall:.1f} s for both ranks")

    def p42():
        cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=False)
        mesh22 = pt.make_mesh(channel=2, time=2, devices=[dev] * 4)
        acct = held(lambda: spl.collective_bytes_per_step(
            cfg, mesh22, 2, T_SHARDED))
        halo_b = (NFFT - HOP) * 4
        check(acct["per_op_bytes"] == [halo_b, halo_b], f"halo ops {acct}")
        t_1s = 49152
        ov = held(lambda: spl.overlap_dot_fraction(cfg, mesh22, 4, 2 * t_1s))
        check(ov["ppermute_ops"] == 2 and ov["independent_fraction"] >= 0.75,
              f"overlap {ov}")
        kind = torch.cuda.get_device_name(0)
        models = {blk: spl.weak_scaling_model(cfg, 2, blk, device_kind=kind)
                  for blk in (48000, spl.CONFIG5_BLOCK)}
        for blk, m in models.items():
            log(f"weak-scaling model ({kind}, 2 local channels, block "
                f"{blk}): {json.dumps(m)}")
        check(models[spl.CONFIG5_BLOCK]["nvlink"]["efficiency_overlap"]
              >= 0.8, "NVLink overlap under 0.8 at config 5's block")
        roof = profiling.roofline_samples_per_sec(NFFT, HOP,
                                                  formulation="blocked")
        out["results"]["roofline"] = roof
        return (f"halo ops {acct['per_op_bytes']} B a shard (2 x (N - H) x 4 "
                f"x 1 channel), {acct['moved_bytes']} B moved a step; "
                f"independent MAC fraction {ov['independent_fraction']} at a "
                f"{t_1s}-sample block; NVLink overlap "
                f"{models[48000]['nvlink']['efficiency_overlap']} at 1 s, "
                f"{models[spl.CONFIG5_BLOCK]['nvlink']['efficiency_overlap']}"
                f" at 2^20; roofline of the main path (blocked, 3xTF32) "
                f"{roof['roofline_samples_per_sec']:.4e} samples/s "
                f"({roof['flops_per_sample']:.0f} FLOP, "
                f"{roof['bytes_per_sample']:.0f} B a sample)")

    def p43():
        lines = []
        rng = np.random.default_rng(43)

        def rmse(a, b):
            return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b)
                                         ** 2)))

        for nfft in QUAD_NFFTS:
            xq = rng.uniform(-1, 1, (QUAD_ROWS, nfft)).astype(np.float32)
            xt = torch.from_numpy(xq).to(dev)
            h = nfft // 2
            spec = np.fft.rfft(xq.astype(np.float64), axis=-1)
            want = (spec.real[:, 0:h:2], spec.real[:, 1:h:2],
                    spec.real[:, h : h + 1], spec.imag[:, 2:h:2],
                    spec.imag[:, 1:h:2])
            parts = held(lambda: mb.rfft_folded_quad_parts(xt, nfft))
            fwd = max(rmse(p.cpu(), w) for p, w in zip(parts, want))
            fwd /= math.sqrt(nfft)
            inv_in = [torch.from_numpy(np.ascontiguousarray(w, np.float32))
                      .to(dev) for w in want]
            inv = rmse(held(lambda: mb.irfft_folded_quad_parts(
                *inv_in, nfft)).cpu(), np.fft.irfft(spec, n=nfft))
            ones = np.ones(nfft)
            rt = rmse(held(lambda: mb.roundtrip_folded_quad(
                xt, nfft, ones)).cpu(), xq)
            t = event_ms(lambda: mb.roundtrip_folded_quad(xt, nfft, ones))
            lines.append(f"quad N {nfft}: forward {fwd:.2e}, inverse "
                         f"{inv:.2e}, round-trip {rt:.2e} ({QUAD_ROWS} rows, "
                         f"{t:.4f} ms)")
            check(fwd < 1e-6 and inv < 1e-6 and rt < 1e-5, lines[-1])
        cfg = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
        spec_ = cfg.frame_spec
        n = x_np.shape[-1]
        nf = spec_.num_frames(n)
        x = torch.from_numpy(x_np).to(dev)
        padded = pad_signal(x, spec_.pad_amount, spec_.pad_amount,
                            spec_.pad_mode).contiguous()
        frames = padded.unfold(-1, NFFT, HOP)[:, :nf]
        w64 = _window_f64(cfg)
        band = pt.spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR,
                                     NFFT)
        gains = pt.spectral.resolve_per_bin_response(band, NFFT)
        pad_np = padded[:, : (A9_FRAMES - 1) * HOP + NFFT].cpu().double()
        fr64 = pad_np.unfold(-1, NFFT, HOP).numpy()
        oracle = {
            "packed": np.fft.irfft(np.fft.rfft(fr64 * w64, axis=-1),
                                   n=NFFT, axis=-1),
            "conv": np.fft.irfft(np.fft.rfft(fr64 * w64, axis=-1)
                                 * gains, n=NFFT, axis=-1),
        }
        calls = {
            "packed": lambda: mb.roundtrip_packed_matmul(frames, NFFT, w64),
            "conv": lambda: mb.roundtrip_composed_conv(
                padded, NFFT, HOP, nf, w64, gains),
            "conv HIGHEST (conv1d)": lambda: mb.roundtrip_composed_conv(
                padded, NFFT, HOP, nf, w64, gains,
                precision=pt.FftPrecision.HIGHEST),
        }
        for name, fn in calls.items():
            got = held(fn)
            check(tuple(got.shape) == (2, nf, NFFT), f"{name} shape")
            err = rmse(got[:, :A9_FRAMES].cpu(),
                       oracle[name.split()[0]])
            t = event_ms(fn)
            target = ("target 1e-6 met" if err < 1e-6
                      else "above the 1e-6 target")
            lines.append(f"{name} on [2, {nf}, {NFFT}] frames: RMSE {err:.2e}"
                         f" vs float64 over the first {A9_FRAMES} frames "
                         f"({target}), {t:.4f} ms")
            check(err < 1e-5, lines[-1])
        check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 turned on")
        return "; ".join(lines) + f"; {hold.summary()}"

    phase("40 dryrun(4) on a (2, 2) mesh of the card", p40)
    phase("41 two ranks sharing the card (gloo, host-staged halos)", p41)
    phase("42 halo accounting, overlap, weak-scaling model", p42)
    phase("43 quad, conv and packed formulations", p43)
    out["counts"] = {"b0": b0.launches + children["b0"],
                     "b3": b2.frames_launches + children["b3"]}
    log(f"multi-process path launches: B0 {out['counts']['b0']} (the two "
        f"ranks: {children['b0']}), B3 {out['counts']['b3']} (the two "
        f"ranks: {children['b3']})")
    if not (out["counts"]["b0"] and out["counts"]["b3"]):
        failures.append("launch counts (multi-process path)")
        log("FAIL launch counts: a kernel of the path was not launched")
    return out


# The last modules of the port: the native host runtime, the bench tooling
# and the examples, on the main path's 2 ch x 60 s at 48 kHz from seed 0.
TOOLING_KERNELS = ("B0", "B1", "B2", "B3", "B4", "K5", "K6", "B6_limb")
EXAMPLE_EDGE = NFFT  # uncentered outputs: the eps-divided edge samples
# The time stretch against the CPU (C23): the median, over each run of
# STRETCH_RUN consecutive frames, of the per-frame magnitude distance
# (`_frame_distance`) may not pass STRETCH_GATE. On the CPU, on phase 48's
# input at rate 1.5, torch.fft against the MATMUL products (both right,
# C23's witness) reads at most 0.0984, and the vocoder with its phase
# accumulation dropped at least 0.5772 in every run of 16 frames
# (tests/test_torch_examples.py).
STRETCH_RUN, STRETCH_GATE = 16, 0.25


def _wav_codes(path):
    from crlot_tpu_torch.io.wav import read_wav

    data, _ = read_wav(path)
    import numpy as np

    return np.rint(data.astype(np.float64) * 32767).astype(np.int64)


def tooling_path(dev, phase, check, failures, x_np, path6) -> dict:
    """Phases 44-48, with every kernel counter reset just before: the
    native runtime feeding phase 28's accumulator, the bench suite, the
    stages, the regression guard and the duty probe, and the eight
    examples. Their counts are those of every launch outside the timed
    repeats and graph captures (`bench.launches.uncounted()`), each held
    against its plain version as it is made (`ToolingHold`)."""
    import contextlib
    import io
    import os
    import runpy
    import tempfile

    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch.bench import launches, regression, stages, suite
    from crlot_tpu_torch.io import native as nat
    from crlot_tpu_torch.io.wav import read_wav, write_wav
    from crlot_tpu_torch.ola import kernels as b5
    from crlot_tpu_torch.window.windows import get_window

    sync = torch.cuda.synchronize
    tmp = tempfile.mkdtemp()
    out = {"results": {}}
    launches.reset_launch_counts()

    def p44():
        t0 = time.perf_counter()
        check(nat.native_available(), "g++ missing: no native runtime")
        build_s = time.perf_counter() - t0
        codec = []
        for bits, ff in ((16, False), (24, False), (32, False), (32, True)):
            p_py = os.path.join(tmp, f"py{bits}{ff}.wav")
            p_nat = os.path.join(tmp, f"nat{bits}{ff}.wav")
            write_wav(p_py, x_np, SR, bits=bits, float_format=ff)
            t0 = time.perf_counter()
            nat.write_wav_native(p_nat, x_np, SR, bits=bits, float_format=ff)
            t_enc = time.perf_counter() - t0
            with open(p_py, "rb") as a, open(p_nat, "rb") as b:
                check(a.read() == b.read(), f"{bits}-bit (float {ff}): "
                      f"native bytes != Python bytes")
            a, sa = read_wav(p_py)
            t0 = time.perf_counter()
            b, sb = nat.read_wav_native(p_nat)
            t_dec = time.perf_counter() - t0
            check(sa == sb == SR and np.array_equal(a, b),
                  f"{bits}-bit (float {ff}): native decode != Python decode")
            codec.append(f"{'f32' if ff else bits} enc {t_enc * 1e3:.1f} / "
                         f"dec {t_dec * 1e3:.1f} ms")
        aos = np.ascontiguousarray(x_np.T).reshape(-1)  # interleaved
        block = 2 * (SR // 100)  # phase 28's 10 ms pushes
        py, nf = pt.Framer(NFFT, HOP, 2, device="cpu"), nat.NativeFramer(
            NFFT, HOP, 2)
        n_frames = 0
        for i in range(0, aos.size + 1, block):
            if i < aos.size:
                py.push(aos[i : i + block])
                nf.push(aos[i : i + block])
            else:
                py.flush()
                nf.flush()
            a, b = py.pop_batch().numpy(), nf.pop_batch()
            check(np.array_equal(a, b), f"batch at sample {i}: native != "
                  "Python Framer")
            n_frames += len(b)

        def host_framing(framer):  # the framer alone, the host clock
            t0 = time.perf_counter()
            for i in range(0, aos.size, block):
                framer.push(aos[i : i + block])
                framer.pop_batch()
            framer.flush()
            framer.pop_batch()
            return time.perf_counter() - t0

        t_nat = host_framing(nat.NativeFramer(NFFT, HOP, 2))
        t_py = host_framing(pt.Framer(NFFT, HOP, 2, device="cpu"))

        ocfg = pt.OLAConfig(sample_rate=SR, frame_size=NFFT, hop_size=HOP,
                            channels=2, apply_window_inside=True)
        w = get_window(pt.WindowType.HANN, NFFT, periodic=True)

        def run():
            """Phase 28's accumulator path fed by the native framer: each
            batch goes to the card in one copy."""
            fr = nat.NativeFramer(NFFT, HOP, 2)
            acc = pt.OLAAccumulator(ocfg, device=dev)
            acc.set_window(w)
            outs, k, spans = [], 0, 0

            def produce(count):
                nonlocal spans
                lo = acc.state.read_pos % ocfg.ring_len
                o = acc.produce(count)
                got = o.shape[1]
                spans += (got > 0) + (lo + got > ocfg.ring_len)
                return o

            def drain():
                nonlocal k
                batch = fr.pop_batch()
                if len(batch):
                    for f in torch.from_numpy(batch).to(dev):
                        acc.add_frame_soa(f, k * HOP)
                        outs.append(produce(HOP))
                        k += 1

            for i in range(0, aos.size, block):
                fr.push(aos[i : i + block])
                drain()
            fr.flush()
            drain()
            acc.flush()
            while (o := produce(ocfg.ring_len)).shape[1]:
                outs.append(o)
            return torch.cat(outs, dim=1), k, spans

        before = b5.launches["normalize_and_clear"]
        y, frames, spans = run()  # every K6 launch held (ToolingHold)
        sync()
        k6 = b5.launches["normalize_and_clear"] - before
        check(k6 == spans, f"{k6} K6 launches for {spans} drained spans")
        check(frames == n_frames, f"{frames} frames, the framers {n_frames}")
        check(torch.equal(y, path6["ola_y"]), "native-fed accumulator != "
              "phase 28's output, max-abs "
              f"{float((y - path6['ola_y']).abs().max()):.3e}")
        sync()
        with launches.uncounted():
            t0 = time.perf_counter()
            run()
            sync()
            wall = time.perf_counter() - t0
        r28 = path6["results"]
        out["results"].update(native_frames_per_s=frames / wall,
                              p28_frames_per_s=r28["ola_frames"]
                              / r28["ola_wall"])
        return (f"native library (g++, built or loaded in {build_s:.2f} s); "
                f"WAV 2 ch x {SECONDS} s bytes and samples equal the Python "
                f"codec at 16 / 24 / 32-bit and float32 ({'; '.join(codec)});"
                f" NativeFramer's {n_frames} frames (10 ms interleaved "
                f"pushes) np.array_equal to Framer's; framing alone "
                f"{t_nat * 1e3:.1f} ms native vs {t_py * 1e3:.1f} ms Python "
                f"(host clock); its batches (one copy to the card each) "
                f"through phase 28's OLAAccumulator: {k6} K6 launches, each "
                f"torch.equal to plain, the output torch.equal to phase 28's;"
                f" {frames / wall:.1f} frames/s ({wall / frames * 1e6:.1f} us "
                f"a frame, host clock, synchronized, a second run, unheld) "
                f"beside phase 28's "
                f"{r28['ola_frames'] / r28['ola_wall']:.1f}")

    def p45():
        path = os.path.join(tmp, "suite.json")
        t0 = time.perf_counter()
        res = suite.main(["--out", path])  # prints each section's line
        wall = time.perf_counter() - t0
        suite.check(res)
        out["suite"], out["suite_path"] = res, path
        for sec, counts in res["_launches"].items():
            log(f"  suite launches in {sec}: "
                f"{', '.join(f'{k} {v}' for k, v in counts.items()) or 'none'}")
        nc = res.get("_not_captured", {})
        for name, why in nc.items():
            log(f"  suite one-program variant {name} not captured: {why}")
        metrics = [k for k in res if not k.startswith("_")]
        return (f"python -m crlot_tpu_torch.bench.suite --out <tmp>: "
                f"{len(res['_launches'])} sections, {len(metrics)} metrics in "
                f"{wall:.1f} s, no NaN, every bit-exact flag 1, every SNR at "
                f"its gate; e2e h256 {res['e2e_1s48k_n1024_h256_ms']} ms a "
                f"second of audio, stream (best variant) "
                f"{res['stream_sustained_device_resident_gsamples_per_s']} "
                f"Gsamples/s ({res['stream_device_resident_formulation']}); "
                f"{len(nc)} variant(s) not captured")

    def p46():
        t0 = time.perf_counter()
        generic = stages.main(device="cuda")
        real = stages.main_pipeline(device="cuda")
        wall = time.perf_counter() - t0
        ms_keys = [k for k in {**generic, **real} if k.endswith("_ms")]
        for k in ms_keys:
            v = {**generic, **real}[k]
            check(math.isfinite(v) and v > 0, f"{k} = {v}")
        check(real["route"] == "blocked", f"route {real['route']}")
        out["results"]["stages"] = real
        return (f"stages.main: " + ", ".join(
            f"{k[:-3]} {generic[k]:.4f}" for k in generic
            if k.endswith("_ms")) + " ms; main_pipeline: " + ", ".join(
            f"{k[:-3]} {real[k]:.4f}" for k in real if k.endswith("_ms")
            and "sum" not in k) + f" ms; the framed stages' sum "
            f"{real['framed_stage_sum_ms']:.4f} ms and the blocked route's "
            f"{real['blocked_stage_sum_ms']:.4f} ms beside round_trip "
            f"{real['round_trip_ms']:.4f} ms (route {real['route']}; CUDA "
            f"events, median of 10, queued; {wall:.1f} s)")

    def p47():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = regression.main(["--current", out["suite_path"]])
        verdict = json.loads(buf.getvalue().strip().splitlines()[-1])
        check("error" not in verdict, f"{verdict}")
        checks = verdict["checks"]
        armed = [r["metric"] for r in checks
                 if r.get("note") == "armed but not measured this run"]
        check(not armed, f"armed but not measured: {armed}")
        snr_bad = [r for r in checks if r["metric"].endswith("_snr_db")
                   and r.get("pass") is False]
        check(not snr_bad, f"SNR bands failed: {snr_bad}")
        timing = [r for r in checks if r.get("pass") is not None
                  and not r["metric"].endswith("_snr_db")]
        slow = [f"{r['metric']} x{r['ratio']}" for r in timing
                if r["pass"] is False]
        duty = verdict["duty_probe"]
        chip = verdict["chip_adjusted_verdict"]
        out["results"]["duty"] = duty
        return (f"regression --current <phase 45>: exit {rc}, "
                f"{len(checks)} bands against the committed "
                f"'{verdict['backend']}' key; SNR bands pass; timing bands "
                f"(printed, not gated: a same-machine guard) "
                f"{len(timing) - len(slow)} pass, {len(slow)} outside "
                f"({', '.join(slow[:8]) or 'none'}); chip-adjusted verdict "
                f"{chip['status']}; quick_headline_duty: bf16 "
                f"{duty['mxu_tflops']:.1f} TFLOP/s of 989 (duty "
                f"{duty['mxu_duty']:.4f}), HBM {duty['hbm_gbps']:.1f} GB/s of"
                f" 3350 (duty {duty['hbm_duty']:.4f}), the main path "
                f"{duty['sps']:.4e} samples/s, {duty['roofline_pct_model']:.2f}"
                f" % of the blocked roofline, chip-adjusted "
                f"{duty['roofline_pct_chip_adjusted']:.2f} %, "
                f"{duty['snr_db']:.2f} dB")

    def p48():
        wav = os.path.join(tmp, "in.wav")
        write_wav(wav, x_np, SR, bits=16)
        specs = {
            "analyze": lambda d: ["--write-stems", d],
            "denoise": lambda d: [os.path.join(d, "out.wav")],
            "extract_features": lambda d: [os.path.join(d, "out.npz")],
            "fir_filter": lambda d: [os.path.join(d, "out.wav")],
            "loudness": lambda d: [],
            "sharded_eq": lambda d: [os.path.join(d, "out.wav")],
            "streaming_checkpoint": lambda d: [
                os.path.join(d, "out.npy"), "--ckpt",
                os.path.join(d, "ckpt.npz")],
            "time_stretch": lambda d: [os.path.join(d, "out.wav"), "--rate",
                                       "1.5"],
        }
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        lines, stdout = [], {}
        def on_card(name, argv):
            """The example in this process on the card: (stdout, wall s)."""
            old, buf = sys.argv, io.StringIO()
            sys.argv = [f"crlot_tpu_torch.examples.{name}", *argv]
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    runpy.run_module(f"crlot_tpu_torch.examples.{name}",
                                     run_name="__main__", alter_sys=True)
                sync()
            finally:
                sys.argv = old
            return buf.getvalue(), time.perf_counter() - t0

        for name, args in specs.items():
            dirs = {d: os.path.join(tmp, f"{name}_{d}")
                    for d in ("cuda", "cpu", "timed")}
            for d in dirs.values():
                os.makedirs(d)
            text, _ = on_card(name, [wav, *args(dirs["cuda"]), "--device",
                                     "cuda"])  # every launch held
            with launches.uncounted():  # timed apart from the holds
                _, wall = on_card(name, [wav, *args(dirs["timed"]),
                                         "--device", "cuda"])
            cpu = subprocess.run(
                [sys.executable, "-m", f"crlot_tpu_torch.examples.{name}",
                 wav, *args(dirs["cpu"]), "--device", "cpu"],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=600)
            check(cpu.returncode == 0, f"{name} --device cpu exited "
                  f"{cpu.returncode}: {cpu.stderr[-500:]}")
            stdout[name] = (text, cpu.stdout)
            note = _compare_example(check, name, dirs, stdout[name], wav)
            lines.append(f"{name} {wall:.2f} s ({note})")
        return ("python -m crlot_tpu_torch.examples.<name> on a 2 ch x "
                f"{SECONDS} s 48 kHz 16-bit WAV from seed 0, card (in "
                "process, every launch held; wall time of a second run, "
                "unheld) vs --device cpu (a subprocess): "
                + "; ".join(lines))

    with ToolingHold(check) as hold:
        phase("44 native runtime: WAV codec, NativeFramer -> "
              "OLAAccumulator (K6)", p44)
        phase("45 bench suite, twelve sections", p45)
        phase("46 bench stages", p46)
        if "suite_path" in out:
            phase("47 regression guard and duty probe", p47)
        else:
            failures.append("47 regression guard and duty probe")
            log("FAIL 47 regression guard and duty probe: phase 45 failed")
        phase("48 the eight examples, card vs CPU", p48)
    counts = launches.launch_counts()
    phase("44-48 held launches", lambda: hold.verify(counts))
    out["counts"] = counts
    log("tooling path launches: " + ", ".join(
        f"{k} {v}" for k, v in counts.items() if v))
    missing = [k for k in TOOLING_KERNELS if not counts[k]]
    if missing:
        failures.append("launch counts (tooling path)")
        log(f"FAIL launch counts: {missing} not launched on the path")
    return out


def _frame_distance(a, b):
    """[C, F]: for each frame of the STFT (N, H = NFFT, HOP, periodic
    Hann, float64) of `a` and `b` [C, T], || |A_t| - |B_t| || / || B_t ||."""
    import torch

    w = torch.hann_window(NFFT, periodic=True, dtype=torch.float64)

    def mag(v):
        return torch.stft(torch.from_numpy(v).double(), NFFT, HOP, window=w,
                          center=False, return_complex=True).abs()

    ma, mb = mag(a), mag(b)  # [C, K, F]
    return (ma - mb).norm(dim=1) / mb.norm(dim=1).clamp_min(1e-30)


def _stretch_runs(a, b):
    """(worst, best) over the runs of STRETCH_RUN frames of the median
    per-frame distance of `a` from `b`."""
    d = _frame_distance(a, b)
    f = d.shape[-1] // STRETCH_RUN * STRETCH_RUN
    med = d[:, :f].reshape(d.shape[0], -1, STRETCH_RUN).median(-1).values
    return float(med.max()), float(med.min())


def _broken_stretch(wav, path):
    """The time stretch of `wav` on the card with its phase accumulation
    dropped (the vocoder's running sum of phase increments zeroed), as
    the example writes it to `path`: a wrong phase path that the time
    stretch's check has to fail."""
    import crlot_tpu_torch as pt
    from crlot_tpu_torch import vocoder
    from crlot_tpu_torch.bench import launches
    from crlot_tpu_torch.io.wav import read_wav, write_wav

    x, sr = read_wav(wav)
    run_sum = vocoder._running_sum
    vocoder._running_sum = lambda inc: inc.new_zeros(inc.shape)
    try:
        with launches.uncounted():
            y = pt.time_stretch(x, pt.StftConfig(frame_size=1024,
                                                 hop_size=256), 1.5,
                                device="cuda")
    finally:
        vocoder._running_sum = run_sum
    write_wav(path, y.cpu().numpy(), sr, bits=16)


def _compare_example(check, name, dirs, stdout, wav) -> str:
    """One example's card output against its CPU output: WAV codes within
    1 (outside the first and last N samples of the uncentered sharded_eq,
    whose eps-divided edge norm amplifies roundoff: reported); the time
    stretch frame by frame (C23: codes drift apart where a bin's phase
    advance lies at +-pi): in every run of STRETCH_RUN frames the median
    per-frame magnitude distance at most STRETCH_GATE, while the stretch
    with its phase accumulation dropped must read above it; arrays within
    1e-4 of their largest |value| (the streaming output within 1e-5),
    printed levels within 0.1 dB, the printed tempo equal."""
    import os
    import re

    import numpy as np

    card, cpu = dirs["cuda"], dirs["cpu"]
    notes = []

    def wavs(rel, edge=0):
        a, b = _wav_codes(os.path.join(card, rel)), _wav_codes(
            os.path.join(cpu, rel))
        check(a.shape == b.shape, f"{name} {rel}: shapes {a.shape} {b.shape}")
        d = np.abs(a - b)
        inner = d[:, edge : d.shape[1] - edge] if edge else d
        check(int(inner.max()) <= 1, f"{name} {rel}: {int(inner.max())} "
              "codes apart")
        notes.append(f"{rel} max {int(inner.max())} code" + (
            f", edges {int(d.max())}" if edge else ""))

    if name == "analyze":
        for stem in ("harmonic.wav", "percussive.wav"):
            wavs(stem)
        tempo = [[ln for ln in s.splitlines() if ln.startswith("tempo:")]
                 for s in stdout]
        check(tempo[0] == tempo[1], f"tempo {tempo}")
        notes.append(tempo[0][0])
    elif name in ("denoise", "fir_filter"):
        wavs("out.wav")
    elif name == "sharded_eq":
        wavs("out.wav", edge=EXAMPLE_EDGE)
    elif name == "time_stretch":
        # The vocoder's phase advance is the principal argument of a phase
        # difference scaled by Hs / Ha: where it lies at +-pi, float32
        # roundoff of the spectra moves a bin's phase for the rest of the
        # stream (ROADMAP C23), so the outputs are held frame by frame on
        # their magnitudes, beside a broken phase path.
        broken = os.path.join(card, "broken.wav")
        _broken_stretch(wav, broken)
        a, b, z = (_wav_codes(p) / 32767.0 for p in (
            os.path.join(card, "out.wav"), os.path.join(cpu, "out.wav"),
            broken))
        check(a.shape == b.shape == z.shape,
              f"{name}: shapes {a.shape} {b.shape} {z.shape}")
        worst, best = _stretch_runs(a, b)
        z_worst, z_best = _stretch_runs(z, b)
        check(worst <= STRETCH_GATE, f"{name}: a run of {STRETCH_RUN} "
              f"frames reads {worst:.4f} > {STRETCH_GATE} from the CPU")
        check(z_worst > STRETCH_GATE, f"{name}: the broken phase path reads "
              f"{z_worst:.4f}, within the gate {STRETCH_GATE}")
        d = np.abs(a - b)[:, EXAMPLE_EDGE:-EXAMPLE_EDGE] * 32767.0
        first = np.flatnonzero((d > 1).any(0))
        upto = EXAMPLE_EDGE + (first[0] if first.size else d.shape[1])
        notes.append(
            f"per-frame magnitude distance, median of each run of "
            f"{STRETCH_RUN} frames: at most {worst:.4f} (least {best:.5f}; "
            f"gate {STRETCH_GATE}); with the phase accumulation dropped "
            f"{z_worst:.4f} at most, {z_best:.4f} at least; inside the "
            f"uncentered edges codes up to {d.max():.0f} apart, within 1 up "
            f"to sample {upto} (C23)")
    elif name == "extract_features":
        fa = np.load(os.path.join(card, "out.npz"))
        fb = np.load(os.path.join(cpu, "out.npz"))
        worst = 0.0
        for k in fb.files:
            a, b = fa[k], fb[k]
            check(a.shape == b.shape, f"{name} {k}: shapes")
            if k in ("onset_frames", "tempo_bpm", "sample_rate", "hop_size"):
                check(np.array_equal(a, b), f"{name} {k}: {a} vs {b}")
                continue
            r = float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                                   1e-30)
            check(r <= 1e-4, f"{name} {k}: {r:.3e} of its largest value")
            worst = max(worst, r)
        notes.append(f"arrays within {worst:.2e} of their largest value, "
                     "onsets and tempo equal")
    elif name == "loudness":
        num = re.compile(r"-?\d+\.\d")
        va, vb = (num.findall(s) for s in stdout)
        check(len(va) == len(vb) == 10, f"{name}: {stdout}")
        d = max(abs(float(p) - float(q)) for p, q in zip(va, vb))
        check(d <= 0.1 + 1e-9, f"{name}: levels {d} dB apart")
        notes.append(f"levels within {d:.1f} dB")
    elif name == "streaming_checkpoint":
        a = np.load(os.path.join(card, "out.npy"))
        b = np.load(os.path.join(cpu, "out.npy"))
        check(a.shape == b.shape, f"{name}: shapes")
        d = float(np.max(np.abs(a - b)))
        check(d <= 1e-5, f"{name}: {d:.3e} apart")
        notes.append(f"within {d:.2e}")
    return "; ".join(notes)


# The frames-level routes (phase 49): 20 ms frames with a 5 ms hop at 48
# kHz, the 30 ms / 10 ms geometry at 44.1 kHz's sizes, and the clips too
# short for the blocked kernel.
N_FOLD, H_FOLD = 960, 240
N_ODD, H_ODD = 1323, 441
CLIPS, CLIP_LEN = 128, 1200


def routes_path(dev, phase, check, failures, x, x_np) -> dict:
    """Phase 49, with the B0 and B1 counters reset just before: the
    frames-level routes of `round_trip` on the main path's 2 ch x 60 s, each
    B1 launch held torch.equal to plain (`LaunchHold`) and each B0 launch
    within its bound of plain (`KernelHold`); then each route's CUDA-event
    time beside the `stft_istft` route it replaces, in turns, outside the
    counts."""
    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import spectral
    from crlot_tpu_torch.bench.launches import uncounted
    from crlot_tpu_torch.core.types import FftBackend, FrameSpec, PadMode
    from crlot_tpu_torch.fft import dispatch
    from crlot_tpu_torch.fft import tf32x3 as b0
    from crlot_tpu_torch.fft.matmul_backend import roundtrip_packed_matmul
    from crlot_tpu_torch.frame.framing import frame_signal
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.ola.norm import edge_norm
    from crlot_tpu_torch.timing import cuda_ms
    from crlot_tpu_torch.window.windows import get_window

    n = x.shape[-1]
    out = {"results": {}, "timings": {}}
    b0.launches = b1.launches = 0
    c960 = pt.StftConfig(frame_size=N_FOLD, hop_size=H_FOLD, center=True)
    c1024 = pt.StftConfig(frame_size=NFFT, hop_size=HOP, center=True)
    band960 = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR,
                                 N_FOLD)
    band1024 = spectral.band_gain([500.0, 4000.0], [0.5, 1.0, 0.25], SR, NFFT)
    clips_np = np.ascontiguousarray(
        x_np[0, : CLIPS * CLIP_LEN].reshape(CLIPS, CLIP_LEN))
    clips = torch.from_numpy(clips_np).to(dev)
    # (c): no StftConfig takes an odd N, so the reference's packed branch
    # is driven as its round_trip would compose it: frames, the packed
    # products, B1 with the edge norm.
    spec_odd = FrameSpec(N_ODD, H_ODD, True, PadMode.REFLECT)
    w_odd = get_window(pt.WindowType.HANN, N_ODD, True, dtype=np.float64)
    f_odd = spec_odd.num_frames(n)
    full_odd = (f_odd - 1) * H_ODD + N_ODD
    norm_odd = torch.from_numpy(
        edge_norm(w_odd, H_ODD, f_odd, full_odd)).to(dev)
    pad_odd = spec_odd.pad_amount

    def packed_odd(sig):
        frames = roundtrip_packed_matmul(frame_signal(sig, spec_odd), N_ODD,
                                         w_odd)
        y = b1.ola_normalized_auto(frames, norm_odd, H_ODD, full_odd, 1e-8)
        return y[..., pad_odd : pad_odd + n]

    def fft_odd(sig):  # what stft -> istft would run at N = 1323
        fr = frame_signal(sig, spec_odd)
        spec = dispatch.rfft_windowed(fr, N_ODD, w_odd, FftBackend.XLA)
        frames = dispatch.irfft(spec, N_ODD, FftBackend.XLA)
        y = b1.ola_normalized_auto(frames, norm_odd, H_ODD, full_odd, 1e-8)
        return y[..., pad_odd : pad_odd + n]

    def stft_istft(sig, cfg, fn=None):
        spec = pt.stft(sig, cfg)
        return pt.istft(spec if fn is None else fn(spec), cfg,
                        length=sig.shape[-1])

    cases = [  # name, route, call, the call it replaces
        ("(a) identity N 960 H 240", "folded",
         lambda: pt.round_trip(x, c960), lambda: stft_istft(x, c960)),
        ("(b) band_gain N 960 H 240", "composed",
         lambda: pt.round_trip(x, c960, band960),
         lambda: stft_istft(x, c960, band960)),
        ("(c) identity N 1323 H 441", "packed (direct)",
         lambda: packed_odd(x), lambda: fft_odd(x)),
        (f"(d) band_gain on {CLIPS} clips of {CLIP_LEN}", "composed",
         lambda: pt.round_trip(clips, c1024, band1024),
         lambda: stft_istft(clips, c1024, band1024)),
    ]
    launch = LaunchHold(check)
    products = KernelHold(check)

    def held(fn):
        with launch, products:
            got = fn()
            torch.cuda.synchronize(dev)
        return got

    def p49():
        lines = []
        check(pt.formulation_for(c960, None, n) == "folded", "(a) route")
        check(pt.formulation_for(c960, band960, n) == "composed",
              "(b) route")
        check(pt.formulation_for(c1024, band1024, CLIP_LEN) == "composed",
              "(d) route")
        check(c1024.frame_spec.num_frames(CLIP_LEN) == 5, "(d) frames")
        try:
            pt.StftConfig(frame_size=N_ODD, hop_size=H_ODD)
            check(False, "(c) an odd StftConfig was taken")
        except ValueError:
            pass
        y = held(cases[0][2])
        snr = pt.snr_db(x_np, y)
        check(y.shape == x.shape and snr > 60.0, f"(a) snr {snr:.2f} dB")
        lines.append(f"(a) folded: {snr:.2f} dB vs input")
        y = held(cases[1][2])
        want = _oracle(x_np, band960.per_bin_gains(N_FOLD), c960)
        snr = min(pt.snr_db(want[c], y[c, :SR]) for c in range(2))
        check(snr >= 80.0, f"(b) snr vs f64 oracle {snr:.2f} dB")
        lines.append(f"(b) composed: first 1 s vs f64 oracle {snr:.2f} dB")
        y = held(cases[2][2])
        snr = pt.snr_db(x_np, y)
        check(y.shape == x.shape and snr > 60.0, f"(c) snr {snr:.2f} dB")
        lines.append(f"(c) packed products + B1 at [2, {f_odd}, {N_ODD}] "
                     f"H {H_ODD}: {snr:.2f} dB vs input")
        y = held(cases[3][2])
        want = _oracle(clips_np, band1024.per_bin_gains(NFFT), c1024,
                       CLIP_LEN)
        snr = min(pt.snr_db(want[c], y[c]) for c in range(CLIPS))
        check(snr >= 80.0, f"(d) worst clip vs f64 oracle {snr:.2f} dB")
        lines.append(f"(d) composed: worst clip vs f64 oracle {snr:.2f} dB")
        rows = {}
        for name, frames in (("N 960 H 240", frame_signal(x, c960.frame_spec)),
                             ("clips", frame_signal(clips,
                                                    c1024.frame_spec))):
            _, _, lda = b0.frame_rows(frames)
            rows[name] = ("in place" if lda < frames.shape[-1]
                          else "copied (lda = N)")
        out["results"]["frame_rows"] = rows
        seen = launch.seen["b1"]
        check(len(seen) == 4 and b1.launches == 4,
              f"B1 launches {b1.launches}, held {len(seen)}")
        check(products.held["b0"] == 2 and b0.launches == 2,
              f"B0 launches {b0.launches}, held {products.held['b0']}")
        hops = sorted({h for h, _, _ in seen})
        lines.append(f"B1 x{len(seen)} torch.equal to plain at hops {hops} "
                     f"({', '.join(str(list(s)) for _, s, _ in seen)})")
        lines.append(products.summary())
        lines.append("B0 frame rows: " + ", ".join(
            f"{k} {v}" for k, v in rows.items()))
        return "; ".join(lines)

    phase("49 frames-level routes (composed, folded, packed)", p49)
    out["counts"] = {"b0": b0.launches, "b1": b1.launches}
    log(f"frames-level routes path launches: B0 {b0.launches}, B1 "
        f"{b1.launches}")
    if not (b0.launches and b1.launches):
        failures.append("launch counts (routes path)")
        log("FAIL launch counts: a kernel of the path was not launched")
    try:
        with uncounted():
            for name, route, call, former in cases:
                t = out["timings"][name] = {"route": [], "stft_istft": []}
                for key, fn in (("route", call), ("stft_istft", former),
                                ("stft_istft", former), ("route", call)):
                    queued, per_call = cuda_ms(fn, REPS)
                    t[key].append(per_call if queued is None else queued)
                log(f"time {name}: {route} "
                    f"{' / '.join(f'{v:.4f}' for v in t['route'])} ms, the "
                    f"stft_istft route it replaces "
                    f"{' / '.join(f'{v:.4f}' for v in t['stft_istft'])} ms "
                    f"(CUDA events, median of {REPS}, queued; in turns "
                    f"route, stft_istft, stft_istft, route)")
    except Exception as e:
        failures.append("timings (routes path)")
        log(f"FAIL timings (routes path): {type(e).__name__}: {e}")
    return out


# Phase 50: the "packed_parts" route at large frames (BASELINE config 2),
# the cell `large4096.gate_tracks`'s configuration and tones at N 2048 and
# 4096, hop N/4: LARGE_ROWS channels of LARGE_SECONDS a call.
LARGE_N = (2048, 4096)
LARGE_ROWS, LARGE_SECONDS = 16, 3
LARGE_SEED = 2 ** 31 + 50
# The frames whose gate decision the kernel's and the plain version's
# rounding flip (C12) are left out of the comparison with the plain split
# path; a share above this means a wrong spectrum, not rounding.
LARGE_FLIPPED = 0.05


class SplitHold:
    """Every launch of the split path's three kernels while the context is
    open (`fused_rt.packed_fold_cuda`, `packed_forward_cuda`,
    `packed_inverse_cuda`), held at once against its plain version on its
    own operands: the fold torch.equal to `packed_fold_plain`; the forward
    GEMM within tf32x3.REL_TOL of sum |a||b| of `packed_forward_plain`
    per output; the inverse within REL_TOL of the two products' sum
    |a||b| (each unfolded sample adds two), plus 2^-23 of the sample for
    the f32 adds, of `packed_inverse_plain`. No gate runs inside a launch,
    so no frame is left out here."""

    def __init__(self, check):
        from crlot_tpu_torch.fft import fused_rt, tf32x3

        self.rt, self.b0, self.check = fused_rt, tf32x3, check
        self.held = {"fold": 0, "forward": 0, "inverse": 0}
        self.worst = {"forward": 0.0, "inverse": 0.0}

    def _scale(self, a, hi, lo):
        import torch

        return torch.matmul(a.abs(), (hi + lo).abs().T)

    def __enter__(self):
        import torch

        rt = self.rt
        self.orig = fold, fwd, inv = (rt.packed_fold_cuda,
                                      rt.packed_forward_cuda,
                                      rt.packed_inverse_cuda)

        def fold_spy(padded, nfft, hop, n_frames, window_f32):
            e, o = fold(padded, nfft, hop, n_frames, window_f32)
            we, wo = rt.packed_fold_plain(padded, nfft, hop, n_frames,
                                          window_f32)
            self.check(torch.equal(e, we) and torch.equal(o, wo),
                       f"fold N {nfft} {list(padded.shape)}: not bit-exact")
            self.held["fold"] += 1
            return e, o

        def fwd_spy(e, o, nfft, bases):
            re, im = fwd(e, o, nfft, bases)
            wre, wim = rt.packed_forward_plain(e, o, bases)
            rel = max(
                float(((got - want).abs()
                       / self._scale(a, hi, lo).clamp_min(1e-30)).max())
                for got, want, a, hi, lo in ((re, wre, e, *bases[:2]),
                                             (im, wim, o, *bases[2:])))
            self.worst["forward"] = max(self.worst["forward"], rel)
            self.check(rel <= self.b0.REL_TOL,
                       f"forward N {nfft}, {e.shape[0]} rows: {rel:.3e} of "
                       f"sum|a||b| (bound {self.b0.REL_TOL:.3e})")
            self.held["forward"] += 1
            return re, im

        def inv_spy(re, im, nfft, bases):
            out = inv(re, im, nfft, bases)
            want = rt.packed_inverse_plain(re, im, nfft, bases)
            sa, sb = (self._scale(re, *bases[:2]),
                      self._scale(im, *bases[2:]))
            h = nfft // 2
            scale = torch.cat([sa[:, : h + 1] + sb[:, : h + 1],
                               (sa[:, 1:h] + sb[:, 1:h]).flip(-1)], -1)
            err = (out - want).abs() - 2.0 ** -23 * want.abs()
            rel = float((err / scale.clamp_min(1e-30)).max())
            self.worst["inverse"] = max(self.worst["inverse"], rel)
            self.check(rel <= self.b0.REL_TOL,
                       f"inverse N {nfft}, {re.shape[0]} rows: {rel:.3e} of "
                       f"sum|a||b| (bound {self.b0.REL_TOL:.3e})")
            self.held["inverse"] += 1
            return out

        rt.packed_fold_cuda, rt.packed_forward_cuda = fold_spy, fwd_spy
        rt.packed_inverse_cuda = inv_spy
        return self

    def __exit__(self, *exc):
        (self.rt.packed_fold_cuda, self.rt.packed_forward_cuda,
         self.rt.packed_inverse_cuda) = self.orig

    def summary(self) -> str:
        return (f"held against plain: fold x{self.held['fold']} torch.equal, "
                f"forward x{self.held['forward']} (worst "
                f"{self.worst['forward']:.3e} of sum|a||b|), inverse "
                f"x{self.held['inverse']} (worst {self.worst['inverse']:.3e}"
                f"), bound {self.b0.REL_TOL:.3e}")


def large_frames_path(dev, phase, check, failures) -> dict:
    """Phase 50, with the split path's and B1's counters reset just
    before: `round_trip`'s "packed_parts" route on the cell
    `large4096.gate_tracks`'s configuration, gate and tones
    (LARGE_ROWS x LARGE_SECONDS a call) at N 2048 and 4096, hop N/4. At
    HIGH: each launch held against plain (`SplitHold`), exactly one fold,
    one forward and one inverse launch a call, the output within the
    plain split path's (3xTF32 as the kernels split it) max-abs 1e-5
    outside the frames whose gate decision the two spectra flip (C12; at
    most LARGE_FLIPPED of them), and within the cell's limits of
    `portbench/reference/stft64.py`'s float64 round trip. At HIGHEST: no
    launch of the split path, the same limits. Then, outside the counts,
    at the cell's full shape (16 x 200 s, N 4096): each kernel's CUDA-event
    time with its TF32 rate and bound, and the whole call's."""
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import pipeline, spectral
    from crlot_tpu_torch.bench.launches import uncounted
    from crlot_tpu_torch.core.padding import pad_signal
    from crlot_tpu_torch.fft import fused_rt as rt
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.timing import cuda_ms
    from portbench import drive, signals
    from portbench.reference import stft64

    cell = json.loads((ROOT / "portbench/configs/large4096.json").read_text())
    mix = json.loads((ROOT / "portbench/traffic/gate_tracks.json").read_text())
    limits = json.loads(
        (ROOT / "portbench/limits/large4096.gate_tracks.json").read_text())
    sr = cell["sample_rate"]
    g = torch.Generator(device=dev).manual_seed(LARGE_SEED)
    x = signals.make(mix["signal"], LARGE_ROWS, LARGE_SECONDS * sr, sr, g,
                     dev)
    out = {"results": {}, "timings": {}}
    for k in rt.packed_launches:
        rt.packed_launches[k] = 0
    b1.launches = 0
    hold = SplitHold(check)

    def flipped_frames(padded, nfft, f, w32, fn):
        """[C, f] bool: the frames holding a bin that the gate decides one
        way on the forward GEMM's spectrum and the other on the plain
        version's, of the same fold (ROADMAP C12: rounding, not a fault);
        the launch made here is not counted."""
        (op,) = spectral.epilogue_of(fn)
        thresh = float(op.scalars[0])
        bases = rt.kernel_bases_on(nfft, dev)
        k = nfft // 2 + 1
        e, o = rt.packed_fold_plain(padded, nfft, nfft // 4, f, w32)
        with uncounted():
            got = rt.packed_forward_cuda(e, o, nfft, bases[:4])
        want = rt.packed_forward_plain(e, o, bases[:4])
        keep = [((re * re + im * im) >= thresh)[:, :k]
                for re, im in (got, want)]
        return (keep[0] != keep[1]).any(-1).view(padded.shape[0], f)

    def p50():
        lines = []
        calls = 0
        for nfft in LARGE_N:
            config = {**cell, "frame_size": nfft, "hop_size": nfft // 4}
            cfg = drive.port_config(config)
            fn = drive.port_spectral(mix["spectral"], config)
            check(pt.formulation_for(cfg, fn, x.shape[-1]) == "packed_parts",
                  f"N {nfft}: route")
            check(rt.packed_engine(cfg.fft_precision, dev) == "rt_gemm",
                  f"N {nfft}: engine")
            before = dict(rt.packed_launches)
            with hold:
                y = pt.round_trip(x, cfg, fn)
                torch.cuda.synchronize(dev)
            calls += 1
            got = {k: rt.packed_launches[k] - before[k] for k in before}
            check(got == {"fold": 1, "forward": 1, "inverse": 1},
                  f"N {nfft}: launches {got}")
            # Against the plain split path outside the ambiguous frames.
            spec_ = cfg.frame_spec
            f = spec_.num_frames(x.shape[-1])
            pad = spec_.pad_amount
            padded = pad_signal(x, pad, pad, spec_.pad_mode).contiguous()
            w32 = torch.from_numpy(
                pipeline._window_np(cfg).astype("float32")).to(dev)
            frames = rt.packed_frames_plain(padded, nfft, nfft // 4, f, w32,
                                            fn.packed)
            full = (f - 1) * (nfft // 4) + nfft
            norm = pipeline._norm_on(cfg, f, full, dev)
            want = b1.ola_normalized_plain(frames, norm, nfft // 4, full,
                                           cfg.eps)[..., pad : pad + x.shape[-1]]
            mask = flipped_frames(padded, nfft, f, w32, fn)
            cover = rt.frames_cover(mask, nfft // 4, nfft, padded.shape[-1])
            keep = ~cover[..., pad : pad + x.shape[-1]]
            err = float((y - want).abs()[keep].max())
            left = int(mask.sum())
            check(err <= 1e-5, f"N {nfft}: max-abs {err:.3e} from the plain "
                  f"split path outside {left} flipped frames")
            check(left <= LARGE_FLIPPED * mask.numel(),
                  f"N {nfft}: {left} of {mask.numel()} frames flipped")
            ref = stft64.RoundTrip(config, mix["spectral"], dev)
            r = stft64.clip_round_trip(ref, x, cfg.center)
            c = stft64.compare(y, r)
            check(c["err_rel"] <= limits["err_rel"]["limit"]
                  and c["peak_rel"] <= limits["peak_rel"]["limit"],
                  f"N {nfft} HIGH: {c} against the float64 reference")
            # HIGHEST keeps torch.matmul.
            cfg_hi = drive.port_config({**config, "precision": "highest"})
            check(rt.packed_engine(cfg_hi.fft_precision, dev) == "matmul",
                  f"N {nfft}: HIGHEST's engine")
            before = dict(rt.packed_launches)
            y_hi = pt.round_trip(x, cfg_hi, fn)
            torch.cuda.synchronize(dev)
            calls += 1
            check(rt.packed_launches == before,
                  f"N {nfft}: HIGHEST launched the split path")
            c_hi = stft64.compare(y_hi, r)
            check(c_hi["err_rel"] <= limits["err_rel"]["limit"]
                  and c_hi["peak_rel"] <= limits["peak_rel"]["limit"],
                  f"N {nfft} HIGHEST: {c_hi} against the float64 reference")
            out["results"][nfft] = {"high": c, "highest": c_hi,
                                    "plain_max_abs": err, "ambiguous": left,
                                    "frames": mask.numel()}
            lines.append(
                f"N {nfft}: HIGH err_rel {c['err_rel']:.3e} peak_rel "
                f"{c['peak_rel']:.3e}, HIGHEST {c_hi['err_rel']:.3e} / "
                f"{c_hi['peak_rel']:.3e} (limits "
                f"{limits['err_rel']['limit']:g} / "
                f"{limits['peak_rel']['limit']:g}); max-abs {err:.3e} from "
                f"the plain split path outside {left} flipped frames of "
                f"{mask.numel()}")
        check(b1.launches == calls, f"B1 launches {b1.launches}, {calls} "
              "calls")
        lines.append(hold.summary())
        lines.append(f"launches {dict(rt.packed_launches)}, B1 "
                     f"{b1.launches}")
        return "; ".join(lines)

    phase("50 large frames on packed_parts (the split path)", p50)
    out["counts"] = dict(rt.packed_launches)
    try:
        with uncounted():
            out["timings"] = large_frames_timings(dev, cell, mix, cuda_ms)
    except Exception as e:
        failures.append("timings (large frames)")
        log(f"FAIL timings (large frames): {type(e).__name__}: {e}")
    return out


def large_frames_timings(dev, cell, mix, cuda_ms) -> dict:
    """At the cell's full shape (its channels x samples, N 4096, hop 1024):
    each split-path kernel's CUDA-event time (median of REPS, queued) with
    the TF32 rate its products issue (3 passes of 2 accumulators over the
    tiles of `fused_rt.gemm_plan`) and its bound at the TF32 peak; the
    fold's bytes over HBM; then the whole `round_trip` call."""
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch import pipeline
    from crlot_tpu_torch.core.padding import pad_signal
    from crlot_tpu_torch.fft import fused_rt as rt
    from portbench import drive, signals

    cfg = drive.port_config(cell)
    fn = drive.port_spectral(mix["spectral"], cell)
    nfft, hop = cfg.frame_size, cfg.hop_size
    rows_c, n = cell["channels"], cell["samples"]
    g = torch.Generator(device=dev).manual_seed(LARGE_SEED + 1)
    x = signals.make(mix["signal"], rows_c, n, cell["sample_rate"], g, dev)
    spec_ = cfg.frame_spec
    f = spec_.num_frames(n)
    rows = rows_c * f
    pad = spec_.pad_amount
    padded = pad_signal(x, pad, pad, spec_.pad_mode).contiguous()
    w32 = torch.from_numpy(pipeline._window_np(cfg).astype("float32")).to(dev)
    bases = rt.kernel_bases_on(nfft, dev)
    e, o = rt.packed_fold_cuda(padded, nfft, hop, f, w32)
    re, im = rt.packed_forward_cuda(e, o, nfft, bases[:4])
    plan = rt.gemm_plan(rows, nfft)
    kp = rt.padded_bins(nfft)
    t = {}
    for key, call in (
            ("fold", lambda: rt.packed_fold_cuda(padded, nfft, hop, f, w32)),
            ("forward", lambda: rt.packed_forward_cuda(e, o, nfft,
                                                       bases[:4])),
            ("inverse", lambda: rt.packed_inverse_cuda(re, im, nfft,
                                                       bases[4:])),
            ("round_trip", lambda: pt.round_trip(x, cfg, fn))):
        queued, per_call = cuda_ms(call, REPS)
        t[key] = per_call if queued is None else queued
    # The TF32 operations the tiles issue: 128 rows x 64 columns a tile, the
    # issued k8 steps, 2 accumulators, 3 passes, 2 flop a MAC.
    k_issued = 8 * (4 * (plan.k_stages - 1) + plan.k_last)
    dft = 4.0 * rows * (nfft // 2 + 1) * (nfft // 2) * 2  # N^2 MACs a frame
    for key, cb in (("forward", plan.col_blocks[0]),
                    ("inverse", plan.col_blocks[1])):
        issued = plan.row_blocks * 128 * cb * 64 * k_issued * 2 * 3 * 2
        t[key + "_tflops"] = issued / (t[key] / 1e3) / 1e12
        t[key + "_bound_ms"] = 3 * dft / 2 / PEAK_OPS["tf32"] * 1e3
    fold_bytes = padded.numel() * 4 + 2 * rows * kp * 4
    t["fold_bound_ms"] = fold_bytes / HBM_BPS * 1e3
    log(f"time large frames at the cell's shape ({rows_c} x {n}, N {nfft}, "
        f"{rows} frames; CUDA events, median of {REPS}, queued): fold "
        f"{t['fold']:.3f} ms (bound {t['fold_bound_ms']:.3f}, "
        f"{fold_bytes / 1e9:.2f} GB), forward GEMM {t['forward']:.3f} ms "
        f"({t['forward_tflops']:.1f} TFLOP/s of TF32 issued; the DFT's "
        f"bound {t['forward_bound_ms']:.3f} ms), inverse GEMM "
        f"{t['inverse']:.3f} ms ({t['inverse_tflops']:.1f} TFLOP/s; bound "
        f"{t['inverse_bound_ms']:.3f}), round_trip {t['round_trip']:.3f} ms")
    return t


def _blocked_composition(signal, cfg, fn):
    """The blocked route as it was composed before it wrote the signal
    once: the centre pad, its first `full` samples in float32,
    `hopblock_apply` (its halo by `F.pad`), the normalised patches, the
    interior and a cat, then the crop."""
    import torch

    from crlot_tpu_torch.core.padding import pad_signal
    from crlot_tpu_torch.fft import matmul_backend as mb

    spec_ = cfg.frame_spec
    full = ((spec_.num_frames(signal.shape[-1]) - 1) * cfg.hop_size
            + cfg.frame_size)
    padded = pad_signal(signal, spec_.pad_amount, spec_.pad_amount,
                        spec_.pad_mode, spec_.pad_value)
    plan = mb.blocked_plan_for(cfg, mb.blocked_response(cfg, fn))
    kern, bt = plan.operands(signal.device, cfg.fft_precision)
    edge, span_p = plan.edge, plan.patch_span
    x = padded[..., :full].float()
    out = mb.hopblock_apply(x, kern, plan.gh, full, edge, cfg.fft_precision,
                            bt)
    head = plan.edge_patch(x[..., :span_p], "head")
    tail = plan.edge_patch(x[..., full - span_p :], "tail")
    out = torch.cat([head, plan.interior_(out[..., edge : full - edge]),
                     tail], dim=-1)
    return out[..., spec_.pad_amount : spec_.pad_amount + signal.shape[-1]]


def _oracle(x_np, gains_f64, cfg, span=SR):
    """float64 numpy STFT * g * iSTFT (center, reflect padding) of the first
    `span` samples of each row of x_np. Frames touching t < span lie inside
    the first span + N samples, so the prefix gives the full-signal values
    there exactly."""
    import numpy as np

    from crlot_tpu_torch.pipeline import _window_f64

    n, hop = cfg.frame_size, cfg.hop_size
    w = _window_f64(cfg)
    pad = n // 2
    outs = []
    for c in range(x_np.shape[0]):
        xp = np.pad(x_np[c, : span + 2 * n].astype(np.float64), (pad, pad),
                    mode="reflect")  # numpy's reflect is reflect101
        f = (xp.size - n) // hop + 1
        idx = np.arange(f)[:, None] * hop + np.arange(n)[None, :]
        y_frames = np.fft.irfft(np.fft.rfft(xp[idx] * w, axis=-1) * gains_f64,
                                n=n, axis=-1)
        acc = np.zeros(xp.size)
        nrm = np.zeros(xp.size)
        for i in range(f):
            acc[i * hop : i * hop + n] += y_frames[i]
            nrm[i * hop : i * hop + n] += w
        outs.append((acc / np.maximum(nrm, cfg.eps))[pad : pad + span])
    return np.stack(outs)


def multihost(nproc: int) -> int:
    """`python3 chip_smoke.py --multihost <nproc>`: phase 41's ranks alone,
    rank r on card r % the card count (NCCL where each has its own, as on
    a four-card machine; gloo where they share one); prints rank 0's
    report and each rank's held launches."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    log(f"nvidia-smi: {smi()}; {torch.cuda.device_count()} cards")
    from crlot_tpu_torch import cuda_build

    cuda_build.load_library()  # once, before the ranks load it
    report, holds, wall = run_multihost(nproc)
    log(json.dumps(report))
    for h in holds:
        log(f"rank {h['rank']}: B0 {h['b0']}, B3 {h['b3']}; {h['summary']}")
    log(f"{nproc} ranks: {wall:.1f} s")
    return 0


SEEDED_ROWS, SEEDED_FRAMES = 128, 2352  # the gate stream cell's feed


def seeded_ola_path(dev, phase, check, failures) -> dict:
    """Phase 51, with B1's seeded counter reset just before: B1's seeded
    variant (the masked stream's overlap-add, `ola.fused.ola_seeded`)
    torch.equal to its plain version on the card, one launch counted a
    call: at the cell `nrstream128.gate_stream`'s feed (128 rows of 2352
    frames of 1024, hop 256: the 602 112-sample block with the 768-sample
    tail seeded first and the divide, then the tail window undivided;
    the frames of an interior feed and of the first) and at odd shapes (R
    2 and 5, N off the hop, hops 21 and 7, windows off the hop grid, a
    frames pointer off 16 bytes, an empty frame range). Then, outside the
    counts, the block's and the tail's CUDA-event times at the cell's
    feed beside their bound (frames, seed and norm read once, the output
    written once), the plain version's and the composition the variant
    replaced (the `where`, two `overlap_add` passes, the divide)."""
    import torch

    from crlot_tpu_torch.bench.launches import uncounted
    from crlot_tpu_torch.ola import fused as b1
    from crlot_tpu_torch.ola.reference import overlap_add

    eps = 1e-8
    rows, n_frames = SEEDED_ROWS, SEEDED_FRAMES
    t_block, halo = n_frames * HOP, NFFT - HOP
    f_hi = (t_block - NFFT) // HOP + 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    frames = torch.randn((rows, n_frames, NFFT), generator=g, device=dev)
    seed = torch.randn((rows, halo), generator=g, device=dev)
    norm = torch.rand(t_block, generator=g, device=dev) + 0.5
    b1.seeded_launches = 0
    out = {}

    def held(fr, hop, t0, length, lo, hi, sd, nrm):
        before = b1.seeded_launches
        got = b1.ola_seeded(fr, hop, t0, length, lo, hi, sd, nrm, eps)
        torch.cuda.synchronize()
        check(b1.seeded_launches == before + 1,
              f"{b1.seeded_launches - before} launches for one call")
        want = b1.ola_seeded_plain(fr, hop, t0, length, lo, hi, sd, nrm, eps)
        check(torch.equal(got, want)
              and torch.equal(torch.signbit(got), torch.signbit(want)),
              f"[{t0}, +{length}) of {list(fr.shape)} at H {hop}, frames "
              f"[{lo}, {hi}): not bit-exact, max-abs "
              f"{float((got - want).abs().max()):.3g}")

    def p51():
        for lo in (0, 4):
            held(frames, HOP, 0, t_block, lo, f_hi, seed, norm)
            held(frames, HOP, t_block, halo, lo, f_hi, None, None)
        g1 = torch.Generator(device=dev).manual_seed(1)
        nf, shapes = 50, []
        for nfft, hop in ((64, 32), (160, 32), (100, 32), (63, 21), (33, 7)):
            for offset in (0, 1):
                flat = torch.randn(3 * nf * nfft + offset, generator=g1,
                                   device=dev)
                fr = flat[offset:].view(3, nf, nfft)
                sd = torch.randn((3, nfft - hop), generator=g1, device=dev)
                nrm = torch.rand(nf * hop + 1000, generator=g1,
                                 device=dev) + 0.25
                nrm[::97] = 0.0  # below eps: divided by eps
                for t0, length in ((0, nf * hop), (nf * hop, nfft - hop),
                                   (5, 301)):
                    held(fr, hop, t0, length, 3, nf - 4, sd, nrm)
                    held(fr, hop, t0, length, 7, 7, None, None)
            shapes.append(f"N {nfft} H {hop}")
        out["launches"] = b1.seeded_launches
        return (f"{b1.seeded_launches} launches, each torch.equal to plain: "
                f"the cell's block and tail ([{rows}, {n_frames}, {NFFT}], "
                f"frames from 0 and from 4 to {f_hi}), and {', '.join(shapes)}"
                f" on 16-byte and offset frames")

    def p51_times():
        def former():
            start = HOP * torch.arange(n_frames, device=dev)
            of = torch.where((start + NFFT <= t_block)[:, None], frames, 0.0)
            tail = overlap_add(of, HOP, t_block + halo)[..., t_block:]
            acc = overlap_add(of, HOP, t_block, init_head=seed)
            return acc / torch.clamp_min(norm, eps), tail

        timing = {}
        with uncounted():
            timed(timing, "block", lambda: b1.ola_seeded(
                frames, HOP, 0, t_block, 0, f_hi, seed, norm, eps))
            timed(timing, "tail", lambda: b1.ola_seeded(
                frames, HOP, t_block, halo, 0, f_hi))
            timed(timing, "plain", lambda: b1.ola_seeded_plain(
                frames, HOP, 0, t_block, 0, f_hi, seed, norm, eps))
            timed(timing, "former", former)
        b = bound(nbytes(frames, seed, norm) + rows * t_block * 4)
        out.update(timing=timing, **b)
        return (f"block {ms(timing, 'block')}, tail {ms(timing, 'tail')}; "
                f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), the block "
                f"at {100 * b['bound_ms'] / timing['block']:.1f} % of it; "
                f"plain {ms(timing, 'plain')}; the former where + two "
                f"overlap_add + divide {ms(timing, 'former')}")

    phase("51 B1 seeded vs plain (the masked stream's OLA)", p51)
    phase("51 B1 seeded times at the gate stream's feed", p51_times)
    return out


CHAIN_ROWS, CHAIN_CHUNK, CHAIN_FEEDS = 128, 1_323_000, 3  # the cell's feed


def chain_stream_path(dev, phase, check, failures) -> dict:
    """Phase 52, with B4's and B7's counters reset just before: the
    resample chain's stream at the cell `rschain128.chain_stream`'s feed,
    each B4 launch held against the plain bank product on the buffer it
    was given, each B7 launch against `stft_plain` (the float64 DFT of
    its own windowed frames) within `stft_tolerance`, the frames
    against the folded route's torch ops (`rfft_folded_packed`) on the
    plain chain over the whole stream."""
    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch.fft import fp32_window as b7
    from crlot_tpu_torch.fft import matmul_backend as mm
    from crlot_tpu_torch.resample import kernel as b4
    from crlot_tpu_torch.resample import polyphase
    from crlot_tpu_torch.window.windows import WindowType, get_window

    rates = (44100, 48000, 16000)
    cfg = pt.StftConfig(frame_size=400, hop_size=160)
    rows, chunk = CHAIN_ROWS, CHAIN_CHUNK
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((rows, CHAIN_FEEDS * chunk), generator=g,
                    device=dev) * 0.05
    out = {}

    def rel(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    def p52():
        launch, held, counts, frames = polyphase.resample_cuda, [], [], []
        stft_launch, spectra, worst = b7.stft_cuda, [], {}

        def recorded(buf, l, m, n_out, *args, **kwargs):
            y = launch(buf, l, m, n_out, *args, **kwargs)
            held.append((buf, l, m, n_out, y))
            return y

        def recorded_stft(fr, n, w):
            spec = stft_launch(fr, n, w)
            spectra.append((fr, n, w, spec))
            return spec

        st = pt.ResampledStftStreamer(rates, cfg, rows, dev)
        polyphase.resample_cuda = recorded
        b7.stft_cuda = recorded_stft
        b4.launches = b7.stft_launches = 0
        try:
            for k in range(CHAIN_FEEDS):
                before, before7 = b4.launches, b7.stft_launches
                frames.append(st.feed(x[:, k * chunk:(k + 1) * chunk]))
                counts.append((b4.launches - before, frames[-1].shape[-2],
                               b7.stft_launches - before7))
                for buf, l, m, n_out, y in held:
                    err = rel(y, b4.resample_bank_plain(buf, l, m, n_out))
                    worst[f"{l}/{m}"] = max(worst.get(f"{l}/{m}", 0.0), err)
                    check(err <= 1e-5, f"feed {k}, B4 at {l}/{m} on "
                          f"{list(buf.shape)}: {err:.3e} of the largest")
                for fr, n, w, spec in spectra:
                    want = b7.stft_plain(fr, n, w)
                    tol = b7.stft_tolerance(fr, n, w)
                    got64 = spec.to(torch.complex128)
                    over = ((got64.real - want.real).abs() > tol.real) | (
                        (got64.imag - want.imag).abs() > tol.imag)
                    worst["B7"] = max(worst.get("B7", 0.0), rel(got64, want))
                    check(not bool(over.any()), f"feed {k}, B7 on "
                          f"{list(fr.shape)}: {int(over.sum())} outputs "
                          f"off the bound")
                    del want, tol, got64, over
                held.clear()
                spectra.clear()
        finally:
            polyphase.resample_cuda = launch
            b7.stft_cuda = stft_launch
        check(all(n == 2 for n, _, _ in counts),
              f"B4 launches a feed {[n for n, _, _ in counts]}")
        check(all(n == 1 for _, _, n in counts),
              f"B7 launches a feed {[n for _, _, n in counts]}")
        hops = chunk // 441  # 441 samples at 44.1 kHz: one hop at 16 kHz
        check(0 < counts[0][1] < hops
              and all(f == hops for _, f, _ in counts[1:]),
              f"frames a feed {[f for _, f, _ in counts]}")
        got = torch.cat(frames, dim=-2)
        del frames
        y = x
        for a, b in zip(rates, rates[1:]):
            c = math.gcd(a, b)
            l, m = b // c, a // c
            y = b4.resample_bank_plain(y, l, m, -(-y.shape[-1] * l // m))
        n, hop, f = cfg.frame_size, cfg.hop_size, got.shape[-2]
        w64 = get_window(cfg.window, n, cfg.periodic, dtype=np.float64)
        want = torch.complex(*mm.rfft_folded_packed(
            y[:, : (f - 1) * hop + n].unfold(-1, n, hop), n, w64))
        err = rel(got, want)
        check(err <= 1e-5, f"frames {err:.3e} of the largest bin")
        out.update(launches=b4.launches, b7_launches=b7.stft_launches,
                   counts=counts, stage_err=worst, frame_err=err)
        return (f"B4 launches {b4.launches} ({[n for n, _, _ in counts]} a "
                f"feed), B7 launches {b7.stft_launches} "
                f"({[n for _, _, n in counts]} a feed), frames "
                f"{[f for _, f, _ in counts]} a feed; each B4 launch against "
                f"the plain bank product on its buffer, each B7 launch "
                f"within its bound of the float64 products, largest "
                f"{', '.join(f'{k} {v:.3e}' for k, v in worst.items())}"
                f" of the largest output; {got.shape[-2]} frames against "
                f"the folded route's torch ops on the plain chain, "
                f"{err:.3e} of the largest bin")

    phase("52 the resample chain's stream at rschain128's feed", p52)
    return out


# B7's checks: (rows, row length, N, H, window), one row and 128 (the
# chain's feed among them), rows of a length off 4 (each row's start off 16
# bytes), frame counts off a CTA's, hops below, at and above N, every radix,
# Hann and a window that is not symmetric.
B7_CASES = ((1, 160 * 2999 + 400, 400, 160, "hann"),
            (128, 160 * 120 + 400 + 3, 400, 160, "random"),
            (3, 128 * 300 + 512 + 1, 512, 128, "hann"),
            (2, 200 * 77 + 512 + 2, 512, 200, "random"),
            (5, 256 * 41 + 1024 + 3, 1024, 256, "random"),
            (2, 333 * 50 + 1024 + 1, 1024, 333, "hann"),
            (2, 1100 * 19 + 1024 + 5, 1024, 1100, "random"),
            (4, 7 * 33 + 16 + 1, 16, 7, "random"),
            (3, 45 * 60 + 98 + 1, 98, 45, "random"),
            (2, 100 * 30 + 960 + 1, 960, 100, "hann"),
            (128, 160 * 2999 + 400 + 1, 400, 160, "hann"))


def stft_b7_path(dev, phase, check, failures) -> dict:
    """Phase 53, with B7's counter reset just before: the framed windowed
    rFFT's kernel (`fp32_window.stft_cuda`) on `unfold` views read in
    place, against `stft_plain` (the float64 DFT of the kernel's own
    windowed frames) within `stft_tolerance`, and a run of the frames
    copied out and taken alone torch.equal to its bins in the whole; the
    cell's
    chain streamed in uneven feeds torch.equal to the one-shot
    `resampled_stft` a stage and to `stft` of the one-shot chain. Then,
    outside the counts, B7's CUDA-event time on 30 s of 128 channels at
    16 kHz (the cell's feed: 3000 frames of 400, hop 160; and N 512, hop
    128 and N 1024, hop 256) beside its bound, the folded route's
    (`matmul_backend.rfft_folded_packed`, then the complex interleave) and
    `torch.fft.rfft` of the windowed frames (cuFFT)."""
    import numpy as np
    import torch

    import crlot_tpu_torch as pt
    from crlot_tpu_torch.bench.launches import uncounted
    from crlot_tpu_torch.core.consts import const_on
    from crlot_tpu_torch.fft import dispatch
    from crlot_tpu_torch.fft import fp32_window as b7
    from crlot_tpu_torch.fft import matmul_backend as mm
    from crlot_tpu_torch.window.windows import WindowType, get_window

    g = torch.Generator(device=dev).manual_seed(SEED)
    b7.stft_launches = 0
    out = {"worst": 0.0}

    def window(n, kind):
        if kind == "hann":
            return const_on(get_window(WindowType.HANN, n), dev)
        return torch.rand(n, generator=g, device=dev) + 0.1

    def p53():
        shapes = []
        for rows, length, n, hop, kind in B7_CASES:
            x = torch.randn(rows * length + 1, generator=g, device=dev)
            x = x[1:].view(rows, length)  # rows off 16 bytes
            frames = x.unfold(-1, n, hop)
            w = window(n, kind)
            before = b7.stft_launches
            got = b7.stft_cuda(frames, n, w)
            torch.cuda.synchronize()
            check(b7.stft_launches == before + 1, "one launch a call")
            want = b7.stft_plain(frames, n, w)
            tol = b7.stft_tolerance(frames, n, w)
            got64 = got.to(torch.complex128)
            over = ((got64.real - want.real).abs() > tol.real) | (
                (got64.imag - want.imag).abs() > tol.imag)
            rel = float((got64 - want).abs().max() / want.abs().max())
            out["worst"] = max(out["worst"], rel)
            check(not bool(over.any()), f"N {n} H {hop} {rows} x {length}: "
                  f"{int(over.sum())} outputs off the bound")
            part = frames[-1:, 1:-1]
            alone = b7.stft_cuda(part.contiguous(), n, w)
            check(torch.equal(alone, got[-1:, 1:-1]), f"N {n} H {hop}: a "
                  f"frame's bins depend on its neighbours")
            plan = b7.stft_plan(n, hop)
            shapes.append(f"N {n} H {hop} {rows} x {frames.shape[1]} "
                          f"(radices {b7.stft_radices(n)}, {plan.tm} frames "
                          f"a CTA)")
        cfg = pt.StftConfig(frame_size=400, hop_size=160)
        x = torch.randn((2, 3 * 44100 + 17), generator=g, device=dev) * 0.1
        for rates in ((44100, 16000), (44100, 48000, 16000)):
            st = pt.ResampledStftStreamer(rates, cfg, 2, dev)
            parts, pos, k = [], 0, 0
            feeds = (1, 441, 8191, 147, 44100, 3)
            while pos < x.shape[-1]:
                step = feeds[k % len(feeds)]
                parts.append(st.feed(x[:, pos:pos + step]))
                pos, k = pos + step, k + 1
            parts.append(st.finish())
            got = torch.cat(parts, dim=-2)
            y = x
            for a, b in zip(rates, rates[1:]):
                y = pt.resample(y, a, b)
            want = (pt.resampled_stft(x, *rates, cfg) if len(rates) == 2
                    else pt.stft(y, cfg))
            check(got.shape == want.shape and torch.equal(got, want),
                  f"{rates}: streamed {tuple(got.shape)} not torch.equal "
                  f"to one-shot {tuple(want.shape)}")
        check(dispatch.windowed_route(400, dev) == "B7", "route")
        out["launches"] = b7.stft_launches
        return (f"{b7.stft_launches} launches; each within its bound of "
                f"the float64 products (worst {out['worst']:.3e} of the "
                f"largest bin): {'; '.join(shapes)}; the chain streamed in "
                f"uneven feeds torch.equal to one-shot")

    def p53_times():
        rows, length = 128, 16000 * 30  # 30 s at 16 kHz, the chain's feed
        x = torch.randn((rows, length), generator=g, device=dev)
        parts = []
        for n, hop in ((400, 160), (512, 128), (1024, 256)):
            frames = x[:, : (length - n) // hop * hop + n].unfold(-1, n, hop)
            w64 = get_window(WindowType.HANN, n, dtype=np.float64)
            w = const_on(w64, dev)
            timing = {}
            with uncounted():
                timed(timing, "b7", lambda: b7.stft_cuda(frames, n, w))
                timed(timing, "folded", lambda: torch.complex(
                    *mm.rfft_folded_packed(frames, n, w64)))
                timed(timing, "cufft", lambda: torch.fft.rfft(
                    frames * w, n=n, dim=-1))
            h, f = n // 2, frames.shape[1]
            ops = 2.5 * n * math.log2(n) * rows * f  # a real FFT's flop
            b = bound(nbytes(x) + rows * f * (h + 1) * 8, ops)
            out[f"N{n}"] = dict(timing=timing, **b)
            parts.append(
                f"N {n} H {hop} {rows} x {f}: B7 {ms(timing, 'b7')}, bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}), B7 at "
                f"{100 * b['bound_ms'] / timing['b7']:.1f} % of it; the "
                f"folded route {ms(timing, 'folded')}; torch.fft.rfft of "
                f"the windowed frames (cuFFT) {ms(timing, 'cufft')}")
            del frames
        return "; ".join(parts)

    phase("53 B7 vs plain (the framed windowed rFFT)", p53)
    phase("53 B7 times at the chain's feed", p53_times)
    return out


def alone(path) -> int:
    """One path of phases run alone, with its timings; exits 1 if one of
    them fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from crlot_tpu_torch import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"nvidia-smi: {smi()}")
    cuda_build.load_library()
    log(f"kernel build: {cuda_build.build_seconds:.2f} s")
    failures = []

    def phase(name, fn):
        try:
            msg = fn()
            torch.cuda.synchronize()
            log(f"PASS {name}: {msg}")
        except Exception as e:
            failures.append(name)
            log(f"FAIL {name}: {type(e).__name__}: {e}")

    def check(cond, what):
        if not cond:
            raise AssertionError(what)

    path(torch.device("cuda", 0), phase, check, failures)
    log(f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if failures:
        log(f"chip_smoke: failed: {failures}")
        return 1
    return 0


def large_frames() -> int:
    """`python3 chip_smoke.py --large-frames`: phase 50 alone, with its
    timings; exits 1 if it fails."""
    return alone(large_frames_path)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--large-frames"]:
        sys.exit(large_frames())
    if sys.argv[1:2] == ["--seeded-ola"]:
        sys.exit(alone(seeded_ola_path))
    if sys.argv[1:2] == ["--chain-stream"]:
        sys.exit(alone(chain_stream_path))
    if sys.argv[1:2] == ["--stft-b7"]:
        sys.exit(alone(stft_b7_path))
    if sys.argv[1:2] == ["--multihost-child"]:
        sys.exit(multihost_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--multihost"]:
        sys.exit(multihost(int(sys.argv[2])))
    sys.exit(main())
