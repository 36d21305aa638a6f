// B3: the fused nonlinear STFT round-trip as [F, N] round-trip frames.
// B2: the same, then overlap-add and COLA normalize (B1's kernel).
//
// B3 replaces the Pallas kernel crlot_tpu/fft/pallas_rt.py::_rt_kernel and,
// followed by ola_fused.cu's overlap-add, B2 replaces
// pallas_rt.py::_rt_ola_kernel. One call, crlot_rt_frames, runs three
// kernels on the frames of a signal (frame f of channel c starts at c *
// ch_stride + f * frame_stride; samples at or past the channel's lp read as
// 0.0, the zero padding the Pallas caller applies):
//
//   1. rt_fold_kernel: frame -> window -> fold, into e [rows, Kp] and o
//      [rows, Kp]: e[n] = y[n] + y[N-n], o[n] = y[n] - y[N-n] (y = x * w;
//      e[0] = y[0], e[N/2] = y[N/2], o zero there and past N/2).
//   2. rt_gemm_kernel<false>, the forward: Re = e . C and Im = o . S on the
//      same [128 frames x 64 bins] tile (two accumulators, so one thread
//      holds Re and Im of one (frame, bin)), then the spectral fn's
//      epilogue menu per bin in registers, stored as Re', Im' [rows, Kp].
//   3. rt_gemm_kernel<true>, the inverse: A = Re' . Cinv and B = Im' . Sinv
//      on one tile, unfolded into frame samples n = A[n] + B[n] (n <= N/2)
//      and A[N-n] - B[N-n]: the [rows, N] round-trip frames.
//
// Kp = 8 * ceil(K / 8), K = N/2 + 1 bins: 16-byte rows for TMA; the bases
// are zero-padded to [Kp, Kp] on the host, stored K-major (transposed) and
// split into their TF32 hi and lo halves there, with S and Sinv shifted so
// that index n is frame sample n.
//
// The products are 3xTF32 on wgmma (sm90.cuh): the reference's HIGH tier
// (its 3-pass bf16 split on the MXU, pallas_rt.py:29-33, :130-156). Each
// GEMM is a persistent grid of one producer warpgroup, which keeps a ring of
// 3 stages of 64 KB filled by TMA (the two A tiles of 128 rows x 32 floats
// and the four B tiles of 64 x 32: both accumulators' hi and lo), and two
// consumer warpgroups of 64 rows each, which split their A fragments on
// chip and run the 3 TF32 products of each k step for both accumulators:
// 4 x 32 registers of accumulators (the running sums and a stage's fresh
// partials). A frame's result depends only on its own samples: not on its
// batch, its tile or its CTA.
//
// What bounds it on an H100 (495 TFLOP/s TF32, 3.35 TB/s): a frame costs 4
// products of K x K multiply-adds, 3 TF32 passes each: at 2 x 60 s (45 004
// frames, N = 1024) 47.3 GFLOP x 3 = 0.287 ms of tensor-core time, against
// about 280 MB of e, o, Re', Im' and frames through device memory (0.08 ms):
// operations. A stage feeds 3.1 MFLOP from 64 KB of L2 reads, so at the TF32
// peak the ring would need about 10 TB/s from L2: L2 bandwidth, not the
// tensor cores, is the likely limit of this tile.
//
// The epilogue replaces the Pallas kernel's traced jaxpr with a fixed menu
// of per-bin ops read from a small descriptor (see spectral.py): elementwise
// steps use explicitly rounded intrinsics so nvcc does not contract them
// into FMAs, matching the plain torch ops step by step.

#include "sm90.cuh"

namespace {

constexpr int kRtBN = 64;                   // bins / samples per tile
constexpr int kRtStages = 3;
constexpr int kRtBTile = kRtBN * kBK;       // 8 KB
constexpr int kRtStage = 2 * kOpTile + 4 * kRtBTile;  // 64 KB
constexpr int kRtSmem = kRtStages * kRtStage + 2 * kRtStages * 8 + 1024;
static_assert(kRtSmem <= kMaxSmem, "shared memory over 227 KB");
constexpr int kFoldThreads = 128;

enum { OP_GAIN = 1, OP_REAL_GAINS = 2, OP_COMPLEX = 3, OP_GATE = 4,
       OP_SUBTRACT = 5 };

__device__ __forceinline__ void scale(float& re, float& im, float s) {
  re = __fmul_rn(re, s);
  im = __fmul_rn(im, s);
}

__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// The menu on bin k (< K) of one frame, op by op.
__device__ __forceinline__ void apply_epilogue(
    float& re, float& im, int k, int K, const int* __restrict__ desc,
    int n_ops, const float* __restrict__ params) {
  for (int i = 0; i < n_ops; ++i) {
    const int code = desc[2 * i];
    const float* p = params + desc[2 * i + 1];
    if (code == OP_GAIN || code == OP_REAL_GAINS) {
      scale(re, im, code == OP_GAIN ? p[0] : p[k]);
    } else if (code == OP_COMPLEX) {
      const float hr = p[k], hi = p[K + k], r = re, m = im;
      re = __fsub_rn(__fmul_rn(r, hr), __fmul_rn(m, hi));
      im = __fadd_rn(__fmul_rn(r, hi), __fmul_rn(m, hr));
    } else if (code == OP_GATE) {
      scale(re, im, power(re, im) >= p[0] ? 1.0f : p[1]);
    } else if (code == OP_SUBTRACT) {
      const float floor_ = p[1], sub = __fmul_rn(p[0], p[2 + k]);
      const float mag = __fsqrt_rn(power(re, im));
      const float nw = fmaxf(__fsub_rn(mag, sub), __fmul_rn(floor_, mag));
      scale(re, im, mag > 0.0f ? __fdiv_rn(nw, fmaxf(mag, 1e-20f)) : 0.0f);
    }
  }
}

// 1. One block a frame row (row = channel * n_frames + frame).
__global__ void __launch_bounds__(kFoldThreads)
rt_fold_kernel(const float* __restrict__ x, long long ch_stride, long long lp,
               long long frame_stride, const float* __restrict__ window,
               float* __restrict__ e, float* __restrict__ o, int n_frames,
               int nfft, int kp) {
  const long long row = blockIdx.x;
  const float* xc = x + (row / n_frames) * ch_stride;
  const long long start = (row % n_frames) * frame_stride;
  const int h = nfft / 2;
  auto y = [&](int n) -> float {
    return __fmul_rn(start + n < lp ? __ldg(xc + start + n) : 0.0f,
                     __ldg(window + n));
  };
  for (int n = threadIdx.x; n < kp; n += blockDim.x) {
    float ev = 0.0f, ov = 0.0f;
    if (n == 0 || n == h) {
      ev = y(n);
    } else if (n < h) {
      const float a = y(n), b = y(nfft - n);
      ev = __fadd_rn(a, b);
      ov = __fsub_rn(a, b);
    }
    e[row * kp + n] = ev;
    o[row * kp + n] = ov;
  }
}

struct RtShape {
  int rows;        // frame rows
  int kp;          // padded bins: the contraction, and the forward's columns
  int k_bins;      // K = N/2 + 1: the bins the epilogue menu touches
  int nfft;
  int kt_n;        // contraction stages of 32 floats
  int row_blocks, col_blocks, tiles;
};

// 2, 3. acc0 = A0 . B0 (B0 hi, B1 lo) and acc1 = A1 . B2 (B2 hi, B3 lo).
// Forward: A0 = e, A1 = o, out0 = Re', out1 = Im'. Inverse: A0 = Re', A1 =
// Im', out0 = the frames.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
rt_gemm_kernel(const __grid_constant__ CUtensorMap map_a0,
               const __grid_constant__ CUtensorMap map_a1,
               const __grid_constant__ CUtensorMap map_b0,
               const __grid_constant__ CUtensorMap map_b1,
               const __grid_constant__ CUtensorMap map_b2,
               const __grid_constant__ CUtensorMap map_b3,
               const int* __restrict__ desc, int n_ops,
               const float* __restrict__ params, float* __restrict__ out0,
               float* __restrict__ out1, RtShape s) {
  constexpr int NR = kRtBN / 2;
  extern __shared__ uint8_t dyn[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~uintptr_t(1023));
  const uint32_t full0 = smem_u32(ring + kRtStages * kRtStage);
  const uint32_t empty0 = full0 + 8 * kRtStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRtStages; ++st) {
      bar_init(full0 + 8 * st, 1);
      bar_init(empty0 + 8 * st, kConsumers * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == 0) {
      const CUtensorMap* maps_b[4] = {&map_b0, &map_b1, &map_b2, &map_b3};
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty: the first waits pass
      for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
        const int row0 = (t / s.col_blocks) * kBM;
        const int col0 = (t % s.col_blocks) * kRtBN;
        for (int kt = 0; kt < s.kt_n; ++kt) {
          const uint32_t full = full0 + 8 * stage;
          bar_wait(empty0 + 8 * stage, phase);
          bar_expect_tx(full, kRtStage);
          const uint32_t dst = smem_u32(ring + stage * kRtStage);
          tma_load_2d(dst, &map_a0, full, kt * kBK, row0);
          tma_load_2d(dst + kOpTile, &map_a1, full, kt * kBK, row0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_2d(dst + 2 * kOpTile + j * kRtBTile, maps_b[j], full,
                        kt * kBK, col0);
          if (++stage == kRtStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64*wg .. 64*wg + 63 of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int lane = tid % 32, warp = tid / 32, g = lane >> 2, q = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const int row0 = (t / s.col_blocks) * kBM;
    const int col0 = (t % s.col_blocks) * kRtBN;
    float acc0[NR], acc1[NR], part0[NR], part1[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc0[i] = acc1[i] = part0[i] = part1[i] = 0.0f;
    fence_acc(part0);
    fence_acc(part1);
    for (int kt = 0; kt < s.kt_n; ++kt) {
      bar_wait(full0 + 8 * stage, phase);
      __syncwarp();  // wgmma is .aligned: the warp issues it converged
      const uint8_t* base = ring + stage * kRtStage;
      uint64_t db[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        db[j] = sw128_desc(smem_u32(base + 2 * kOpTile + j * kRtBTile));
      // Two halves of 2 k steps: 32 fragment registers at a time.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t h0[2][4], l0[2][4], h1[2][4], l1[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          tf32_frags(base, wg, tid, 2 * half + k, h0[k], l0[k]);
          tf32_frags(base + kOpTile, wg, tid, 2 * half + k, h1[k], l1[k]);
        }
        wgmma_fence();
        tf32x3_steps<kRtBN, 2>(part0, h0, l0, db[0], db[1], 2 * half);
        tf32x3_steps<kRtBN, 2>(part1, h1, l1, db[2], db[3], 2 * half);
        wgmma_commit();
        wgmma_wait0();
        fence_acc(part0);
        fence_acc(part1);
      }
      if (lane == 0) bar_arrive(empty0 + 8 * stage);
      promote(acc0, part0);
      promote(acc1, part1);
      if (++stage == kRtStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // Epilogue from registers. In the m64nN layout warp w holds rows 16w + g
    // and 16w + g + 8 and, for each 8-column block j, columns 8j + 2q and
    // 8j + 2q + 1: elements 4j + 2h and 4j + 2h + 1.
#pragma unroll
    for (int j = 0; j < kRtBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wg * 64 + warp * 16 + h * 8 + g;
        const int col = col0 + 8 * j + 2 * q;
        const int i = 4 * j + 2 * h;
        if (row >= s.rows) continue;
        if constexpr (!kInverse) {
          if (col >= s.kp) continue;  // kp is even: col + 1 < kp too
          float re[2] = {acc0[i], acc0[i + 1]}, im[2] = {acc1[i], acc1[i + 1]};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < s.k_bins)
              apply_epilogue(re[e], im[e], col + e, s.k_bins, desc, n_ops,
                             params);
          const long long at = (long long)row * s.kp + col;
          *reinterpret_cast<float2*>(out0 + at) = make_float2(re[0], re[1]);
          *reinterpret_cast<float2*>(out1 + at) = make_float2(im[0], im[1]);
        } else {
          const int hn = s.nfft / 2;
          float* fr = out0 + (long long)row * s.nfft;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = col + e;
            if (n <= hn) fr[n] = __fadd_rn(acc0[i + e], acc1[i + e]);
            if (n >= 1 && n < hn) fr[s.nfft - n] = __fsub_rn(acc0[i + e],
                                                           acc1[i + e]);
          }
        }
      }
    }
  }
}

template <bool kInverse>
int prepare_gemm(int device) {
  static int entry_regs[kMaxDevices];  // 0 until set up on that device
  return sm90_prepare(rt_gemm_kernel<kInverse>, kRtSmem, device, entry_regs,
                      "fused_rt");
}

// A [rows, kp] f32 matrix as a byte map with 128 x `box_rows` boxes.
bool encode_rows(CUtensorMap* map, const float* base, int rows, int kp,
                 int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)kp * 4, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kp * 4};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 2, dims, strides,
                kBK, box_rows);
}

template <bool kInverse>
int launch_gemm(const float* a0, const float* a1, const float* const* b,
                const int* desc, int n_ops, const float* params, float* out0,
                float* out1, RtShape s, int sms, cudaStream_t st) {
  CUtensorMap ma0, ma1, mb[4];
  bool ok = encode_rows(&ma0, a0, s.rows, s.kp, kBM) &&
            encode_rows(&ma1, a1, s.rows, s.kp, kBM);
  for (int j = 0; j < 4; ++j)
    ok = ok && encode_rows(&mb[j], b[j], s.kp, s.kp, kRtBN);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int cols = kInverse ? s.nfft / 2 + 1 : s.kp;
  s.col_blocks = (cols + kRtBN - 1) / kRtBN;
  s.tiles = s.row_blocks * s.col_blocks;
  rt_gemm_kernel<kInverse><<<s.tiles < sms ? s.tiles : sms, kThreads,
                             kRtSmem, st>>>(
      ma0, ma1, mb[0], mb[1], mb[2], mb[3], desc, n_ops, params, out0, out1,
      s);
  return (int)cudaGetLastError();
}

}  // namespace

// The round-trip frames of `channels` x `n_frames` frames: frame f of
// channel c is x[c * ch_stride + f * frame_stride + n], n < nfft, read as 0
// at or past lp. fwd = (C hi, C lo, S hi, S lo), inv = (Cinv hi, Cinv lo,
// Sinv hi, Sinv lo), each [Kp, Kp] K-major. e, o, re, im: [rows, Kp]
// scratch; out: [rows, nfft].
extern "C" int crlot_rt_frames(
    const float* x, long long ch_stride, long long lp, long long frame_stride,
    const float* window, const float* c_hi, const float* c_lo,
    const float* s_hi, const float* s_lo, const float* ci_hi,
    const float* ci_lo, const float* si_hi, const float* si_lo,
    const int* desc, int n_ops, const float* params, float* e, float* o,
    float* re, float* im, float* out, int channels, int n_frames, int nfft,
    void* stream) {
  const long long rows = (long long)channels * n_frames;
  if (nfft < 4 || nfft % 2 || n_frames < 1 || channels < 1 || lp < 1 ||
      rows > (1ll << 31) - 1 - kBM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int status = prepare_gemm<false>(device);
  if (status == 0) status = prepare_gemm<true>(device);
  if (status != 0) return status;
  const int k = nfft / 2 + 1, kp = (k + 7) / 8 * 8;
  rt_fold_kernel<<<(unsigned)rows, kFoldThreads, 0, st>>>(
      x, ch_stride, lp, frame_stride, window, e, o, n_frames, nfft, kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  RtShape s;
  s.rows = (int)rows;
  s.kp = kp;
  s.k_bins = k;
  s.nfft = nfft;
  s.kt_n = (kp * 4 + kBK - 1) / kBK;
  s.row_blocks = (s.rows + kBM - 1) / kBM;
  s.col_blocks = s.tiles = 0;  // per GEMM
  const float* fwd[4] = {c_hi, c_lo, s_hi, s_lo};
  const float* inv[4] = {ci_hi, ci_lo, si_hi, si_lo};
  status = launch_gemm<false>(e, o, fwd, desc, n_ops, params, re, im, s, sms,
                              st);
  if (status != 0) return status;
  return launch_gemm<true>(re, im, inv, desc, 0, params, out, nullptr, s, sms,
                           st);
}
