// B3: the fused nonlinear STFT round-trip as [F, N] round-trip frames.
// B2: the same, then overlap-add and COLA normalize (B1's kernel).
//
// B3 replaces the Pallas kernel crlot_tpu/fft/pallas_rt.py::_rt_kernel and,
// followed by ola_fused.cu's overlap-add, B2 replaces
// pallas_rt.py::_rt_ola_kernel. One call, crlot_rt_frames, runs three
// kernels on the frames of a signal (frame f of channel c starts at c *
// ch_stride + f * frame_stride; samples at or past the channel's lp read as
// 0.0, the zero padding the Pallas caller applies). Each also has an entry
// of its own (crlot_rt_fold, crlot_rt_forward, crlot_rt_inverse) for a
// caller that runs a step of its own between the GEMMs: round_trip's
// "packed_parts" route, whose spectral fn runs in torch on Re, Im.
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
// GEMM is a persistent grid of clusters of CTAs. A CTA has one producer
// warpgroup, which keeps a ring of 3 stages of 64 KB filled by TMA (the two
// A tiles of 128 rows x 32 floats and the four B tiles of 64 x 32: both
// accumulators' hi and lo), and two consumer warpgroups of 64 rows each,
// which split their A fragments on chip (the TF32 rounding on the integer
// pipe) and run the 3 TF32 products of each k step for both accumulators:
// 4 x 32 registers of accumulators (the running sums and a stage's fresh
// partials). A stage's k steps run as two groups of wgmma: steps 2, 3 are
// split while steps 0, 1 run, and the next stage's steps 0, 1 while steps
// 2, 3 run. The last stage runs only the k steps that hold bins (at N =
// 1024, Kp = 520: 1 of its 4).
//
// The feed: a cluster is 2 row blocks at one column block (1 under 2),
// which read the same basis tiles. Each CTA's producer loads its own A
// tiles and half of the basis tiles, with TMA's multicast, so that one L2
// read lands in both CTAs: a CTA reads 48 KB from L2 a stage where it read
// 64 KB. A stage is refilled only once every consumer warp of the cluster
// has released it (its empty barrier counts their remote arrivals). A CTA
// whose row block lies past the last row loads only its basis share and
// stores nothing. A frame's result depends only on its own samples: not on
// its batch, its tile, its CTA or the cluster size.
//
// The epilogue runs the menu op by op over a thread's 32 (frame, bin)
// pairs, each op's descriptor read once; the inverse stores its samples
// and their mirror images as 8-byte pairs, a lane taking its left
// neighbour's mirrored sample by a shuffle.
//
// What bounds it on an H100 (495 TFLOP/s TF32, 3.35 TB/s): a frame costs 4
// products of K x K multiply-adds, 3 TF32 passes each: at 2 x 60 s (45 004
// frames, N = 1024) 47.3 GFLOP x 3 = 0.287 ms of tensor-core time, against
// about 280 MB of e, o, Re', Im' and frames through device memory (0.08 ms):
// operations. At the 64-channel batch (720 064 frames) each GEMM issues
// 2.59 TFLOP of TF32 in 9.95 to 10.5 ms, 50 to 53 % of the peak (42 to 47 %
// before this design: the menu's per-bin descriptor reads and the
// inverse's 4-byte stores took a quarter of each GEMM; the L2 feed was not
// the limit). Without loads, split or epilogue the same m64n64k8 wgmmas
// take 9.8 ms: their issue rate now bounds the tile (PERF.md §6).
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

template <int N>
struct KSteps {  // a count of k steps, as a type
  static constexpr int value = N;
};

enum { OP_GAIN = 1, OP_REAL_GAINS = 2, OP_COMPLEX = 3, OP_GATE = 4,
       OP_SUBTRACT = 5 };

__device__ __forceinline__ void scale(float& re, float& im, float s) {
  re = __fmul_rn(re, s);
  im = __fmul_rn(im, s);
}

__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
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
  int k_last;      // k8 steps of the last stage that hold bins (1 to 4)
  int cluster;     // CTAs (row blocks at one column block) a cluster
  int row_groups;  // clusters' row groups: ceil(row blocks / cluster)
  int col_blocks, tiles;  // per GEMM: tiles = row_groups * col_blocks
};

// The GEMMs' plan, from the rows and N alone (fused_rt.py's gemm_plan is
// the same function): a cluster of 2 row blocks, of 1 under 2.
RtShape rt_shape(long long rows, int nfft) {
  RtShape s;
  s.rows = (int)rows;
  s.nfft = nfft;
  s.k_bins = nfft / 2 + 1;
  s.kp = (s.k_bins + 7) / 8 * 8;
  s.kt_n = (s.kp * 4 + kBK - 1) / kBK;
  s.k_last = (s.kp - (s.kt_n - 1) * (kBK / 4)) / 8;
  const int row_blocks = (s.rows + kBM - 1) / kBM;
  s.cluster = row_blocks >= 2 ? 2 : 1;
  s.row_groups = (row_blocks + s.cluster - 1) / s.cluster;
  s.col_blocks = s.tiles = 0;
  return s;
}

// The bytes a CTA reads from L2 a stage: its two A tiles and its share of
// the four basis tiles.
constexpr int rt_stage_l2_bytes(int cluster) {
  return 2 * kOpTile + 4 * kRtBTile / cluster;
}

// 2, 3. acc0 = A0 . B0 (B0 hi, B1 lo) and acc1 = A1 . B2 (B2 hi, B3 lo).
// Forward: A0 = e, A1 = o, out0 = Re', out1 = Im'. Inverse: A0 = Re', A1 =
// Im', out0 = the frames. Cluster tile t (of s.tiles) is row group t /
// col_blocks at column block t % col_blocks; CTA `rank` of the cluster
// takes that group's row block `rank`.
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
  const int rank = blockIdx.x % s.cluster;
  const int first = blockIdx.x / s.cluster, stride = gridDim.x / s.cluster;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRtStages; ++st) {
      bar_init(full0 + 8 * st, 1);
      // One arrival a consumer warp of every CTA of the cluster: a stage
      // is refilled once all of them have read it.
      bar_init(empty0 + 8 * st, kConsumers * 4 * s.cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peers' barriers exist before anything lands there

  if (wg == kConsumers) {
    // Producer: one thread issues every TMA load: its own A tiles, and its
    // share of the basis tiles multicast to the whole cluster.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == 0) {
      const CUtensorMap* maps_b[4] = {&map_b0, &map_b1, &map_b2, &map_b3};
      const int share = 4 / s.cluster;
      const uint16_t mask = (uint16_t)((1u << s.cluster) - 1);
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty: the first waits pass
      for (int t = first; t < s.tiles; t += stride) {
        const int row0 = ((t / s.col_blocks) * s.cluster + rank) * kBM;
        const int col0 = (t % s.col_blocks) * kRtBN;
        // A row block past the last row: the bases only, nothing stored.
        const bool rows_in = row0 < s.rows;
        for (int kt = 0; kt < s.kt_n; ++kt) {
          const uint32_t full = full0 + 8 * stage;
          bar_wait(empty0 + 8 * stage, phase);
          bar_expect_tx(full, rows_in ? kRtStage : 4 * kRtBTile);
          const uint32_t dst = smem_u32(ring + stage * kRtStage);
          if (rows_in) {
            tma_load_2d(dst, &map_a0, full, kt * kBK, row0);
            tma_load_2d(dst + kOpTile, &map_a1, full, kt * kBK, row0);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j / share == rank)
              tma_load_2d_multicast(dst + 2 * kOpTile + j * kRtBTile,
                                    maps_b[j], full, kt * kBK, col0, mask);
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
  // The split A fragments of two k steps of a stage: 8 registers a step for
  // each of A0 and A1.
  uint32_t fh0[2][4], fl0[2][4], fh1[2][4], fl1[2][4];  // k steps 0, 1
  uint32_t gh0[2][4], gl0[2][4], gh1[2][4], gl1[2][4];  // k steps 2, 3
  float part0[NR], part1[NR];
  auto split = [&](int st, int k0, uint32_t (&h0)[2][4],
                   uint32_t (&l0)[2][4], uint32_t (&h1)[2][4],
                   uint32_t (&l1)[2][4]) {
    const uint8_t* base = ring + st * kRtStage;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      tf32_frags<true>(base, wg, tid, k0 + k, h0[k], l0[k]);
      tf32_frags<true>(base + kOpTile, wg, tid, k0 + k, h1[k], l1[k]);
    }
  };
  // KS k steps from k step k0 of a stage into the partials, one group.
  auto issue = [&](auto ks, int st, int k0, uint32_t (&h0)[2][4],
                   uint32_t (&l0)[2][4], uint32_t (&h1)[2][4],
                   uint32_t (&l1)[2][4]) {
    constexpr int KS = decltype(ks)::value;
    using F = const uint32_t(&)[KS][4];  // the first KS steps
    const uint32_t b = smem_u32(ring + st * kRtStage + 2 * kOpTile);
    wgmma_fence();
    tf32x3_steps<kRtBN, KS>(part0, reinterpret_cast<F>(h0),
                            reinterpret_cast<F>(l0), sw128_desc(b),
                            sw128_desc(b + kRtBTile), k0);
    tf32x3_steps<kRtBN, KS>(part1, reinterpret_cast<F>(h1),
                            reinterpret_cast<F>(l1),
                            sw128_desc(b + 2 * kRtBTile),
                            sw128_desc(b + 3 * kRtBTile), k0);
    wgmma_commit();
  };
#pragma unroll
  for (int i = 0; i < NR; ++i) part0[i] = part1[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  if (first < s.tiles) {  // the first stage's k steps 0, 1, split ahead
    bar_wait(full0, 0);
    split(0, 0, fh0, fl0, fh1, fl1);
  }
  for (int t = first; t < s.tiles; t += stride) {
    const int row0 = ((t / s.col_blocks) * s.cluster + rank) * kBM;
    const int col0 = (t % s.col_blocks) * kRtBN;
    float acc0[NR], acc1[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) acc0[i] = acc1[i] = 0.0f;
    for (int kt = 0; kt < s.kt_n; ++kt) {
      // The stage's k steps in two groups: 0, 1 (split ahead) and 2, 3,
      // split under the first group's products. The last stage stops at
      // its last bin (the steps left out would add products of zero
      // padding); a row block past the last row runs none.
      const int n_steps = row0 >= s.rows ? 0 : kt + 1 < s.kt_n ? 4 : s.k_last;
      __syncwarp();  // wgmma is .aligned: the warp issues it converged
      if (n_steps >= 2)
        issue(KSteps<2>(), stage, 0, fh0, fl0, fh1, fl1);
      else if (n_steps == 1)
        issue(KSteps<1>(), stage, 0, fh0, fl0, fh1, fl1);
      if (n_steps > 2) {
        split(stage, 2, gh0, gl0, gh1, gl1);
        if (n_steps == 4)
          issue(KSteps<2>(), stage, 2, gh0, gl0, gh1, gl1);
        else
          issue(KSteps<1>(), stage, 2, gh0, gl0, gh1, gl1);
        wgmma_wait1();  // the first group has read its fragments
      } else {
        wgmma_wait0();
      }
      // The next stage's k steps 0, 1, split under the last group.
      const int next = stage + 1 == kRtStages ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      if (kt + 1 < s.kt_n || t + stride < s.tiles) {
        bar_wait(full0 + 8 * next, next_phase);
        split(next, 0, fh0, fl0, fh1, fl1);
      }
      wgmma_wait0();
      fence_acc(part0);
      fence_acc(part1);
      if (lane < s.cluster) bar_arrive_cluster(empty0 + 8 * stage, lane);
      promote(acc0, part0);
      promote(acc1, part1);
      stage = next;
      phase = next_phase;
    }
    // Epilogue from registers. In the m64nN layout warp w holds rows 16w + g
    // and 16w + g + 8 and, for each 8-column block j, columns 8j + 2q and
    // 8j + 2q + 1: elements 4j + 2h and 4j + 2h + 1.
    if constexpr (!kInverse) {
      // The menu op by op, each op over the thread's 32 (frame, bin) pairs
      // with its descriptor read once: on each pair the same operations in
      // the same order as the menu bin by bin.
      for (int op = 0; op < n_ops; ++op) {
        const int code = desc[2 * op];
        const float* p = params + desc[2 * op + 1];
        const int kk = s.k_bins;
        auto each = [&](auto f) {
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const int k = col0 + 8 * (i / 4) + 2 * q + (i & 1);
            if (k < kk) f(acc0[i], acc1[i], k);
          }
        };
        if (code == OP_GAIN) {
          const float gain = p[0];
          each([&](float& re, float& im, int) { scale(re, im, gain); });
        } else if (code == OP_REAL_GAINS) {
          each([&](float& re, float& im, int k) { scale(re, im, p[k]); });
        } else if (code == OP_COMPLEX) {
          each([&](float& re, float& im, int k) {
            const float hr = p[k], hi = p[kk + k], r = re, m = im;
            re = __fsub_rn(__fmul_rn(r, hr), __fmul_rn(m, hi));
            im = __fadd_rn(__fmul_rn(r, hi), __fmul_rn(m, hr));
          });
        } else if (code == OP_GATE) {
          const float thresh = p[0], att = p[1];
          each([&](float& re, float& im, int) {
            scale(re, im, power(re, im) >= thresh ? 1.0f : att);
          });
        } else if (code == OP_SUBTRACT) {
          const float alpha = p[0], floor_ = p[1];
          each([&](float& re, float& im, int k) {
            const float sub = __fmul_rn(alpha, p[2 + k]);
            const float mag = __fsqrt_rn(power(re, im));
            const float nw = fmaxf(__fsub_rn(mag, sub), __fmul_rn(floor_, mag));
            scale(re, im, mag > 0.0f ? __fdiv_rn(nw, fmaxf(mag, 1e-20f)) : 0.0f);
          });
        }
      }
#pragma unroll
      for (int j = 0; j < kRtBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wg * 64 + warp * 16 + h * 8 + g;
          const int col = col0 + 8 * j + 2 * q;
          const int i = 4 * j + 2 * h;
          if (row >= s.rows || col >= s.kp) continue;  // kp is even
          const long long at = (long long)row * s.kp + col;
          *reinterpret_cast<float2*>(out0 + at) =
              make_float2(acc0[i], acc0[i + 1]);
          *reinterpret_cast<float2*>(out1 + at) =
              make_float2(acc1[i], acc1[i + 1]);
        }
      }
    } else {
      // Frame sample n = A[n] + B[n] (n <= N/2) and, mirrored, N - n =
      // A[n] - B[n] (0 < n < N/2): samples c, c + 1 (c = col0 + 8j + 2q)
      // store as one float2 at c, and the mirrored N - c (even) as one
      // float2 with N - c + 1, sample c - 1's, from the lane on the left
      // (lane 3 of block j - 1 for lane 0). A tile's first and last
      // mirrored samples, whose partners lie in the next tiles, and those
      // at the ends of the range store alone.
      const int hn = s.nfft / 2;
      auto mirrored = [&](int n) { return n >= 1 && n < hn; };
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wg * 64 + warp * 16 + h * 8 + g;
        const bool row_in = row < s.rows;
        float* fr = out0 + (long long)(row_in ? row : 0) * s.nfft;
        float last = 0.0f;  // this lane's mirrored sample c + 1 of block j - 1
#pragma unroll
        for (int j = 0; j < kRtBN / 8; ++j) {
          const int c = col0 + 8 * j + 2 * q, i = 4 * j + 2 * h;
          const float m0 = __fsub_rn(acc0[i], acc1[i]);
          const float m1 = __fsub_rn(acc0[i + 1], acc1[i + 1]);
          const float left = __shfl_sync(0xffffffffu, q == 3 ? last : m1,
                                         (lane & ~3) | ((q + 3) & 3));
          last = m1;
          if (!row_in) continue;
          const float d0 = __fadd_rn(acc0[i], acc1[i]);
          const float d1 = __fadd_rn(acc0[i + 1], acc1[i + 1]);
          if (c + 1 <= hn)
            *reinterpret_cast<float2*>(fr + c) = make_float2(d0, d1);
          else if (c <= hn)
            fr[c] = d0;
          const bool own = mirrored(c);
          const bool from_left = (j > 0 || q > 0) && mirrored(c - 1);
          if (own && from_left) {
            *reinterpret_cast<float2*>(fr + s.nfft - c) = make_float2(m0, left);
          } else {
            if (own) fr[s.nfft - c] = m0;
            if (from_left) fr[s.nfft - c + 1] = left;
          }
          if (j == kRtBN / 8 - 1 && q == 3 && mirrored(c + 1))
            fr[s.nfft - c - 1] = m1;
        }
      }
    }
  }
  // No CTA leaves while a peer may still arrive on its barriers.
  __syncwarp();
  cluster_sync();
}

template <bool kInverse>
int prepare_gemm(int device) {
  static int entry_regs[kMaxDevices];  // 0 until set up on that device
  return sm90_prepare(rt_gemm_kernel<kInverse>, kRtSmem, device, entry_regs,
                      "fused_rt");
}

// A launch of `blocks` CTAs in clusters of `cluster` along x.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int blocks, int cluster, cudaStream_t st) : attr(), cfg() {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kRtSmem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of `cluster` CTAs the device holds at once: the
// persistent grid. Asked once a device and cluster size.
template <bool kInverse>
int resident_clusters(int device, int cluster, int* n) {
  static int known[kMaxDevices][3];  // clusters of 1, 2, 4; 0 until asked
  int& k = known[device][cluster / 2];
  if (k == 0) {
    ClusterLaunch l(cluster, cluster, 0);
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&k, rt_gemm_kernel<kInverse>, &l.cfg);
    if (e != cudaSuccess) return (int)e;
    if (k < 1) return (int)cudaErrorInvalidConfiguration;
  }
  *n = k;
  return 0;
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
                float* out1, RtShape s, int device, cudaStream_t st) {
  CUtensorMap ma0, ma1, mb[4];
  bool ok = encode_rows(&ma0, a0, s.rows, s.kp, kBM) &&
            encode_rows(&ma1, a1, s.rows, s.kp, kBM);
  for (int j = 0; j < 4; ++j)
    ok = ok && encode_rows(&mb[j], b[j], s.kp, s.kp, kRtBN);
  if (!ok) return (int)cudaErrorInvalidValue;
  const int cols = kInverse ? s.nfft / 2 + 1 : s.kp;
  s.col_blocks = (cols + kRtBN - 1) / kRtBN;
  s.tiles = s.row_groups * s.col_blocks;
  int clusters;
  const int status = resident_clusters<kInverse>(device, s.cluster, &clusters);
  if (status != 0) return status;
  ClusterLaunch l((s.tiles < clusters ? s.tiles : clusters) * s.cluster,
                  s.cluster, st);
  const cudaError_t e = cudaLaunchKernelEx(
      &l.cfg, rt_gemm_kernel<kInverse>, ma0, ma1, mb[0], mb[1], mb[2], mb[3],
      desc, n_ops, params, out0, out1, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The checks every entry makes on the frame rows and N.
bool rows_ok(long long rows, int nfft) {
  return nfft >= 4 && nfft % 2 == 0 && rows >= 1 &&
         rows <= (1ll << 31) - 1 - kBM;
}

template <bool kInverse>
int gemm_entry(const float* a0, const float* a1, const float* const* b,
               const int* desc, int n_ops, const float* params, float* out0,
               float* out1, long long rows, int nfft, void* stream) {
  if (!rows_ok(rows, nfft)) return (int)cudaErrorInvalidValue;
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const int status = prepare_gemm<kInverse>(device);
  if (status != 0) return status;
  return launch_gemm<kInverse>(a0, a1, b, desc, n_ops, params, out0, out1,
                               rt_shape(rows, nfft), device,
                               (cudaStream_t)stream);
}

}  // namespace

// The GEMMs' plan of `rows` frame rows at N = nfft, as crlot_rt_frames
// launches it, into out[6]: the cluster, the L2 bytes a CTA loads a stage,
// the k8 steps of the last stage, the row groups, and the forward's and
// the inverse's column blocks.
extern "C" int crlot_rt_plan(long long rows, int nfft, int* out) {
  if (!rows_ok(rows, nfft)) return (int)cudaErrorInvalidValue;
  const RtShape s = rt_shape(rows, nfft);
  out[0] = s.cluster;
  out[1] = rt_stage_l2_bytes(s.cluster);
  out[2] = s.k_last;
  out[3] = s.row_groups;
  out[4] = (s.kp + kRtBN - 1) / kRtBN;
  out[5] = (s.k_bins + kRtBN - 1) / kRtBN;
  return 0;
}

// 1. The fold pass over `channels` x `n_frames` frames: frame f of channel
// c is x[c * ch_stride + f * frame_stride + n], n < nfft, read as 0 at or
// past lp. e, o: [rows, Kp].
extern "C" int crlot_rt_fold(const float* x, long long ch_stride,
                             long long lp, long long frame_stride,
                             const float* window, float* e, float* o,
                             int channels, int n_frames, int nfft,
                             void* stream) {
  const long long rows = (long long)channels * n_frames;
  if (!rows_ok(rows, nfft) || n_frames < 1 || channels < 1 || lp < 1)
    return (int)cudaErrorInvalidValue;
  rt_fold_kernel<<<(unsigned)rows, kFoldThreads, 0, (cudaStream_t)stream>>>(
      x, ch_stride, lp, frame_stride, window, e, o, n_frames, nfft,
      rt_shape(rows, nfft).kp);
  return (int)cudaGetLastError();
}

// 2. The forward GEMM with the epilogue menu (n_ops 0: none): e, o ->
// re, im, each [rows, Kp]. fwd = (C hi, C lo, S hi, S lo), [Kp, Kp]
// K-major.
extern "C" int crlot_rt_forward(const float* e, const float* o,
                                const float* c_hi, const float* c_lo,
                                const float* s_hi, const float* s_lo,
                                const int* desc, int n_ops,
                                const float* params, float* re, float* im,
                                long long rows, int nfft, void* stream) {
  const float* fwd[4] = {c_hi, c_lo, s_hi, s_lo};
  return gemm_entry<false>(e, o, fwd, desc, n_ops, params, re, im, rows, nfft,
                           stream);
}

// 3. The inverse GEMM and the unfold: re, im [rows, Kp] -> out [rows,
// nfft]. inv = (Cinv hi, Cinv lo, Sinv hi, Sinv lo), [Kp, Kp] K-major.
extern "C" int crlot_rt_inverse(const float* re, const float* im,
                                const float* ci_hi, const float* ci_lo,
                                const float* si_hi, const float* si_lo,
                                float* out, long long rows, int nfft,
                                void* stream) {
  const float* inv[4] = {ci_hi, ci_lo, si_hi, si_lo};
  return gemm_entry<true>(re, im, inv, nullptr, 0, nullptr, out, nullptr,
                          rows, nfft, stream);
}

// The round-trip frames of `channels` x `n_frames` frames: 1, 2 and 3 in
// turn. e, o, re, im: [rows, Kp] scratch; out: [rows, nfft].
extern "C" int crlot_rt_frames(
    const float* x, long long ch_stride, long long lp, long long frame_stride,
    const float* window, const float* c_hi, const float* c_lo,
    const float* s_hi, const float* s_lo, const float* ci_hi,
    const float* ci_lo, const float* si_hi, const float* si_lo,
    const int* desc, int n_ops, const float* params, float* e, float* o,
    float* re, float* im, float* out, int channels, int n_frames, int nfft,
    void* stream) {
  const long long rows = (long long)channels * n_frames;
  int status = crlot_rt_fold(x, ch_stride, lp, frame_stride, window, e, o,
                             channels, n_frames, nfft, stream);
  if (status == 0)
    status = crlot_rt_forward(e, o, c_hi, c_lo, s_hi, s_lo, desc, n_ops,
                              params, re, im, rows, nfft, stream);
  if (status == 0)
    status = crlot_rt_inverse(re, im, ci_hi, ci_lo, si_hi, si_lo, out, rows,
                              nfft, stream);
  return status;
}
