// B4: polyphase L/M FIR resampler, all channels in one launch.
//
// Replaces the Pallas kernel crlot_tpu/resample/pallas_kernel.py::_resample_kernel
// (with resample_pallas's left pad of -tau_min):
//
//   y[c, j] = sum_{k<tp} taps_t[k, j % L] * x[c, s_j + k],
//   s_j = floor((j*M + h0) / L) - (tp - 1),   h0 = (n_h - 1) / 2,
//
// with x read as 0 outside [0, T). taps_t is the compact form of the dense
// [L, W] bank (row i's nonzero taps are one contiguous run of tp entries);
// s_j is the first input sample of output j's run, and it never decreases
// with j: consecutive outputs step by floor or ceil of M / L samples.
//
// What bounds it on an H100: at 2 x 60 s, 44.1 -> 48 kHz it does 5.76 M
// outputs x 157 taps (1.81 GFLOP of fp32 work) on 21 MB in and 23 MB out,
// about 40 FLOP per byte, above the card's fp32 balance (67 TFLOP/s over
// 3.35 TB/s, about 20): the FMA pipe bounds it (0.027 ms), and so do the
// loads that feed it. An SM issues 128 fp32 FMAs a clock but serves one
// 128-byte shared-memory wavefront a clock, so a design that reads one
// shared float per FMA (blocks_kernel) cannot pass a quarter of the FMA
// peak.
//
// Design: a register tile of R runs x J outputs a thread (runs_kernel).
//  - A run is J consecutive outputs j0 .. j0 + J - 1 (J = 8 or 7). Their
//    windows start at s_j0 + delta_jj with delta_jj <= (J - 1) * M / L + 1,
//    so all J read one window of span = tp + max delta samples: with the
//    run's taps shifted by delta_jj into a zero-padded table U[class][n][jj]
//    = taps_t[n - delta_jj, (j0 + jj) % L], output j0 + jj is the ascending
//    sum over n < span of U * x[s_j0 + n]. One shared load of x[s_j0 + n]
//    feeds J FMAs. The deltas depend on j0 % L only: nc = L / gcd(L, J)
//    classes, each repeating every lcm(J, L) outputs, Delta = lcm(J, L) *
//    M / L input samples.
//  - A thread takes R runs of one class, 32 * Delta samples apart, so one
//    load of U[class][n][0..7] (two float4, the same address for the whole
//    warp: a broadcast) feeds R * J FMAs. Per step n a warp issues R + 2
//    loads for R * J FMAs (R = 2, J = 8: 4 loads, 16 FMAs).
//  - The 32 lanes of a warp take 32 consecutive runs of its class, Delta
//    samples apart; J is 8, or 7 where that makes Delta odd, so a warp's
//    shared loads hit 32 distinct banks (44.1 -> 48 kHz: J = 8, Delta =
//    147; 48 -> 16 kHz: J = 7, Delta = 21).
//  - A CTA is 8 warps: WC classes x 8 / WC groups of 32 * R periods; it
//    stages the input segment of all its runs in shared memory with bounded
//    (zero-filling) coalesced loads, so no padded copy of x is made. The
//    host picks J, R and WC (resample/kernel.py `geometry`) so that the
//    segment fits 113 KB where it can (two CTAs, 16 warps an SM), else
//    227 KB. On an H100 the compute loop bounds this tile, not the staging:
//    a persistent grid with double-buffered segments, and one CTA holding
//    all of a rate's classes (x staged once), were no faster (PERF.md).
//
// Where no segment fits in shared memory, even at R = 1 (integer
// decimation by M above 141, e.g. 48 kHz -> 300 Hz: M = 160, W = 25 k
// taps), `windows_kernel` takes over: the segment is not staged; each
// thread owns one output and reads its own window of x from L2 in tiles of
// 32 taps, which the CTA loads cooperatively (one warp load = 32
// consecutive samples of one window, coalesced) and transposes through
// shared memory, so each thread then reads its 32 samples without bank
// conflicts.
//
// Numerics: each output is one fp32 FMA chain in ascending input sample,
// starting from 0.0f. The zero entries of U add exact zeros (the
// accumulator is never -0.0: it starts at +0.0 and an exact-zero FMA result
// rounds to +0.0), so every output equals the compact chain in ascending k
// bit for bit, whatever its class, run or place in the tile. Chunked and
// one-shot resampling therefore agree bit for bit (the chunk starts are
// multiples of M), and runs_kernel's outputs equal blocks_kernel's bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxSharedBytes = 232448;  // 227 KB per CTA on sm_90
constexpr int kUCols = 8;                      // U's row: J taps, padded

// 4 bytes global -> shared without a register round trip, so that a thread
// keeps all of its staging loads in flight at once; ok = false writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// First input sample of output j's run of taps.
__device__ __forceinline__ long long run_start(long long j, int l, int m,
                                               int h0, int s_off) {
  return (j * m + h0) / l + s_off;
}

template <int J, int R>
__global__ void __launch_bounds__(kThreads)
runs_kernel(const float* __restrict__ x, long long t_in,
            const float* __restrict__ u, int nc, int span,
            float* __restrict__ out, int n_out, int l, int m, int h0,
            int s_off, int wc) {
  extern __shared__ float smem[];
  const long long c = blockIdx.y;
  const float* xc = x + c * t_in;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = 32 * R;                       // periods of a warp
  const int per_cta = (kWarps / wc) * per_warp;
  const long long p0 = (long long)blockIdx.x * per_cta;
  const int cls0 = blockIdx.z * wc;
  const int ncls = (cls0 + wc < nc ? cls0 + wc : nc) - cls0;  // this slice
  // Shared memory: the slice's wc classes of U (plus one zero row, read by
  // the last prefetch); the outputs of the tile, a period's ncls * J in a
  // row of `pitch` (odd: a warp's rows fall in distinct banks); the input
  // segment, from the CTA's first run to the end of its last one (plus one
  // float, likewise), all staged by cp.async.
  const int u_len = wc * span * kUCols;
  const int pitch = (wc * J) | 1;
  float* us = smem;
  float* ob = us + u_len + kUCols;
  float* seg = ob + per_cta * pitch;
  const float* uc = u + (long long)cls0 * span * kUCols;
  for (int i = threadIdx.x; i < u_len + kUCols; i += kThreads) {
    const bool ok = i < ncls * span * kUCols;
    cp_async4(us + i, ok ? uc + i : u, ok);
  }
  const long long s0 = run_start((p0 * nc + cls0) * J, l, m, h0, s_off);
  const long long s_end =
      run_start(((p0 + per_cta - 1) * nc + cls0 + ncls - 1) * J, l, m, h0,
                s_off) + span;
  const int seg_len = (int)(s_end - s0);
  for (int s = threadIdx.x; s <= seg_len; s += kThreads) {
    const long long g = s0 + s;
    const bool ok = s < seg_len && g >= 0 && g < t_in;
    cp_async4(seg + s, ok ? xc + g : xc, ok);
  }
  cp_async_wait_all();
  __syncthreads();
  const int k = warp % wc;  // the warp's class in the slice
  if (k < ncls) {
    const int pl = (warp / wc) * per_warp + lane;  // first period, in the CTA
    const float* xs[R];
    float acc[R][J];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xs[r] = seg + (run_start(((p0 + pl + 32 * r) * nc + cls0 + k) * J, l,
                               m, h0, s_off) - s0);
#pragma unroll
      for (int jj = 0; jj < J; ++jj) acc[r][jj] = 0.0f;
    }
    // Step n uses U's row n (two float4, the same for the whole warp) and
    // each run's sample n; both are loaded one step ahead.
    const float4* ut =
        reinterpret_cast<const float4*>(us) + k * span * (kUCols / 4);
    float4 t0 = ut[0], t1 = ut[1];
    float xv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) xv[r] = xs[r][0];
#pragma unroll 2
    for (int n = 0; n < span; ++n) {
      const float tv[kUCols] = {t0.x, t0.y, t0.z, t0.w,
                                t1.x, t1.y, t1.z, t1.w};
      float xn[R];
#pragma unroll
      for (int r = 0; r < R; ++r) xn[r] = xv[r];
      t0 = ut[2 * n + 2];
      t1 = ut[2 * n + 3];
#pragma unroll
      for (int r = 0; r < R; ++r) xv[r] = xs[r][n + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int jj = 0; jj < J; ++jj)
          acc[r][jj] = __fmaf_rn(tv[jj], xn[r], acc[r][jj]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        ob[(pl + 32 * r) * pitch + k * J + jj] = acc[r][jj];
    }
  }
  __syncthreads();
  // A period's ncls * J outputs are contiguous in y (and, with one slice,
  // so are the CTA's): consecutive threads store consecutive outputs.
  const int row = ncls * J;
  float* oc = out + c * n_out;
  for (int e = threadIdx.x; e < per_cta * row; e += kThreads) {
    const int p = e / row, q = e - p * row;
    const long long j = ((p0 + p) * nc + cls0) * J + q;
    if (j < n_out) oc[j] = ob[p * pitch + q];
  }
}

// The former design, kept for the rates whose runs_kernel segment outgrows
// shared memory (L = 1 with M above 32, where a warp's 32 runs already
// span 224 M samples): thread (i, q) of a P = min(L, 256) phase x Q blocks
// tile computes the R outputs (b0 + q + r*Q)*L + i, one shared load per FMA.
template <int R>
__global__ void __launch_bounds__(kThreads)
blocks_kernel(const float* __restrict__ x, long long t_in,
              const float* __restrict__ taps_t,
              const int* __restrict__ offsets, float* __restrict__ out,
              int n_out, int l, int m, int tp, int w, int tau_min, int p,
              int q) {
  extern __shared__ float seg[];
  const long long c = blockIdx.y;
  const float* xc = x + c * t_in;
  const int b0 = blockIdx.x * q * R;
  const int seg_len = (q * R - 1) * m + w;
  const long long start = (long long)b0 * m + tau_min;
  for (int s = threadIdx.x; s < seg_len; s += blockDim.x) {
    const long long g = start + s;
    seg[s] = (g >= 0 && g < t_in) ? __ldg(xc + g) : 0.0f;
  }
  __syncthreads();
  const int i = blockIdx.z * p + threadIdx.x % p;
  if (i >= l) return;
  const int qi = threadIdx.x / p;
  const float* tap = taps_t + i;
  const float* sp = seg + qi * m + __ldg(offsets + i);
  const int stride = q * m;  // shared-memory distance of r and r + 1
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int k = 0; k < tp; ++k) {
    const float tv = __ldg(tap + (long long)k * l);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(tv, sp[r * stride + k], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long j = (long long)(b0 + qi + r * q) * l + i;
    if (j < n_out) out[c * n_out + j] = acc[r];
  }
}

constexpr int kTileK = 32;  // taps of one window per shared tile

__global__ void __launch_bounds__(kThreads)
windows_kernel(const float* __restrict__ x, long long t_in,
               const float* __restrict__ taps_t,
               const int* __restrict__ offsets, float* __restrict__ out,
               int n_out, int l, int m, int tp, int tau_min, int p, int q) {
  __shared__ float tile[kTileK][kThreads + 1];
  __shared__ long long win0[kThreads];  // x index of each thread's tap 0
  const long long c = blockIdx.y;
  const float* xc = x + c * t_in;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.z * p + tid % p;
  const int b = blockIdx.x * q + tid / p;
  const long long j = (long long)b * l + i;
  const bool active = tid < p * q && i < l && j < n_out;
  win0[tid] = active ? (long long)b * m + __ldg(offsets + i) + tau_min
                     : (long long)-1 << 62;
  __syncthreads();
  const float* tap = taps_t + i;
  float acc = 0.0f;
  for (int k0 = 0; k0 < tp; k0 += kTileK) {
    // Warp w fills the columns of threads 32w .. 32w + 31, one window
    // each: all 32 loads are issued before the first store, so their L2
    // latencies overlap.
    float v[32];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const long long g = win0[warp * 32 + jj] + k0 + lane;
      v[jj] = (k0 + lane < tp && g >= 0 && g < t_in) ? __ldg(xc + g) : 0.0f;
    }
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) tile[lane][warp * 32 + jj] = v[jj];
    __syncthreads();
    const int kn = tp - k0 < kTileK ? tp - k0 : kTileK;
    if (active) {
      for (int k = 0; k < kn; ++k)
        acc = __fmaf_rn(__ldg(tap + (long long)(k0 + k) * l), tile[k][tid],
                        acc);
    }
    __syncthreads();
  }
  if (active) out[c * n_out + j] = acc;
}

template <int J, int R>
int launch_runs(const float* x, long long t_in, const float* u, int nc,
                int span, float* out, int channels, int n_out, int l, int m,
                int h0, int s_off, int wc, size_t smem, cudaStream_t st) {
  // Set on every launch: the attribute belongs to the current device, which
  // the wrapper has made the tensors' device.
  const cudaError_t e = cudaFuncSetAttribute(
      runs_kernel<J, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long runs = ((long long)n_out + J - 1) / J;
  const long long periods = (runs + nc - 1) / nc;
  const long long per_cta = (long long)(kWarps / wc) * 32 * R;
  const dim3 grid((unsigned)((periods + per_cta - 1) / per_cta), channels,
                  (nc + wc - 1) / wc);
  runs_kernel<J, R><<<grid, kThreads, smem, st>>>(
      x, t_in, u, nc, span, out, n_out, l, m, h0, s_off, wc);
  return (int)cudaGetLastError();
}

template <int J>
int launch_r(int r, const float* x, long long t_in, const float* u, int nc,
             int span, float* out, int channels, int n_out, int l, int m,
             int h0, int s_off, int wc, size_t smem, cudaStream_t st) {
  switch (r) {
    case 8: return launch_runs<J, 8>(x, t_in, u, nc, span, out, channels,
                                     n_out, l, m, h0, s_off, wc, smem, st);
    case 4: return launch_runs<J, 4>(x, t_in, u, nc, span, out, channels,
                                     n_out, l, m, h0, s_off, wc, smem, st);
    case 2: return launch_runs<J, 2>(x, t_in, u, nc, span, out, channels,
                                     n_out, l, m, h0, s_off, wc, smem, st);
    default: return launch_runs<J, 1>(x, t_in, u, nc, span, out, channels,
                                      n_out, l, m, h0, s_off, wc, smem, st);
  }
}

template <int R>
int launch_blocks(const float* x, long long t_in, const float* taps_t,
                  const int* offsets, float* out, int channels, int n_out,
                  int l, int m, int tp, int w, int tau_min, size_t smem,
                  cudaStream_t st) {
  const int p = l < kThreads ? l : kThreads;
  const int q = kThreads / p;
  const cudaError_t e = cudaFuncSetAttribute(
      blocks_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)n_out + l - 1) / l;
  dim3 grid((unsigned)((blocks + (long long)q * R - 1) / ((long long)q * R)),
            channels, (l + p - 1) / p);
  blocks_kernel<R><<<grid, p * q, smem, st>>>(
      x, t_in, taps_t, offsets, out, n_out, l, m, tp, w, tau_min, p, q);
  return (int)cudaGetLastError();
}

}  // namespace

// The host picks the kernel and its tile (resample/kernel.py `geometry`):
//  - j = 7 or 8: runs_kernel with R = r runs a thread, wc classes a CTA, U
//    [nc, span, 8] f32, and seg_floats the longest segment of a CTA;
//  - j = 0, r > 0: blocks_kernel with R = r, seg_floats = (Q*r - 1)*M + W;
//  - r = 0: the unstaged windows_kernel.
// blocks_kernel and windows_kernel read taps_t [tp, L] and offsets [L].
// A seg_floats below what the tile stages (runs_segment, blocks_segment of
// kernel.py) is refused: the kernel would write past its shared memory.
extern "C" int crlot_resample(const float* x, long long t_in, const float* u,
                              int nc, int span, const float* taps_t,
                              const int* offsets, float* out, int channels,
                              int n_out, int l, int m, int tp, int w,
                              int tau_min, int h0, int j, int r, int wc,
                              long long seg_floats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (channels < 1 || channels > 65535 || n_out < 1 || l < 1 || m < 1 ||
      tp < 1)
    return (int)cudaErrorInvalidValue;
  if (j == 0 && r > 0) {
    const long long smem = seg_floats * (long long)sizeof(float);
    const long long q = kThreads / (l < kThreads ? l : kThreads);
    if (seg_floats < (q * r - 1) * m + w || smem > kMaxSharedBytes)
      return (int)cudaErrorInvalidValue;
    switch (r) {
      case 8: return launch_blocks<8>(x, t_in, taps_t, offsets, out, channels,
                                      n_out, l, m, tp, w, tau_min, smem, st);
      case 4: return launch_blocks<4>(x, t_in, taps_t, offsets, out, channels,
                                      n_out, l, m, tp, w, tau_min, smem, st);
      case 2: return launch_blocks<2>(x, t_in, taps_t, offsets, out, channels,
                                      n_out, l, m, tp, w, tau_min, smem, st);
      case 1: return launch_blocks<1>(x, t_in, taps_t, offsets, out, channels,
                                      n_out, l, m, tp, w, tau_min, smem, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (r == 0) {
    const int p = l < kThreads ? l : kThreads;
    const int q = kThreads / p;
    const long long blocks = ((long long)n_out + l - 1) / l;
    dim3 grid((unsigned)((blocks + q - 1) / q), channels, (l + p - 1) / p);
    windows_kernel<<<grid, kThreads, 0, st>>>(x, t_in, taps_t, offsets, out,
                                              n_out, l, m, tp, tau_min, p, q);
    return (int)cudaGetLastError();
  }
  const long long smem = seg_floats * (long long)sizeof(float);
  if ((j != 7 && j != 8) || (r != 1 && r != 2 && r != 4 && r != 8) ||
      (wc != 1 && wc != 2 && wc != 4 && wc != 8) || nc < 1 || nc > 65535 ||
      span < tp || smem > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  // U's slice and zero row, the output rows, the input segment of the
  // CTA's runs (its last run at most ceil(runs * J * M / L) samples on)
  // plus span, and the last prefetch's float.
  const long long per_cta = (long long)(kWarps / wc) * 32 * r;
  const long long runs = (per_cta - 1) * nc + wc - 1;
  if (seg_floats < ((long long)wc * span + 1) * kUCols +
                       per_cta * ((wc * j) | 1) + (runs * j * m + l - 1) / l +
                       span + 1)
    return (int)cudaErrorInvalidValue;
  const int s_off = -(tp - 1);
  if (j == 8)
    return launch_r<8>(r, x, t_in, u, nc, span, out, channels, n_out, l, m,
                       h0, s_off, wc, (size_t)smem, st);
  return launch_r<7>(r, x, t_in, u, nc, span, out, channels, n_out, l, m, h0,
                     s_off, wc, (size_t)smem, st);
}
