// B4: polyphase L/M FIR resampler, all channels in one launch.
//
// Replaces the Pallas kernel crlot_tpu/resample/pallas_kernel.py::_resample_kernel
// (with resample_pallas's left pad of -tau_min):
//
//   y[c, b*L + i] = sum_{k<tp} taps_t[k, i] * x[c, b*M + offsets[i] + k + tau_min]
//
// with x read as 0 outside [0, T). taps_t is the compact form of the dense
// [L, W] bank (row i's nonzero taps are one contiguous run of tp entries
// starting at column offsets[i]); the entries it skips are exactly 0.0.
//
// What bounds it on an H100: at 2 x 60 s, 44.1 -> 48 kHz it does 5.76 M
// outputs x 157 taps (about 1.8 GFLOP of useful fp32 work) while reading
// 21 MB and writing 23 MB, about 40 FLOP per byte: above the card's fp32
// balance (67 TFLOP/s over 3.35 TB/s, about 20), so the throughput of the
// multiply-adds and of the loads feeding them bounds it, not HBM. The
// design therefore keeps every operand on chip and loads each as few times
// as it can:
//  - a CTA stages the input segment of its output tile in shared memory
//    with bounded (zero-filling) coalesced loads, so no padded copy of x is
//    ever made;
//  - the tile is P = min(L, 256) phases x Q*R blocks (Q = 256/P); thread
//    (i, q) computes the R outputs (b0 + q + r*Q)*L + i, r < R, which share
//    phase i and therefore every tap: one tap load (read-only cache, [tp, L]
//    layout, so a warp's phases read neighbouring addresses) feeds R FMAs,
//    and each FMA reads one float from shared memory;
//  - the compact table halves the MACs and the tap bytes against the dense
//    bank. Neither the dense bank (189 KB at 44.1 -> 48 kHz, 543 KB at
//    44.1 -> 16 kHz) nor the TPU's grid of TB = 8 blocks carries over: at
//    L = 1 (48 -> 16 kHz) a CTA takes 256 x R blocks and neighbouring
//    threads read windows M = 3 floats apart, an odd stride without bank
//    conflicts. R is the largest of 8, 4, 2, 1 whose segment fits in
//    shared memory.
//
// Where no segment fits in shared memory, even at R = 1 (integer
// decimation by M above 141, e.g. 48 kHz -> 300 Hz: M = 160, W = 25 k
// taps), `windows_kernel` takes over: the segment is not staged; each
// thread owns one output and reads its own window of x from L2 in tiles of
// 32 taps, which the CTA loads cooperatively (one warp load = 32
// consecutive samples of one window, coalesced) and transposes through
// shared memory, so each thread then reads its 32 samples without bank
// conflicts. (Read straight from global memory, the windows of a warp's
// outputs lie M floats apart: every load touched 32 cache lines.)
//
// Numerics: each output is one fp32 FMA chain in ascending k (ascending w),
// starting from 0.0f, in an order that does not depend on where the output
// sits in its tile or on R. Chunked and one-shot resampling therefore agree
// bit for bit (every kept chunk output sums the same products: the chunk
// starts are multiples of M).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxSharedBytes = 232448;  // 227 KB per CTA on sm_90

template <int R>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ x, long long t_in,
                const float* __restrict__ taps_t,
                const int* __restrict__ offsets, float* __restrict__ out,
                int n_out, int l, int m, int tp, int w, int tau_min, int p,
                int q) {
  extern __shared__ float seg[];
  const long long c = blockIdx.y;
  const float* xc = x + c * t_in;
  const int b0 = blockIdx.x * q * R;
  const int seg_len = (q * R - 1) * m + w;
  // x_pad[b0*M + s] = x[b0*M + s + tau_min], zero outside the signal.
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

template <int R>
int launch(const float* x, long long t_in, const float* taps_t,
           const int* offsets, float* out, int channels, int n_out, int l,
           int m, int tp, int w, int tau_min, int p, int q, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = ((long long)n_out + l - 1) / l;
  dim3 grid((unsigned)((blocks + (long long)q * R - 1) / ((long long)q * R)),
            channels, (l + p - 1) / p);
  resample_kernel<R><<<grid, p * q, smem, stream>>>(
      x, t_in, taps_t, offsets, out, n_out, l, m, tp, w, tau_min, p, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crlot_resample(const float* x, long long t_in,
                              const float* taps_t, const int* offsets,
                              float* out, int channels, int n_out, int l,
                              int m, int tp, int w, int tau_min,
                              void* stream) {
  const int p = l < kThreads ? l : kThreads;
  const int q = kThreads / p;
  cudaStream_t st = (cudaStream_t)stream;
  for (int r = 8; r >= 1; r /= 2) {
    const long long smem = (((long long)q * r - 1) * m + w) * sizeof(float);
    if (smem > kMaxSharedBytes) continue;
    const size_t bytes = (size_t)smem;
    switch (r) {
      case 8: return launch<8>(x, t_in, taps_t, offsets, out, channels,
                               n_out, l, m, tp, w, tau_min, p, q, bytes, st);
      case 4: return launch<4>(x, t_in, taps_t, offsets, out, channels,
                               n_out, l, m, tp, w, tau_min, p, q, bytes, st);
      case 2: return launch<2>(x, t_in, taps_t, offsets, out, channels,
                               n_out, l, m, tp, w, tau_min, p, q, bytes, st);
      default: return launch<1>(x, t_in, taps_t, offsets, out, channels,
                                n_out, l, m, tp, w, tau_min, p, q, bytes, st);
    }
  }
  // No segment fits in shared memory: each thread reads its own window.
  const long long blocks = ((long long)n_out + l - 1) / l;
  dim3 grid((unsigned)((blocks + q - 1) / q), channels, (l + p - 1) / p);
  windows_kernel<<<grid, kThreads, 0, st>>>(x, t_in, taps_t, offsets, out,
                                            n_out, l, m, tp, tau_min, p, q);
  return (int)cudaGetLastError();
}
