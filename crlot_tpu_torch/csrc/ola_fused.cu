// B1: fused overlap-add + COLA normalize, one pass over device memory.
//
// Replaces the Pallas kernel crlot_tpu/ola/fused.py::_fused_kernel.
//
//   out[b, t] = (sum_{r=R-1..0} frames[b, t/H - r, r*H + t%H]) / max(norm[t], eps)
//
// with frames outside [0, F) and samples past N counting as absent.
//
// What bounds it on an H100: memory. Each output sample reads R frame values
// and one norm value and writes one result, with R adds and one divide: far
// below the card's ops-per-byte balance (at the main path's [2, 11251,
// 1024] frames, 127 MB: 0.0378 ms at 3.35 TB/s). So the design keeps as
// many bytes in flight as the memory system needs, and does little else:
//  - a thread takes V = 4 consecutive samples of one hop block, with
//    16-byte loads of each frame's 4 values and of the norm, and a 16-byte
//    store (where H, N, the output length and the pointers are multiples of
//    16 bytes; else V = 1, the same sums one sample a thread);
//  - R = ceil(N/H) is a compile-time trip count for the common R (2, 3, 4,
//    8), so the R loads of a thread are all issued before the first add;
//  - no integer divide: a CTA's threadIdx.y picks its hop block, threadIdx.x
//    the samples in it (a loop where H/V exceeds the CTA's width).
// Consecutive threads read consecutive 16-byte words of each frame, so a
// warp's loads are whole 128-byte lines, and the frames are never
// re-laid-out. The batch is the grid's y axis: [B, F, N] frames run in one
// launch.
//
// Numerics: the R terms are added in ascending frame order starting from
// 0.0f, then divided with IEEE division (no fast math) -- the same sequence
// of roundings as ola/reference.py's overlap_add + normalize, so the result
// is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int V> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane(const float& v, int) { return v; }

// R > 0: the compile-time trip count; R == 0: r_rt at run time.
template <int V, int R>
__global__ void __launch_bounds__(kThreads)
ola_normalized_kernel(const float* __restrict__ frames,
                      const float* __restrict__ norm,
                      float* __restrict__ out, int n_frames, int nfft,
                      int hop, int out_len, int n_blocks, float eps,
                      int r_rt) {
  using T = typename Vec<V>::T;
  const int blk = blockIdx.x * blockDim.y + threadIdx.y;
  if (blk >= n_blocks) return;
  const long long b = blockIdx.y;
  const float* fb = frames + b * (long long)n_frames * nfft;
  float* ob = out + b * (long long)out_len;
  const int r_count = R > 0 ? R : r_rt;
  for (int s = threadIdx.x * V; s < hop; s += blockDim.x * V) {
    const int t = blk * hop + s;
    if (t >= out_len) return;
    T v[R > 0 ? R : 1];
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    if constexpr (R > 0) {
      // Every load first (a sample past N reads as 0.0f, which the plain
      // version adds too), then the adds in ascending frame order.
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const int f = blk - r, n = r * hop + s;
        v[r] = f >= 0 && f < n_frames && n < nfft
                   ? __ldg(reinterpret_cast<const T*>(
                         fb + (long long)f * nfft + n))
                   : Vec<V>::zero();
      }
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        const int f = blk - r;
        if (f < 0 || f >= n_frames) continue;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += lane(v[r], i);
      }
    } else {
      for (int r = r_count - 1; r >= 0; --r) {
        const int f = blk - r, n = r * hop + s;
        if (f < 0 || f >= n_frames) continue;
        if (n < nfft) {
          const T w =
              __ldg(reinterpret_cast<const T*>(fb + (long long)f * nfft + n));
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += lane(w, i);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] += 0.0f;
        }
      }
    }
    const T nv = __ldg(reinterpret_cast<const T*>(norm + t));
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(ob + t) = make_float4(
          acc[0] / fmaxf(nv.x, eps), acc[1] / fmaxf(nv.y, eps),
          acc[2] / fmaxf(nv.z, eps), acc[3] / fmaxf(nv.w, eps));
    } else {
      ob[t] = acc[0] / fmaxf(nv, eps);
    }
  }
}

template <int V>
int launch(const float* frames, const float* norm, float* out, int batch,
           int n_frames, int nfft, int hop, int out_len, float eps,
           cudaStream_t st) {
  const int n_blocks = (out_len + hop - 1) / hop;
  const int per_block = (hop + V - 1) / V;  // threads a hop block needs
  int tx = 32;
  while (tx < per_block && tx < kThreads) tx *= 2;
  const dim3 threads(tx, kThreads / tx);
  const dim3 grid((n_blocks + threads.y - 1) / threads.y, batch);
  const int r = (nfft + hop - 1) / hop;
#define B1_LAUNCH(R)                                                         \
  ola_normalized_kernel<V, R><<<grid, threads, 0, st>>>(                     \
      frames, norm, out, n_frames, nfft, hop, out_len, n_blocks, eps, r)
  switch (r) {
    case 2: B1_LAUNCH(2); break;
    case 3: B1_LAUNCH(3); break;
    case 4: B1_LAUNCH(4); break;
    case 8: B1_LAUNCH(8); break;
    default: B1_LAUNCH(0); break;
  }
#undef B1_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// frames [batch, n_frames, nfft], norm [>= out_len], out [batch, out_len],
// all f32 and contiguous. The 16-byte path needs hop, nfft and out_len
// multiples of 4 and the three pointers 16-byte aligned.
extern "C" int crlot_ola_normalized(const float* frames, const float* norm,
                                    float* out, int batch, int n_frames,
                                    int nfft, int hop, int out_len, float eps,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || n_frames < 0 || nfft < 1 || hop < 1 ||
      out_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = hop % 4 == 0 && nfft % 4 == 0 && out_len % 4 == 0 &&
                    ((uintptr_t)frames | (uintptr_t)norm | (uintptr_t)out) %
                            16 == 0;
  return wide ? launch<4>(frames, norm, out, batch, n_frames, nfft, hop,
                          out_len, eps, st)
              : launch<1>(frames, norm, out, batch, n_frames, nfft, hop,
                          out_len, eps, st);
}

extern "C" const char* crlot_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
