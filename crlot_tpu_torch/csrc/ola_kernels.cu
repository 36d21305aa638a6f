// B5: the OLA SIMD tier -- axpy, axpy_windowed and normalize_and_clear.
//
// Replaces the Pallas kernels of crlot_tpu/ola/kernels.py:
//   _axpy_kernel           out = dst + src*gain
//   _axpy_windowed_kernel  out = dst + (src*win)*gain
//   _normalize_kernel      out = acc / max(norm, eps), cleared = 0
//
// What bounds them on an H100: memory. Each element costs one or two
// flops against 12 to 16 bytes of traffic, far below the card's balance,
// so the only aim is to stream every byte once at full width: one 16-byte
// float4 access per thread (when every pointer is 16-byte aligned), and the
// first threads take one element each of the scalar tail. A grid of one
// thread per float4 keeps the most loads in flight (a grid capped at 16
// CTAs per SM, looping over the rest, reached 37 % of HBM bandwidth). This
// replaces the TPU kernels' pad to (8, 128) tiles and reshape: nothing is
// padded or copied.
//
// Numerics: the multiply-add is one fused multiply-add with a single
// rounding, fma(src, gain, dst) and fma(src*win, gain, dst), written as
// explicit round-to-nearest intrinsics so nothing is left to the compiler's
// contraction: that is what XLA computes for the reference's jnp oracles
// (it contracts dst + src*gain) and what the reference's Highway MulAdd
// does; the two-rounding form would differ by thousands of ULP where the
// terms cancel. The results are bit for bit those of the plain versions.
// fmaxf(NaN, eps) returns eps while jnp.maximum and torch.clamp_min return
// NaN, so the normalize kernel passes a NaN of norm (or of eps) through to
// the divide as they do.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Axpy {
  float gain;
  __device__ float operator()(float d, float s) const {
    return __fmaf_rn(s, gain, d);
  }
};

struct AxpyWindowed {
  float gain;
  __device__ float operator()(float d, float s, float w) const {
    return __fmaf_rn(__fmul_rn(s, w), gain, d);
  }
};

struct Normalize {
  float eps;
  __device__ float operator()(float a, float n) const {
    float den = fmaxf(n, eps);
    if (n != n) den = n;
    if (eps != eps) den = eps;
    return __fdiv_rn(a, den);
  }
};

__device__ __forceinline__ long long thread_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void axpy_kernel(const float* __restrict__ dst,
                            const float* __restrict__ src, Axpy op,
                            float* __restrict__ out, long long n,
                            long long n_vec) {
  const float4* d4 = reinterpret_cast<const float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long v = thread_index(), e = 4 * n_vec + v;
  if (v < n_vec) {
    const float4 d = __ldg(d4 + v), s = __ldg(s4 + v);
    o4[v] = make_float4(op(d.x, s.x), op(d.y, s.y), op(d.z, s.z),
                        op(d.w, s.w));
  }
  if (e < n) out[e] = op(__ldg(dst + e), __ldg(src + e));
}

__global__ void axpy_windowed_kernel(const float* __restrict__ dst,
                                     const float* __restrict__ src,
                                     const float* __restrict__ win,
                                     AxpyWindowed op, float* __restrict__ out,
                                     long long n, long long n_vec) {
  const float4* d4 = reinterpret_cast<const float4*>(dst);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  const float4* w4 = reinterpret_cast<const float4*>(win);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long v = thread_index(), e = 4 * n_vec + v;
  if (v < n_vec) {
    const float4 d = __ldg(d4 + v), s = __ldg(s4 + v), w = __ldg(w4 + v);
    o4[v] = make_float4(op(d.x, s.x, w.x), op(d.y, s.y, w.y),
                        op(d.z, s.z, w.z), op(d.w, s.w, w.w));
  }
  if (e < n) out[e] = op(__ldg(dst + e), __ldg(src + e), __ldg(win + e));
}

__global__ void normalize_kernel(const float* __restrict__ acc,
                                 const float* __restrict__ norm, Normalize op,
                                 float* __restrict__ out,
                                 float* __restrict__ cleared, long long n,
                                 long long n_vec) {
  const float4* a4 = reinterpret_cast<const float4*>(acc);
  const float4* n4 = reinterpret_cast<const float4*>(norm);
  float4* o4 = reinterpret_cast<float4*>(out);
  float4* c4 = reinterpret_cast<float4*>(cleared);
  const long long v = thread_index(), e = 4 * n_vec + v;
  if (v < n_vec) {
    const float4 a = __ldg(a4 + v), nv = __ldg(n4 + v);
    o4[v] = make_float4(op(a.x, nv.x), op(a.y, nv.y), op(a.z, nv.z),
                        op(a.w, nv.w));
    c4[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (e < n) {
    out[e] = op(__ldg(acc + e), __ldg(norm + e));
    cleared[e] = 0.0f;
  }
}

// float4 groups when every pointer is 16-byte aligned, else none.
long long vector_count(long long n, const void* a, const void* b,
                       const void* c, const void* d) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c |
                         (uintptr_t)d;
  return (bits & 15) == 0 ? n / 4 : 0;
}

// One thread per float4, or per element of the tail where that is more.
// Zero when the grid would pass CUDA's 2^31 - 1 blocks (n > 2^41).
long long block_count(long long n, long long n_vec) {
  const long long tail = n - 4 * n_vec;
  const long long work = n_vec > tail ? n_vec : tail;
  const long long blocks = (work + kThreads - 1) / kThreads;
  return blocks <= 0 ? 1 : (blocks <= 0x7fffffffLL ? blocks : 0);
}

}  // namespace

extern "C" int crlot_axpy(const float* dst, const float* src, float gain,
                          float* out, long long n, void* stream) {
  const long long n_vec = vector_count(n, dst, src, out, out);
  const long long blocks = block_count(n, n_vec);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  axpy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      dst, src, Axpy{gain}, out, n, n_vec);
  return (int)cudaGetLastError();
}

extern "C" int crlot_axpy_windowed(const float* dst, const float* src,
                                   const float* win, float gain, float* out,
                                   long long n, void* stream) {
  const long long n_vec = vector_count(n, dst, src, win, out);
  const long long blocks = block_count(n, n_vec);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  axpy_windowed_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(dst, src, win,
                                                 AxpyWindowed{gain}, out, n,
                                                 n_vec);
  return (int)cudaGetLastError();
}

extern "C" int crlot_normalize_and_clear(const float* acc, const float* norm,
                                         float eps, float* out,
                                         float* cleared, long long n,
                                         void* stream) {
  const long long n_vec = vector_count(n, acc, norm, out, cleared);
  const long long blocks = block_count(n, n_vec);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  normalize_kernel<<<(unsigned)blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(acc, norm, Normalize{eps}, out,
                                             cleared, n, n_vec);
  return (int)cudaGetLastError();
}
