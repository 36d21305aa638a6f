// B2: fused nonlinear STFT round-trip + overlap-add + COLA normalize.
// B3: the same round-trip without the OLA: [F, N] round-trip frames.
//
// B2 replaces the Pallas kernel crlot_tpu/fft/pallas_rt.py::_rt_ola_kernel,
// B3 replaces pallas_rt.py::_rt_kernel. Both run stages 1-3 below through
// one device function (rt_frames_to_planes); they differ in which frames a
// CTA owns and in stage 4.
//
// B2: each CTA owns TB = NF - (R-1) output hop-blocks of one channel and
// computes the NF = 32 frames that touch them (R-1 of them are boundary
// frames its neighbour recomputes too). Frames outside [0, n_frames) are
// zero before the products, so phantom frames add nothing. Per CTA:
//
//   1. fold:    e[n][f] = y[n] + y[N-n], o[n][f] = y[n] - y[N-n], y = x * w
//   2. forward: Re = e @ C, Im = o @ S       (half-size DFT bases, K = N/2+1)
//               then the epilogue menu on (Re, Im), per bin
//   3. inverse: A = Re @ Cinv, B = Im @ Sinv
//   4. unfold + OLA + normalize: frame sample n is A[n] + B[n] (n <= N/2)
//      or A[N-n] - B[N-n]; each output sample sums its R frames in
//      ascending frame order and divides by max(norm, eps).
//
// B3: each CTA owns NF = 32 consecutive frames of one channel and
// recomputes nothing (a frame needs no neighbour). Its stage 4 unfolds
// each frame with the same rounded steps as B2 and stores it as one
// coalesced row of N floats, so B3 followed by the plain OLA can match B2
// bit for bit. Its signal reads at or past the row length return 0.0 (the
// zero padding the Pallas caller applies), since a sharded caller passes
// exactly the samples its frames span. B3 does B2's useful FMAs without
// B2's (R-1)/TB recompute and writes F * N * 4 bytes (92 MB at 2 x 60 s,
// ~0.03 ms at 3.35 TB/s), so it is FMA-bound like B2.
//
// What bounds both on an H100: fp32 FMA issue. Each frame costs
// 4 * K^2 ~ 1.05 M multiply-adds at N = 1024 against 4 KB of signal in and
// 1 KB out, far above the memory roofline. The design keeps every
// intermediate in shared memory and register-tiles the four products like
// an SGEMM: each thread owns an 8-frame x 8-bin tile (64 accumulators), so
// one contraction step is two 16-byte shared loads (8 frames) and two
// 16-byte loads of a basis row (8 bins, from L2: the four bases are ~4.2 MB)
// feeding 64 FMAs. The bases are zero-padded on the host to Kp = 8*ceil(K/8)
// columns, so every basis row is 16-byte aligned and the tiles need no
// bounds checks; Sinv is shifted so that B's column j is sample j. With one
// 288-thread CTA per SM (shared memory) only 9 warps hide the L2 latency of
// the basis loads, so the contraction loop is unrolled 16 deep to let them
// issue well ahead (measured on the H100: unroll 2 / 8 / 16 / 32 gave
// 2.78 / 2.08 / 2.00 / 2.20 ms for 2 x 60 s, PERF.md).
// Shared memory holds three [Kp x NF] planes (3 * 520 * 32 * 4 B = 195 KB
// at N = 1024, above the 48 KB default, hence cudaFuncSetAttribute):
//   plane0: e  -> A (frame-major)
//   plane1: o  -> Im after the epilogue
//   plane2: Re -> Re after the epilogue -> B (frame-major)
// Not carried over from the TPU kernel: the 3-pass bf16 emulation of fp32
// (products here are fp32 FMA), lane reversal by exchange-matrix products
// (reversal is indexing here), and the per-channel Python loop (channels are
// the grid's y axis). Tensor cores (wgmma / TMA) are later work.
//
// The epilogue replaces the Pallas kernel's traced jaxpr with a fixed menu
// of per-bin ops read from a small descriptor (see spectral.py): elementwise
// steps use explicitly rounded intrinsics so nvcc does not contract them
// into FMAs, matching the plain torch ops step by step.

#include <cuda_runtime.h>

namespace {

constexpr int NF = 32;            // frames per CTA
constexpr int TF = 8;             // frames per thread tile
constexpr int TBIN = 8;           // bins per thread tile
constexpr int MAX_THREADS = 288;  // 32 * ceil(4 * 65 / 32): Kp = 520

enum { OP_GAIN = 1, OP_REAL_GAINS = 2, OP_COMPLEX = 3, OP_GATE = 4,
       OP_SUBTRACT = 5 };

typedef float Tile[TBIN][TF];

__device__ __forceinline__ void scale(float& re, float& im, float s) {
  re = __fmul_rn(re, s);
  im = __fmul_rn(im, s);
}

__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// The menu on one thread's tile; bins >= K (padding) are left alone.
__device__ __forceinline__ void apply_epilogue(
    Tile& re, Tile& im, int j0, int K, const int* __restrict__ desc,
    int n_ops, const float* __restrict__ params) {
  for (int i = 0; i < n_ops; ++i) {
    const int code = desc[2 * i];
    const float* p = params + desc[2 * i + 1];
#pragma unroll
    for (int b = 0; b < TBIN; ++b) {
      const int k = j0 + b;
      if (k >= K) continue;
      if (code == OP_GAIN || code == OP_REAL_GAINS) {
        const float g = code == OP_GAIN ? p[0] : p[k];
#pragma unroll
        for (int f = 0; f < TF; ++f) scale(re[b][f], im[b][f], g);
      } else if (code == OP_COMPLEX) {
        const float hr = p[k], hi = p[K + k];
#pragma unroll
        for (int f = 0; f < TF; ++f) {
          const float r = re[b][f], m = im[b][f];
          re[b][f] = __fsub_rn(__fmul_rn(r, hr), __fmul_rn(m, hi));
          im[b][f] = __fadd_rn(__fmul_rn(r, hi), __fmul_rn(m, hr));
        }
      } else if (code == OP_GATE) {
        const float thresh = p[0], att = p[1];
#pragma unroll
        for (int f = 0; f < TF; ++f)
          scale(re[b][f], im[b][f],
                power(re[b][f], im[b][f]) >= thresh ? 1.0f : att);
      } else if (code == OP_SUBTRACT) {
        const float floor_ = p[1], sub = __fmul_rn(p[0], p[2 + k]);
#pragma unroll
        for (int f = 0; f < TF; ++f) {
          const float mag = __fsqrt_rn(power(re[b][f], im[b][f]));
          const float nw = fmaxf(__fsub_rn(mag, sub), __fmul_rn(floor_, mag));
          scale(re[b][f], im[b][f],
                mag > 0.0f ? __fdiv_rn(nw, fmaxf(mag, 1e-20f)) : 0.0f);
        }
      }
    }
  }
}

// acc[b][f] = sum_{k in [k0, k1)} plane[k][f0 + f] * basis[k - shift][j0 + b]
// with plane k-major (row stride NF) and basis row stride kp, ascending k.
__device__ __forceinline__ void tile_product(
    Tile& acc, const float* __restrict__ plane, int f0,
    const float* __restrict__ basis, int kp, int j0, int k0, int k1,
    int shift) {
#pragma unroll
  for (int b = 0; b < TBIN; ++b)
#pragma unroll
    for (int f = 0; f < TF; ++f) acc[b][f] = 0.0f;
#pragma unroll 16
  for (int k = k0; k < k1; ++k) {
    const float4* pr = reinterpret_cast<const float4*>(plane + k * NF + f0);
    const float4* br = reinterpret_cast<const float4*>(
        basis + (long long)(k - shift) * kp + j0);
    const float4 p0 = pr[0], p1 = pr[1];
    const float4 b0 = __ldg(br), b1 = __ldg(br + 1);
    const float pv[TF] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float bv[TBIN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int b = 0; b < TBIN; ++b)
#pragma unroll
      for (int f = 0; f < TF; ++f) acc[b][f] = fmaf(pv[f], bv[b], acc[b][f]);
  }
}

// Store a tile k-major (row = bin, NF frames per row).
__device__ __forceinline__ void store_bin_major(float* plane, const Tile& t,
                                                int j0, int f0) {
#pragma unroll
  for (int b = 0; b < TBIN; ++b) {
    float4* r = reinterpret_cast<float4*>(plane + (j0 + b) * NF + f0);
    r[0] = make_float4(t[b][0], t[b][1], t[b][2], t[b][3]);
    r[1] = make_float4(t[b][4], t[b][5], t[b][6], t[b][7]);
  }
}

__device__ __forceinline__ void load_bin_major(Tile& t, const float* plane,
                                               int j0, int f0) {
#pragma unroll
  for (int b = 0; b < TBIN; ++b) {
    const float4* r = reinterpret_cast<const float4*>(plane + (j0 + b) * NF + f0);
    const float4 a = r[0], c = r[1];
    t[b][0] = a.x; t[b][1] = a.y; t[b][2] = a.z; t[b][3] = a.w;
    t[b][4] = c.x; t[b][5] = c.y; t[b][6] = c.z; t[b][7] = c.w;
  }
}

// Store a tile frame-major (row = frame, kp bins per row).
__device__ __forceinline__ void store_frame_major(float* plane, const Tile& t,
                                                  int kp, int j0, int f0) {
#pragma unroll
  for (int f = 0; f < TF; ++f) {
    float4* r = reinterpret_cast<float4*>(plane + (f0 + f) * kp + j0);
    r[0] = make_float4(t[0][f], t[1][f], t[2][f], t[3][f]);
    r[1] = make_float4(t[4][f], t[5][f], t[6][f], t[7][f]);
  }
}

// Stages 1-3 for the NF frames fbase .. fbase+NF-1 of one channel `x`:
// on return plane0 holds A and plane2 holds B, both frame-major (row =
// local frame, kp columns). Frames outside [0, n_frames) are zero before
// the products. With kBounded, samples at or past `lp` read as 0.0 (the
// zero padding of a signal shorter than its frames' span).
template <bool kBounded>
__device__ __forceinline__ void rt_frames_to_planes(
    const float* __restrict__ x, long long lp,
    const float* __restrict__ window,
    const float* __restrict__ cb, const float* __restrict__ sb,
    const float* __restrict__ cinv, const float* __restrict__ sinv,
    const int* __restrict__ desc, int n_ops,
    const float* __restrict__ params,
    float* plane0, float* plane1, float* plane2,
    int fbase, int nfft, int hop, int n_frames) {
  const int h = nfft / 2, K = h + 1;
  const int kp = (K + TBIN - 1) / TBIN * TBIN;
  const int tid = threadIdx.x;

  // 1. Fold, k-major (lane = local frame); rows 0 and h of o are zero.
  {
    const int lane = tid & 31, n_warps = blockDim.x >> 5;
    const int fa = fbase + lane;
    const bool valid = fa >= 0 && fa < n_frames;
    const long long start = (long long)(valid ? fa : 0) * hop;
    const float* xf = x + start;
    auto sample = [&](int n) -> float {
      return !kBounded || start + n < lp ? xf[n] : 0.0f;
    };
    for (int n = tid >> 5; n <= h; n += n_warps) {
      float e = 0.0f, o = 0.0f;
      if (valid) {
        if (n == 0 || n == h) {
          e = __fmul_rn(sample(n), window[n]);
        } else {
          const float a = __fmul_rn(sample(n), window[n]);
          const float b = __fmul_rn(sample(nfft - n), window[nfft - n]);
          e = __fadd_rn(a, b);
          o = __fsub_rn(a, b);
        }
      }
      plane0[n * NF + lane] = e;
      plane1[n * NF + lane] = o;
    }
  }
  __syncthreads();

  // Thread tile: frames f0..f0+7, bins j0..j0+7.
  const int f0 = (tid & 3) * TF, j0 = (tid >> 2) * TBIN;
  const bool active = j0 < kp;
  Tile t0, t1;

  // 2. Forward products and the epilogue.
  if (active) {
    tile_product(t0, plane0, f0, cb, kp, j0, 0, h + 1, 0);      // Re
    store_bin_major(plane2, t0, j0, f0);
    tile_product(t1, plane1, f0, sb, kp, j0, 1, h, 1);          // Im
    load_bin_major(t0, plane2, j0, f0);
    apply_epilogue(t0, t1, j0, K, desc, n_ops, params);
    store_bin_major(plane2, t0, j0, f0);
  }
  __syncthreads();  // every thread is done reading o
  if (active) store_bin_major(plane1, t1, j0, f0);
  __syncthreads();

  // 3. Inverse products: A into plane0 (e is dead), then B into plane2
  //    once every thread is done reading Re from it.
  if (active) {
    tile_product(t0, plane2, f0, cinv, kp, j0, 0, K, 0);
    store_frame_major(plane0, t0, kp, j0, f0);
    tile_product(t1, plane1, f0, sinv, kp, j0, 0, K, 0);
  }
  __syncthreads();
  if (active) store_frame_major(plane2, t1, kp, j0, f0);
  __syncthreads();
}

// Sample n of local frame lf: A[n] + B[n] (n <= N/2) or A[N-n] - B[N-n].
__device__ __forceinline__ float unfold(const float* plane0,
                                        const float* plane2, int lf, int kp,
                                        int n, int nfft) {
  const int h = nfft / 2;
  return n <= h
      ? __fadd_rn(plane0[lf * kp + n], plane2[lf * kp + n])
      : __fsub_rn(plane0[lf * kp + nfft - n], plane2[lf * kp + nfft - n]);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
rt_ola_kernel(const float* __restrict__ padded, long long lp,
              const float* __restrict__ window,
              const float* __restrict__ cb,    // C    [h+1, Kp]
              const float* __restrict__ sb,    // S    [h-1, Kp]
              const float* __restrict__ cinv,  // Cinv [K, Kp]
              const float* __restrict__ sinv,  // Sinv [K, Kp], column j = sample j
              const float* __restrict__ norm,
              const int* __restrict__ desc, int n_ops,
              const float* __restrict__ params,
              float* __restrict__ out,
              int nfft, int hop, int n_frames, int out_len, float eps) {
  extern __shared__ float4 smem4[];
  const int K = nfft / 2 + 1, r_count = nfft / hop;
  const int kp = (K + TBIN - 1) / TBIN * TBIN;
  const int tb = NF - (r_count - 1);
  float* plane0 = reinterpret_cast<float*>(smem4);
  float* plane1 = plane0 + kp * NF;
  float* plane2 = plane1 + kp * NF;
  const int fbase = blockIdx.x * tb - (r_count - 1);  // frame of local 0
  rt_frames_to_planes<false>(
      padded + (long long)blockIdx.y * lp, lp, window, cb, sb, cinv, sinv,
      desc, n_ops, params, plane0, plane1, plane2, fbase, nfft, hop,
      n_frames);

  // 4. Unfold + OLA (ascending frame order) + normalize.
  float* o_ch = out + (long long)blockIdx.y * out_len;
  for (int idx = threadIdx.x; idx < tb * hop; idx += blockDim.x) {
    const int jb = idx / hop, s = idx - jb * hop;
    const long long t = (long long)(blockIdx.x * tb + jb) * hop + s;
    if (t >= out_len) continue;
    float acc = 0.0f;
    for (int r = r_count - 1; r >= 0; --r) {
      const int lf = jb + r_count - 1 - r;
      const int fa = fbase + lf;
      if (fa < 0 || fa >= n_frames) continue;
      acc = __fadd_rn(acc, unfold(plane0, plane2, lf, kp, r * hop + s, nfft));
    }
    o_ch[t] = __fdiv_rn(acc, fmaxf(__ldg(norm + t), eps));
  }
}

// B3: the frames-level round-trip (replaces pallas_rt.py::_rt_kernel).
// Each CTA owns NF consecutive frames of one channel; no neighbour is
// needed, so nothing is recomputed. Stage 4 unfolds and stores each frame
// as one coalesced row of N floats; frames >= n_frames are not stored.
__global__ void __launch_bounds__(MAX_THREADS, 1)
rt_frames_kernel(const float* __restrict__ padded, long long lp,
                 const float* __restrict__ window,
                 const float* __restrict__ cb, const float* __restrict__ sb,
                 const float* __restrict__ cinv,
                 const float* __restrict__ sinv,
                 const int* __restrict__ desc, int n_ops,
                 const float* __restrict__ params,
                 float* __restrict__ out,  // [channels, n_frames, nfft]
                 int nfft, int hop, int n_frames) {
  extern __shared__ float4 smem4[];
  const int K = nfft / 2 + 1;
  const int kp = (K + TBIN - 1) / TBIN * TBIN;
  float* plane0 = reinterpret_cast<float*>(smem4);
  float* plane1 = plane0 + kp * NF;
  float* plane2 = plane1 + kp * NF;
  const int fbase = blockIdx.x * NF;
  rt_frames_to_planes<true>(
      padded + (long long)blockIdx.y * lp, lp, window, cb, sb, cinv, sinv,
      desc, n_ops, params, plane0, plane1, plane2, fbase, nfft, hop,
      n_frames);

  // 4. Unfold and store.
  const int n_local = min(NF, n_frames - fbase);
  float* o = out + ((long long)blockIdx.y * n_frames + fbase) * nfft;
  for (int idx = threadIdx.x; idx < n_local * nfft; idx += blockDim.x) {
    const int lf = idx / nfft, n = idx - lf * nfft;
    o[idx] = unfold(plane0, plane2, lf, kp, n, nfft);
  }
}

}  // namespace

extern "C" int crlot_rt_ola(const float* padded, long long lp,
                            const float* window, const float* c,
                            const float* s, const float* cinv,
                            const float* sinv, const float* norm,
                            const int* desc, int n_ops, const float* params,
                            float* out, int channels, int nfft, int hop,
                            int n_frames, int out_len, float eps,
                            void* stream) {
  const int k = nfft / 2 + 1, r_count = nfft / hop;
  const int kp = (k + TBIN - 1) / TBIN * TBIN;
  const int tb = NF - (r_count - 1);
  const int threads = ((kp / TBIN) * (NF / TF) + 31) / 32 * 32;
  if (tb < 1 || threads > MAX_THREADS || nfft % hop != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = 3 * kp * NF * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rt_ola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (out_len + hop - 1) / hop;
  dim3 grid((blocks + tb - 1) / tb, channels);
  rt_ola_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      padded, lp, window, c, s, cinv, sinv, norm, desc, n_ops, params, out,
      nfft, hop, n_frames, out_len, eps);
  return (int)cudaGetLastError();
}

extern "C" int crlot_rt_frames(const float* padded, long long lp,
                               const float* window, const float* c,
                               const float* s, const float* cinv,
                               const float* sinv, const int* desc, int n_ops,
                               const float* params, float* out, int channels,
                               int nfft, int hop, int n_frames,
                               void* stream) {
  const int k = nfft / 2 + 1;
  const int kp = (k + TBIN - 1) / TBIN * TBIN;
  const int threads = ((kp / TBIN) * (NF / TF) + 31) / 32 * 32;
  if (threads > MAX_THREADS || n_frames < 1 || lp < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = 3 * kp * NF * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rt_frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + NF - 1) / NF, channels);
  rt_frames_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      padded, lp, window, c, s, cinv, sinv, desc, n_ops, params, out, nfft,
      hop, n_frames);
  return (int)cudaGetLastError();
}
