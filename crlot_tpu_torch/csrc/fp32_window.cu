// B0 at FftPrecision.HIGHEST: the windowed product in IEEE fp32, summed in a
// fixed order on the FMA pipe.
//
// B0 is the blocked round-trip's windowed product (crlot_tpu/fft/
// matmul_backend.py:633 hopblock_apply, an XLA dot in the reference, not a
// Pallas kernel). At HIGH it runs in 3xTF32 (b6_sm90.cu mode 8); this file
// is the HIGHEST tier:
//
//   C[b, r, n] = sum_{k = 0 .. K-1} A[b * a_batch + r * lda + k] * W[k, n]
//
// over the overlapping windows of a signal (lda < K, read in place: the
// blocked round-trip's lda = G*hop, K = mg*G*hop) or the rows of a matrix
// (lda = K). W is the [K, N] row-major kernel.
//
// Order. Each output is one fmaf chain over k ascending from 0.0f: no
// split-K, no tree, nothing that depends on the row count, the tile the
// output sits in or the batch. So a chunk's rows equal the one-shot's rows
// bit for bit (the f32 streamer, the sharded blocked route; ROADMAP C6),
// which cuBLAS, whose split depends on the shape, does not promise.
//
// Design: a register-tiled SIMT GEMM. A CTA of 256 threads computes a
// 128 x 128 tile of C, a thread 8 x 8 outputs (rows 4ty .. 4ty+3 and 64 +
// 4ty .., columns 4tx .. and 64 + 4tx ..: conflict-free float4 reads of the
// staged tiles). The contraction advances 8 at a time through two shared
// buffers (A transposed, W as is); the next slab is loaded into registers
// while the current one is multiplied. Rows, columns and k past the edges
// read as zeros, which add nothing to a chain.
//
// What bounds it on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores,
// 3.35 TB/s): at the main path (2 x 11 252 windows x 512, K 2048) 23.6
// GFLOP (0.352 ms) against 46 MB of signal and output (0.014 ms): the FMA
// pipe. Each staged value feeds 8 FMAs from registers.

#include <cuda_runtime.h>

namespace {

constexpr int kTM = 128, kTN = 128, kTK = 8, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fp32_window_kernel(const float* __restrict__ x, long long lda,
                   long long a_batch, const float* __restrict__ w, int k,
                   int n, float* __restrict__ out, int m) {
  __shared__ __align__(16) float as[2][kTK][kTM];
  __shared__ __align__(16) float ws[2][kTK][kTN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;
  const float* xb = x + blockIdx.z * a_batch;
  // The slab loads: A row ar, k offset ak (a float4); W k row wk, column wc.
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int wk = tid / 32, wc = (tid % 32) * 4;
  const bool a_ok = row0 + ar < m, w_ok = col0 + wc < n;
  const float* ap = xb + (long long)(a_ok ? row0 + ar : 0) * lda + ak;
  const float* wp = w + (long long)wk * n + (w_ok ? col0 + wc : 0);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_a = [&](int k0) {
    return a_ok && k0 + ak < k ? *reinterpret_cast<const float4*>(ap + k0)
                               : zero;
  };
  auto load_w = [&](int k0) {
    return w_ok && k0 + wk < k
               ? *reinterpret_cast<const float4*>(wp + (long long)k0 * n)
               : zero;
  };
  auto stage = [&](int buf, float4 va, float4 vw) {
    as[buf][ak][ar] = va.x;
    as[buf][ak + 1][ar] = va.y;
    as[buf][ak + 2][ar] = va.z;
    as[buf][ak + 3][ar] = va.w;
    *reinterpret_cast<float4*>(&ws[buf][wk][wc]) = vw;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  stage(0, load_a(0), load_w(0));
  __syncthreads();
  const int slabs = (k + kTK - 1) / kTK;
  for (int s = 0; s < slabs; ++s) {
    const int buf = s & 1;
    float4 na = zero, nw = zero;
    if (s + 1 < slabs) {
      na = load_a((s + 1) * kTK);
      nw = load_w((s + 1) * kTK);
    }
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&ws[buf][kk][64 + 4 * tx]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < slabs) {
      stage(buf ^ 1, na, nw);  // the other buffer: read a slab ago, synced
      __syncthreads();
    }
  }

  float* ob = out + (long long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 64 * h + 4 * tx;
      if (c < n)
        *reinterpret_cast<float4*>(ob + (long long)r * n + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

}  // namespace

// x: the signal [batch, a_batch floats] (a matrix: lda = k); w: [k, n]
// row-major; out: [batch, m, n]. lda, a_batch, k and n multiples of 4 (16-byte
// rows), x, w and out 16-byte aligned; the wrapper checks that the windows
// fit the signal.
extern "C" int crlot_fp32_window(const float* x, long long lda,
                                 long long a_batch, const float* w, int k,
                                 int n, float* out, int m, int batch,
                                 void* stream) {
  if (m < 1 || n < 4 || k < 4 || batch < 1 || batch > 65535 || lda % 4 ||
      a_batch % 4 || k % 4 || n % 4 || (m + kTM - 1) / kTM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTN - 1) / kTN, (m + kTM - 1) / kTM, batch);
  fp32_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, lda, a_batch, w, k, n, out, m);
  return (int)cudaGetLastError();
}
