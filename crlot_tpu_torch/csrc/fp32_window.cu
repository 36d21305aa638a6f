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

//
// B7 (stft_fp32_window_kernel, below): the framed windowed rFFT in IEEE
// fp32 on the frames of a signal read in place (frame f of row r at x +
// r*row_stride + f*hop, N samples), written straight into the complex64
// [rows, F, N/2+1] spectrum:
//
//   y[n] = w[n] * x[f*hop + n],  M = N/2,  z[m] = y[2m] + i y[2m+1]
//   Z = DFT_M(z),  A[k] = (Z[k] + conj Z[M-k]) / 2,
//   B[k] = (Z[k] - conj Z[M-k]) / 2i,  X[k] = A[k] + exp(-2 pi i k/N) B[k]
//
// for k = 0 .. M (Z's index mod M), Im = 0 at bins 0 and M. DFT_M is
// Stockham's mixed-radix FFT: a pass of radix R and stride ns (the product
// of the radices before it) takes the R inputs j + r*M/R, twiddles input
// r by exp(-2 pi i (j mod ns) r / (ns R)), runs an R-point DFT and stores
// output r at (j - j mod ns) R + j mod ns + r ns; the radices (2, 3, 4, 5,
// 7, 8, odd ones first) come packed from the host, so N/2 must be a product
// of 2, 3, 5 and 7. Twiddles come from a float64-built float32 table. Order:
// a frame's outputs are the same sequence of operations whatever its CTA,
// its place in it or the row count: a stream's spectrum equals the
// one-shot's bit for bit.
//
// Design: a CTA of 8 warps owns tm consecutive frames of one row. It stages
// their span, (tm-1)*hop + N samples (each frame's N alone where hop > N),
// the window and the tables in shared memory with coalesced 4-byte
// cp.async copies, all in flight at once (a row's start has no
// alignment). Each warp then takes a frame at a time: the windowed pairs
// into its buffer, the passes between its two buffers (one slot skipped
// every 16 complex, so a pass's strided stores meet no bank conflict), the
// split into the spectrum, a lane a bin: a warp's stores are consecutive
// (Re, Im) pairs. Nothing but the spectrum is written.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32) at the Whisper chain's
// feed (128 rows x 3000 frames, N 400, H 160): 246 MB of signal read and
// 617 MB of spectrum written, 0.258 ms; an FFT's 2.5 N log2 N flop a frame
// (3.3 GFLOP, 0.05 ms) are far below it: the bytes.

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

namespace {

constexpr int kFWarps = 8;  // warps a CTA, a frame at a time each
constexpr int kFThreads = 32 * kFWarps;

// 4 bytes global -> shared without a register round trip, any alignment.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// A warp's buffer index of complex i: one slot skipped every 16.
__device__ __forceinline__ int pad2(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// -i a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// (cos, sin) of 2 pi t / R, t in [1, R), for the odd radices.
template <int R>
__device__ __forceinline__ float2 root(int t);
template <>
__device__ __forceinline__ float2 root<3>(int t) {
  return make_float2(-0.5f, t == 1 ? 0.8660254037844386f
                                   : -0.8660254037844386f);
}
template <>
__device__ __forceinline__ float2 root<5>(int t) {
  const float c1 = 0.30901699437494745f, s1 = 0.9510565162951535f;
  const float c2 = -0.8090169943749475f, s2 = 0.5877852522924731f;
  return t == 1 ? make_float2(c1, s1)
       : t == 2 ? make_float2(c2, s2)
       : t == 3 ? make_float2(c2, -s2) : make_float2(c1, -s1);
}
template <>
__device__ __forceinline__ float2 root<7>(int t) {
  const float c1 = 0.6234898018587336f, s1 = 0.7818314824680298f;
  const float c2 = -0.22252093395631434f, s2 = 0.9749279121818236f;
  const float c3 = -0.900968867902419f, s3 = 0.43388373911755823f;
  return t == 1 ? make_float2(c1, s1)
       : t == 2 ? make_float2(c2, s2)
       : t == 3 ? make_float2(c3, s3)
       : t == 4 ? make_float2(c3, -s3)
       : t == 5 ? make_float2(c2, -s2) : make_float2(c1, -s1);
}

// The R-point forward DFT of v in place.
template <int R>
struct Dft {  // odd R: the pairs v[r] +- v[R-r] share their roots
  static __device__ __forceinline__ void run(float2* v) {
    constexpr int H = (R - 1) / 2;
    float2 s[H], d[H];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      s[r - 1] = cadd(v[r], v[R - r]);
      d[r - 1] = csub(v[r], v[R - r]);
    }
    const float2 v0 = v[0];
    float2 x0 = v0;
#pragma unroll
    for (int r = 0; r < H; ++r) x0 = cadd(x0, s[r]);
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float cr = v0.x, ci = v0.y, sr = 0.f, si = 0.f;
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 w = root<R>((r * k) % R);
        cr += s[r - 1].x * w.x;
        ci += s[r - 1].y * w.x;
        sr += d[r - 1].y * w.y;
        si += d[r - 1].x * w.y;
      }
      v[k] = make_float2(cr + sr, ci - si);
      v[R - k] = make_float2(cr - sr, ci + si);
    }
    v[0] = x0;
  }
};
template <>
struct Dft<2> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
};
template <>
struct Dft<4> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = cadd(t1, t3);
    v[3] = csub(t1, t3);
  }
};
template <>
struct Dft<8> {  // two 4-point DFTs of the even and odd inputs, then W8^k
  static __device__ __forceinline__ void run(float2* v) {
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    Dft<4>::run(e);
    Dft<4>::run(o);
    const float h = 0.7071067811865476f;
    o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
    o[2] = mul_mi(o[2]);
    o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cadd(e[k], o[k]);
      v[k + 4] = csub(e[k], o[k]);
    }
  }
};

// One Stockham pass of radix R and stride ns over a warp's m points.
template <int R>
__device__ __forceinline__ void stft_pass(const float2* __restrict__ src,
                                          float2* __restrict__ dst, int m,
                                          int ns, const float2* tw,
                                          int lane) {
  const int q = m / R, step = m / (ns * R);
  for (int j = lane; j < q; j += 32) {
    const int js = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = src[pad2(j + r * q)];
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[js * r * step]);
    }
    Dft<R>::run(v);
    const int d = (j - js) * R + js;
#pragma unroll
    for (int r = 0; r < R; ++r) dst[pad2(d + r * ns)] = v[r];
  }
}

__global__ void __launch_bounds__(kFThreads)
stft_fp32_window_kernel(const float* __restrict__ x, long long row_stride,
                        long long hop, int n, int frames,
                        const float* __restrict__ window,
                        const float2* __restrict__ tables,
                        unsigned long long radices,
                        float2* __restrict__ out, int tm, int fblocks) {
  extern __shared__ __align__(16) float2 smem2[];
  const int m = n / 2, pm = m + (m - 1) / 16 + 1;
  const int row = (int)(blockIdx.x / fblocks);
  const int f0 = (int)(blockIdx.x % fblocks) * tm;
  const int nf = min(tm, frames - f0);
  const int s = hop < n ? (int)hop : n;  // a frame's offset in the span
  const int span = (nf - 1) * s + n;
  float2* tw = smem2;                     // 2m + 1: the passes', the split's
  float2* bufs = tw + 2 * m + 1;          // two a warp, pm each
  float* win = reinterpret_cast<float*>(bufs + 2 * kFWarps * pm);
  float* sp = win + n;
  const int tid = threadIdx.x;
  const float* tf = reinterpret_cast<const float*>(tables);
  float* twf = reinterpret_cast<float*>(tw);
  for (int i = tid; i < 4 * m + 2; i += kFThreads) cp_async4(twf + i, tf + i);
  for (int i = tid; i < n; i += kFThreads) cp_async4(win + i, window + i);
  const float* xr = x + row * row_stride + f0 * hop;
  if (s == hop) {
    for (int i = tid; i < span; i += kFThreads) cp_async4(sp + i, xr + i);
  } else {
    for (int i = tid; i < span; i += kFThreads)
      cp_async4(sp + i, xr + (long long)(i / n) * hop + i % n);
  }
  cp_async_wait_all();
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  float2* a = bufs + warp * 2 * pm;
  float2* b = a + pm;
  const float2* wn = tw + m;
  for (int f = warp; f < nf; f += kFWarps) {
    const float* fs = sp + f * s;
    for (int i = lane; i < m; i += 32)
      a[pad2(i)] = make_float2(win[2 * i] * fs[2 * i],
                               win[2 * i + 1] * fs[2 * i + 1]);
    __syncwarp();
    float2 *src = a, *dst = b;
    int ns = 1;
    for (unsigned long long code = radices; code; code >>= 4) {
      const int r = (int)(code & 15);
      switch (r) {
        case 2: stft_pass<2>(src, dst, m, ns, tw, lane); break;
        case 3: stft_pass<3>(src, dst, m, ns, tw, lane); break;
        case 4: stft_pass<4>(src, dst, m, ns, tw, lane); break;
        case 5: stft_pass<5>(src, dst, m, ns, tw, lane); break;
        case 7: stft_pass<7>(src, dst, m, ns, tw, lane); break;
        default: stft_pass<8>(src, dst, m, ns, tw, lane); break;
      }
      __syncwarp();
      float2* t = src;
      src = dst;
      dst = t;
      ns *= r;
    }
    float2* o = out + ((long long)row * frames + f0 + f) * (m + 1);
    for (int k = lane; k <= m; k += 32) {
      const float2 zk = src[pad2(k == m ? 0 : k)];
      const float2 zc = src[pad2(k == 0 ? 0 : m - k)];
      const float ar = 0.5f * (zk.x + zc.x), ai = 0.5f * (zk.y - zc.y);
      const float br = 0.5f * (zk.y + zc.y), bi = 0.5f * (zc.x - zk.x);
      const float2 w = wn[k];
      const float re = ar + (w.x * br - w.y * bi);
      const float im = ai + (w.x * bi + w.y * br);
      o[k] = make_float2(re, k == 0 || k == m ? 0.f : im);
    }
    __syncwarp();
  }
}

bool stft_radices_ok(unsigned long long code, int m) {
  long long product = 1;
  int passes = 0;
  for (; code; code >>= 4, ++passes) {
    const int r = (int)(code & 15);
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8)
      return false;
    product *= r;
  }
  return passes > 0 && product == m;
}

}  // namespace

// x: frame f of row r at x + r*row_stride + f*hop; out: complex64 [rows,
// frames, n/2+1]; tables: float32 [n + 1, 2] (`fp32_window.py`
// _stft_tables); radices packed 4 bits a pass, first lowest; smem_bytes the
// shared memory of tm frames (`fp32_window.py` stft_plan).
extern "C" int crlot_stft_fp32_window(const float* x, long long row_stride,
                                      long long hop, int n, int frames,
                                      int rows, const float* window,
                                      const float* tables, float* out,
                                      long long radices, int tm,
                                      int smem_bytes, void* stream) {
  const int m = n / 2, pm = m + (m - 1) / 16 + 1;
  if (n % 2 || n < 16 || n > 1024 || frames < 1 || rows < 1 || hop < 0 ||
      tm < 1 || !stft_radices_ok((unsigned long long)radices, m))
    return (int)cudaErrorInvalidValue;
  const long long s = hop < n ? hop : n;
  const long long need = 8LL * (2 * m + 1) + 16LL * kFWarps * pm +
                         4LL * (n + (tm - 1) * s + n);
  if (smem_bytes < need || smem_bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long fblocks = (frames + tm - 1) / tm;
  const long long blocks = (long long)rows * fblocks;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  // Set on every launch: the attribute belongs to the current device, which
  // the wrapper has made the tensors' device.
  const cudaError_t e = cudaFuncSetAttribute(
      stft_fp32_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  stft_fp32_window_kernel<<<(unsigned)blocks, kFThreads, (size_t)smem_bytes,
                            (cudaStream_t)stream>>>(
      x, row_stride, hop, n, frames, window,
      reinterpret_cast<const float2*>(tables),
      (unsigned long long)radices, reinterpret_cast<float2*>(out), tm,
      (int)fblocks);
  return (int)cudaGetLastError();
}
