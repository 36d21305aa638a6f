// B6-fusedq: K11, the fused quantize-and-dot, on Hopper's tensor cores.
//
// Replaces the Pallas kernel of scripts/bench_pallas_int8_probe.py
//   K11 _kernel_i8_fusedq (:64)  per-row quantize + 3 dots      fusedq_kernel
// The other B6 products (K8, K9, K10 and the wire tier's limb products)
// run on b6_sm90.cu's TMA + wgmma kernel.
//
// Tiles: a CTA of 4 warps computes a 64 x 64 tile of each accumulator, a
// warp a 32 x 32 quarter (2 x 4 mma.sync tiles). Its 64 rows, quantized to
// two int8 limbs, stay in shared memory for the whole contraction; B (Bt
// [N, K], K-contiguous: the `.col` operand of mma.sync) advances 64 bytes a
// stage, two m16n8k32 int8 steps, staged by cp.async in a two-deep ring.
// Shared rows are padded, so that a warp's 32-bit fragment loads hit 32
// distinct banks.
//
// Exactness. Each limb product accumulates in int32 registers (mma s32, no
// saturation): sums of integers, exact in any order. The f32 epilogue
// converts each accumulator with __int2float_rn and combines them with
// __fmul_rn / __fadd_rn in the caller's order and expression, so no
// contraction into an FMA changes a rounding.
//
// What bounds it on an H100 (SXM: 1979 TOPS int8, 3.35 TB/s): at the
// probe's 11264 x 512 x 512, 24 MB of f32 rows in and 23 MB of f32 out
// (0.0139 ms) against 3 x 5.9 G int8 operations (0.009 ms): the bytes.
// This design (mma.sync from padded shared tiles, each fragment reused 2-4
// times) is bound by shared-memory fragment loads well before either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                // rows of C per CTA
constexpr int kBN = 64;                // columns of C per CTA
constexpr int kBK = 64;                // contraction bytes per stage
constexpr int kPitch = kBK + 16;       // bytes per staged shared row
constexpr int kTile = kBM * kPitch;    // bytes of one staged operand tile
constexpr int kThreads = 128;

using Acc = int[2][2][4][4];  // [hh, hl + lh][mt][nt][element]

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared; `bytes` = 0 zero-fills (rows past M).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One 32-byte slab of the contraction for a warp's 32 x 32 quarter. Thread
// (g, t) = (lane / 4, lane % 4) holds the bytes [4t, 4t+4) and [16+4t, ...)
// of rows g and g+8 of each 16-row A tile and of column g of each 8-column
// B tile: the m16n8k32 s8 fragment layout.
__device__ __forceinline__ void mma_slab(Acc& acc, const uint8_t* const* sa,
                                         int a_pitch, int a_off,
                                         const uint8_t* const* sb, int b_off,
                                         int wm, int wn, int g, int t) {
  uint32_t af[2][2][4];
  uint32_t bf[2][4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint8_t* p =
          sa[i] + (wm * 32 + mt * 16 + g) * a_pitch + a_off + t * 4;
      af[i][mt][0] = lds32(p);
      af[i][mt][1] = lds32(p + 8 * a_pitch);
      af[i][mt][2] = lds32(p + 16);
      af[i][mt][3] = lds32(p + 8 * a_pitch + 16);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint8_t* p = sb[j] + (wn * 32 + nt * 8 + g) * kPitch + b_off + t * 4;
      bf[j][nt][0] = lds32(p);
      bf[j][nt][1] = lds32(p + 16);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mma_s8(acc[0][mt][nt], af[0][mt], bf[0][nt]);  // hh = xh . b
      mma_s8(acc[1][mt][nt], af[0][mt], bf[1][nt]);  // hl = xh . b2, and
      mma_s8(acc[1][mt][nt], af[1][mt], bf[0][nt]);  // lh = xl . b: one int32 sum
    }
  }
}

__device__ __forceinline__ float f32(int v) { return __int2float_rn(v); }

// Writes the warp's quarter, (f32(hh)*128 + f32(hl + lh)) * row_scale: rows
// past m are dropped. Thread (g, t) holds columns 2t, 2t+1 of rows g and
// g+8 of each 16 x 8 tile.
__device__ __forceinline__ void store_tile(const Acc& acc, float* out,
                                           long long ldc, int row0, int col0,
                                           int m, const float* row_scale,
                                           int wm, int wn, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = wm * 32 + mt * 16 + g + hf * 8;
      const int r = row0 + lr;
      if (r >= m) continue;
      const float rs = row_scale[lr];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long at = (long long)r * ldc + col0 + wn * 32 + nt * 8 + t * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = __fmul_rn(
              __fadd_rn(__fmul_rn(f32(acc[0][mt][nt][hf * 2 + e]), 128.0f),
                        f32(acc[1][mt][nt][hf * 2 + e])),
              rs);
        *reinterpret_cast<float2*>(out + at) = make_float2(v[0], v[1]);
      }
    }
  }
}

// Stages kBK bytes at contraction offset k0 of 64 rows into a padded shared
// tile: 256 chunks of 16 bytes, two a thread. Rows at or past `rows` are
// zero-filled (their address is clamped to row 0, never read).
__device__ __forceinline__ void stage_rows(uint8_t* tile, const uint8_t* base,
                                           long long stride, int row0,
                                           int rows, int k0, int tid) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int q = tid + c * kThreads;
    const int r = q >> 2, ch = q & 3;
    const bool ok = row0 + r < rows;
    const uint8_t* src = base + (ok ? (long long)(row0 + r) * stride : 0) + k0 + ch * 16;
    cp_async16(tile + r * kPitch + ch * 16, src, ok ? 16 : 0);
  }
}

// K11: f32 rows in, quantized in the CTA. The CTA's 64 rows span the full
// contraction (k <= 1024 bytes), so each row's amax is taken over the whole
// row before any value is quantized, exactly as the Pallas tile does:
//   s = max(amax, 1e-30) * f32(1/16256) (XLA folds the probe's division by
//   the constant 16256 into this product), q = rint(x / s) (an IEEE
//   divide; ties to even as jnp.round), hi = clip(rint(q / 128), +-127),
//   lo = q - 128*hi,
// then the 3 dots from the quantized rows in shared memory, and
//   out = (f32(hh)*128 + f32(hl + lh)) * (s*128).
// A NaN in a row is dropped by fmaxf where jnp.max would keep it (the probe
// feeds finite uniform noise).
__global__ void __launch_bounds__(kThreads)
fusedq_kernel(const float* __restrict__ x, long long ldx,
              const uint8_t* __restrict__ b0, const uint8_t* __restrict__ b1,
              int k, float* __restrict__ out, long long ldc, int m, int n) {
  extern __shared__ __align__(16) uint8_t dyn[];
  const int a_pitch = k + 16;  // conflict-free: (k + 16) / 4 = 4 mod 32 words
  uint8_t* qa[2] = {dyn, dyn + kBM * a_pitch};
  float* row_scale = reinterpret_cast<float*>(dyn + 2 * kBM * a_pitch);
  uint8_t* ring = dyn + 2 * kBM * a_pitch + kBM * sizeof(float);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.x * kBM;
  const int kt_n = k / kBK;
  int col0 = 0;
  auto load = [&](int stage, int kt) {
    stage_rows(ring + (2 * stage) * kTile, b0, k, col0, n, kt * kBK, tid);
    stage_rows(ring + (2 * stage + 1) * kTile, b1, k, col0, n, kt * kBK, tid);
  };
  load(0, 0);
  cp_async_commit();

  for (int lr = warp; lr < kBM; lr += kThreads / 32) {
    const int r = row0 + lr;
    const float* xr = x + (long long)(r < m ? r : 0) * ldx;
    float amax = 0.0f;
    for (int c = lane * 4; c < k; c += 128) {
      const float4 v = r < m ? *reinterpret_cast<const float4*>(xr + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = __fmul_rn(fmaxf(amax, 1e-30f), 1.0f / 16256.0f);
    if (lane == 0) row_scale[lr] = __fmul_rn(s, 128.0f);
    for (int c = lane * 4; c < k; c += 128) {
      const float4 v = r < m ? *reinterpret_cast<const float4*>(xr + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float xs[4] = {v.x, v.y, v.z, v.w};
      char4 hi4, lo4;
      signed char* hp = reinterpret_cast<signed char*>(&hi4);
      signed char* lp = reinterpret_cast<signed char*>(&lo4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = rintf(__fdiv_rn(xs[e], s));
        const float h =
            fminf(fmaxf(rintf(__fmul_rn(q, 0.0078125f)), -127.0f), 127.0f);
        hp[e] = (signed char)(int)h;
        lp[e] = (signed char)(int)__fsub_rn(q, __fmul_rn(h, 128.0f));
      }
      *reinterpret_cast<char4*>(qa[0] + lr * a_pitch + c) = hi4;
      *reinterpret_cast<char4*>(qa[1] + lr * a_pitch + c) = lo4;
    }
  }

  // The quantized rows stay in shared memory while the CTA walks every
  // 64-column tile of the output: each row is quantized once.
  const uint8_t* sa[2] = {qa[0], qa[1]};
  for (; col0 < n; col0 += kBN) {
    if (col0 > 0) {
      load(0, 0);
      cp_async_commit();
    }
    Acc acc;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][mt][nt][e] = 0;
    for (int kt = 0; kt < kt_n; ++kt) {
      if (kt + 1 < kt_n) load((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();  // also publishes the quantized rows before kt = 0
      const uint8_t* base = ring + 2 * (kt & 1) * kTile;
      const uint8_t* sb[2] = {base, base + kTile};
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32)
        mma_slab(acc, sa, a_pitch, kt * kBK + kk, sb, kk, wm, wn, g, t);
      __syncthreads();
    }
    store_tile(acc, out, ldc, row0, col0, m, row_scale, wm, wn, g, t);
  }
}

}  // namespace

// K11: x f32 [m, k] (row stride ldx floats), b0/b1 int8 Bt [n, k], out f32
// [m, n] (row stride ldc). k % 128 == 0 and k <= 1024.
extern "C" int crlot_b6_fusedq(const float* x, long long ldx, const void* b0,
                               const void* b1, int k, float* out,
                               long long ldc, int m, int n, void* stream) {
  if (m < 1 || n < kBN || n % kBN || k < 128 || k % 128 || k > 1024 ||
      ldx % 4 || n / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      2 * (size_t)kBM * (k + 16) + kBM * sizeof(float) + 4 * (size_t)kTile;
  cudaError_t e = cudaFuncSetAttribute(
      fusedq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), 1, 1);
  fusedq_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, ldx, static_cast<const uint8_t*>(b0), static_cast<const uint8_t*>(b1),
      k, out, ldc, m, n);
  return (int)cudaGetLastError();
}
