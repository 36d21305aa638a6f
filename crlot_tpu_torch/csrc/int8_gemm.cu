// B6: the int8 limb dots on Hopper's tensor cores, and crlot_b6_gemm.
//
// Replaces two Pallas kernels of scripts/bench_pallas_int8_probe.py
//   K10 _kernel_i8_3dot   (:50)  f32(hh)*128 + f32(hl + lh)     mode kProbe3
//   K11 _kernel_i8_fusedq (:64)  per-row quantize + 3 dots      fusedq_kernel
// and runs the born-int16 wire tier's interior, the limb dots and their
// combination of crlot_tpu/wire.py:112-179 (modes kWire2 and kWire1).
// crlot_b6_gemm's dense modes kI32 (K9 _kernel_i8, :41) and kBf16 (K8
// _kernel_bf16, :32) run on b6_sm90.cu's TMA + wgmma kernel.
//
// One main loop serves the limb modes: C[b] = (limb-pair sums of A_i[b] @
// B_j), where B_j comes as Bt [N, K] (K-contiguous: the `.col` operand of
// mma.sync, laid out once at design time) and row r of A_i[b] is the K
// bytes at A_i + b*a_batch + r*lda. With lda < K the rows are overlapping
// windows of one signal, read in place: the wire tier's hop-block Toeplitz
// rows (lda = gh = 512, K = mg*gh = 2048) need no im2col copy.
//
// Tiles: a CTA of 4 warps computes a 64 x 64 tile of each accumulator, a
// warp a 32 x 32 quarter (2 x 4 mma tiles). The contraction advances 64
// bytes a stage, two m16n8k32 int8 steps, staged by cp.async in a two-deep
// ring. Shared rows are padded to 80 bytes, so that a warp's 32-bit
// fragment loads hit 32 distinct banks.
//
// Exactness. Each limb product accumulates in int32 registers (mma s32,
// no saturation): sums of integers, exact in any order, so one launch over
// the full contraction equals the reference's m-ordered sum of mg shifted
// dots bit for bit, and the wire tier's output is bit-identical across
// chunk sizes. Headroom (ROADMAP C2): the largest accumulator is the
// unsigned low limb (0..255) against the kernel's high limb (|k_hi| <= 127):
// 255*128*K = 66.8 M at K = 2048 (mg*gh), < 2^31; the probe's |hh| reaches
// 128*127*512 = 8.3 M. The f32 epilogues convert each accumulator with
// __int2float_rn (it rounds above 2^24, as torch's .float() does) and
// combine them with __fmul_rn / __fadd_rn in the caller's order and
// expression, so no contraction into an FMA changes a rounding.
//
// What bounds it on an H100 (SXM: 1979 TOPS int8, 989 TFLOP/s bf16 dense,
// 3.35 TB/s): the probe's dot is 2*11264*512*512 = 5.9 G operations, 3 ms
// of int8 tensor-core time per thousand calls, while its f32 or int32
// output alone is 23 MB (0.0069 ms): the bytes bound every probe variant.
// The wire chunk (2 097 152 samples, int8x2) is 4 x 8.6 G = 34.4 G int8
// operations (0.017 ms) on 4 MB of limbs and 8 MB of output (0.0036 ms):
// operations bound it. This first design is mma.sync from padded shared
// tiles, without ldmatrix, wgmma or TMA, and a 64 x 64 tile reuses each
// fragment only 2-4 times: shared-memory fragment loads bound it well
// before either roofline (later PRs: wgmma, TMA, larger tiles).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;                // rows of C per CTA
constexpr int kBN = 64;                // columns of C per CTA
constexpr int kBK = 64;                // contraction bytes per stage
constexpr int kPitch = kBK + 16;       // bytes per staged shared row
constexpr int kTile = kBM * kPitch;    // bytes of one staged operand tile
constexpr int kThreads = 128;

enum Mode : int { kI32 = 0, kProbe3 = 1, kWire2 = 2, kWire1 = 3, kBf16 = 4,
                  kFusedQ = 5 };

// NA A operands, NB B operands, NACC accumulators.
template <int MODE> struct Shape;
template <> struct Shape<kProbe3> { static constexpr int NA = 2, NB = 2, NACC = 2; };
template <> struct Shape<kFusedQ> { static constexpr int NA = 2, NB = 2, NACC = 2; };
template <> struct Shape<kWire2>  { static constexpr int NA = 2, NB = 2, NACC = 4; };
template <> struct Shape<kWire1>  { static constexpr int NA = 2, NB = 1, NACC = 2; };

template <int MODE>
using Acc = int[Shape<MODE>::NACC][2][4][4];

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A unsigned (the wire's low limb, 0..255), B signed.
__device__ __forceinline__ void mma_u8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
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
template <int MODE>
__device__ __forceinline__ void mma_slab(Acc<MODE>& acc,
                                         const uint8_t* const* sa,
                                         int a_pitch, int a_off,
                                         const uint8_t* const* sb, int b_off,
                                         int wm, int wn, int g, int t) {
  using S = Shape<MODE>;
  uint32_t af[S::NA][2][4];
  uint32_t bf[S::NB][4][2];
#pragma unroll
  for (int i = 0; i < S::NA; ++i) {
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
  for (int j = 0; j < S::NB; ++j) {
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
      if constexpr (MODE == kProbe3 || MODE == kFusedQ) {
        mma_s8(acc[0][mt][nt], af[0][mt], bf[0][nt]);  // hh = xh . b
        mma_s8(acc[1][mt][nt], af[0][mt], bf[1][nt]);  // hl = xh . b2, and
        mma_s8(acc[1][mt][nt], af[1][mt], bf[0][nt]);  // lh = xl . b: one int32 sum
      } else if constexpr (MODE == kWire2) {
        mma_s8(acc[0][mt][nt], af[0][mt], bf[0][nt]);  // hh = hi . k_hi
        mma_u8(acc[1][mt][nt], af[1][mt], bf[0][nt]);  // lh = lo . k_hi
        mma_s8(acc[2][mt][nt], af[0][mt], bf[1][nt]);  // hl = hi . k_lo
        mma_u8(acc[3][mt][nt], af[1][mt], bf[1][nt]);  // ll = lo . k_lo
      } else {                                         // kWire1
        mma_s8(acc[0][mt][nt], af[0][mt], bf[0][nt]);  // hi . k
        mma_u8(acc[1][mt][nt], af[1][mt], bf[0][nt]);  // lo . k
      }
    }
  }
}

__device__ __forceinline__ float f32(int v) { return __int2float_rn(v); }

// The epilogue of accumulator element e of fragment (mt, nt); `row_scale`
// is K11's per-row s*128.
template <int MODE>
__device__ __forceinline__ float combine(const Acc<MODE>& acc, int mt, int nt,
                                         int e, float scale, float row_scale) {
  if constexpr (MODE == kProbe3 || MODE == kFusedQ) {
    const float v = __fadd_rn(__fmul_rn(f32(acc[0][mt][nt][e]), 128.0f),
                              f32(acc[1][mt][nt][e]));
    if constexpr (MODE == kFusedQ) return __fmul_rn(v, row_scale);
    return v;
  } else if constexpr (MODE == kWire2) {
    // (hh*32768 + lh*128 + hl*256 + ll) * (k_scale / 32768), left to right.
    float v = __fmul_rn(f32(acc[0][mt][nt][e]), 32768.0f);
    v = __fadd_rn(v, __fmul_rn(f32(acc[1][mt][nt][e]), 128.0f));
    v = __fadd_rn(v, __fmul_rn(f32(acc[2][mt][nt][e]), 256.0f));
    v = __fadd_rn(v, f32(acc[3][mt][nt][e]));
    return __fmul_rn(v, scale);
  } else {  // kWire1
    const float v = __fadd_rn(__fmul_rn(f32(acc[0][mt][nt][e]), 256.0f),
                              f32(acc[1][mt][nt][e]));
    return __fmul_rn(v, scale);
  }
}

// Writes the warp's quarter: rows past m are dropped. Thread (g, t) holds
// columns 2t, 2t+1 of rows g and g+8 of each 16 x 8 tile.
template <int MODE>
__device__ __forceinline__ void store_tile(const Acc<MODE>& acc, void* out,
                                           long long ldc, int row0, int col0,
                                           int m, float scale,
                                           const float* row_scale, int wm,
                                           int wn, int g, int t) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = wm * 32 + mt * 16 + g + hf * 8;
      const int r = row0 + lr;
      if (r >= m) continue;
      const float rs = row_scale != nullptr ? row_scale[lr] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const long long at = (long long)r * ldc + col0 + wn * 32 + nt * 8 + t * 2;
        const int e = hf * 2;
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
            make_float2(combine<MODE>(acc, mt, nt, e, scale, rs),
                        combine<MODE>(acc, mt, nt, e + 1, scale, rs));
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

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const uint8_t* __restrict__ a0, const uint8_t* __restrict__ a1,
            long long lda, long long a_batch, const uint8_t* __restrict__ b0,
            const uint8_t* __restrict__ b1, int k_bytes, void* __restrict__ out,
            long long ldc, long long c_batch, int m, int n, float scale) {
  using S = Shape<MODE>;
  constexpr int kOps = S::NA + S::NB;
  __shared__ __align__(16) uint8_t smem[2 * kOps * kTile];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const long long bz = blockIdx.z;
  const uint8_t* ga[2] = {a0 + bz * a_batch, S::NA > 1 ? a1 + bz * a_batch : a0};
  const uint8_t* gb[2] = {b0, S::NB > 1 ? b1 : b0};
  const int kt_n = k_bytes / kBK;

  auto load = [&](int stage, int kt) {
    uint8_t* base = smem + stage * kOps * kTile;
#pragma unroll
    for (int i = 0; i < S::NA; ++i)
      stage_rows(base + i * kTile, ga[i], lda, row0, m, kt * kBK, tid);
#pragma unroll
    for (int j = 0; j < S::NB; ++j)
      stage_rows(base + (S::NA + j) * kTile, gb[j], k_bytes, col0, n,
                 kt * kBK, tid);
  };

  Acc<MODE> acc;
#pragma unroll
  for (int a = 0; a < S::NACC; ++a)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][mt][nt][e] = 0;

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) load((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const uint8_t* base = smem + (kt & 1) * kOps * kTile;
    const uint8_t* sa[2] = {base, base + (S::NA > 1 ? kTile : 0)};
    const uint8_t* sb[2] = {base + S::NA * kTile,
                            base + (S::NA + (S::NB > 1 ? 1 : 0)) * kTile};
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32)
      mma_slab<MODE>(acc, sa, kPitch, kk, sb, kk, wm, wn, g, t);
    __syncthreads();
  }
  store_tile<MODE>(acc,
                   static_cast<uint8_t*>(out) + bz * c_batch * sizeof(float),
                   ldc, row0, col0, m, scale, nullptr, wm, wn, g, t);
}

// K11: f32 rows in, quantized in the CTA. The CTA's 64 rows span the full
// contraction (k <= 1024 bytes), so each row's amax is taken over the whole
// row before any value is quantized, exactly as the Pallas tile does:
//   s = max(amax, 1e-30) * f32(1/16256) (XLA folds the probe's division by
//   the constant 16256 into this product), q = rint(x / s) (an IEEE
//   divide; ties to even as jnp.round), hi = clip(rint(q / 128), +-127),
//   lo = q - 128*hi,
// then the 3 dots of kProbe3 from the quantized rows in shared memory, and
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
    Acc<kFusedQ> acc;
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
        mma_slab<kFusedQ>(acc, sa, a_pitch, kt * kBK + kk, sb, kk, wm, wn, g,
                          t);
      __syncthreads();
    }
    store_tile<kFusedQ>(acc, out, ldc, row0, col0, m, 0.0f, row_scale, wm,
                        wn, g, t);
  }
}

template <int MODE>
int launch_gemm(const void* a0, const void* a1, long long lda,
                long long a_batch, const void* b0, const void* b1,
                int k_bytes, void* out, long long ldc, long long c_batch,
                int m, int n, int batch, float scale, cudaStream_t st) {
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (unsigned)(n / kBN),
                  (unsigned)batch);
  gemm_kernel<MODE><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(a0), static_cast<const uint8_t*>(a1), lda,
      a_batch, static_cast<const uint8_t*>(b0),
      static_cast<const uint8_t*>(b1), k_bytes, out, ldc, c_batch, m, n,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// b6_sm90.cu: modes kI32 and kBf16 on TMA + wgmma.
int b6_sm90_gemm(int mode, const void* a, long long lda, long long a_batch,
                 const void* bt, int k_bytes, void* out, long long ldc,
                 long long c_batch, int m, int n, int batch, cudaStream_t st);

// mode: 0 int32 out (K9), 1 probe 3-dot (K10), 2 wire int8x2, 3 wire
// int8x1, 4 bf16 (K8); modes 0 and 4 run on b6_sm90.cu. lda, a_batch and
// k_bytes in bytes; ldc and c_batch in output elements. The wrapper checks
// the shapes; this refuses what the tiles cannot take (N % 64, K % 64,
// 16-byte strides).
extern "C" int crlot_b6_gemm(int mode, const void* a0, const void* a1,
                             long long lda, long long a_batch,
                             const void* b0, const void* b1, int k_bytes,
                             void* out, long long ldc, long long c_batch,
                             int m, int n, int batch, float scale,
                             void* stream) {
  if (m < 1 || n < kBN || n % kBN || k_bytes < kBK || k_bytes % kBK ||
      lda % 16 || a_batch % 16 || batch < 1 || batch > 65535 ||
      n / kBN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case kI32:
    case kBf16: return b6_sm90_gemm(mode, a0, lda, a_batch, b0, k_bytes, out,
                                    ldc, c_batch, m, n, batch, st);
    case kProbe3: return launch_gemm<kProbe3>(a0, a1, lda, a_batch, b0, b1,
                                              k_bytes, out, ldc, c_batch, m, n,
                                              batch, scale, st);
    case kWire2: return launch_gemm<kWire2>(a0, a1, lda, a_batch, b0, b1,
                                            k_bytes, out, ldc, c_batch, m, n,
                                            batch, scale, st);
    case kWire1: return launch_gemm<kWire1>(a0, a1, lda, a_batch, b0, b1,
                                            k_bytes, out, ldc, c_batch, m, n,
                                            batch, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
