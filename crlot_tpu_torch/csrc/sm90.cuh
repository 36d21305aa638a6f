// Hopper building blocks shared by the TMA + wgmma kernels (b6_sm90.cu,
// fused_rt.cu): mbarriers, TMA loads and stores, cluster multicast loads
// and remote arrivals, the 128-byte-swizzle operand descriptor, wgmma
// (int8, bf16 and the 3xTF32 products), the tensor-map encoder and the
// setmaxnreg register check.
//
// 3xTF32. wgmma's .tf32 operands keep 10 of an f32's 23 mantissa bits. An
// f32 a is split as hi = tf32(a) and lo = tf32(a - hi) (both rounded to
// nearest, ties away from zero: cvt.rna), so |a - (hi + lo)| <= 2^-21 |a|,
// and a.b is taken as hi.b_hi + hi.b_lo + lo.b_hi: each term exact in f32,
// the dropped lo.b_lo and the split errors about 2^-21 |a||b|. The tensor
// core's f32 accumulation does not round to nearest at each step, so the
// kernels run each stage's products into a fresh accumulator and add it to
// the running sum with an IEEE add: a fixed order per output that depends
// on nothing but the output's own contraction index.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBM = 128;                    // rows of C per tile
constexpr int kBK = 128;                    // contraction bytes per stage
constexpr int kOpTile = kBM * kBK;          // 16 KB: one A tile
constexpr int kConsumers = 2;               // warpgroups running wgmma
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr long long kMaxSmem = 232448;      // 227 KB per CTA on sm_90
constexpr int kMaxDevices = 64;
// setmaxnreg: the producer warpgroup drops to kProducerRegs so that each
// consumer thread can hold kConsumerRegs; the CTA's pool must cover both.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kEntryRegs =
    (128 * kProducerRegs + kConsumers * 128 * kConsumerRegs) / kThreads;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed. A wrong
// parity or transaction count would spin for ever: after 2^34 cycles of the
// card's clock (about 10 s) the kernel traps, and the launch fails instead.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk stores have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The 128 threads of consumer warpgroup wg (barrier 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}
// Generic-proxy writes to shared memory, made visible to TMA and wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- clusters --------------------------------------------------------------

// tma_load_2d multicast: one read from L2 lands at the same CTA-relative
// offset `dst` in every CTA of the cluster whose bit is set in `mask`, and
// completes its bytes on the barrier at offset `bar` in each of them.
__device__ __forceinline__ void tma_load_2d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}
// One arrival on the barrier at CTA-relative offset `bar` of CTA `rank` of
// the cluster (this CTA's own included), with bar_arrive's release at CTA
// scope: it orders this thread's reads of the stage (a cluster-scope
// release would also wait for its global stores).
__device__ __forceinline__ void bar_arrive_cluster(uint32_t bar,
                                                   uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}
// Until every thread of the cluster that has not exited gets here.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A K-major operand tile in shared memory as TMA's 128-byte swizzle leaves
// it: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte
// offset), layout type 1 = SWIZZLE_128B. Tile bases are 1024-byte aligned;
// a k step inside the 128-byte row adds its byte offset to the start.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Until all but the last committed group are done.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define B6_ACC8(c, i)                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]),          \
      c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define B6_ACC32(c)                                                     \
  B6_ACC8(c, 0), B6_ACC8(c, 8), B6_ACC8(c, 16), B6_ACC8(c, 24)
#define B6_ACC64(c)                                                     \
  B6_ACC32(c), B6_ACC8(c, 32), B6_ACC8(c, 40), B6_ACC8(c, 48),          \
      B6_ACC8(c, 56)
#define B6_REGS32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define B6_REGS64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// --- 3xTF32 ---------------------------------------------------------------

// a rounded to TF32 (to nearest, ties away from zero): the low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}
// tf32_rna's bits from two integer operations, in place of a cvt on the
// slower conversion unit: the magnitude rounded half away from zero at bit
// 13 (the sign stays), carrying into the exponent as the rounding does;
// the same bits for every finite or infinite a.
__device__ __forceinline__ uint32_t tf32_rna_int(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// The 3xTF32 A fragments of k step k (8 TF32, 32 bytes) of warpgroup wg's 64
// rows, from a 128-row x 128-byte tile that TMA's 128-byte swizzle left in
// shared memory (16-byte chunk c of row r at chunk c ^ (r % 8)). In wgmma's
// TF32 register layout thread (g, t) of warp w holds elements t and t + 4
// of the step in rows 16w + g and 16w + g + 8: a[0] (g, t), a[1] (g + 8,
// t), a[2] (g, t + 4), a[3] (g + 8, t + 4), the same 32-bit words as the
// 8-bit layout's. A warp's 32 loads of one q fall on 32 distinct banks.
// kInt: round with tf32_rna_int.
template <bool kInt = false>
__device__ __forceinline__ void tf32_frags(const uint8_t* tile, int wg,
                                           int tid, int k,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const int warp = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = wg * 64 + warp * 16 + g + 8 * (q & 1);
    const int b = 32 * k + 16 * (q >> 1) + 4 * t;  // byte in the row
    const float a = *reinterpret_cast<const float*>(
        tile + r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15));
    hi[q] = kInt ? tf32_rna_int(a) : tf32_rna(a);
    const float rest = __fsub_rn(a, __uint_as_float(hi[q]));
    lo[q] = kInt ? tf32_rna_int(rest) : tf32_rna(rest);
  }
}

// D[64 x N] (+)= A[64 x 8] . B[N x 8]^T in TF32 with f32 accumulation, A
// from registers (a TF32 fragment), B a K-major swizzled tile; scale_d 0
// starts D afresh.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " B6_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : B6_ACC64("+f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else {
    static_assert(N == 64, "TF32 tiles are 64 or 128 columns");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " B6_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : B6_ACC32("+f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
}

// One stage's 3xTF32 products into d (started afresh): for each of KS k
// steps, lo.b_hi, hi.b_lo, hi.b_hi, in that order. db_hi / db_lo: the
// descriptors of the stage's B halves.
template <int N, int KS>
__device__ __forceinline__ void tf32x3_steps(float (&d)[N / 2],
                                             const uint32_t (&hi)[KS][4],
                                             const uint32_t (&lo)[KS][4],
                                             uint64_t db_hi, uint64_t db_lo,
                                             int k0) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t off = 2 * (k0 + k);  // 32 bytes: 2 descriptor units
    wgmma_tf32<N>(d, lo[k], db_hi + off, k0 + k != 0);
    wgmma_tf32<N>(d, hi[k], db_lo + off, 1);
    wgmma_tf32<N>(d, hi[k], db_hi + off, 1);
  }
}

// The running sum += a stage's partial, IEEE round to nearest.
template <int R>
__device__ __forceinline__ void promote(float (&acc)[R], const float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// --- host side ----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: fetched through the runtime,
// so that the library links without libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-`rank` map with 128-byte swizzled boxes of box0 x box1 (x 1).
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            int rank, const cuuint64_t* dims, const cuuint64_t* strides,
            cuuint32_t box0, cuuint32_t box1) {
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  if (encode_tiled() == nullptr) return false;
  const CUresult r = encode_tiled()(
      map, type, (cuuint32_t)rank,
      const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS)
    fprintf(stderr, "sm90: cuTensorMapEncodeTiled failed (CUresult %d)\n",
            (int)r);
  return r == CUDA_SUCCESS;
}

// The shared-memory attribute and the register check of `kernel` on
// `device`, done once a device (entry_regs[device] is 0 until then): the
// attribute belongs to the current device, which the wrapper has made the
// tensors' device (cuda_build.launch). setmaxnreg.inc waits for registers
// the CTA does not have if the kernel was compiled with fewer than the
// split needs: refuse instead.
template <typename Kernel>
int sm90_prepare(Kernel kernel, int smem, int device,
                 int (&entry_regs)[kMaxDevices], const char* who) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (entry_regs[device] == 0) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    entry_regs[device] = attr.numRegs;
  }
  if (entry_regs[device] < kEntryRegs) {
    fprintf(stderr, "%s: %d registers at entry, the split needs %d\n", who,
            entry_regs[device], kEntryRegs);
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace
