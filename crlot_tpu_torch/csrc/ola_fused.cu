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
// below the card's ops-per-byte balance. The design therefore moves each byte
// once: one thread per output sample, consecutive threads on consecutive
// samples, so every one of the R frame reads of a warp is one contiguous
// 128-byte span and the frames are never re-laid-out. The TPU kernel's row
// stacking, front/back zero pads and (8,128) tiling have no purpose here and
// are gone, and so is its hop % 128 rule. The batch is the grid's y axis:
// [B, F, N] frames run in one launch.
//
// Numerics: the R terms are added in ascending frame order starting from
// 0.0f, then divided with IEEE division (no fast math) -- the same sequence
// of roundings as ola/reference.py's overlap_add + normalize, so the result
// is bit-identical to the plain version.

#include <cuda_runtime.h>

namespace {

__global__ void ola_normalized_kernel(const float* __restrict__ frames,
                                      const float* __restrict__ norm,
                                      float* __restrict__ out,
                                      int n_frames, int nfft, int hop,
                                      int out_len, float eps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= out_len) return;
  const long long b = blockIdx.y;
  const float* fb = frames + b * (long long)n_frames * nfft;
  const int blk = t / hop;
  const int s = t - blk * hop;
  const int r_count = (nfft + hop - 1) / hop;
  float acc = 0.0f;
  for (int r = r_count - 1; r >= 0; --r) {
    const int f = blk - r;
    if (f < 0 || f >= n_frames) continue;
    const int n = r * hop + s;
    acc += (n < nfft) ? __ldg(fb + (long long)f * nfft + n) : 0.0f;
  }
  out[b * out_len + t] = acc / fmaxf(__ldg(norm + t), eps);
}

}  // namespace

extern "C" int crlot_ola_normalized(const float* frames, const float* norm,
                                    float* out, int batch, int n_frames,
                                    int nfft, int hop, int out_len, float eps,
                                    void* stream) {
  const int threads = 256;
  dim3 grid((out_len + threads - 1) / threads, batch);
  ola_normalized_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      frames, norm, out, n_frames, nfft, hop, out_len, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* crlot_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
