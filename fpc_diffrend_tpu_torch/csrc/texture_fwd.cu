// K7: standalone bilinear texture sample of uv planes, wrap or clamp.
//
// Replaces fpc_diffrend_tpu/ops/pallas/texture_tpu.py _fwd_kernel
// (launched by _texture_fwd_impl and _texture_planes_fwd_impl). What it
// computes is the XLA sampler fpc_diffrend_tpu/ops/texture.py _bilinear
// (plain version: texture_planes_plain in ops/cuda/texture_cuda.py,
// ops/texture.py bilinear):
//   s = u * TW - 0.5, t = v * TH - 0.5, fs = s - floor(s), ft = t - floor(t)
//   top = c00 (1 - fs) + c01 fs, bot = c10 (1 - fs) + c11 fs,
//   out = top (1 - ft) + bot ft
// with the four texel indices wrapped (remainder) or clamped to the
// texture. The TPU kernel samples a VMEM-resident texture through hat
// matrices on the MXU, skips tiles whose uv are all (0, 0), bounds each
// tile's footprint to a texel patch and, in clamp mode, clips the
// coordinate to TW - 1.001 instead of clamping the indices; none of that
// is copied. Past the high edge the two clamps differ by at most 0.001 of
// the edge texel step.
//
// Design: one thread per pixel, four texel gathers a channel, in the
// arithmetic order of K1's texture tail (csrc/fused_raster.cu; built with
// -fmad=false as K1), so its wrap output equals K1's colour planes on the
// same uv bit for bit.
//
// Bound on the H100: the bytes, 8 bytes a pixel read (tu, tv) and 4 C
// written, plus the texels the pixels touch (at most the texture, read
// from L2 after its first touch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return min(max(i, 0), n - 1);
}

template <bool CLAMP>
__global__ void __launch_bounds__(THREADS)
texture_fwd_kernel(const float* __restrict__ tex, const float* __restrict__ tu,
                   const float* __restrict__ tv, int64_t n_px, int th, int tw,
                   int nchan, float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= n_px) return;
  const float s = tu[p] * (float)tw - 0.5f;
  const float t = tv[p] * (float)th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  const float fs = s - s0f;
  const float ft = t - t0f;
  const int s0 = (int)s0f;
  const int t0 = (int)t0f;
  const int s1i = CLAMP ? clamp_idx(s0 + 1, tw) : wrap(s0 + 1, tw);
  const int t1i = CLAMP ? clamp_idx(t0 + 1, th) : wrap(t0 + 1, th);
  const int s0i = CLAMP ? clamp_idx(s0, tw) : wrap(s0, tw);
  const int t0i = CLAMP ? clamp_idx(t0, th) : wrap(t0, th);
  for (int c = 0; c < nchan; ++c) {
    const float c00 = tex[((int64_t)t0i * tw + s0i) * nchan + c];
    const float c01 = tex[((int64_t)t0i * tw + s1i) * nchan + c];
    const float c10 = tex[((int64_t)t1i * tw + s0i) * nchan + c];
    const float c11 = tex[((int64_t)t1i * tw + s1i) * nchan + c];
    const float top = c00 * (1.f - fs) + c01 * fs;
    const float bot = c10 * (1.f - fs) + c11 * fs;
    out[c * n_px + p] = top * (1.f - ft) + bot * ft;
  }
}

}  // namespace

extern "C" int texture_fwd_launch(const float* tex, const float* tu,
                                  const float* tv, int64_t n_px, int th,
                                  int tw, int nchan, int clamp, float* out,
                                  void* stream) {
  if (nchan < 1) return (int)cudaErrorInvalidValue;
  if (n_px == 0) return 0;
  const unsigned blocks = (unsigned)((n_px + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (clamp)
    texture_fwd_kernel<true><<<blocks, THREADS, 0, st>>>(tex, tu, tv, n_px,
                                                         th, tw, nchan, out);
  else
    texture_fwd_kernel<false><<<blocks, THREADS, 0, st>>>(tex, tu, tv, n_px,
                                                          th, tw, nchan, out);
  return (int)cudaGetLastError();
}
