// K8 and K9: trilinear mipmap sampling of the stacked image, and its VJP.
//
// Replaces fpc_diffrend_tpu/ops/pallas/texture_mip_tpu.py _mip_fwd_kernel
// (K8, launched by _mip_fwd_impl) and _mip_bwd_kernel (K9, launched by
// _mip_vjp_bwd). Ported is what they compute, not their TPU layout: the
// packed pyramid with wrap aprons, the per-tile patch windows, the
// scalar-prefetched (tile, level) liveness and the hat-matrix matmuls are
// VMEM workarounds and are gone. Plain versions: mip_sample_plain and
// mip_sample_bwd_plain in ops/cuda/texture_mip_cuda.py, operand for operand.
//
// The pyramid is one flat (n_texels, C) buffer: level l is (th_l, tw_l, C)
// row-major at texel row off_l (at most 16 levels, passed by value as a
// __grid_constant__ parameter, so a per-pixel level index reads it in
// place).
//
// K8, per pixel: lam is clamped to [0, L - 1], lo = floor(lam) and
// frac = lam - lo; the bilinear wrap sample of level lo (s = u * tw_l - 0.5,
// floor, wrap, ops/texture.py _bilinear's order) weighs 1 - frac, and that
// of level lo + 1 weighs frac where lo + 1 < L and frac > 0.
//
// K9, per pixel: the VJP of K8 with lam held constant, as the autodiff of
// the XLA trilinear sampler (ops/texture.py texture) gives it. For each
// live level with weight w, gl = w * g; the four texel shares of gl go
// into the gradient pyramid with atomicAdd (red.global.add.f32; zeroed by
// the entry point first), and the weight derivatives times tw_l / th_l
// (the 2^-l chain factor of the TPU kernel, exact for power-of-two sides)
// add to gtu / gtv. The TPU kernel also zeroes the uv gradient where its
// VMEM patch clamps (s_in / t_in); that is a layout artefact, and this
// kernel follows the XLA reference instead, as K4 does. A pixel whose
// cotangent is 0 in every channel writes gtu = gtv = 0 and stops.
//
// Design: one thread per pixel, no shared memory. The pyramid of a 1024^2
// one-channel texture is 5.6 MB and stays in the 50 MB L2, so the taps are
// L2 hits; neighbouring pixels read neighbouring texels.
//
// Bound on the H100: the bytes. K8 reads tu, tv, lam (12 B a pixel) and
// writes C planes (4 B each), plus the pyramid once; K9 reads C cotangent
// planes, tu, tv, lam and writes gtu, gtv (20 + 4 C B a pixel), plus the
// pyramid read and the gradient pyramid written. ~2 levels x 4 taps x
// ~10 flops a pixel and channel is far below the fp32 rate. K9's atomics
// contend at coarse levels (level 6 of 1024^2 is 16 x 16 texels), but few
// pixels select them: a pixel reaches level l only at 2^l texels a pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_C = 4;
constexpr int THREADS = 256;

struct Levels {
  int n;
  int th[MAX_LEVELS];
  int tw[MAX_LEVELS];
  int off[MAX_LEVELS];   // first texel row of each level
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// The four texel rows of a bilinear wrap sample at level l, and its
// fractions.
struct Taps {
  int64_t i00, i01, i10, i11;
  float fs, ft;
  int th, tw;
};

__device__ __forceinline__ Taps taps(const Levels& lv, int l, float u,
                                     float v) {
  Taps k;
  k.th = lv.th[l];
  k.tw = lv.tw[l];
  const float s = u * (float)k.tw - 0.5f;
  const float t = v * (float)k.th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  k.fs = s - s0f;
  k.ft = t - t0f;
  const int s0 = (int)s0f;
  const int t0 = (int)t0f;
  const int64_t r0 = (int64_t)lv.off[l] + (int64_t)wrap(t0, k.th) * k.tw;
  const int64_t r1 = (int64_t)lv.off[l] + (int64_t)wrap(t0 + 1, k.th) * k.tw;
  const int q0 = wrap(s0, k.tw);
  const int q1 = wrap(s0 + 1, k.tw);
  k.i00 = r0 + q0;
  k.i01 = r0 + q1;
  k.i10 = r1 + q0;
  k.i11 = r1 + q1;
  return k;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ pyr,
                                          const Taps& k, int nchan, int c) {
  const float c00 = pyr[k.i00 * nchan + c];
  const float c01 = pyr[k.i01 * nchan + c];
  const float c10 = pyr[k.i10 * nchan + c];
  const float c11 = pyr[k.i11 * nchan + c];
  const float top = c00 * (1.f - k.fs) + c01 * k.fs;
  const float bot = c10 * (1.f - k.fs) + c11 * k.fs;
  return top * (1.f - k.ft) + bot * k.ft;
}

// lo = floor(lam clamped to [0, n - 1]) and its fraction; whether level
// lo + 1 takes part.
__device__ __forceinline__ bool pick(float lam, int n, int& lo,
                                     float& frac) {
  const float lc = fminf(fmaxf(lam, 0.f), (float)(n - 1));
  const float lof = floorf(lc);
  lo = (int)lof;
  frac = lc - lof;
  return lo + 1 < n && frac > 0.f;
}

__global__ void __launch_bounds__(THREADS)
mip_fwd_kernel(const float* __restrict__ pyr, const float* __restrict__ tu,
               const float* __restrict__ tv, const float* __restrict__ lam,
               int64_t plane, const __grid_constant__ Levels lv, int nchan,
               float* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  int lo;
  float frac;
  const bool hi = pick(lam[p], lv.n, lo, frac);
  const float u = tu[p];
  const float v = tv[p];
  const Taps a = taps(lv, lo, u, v);
  Taps b = a;
  if (hi) b = taps(lv, lo + 1, u, v);
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c >= nchan) break;
    float r = bilinear(pyr, a, nchan, c) * (1.f - frac);
    if (hi) r = r + bilinear(pyr, b, nchan, c) * frac;
    out[c * plane + p] = r;
  }
}

__global__ void __launch_bounds__(THREADS)
mip_bwd_kernel(const float* __restrict__ pyr, const float* __restrict__ tu,
               const float* __restrict__ tv, const float* __restrict__ lam,
               const float* __restrict__ gcolour, int64_t plane,
               const __grid_constant__ Levels lv, int nchan,
               float* __restrict__ gpyr, float* __restrict__ gtu,
               float* __restrict__ gtv) {
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  float g[MAX_C];
  bool live = false;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    g[c] = c < nchan ? gcolour[c * plane + p] : 0.f;
    live = live || g[c] != 0.f;
  }
  if (!live) {
    gtu[p] = 0.f;
    gtv[p] = 0.f;
    return;
  }
  int lo;
  float frac;
  const bool hi = pick(lam[p], lv.n, lo, frac);
  const float u = tu[p];
  const float v = tv[p];
  float gu = 0.f, gv = 0.f;
  for (int k = 0; k < 2; ++k) {
    if (k == 1 && !hi) break;
    const float w = k == 0 ? 1.f - frac : frac;
    const Taps t = taps(lv, lo + k, u, v);
    float gs = 0.f, gt = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c >= nchan) break;
      const float c00 = pyr[t.i00 * nchan + c];
      const float c01 = pyr[t.i01 * nchan + c];
      const float c10 = pyr[t.i10 * nchan + c];
      const float c11 = pyr[t.i11 * nchan + c];
      const float top = c00 * (1.f - t.fs) + c01 * t.fs;
      const float bot = c10 * (1.f - t.fs) + c11 * t.fs;
      const float gl = g[c] * w;
      const float gtop = gl * (1.f - t.ft);
      const float gbot = gl * t.ft;
      gs = gs + ((gtop * c01 - gtop * c00) + (gbot * c11 - gbot * c10));
      gt = gt + (gl * bot - gl * top);
      atomicAdd(&gpyr[t.i00 * nchan + c], gtop * (1.f - t.fs));
      atomicAdd(&gpyr[t.i01 * nchan + c], gtop * t.fs);
      atomicAdd(&gpyr[t.i10 * nchan + c], gbot * (1.f - t.fs));
      atomicAdd(&gpyr[t.i11 * nchan + c], gbot * t.fs);
    }
    gu = gu + gs * (float)t.tw;
    gv = gv + gt * (float)t.th;
  }
  gtu[p] = gu;
  gtv[p] = gv;
}

// Levels from the host arrays; false if they are out of range.
bool make_levels(int nlev, const int* th, const int* tw, const int* off,
                 Levels& lv) {
  if (nlev < 1 || nlev > MAX_LEVELS) return false;
  lv.n = nlev;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.th[l] = l < nlev ? th[l] : 1;
    lv.tw[l] = l < nlev ? tw[l] : 1;
    lv.off[l] = l < nlev ? off[l] : 0;
    if (lv.th[l] < 1 || lv.tw[l] < 1) return false;
  }
  return true;
}

}  // namespace

extern "C" int mip_fwd_launch(const float* pyr, const float* tu,
                              const float* tv, const float* lam, int rows,
                              int pw, int nlev, const int* th, const int* tw,
                              const int* off, int nchan, float* out,
                              void* stream) {
  Levels lv;
  if (nchan < 1 || nchan > MAX_C || !make_levels(nlev, th, tw, off, lv))
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * pw;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  mip_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      pyr, tu, tv, lam, n, lv, nchan, out);
  return (int)cudaGetLastError();
}

extern "C" int mip_bwd_launch(const float* pyr, const float* tu,
                              const float* tv, const float* lam,
                              const float* gcolour, int rows, int pw,
                              int nlev, const int* th, const int* tw,
                              const int* off, int nchan, int n_texels,
                              float* gpyr, float* gtu, float* gtv,
                              void* stream) {
  Levels lv;
  if (nchan < 1 || nchan > MAX_C || !make_levels(nlev, th, tw, off, lv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      gpyr, 0, (size_t)n_texels * nchan * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)rows * pw;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  mip_bwd_kernel<<<blocks, THREADS, 0, st>>>(pyr, tu, tv, lam, gcolour, n,
                                             lv, nchan, gpyr, gtu, gtv);
  return (int)cudaGetLastError();
}
