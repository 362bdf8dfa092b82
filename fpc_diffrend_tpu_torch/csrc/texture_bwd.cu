// K4: backward of the bilinear wrap texture sample over the stacked image.
//
// Replaces fpc_diffrend_tpu/ops/pallas/texture_tpu.py _bwd_kernel
// (launched by texture_planes_bwd_impl). What it computes is the
// autodiff of the XLA sampler fpc_diffrend_tpu/ops/texture.py _bilinear in
// wrap mode, written out (plain version: texture_planes_bwd_plain in
// ops/cuda/texture_cuda.py, operand for operand):
//   top = c00 (1 - fs) + c01 fs, bot = c10 (1 - fs) + c11 fs,
//   out = top (1 - ft) + bot ft, with s = u * TW - 0.5, fs = s - floor(s)
//   gtex[t0, s0] += g (1 - ft) (1 - fs), ... (the 4 texel shares)
//   gs = sum_c g (1 - ft) (c01 - c00) + g ft (c11 - c10), gtu = gs * TW
//   gt = sum_c g (bot - top),                              gtv = gt * TH
// The TPU kernel reads the texture from a VMEM-resident patch and zeroes
// the coordinate gradient where its 256-column patch or SUB_H-row band
// clamps (s_in/t_in); that is a layout artefact, and this kernel follows
// the XLA reference instead.
//
// Design: one thread per pixel. A pixel whose cotangent is 0 in every
// channel writes gtu = gtv = 0 and stops. Every other pixel adds its 4 * C
// texel shares into gtex with atomicAdd (red.global.add.f32; gtex is
// zeroed by this entry point first) and writes its own gtu and gtv. Pixels
// are not masked by id: a missed pixel samples uv (0, 0), and K3 gives it
// a colour cotangent where K2 blended against that colour.
//
// Bound on the H100: the bytes, 12 bytes a pixel read (tu, tv, C = 1
// cotangent) and 8 written (gtu, gtv), plus the 4 MB texture read and
// 4 MB gtex written at 1024^2. The atomics spread over ~1 M texels, about
// 16 pixels of the stacked batch per texel, so they contend little.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(THREADS)
texture_bwd_kernel(const float* __restrict__ tex, const float* __restrict__ tu,
                   const float* __restrict__ tv,
                   const float* __restrict__ gcolour, int64_t plane, int th,
                   int tw, int nchan, float* __restrict__ gtex,
                   float* __restrict__ gtu, float* __restrict__ gtv) {
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
  const float s = tu[p] * (float)tw - 0.5f;
  const float t = tv[p] * (float)th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  const float fs = s - s0f;
  const float ft = t - t0f;
  const int s0 = (int)s0f;
  const int t0 = (int)t0f;
  const int64_t i00 = (int64_t)wrap(t0, th) * tw + wrap(s0, tw);
  const int64_t i01 = (int64_t)wrap(t0, th) * tw + wrap(s0 + 1, tw);
  const int64_t i10 = (int64_t)wrap(t0 + 1, th) * tw + wrap(s0, tw);
  const int64_t i11 = (int64_t)wrap(t0 + 1, th) * tw + wrap(s0 + 1, tw);
  float gs = 0.f, gt = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c >= nchan) continue;
    const float c00 = tex[i00 * nchan + c];
    const float c01 = tex[i01 * nchan + c];
    const float c10 = tex[i10 * nchan + c];
    const float c11 = tex[i11 * nchan + c];
    const float top = c00 * (1.f - fs) + c01 * fs;
    const float bot = c10 * (1.f - fs) + c11 * fs;
    const float gtop = g[c] * (1.f - ft);
    const float gbot = g[c] * ft;
    gs = gs + ((gtop * c01 - gtop * c00) + (gbot * c11 - gbot * c10));
    gt = gt + (g[c] * bot - g[c] * top);
    atomicAdd(&gtex[i00 * nchan + c], gtop * (1.f - fs));
    atomicAdd(&gtex[i01 * nchan + c], gtop * fs);
    atomicAdd(&gtex[i10 * nchan + c], gbot * (1.f - fs));
    atomicAdd(&gtex[i11 * nchan + c], gbot * fs);
  }
  gtu[p] = gs * (float)tw;
  gtv[p] = gt * (float)th;
}

}  // namespace

extern "C" int texture_bwd_launch(const float* tex, const float* tu,
                                  const float* tv, const float* gcolour,
                                  int rows, int pw, int th, int tw, int nchan,
                                  float* gtex, float* gtu, float* gtv,
                                  void* stream) {
  if (nchan < 1 || nchan > MAX_C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      gtex, 0, (size_t)th * tw * nchan * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)rows * pw;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  texture_bwd_kernel<<<blocks, THREADS, 0, st>>>(
      tex, tu, tv, gcolour, n, th, tw, nchan, gtex, gtu, gtv);
  return (int)cudaGetLastError();
}
