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
// Bound on the H100: the bytes, 8 bytes a pixel read (tu, tv) and 4 C
// written, plus the texels the pixels touch (at most the texture, read
// from L2 after its first touch).
//
// Design: each thread samples PX = 4 neighbouring pixels, so its uv come
// in as one 16-byte load of tu and one of tv and each channel goes out as
// one 16-byte store, with the pixels' 16 texel gathers in flight at once
// (read-only path). Indices are 32-bit inside a plane and a texture; the
// launcher refuses larger ones. C == 1, the fit's texture, is its own
// instantiation; other channel counts unroll the channel loop. A
// power-of-two size wraps with a mask (i & (n - 1) equals the remainder
// wrap for every int i, negative ones too, in two's complement), other
// sizes with wrap(). Where tu, tv or out are not 16-byte aligned, or a
// channel plane would not be (C > 1 and n_px % 4 != 0), the same kernel
// runs one pixel a thread with scalar loads; with C == 1 the last
// n_px % 4 pixels form a scalar tail. Every pixel keeps the arithmetic
// order of K1's texture tail (csrc/fused_raster.cu; built with -fmad=false
// as K1), so K7's wrap output equals K1's colour planes on the same uv bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PX = 4;                 // pixels a thread on the vector path

enum Mode { WRAP = 0, WRAP_POW2 = 1, CLAMP = 2 };

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

template <int MODE>
__device__ __forceinline__ int tex_idx(int i, int n) {
  if (MODE == CLAMP) return min(max(i, 0), n - 1);
  if (MODE == WRAP_POW2) return i & (n - 1);
  return wrap(i, n);
}

// One pixel's four texel offsets (in texels) and its two fractions.
struct Tap {
  int o00, o01, o10, o11;
  float fs, ft;
};

template <int MODE>
__device__ __forceinline__ Tap tap(float u, float v, int th, int tw) {
  const float s = u * (float)tw - 0.5f;
  const float t = v * (float)th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  Tap q;
  q.fs = s - s0f;
  q.ft = t - t0f;
  const int s0 = (int)s0f;
  const int t0 = (int)t0f;
  const int s1i = tex_idx<MODE>(s0 + 1, tw);
  const int t1i = tex_idx<MODE>(t0 + 1, th);
  const int s0i = tex_idx<MODE>(s0, tw);
  const int t0i = tex_idx<MODE>(t0, th);
  q.o00 = t0i * tw + s0i;
  q.o01 = t0i * tw + s1i;
  q.o10 = t1i * tw + s0i;
  q.o11 = t1i * tw + s1i;
  return q;
}

// Channel c of one pixel, in K1's order.
__device__ __forceinline__ float sample(const float* __restrict__ tex,
                                        const Tap& q, int nchan, int c) {
  const float c00 = __ldg(&tex[q.o00 * nchan + c]);
  const float c01 = __ldg(&tex[q.o01 * nchan + c]);
  const float c10 = __ldg(&tex[q.o10 * nchan + c]);
  const float c11 = __ldg(&tex[q.o11 * nchan + c]);
  const float top = c00 * (1.f - q.fs) + c01 * q.fs;
  const float bot = c10 * (1.f - q.fs) + c11 * q.fs;
  return top * (1.f - q.ft) + bot * q.ft;
}

// NC: the channel count where it is fixed at 1, else 0 (read nchan).
template <int MODE, int NC, bool VEC>
__global__ void __launch_bounds__(THREADS)
texture_fwd_kernel(const float* __restrict__ tex, const float* __restrict__ tu,
                   const float* __restrict__ tv, int n_px, int th, int tw,
                   int nchan_arg, float* __restrict__ out) {
  const int nchan = NC ? NC : nchan_arg;
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (VEC && (g + 1) * PX <= n_px) {
    const float4 u4 = __ldg(reinterpret_cast<const float4*>(tu) + g);
    const float4 v4 = __ldg(reinterpret_cast<const float4*>(tv) + g);
    const Tap q0 = tap<MODE>(u4.x, v4.x, th, tw);
    const Tap q1 = tap<MODE>(u4.y, v4.y, th, tw);
    const Tap q2 = tap<MODE>(u4.z, v4.z, th, tw);
    const Tap q3 = tap<MODE>(u4.w, v4.w, th, tw);
#pragma unroll 4
    for (int c = 0; c < nchan; ++c) {
      float4 r;
      r.x = sample(tex, q0, nchan, c);
      r.y = sample(tex, q1, nchan, c);
      r.z = sample(tex, q2, nchan, c);
      r.w = sample(tex, q3, nchan, c);
      reinterpret_cast<float4*>(out + (size_t)c * n_px)[g] = r;
    }
    return;
  }
  // one pixel a thread; on the vector path, the scalar tail of C == 1
  const int p = VEC ? g * PX : g;
  const int end = VEC ? min(p + PX, n_px) : min(p + 1, n_px);
  for (int i = p; i < end; ++i) {
    const Tap q = tap<MODE>(__ldg(&tu[i]), __ldg(&tv[i]), th, tw);
#pragma unroll 4
    for (int c = 0; c < nchan; ++c)
      out[(size_t)c * n_px + i] = sample(tex, q, nchan, c);
  }
}

template <int MODE, int NC>
void launch(bool vec, const float* tex, const float* tu, const float* tv,
            int n_px, int th, int tw, int nchan, float* out,
            cudaStream_t st) {
  const int per = vec ? PX : 1;
  const int threads = (n_px + per - 1) / per;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (vec)
    texture_fwd_kernel<MODE, NC, true><<<blocks, THREADS, 0, st>>>(
        tex, tu, tv, n_px, th, tw, nchan, out);
  else
    texture_fwd_kernel<MODE, NC, false><<<blocks, THREADS, 0, st>>>(
        tex, tu, tv, n_px, th, tw, nchan, out);
}

template <int MODE>
void launch_mode(bool vec, const float* tex, const float* tu,
                 const float* tv, int n_px, int th, int tw, int nchan,
                 float* out, cudaStream_t st) {
  if (nchan == 1)
    launch<MODE, 1>(vec, tex, tu, tv, n_px, th, tw, nchan, out, st);
  else
    launch<MODE, 0>(vec, tex, tu, tv, n_px, th, tw, nchan, out, st);
}

bool pow2(int n) { return (n & (n - 1)) == 0; }

}  // namespace

extern "C" int texture_fwd_launch(const float* tex, const float* tu,
                                  const float* tv, int64_t n_px, int th,
                                  int tw, int nchan, int clamp, float* out,
                                  void* stream) {
  if (nchan < 1 || th < 1 || tw < 1 || n_px >= INT32_MAX ||
      (int64_t)th * tw * nchan >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_px == 0) return 0;
  const int n = (int)n_px;
  const bool vec =
      ((uintptr_t)tu % 16 == 0) && ((uintptr_t)tv % 16 == 0) &&
      ((uintptr_t)out % 16 == 0) && (nchan == 1 || n % PX == 0);
  cudaStream_t st = (cudaStream_t)stream;
  if (clamp)
    launch_mode<CLAMP>(vec, tex, tu, tv, n, th, tw, nchan, out, st);
  else if (pow2(th) && pow2(tw))
    launch_mode<WRAP_POW2>(vec, tex, tu, tv, n, th, tw, nchan, out, st);
  else
    launch_mode<WRAP>(vec, tex, tu, tv, n, th, tw, nchan, out, st);
  return (int)cudaGetLastError();
}
