// K4: backward of the bilinear texture sample (K1's tail, K7), wrap or
// clamp.
//
// Replaces fpc_diffrend_tpu/ops/pallas/texture_tpu.py _bwd_kernel
// (launched by texture_planes_bwd_impl and _texture_vjp_bwd). What it
// computes is the autodiff of the XLA sampler
// fpc_diffrend_tpu/ops/texture.py _bilinear, written out (plain version:
// texture_planes_bwd_plain in ops/cuda/texture_cuda.py, operand for
// operand), the four texel indices wrapped or clamped as the forward's:
//   top = c00 (1 - fs) + c01 fs, bot = c10 (1 - fs) + c11 fs,
//   out = top (1 - ft) + bot ft, with s = u * TW - 0.5, fs = s - floor(s)
//   gtex[t0, s0] += g (1 - ft) (1 - fs), ... (the 4 texel shares)
//   gs = sum_c g (1 - ft) (c01 - c00) + g ft (c11 - c10), gtu = gs * TW
//   gt = sum_c g (bot - top),                              gtv = gt * TH
// The TPU kernel reads the texture from a VMEM-resident patch and zeroes
// the coordinate gradient where its 256-column patch or SUB_H-row band
// clamps (s_in/t_in), and in clamp mode gates it past the clipped
// coordinate; these are layout artefacts, and this kernel follows the XLA
// reference instead (in clamp mode the two taps of an edge texel coincide,
// so the coordinate gradient there is 0 by the formula).
//
// What binds it on the H100 (chip_turns.py and chip_smoke.py phase 6 at
// the bench batch; PERF.md keeps the measurements): the memory system's
// service of its loads and of its reductions into gtex, each by the 32-byte
// sectors a warp instruction touches, more than the count of reductions;
// so each warp instruction covers 32 neighbouring pixels, as one thread a
// pixel's would. Where many reductions land on one texel they serialize:
// a missed pixel samples uv (0, 0), and K3 gives the missed side of a
// silhouette pair a colour cotangent, so a run of missed pixels along a
// silhouette adds into the same four texels (one in clamp mode).
//
// Design:
// 1. Each thread takes PX pixels 32 apart, so a warp instruction covers 32
//    neighbouring pixels (its loads, stores and reductions coalesce as one
//    thread a pixel's do), and issues all their loads (tu, tv, the
//    cotangent) at once, then all their texel gathers (read-only path). A
//    power-of-two texture wraps with a mask (i & (n - 1) is the remainder
//    wrap for every int i in two's complement), others with wrap().
// 2. Where the live pixels (cotangent not 0 in some channel) of a warp
//    instruction all sample one unwrapped texel (t0, s0) = floor(uv * size
//    - 0.5) - a run of missed pixels at uv (0, 0), or a lone live pixel -
//    their shares are summed across the warp first: 4 * C reductions for
//    the 32 pixels, where lane pairs would put 64 * C onto those texels.
// 3. Otherwise lane pairs (2m, 2m + 1), neighbouring pixels, first sum
//    the taps they share: the odd lane hands the even one all four shares
//    where both sample one (t0, s0), its left column where it samples
//    (t0, s0 + 1); the rest go to gtex with red.global.add
//    (chip_smoke.py k4_design_reductions counts them).
// A pixel whose cotangent is 0 adds nothing and writes gtu = gtv = 0.
// Pixels are not masked by id: a missed pixel samples uv (0, 0), and K3
// gives it a colour cotangent where K2 blended against that colour. gtex
// is zeroed by this entry point first; its sums take another order from
// run to run (the stated tolerance, ATOMIC_RTOL in chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 4;
constexpr int THREADS = 256;
constexpr int PX = 4;                 // pixels a thread, 32 apart
constexpr unsigned FULL = 0xffffffffu;

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

// i + 1 in two's complement, with no undefined overflow (uv far past the
// texture gives coordinates near the int range's ends)
__device__ __forceinline__ int plus1(int i) {
  return (int)((unsigned)i + 1u);
}

// One pixel: whether its cotangent is live, the unwrapped texel (t0, s0)
// of its tap 00, and its shares to taps 00 01 10 11, channel by channel.
template <int NCH>
struct Px {
  bool live;
  int t0, s0;
  float a[4][NCH];
};

// Pixel (u, v) with cotangent g: its taps and shares into q, its uv
// cotangents into gtu, gtv.
template <int MODE, int NCH>
__device__ __forceinline__ void pixel(const float* __restrict__ tex, float u,
                                      float v, const float* g, int th, int tw,
                                      Px<NCH>& q, float& gtu, float& gtv) {
  const float s = u * (float)tw - 0.5f;
  const float t = v * (float)th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  const float fs = s - s0f;
  const float ft = t - t0f;
  q.s0 = (int)s0f;
  q.t0 = (int)t0f;
  const int r0 = tex_idx<MODE>(q.t0, th) * tw;
  const int r1 = tex_idx<MODE>(plus1(q.t0), th) * tw;
  const int c0 = tex_idx<MODE>(q.s0, tw);
  const int c1 = tex_idx<MODE>(plus1(q.s0), tw);
  float gs = 0.f, gt = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const float c00 = __ldg(&tex[(r0 + c0) * NCH + c]);
    const float c01 = __ldg(&tex[(r0 + c1) * NCH + c]);
    const float c10 = __ldg(&tex[(r1 + c0) * NCH + c]);
    const float c11 = __ldg(&tex[(r1 + c1) * NCH + c]);
    const float top = c00 * (1.f - fs) + c01 * fs;
    const float bot = c10 * (1.f - fs) + c11 * fs;
    const float gtop = g[c] * (1.f - ft);
    const float gbot = g[c] * ft;
    gs = gs + ((gtop * c01 - gtop * c00) + (gbot * c11 - gbot * c10));
    gt = gt + (g[c] * bot - g[c] * top);
    q.a[0][c] = gtop * (1.f - fs);
    q.a[1][c] = gtop * fs;
    q.a[2][c] = gbot * (1.f - fs);
    q.a[3][c] = gbot * fs;
  }
  gtu = gs * (float)tw;
  gtv = gt * (float)th;
}

// Add shares a to tap k (texel row t0 + k / 2, column s0 + k % 2) of gtex.
template <int MODE, int NCH>
__device__ __forceinline__ void emit(float* __restrict__ gtex, int t0, int s0,
                                     int k, const float* a, int th, int tw) {
  const int i = tex_idx<MODE>(k >> 1 ? plus1(t0) : t0, th) * tw +
                tex_idx<MODE>(k & 1 ? plus1(s0) : s0, tw);
#pragma unroll
  for (int c = 0; c < NCH; ++c) atomicAdd(&gtex[i * NCH + c], a[c]);
}

// Pixel j of lane l in the thread's warp w is w * 32 * PX + j * 32 + l:
// each warp instruction covers 32 neighbouring pixels.
template <int MODE, int NCH>
__global__ void __launch_bounds__(THREADS)
texture_bwd_kernel(const float* __restrict__ tex, const float* __restrict__ tu,
                   const float* __restrict__ tv,
                   const float* __restrict__ gcolour, int n_px, int th, int tw,
                   float* __restrict__ gtex, float* __restrict__ gtu,
                   float* __restrict__ gtv) {
  const int lane = threadIdx.x & 31;
  const int base =
      ((blockIdx.x * THREADS + threadIdx.x) >> 5) * 32 * PX + lane;
  // 1. every load at once, then the texel gathers, then gtu and gtv
  float u[PX], v[PX], g[PX][NCH];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int p = base + j * 32;
    const bool in = p < n_px;
    u[j] = in ? __ldg(&tu[p]) : 0.f;
    v[j] = in ? __ldg(&tv[p]) : 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      g[j][c] = in ? __ldg(&gcolour[(size_t)c * n_px + p]) : 0.f;
  }
  Px<NCH> q[PX];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int p = base + j * 32;
    q[j].live = false;
#pragma unroll
    for (int c = 0; c < NCH; ++c) q[j].live = q[j].live || g[j][c] != 0.f;
    float ou = 0.f, ov = 0.f;
    q[j].t0 = q[j].s0 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < NCH; ++c) q[j].a[k][c] = 0.f;
    if (q[j].live)
      pixel<MODE, NCH>(tex, u[j], v[j], g[j], th, tw, q[j], ou, ov);
    if (p < n_px) {
      gtu[p] = ou;
      gtv[p] = ov;
    }
  }
  // 2. the shares, 32 neighbouring pixels an instruction; where every live
  // one of them samples one (t0, s0), summed across the warp first
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const unsigned lm = __ballot_sync(FULL, q[j].live);
    if (!lm) continue;
    const int lead = __ffs(lm) - 1;
    const int lt = __shfl_sync(FULL, q[j].t0, lead);
    const int ls = __shfl_sync(FULL, q[j].s0, lead);
    if (__all_sync(FULL,
                   !q[j].live || (q[j].t0 == lt && q[j].s0 == ls))) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float a[NCH];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          a[c] = q[j].a[k][c];
#pragma unroll
          for (int o = 16; o; o >>= 1)
            a[c] += __shfl_xor_sync(FULL, a[c], o);
        }
        if (lane == lead) emit<MODE, NCH>(gtex, lt, ls, k, a, th, tw);
      }
      continue;
    }
    // 3. lane pairs (2m, 2m + 1): the odd lane hands the even one its
    // shares of the taps they both take, all four where both sample one
    // (t0, s0), its left column where it samples (t0, s0 + 1)
    const int et = __shfl_up_sync(FULL, q[j].t0, 1);
    const int es = __shfl_up_sync(FULL, q[j].s0, 1);
    const int elive = __shfl_up_sync(FULL, (int)q[j].live, 1);
    const int ot = __shfl_down_sync(FULL, q[j].t0, 1);
    const int os = __shfl_down_sync(FULL, q[j].s0, 1);
    const int olive = __shfl_down_sync(FULL, (int)q[j].live, 1);
    float from[4][NCH];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        from[k][c] = __shfl_down_sync(FULL, q[j].a[k][c], 1);
    if (!q[j].live) continue;
    if (lane & 1) {
      const bool row = elive && et == q[j].t0;
      if (row && es == q[j].s0) continue;             // all four handed on
      const bool left = row && q[j].s0 == plus1(es);  // left column handed on
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (!left || (k & 1))
          emit<MODE, NCH>(gtex, q[j].t0, q[j].s0, k, q[j].a[k], th, tw);
    } else {
      const bool row = olive && ot == q[j].t0;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (row && os == q[j].s0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) q[j].a[k][c] += from[k][c];
        } else if (row && os == plus1(q[j].s0)) {
          q[j].a[1][c] += from[0][c];
          q[j].a[3][c] += from[2][c];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        emit<MODE, NCH>(gtex, q[j].t0, q[j].s0, k, q[j].a[k], th, tw);
    }
  }
}

template <int MODE>
void launch(int nchan, cudaStream_t st, const float* tex, const float* tu,
            const float* tv, const float* gcolour, int n, int th, int tw,
            float* gtex, float* gtu, float* gtv) {
  const int warps = (n + 32 * PX - 1) / (32 * PX);
  const unsigned blocks = (unsigned)((warps * 32 + THREADS - 1) / THREADS);
  switch (nchan) {
    case 1: texture_bwd_kernel<MODE, 1><<<blocks, THREADS, 0, st>>>(
                tex, tu, tv, gcolour, n, th, tw, gtex, gtu, gtv); break;
    case 2: texture_bwd_kernel<MODE, 2><<<blocks, THREADS, 0, st>>>(
                tex, tu, tv, gcolour, n, th, tw, gtex, gtu, gtv); break;
    case 3: texture_bwd_kernel<MODE, 3><<<blocks, THREADS, 0, st>>>(
                tex, tu, tv, gcolour, n, th, tw, gtex, gtu, gtv); break;
    default: texture_bwd_kernel<MODE, 4><<<blocks, THREADS, 0, st>>>(
                 tex, tu, tv, gcolour, n, th, tw, gtex, gtu, gtv); break;
  }
}

bool pow2(int n) { return (n & (n - 1)) == 0; }

}  // namespace

extern "C" int texture_bwd_launch(const float* tex, const float* tu,
                                  const float* tv, const float* gcolour,
                                  int64_t n_px, int th, int tw, int nchan,
                                  int clamp, float* gtex, float* gtu,
                                  float* gtv, void* stream) {
  if (nchan < 1 || nchan > MAX_C || th < 1 || tw < 1 || n_px < 0 ||
      n_px >= INT32_MAX - 32 * PX || (int64_t)th * tw * nchan >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      gtex, 0, (size_t)th * tw * nchan * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int n = (int)n_px;
  if (n == 0) return 0;
  if (clamp)
    launch<CLAMP>(nchan, st, tex, tu, tv, gcolour, n, th, tw, gtex, gtu, gtv);
  else if (pow2(th) && pow2(tw))
    launch<WRAP_POW2>(nchan, st, tex, tu, tv, gcolour, n, th, tw, gtex, gtu,
                      gtv);
  else
    launch<WRAP>(nchan, st, tex, tu, tv, gcolour, n, th, tw, gtex, gtu, gtv);
  return (int)cudaGetLastError();
}
