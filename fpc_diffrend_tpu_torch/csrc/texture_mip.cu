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
// into the gradient pyramid (zeroed by the entry point first), and the
// weight derivatives times tw_l / th_l (the 2^-l chain factor of the TPU
// kernel, exact for power-of-two sides) add to gtu / gtv. The TPU kernel
// also zeroes the uv gradient where its VMEM patch clamps (s_in / t_in);
// that is a layout artefact, and this kernel follows the XLA reference
// instead, as K4 does. A pixel whose cotangent is 0 in every channel
// writes gtu = gtv = 0 and adds nothing.
//
// What binds them on the H100 (chip_smoke.py phase 6 and chip_turns.py at
// the bench-mip batch, 16.4 M pixels of one channel; PERF.md keeps the
// measurements): the bytes of the planes, 16 a pixel for K8 and 20 for K9,
// and for K9 the memory system's service of its reductions into the
// gradient pyramid, as for K4 (csrc/texture_bwd.cu): without them it
// takes about half its time. The pyramid (5.6 MB for a one-channel 1024^2
// chain) and its gradient stay in the 50 MB L2. The fit magnifies its
// texture: 99.5 % of the live pixels take level 0 (lam < 0 clamps there
// with frac = 0), none a level past 2, and a tenth blend a second level,
// along the silhouette. The parent design lost a third of K8's time to the
// remainder by a divisor known only at run time; K9 runs fastest with one
// pixel a thread (four pixels 32 apart, K4's layout, hold twice the
// registers and take 0.07 ms longer at the bench-mip batch).
//
// Design of K8 (K7's, csrc/texture_fwd.cu): each thread samples PX = 4
// neighbouring pixels, so tu, tv and lam come in as one 16-byte load each
// and each channel goes out as one 16-byte store, with the pixels' level
// lo gathers in flight at once (read-only path); level lo + 1's taps are
// computed where they are sampled, for the pixels that blend it. Where a
// plane is not 16-byte aligned, or a channel plane would not be (C > 1 and
// n_px % 4 != 0), the same kernel runs one pixel a thread; with C == 1
// the last n_px % 4 pixels form a scalar tail. C == 1 is its own
// instantiation. Every pixel keeps the plain version's arithmetic order
// (built with -fmad=false), so K8 equals it bit for bit.
//
// Design of K9 (K4's reductions, one pixel a thread): a warp instruction
// covers 32 neighbouring pixels, so its loads and reductions coalesce; all
// of a pixel's loads (the cotangent, tu, tv, lam) are issued at once, then
// its level lo gathers (slot 0), then, where a pixel of the warp blends
// level lo + 1, that level's, its inputs read again (slot 1). In each
// slot, where the live pixels of a warp instruction all sample one
// unwrapped texel (level, t0, s0) - a run of missed pixels at uv (0, 0) -
// their shares are summed across the warp first; otherwise lane pairs
// (2m, 2m + 1) first sum the taps they share at one level (chip_smoke.py
// k9_design_reductions counts what reaches device memory), and the rest go
// to the gradient pyramid with red.global.add. Its sums take another order
// from run to run (the stated tolerance, ATOMIC_RTOL in chip_smoke.py);
// gtu and gtv are each pixel's own sums, in the plain version's order.
//
// Both: indices are 32-bit inside a plane and the pyramid (the launchers
// refuse larger ones); a chain of power-of-two levels wraps with a mask
// (i & (n - 1) is the remainder wrap for every int i in two's
// complement), other chains with wrap().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int MAX_C = 4;
constexpr int THREADS = 256;
constexpr int PX = 4;                 // K8: neighbouring pixels a thread
constexpr unsigned FULL = 0xffffffffu;

enum Mode { WRAP = 0, WRAP_POW2 = 1 };

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

template <int MODE>
__device__ __forceinline__ int tex_idx(int i, int n) {
  if (MODE == WRAP_POW2) return i & (n - 1);
  return wrap(i, n);
}

// i + 1 in two's complement, with no undefined overflow (uv far past the
// texture gives coordinates near the int range's ends)
__device__ __forceinline__ int plus1(int i) {
  return (int)((unsigned)i + 1u);
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

// One bilinear wrap sample at level l: its unwrapped texel (t0, s0), its
// four texel rows in the pyramid (00 01 10 11) and its fractions.
struct Tap {
  int t0, s0;
  int i00, i01, i10, i11;
  float fs, ft;
};

template <int MODE>
__device__ __forceinline__ Tap tap(const Levels& lv, int l, float u,
                                   float v) {
  const int th = lv.th[l];
  const int tw = lv.tw[l];
  const float s = u * (float)tw - 0.5f;
  const float t = v * (float)th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  Tap q;
  q.fs = s - s0f;
  q.ft = t - t0f;
  q.s0 = (int)s0f;
  q.t0 = (int)t0f;
  const int r0 = lv.off[l] + tex_idx<MODE>(q.t0, th) * tw;
  const int r1 = lv.off[l] + tex_idx<MODE>(plus1(q.t0), th) * tw;
  const int c0 = tex_idx<MODE>(q.s0, tw);
  const int c1 = tex_idx<MODE>(plus1(q.s0), tw);
  q.i00 = r0 + c0;
  q.i01 = r0 + c1;
  q.i10 = r1 + c0;
  q.i11 = r1 + c1;
  return q;
}

__device__ __forceinline__ float bilinear(const float* __restrict__ pyr,
                                          const Tap& q, int nchan, int c) {
  const float c00 = __ldg(&pyr[q.i00 * nchan + c]);
  const float c01 = __ldg(&pyr[q.i01 * nchan + c]);
  const float c10 = __ldg(&pyr[q.i10 * nchan + c]);
  const float c11 = __ldg(&pyr[q.i11 * nchan + c]);
  const float top = c00 * (1.f - q.fs) + c01 * q.fs;
  const float bot = c10 * (1.f - q.fs) + c11 * q.fs;
  return top * (1.f - q.ft) + bot * q.ft;
}

// ---- K8 ----

// One pixel: its taps at level lo, and what level lo + 1's need where it
// blends that level (computed where they are sampled, so that a thread's
// four pixels hold one level's taps each).
struct Trilinear {
  Tap a;
  float u, v, frac;
  int lo;
  bool hi;
};

template <int MODE>
__device__ __forceinline__ Trilinear trilinear(const Levels& lv, float u,
                                               float v, float lam) {
  Trilinear p;
  p.hi = pick(lam, lv.n, p.lo, p.frac);
  p.a = tap<MODE>(lv, p.lo, u, v);
  p.u = u;
  p.v = v;
  return p;
}

template <int MODE>
__device__ __forceinline__ float mip_channel(const float* __restrict__ pyr,
                                             const Levels& lv,
                                             const Trilinear& p, int nchan,
                                             int c) {
  float r = bilinear(pyr, p.a, nchan, c) * (1.f - p.frac);
  if (p.hi)
    r = r + bilinear(pyr, tap<MODE>(lv, p.lo + 1, p.u, p.v), nchan, c) *
                p.frac;
  return r;
}

// NC: the channel count where it is fixed at 1, else 0 (read nchan).
template <int MODE, int NC, bool VEC>
__global__ void __launch_bounds__(THREADS)
mip_fwd_kernel(const float* __restrict__ pyr, const float* __restrict__ tu,
               const float* __restrict__ tv, const float* __restrict__ lam,
               int n_px, const __grid_constant__ Levels lv, int nchan_arg,
               float* __restrict__ out) {
  const int nchan = NC ? NC : nchan_arg;
  const int g = blockIdx.x * THREADS + threadIdx.x;
  if (VEC && (g + 1) * PX <= n_px) {
    const float4 u4 = __ldg(reinterpret_cast<const float4*>(tu) + g);
    const float4 v4 = __ldg(reinterpret_cast<const float4*>(tv) + g);
    const float4 l4 = __ldg(reinterpret_cast<const float4*>(lam) + g);
    const Trilinear p0 = trilinear<MODE>(lv, u4.x, v4.x, l4.x);
    const Trilinear p1 = trilinear<MODE>(lv, u4.y, v4.y, l4.y);
    const Trilinear p2 = trilinear<MODE>(lv, u4.z, v4.z, l4.z);
    const Trilinear p3 = trilinear<MODE>(lv, u4.w, v4.w, l4.w);
#pragma unroll 4
    for (int c = 0; c < nchan; ++c) {
      float4 r;
      r.x = mip_channel<MODE>(pyr, lv, p0, nchan, c);
      r.y = mip_channel<MODE>(pyr, lv, p1, nchan, c);
      r.z = mip_channel<MODE>(pyr, lv, p2, nchan, c);
      r.w = mip_channel<MODE>(pyr, lv, p3, nchan, c);
      reinterpret_cast<float4*>(out + (size_t)c * n_px)[g] = r;
    }
    return;
  }
  // one pixel a thread; on the vector path, the scalar tail of C == 1
  const int p = VEC ? g * PX : g;
  const int end = VEC ? min(p + PX, n_px) : min(p + 1, n_px);
  for (int i = p; i < end; ++i) {
    const Trilinear q =
        trilinear<MODE>(lv, __ldg(&tu[i]), __ldg(&tv[i]), __ldg(&lam[i]));
#pragma unroll 1
    for (int c = 0; c < nchan; ++c)
      out[(size_t)c * n_px + i] = mip_channel<MODE>(pyr, lv, q, nchan, c);
  }
}

// ---- K9 ----

// One pixel in one level slot: whether it samples there, the level and
// unwrapped texel (t0, s0) of its tap 00, and its shares to taps 00 01 10
// 11, channel by channel.
template <int NCH>
struct Px {
  bool live;
  int lvl, t0, s0;
  float a[4][NCH];
};

// q taking part where live, with no shares yet.
template <int NCH>
__device__ __forceinline__ void init(Px<NCH>& q, bool live) {
  q.live = live;
  q.lvl = q.t0 = q.s0 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < NCH; ++c) q.a[k][c] = 0.f;
}

// Pixel (u, v) at level l with cotangent g * w: its taps and shares into
// q, its uv cotangents added to gu, gv (the plain version's order).
template <int MODE, int NCH>
__device__ __forceinline__ void pixel(const float* __restrict__ pyr,
                                      const Levels& lv, int l, float u,
                                      float v, const float* g, float w,
                                      Px<NCH>& q, float& gu, float& gv) {
  const Tap t = tap<MODE>(lv, l, u, v);
  q.lvl = l;
  q.t0 = t.t0;
  q.s0 = t.s0;
  float gs = 0.f, gt = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const float c00 = __ldg(&pyr[t.i00 * NCH + c]);
    const float c01 = __ldg(&pyr[t.i01 * NCH + c]);
    const float c10 = __ldg(&pyr[t.i10 * NCH + c]);
    const float c11 = __ldg(&pyr[t.i11 * NCH + c]);
    const float top = c00 * (1.f - t.fs) + c01 * t.fs;
    const float bot = c10 * (1.f - t.fs) + c11 * t.fs;
    const float gl = g[c] * w;
    const float gtop = gl * (1.f - t.ft);
    const float gbot = gl * t.ft;
    gs = gs + ((gtop * c01 - gtop * c00) + (gbot * c11 - gbot * c10));
    gt = gt + (gl * bot - gl * top);
    q.a[0][c] = gtop * (1.f - t.fs);
    q.a[1][c] = gtop * t.fs;
    q.a[2][c] = gbot * (1.f - t.fs);
    q.a[3][c] = gbot * t.fs;
  }
  gu = gu + gs * (float)lv.tw[l];
  gv = gv + gt * (float)lv.th[l];
}

// Add shares a to tap k (texel row t0 + k / 2, column s0 + k % 2) of level
// l of the gradient pyramid.
template <int MODE, int NCH>
__device__ __forceinline__ void emit(float* __restrict__ gpyr,
                                     const Levels& lv, int l, int t0, int s0,
                                     int k, const float* a) {
  const int th = lv.th[l];
  const int tw = lv.tw[l];
  const int i = lv.off[l] + tex_idx<MODE>(k >> 1 ? plus1(t0) : t0, th) * tw +
                tex_idx<MODE>(k & 1 ? plus1(s0) : s0, tw);
#pragma unroll
  for (int c = 0; c < NCH; ++c) atomicAdd(&gpyr[i * NCH + c], a[c]);
}

// The shares of one warp instruction's 32 neighbouring pixels in one slot
// into the gradient pyramid: summed across the warp where every live one
// samples one (level, t0, s0), else lane pairs (2m, 2m + 1) first sum the
// taps they share at one level: the odd lane hands the even one all four
// where both sample one (t0, s0), its left column where it samples
// (t0, s0 + 1).
template <int MODE, int NCH>
__device__ __forceinline__ void reduce(float* __restrict__ gpyr,
                                       const Levels& lv, Px<NCH>& q,
                                       int lane) {
  const unsigned lm = __ballot_sync(FULL, q.live);
  if (!lm) return;
  const int lead = __ffs(lm) - 1;
  const int ll = __shfl_sync(FULL, q.lvl, lead);
  const int lt = __shfl_sync(FULL, q.t0, lead);
  const int ls = __shfl_sync(FULL, q.s0, lead);
  if (__all_sync(FULL, !q.live || (q.lvl == ll && q.t0 == lt &&
                                   q.s0 == ls))) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float a[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        a[c] = q.a[k][c];
#pragma unroll
        for (int o = 16; o; o >>= 1) a[c] += __shfl_xor_sync(FULL, a[c], o);
      }
      if (lane == lead) emit<MODE, NCH>(gpyr, lv, ll, lt, ls, k, a);
    }
    return;
  }
  const int el = __shfl_up_sync(FULL, q.lvl, 1);
  const int et = __shfl_up_sync(FULL, q.t0, 1);
  const int es = __shfl_up_sync(FULL, q.s0, 1);
  const int elive = __shfl_up_sync(FULL, (int)q.live, 1);
  const int ol = __shfl_down_sync(FULL, q.lvl, 1);
  const int ot = __shfl_down_sync(FULL, q.t0, 1);
  const int os = __shfl_down_sync(FULL, q.s0, 1);
  const int olive = __shfl_down_sync(FULL, (int)q.live, 1);
  float from[4][NCH];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      from[k][c] = __shfl_down_sync(FULL, q.a[k][c], 1);
  if (!q.live) return;
  if (lane & 1) {
    const bool row = elive && el == q.lvl && et == q.t0;
    if (row && es == q.s0) return;                  // all four handed on
    const bool left = row && q.s0 == plus1(es);     // left column handed on
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (!left || (k & 1))
        emit<MODE, NCH>(gpyr, lv, q.lvl, q.t0, q.s0, k, q.a[k]);
  } else {
    const bool row = olive && ol == q.lvl && ot == q.t0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if (row && os == q.s0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) q.a[k][c] += from[k][c];
      } else if (row && os == plus1(q.s0)) {
        q.a[1][c] += from[0][c];
        q.a[3][c] += from[2][c];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      emit<MODE, NCH>(gpyr, lv, q.lvl, q.t0, q.s0, k, q.a[k]);
  }
}

// One pixel a thread: a warp instruction covers 32 neighbouring pixels.
// REDUCE false leaves the gradient pyramid out (timing only).
template <int MODE, int NCH, bool REDUCE>
__global__ void __launch_bounds__(THREADS)
mip_bwd_kernel(const float* __restrict__ pyr, const float* __restrict__ tu,
               const float* __restrict__ tv, const float* __restrict__ lam,
               const float* __restrict__ gcolour, int n_px,
               const __grid_constant__ Levels lv, float* __restrict__ gpyr,
               float* __restrict__ gtu, float* __restrict__ gtv) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  const bool in = p < n_px;
  float gu = 0.f, gv = 0.f;
  bool blend;                       // live, and blends level lo + 1
  Px<NCH> q;
  // slot 0, level lo: every load at once, then the texel gathers
  {
    float g[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      g[c] = in ? __ldg(&gcolour[(size_t)c * n_px + p]) : 0.f;
    const float u = in ? __ldg(&tu[p]) : 0.f;
    const float v = in ? __ldg(&tv[p]) : 0.f;
    const float lm = in ? __ldg(&lam[p]) : 0.f;
    bool live = false;
#pragma unroll
    for (int c = 0; c < NCH; ++c) live = live || g[c] != 0.f;
    int lo;
    float frac;
    blend = pick(lm, lv.n, lo, frac) && live;
    init(q, live);
    if (live) pixel<MODE, NCH>(pyr, lv, lo, u, v, g, 1.f - frac, q, gu, gv);
    if (REDUCE) reduce<MODE, NCH>(gpyr, lv, q, lane);
  }
  // slot 1, level lo + 1, where a pixel of the warp blends it; its inputs
  // read again (cache hits: 3 % faster at the bench-mip batch than holding
  // them across slot 0's reductions)
  if (__any_sync(FULL, blend)) {
    init(q, blend);
    if (blend) {
      float g[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        g[c] = __ldg(&gcolour[(size_t)c * n_px + p]);
      int lo;
      float frac;
      pick(__ldg(&lam[p]), lv.n, lo, frac);
      pixel<MODE, NCH>(pyr, lv, lo + 1, __ldg(&tu[p]), __ldg(&tv[p]), g,
                       frac, q, gu, gv);
    }
    if (REDUCE) reduce<MODE, NCH>(gpyr, lv, q, lane);
  }
  if (in) {
    gtu[p] = gu;
    gtv[p] = gv;
  }
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

// Whether every level's sides are powers of two.
bool pow2_chain(const Levels& lv) {
  for (int l = 0; l < lv.n; ++l)
    if ((lv.th[l] & (lv.th[l] - 1)) || (lv.tw[l] & (lv.tw[l] - 1)))
      return false;
  return true;
}

template <int MODE, int NC>
void fwd(bool vec, const float* pyr, const float* tu, const float* tv,
         const float* lam, int n, const Levels& lv, int nchan, float* out,
         cudaStream_t st) {
  const int per = vec ? PX : 1;
  const int threads = (n + per - 1) / per;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  if (vec)
    mip_fwd_kernel<MODE, NC, true><<<blocks, THREADS, 0, st>>>(
        pyr, tu, tv, lam, n, lv, nchan, out);
  else
    mip_fwd_kernel<MODE, NC, false><<<blocks, THREADS, 0, st>>>(
        pyr, tu, tv, lam, n, lv, nchan, out);
}

template <int MODE, bool REDUCE>
void bwd(int nchan, const float* pyr, const float* tu, const float* tv,
         const float* lam, const float* gcolour, int n, const Levels& lv,
         float* gpyr, float* gtu, float* gtv, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  switch (nchan) {
    case 1: mip_bwd_kernel<MODE, 1, REDUCE><<<blocks, THREADS, 0, st>>>(
                pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu, gtv); break;
    case 2: mip_bwd_kernel<MODE, 2, REDUCE><<<blocks, THREADS, 0, st>>>(
                pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu, gtv); break;
    case 3: mip_bwd_kernel<MODE, 3, REDUCE><<<blocks, THREADS, 0, st>>>(
                pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu, gtv); break;
    default: mip_bwd_kernel<MODE, 4, REDUCE><<<blocks, THREADS, 0, st>>>(
                 pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu, gtv); break;
  }
}

// The checks both entry points share; false if they refuse the shapes.
bool args_ok(int rows, int pw, int nlev, const int* th, const int* tw,
             const int* off, int nchan, Levels& lv) {
  if (nchan < 1 || nchan > MAX_C || rows < 0 || pw < 0 ||
      !make_levels(nlev, th, tw, off, lv))
    return false;
  const int64_t texels = (int64_t)off[nlev - 1] + (int64_t)th[nlev - 1] *
                         tw[nlev - 1];
  return (int64_t)rows * pw < INT32_MAX - 32 * PX &&
         texels * nchan < INT32_MAX;
}

int mip_bwd(const float* pyr, const float* tu, const float* tv,
            const float* lam, const float* gcolour, int rows, int pw,
            int nlev, const int* th, const int* tw, const int* off, int nchan,
            int n_texels, float* gpyr, float* gtu, float* gtv, void* stream,
            bool reduce) {
  Levels lv;
  if (!args_ok(rows, pw, nlev, th, tw, off, nchan, lv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      gpyr, 0, (size_t)n_texels * nchan * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int n = rows * pw;
  if (n == 0) return 0;
  const bool p2 = pow2_chain(lv);
  if (reduce && p2)
    bwd<WRAP_POW2, true>(nchan, pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu,
                         gtv, st);
  else if (reduce)
    bwd<WRAP, true>(nchan, pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu, gtv,
                    st);
  else if (p2)
    bwd<WRAP_POW2, false>(nchan, pyr, tu, tv, lam, gcolour, n, lv, gpyr,
                          gtu, gtv, st);
  else
    bwd<WRAP, false>(nchan, pyr, tu, tv, lam, gcolour, n, lv, gpyr, gtu,
                     gtv, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mip_fwd_launch(const float* pyr, const float* tu,
                              const float* tv, const float* lam, int rows,
                              int pw, int nlev, const int* th, const int* tw,
                              const int* off, int nchan, float* out,
                              void* stream) {
  Levels lv;
  if (!args_ok(rows, pw, nlev, th, tw, off, nchan, lv))
    return (int)cudaErrorInvalidValue;
  const int n = rows * pw;
  if (n == 0) return 0;
  const bool vec =
      ((uintptr_t)tu % 16 == 0) && ((uintptr_t)tv % 16 == 0) &&
      ((uintptr_t)lam % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
      (nchan == 1 || n % PX == 0);
  cudaStream_t st = (cudaStream_t)stream;
  const bool p2 = pow2_chain(lv);
  if (nchan == 1 && p2)
    fwd<WRAP_POW2, 1>(vec, pyr, tu, tv, lam, n, lv, nchan, out, st);
  else if (nchan == 1)
    fwd<WRAP, 1>(vec, pyr, tu, tv, lam, n, lv, nchan, out, st);
  else if (p2)
    fwd<WRAP_POW2, 0>(vec, pyr, tu, tv, lam, n, lv, nchan, out, st);
  else
    fwd<WRAP, 0>(vec, pyr, tu, tv, lam, n, lv, nchan, out, st);
  return (int)cudaGetLastError();
}

extern "C" int mip_bwd_launch(const float* pyr, const float* tu,
                              const float* tv, const float* lam,
                              const float* gcolour, int rows, int pw,
                              int nlev, const int* th, const int* tw,
                              const int* off, int nchan, int n_texels,
                              float* gpyr, float* gtu, float* gtv,
                              void* stream) {
  return mip_bwd(pyr, tu, tv, lam, gcolour, rows, pw, nlev, th, tw, off,
                 nchan, n_texels, gpyr, gtu, gtv, stream, true);
}

// K9 with its gradient-pyramid reductions left out (gpyr stays zero), for
// timing only: chip_smoke.py phase 6 times it beside K9 to show what the
// reductions cost. No wrapper of the port calls it.
extern "C" int mip_bwd_unreduced_launch(
    const float* pyr, const float* tu, const float* tv, const float* lam,
    const float* gcolour, int rows, int pw, int nlev, const int* th,
    const int* tw, const int* off, int nchan, int n_texels, float* gpyr,
    float* gtu, float* gtv, void* stream) {
  return mip_bwd(pyr, tu, tv, lam, gcolour, rows, pw, nlev, th, tw, off,
                 nchan, n_texels, gpyr, gtu, gtv, stream, false);
}
