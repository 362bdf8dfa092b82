// K3: backward of the silhouette antialias (K2) over the stacked batch image.
//
// Replaces fpc_diffrend_tpu/ops/pallas/antialias_tpu.py _bwd_kernel
// (launched by aa_planes_bwd_core), which traces jax.vjp of _pair_delta
// inside the kernel. Here the derivative is written out by hand; its plain
// PyTorch version is pair_grad in ops/antialias.py, operand for operand
// (built with -fmad=false, so both round every product and sum alike).
//
// For one pair (a, b) with blend delta = clamp(xi - 0.5) of the occluder's
// chosen edge and cotangents g_a, g_b of (delta_a, delta_b):
//   delta > 0: delta_b = delta * (c_a - c_b)  -> g_delta = sum g_b * diff
//   delta < 0: delta_a = -delta * -(c_a - c_b) -> g_delta = sum g_a * diff
//   the colour shares: c_a += delta * g, c_b -= delta * g
//   xi = f_a / q, q = denom = f_a - f_b where |denom| > 1e-20, else 1e-20
//   f = edge_fn of the occluder's chosen edge at each pixel centre, which
//   gives 4 of the occluder's 6 screen-corner cotangents.
// The clamp passes the gradient inside (-0.5, 0.5), half of it at a bound
// (as JAX's clip) and none outside; an invalid pair or delta == 0 gives
// nothing.
//
// The TPU kernel evaluates each pair once, at its left/top pixel, and
// carries the far side's share through VMEM between grid steps that run in
// order (hcarry/vcarry). Blocks on the H100 run in no order, so this kernel
// is a gather, like K2: one thread per pixel recomputes the <= 4 pairs it
// belongs to and keeps its own side's share: the a-side for the pair to its
// right and the pair below, the b-side for the pair to its left and the
// pair above. It writes gcolour = gout + (right + left) + (down + up) and
// gverts = (right + left) + (down + up) once, the TPU kernel's order: no
// atomics, and the result is deterministic. Only two shares are live at a
// time (120 registers). Occupancy does not bind it: capped at 80
// registers (6 blocks an SM) it ran no faster on the H100.
//
// Bound on the H100: the bytes. Each pixel reads id, z, 6 corners, 3
// neighbours, C colour and C gout planes and writes C + 6 planes, 80
// bytes at C = 1; a pixel whose four neighbours share its id reads only
// id, colour and gout. The pair math (~100 flops a pair, twice per pair)
// is small beside that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 4;
constexpr int THREADS = 128;
constexpr int NV = 6;

struct Px {
  float id, z, v[NV], n[3];
};

__device__ __forceinline__ Px load_px(const int* __restrict__ idbuf,
                                      const float* __restrict__ payload,
                                      int64_t plane, int64_t p) {
  Px q;
  q.id = (float)idbuf[p];
  q.z = payload[2 * plane + p];
#pragma unroll
  for (int k = 0; k < NV; ++k) q.v[k] = payload[(5 + k) * plane + p];
#pragma unroll
  for (int k = 0; k < 3; ++k) q.n[k] = payload[(11 + k) * plane + p];
  return q;
}

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx,
                                         float by, float px, float py) {
  return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
}

// One pixel's share of a pair's gradient: its colour cotangent and, if it
// is the occluder, the cotangents of its 6 screen corners.
struct Share {
  float col[MAX_C], v[NV];
};

__device__ __forceinline__ void zero(Share& s) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) s.col[c] = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) s.v[k] = 0.f;
}

// Backward of pair (a, b) for cotangents g_a, g_b (gout at each pixel):
// writes the a-side share (as_a) or the b-side share into s, which the
// caller zeroed.
__device__ __forceinline__ void pair_grad(
    const Px& a, const Px& b, float pax, float pay, float pbx, float pby,
    const float (&c_a)[MAX_C], const float (&c_b)[MAX_C],
    const float (&g_a)[MAX_C], const float (&g_b)[MAX_C], int nchan,
    bool as_a, Share& s) {
  if (!(a.id != b.id)) return;
  const float inf = __int_as_float(0x7f800000);
  const float z_a = a.id >= 0.f ? a.z : inf;
  const float z_b = b.id >= 0.f ? b.z : inf;
  const bool a_occ = z_a <= z_b;
  const float occ_id = a_occ ? a.id : b.id;
  const float other_id = a_occ ? b.id : a.id;
  if (!(occ_id >= 0.f)) return;
  float ov[NV], on[3];
#pragma unroll
  for (int k = 0; k < NV; ++k) ov[k] = a_occ ? a.v[k] : b.v[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) on[k] = a_occ ? a.n[k] : b.n[k];

  float best_xi = 0.f, best_score = inf, bfa = 0.f, bfb = 0.f, bq = 1.f;
  int bj = -1;
  bool found = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = (j + 1) % 3;
    const float f_a = edge_fn(ov[2 * j], ov[2 * j + 1], ov[2 * k],
                              ov[2 * k + 1], pax, pay);
    const float f_b = edge_fn(ov[2 * j], ov[2 * j + 1], ov[2 * k],
                              ov[2 * k + 1], pbx, pby);
    const bool crossing = (f_a * f_b) < 0.f;
    const bool shared = (on[j] >= 0.f) && (on[j] == other_id);
    const bool ok = crossing && !shared;
    const float denom = f_a - f_b;
    const float q = fabsf(denom) > 1e-20f ? denom : 1e-20f;
    const float xi = f_a / q;
    const float score = fabsf(xi - 0.5f);
    if (ok && score < best_score) {
      best_xi = xi;
      best_score = score;
      bfa = f_a;
      bfb = f_b;
      bq = q;
      bj = j;
    }
    found = found || ok;
  }
  if (!found) return;                        // no silhouette edge crossed
  const float d0 = best_xi - 0.5f;
  const float delta = fminf(fmaxf(d0, -0.5f), 0.5f);
  if (!(delta > 0.f) && !(delta < 0.f)) return;
  const bool pos = delta > 0.f;

  float gdelta = 0.f;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < nchan) {
      const float gs = pos ? g_b[c] : g_a[c];
      gdelta = gdelta + gs * (c_a[c] - c_b[c]);
      const float gd = delta * gs;
      s.col[c] = as_a ? gd : -gd;
    }
  if (as_a != a_occ) return;                 // not the occluder

  const float fac = (d0 > -0.5f && d0 < 0.5f) ? 1.f
                    : (d0 == -0.5f || d0 == 0.5f) ? 0.5f : 0.f;
  const float gxi = gdelta * fac;
  const float gden =
      fabsf(bfa - bfb) > 1e-20f ? (-gxi * bfa) / (bq * bq) : 0.f;
  const float gfa = gxi / bq + gden;
  const float gfb = -gden;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (j != bj) continue;
    const int k = (j + 1) % 3;
    const float vax = ov[2 * j], vay = ov[2 * j + 1];
    const float vbx = ov[2 * k], vby = ov[2 * k + 1];
    const float ax = vbx - vax, cy = vby - vay;
    const float bya = pay - vay, exa = pax - vax;
    const float byb = pby - vay, exb = pbx - vax;
    s.v[2 * j] = (-(gfa * bya) + gfa * cy) + (-(gfb * byb) + gfb * cy);
    s.v[2 * j + 1] = (-(gfa * ax) + gfa * exa) + (-(gfb * ax) + gfb * exb);
    s.v[2 * k] = gfa * bya + gfb * byb;
    s.v[2 * k + 1] = -(gfa * exa) + -(gfb * exb);
  }
}

__device__ __forceinline__ void load_c(const float* __restrict__ planes,
                                       int64_t plane, int64_t p, int nchan,
                                       float (&out)[MAX_C]) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    out[c] = c < nchan ? planes[c * plane + p] : 0.f;
}

__global__ void __launch_bounds__(THREADS)
antialias_bwd_kernel(const int* __restrict__ idbuf,
                     const float* __restrict__ payload,
                     const float* __restrict__ colour,
                     const float* __restrict__ gout, int rows, int pw,
                     int nchan, int height, int width, int sample_ph,
                     float* __restrict__ gcolour, float* __restrict__ gverts) {
  const int64_t plane = (int64_t)rows * pw;
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  const int r = (int)(p / pw);
  const int x = (int)(p - (int64_t)r * pw);
  const float cx = (float)x + 0.5f;
  const float cy = (float)r + 0.5f;

  float c_self[MAX_C], g_self[MAX_C];
  load_c(colour, plane, p, nchan, c_self);
  load_c(gout, plane, p, nchan, g_self);

  const int id = idbuf[p];
  const bool right = x < width - 1 && idbuf[p + 1] != id;
  const bool left = x >= 1 && x - 1 < width - 1 && idbuf[p - 1] != id;
  const bool down = r % sample_ph < height - 1 && idbuf[p + pw] != id;
  const bool up = r >= 1 && (r - 1) % sample_ph < height - 1 &&
                  idbuf[p - pw] != id;

  // the horizontal pairs' shares, then the vertical ones, each pair of
  // shares summed before it joins the running sums (the TPU order)
  Share a, b;
  zero(a);
  zero(b);
  Px self;
  if (right || left || down || up) self = load_px(idbuf, payload, plane, p);
  float c_nb[MAX_C], g_nb[MAX_C];
  if (right) {             // pair (x, x + 1), this pixel is a
    load_c(colour, plane, p + 1, nchan, c_nb);
    load_c(gout, plane, p + 1, nchan, g_nb);
    pair_grad(self, load_px(idbuf, payload, plane, p + 1), cx, cy,
              cx + 1.0f, cy, c_self, c_nb, g_self, g_nb, nchan, true, a);
  }
  if (left) {              // pair (x - 1, x), this pixel is b
    const float lx = (float)(x - 1) + 0.5f;
    load_c(colour, plane, p - 1, nchan, c_nb);
    load_c(gout, plane, p - 1, nchan, g_nb);
    pair_grad(load_px(idbuf, payload, plane, p - 1), self, lx, cy,
              lx + 1.0f, cy, c_nb, c_self, g_nb, g_self, nchan, false, b);
  }
  float gcol[MAX_C], gv[NV];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    gcol[c] = g_self[c] + (a.col[c] + b.col[c]);
#pragma unroll
  for (int k = 0; k < NV; ++k) gv[k] = a.v[k] + b.v[k];
  zero(a);
  zero(b);
  if (down) {              // pair (r, r + 1) inside one sample, a
    load_c(colour, plane, p + pw, nchan, c_nb);
    load_c(gout, plane, p + pw, nchan, g_nb);
    pair_grad(self, load_px(idbuf, payload, plane, p + pw), cx, cy, cx,
              cy + 1.0f, c_self, c_nb, g_self, g_nb, nchan, true, a);
  }
  if (up) {                // pair (r - 1, r) inside one sample, b
    const float uy = (float)(r - 1) + 0.5f;
    load_c(colour, plane, p - pw, nchan, c_nb);
    load_c(gout, plane, p - pw, nchan, g_nb);
    pair_grad(load_px(idbuf, payload, plane, p - pw), self, cx, uy, cx,
              uy + 1.0f, c_nb, c_self, g_nb, g_self, nchan, false, b);
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < nchan) gcolour[c * plane + p] = gcol[c] + (a.col[c] + b.col[c]);
#pragma unroll
  for (int k = 0; k < NV; ++k)
    gverts[k * plane + p] = gv[k] + (a.v[k] + b.v[k]);
}

}  // namespace

extern "C" int antialias_bwd_launch(const int* idbuf, const float* payload,
                                    const float* colour, const float* gout,
                                    int rows, int pw, int nchan, int height,
                                    int width, int sample_ph, float* gcolour,
                                    float* gverts, void* stream) {
  if (nchan < 1 || nchan > MAX_C) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * pw;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  antialias_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      idbuf, payload, colour, gout, rows, pw, nchan, height, width,
      sample_ph, gcolour, gverts);
  return (int)cudaGetLastError();
}
