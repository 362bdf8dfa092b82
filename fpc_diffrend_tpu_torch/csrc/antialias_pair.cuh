// The antialias pair blend, shared by K2 (csrc/antialias.cu) and K10's
// antialias tail (csrc/fused_raster.cu).
//
// pair_delta is nvdiffrast's silhouette blend of one pixel pair, whose math
// is _pair_delta in fpc_diffrend_tpu/ops/pallas/antialias_tpu.py and
// pair_delta in ops/antialias.py, kept operand for operand (the sources
// that include this header are built with -fmad=false, so every product
// rounds as there). blend_pixel is the sum at one pixel,
// c + da_right + db_left + da_down + db_up, in that order, over planes that
// a Planes accessor reads: device memory (GlobalPlanes, K10's seam pass)
// or a block's shared memory (SharedPlanes, K10's in-block pass). The
// same accessors give the same floats, so both write the same sums. K2
// calls pair_delta once a pair and adds each pixel's terms in
// blend_pixel's order, so it writes the same sums too.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aa {

constexpr int MAX_C = 4;
constexpr int N_GEOM = 11;      // packed planes before colour: id z v0..v5 n0..n2

struct Px {
  float id, z, v[6], n[3];
};

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx,
                                         float by, float px, float py) {
  return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
}

// The blend delta of pair (a, b): > 0 moves b toward a, < 0 moves a toward b.
__device__ __forceinline__ float pair_delta(const Px& a, const Px& b,
                                            float pax, float pay, float pbx,
                                            float pby) {
  if (!(a.id != b.id)) return 0.f;
  const float inf = __int_as_float(0x7f800000);
  const float z_a = a.id >= 0.f ? a.z : inf;
  const float z_b = b.id >= 0.f ? b.z : inf;
  const bool a_occ = z_a <= z_b;
  const float occ_id = a_occ ? a.id : b.id;
  const float other_id = a_occ ? b.id : a.id;
  if (!(occ_id >= 0.f)) return 0.f;
  // the occluder's corners and neighbours, chosen field by field (a
  // reference to a or b would put both in local memory)
  float ov[6], on[3];
#pragma unroll
  for (int k = 0; k < 6; ++k) ov[k] = a_occ ? a.v[k] : b.v[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) on[k] = a_occ ? a.n[k] : b.n[k];

  float best_xi = 0.f;
  float best_score = inf;
  bool found = false;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int k = (j + 1) % 3;
    const float vax = ov[2 * j], vay = ov[2 * j + 1];
    const float vbx = ov[2 * k], vby = ov[2 * k + 1];
    const float f_a = edge_fn(vax, vay, vbx, vby, pax, pay);
    const float f_b = edge_fn(vax, vay, vbx, vby, pbx, pby);
    const bool crossing = (f_a * f_b) < 0.f;
    const bool shared = (on[j] >= 0.f) && (on[j] == other_id);
    const bool ok = crossing && !shared;
    const float denom = f_a - f_b;
    const float xi = f_a / (fabsf(denom) > 1e-20f ? denom : 1e-20f);
    const float score = fabsf(xi - 0.5f);
    if (ok && score < best_score) {
      best_xi = xi;
      best_score = score;
    }
    found = found || ok;
  }
  if (!found) return 0.f;
  return fminf(fmaxf(best_xi - 0.5f, -0.5f), 0.5f);
}

// The fused raster kernel's planes in device memory: the id buffer, the
// payload (z = plane 2, corners 5-10, neighbours 11-13) and the colour.
struct GlobalPlanes {
  const int* idbuf;
  const float* payload;
  const float* colour;
  int64_t plane;

  // read-only for the kernel's life: through the non-coherent cache
  __device__ __forceinline__ int id(int64_t q) const {
    return __ldg(&idbuf[q]);
  }
  __device__ __forceinline__ Px px(int64_t q) const {
    Px r;
    r.id = (float)id(q);
    r.z = __ldg(&payload[2 * plane + q]);
#pragma unroll
    for (int k = 0; k < 6; ++k) r.v[k] = __ldg(&payload[(5 + k) * plane + q]);
#pragma unroll
    for (int k = 0; k < 3; ++k) r.n[k] = __ldg(&payload[(11 + k) * plane + q]);
    return r;
  }
  __device__ __forceinline__ float col(int c, int64_t q) const {
    return __ldg(&colour[c * plane + q]);
  }
};

// The same planes of one block's pixels in shared memory, packed plane by
// plane with stride n: [id (int bits), z, v0..v5, n0..n2, colour...].
struct SharedPlanes {
  const float* s;
  int n;

  __device__ __forceinline__ int id(int q) const {
    return __float_as_int(s[q]);
  }
  __device__ __forceinline__ Px px(int q) const {
    Px r;
    r.id = (float)id(q);
    r.z = s[n + q];
#pragma unroll
    for (int k = 0; k < 6; ++k) r.v[k] = s[(2 + k) * n + q];
#pragma unroll
    for (int k = 0; k < 3; ++k) r.n[k] = s[(8 + k) * n + q];
    return r;
  }
  __device__ __forceinline__ float col(int c, int q) const {
    return s[(N_GEOM + c) * n + q];
  }
};

// K2's output at pixel q, at row r and column x of the stacked image:
// c + da_right + db_left + da_down + db_up into acc. ``down`` is the index
// step to the pixel below. Pairs: horizontal (x, x + 1) for x < W - 1;
// vertical (r, r + 1) within one stacked sample, r % sample_ph < H - 1. A
// pair whose ids are equal has delta 0, so the pixel first compares ids
// and reads the geometry only of itself and of neighbours whose ids differ.
template <typename Planes, typename Index>
__device__ __forceinline__ void blend_pixel(const Planes& P, Index q,
                                            Index down, int r, int x,
                                            int nchan, int height, int width,
                                            int sample_ph, float* acc) {
  const float cx = (float)x + 0.5f;
  const float cy = (float)r + 0.5f;
  float c_self[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < nchan) acc[c] = c_self[c] = P.col(c, q);

  const int id = P.id(q);
  const bool right = x < width - 1 && P.id(q + 1) != id;
  const bool left = x >= 1 && x - 1 < width - 1 && P.id(q - 1) != id;
  const bool below = r % sample_ph < height - 1 && P.id(q + down) != id;
  const bool above = r >= 1 && (r - 1) % sample_ph < height - 1 &&
                     P.id(q - down) != id;
  if (!(right || left || below || above)) return;

  const Px self = P.px(q);
  // Each pair adds its delta to this pixel's colour: as the a-side,
  // -d * (-(c_self - c_other)) where d < 0; as the b-side,
  // d * (c_other - c_self) where d > 0.
  // horizontal, a-side: pair (x, x + 1)
  if (right) {
    const float d = pair_delta(self, P.px(q + 1), cx, cy, cx + 1.0f, cy);
    if (d < 0.f)
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < nchan)
          acc[c] = acc[c] + -d * (-(c_self[c] - P.col(c, q + 1)));
  }
  // horizontal, b-side: pair (x - 1, x)
  if (left) {
    const float lx = (float)(x - 1) + 0.5f;
    const float d = pair_delta(P.px(q - 1), self, lx, cy, lx + 1.0f, cy);
    if (d > 0.f)
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < nchan) acc[c] = acc[c] + d * (P.col(c, q - 1) - c_self[c]);
  }
  // vertical, a-side: pair (r, r + 1) inside one sample
  if (below) {
    const float d = pair_delta(self, P.px(q + down), cx, cy, cx, cy + 1.0f);
    if (d < 0.f)
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < nchan)
          acc[c] = acc[c] + -d * (-(c_self[c] - P.col(c, q + down)));
  }
  // vertical, b-side: pair (r - 1, r) inside one sample
  if (above) {
    const float uy = (float)(r - 1) + 0.5f;
    const float d = pair_delta(P.px(q - down), self, cx, uy, cx, uy + 1.0f);
    if (d > 0.f)
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < nchan)
          acc[c] = acc[c] + d * (P.col(c, q - down) - c_self[c]);
  }
}

}  // namespace aa
