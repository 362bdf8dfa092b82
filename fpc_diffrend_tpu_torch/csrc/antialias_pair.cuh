// The antialias pair blend of K2 (csrc/antialias_fwd.cuh, which K2's and
// K10's libraries build).
//
// pair_delta is nvdiffrast's silhouette blend of one pixel pair, whose math
// is _pair_delta in fpc_diffrend_tpu/ops/pallas/antialias_tpu.py and
// pair_delta in ops/antialias.py, kept operand for operand (the sources
// that include this header are built with -fmad=false, so every product
// rounds as there).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aa {

constexpr int MAX_C = 4;

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

}  // namespace aa
