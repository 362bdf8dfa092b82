// K2: silhouette antialias over the stacked batch image (forward).
//
// Replaces fpc_diffrend_tpu/ops/pallas/antialias_tpu.py _fwd_kernel
// (launched by _aa_fwd_from_packed): nvdiffrast's pair blend, whose math is
// _pair_delta there and pair_delta in ops/antialias.py, kept operand for
// operand (built with -fmad=false, so every product rounds as there).
//
// The TPU kernel evaluates each pair once, at its left/top pixel, and
// carries the other side's delta forward through VMEM between grid steps,
// which run in order on one core. Blocks on the H100 run in no order, so
// this kernel is a gather instead: one thread per pixel evaluates the pair
// with its right neighbour and the pair below (where it is the a-side)
// and the pair with its left neighbour and the pair above (where it is the
// b-side), and writes c + da_right + db_left + da_down + db_up once — the
// order of the TPU kernel's sums. Each pair is evaluated twice, once by
// each of its pixels; the work is cheap beside the bytes.
//
// Pair masks: horizontal pairs need x < W - 1; vertical pairs stay within
// one stacked sample, row % sample_ph < H - 1. A pair whose ids are equal
// has delta 0, so a pixel first compares ids and reads the geometry planes
// only of itself and of the neighbours whose ids differ from its own.
//
// Bound on the H100: the bytes. Each pixel reads 11 + C planes (id, z,
// 6 corners, 3 neighbours, colour) and writes C; the neighbour reads hit
// L1/L2. ~52 bytes a pixel at C = 1. Every per-pixel array is indexed by
// unrolled constants. Blocks of 128 threads capped at 64 registers (8
// blocks an SM) keep more loads in flight; on the H100 they ran faster
// than 256 threads at 88 registers, though the cap spills 48 bytes a
// thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 4;
constexpr int THREADS = 128;

struct Px {
  float id, z, v[6], n[3];
};

__device__ __forceinline__ Px load_px(const int* __restrict__ idbuf,
                                      const float* __restrict__ payload,
                                      int64_t plane, int64_t p) {
  Px q;
  q.id = (float)idbuf[p];
  q.z = payload[2 * plane + p];
#pragma unroll
  for (int k = 0; k < 6; ++k) q.v[k] = payload[(5 + k) * plane + p];
#pragma unroll
  for (int k = 0; k < 3; ++k) q.n[k] = payload[(11 + k) * plane + p];
  return q;
}

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

__global__ void __launch_bounds__(THREADS, 8)
antialias_kernel(const int* __restrict__ idbuf,
                 const float* __restrict__ payload,
                 const float* __restrict__ colour, int rows, int pw,
                 int nchan, int height, int width, int sample_ph,
                 float* __restrict__ out) {
  const int64_t plane = (int64_t)rows * pw;
  const int64_t p = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (p >= plane) return;
  const int r = (int)(p / pw);
  const int x = (int)(p - (int64_t)r * pw);
  const float cx = (float)x + 0.5f;
  const float cy = (float)r + 0.5f;

  float c_self[MAX_C], acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < nchan) acc[c] = c_self[c] = colour[c * plane + p];

  // the pairs this pixel is in whose ids differ
  const int id = idbuf[p];
  const bool right = x < width - 1 && idbuf[p + 1] != id;
  const bool left = x >= 1 && x - 1 < width - 1 && idbuf[p - 1] != id;
  const bool down = r % sample_ph < height - 1 && idbuf[p + pw] != id;
  const bool up = r >= 1 && (r - 1) % sample_ph < height - 1 &&
                  idbuf[p - pw] != id;

  if (right || left || down || up) {
    const Px self = load_px(idbuf, payload, plane, p);
    // Each pair adds its delta to this pixel's colour: as the a-side,
    // -d * (-(c_self - c_other)) where d < 0; as the b-side,
    // d * (c_other - c_self) where d > 0.
    // horizontal, a-side: pair (x, x + 1)
    if (right) {
      const float d = pair_delta(self, load_px(idbuf, payload, plane, p + 1),
                                 cx, cy, cx + 1.0f, cy);
      if (d < 0.f)
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < nchan)
            acc[c] = acc[c] + -d * (-(c_self[c] - colour[c * plane + p + 1]));
    }
    // horizontal, b-side: pair (x - 1, x)
    if (left) {
      const float lx = (float)(x - 1) + 0.5f;
      const float d = pair_delta(load_px(idbuf, payload, plane, p - 1), self,
                                 lx, cy, lx + 1.0f, cy);
      if (d > 0.f)
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < nchan)
            acc[c] = acc[c] + d * (colour[c * plane + p - 1] - c_self[c]);
    }
    // vertical, a-side: pair (r, r + 1) inside one sample
    if (down) {
      const float d = pair_delta(self, load_px(idbuf, payload, plane, p + pw),
                                 cx, cy, cx, cy + 1.0f);
      if (d < 0.f)
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < nchan)
            acc[c] =
                acc[c] + -d * (-(c_self[c] - colour[c * plane + p + pw]));
    }
    // vertical, b-side: pair (r - 1, r) inside one sample
    if (up) {
      const float uy = (float)(r - 1) + 0.5f;
      const float d = pair_delta(load_px(idbuf, payload, plane, p - pw), self,
                                 cx, uy, cx, uy + 1.0f);
      if (d > 0.f)
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < nchan)
            acc[c] = acc[c] + d * (colour[c * plane + p - pw] - c_self[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < nchan) out[c * plane + p] = acc[c];
}

}  // namespace

extern "C" int antialias_launch(const int* idbuf, const float* payload,
                                const float* colour, int rows, int pw,
                                int nchan, int height, int width,
                                int sample_ph, float* out, void* stream) {
  if (nchan < 1 || nchan > MAX_C) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * pw;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  antialias_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      idbuf, payload, colour, rows, pw, nchan, height, width, sample_ph, out);
  return (int)cudaGetLastError();
}
