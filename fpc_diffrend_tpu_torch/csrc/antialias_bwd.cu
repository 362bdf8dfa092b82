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
// Pairs: horizontal (x, x + 1) for x < W - 1, vertical (r, r + 1) inside
// one stacked sample (r % sample_ph < H - 1). Each pixel writes
// gcolour = gout + (right.a + left.b) + (down.a + up.b) and
// gverts = (right.a + left.b) + (down.a + up.b), the TPU kernel's order,
// where right.a is its share as the a-side of the pair to its right, and so
// on. The TPU kernel evaluates each pair once, at its left/top pixel, and
// carries the far side's share through VMEM between grid steps that run
// in order. Blocks on the H100 run in no order, so here each block owns a
// tile and a one-pixel halo:
//
// 1. A block of 256 threads takes a 32 x 8 tile (one warp a row; row and
//    column from the grid, no divide). The ids, z, colour and gout of the
//    tile and its halo, 34 x 10 pixels, go to shared memory by
//    asynchronous copies (cp.async).
// 2. The pairs whose a-pixel is in the tile, or in the halo's left column
//    (horizontal) or top row (vertical), and whose ids differ, under K2's
//    masks, are found by warp ballot and compacted into a shared list.
// 3. A warp none of whose pixels is in a listed pair writes gout and zeros
//    at once.
// 4. Dense lanes walk the list and evaluate each pair once: both shares
//    come from one evaluation (the a-side's colour share is delta * g, the
//    b-side's its negation; the corner cotangents go to the occluder),
//    and only the occluder's 9 payload planes are read from device memory
//    (z comes from shared memory). Each pair's result goes to its own slot
//    in shared memory. Pairs along the tile's left and top edges are
//    evaluated by both blocks that need them (40 of ~550 slots).
// 5. After one barrier each pixel sums its four slots in the order above
//    and stores; a warp stores 128 contiguous bytes a plane.
// Every value is the same float, summed in the same order, as in the
// plain version: K3 equals it bit for bit. No atomics: it is
// deterministic.
//
// Bound on the H100: the bytes. Each pixel reads id, z, C colour and C
// gout planes and writes C + 6 planes, 48 bytes at C = 1 (z is read for
// every pixel, 4 bytes a pixel more than the function needs, so the pair
// evaluation waits on one round trip, not two); the occluder of a
// differing pair reads 36 bytes more. The pair math (~150 flops a pair,
// once per pair) is small beside that. The occluders' 9 planes are read a
// 32-byte sector (8 pixels of a row) at a time, and the occluders of the
// pairs along an edge sit in few of a sector's pixels: at the bench batch
// that traffic is larger than the rest of the reads (chip_smoke.py
// k3_design_bytes). Two variants measured no better: the occluders'
// planes staged into shared memory by coalesced copies after one more
// barrier (slower), and persistent blocks that stage the next tile while
// working on this one (2 % faster: the staging's latency is not what
// binds).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NV = 6;
constexpr int TW = 32;                 // tile width: one warp a row
constexpr int TH = 8;                  // tile height: one row a warp
constexpr int THREADS = TW * TH;
constexpr int RW = TW + 2;             // staged region: tile + halo
constexpr int RH = TH + 2;
constexpr int NR = RW * RH;
// pair slots by a-pixel: horizontal at tile rows 0..TH-1, columns
// -1..TW-1; vertical at rows -1..TH-1, columns 0..TW-1
constexpr int NH = TH * (TW + 1);
constexpr int NSLOT = NH + (TH + 1) * TW;
// a slot's shares: none, or both with the corners at a or at b
constexpr uint8_t NONE = 0, A_OCC = 1, B_OCC = 2;
constexpr unsigned FULL = 0xffffffffu;

// 60 registers and 23 KB of shared memory (C = 1): four blocks an SM.
// Capped at 48 or 40 registers (five or six blocks) it spills and ran
// slower on the H100 (chip_turns.py).
constexpr int MIN_BLOCKS = 4;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ float edge_fn(float ax, float ay, float bx,
                                         float by, float px, float py) {
  return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
}

template <int NCH>
struct Smem {
  int id[NR];
  float z[NR];
  float col[NCH][NR];
  float g[NCH][NR];
  float share[NCH + NV][NSLOT];        // the a-side's colour share, then
                                       // the occluder's corner cotangents
  uint8_t listed[NSLOT];               // ids differ under the masks
  uint8_t kind[NSLOT];                 // set by the pair's evaluation
  uint16_t list[NSLOT];
  int n_list;
};

// Evaluate the pair in ``slot`` once: its kind and, unless NONE, its
// shares. a is at stacked row rg, column xg; ia, ib index the region.
template <int NCH>
__device__ __forceinline__ void eval_pair(Smem<NCH>& S, int slot,
                                          const float* __restrict__ payload,
                                          size_t plane, int pw, int r0,
                                          int x0, int sample_ph) {
  const bool horiz = slot < NH;
  int ta, xa;                          // a's tile row and column
  if (horiz) {
    ta = slot / (TW + 1);
    xa = slot - ta * (TW + 1) - 1;
  } else {
    const int s = slot - NH;
    ta = s / TW - 1;
    xa = s - (ta + 1) * TW;
  }
  const int ia = (ta + 1) * RW + xa + 1;
  const int ib = horiz ? ia + 1 : ia + RW;
  const int rg = r0 + ta, xg = x0 + xa;
  // the corners are in the sample's own frame: a's row within its sample
  const float pax = (float)xg + 0.5f, pay = (float)(rg % sample_ph) + 0.5f;
  const float pbx = horiz ? pax + 1.0f : pax;
  const float pby = horiz ? pay : pay + 1.0f;

  uint8_t kind = NONE;
  const float id_a = (float)S.id[ia], id_b = (float)S.id[ib];
  const float inf = __int_as_float(0x7f800000);
  const float z_a = id_a >= 0.f ? S.z[ia] : inf;
  const float z_b = id_b >= 0.f ? S.z[ib] : inf;
  const bool a_occ = z_a <= z_b;
  const float occ_id = a_occ ? id_a : id_b;
  const float other_id = a_occ ? id_b : id_a;
  if (id_a != id_b && occ_id >= 0.f) {
    // the occluder's corners and neighbours
    const int qo = rg * pw + xg + (a_occ ? 0 : horiz ? 1 : pw);
    const float* pv = payload + 5 * plane + qo;
    float ov[NV], on[3];
#pragma unroll
    for (int k = 0; k < NV; ++k) ov[k] = __ldg(pv + k * plane);
#pragma unroll
    for (int k = 0; k < 3; ++k) on[k] = __ldg(pv + (NV + k) * plane);

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
    const float d0 = best_xi - 0.5f;
    const float delta = fminf(fmaxf(d0, -0.5f), 0.5f);
    if (found && (delta > 0.f || delta < 0.f)) {
      const bool pos = delta > 0.f;
      float gdelta = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float gs = pos ? S.g[c][ib] : S.g[c][ia];
        gdelta = gdelta + gs * (S.col[c][ia] - S.col[c][ib]);
        S.share[c][slot] = delta * gs;
      }
      const float fac = (d0 > -0.5f && d0 < 0.5f) ? 1.f
                        : (d0 == -0.5f || d0 == 0.5f) ? 0.5f : 0.f;
      const float gxi = gdelta * fac;
      const float gden =
          fabsf(bfa - bfb) > 1e-20f ? (-gxi * bfa) / (bq * bq) : 0.f;
      const float gfa = gxi / bq + gden;
      const float gfb = -gden;
      float gv[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) gv[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j != bj) continue;
        const int k = (j + 1) % 3;
        const float vax = ov[2 * j], vay = ov[2 * j + 1];
        const float vbx = ov[2 * k], vby = ov[2 * k + 1];
        const float ax = vbx - vax, cy = vby - vay;
        const float bya = pay - vay, exa = pax - vax;
        const float byb = pby - vay, exb = pbx - vax;
        gv[2 * j] = (-(gfa * bya) + gfa * cy) + (-(gfb * byb) + gfb * cy);
        gv[2 * j + 1] = (-(gfa * ax) + gfa * exa) + (-(gfb * ax) + gfb * exb);
        gv[2 * k] = gfa * bya + gfb * byb;
        gv[2 * k + 1] = -(gfa * exa) + -(gfb * exb);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) S.share[NCH + k][slot] = gv[k];
      kind = a_occ ? A_OCC : B_OCC;
    }
  }
  S.kind[slot] = kind;
}

// Append ``slot`` to the block's list where ``f``: one shared atomic a warp.
template <int NCH>
__device__ __forceinline__ void push(Smem<NCH>& S, bool f, int slot,
                                     int lane) {
  const unsigned m = __ballot_sync(FULL, f);
  if (!m) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(&S.n_list, __popc(m));
  base = __shfl_sync(FULL, base, 0);
  if (f) S.list[base + __popc(m & ((1u << lane) - 1u))] = (uint16_t)slot;
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
antialias_bwd_kernel(const int* __restrict__ idbuf,
                     const float* __restrict__ payload,
                     const float* __restrict__ colour,
                     const float* __restrict__ gout, int rows, int pw,
                     int height, int width, int sample_ph,
                     float* __restrict__ gcolour, float* __restrict__ gverts) {
  __shared__ Smem<NCH> S;
  const size_t plane = (size_t)rows * pw;
  const int x0 = blockIdx.x * TW, r0 = blockIdx.y * TH;
  const int tid = threadIdx.x, lane = tid & 31, ty = tid >> 5;

  // 1. stage the tile and its halo
  if (tid == 0) S.n_list = 0;
  for (int i = tid; i < NR; i += THREADS) {
    const int rr = r0 - 1 + i / RW, xx = x0 - 1 + i % RW;
    if (rr >= 0 && rr < rows && xx >= 0 && xx < pw) {
      const int q = rr * pw + xx;
      cp_async4(&S.id[i], idbuf + q);
      cp_async4(&S.z[i], payload + 2 * plane + q);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        cp_async4(&S.col[c][i], colour + c * plane + q);
        cp_async4(&S.g[c][i], gout + c * plane + q);
      }
    } else {                           // never read by a pair (the masks)
      S.id[i] = -1;
      S.z[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) S.col[c][i] = S.g[c][i] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the pairs this block evaluates, by their a-pixel
  const int r = r0 + ty, x = x0 + lane;
  const bool in = r < rows && x < pw;
  const int ri = (ty + 1) * RW + lane + 1;
  const int id = S.id[ri];
  const bool hflag = in && x < width - 1 && S.id[ri + 1] != id;
  const bool vflag = in && r % sample_ph < height - 1 && S.id[ri + RW] != id;
  const int hs = ty * (TW + 1) + lane + 1;           // right pair
  const int vs = NH + (ty + 1) * TW + lane;          // pair below
  // the halo's pairs: threads 0..TW-1 the top row's vertical pairs
  // (r0 - 1, x), threads TW..TW+TH-1 the left column's horizontal pairs
  // (r, x0 - 1)
  bool halo = false;
  int halo_slot = 0;
  if (tid < TW) {
    halo_slot = NH + tid;
    const int xh = x0 + tid;
    halo = r0 >= 1 && xh < pw && (r0 - 1) % sample_ph < height - 1 &&
           S.id[tid + 1] != S.id[RW + tid + 1];
  } else if (tid < TW + TH) {
    const int j = tid - TW;
    halo_slot = j * (TW + 1);
    halo = x0 >= 1 && r0 + j < rows && x0 - 1 < width - 1 &&
           S.id[(j + 1) * RW] != S.id[(j + 1) * RW + 1];
  }
  S.listed[hs] = hflag;
  S.listed[vs] = vflag;
  S.kind[hs] = S.kind[vs] = NONE;
  if (tid < TW + TH) {
    S.listed[halo_slot] = halo;
    S.kind[halo_slot] = NONE;
  }
  push(S, hflag, hs, lane);
  push(S, vflag, vs, lane);
  push(S, halo, halo_slot, lane);
  __syncthreads();

  // 3. a warp with no pixel in a listed pair: gout and zeros at once
  const int q = r * pw + x;
  const bool touched = in && (S.listed[hs] | S.listed[hs - 1] |
                              S.listed[vs] | S.listed[vs - TW]);
  const bool busy = __any_sync(FULL, touched);
  if (!busy && in) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      gcolour[c * plane + q] = S.g[c][ri] + 0.f;      // g + (0 + 0) ...
#pragma unroll
    for (int k = 0; k < NV; ++k) gverts[k * plane + q] = 0.f;
  }

  // 4. each listed pair once, by dense lanes
  const int n = S.n_list;
  for (int i = tid; i < n; i += THREADS)
    eval_pair(S, S.list[i], payload, plane, pw, r0, x0, sample_ph);
  __syncthreads();

  // 5. the pixel's four shares, in the TPU kernel's order
  if (!busy || !in) return;
  const uint8_t kr = S.kind[hs], kl = S.kind[hs - 1];
  const uint8_t kd = S.kind[vs], ku = S.kind[vs - TW];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const float ra = kr ? S.share[c][hs] : 0.f;
    const float lb = kl ? -S.share[c][hs - 1] : 0.f;
    const float da = kd ? S.share[c][vs] : 0.f;
    const float ub = ku ? -S.share[c][vs - TW] : 0.f;
    gcolour[c * plane + q] = (S.g[c][ri] + (ra + lb)) + (da + ub);
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float ra = kr == A_OCC ? S.share[NCH + k][hs] : 0.f;
    const float lb = kl == B_OCC ? S.share[NCH + k][hs - 1] : 0.f;
    const float da = kd == A_OCC ? S.share[NCH + k][vs] : 0.f;
    const float ub = ku == B_OCC ? S.share[NCH + k][vs - TW] : 0.f;
    gverts[k * plane + q] = (ra + lb) + (da + ub);
  }
}

template <int NCH>
void launch(dim3 grid, cudaStream_t st, const int* idbuf,
            const float* payload, const float* colour, const float* gout,
            int rows, int pw, int height, int width, int sample_ph,
            float* gcolour, float* gverts) {
  antialias_bwd_kernel<NCH><<<grid, THREADS, 0, st>>>(
      idbuf, payload, colour, gout, rows, pw, height, width, sample_ph,
      gcolour, gverts);
}

}  // namespace

extern "C" int antialias_bwd_launch(const int* idbuf, const float* payload,
                                    const float* colour, const float* gout,
                                    int rows, int pw, int nchan, int height,
                                    int width, int sample_ph, float* gcolour,
                                    float* gverts, void* stream) {
  if (nchan < 1 || nchan > 4 || rows < 1 || pw < 1 || sample_ph < 1 ||
      (int64_t)rows * pw >= INT32_MAX || (rows + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((pw + TW - 1) / TW, (rows + TH - 1) / TH);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nchan) {
    case 1: launch<1>(grid, st, idbuf, payload, colour, gout, rows, pw,
                      height, width, sample_ph, gcolour, gverts); break;
    case 2: launch<2>(grid, st, idbuf, payload, colour, gout, rows, pw,
                      height, width, sample_ph, gcolour, gverts); break;
    case 3: launch<3>(grid, st, idbuf, payload, colour, gout, rows, pw,
                      height, width, sample_ph, gcolour, gverts); break;
    default: launch<4>(grid, st, idbuf, payload, colour, gout, rows, pw,
                       height, width, sample_ph, gcolour, gverts); break;
  }
  return (int)cudaGetLastError();
}
