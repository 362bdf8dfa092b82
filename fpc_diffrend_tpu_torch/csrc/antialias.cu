// K2: silhouette antialias over the stacked batch image (forward).
//
// Replaces fpc_diffrend_tpu/ops/pallas/antialias_tpu.py _fwd_kernel
// (launched by _aa_fwd_from_packed): nvdiffrast's pair blend, whose math is
// _pair_delta there and pair_delta in ops/antialias.py, kept operand for
// operand (built with -fmad=false, so every product rounds as there). The
// pair blend lives in antialias_pair.cuh, which K10's antialias tail
// shares; so does blend_pixel, the per-pixel sum K10 takes and whose
// order this kernel keeps.
//
// Each pixel writes c + da_right + db_left + da_down + db_up: its share as
// the a-side of the pair to its right and below (the pair's delta d where
// d < 0) and as the b-side of the pair to its left and above (where
// d > 0), in the TPU kernel's order. Pairs: horizontal (x, x + 1) for
// x < W - 1; vertical (r, r + 1) within one stacked sample,
// r % sample_ph < H - 1. The TPU kernel evaluates each pair once, at its
// left/top pixel, and carries the far side's share through VMEM between
// grid steps that run in order. Blocks on the H100 run in no order, so
// each block owns a tile and a one-pixel halo (K3's structure,
// antialias_bwd.cu):
//
// 1. A block of 256 threads takes a 32 x 8 tile (one warp a row). The ids,
//    z and colour of the tile and its halo, 34 x 10 pixels, go to shared
//    memory by asynchronous copies (cp.async).
// 2. The pairs whose a-pixel is in the tile, or in the halo's left column
//    (horizontal) or top row (vertical), and whose ids differ, under the
//    masks above, are found by warp ballot and compacted into a list.
// 3. A warp none of whose pixels is in a listed pair writes its colour
//    through at once.
// 4. Dense lanes walk the list and evaluate each pair once with
//    aa::pair_delta. Only the occluder's 9 corner and neighbour planes are
//    read from device memory (pair_delta reads no other pixel's; z comes
//    from shared memory). Each pair's delta goes to its own slot in shared
//    memory. Pairs along the tile's left and top edges are evaluated by
//    both blocks that need them (40 of ~550 slots).
// 5. After one barrier each pixel adds its four slots' colour terms in
//    blend_pixel's order and stores; a warp stores 128 contiguous bytes a
//    plane.
// Every value is the same float, summed in the same order, as in
// blend_pixel and the plain version.
//
// Bound on the H100: the bytes. Every pixel reads id and C colour and
// writes C colour planes; the covered pixels of a pair whose ids differ
// read z, and each such pair's occluder its 6 corners and 3 neighbours
// (chip_smoke.py k2_bound_ms). This design reads z for every pixel (so a
// pair waits on one round trip, not two) and reads the occluders' 9 planes
// a 32-byte sector (8 pixels of a row) at a time, which at the bench batch
// is the larger part of its traffic (chip_smoke.py k2_design_bytes). The
// pair math (~60 flops, once a pair) is small beside that. Registers are
// not capped, so nothing spills (chip_turns.py records ptxas's lines).

#include <cuda_runtime.h>
#include <stdint.h>

#include "antialias_pair.cuh"

namespace {

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
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int NCH>
struct Smem {
  int id[NR];
  float z[NR];
  float col[NCH][NR];
  float d[NSLOT];                      // the pair's delta; 0 where none
  uint8_t listed[NSLOT];               // ids differ under the masks
  uint16_t list[NSLOT];
  int n_list;
};

// Evaluate the pair in ``slot`` once into S.d[slot].
template <int NCH>
__device__ __forceinline__ void eval_pair(Smem<NCH>& S, int slot,
                                          const float* __restrict__ payload,
                                          size_t plane, int pw, int r0,
                                          int x0) {
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
  const float pax = (float)xg + 0.5f, pay = (float)rg + 0.5f;
  const float pbx = horiz ? pax + 1.0f : pax;
  const float pby = horiz ? pay : pay + 1.0f;

  aa::Px a, b;
  a.id = (float)S.id[ia];
  b.id = (float)S.id[ib];
  a.z = S.z[ia];
  b.z = S.z[ib];
  // the occluder as pair_delta picks it; it reads no other pixel's corners
  // or neighbours, so both sides carry the occluder's
  const float inf = __int_as_float(0x7f800000);
  const float z_a = a.id >= 0.f ? a.z : inf;
  const float z_b = b.id >= 0.f ? b.z : inf;
  const bool a_occ = z_a <= z_b;
  float d = 0.f;
  if (a.id != b.id && (a_occ ? a.id : b.id) >= 0.f) {
    const int qo = rg * pw + xg + (a_occ ? 0 : horiz ? 1 : pw);
    const float* pv = payload + 5 * plane + qo;
#pragma unroll
    for (int k = 0; k < 6; ++k) a.v[k] = b.v[k] = __ldg(pv + k * plane);
#pragma unroll
    for (int k = 0; k < 3; ++k) a.n[k] = b.n[k] = __ldg(pv + (6 + k) * plane);
    d = aa::pair_delta(a, b, pax, pay, pbx, pby);
  }
  S.d[slot] = d;
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
__global__ void __launch_bounds__(THREADS)
antialias_kernel(const int* __restrict__ idbuf,
                 const float* __restrict__ payload,
                 const float* __restrict__ colour, int rows, int pw,
                 int height, int width, int sample_ph,
                 float* __restrict__ out) {
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
      for (int c = 0; c < NCH; ++c)
        cp_async4(&S.col[c][i], colour + c * plane + q);
    } else {                           // never read by a pair (the masks)
      S.id[i] = -1;
      S.z[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) S.col[c][i] = 0.f;
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
  S.d[hs] = S.d[vs] = 0.f;
  if (tid < TW + TH) {
    S.listed[halo_slot] = halo;
    S.d[halo_slot] = 0.f;
  }
  push(S, hflag, hs, lane);
  push(S, vflag, vs, lane);
  push(S, halo, halo_slot, lane);
  __syncthreads();

  // 3. a warp with no pixel in a listed pair: its colour, at once
  const size_t q = (size_t)r * pw + x;
  const bool touched = in && (S.listed[hs] | S.listed[hs - 1] |
                              S.listed[vs] | S.listed[vs - TW]);
  const bool busy = __any_sync(FULL, touched);
  if (!busy && in) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) out[c * plane + q] = S.col[c][ri];
  }

  // 4. each listed pair once, by dense lanes
  const int n = S.n_list;
  for (int i = tid; i < n; i += THREADS)
    eval_pair(S, S.list[i], payload, plane, pw, r0, x0);
  __syncthreads();

  // 5. the pixel's four terms, in blend_pixel's order and arithmetic
  if (!busy || !in) return;
  const float d_right = S.d[hs], d_left = S.d[hs - 1];
  const float d_down = S.d[vs], d_up = S.d[vs - TW];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const float cs = S.col[c][ri];
    float acc = cs;
    if (d_right < 0.f) acc = acc + -d_right * (-(cs - S.col[c][ri + 1]));
    if (d_left > 0.f) acc = acc + d_left * (S.col[c][ri - 1] - cs);
    if (d_down < 0.f) acc = acc + -d_down * (-(cs - S.col[c][ri + RW]));
    if (d_up > 0.f) acc = acc + d_up * (S.col[c][ri - RW] - cs);
    out[c * plane + q] = acc;
  }
}

template <int NCH>
void launch(dim3 grid, cudaStream_t st, const int* idbuf,
            const float* payload, const float* colour, int rows, int pw,
            int height, int width, int sample_ph, float* out) {
  antialias_kernel<NCH><<<grid, THREADS, 0, st>>>(
      idbuf, payload, colour, rows, pw, height, width, sample_ph, out);
}

}  // namespace

extern "C" int antialias_launch(const int* idbuf, const float* payload,
                                const float* colour, int rows, int pw,
                                int nchan, int height, int width,
                                int sample_ph, float* out, void* stream) {
  if (nchan < 1 || nchan > aa::MAX_C || rows < 1 || pw < 1 ||
      sample_ph < 1 || (int64_t)rows * pw >= INT32_MAX ||
      (rows + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((pw + TW - 1) / TW, (rows + TH - 1) / TH);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nchan) {
    case 1: launch<1>(grid, st, idbuf, payload, colour, rows, pw, height,
                      width, sample_ph, out); break;
    case 2: launch<2>(grid, st, idbuf, payload, colour, rows, pw, height,
                      width, sample_ph, out); break;
    case 3: launch<3>(grid, st, idbuf, payload, colour, rows, pw, height,
                      width, sample_ph, out); break;
    default: launch<4>(grid, st, idbuf, payload, colour, rows, pw, height,
                       width, sample_ph, out); break;
  }
  return (int)cudaGetLastError();
}
