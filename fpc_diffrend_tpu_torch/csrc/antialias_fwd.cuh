// K2's kernel (the design note is csrc/antialias.cu's), in a header so
// that K2's library and K10's (csrc/fused_raster.cu, which runs K1's
// kernel and then this one) build the same code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "antialias_pair.cuh"

namespace aa_fwd {

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
    eval_pair(S, S.list[i], payload, plane, pw, r0, x0, sample_ph);
  __syncthreads();

  // 5. the pixel's four terms, in the plain version's order and arithmetic
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
void launch_nch(dim3 grid, cudaStream_t st, const int* idbuf,
            const float* payload, const float* colour, int rows, int pw,
            int height, int width, int sample_ph, float* out) {
  antialias_kernel<NCH><<<grid, THREADS, 0, st>>>(
      idbuf, payload, colour, rows, pw, height, width, sample_ph, out);
}

// The planes K2 takes: 1 to 4 channels, int32 pixel indices, grid rows
// within a launch's limit.
inline bool valid(int rows, int pw, int nchan, int sample_ph) {
  return nchan >= 1 && nchan <= aa::MAX_C && rows >= 1 && pw >= 1 &&
         sample_ph >= 1 && (int64_t)rows * pw < INT32_MAX &&
         (rows + TH - 1) / TH <= 65535;
}

// K2 on the stream: out (nchan, rows, pw) <- the antialiased colour.
inline void launch(cudaStream_t st, const int* idbuf, const float* payload,
                   const float* colour, int rows, int pw, int nchan,
                   int height, int width, int sample_ph, float* out) {
  const dim3 grid((pw + TW - 1) / TW, (rows + TH - 1) / TH);
  switch (nchan) {
    case 1:
      launch_nch<1>(grid, st, idbuf, payload, colour, rows, pw, height, width,
                    sample_ph, out);
      break;
    case 2:
      launch_nch<2>(grid, st, idbuf, payload, colour, rows, pw, height, width,
                    sample_ph, out);
      break;
    case 3:
      launch_nch<3>(grid, st, idbuf, payload, colour, rows, pw, height, width,
                    sample_ph, out);
      break;
    default:
      launch_nch<4>(grid, st, idbuf, payload, colour, rows, pw, height, width,
                    sample_ph, out);
  }
}

}  // namespace aa_fwd
