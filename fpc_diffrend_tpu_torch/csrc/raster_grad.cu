// K5: per-pixel gradient coefficients reduced onto each pixel's winning
// bin entry; K6: bin-entry gradient rows folded into per-triangle rows.
//
// K5 replaces fpc_diffrend_tpu/ops/pallas/raster_grad_tpu.py _grad_kernel
// (coefficients _grad_coeff_planes; launched by pixel_grad_pallas). Per
// pixel, from K1's residual planes (u, v, D, 1/w_i, uv-corner differences)
// and the payload cotangents gtu, gtv (the sampler's backward), gx0 gy0
// gx1 gy1 gx2 gy2 (K3's) and gu gv gz, each read where its producer wrote
// it (one pointer a source, planes of rows * pw), the 32 coefficients of
// the winner's record slots (raster_grad_tpu.py :286-310, operand for
// operand; plain version pixel_grad_plain in ops/cuda/raster_grad_cuda.py):
//   d0 = u D, d1 = v D, d2 = D - d0 - d1
//   gu' = gu + gtu du02 + gtv dv02, gv' = gv + gtu du12 + gtv dv12
//   S = (gu' d0 + gv' d1) rD rD, gd0 = gu' rD - S, gd1 = gv' rD - S,
//   gd2 = -S, gl_i = gd_i / w_i
//   slots 0-11: gl_i x, gl_i y, gl_i (edge planes); gz x, gz y, gz (depth),
//   at the pixel's row within its sample, y = r % sample_ph + 0.5: the
//   records are in each sample's own frame, as K1 evaluates them
//   slots 13-15: -gd_i d_i / w_i; 16-21: the uv corners' shares; 22-27: the
//   screen-corner cotangents. Slots 12 (id) and 28-31 are 0.
// The textured pass's u, v and z never leave it, so their cotangents are
// 0 there: without UVZ (a null guvz) the kernel reads no gu, gv, gz plane
// and puts the literal 0.f where it would load them, each expression with
// its operands in the same order, so it computes what the UVZ instance
// computes on zero planes. Its depth coefficients (slots 9-11) are then
// +0 at every pixel and their rows start at +0, so it leaves out their
// sums and atomics (summed<UVZ>) without changing a bit: in the shuffles
// and atomics that bound K5, 24 coefficients in place of 27.
// RasterizeKernel's backward and the band render's edge rows pass the
// planes and take the UVZ instance.
// The TPU kernel reduces a tile's pixels onto its bin with one-hot MXU
// matmuls and carries shared chunks in VMEM between sequential grid steps.
// Here one block of 8 warps takes one 8x128 tile (a warp per pixel row,
// 4 passes of 32 pixels): the block zeroes a shared accumulator of the 27
// live slots for the first CAP entries of its bin, each pixel adds its 27
// coefficients into its winner's row, and the block writes the bin's rows
// once. An entry belongs to exactly one tile's bin, so no two blocks write
// one row. A warp first sums each run of pixels with one winner with
// shuffles, so one lane per run adds: shared atomics from every pixel of
// a run would serialize on one row. Entries past CAP of an oversized bin
// take device-memory atomics on their (zeroed) rows,
// and global-list winners (entry >= gbase) atomics on grad_global: nothing
// is dropped. Rows past bin_start[-1] are not written. With FAST (the
// gradient precision "fast", FPC_GRAD_PREC=fast in JAX: the TPU kernel
// contracts one bf16 plane of the coefficients, raster_grad_tpu.py:89-92)
// each of a pixel's 27 coefficients is rounded to bf16 (nearest even) and
// widened back before the sums, which stay f32.
//
// K6 replaces raster_grad_tpu.py _fold_kernel (launched by banded_fold),
// the counterpart of the segment_sum fold the JAX step uses by default; it
// computes the JAX step's gather fold (FPC_FOLD_IMPL=gather, the inverse
// of _place_sort(want_inv=True)) without its inverse array. Each triangle
// gathers its own rows, so the fold needs no band of triangle ids (the
// TPU's sliding window, overflow count and face-order flip), no memset
// and no atomics, and adds in a fixed order: it is bit-stable from run to
// run and equal to fold_entries_plain. A warp takes 4 triangles. First
// each lane takes one window slot (triangle j = lane / 8, slot k = lane %
// 8): the slot's tile from the binning's tile ids, then a binary search
// for the triangle in its bin (sorted_tri[bin_start[tile] ..
// bin_start[tile + 1]], ascending: at most 7 probes at the bench, served
// by the L2). A slot the cap dropped is not found: bin_start is clamped
// to P. A triangle with no live slot searches the global list (ascending,
// n_global read on the device). Then lane (j, q) loads record slots
// 4q..4q+3 of each found row of triangle j (8 lanes read a 128-byte row),
// all loads issued before the adds, sums them in ascending slot k from
// 0.0, adds the global row, and stores them: one coalesced row a
// triangle, slots 12 and 28-31 zero. The tile ids and rows, read once,
// are loaded and the rows stored with the streaming (evict-first) hint,
// so that sorted_tri and bin_start, which every search probes, stay in
// the L2 (11 % faster on the H100 than the default caching).
//
// Bound on the H100: the bytes. K5 reads entry, u, v, 8 extra and 8
// cotangent planes (76 bytes a covered pixel; with UVZ 11 planes, 88; a
// missed pixel reads only its entry) and writes the live rows (128 bytes
// each); K6 reads the live rows, the tile ids (32 bytes a triangle) and
// writes the (B*T, 32) rows. The search's dependent loads are latency,
// hidden by 4 triangles a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int THREADS = TILE_H * 32;    // a warp per pixel row of the tile
constexpr int REC = 32;
constexpr int NLIVE = 27;               // record slots 0-11 and 13-27
constexpr int CAP = 256;                // bin entries held in shared memory
constexpr int N_EXTRA = 8;
constexpr int WIN = 8;                  // window slots a triangle (K6)
constexpr int FOLD_THREADS = 128;       // 4 warps, 16 triangles a block
constexpr float AREA_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int slot(int k) { return k < 12 ? k : k + 1; }

// Whether live slot k is summed: without UVZ the depth coefficients (live
// slots 9-11: gz x, gz y, gz) are +0 at every pixel, and adding them to
// rows that start at +0 changes no bit, so their sums and atomics are
// left out.
template <bool UVZ>
__device__ __forceinline__ constexpr bool summed(int k) {
  return UVZ || k < 9 || k > 11;
}

// The 27 live coefficients of one pixel, in live-slot order; with FAST
// each rounded to bf16; without UVZ gu, gv and gz are 0.
template <bool FAST, bool UVZ>
__device__ __forceinline__ void coefficients(
    const float* __restrict__ u_pl, const float* __restrict__ v_pl,
    const float* __restrict__ extra, const float* __restrict__ gtu_pl,
    const float* __restrict__ gtv_pl, const float* __restrict__ gcorners,
    const float* __restrict__ guvz, int64_t plane, int64_t p, float x,
    float y, float (&c)[NLIVE]) {
  const float u = u_pl[p];
  const float v = v_pl[p];
  float e[N_EXTRA], gc[6];
#pragma unroll
  for (int k = 0; k < N_EXTRA; ++k) e[k] = extra[k * plane + p];
  const float gtu = gtu_pl[p];
  const float gtv = gtv_pl[p];
#pragma unroll
  for (int k = 0; k < 6; ++k) gc[k] = gcorners[k * plane + p];
  float gu0 = 0.f, gv0 = 0.f, gz = 0.f;
  if (UVZ) {
    gu0 = guvz[p];
    gv0 = guvz[plane + p];
    gz = guvz[2 * plane + p];
  }
  const float D = e[0], iw0 = e[1], iw1 = e[2], iw2 = e[3];
  const float du02 = e[4], du12 = e[5], dv02 = e[6], dv12 = e[7];
  const float d0 = u * D;
  const float d1 = v * D;
  const float d2 = (D - d0) - d1;
  const float gu = (gu0 + gtu * du02) + gtv * dv02;
  const float gv = (gv0 + gtu * du12) + gtv * dv12;
  const float rD = 1.f / (fabsf(D) > AREA_EPS ? D : 1.f);
  const float S = ((gu * d0 + gv * d1) * rD) * rD;
  const float gd0 = gu * rD - S;
  const float gd1 = gv * rD - S;
  const float gd2 = -S;
  const float gl0 = gd0 * iw0;
  const float gl1 = gd1 * iw1;
  const float gl2 = gd2 * iw2;
  const float wp = (1.f - u) - v;
  c[0] = gl0 * x;  c[1] = gl0 * y;  c[2] = gl0;
  c[3] = gl1 * x;  c[4] = gl1 * y;  c[5] = gl1;
  c[6] = gl2 * x;  c[7] = gl2 * y;  c[8] = gl2;
  c[9] = gz * x;   c[10] = gz * y;  c[11] = gz;
  c[12] = (-gd0 * d0) * iw0;
  c[13] = (-gd1 * d1) * iw1;
  c[14] = (-gd2 * d2) * iw2;
  c[15] = gtu * u;  c[16] = gtv * u;
  c[17] = gtu * v;  c[18] = gtv * v;
  c[19] = gtu * wp; c[20] = gtv * wp;
#pragma unroll
  for (int k = 0; k < 6; ++k) c[21 + k] = gc[k];
  if (FAST) {
#pragma unroll
    for (int k = 0; k < NLIVE; ++k)
      c[k] = __bfloat162float(__float2bfloat16_rn(c[k]));
  }
}

template <bool FAST, bool UVZ>
__global__ void __launch_bounds__(THREADS)
pixel_grad_kernel(const int* __restrict__ entry,
                  const float* __restrict__ u_pl,
                  const float* __restrict__ v_pl,
                  const float* __restrict__ extra,
                  const float* __restrict__ gtu,
                  const float* __restrict__ gtv,
                  const float* __restrict__ gcorners,
                  const float* __restrict__ guvz,
                  const int* __restrict__ bin_start, int gx, int pw,
                  int sample_ph, int64_t plane, int gbase,
                  float* __restrict__ grad_entries,
                  float* __restrict__ grad_global) {
  __shared__ float acc[CAP * NLIVE];
  const int tile = blockIdx.x;
  const int ti = tile / gx;
  const int tj = tile - ti * gx;
  const int tid = threadIdx.x;
  const int start = bin_start[tile];
  const int n = bin_start[tile + 1] - start;
  const int n_sh = min(n, CAP);

  for (int i = tid; i < n_sh * NLIVE; i += THREADS) acc[i] = 0.f;
  // rows past CAP take device atomics: zero them first
  for (int64_t i = tid; i < (int64_t)(n - n_sh) * REC; i += THREADS)
    grad_entries[(int64_t)(start + CAP) * REC + i] = 0.f;
  __syncthreads();

  const int lane = tid & 31;
  const int row = ti * TILE_H + (tid >> 5);
  const float y = (float)(row % sample_ph) + 0.5f;
  for (int pass = 0; pass < TILE_W / 32; ++pass) {
    const int col = tj * TILE_W + pass * 32 + lane;
    const int64_t p = (int64_t)row * pw + col;
    const int e = entry[p];
    float c[NLIVE];
    if (e >= 0) {
      coefficients<FAST, UVZ>(u_pl, v_pl, extra, gtu, gtv, gcorners, guvz,
                              plane, p, (float)col + 0.5f, y, c);
    } else {
#pragma unroll
      for (int k = 0; k < NLIVE; ++k) c[k] = 0.f;
    }
    // runs of equal entries along the warp (a triangle's pixels in a row
    // are contiguous): an inclusive segmented sum over each run, which the
    // run's last lane adds once
    const int e_prev = __shfl_up_sync(FULL, e, 1);
    const int e_next = __shfl_down_sync(FULL, e, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || e_prev != e);
    const int run0 = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int k = 0; k < NLIVE; ++k)
#pragma unroll
      for (int off = 1; off < 32 && summed<UVZ>(k); off <<= 1) {
        const float up = __shfl_up_sync(FULL, c[k], off);
        if (lane - off >= run0) c[k] += up;
      }
    if (e < 0 || (lane != 31 && e_next == e)) continue;
    // this lane adds c to row e
    float* dst;
    if (e >= gbase) {
      dst = grad_global + (int64_t)(e - gbase) * REC;
    } else {
      const int r = e - start;
      if (r < 0 || r >= n) continue;         // not this tile's bin
      if (r < CAP) {
#pragma unroll
        for (int k = 0; k < NLIVE; ++k)
          if (summed<UVZ>(k)) atomicAdd(&acc[r * NLIVE + k], c[k]);
        continue;
      }
      dst = grad_entries + (int64_t)e * REC;
    }
#pragma unroll
    for (int k = 0; k < NLIVE; ++k)
      if (summed<UVZ>(k)) atomicAdd(dst + slot(k), c[k]);
  }
  __syncthreads();

  for (int i = tid; i < n_sh * REC; i += THREADS) {
    const int r = i / REC;
    const int k = i - r * REC;
    const float val =
        (k == 12 || k >= 28) ? 0.f : acc[r * NLIVE + (k < 12 ? k : k - 1)];
    grad_entries[(int64_t)(start + r) * REC + k] = val;
  }
}

// the position of t in the ascending a[lo, hi), or -1
__device__ __forceinline__ int find(const int* __restrict__ a, int lo,
                                    int hi, int t) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int v = a[mid];
    if (v == t) return mid;
    if (v < t) lo = mid + 1; else hi = mid;
  }
  return -1;
}

__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const float* __restrict__ grad_entries,
            const float* __restrict__ grad_global,
            const int* __restrict__ tile_ids,
            const int* __restrict__ bin_start,
            const int* __restrict__ sorted_tri,
            const int* __restrict__ global_idx,
            const int* __restrict__ n_global_ptr, int n_tiles, int n_tris,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int group = lane & ~(WIN - 1);         // first lane of triangle j
  const int t = (blockIdx.x * FOLD_THREADS + threadIdx.x) / WIN;
  const bool own = t < n_tris;
  // lane (j, k): slot k of triangle t
  const int tile =
      own ? __ldcs(tile_ids + (int64_t)t * WIN + (lane & (WIN - 1)))
          : n_tiles;
  const bool live = tile < n_tiles;
  const int pos =
      live ? find(sorted_tri, bin_start[tile], bin_start[tile + 1], t) : -1;
  // every lane takes part in the ballot, owner of a triangle or not
  const unsigned any_live =
      __ballot_sync(FULL, live) & (((1u << WIN) - 1) << group);
  const int gpos =
      own && !any_live ? find(global_idx, 0, *n_global_ptr, t) : -1;

  // lane (j, q): record slots 4q..4q+3 of triangle t's rows
  const int q = lane & (WIN - 1);
  float4 row[WIN];
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
    const int p = __shfl_sync(FULL, pos, group | k);
    row[k] = p >= 0 ? __ldcs(reinterpret_cast<const float4*>(
                          grad_entries + (int64_t)p * REC) + q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4 g = gpos >= 0 ? __ldg(reinterpret_cast<const float4*>(
                                   grad_global + (int64_t)gpos * REC) + q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < WIN; ++k) {
    s.x += row[k].x; s.y += row[k].y; s.z += row[k].z; s.w += row[k].w;
  }
  if (gpos >= 0) {
    s.x += g.x; s.y += g.y; s.z += g.z; s.w += g.w;
  }
  if (q == 3) s.x = 0.f;                        // slot 12, the id
  if (q == 7) s = make_float4(0.f, 0.f, 0.f, 0.f);   // slots 28-31
  if (own)
    __stcs(reinterpret_cast<float4*>(out + (int64_t)t * REC) + q, s);
}

}  // namespace

// guvz null: the instance without UVZ (u, v, z cotangents 0, not read)
extern "C" int pixel_grad_launch(const int* entry, const float* u,
                                 const float* v, const float* extra,
                                 const float* gtu, const float* gtv,
                                 const float* gcorners, const float* guvz,
                                 const int* bin_start, int n_tiles, int gx,
                                 int rows, int sample_ph, int gbase,
                                 float* grad_entries, float* grad_global,
                                 int max_global, int fast, void* stream) {
  if (sample_ph < TILE_H || sample_ph % TILE_H || rows % sample_ph)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      grad_global, 0, (size_t)max_global * REC * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int pw = gx * TILE_W;
  decltype(&pixel_grad_kernel<false, false>) kernel =
      fast ? (guvz ? &pixel_grad_kernel<true, true>
                   : &pixel_grad_kernel<true, false>)
           : (guvz ? &pixel_grad_kernel<false, true>
                   : &pixel_grad_kernel<false, false>);
  kernel<<<n_tiles, THREADS, 0, st>>>(
      entry, u, v, extra, gtu, gtv, gcorners, guvz, bin_start, gx, pw,
      sample_ph, (int64_t)rows * pw, gbase, grad_entries, grad_global);
  return (int)cudaGetLastError();
}

extern "C" int fold_entries_launch(const float* grad_entries,
                                   const float* grad_global,
                                   const int* tile_ids, const int* bin_start,
                                   const int* sorted_tri,
                                   const int* global_idx, const int* n_global,
                                   int n_tiles, int n_tris, float* out,
                                   void* stream) {
  if (n_tris <= 0) return 0;
  const unsigned blocks =
      (unsigned)(((int64_t)n_tris * WIN + FOLD_THREADS - 1) / FOLD_THREADS);
  fold_kernel<<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      grad_entries, grad_global, tile_ids, bin_start, sorted_tri, global_idx,
      n_global, n_tiles, n_tris, out);
  return (int)cudaGetLastError();
}
