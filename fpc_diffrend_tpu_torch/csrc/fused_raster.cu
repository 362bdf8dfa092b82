// K1: fused rasterize + interpolate + texture over the stacked batch image.
//
// Replaces fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py _fused_kernel
// (launched by fused_rasterize_from_bins; body _fused_tile_body, phase A
// _phasea_block, texture tail _sample_tile). Ported is what it computes,
// not its TPU layout: the one-hot MXU record gather, the hat-matrix texture
// matmuls, the 4-slot DMA rotation and the VMEM carries are gone.
//
// Per pixel: the nearest covered triangle among its 8x128 tile's bin
// entries, then the global (oversized) rows whose tile box holds the tile.
// Covered means all three normalized edge planes >= 0 (both windings) and
// z in [-1, 1]; a strictly smaller z wins, entries are tested in order, so
// the lowest entry wins a tie. Then the winner's perspective-correct
// (u, v), interpolated (tu, tv), screen corners and neighbour ids, the 8
// residual planes of the backward, and a bilinear wrap sample of the
// texture. A pixel nothing covers resolves an all-zero record: uv (0, 0).
//
// Design: one block per pixel row of a tile (8 blocks per tile, 128
// threads, one per pixel), so eight blocks share an SM at 56 registers and
// one block's staging and barriers overlap the others' tests and stores;
// 4-row and whole-tile blocks ran slower on the H100. A block stages the
// 12 plane coefficients of 128 bin records at a time in shared memory
// (6 KB; the 8 blocks of a tile read the same bin, from L2); every thread
// of a warp reads the same record, a broadcast. The winner's full 32-float
// record is then read once, directly, by its entry index (int32: exact at
// any bin size, where the TPU carried it as f32). The records are in each
// sample's own frame, so a pixel of stacked row r is evaluated at its
// sample's row r % sample_ph (a tile lies in one sample: sample_ph is whole
// tiles); the TPU kernel takes records shifted into the stacked frame,
// whose planes lose their low bits in f32 at rows far down the stack.
// Planes are evaluated as
// a*x + (b*y + c) per pixel with every product and sum rounded (built with
// -fmad=false), the order of the plain PyTorch version, so kernel and
// plain version agree exactly on ids and entries.
//
// Bound on the H100: the writes. 100 bytes a pixel (id 4, entry 4,
// payload 56, extra 32, colour 4 per channel), against ~16 flops per
// (pixel, bin entry) test; at the bench shapes that is ~1.64 GB of writes
// (~0.5 ms at 3.35 TB/s) and ~10 GFLOP of tests. All stores are
// coalesced: a warp writes 32 consecutive pixels of a row of each plane.
//
// K10: K1 with the antialias (fused_raster_aa_launch). Replaces the
// antialias tail of the same TPU kernel (aa=True: rasterize_tpu.py
// _aa_tile, _aa_empty_tile, the side outputs folded by _fold_aa_sides),
// which blends each tile while its planes are in VMEM and carries the
// tile's last row and column to its neighbour between grid steps that run
// in order. On the H100 the blend of a pixel pair across two blocks needs
// both blocks' planes, and blocks run in no order, so a fused kernel pays
// for that dependency. Device time at the bench's single view on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_turns.py, PERF.md): one
// 1024-thread block a tile with a seam launch for the border pixels,
// 0.223 ms; K1's row blocks as a thread-block cluster a tile, blending
// through distributed shared memory, with a seam, 0.212 (the cluster
// launch 0.010, its barriers 0.024, the seam 0.028); K1's kernel then
// K2's, 0.167. So K10 launches this file's K1 kernel and then K2's
// kernel (antialias_fwd.cuh, which K2's library builds too) from one
// entry point: its ids, entries, payload, extra and colour are K1's and
// its aa is K2's, exactly, by construction.
//
// Bound on the H100: the bytes, K1's plus the C aa planes written (4 C
// bytes a pixel); K2's reads of the planes K1 wrote are the price of the
// two launches (chip_smoke.py k10_design_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "antialias_fwd.cuh"

namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int CHUNK = 128;
constexpr int REC = 32;
constexpr int NCOEF = 12;          // a0 b0 c0 a1 b1 c1 a2 b2 c2 zx zy zc
constexpr int N_PAYLOAD = 14;
constexpr int N_EXTRA = 8;
constexpr float BIG = 3.0e38f;
constexpr float W_EPS = 1e-9f;
constexpr float AREA_EPS = 1e-12f;

__device__ __forceinline__ float plane(float a, float b, float c, float x,
                                       float y) {
  return __fadd_rn(__fmul_rn(a, x), __fadd_rn(__fmul_rn(b, y), c));
}

// Merge one record's coverage test into the pixel's (z, entry) minimum.
__device__ __forceinline__ void test_record(const float* r, float x, float y,
                                            int entry, float& bz, int& be) {
  const float4 q0 = reinterpret_cast<const float4*>(r)[0];
  const float4 q1 = reinterpret_cast<const float4*>(r)[1];
  const float4 q2 = reinterpret_cast<const float4*>(r)[2];
  const float l0 = plane(q0.x, q0.y, q0.z, x, y);
  const float l1 = plane(q0.w, q1.x, q1.y, x, y);
  const float l2 = plane(q1.z, q1.w, q2.x, x, y);
  const float z = plane(q2.y, q2.z, q2.w, x, y);
  const bool covered = (l0 >= 0.f) && (l1 >= 0.f) && (l2 >= 0.f) &&
                       (z >= -1.f) && (z <= 1.f);
  if (covered && z < bz) {
    bz = z;
    be = entry;
  }
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// One block of 128 threads, one pixel each, a pixel row of a tile: 8
// blocks a tile.
__global__ void __launch_bounds__(TILE_W, 8)
fused_raster_kernel(const float* __restrict__ rec,
                    const float* __restrict__ glob,
                    const int* __restrict__ gbox,
                    const int* __restrict__ n_global_ptr,
                    const int* __restrict__ bin_start,
                    const float* __restrict__ tex, int th, int tw, int nchan,
                    int gx, int gbase, int pw, int sample_ph,
                    int64_t plane_stride,
                    int* __restrict__ id_out, int* __restrict__ entry_out,
                    float* __restrict__ payload, float* __restrict__ extra,
                    float* __restrict__ colour) {
  constexpr int THREADS = TILE_W;
  __shared__ __align__(16) float s_rec[CHUNK * NCOEF];
  __shared__ int s_box[CHUNK * 4];

  const int tile = blockIdx.x / TILE_H;
  const int ti = tile / gx;
  const int tj = tile - ti * gx;
  const int tid = threadIdx.x;
  const int row = ti * TILE_H + blockIdx.x % TILE_H;
  const int col_x = tj * TILE_W + threadIdx.x;
  const float x = (float)col_x + 0.5f;
  const float y = (float)(row % sample_ph) + 0.5f;

  float bz = BIG;
  int be = -1;

  // ---- the tile's bin, 128 records at a time ----
  const int start = bin_start[tile];
  const int end = bin_start[tile + 1];
  for (int base = start; base < end; base += CHUNK) {
    const int n = min(CHUNK, end - base);
    __syncthreads();
    for (int i = tid; i < n * NCOEF; i += THREADS) {
      const int r = i / NCOEF;
      s_rec[i] = rec[(int64_t)(base + r) * REC + (i - r * NCOEF)];
    }
    __syncthreads();
    for (int r = 0; r < n; ++r)
      test_record(&s_rec[r * NCOEF], x, y, base + r, bz, be);
  }

  // ---- the global list: rows whose tile box holds this tile ----
  const int n_global = *n_global_ptr;
  for (int base = 0; base < n_global; base += CHUNK) {
    const int n = min(CHUNK, n_global - base);
    __syncthreads();
    for (int i = tid; i < n * NCOEF; i += THREADS) {
      const int r = i / NCOEF;
      s_rec[i] = glob[(int64_t)(base + r) * REC + (i - r * NCOEF)];
    }
    for (int i = tid; i < n * 4; i += THREADS) s_box[i] = gbox[base * 4 + i];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const int* b = &s_box[r * 4];
      if (tj >= b[0] && tj <= b[2] && ti >= b[1] && ti <= b[3])
        test_record(&s_rec[r * NCOEF], x, y, gbase + base + r, bz, be);
    }
  }

  // ---- the winner's record, read once by its entry index ----
  const bool hit = bz < BIG;
  float f[REC];
  if (hit) {
    const float4* src = reinterpret_cast<const float4*>(
        be < gbase ? rec + (int64_t)be * REC
                   : glob + (int64_t)(be - gbase) * REC);
#pragma unroll
    for (int q = 0; q < REC / 4; ++q) {
      const float4 v = src[q];
      f[4 * q] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < REC; ++k) f[k] = 0.f;
  }

  const float l0 = plane(f[0], f[1], f[2], x, y);
  const float l1 = plane(f[3], f[4], f[5], x, y);
  const float l2 = plane(f[6], f[7], f[8], x, y);
  const float iw0 = 1.f / (fabsf(f[13]) > W_EPS ? f[13] : 1.f);
  const float iw1 = 1.f / (fabsf(f[14]) > W_EPS ? f[14] : 1.f);
  const float iw2 = 1.f / (fabsf(f[15]) > W_EPS ? f[15] : 1.f);
  const float d0 = l0 * iw0;
  const float d1 = l1 * iw1;
  const float d2 = l2 * iw2;
  const float D = (d0 + d1) + d2;
  const float rD = 1.f / (fabsf(D) > AREA_EPS ? D : 1.f);
  const float up = d0 * rD;
  const float vp = d1 * rD;
  const float du02 = f[16] - f[20];
  const float du12 = f[18] - f[20];
  const float dv02 = f[17] - f[21];
  const float dv12 = f[19] - f[21];
  const float tu = (up * du02 + vp * du12) + f[20];
  const float tv = (up * dv02 + vp * dv12) + f[21];

  const int64_t p = (int64_t)row * pw + col_x;
  id_out[p] = hit ? (int)f[12] : -1;
  entry_out[p] = hit ? be : -1;
  const float pay[N_PAYLOAD] = {up,    vp,    hit ? bz : 0.f, tu,    tv,
                                f[22], f[23], f[24],          f[25], f[26],
                                f[27], f[28], f[29],          f[30]};
#pragma unroll
  for (int k = 0; k < N_PAYLOAD; ++k) payload[k * plane_stride + p] = pay[k];
  const float ext[N_EXTRA] = {D, iw0, iw1, iw2, du02, du12, dv02, dv12};
#pragma unroll
  for (int k = 0; k < N_EXTRA; ++k) extra[k * plane_stride + p] = ext[k];

  // ---- bilinear wrap sample of the (th, tw, nchan) texture ----
  const float s = tu * (float)tw - 0.5f;
  const float t = tv * (float)th - 0.5f;
  const float s0f = floorf(s);
  const float t0f = floorf(t);
  const float fs = s - s0f;
  const float ft = t - t0f;
  const int s0 = (int)s0f;
  const int t0 = (int)t0f;
  const int s1w = wrap(s0 + 1, tw);
  const int t1w = wrap(t0 + 1, th);
  const int s0w = wrap(s0, tw);
  const int t0w = wrap(t0, th);
  for (int c = 0; c < nchan; ++c) {
    const float c00 = tex[((int64_t)t0w * tw + s0w) * nchan + c];
    const float c01 = tex[((int64_t)t0w * tw + s1w) * nchan + c];
    const float c10 = tex[((int64_t)t1w * tw + s0w) * nchan + c];
    const float c11 = tex[((int64_t)t1w * tw + s1w) * nchan + c];
    const float top = c00 * (1.f - fs) + c01 * fs;
    const float bot = c10 * (1.f - fs) + c11 * fs;
    colour[c * plane_stride + p] = top * (1.f - ft) + bot * ft;
  }
}

void launch_k1(const float* rec, const float* glob, const int* gbox,
               const int* n_global, const int* bin_start, const float* tex,
               int th, int tw, int nchan, int n_tiles, int gx, int gbase,
               int rows, int sample_ph, int* id_out, int* entry_out,
               float* payload, float* extra, float* colour, cudaStream_t st) {
  const int pw = gx * TILE_W;
  fused_raster_kernel<<<n_tiles * TILE_H, TILE_W, 0, st>>>(
      rec, glob, gbox, n_global, bin_start, tex, th, tw, nchan, gx, gbase, pw,
      sample_ph, (int64_t)rows * pw, id_out, entry_out, payload, extra,
      colour);
}

}  // namespace

extern "C" int fused_raster_launch(
    const float* rec, const float* glob, const int* gbox, const int* n_global,
    const int* bin_start, const float* tex, int th, int tw, int nchan,
    int n_tiles, int gx, int gbase, int rows, int sample_ph, int* id_out,
    int* entry_out, float* payload, float* extra, float* colour,
    void* stream) {
  if (sample_ph < TILE_H || sample_ph % TILE_H || rows % sample_ph)
    return (int)cudaErrorInvalidValue;
  launch_k1(rec, glob, gbox, n_global, bin_start, tex, th, tw, nchan, n_tiles,
            gx, gbase, rows, sample_ph, id_out, entry_out, payload, extra,
            colour, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K10: K1's kernel, then K2's on the planes it wrote.
extern "C" int fused_raster_aa_launch(
    const float* rec, const float* glob, const int* gbox, const int* n_global,
    const int* bin_start, const float* tex, int th, int tw, int nchan,
    int n_tiles, int gx, int gbase, int rows, int height, int width,
    int sample_ph, int* id_out, int* entry_out, float* payload, float* extra,
    float* colour, float* aa_out, void* stream) {
  const int pw = gx * TILE_W;
  if (!aa_fwd::valid(rows, pw, nchan, sample_ph) || sample_ph % TILE_H ||
      rows % sample_ph)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  launch_k1(rec, glob, gbox, n_global, bin_start, tex, th, tw, nchan, n_tiles,
            gx, gbase, rows, sample_ph, id_out, entry_out, payload, extra,
            colour, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  aa_fwd::launch(st, id_out, payload, colour, rows, pw, nchan, height, width,
                 sample_ph, aa_out);
  return (int)cudaGetLastError();
}
