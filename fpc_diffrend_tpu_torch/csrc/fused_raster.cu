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
// any bin size, where the TPU carried it as f32). Planes are evaluated as
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
// K10: K1 with the antialias in the same pass (fused_raster_aa_launch).
// Replaces the antialias tail of the same TPU kernel (aa=True:
// rasterize_tpu.py _aa_tile, _aa_empty_tile, the side outputs folded by
// _fold_aa_sides). It computes what K2 computes over K1's planes (csrc/
// antialias.cu; plain version: antialias_planes_plain of
// fused_raster_plain), and still writes K1's outputs, which the backward
// (K3-K5) reads. The TPU kernel walks the tiles in order and carries each
// tile's last row and column to its neighbour through VMEM; blocks on the
// H100 run in no order, so the carries become a second launch:
//   * one block per 8x128 tile (1024 threads): each pixel resolves as in
//     K1 (the same code, so ids, entries, payload, extra and colour are
//     K1's exactly), writes them, and stores its packed antialias planes
//     [id, z, corners, neighbours, colour] in shared memory; after a
//     barrier each pixel whose four neighbours lie in the tile writes K2's
//     sum for itself from shared memory (antialias_pair.cuh blend_pixel);
//   * the seam launch then writes the tile's 268 border pixels (rows 0
//     and 7, columns 0 and 127), the same sum read from the planes the
//     first launch wrote to device memory.
// Every pixel's aa is K2's sum in K2's order from the same floats, so it
// equals K2's output exactly.
//
// Bound on the H100: the bytes, K1's plus the C aa planes written (4 C
// bytes a pixel); the seam re-reads the border pixels' planes (~26 % of
// the image) from L2. The in-tile blend saves K2's read of 11 + C planes
// for the other ~74 %.

#include <cuda_runtime.h>
#include <stdint.h>

#include "antialias_pair.cuh"

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
constexpr int AA_THREADS = TILE_H * TILE_W;
constexpr int SEAM_PX = 2 * TILE_W + 2 * (TILE_H - 2);   // border pixels

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

// One block of ROWS pixel rows of a tile. K1: ROWS = 1, 8 blocks a tile,
// 128 threads. K10 (AA): ROWS = 8, one block a tile, and the in-tile
// antialias from the packed planes in dynamic shared memory.
template <int ROWS, bool AA>
__global__ void __launch_bounds__(ROWS * TILE_W, 8 / ROWS)
fused_raster_kernel(const float* __restrict__ rec,
                    const float* __restrict__ glob,
                    const int* __restrict__ gbox,
                    const int* __restrict__ n_global_ptr,
                    const int* __restrict__ bin_start,
                    const float* __restrict__ tex, int th, int tw, int nchan,
                    int gx, int gbase, int pw, int64_t plane_stride,
                    int* __restrict__ id_out, int* __restrict__ entry_out,
                    float* __restrict__ payload, float* __restrict__ extra,
                    float* __restrict__ colour, int height, int width,
                    int sample_ph, float* __restrict__ aa_out) {
  constexpr int SPLIT = TILE_H / ROWS;    // blocks per tile
  constexpr int THREADS = ROWS * TILE_W;
  __shared__ __align__(16) float s_rec[CHUNK * NCOEF];
  __shared__ int s_box[CHUNK * 4];

  const int tile = blockIdx.x / SPLIT;
  const int ti = tile / gx;
  const int tj = tile - ti * gx;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int row = ti * TILE_H + (blockIdx.x % SPLIT) * ROWS + threadIdx.y;
  const int col_x = tj * TILE_W + threadIdx.x;
  const float x = (float)col_x + 0.5f;
  const float y = (float)row + 0.5f;

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
  // K10 keeps the packed antialias planes of the tile in shared memory:
  // (11 + nchan) planes of THREADS [id, z, corners, neighbours, colour]
  extern __shared__ float s_pk[];
  for (int c = 0; c < nchan; ++c) {
    const float c00 = tex[((int64_t)t0w * tw + s0w) * nchan + c];
    const float c01 = tex[((int64_t)t0w * tw + s1w) * nchan + c];
    const float c10 = tex[((int64_t)t1w * tw + s0w) * nchan + c];
    const float c11 = tex[((int64_t)t1w * tw + s1w) * nchan + c];
    const float top = c00 * (1.f - fs) + c01 * fs;
    const float bot = c10 * (1.f - fs) + c11 * fs;
    const float value = top * (1.f - ft) + bot * ft;
    colour[c * plane_stride + p] = value;
    if (AA) s_pk[(aa::N_GEOM + c) * THREADS + tid] = value;
  }
  if (!AA) return;

  // ---- K10: the rest of the packed planes, then K2's sum for every pixel
  // whose four neighbours are in the tile ----
  s_pk[tid] = __int_as_float(hit ? (int)f[12] : -1);
  s_pk[THREADS + tid] = pay[2];
#pragma unroll
  for (int k = 0; k < 6; ++k) s_pk[(2 + k) * THREADS + tid] = pay[5 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) s_pk[(8 + k) * THREADS + tid] = pay[11 + k];
  __syncthreads();
  const int ly = row - ti * TILE_H;
  if (threadIdx.x == 0 || threadIdx.x == TILE_W - 1 || ly == 0 ||
      ly == TILE_H - 1)
    return;                            // a border pixel: the seam's
  const aa::SharedPlanes planes{s_pk, THREADS};
  float acc[aa::MAX_C];
  aa::blend_pixel(planes, tid, TILE_W, row, col_x, nchan, height, width,
                  sample_ph, acc);
#pragma unroll
  for (int c = 0; c < aa::MAX_C; ++c)
    if (c < nchan) aa_out[c * plane_stride + p] = acc[c];
}

// K10's seam pass: K2's sum for the border pixels of every tile (rows 0 and
// TILE_H - 1, then columns 0 and TILE_W - 1 of the rows between), read
// from the planes the raster pass wrote.
__global__ void __launch_bounds__(256)
aa_seam_kernel(const int* __restrict__ idbuf,
               const float* __restrict__ payload,
               const float* __restrict__ colour, int n_tiles, int gx, int pw,
               int64_t plane, int nchan, int height, int width,
               int sample_ph, float* __restrict__ aa_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n_tiles * SEAM_PX) return;
  const int tile = (int)(i / SEAM_PX);
  const int k = (int)(i - (int64_t)tile * SEAM_PX);
  int ly, lx;
  if (k < 2 * TILE_W) {
    ly = k < TILE_W ? 0 : TILE_H - 1;
    lx = k % TILE_W;
  } else {
    ly = 1 + (k - 2 * TILE_W) / 2;
    lx = (k & 1) ? TILE_W - 1 : 0;
  }
  const int ti = tile / gx;
  const int r = ti * TILE_H + ly;
  const int x = (tile - ti * gx) * TILE_W + lx;
  const int64_t p = (int64_t)r * pw + x;
  const aa::GlobalPlanes planes{idbuf, payload, colour, plane};
  float acc[aa::MAX_C];
  aa::blend_pixel(planes, p, (int64_t)pw, r, x, nchan, height, width,
                  sample_ph, acc);
#pragma unroll
  for (int c = 0; c < aa::MAX_C; ++c)
    if (c < nchan) aa_out[c * plane + p] = acc[c];
}

}  // namespace

extern "C" int fused_raster_launch(
    const float* rec, const float* glob, const int* gbox, const int* n_global,
    const int* bin_start, const float* tex, int th, int tw, int nchan,
    int n_tiles, int gx, int gbase, int rows, int* id_out, int* entry_out,
    float* payload, float* extra, float* colour, void* stream) {
  const int pw = gx * TILE_W;
  fused_raster_kernel<1, false><<<n_tiles * TILE_H, dim3(TILE_W, 1), 0,
                                  (cudaStream_t)stream>>>(
      rec, glob, gbox, n_global, bin_start, tex, th, tw, nchan, gx, gbase, pw,
      (int64_t)rows * pw, id_out, entry_out, payload, extra, colour, 0, 0, 1,
      nullptr);
  return (int)cudaGetLastError();
}

extern "C" int fused_raster_aa_launch(
    const float* rec, const float* glob, const int* gbox, const int* n_global,
    const int* bin_start, const float* tex, int th, int tw, int nchan,
    int n_tiles, int gx, int gbase, int rows, int height, int width,
    int sample_ph, int* id_out, int* entry_out, float* payload, float* extra,
    float* colour, float* aa_out, void* stream) {
  if (nchan < 1 || nchan > aa::MAX_C) return (int)cudaErrorInvalidValue;
  const int pw = gx * TILE_W;
  const int64_t plane = (int64_t)rows * pw;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)(aa::N_GEOM + nchan) * AA_THREADS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_raster_kernel<TILE_H, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_raster_kernel<TILE_H, true><<<n_tiles, dim3(TILE_W, TILE_H), smem,
                                      st>>>(
      rec, glob, gbox, n_global, bin_start, tex, th, tw, nchan, gx, gbase, pw,
      plane, id_out, entry_out, payload, extra, colour, height, width,
      sample_ph, aa_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_seam = (int64_t)n_tiles * SEAM_PX;
  aa_seam_kernel<<<(unsigned)((n_seam + 255) / 256), 256, 0, st>>>(
      id_out, payload, colour, n_tiles, gx, pw, plane, nchan, height, width,
      sample_ph, aa_out);
  return (int)cudaGetLastError();
}
