// K11: stable bin placement of the stacked binning.
//
// Replaces the TPU kernels _count_kernel and _place_kernel of
// fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py (:350, :385, launched by
// _place_pallas :414). Input: the (tile, triangle) pair slots of the
// stacked batch, tile_ids (B, T, K) int32 with the sentinel n_tiles for a
// dead slot; slot i belongs to the stacked triangle i / K = b * T + t.
// Output: bin_start (n_tiles + 1), the bin offsets clamped to P, and
// sorted_tri (P): the stacked triangle id of each entry, grouped by tile,
// ascending inside each bin, cut at P (the entry cap), and the sentinel
// B * T past the live prefix. That is exactly the kept prefix of a sort of
// the keys tile * B * T + b * T + t.
//
// Bound: bytes. The function reads the slots once and writes sorted_tri
// and bin_start once: ~10.6 MB, ~0.0032 ms at the bench (1.9 M slots,
// P = 0.72 M at the autotuned cap) against HBM's 3.35 TB/s, below the
// latency of any design with a dependency across the grid.
//
// Design: a stable counting sort in three launches of one entry point, no
// memset, copy or scan between them. The slots come in ascending triangle
// order, so a placement that keeps slot order inside each bin needs no
// rank step across the bin: G blocks each take a contiguous run of whole
// triangles, and a block's entries of a tile follow those of the blocks
// before it.
// 1. count_rows_kernel: a block counts its run's live slots per tile in a
//    shared-memory histogram, written whole to row j of a (G, n_tiles)
//    matrix (so nothing needs zeroing first).
// 2. scan_rows_kernel: one thread a tile turns its column into the
//    exclusive prefix over the blocks before each row, in place, and
//    writes the tile's total.
// 3. place_shared_kernel: each block scans the totals into the bin
//    offsets (every block the whole scan, so no flag or ticket joins the
//    blocks; block 0 writes bin_start clamped to P, every block part of
//    the sentinel fill past the total) and its own counts into local
//    offsets, stages its run's live slots tile by tile in shared memory
//    through one cursor a tile (in an arbitrary order inside a tile), then
//    writes each entry at its bin's offset + its block's prefix + its
//    triangle's rank among the block's entries of that tile, if that is
//    below P: a bin that straddles P keeps its lowest triangles.
//    place_rows_kernel does the same with the staging in device memory
//    where two n_tiles arrays and the run do not fit a block's shared
//    memory (past ~21,000 tiles at the bench's run of 14,440 slots), or
//    n_tiles reaches 2^16; past 57,344 tiles its cursors and the
//    histograms live in device memory too (in_device_memory).
// What binds at the bench is the (G, n_tiles) matrix: written, read and
// written by the scan, read three times by the placement with the totals
// beside it, ~7 x 8.4 MB mostly through L2, against the slots' 2 x 7.6 MB
// (chip_smoke.py k11_design_bytes; PERF.md for the variants measured).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COUNT_THREADS = 1024;
constexpr int COUNT_BLOCKS = 264;          // 2 per SM of the H100's 132
constexpr int GLOBAL_THREADS = 256;
constexpr int ROW_THREADS = 1024;          // count_rows and the placements
constexpr int SCAN_THREADS = 128;          // scan_rows: a thread a tile
constexpr int SCAN_BATCH = 32;             // rows a thread loads at once
constexpr int UNROLL = 4;                  // slots a thread loads at once
constexpr int LOCAL_ITEMS = 8;             // tiles a thread scans at once
constexpr int SCAN_ITEMS = 16;             // tiles a thread adds up in place
constexpr unsigned FULL = 0xffffffffu;

__global__ void count_kernel(const int* __restrict__ tile_ids, int64_t np,
                             int n_tiles, int* __restrict__ counts) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int64_t chunk = (np + gridDim.x - 1) / gridDim.x;
  const int64_t lo = (int64_t)blockIdx.x * chunk;
  const int64_t hi = lo + chunk < np ? lo + chunk : np;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int t = tile_ids[i];
    if (t >= 0 && t < n_tiles) atomicAdd(&hist[t], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    const int c = hist[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

__global__ void count_global_kernel(const int* __restrict__ tile_ids,
                                    int64_t np, int n_tiles,
                                    int* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += stride) {
    const int t = tile_ids[i];
    if (t >= 0 && t < n_tiles) atomicAdd(&counts[t], 1);
  }
}

// Row j of rows (G, n_tiles) <- the live slots of block j's run per tile.
__global__ void __launch_bounds__(ROW_THREADS)
count_rows_kernel(const int* __restrict__ tile_ids, int64_t np, int64_t run,
                  int n_tiles, int in_device_memory, int* __restrict__ rows) {
  extern __shared__ int s_hist[];
  int* row = rows + (int64_t)blockIdx.x * n_tiles;
  int* hist = in_device_memory ? row : s_hist;
  for (int t = threadIdx.x; t < n_tiles; t += ROW_THREADS) hist[t] = 0;
  __syncthreads();
  const int64_t lo = (int64_t)blockIdx.x * run;
  const int64_t hi = lo + run < np ? lo + run : np;
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += UNROLL * ROW_THREADS) {
    int t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * ROW_THREADS;
      t[u] = i < hi ? tile_ids[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (t[u] >= 0 && t[u] < n_tiles) atomicAdd(&hist[t[u]], 1);
  }
  if (in_device_memory) return;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += ROW_THREADS) row[t] = s_hist[t];
}

// Each tile's column of rows becomes the exclusive prefix over the blocks
// before each row; tot[t] <- the tile's live slots. A batch of rows is
// loaded at once, so the column costs G / SCAN_BATCH round trips.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_rows_kernel(int* __restrict__ rows, int G, int n_tiles,
                 int* __restrict__ tot) {
  const int t = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (t >= n_tiles) return;
  int* col = rows + t;
  int run = 0;
  for (int j = 0; j < G; j += SCAN_BATCH) {
    int v[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      v[k] = j + k < G ? col[(int64_t)(j + k) * n_tiles] : 0;
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k) {
      if (j + k < G) col[(int64_t)(j + k) * n_tiles] = run;
      run += v[k];
    }
  }
  tot[t] = run;
}

// The exclusive scan of one int a thread over the block; *total <- the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < ROW_THREADS / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[ROW_THREADS / 32 - 1];
  __syncthreads();                     // s_warp is reused by the next call
  return before + x - v;
}

// Block j places its run's live slots, in device memory: bin offset + the
// prefix of the blocks before it (rows, after scan_rows) + the rank of its
// triangle among the block's own entries of that tile.
__global__ void __launch_bounds__(ROW_THREADS)
place_rows_kernel(const int* __restrict__ tile_ids, int64_t np, int64_t run,
                  int K, int n_tiles, int G, const int* __restrict__ rows,
                  const int* __restrict__ tot, int* __restrict__ cur_rows,
                  int* __restrict__ stage, int P, int sentinel,
                  int* __restrict__ bin_start, int* __restrict__ sorted_tri) {
  extern __shared__ int s_cur[];
  __shared__ int s_warp[ROW_THREADS / 32];
  const int j = blockIdx.x, tid = threadIdx.x;
  const int* pre = rows + (int64_t)j * n_tiles;
  int* cur = cur_rows ? cur_rows + (int64_t)j * n_tiles : s_cur;

  // 1. cur[t] = the tile's bin offset + this block's prefix in it
  int carry = 0;
  for (int base = 0; base < n_tiles; base += ROW_THREADS * SCAN_ITEMS) {
    const int t0 = base + tid * SCAN_ITEMS;
    int v[SCAN_ITEMS];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = t0 + k < n_tiles ? tot[t0 + k] : 0;
      sum += v[k];
    }
    int total;
    int s = carry + block_exclusive_scan(sum, s_warp, &total);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const int t = t0 + k;
      if (t < n_tiles) {
        cur[t] = s + pre[t];
        if (j == 0) bin_start[t] = s < P ? s : P;
      }
      s += v[k];
    }
    carry += total;
  }
  const int n_live = carry;
  if (j == 0 && tid == 0) bin_start[n_tiles] = n_live < P ? n_live : P;
  for (int i = n_live + j * ROW_THREADS + tid; i < P; i += G * ROW_THREADS)
    sorted_tri[i] = sentinel;
  __syncthreads();

  // 2. the run's live slots, each tile's in an arbitrary order
  const int64_t lo = (int64_t)j * run;
  const int64_t hi = lo + run < np ? lo + run : np;
  for (int64_t i0 = lo + tid; i0 < hi; i0 += UNROLL * ROW_THREADS) {
    int t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * ROW_THREADS;
      t[u] = i < hi ? tile_ids[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (t[u] >= 0 && t[u] < n_tiles)
        stage[atomicAdd(&cur[t[u]], 1)] =
            (int)((i0 + u * ROW_THREADS) / K);
  }
  __syncthreads();

  // 3. each entry at its triangle's rank among the block's entries of its
  // tile, stage[end - n, end) (ties, a triangle that names a tile twice,
  // by its slot order)
  const int* next = j + 1 < G ? rows + (int64_t)(j + 1) * n_tiles : tot;
  for (int64_t i = lo + tid; i < hi; i += ROW_THREADS) {
    const int t = tile_ids[i];
    if (!(t >= 0 && t < n_tiles)) continue;
    const int end = cur[t];
    const int begin = end - (next[t] - pre[t]);
    if (begin >= P) continue;
    const int tri = (int)(i / K);
    int below = 0, same = 0;
    for (int q = begin; q < end; ++q) {
      const int w = stage[q];
      below += w < tri;
      same += w == tri;
    }
    if (same > 1)
      for (int64_t q = (int64_t)tri * K; q < i; ++q) below += tile_ids[q] == t;
    if (begin + below < P) sorted_tri[begin + below] = tri;
  }
}

// K11's placement where a block's per-tile arrays and its run fit its
// shared memory (n_tiles < 2^16, run < 2^16 slots): each tile's global
// begin for this block, its count and local cursor packed in one word, and
// the run's live entries staged locally, tile by tile, as tile << 16 |
// the triangle's offset in the run. The rank is then taken in shared
// memory.
__global__ void __launch_bounds__(ROW_THREADS)
place_shared_kernel(const int* __restrict__ tile_ids, int64_t np, int64_t run,
                    int K, int n_tiles, int G, const int* __restrict__ rows,
                    const int* __restrict__ tot, int P, int sentinel,
                    int* __restrict__ bin_start,
                    int* __restrict__ sorted_tri) {
  extern __shared__ int s_mem[];
  __shared__ int s_warp[ROW_THREADS / 32];
  int* s_beg = s_mem;
  unsigned* s_lc = reinterpret_cast<unsigned*>(s_mem + n_tiles);
  unsigned* s_stage = s_lc + n_tiles;
  const int j = blockIdx.x, tid = threadIdx.x;
  const int* pre = rows + (int64_t)j * n_tiles;
  const int* next = j + 1 < G ? rows + (int64_t)(j + 1) * n_tiles : tot;

  // 1. the tiles' bin offsets (the scan of tot) and this block's local
  // offsets (the scan of its own counts): the inputs read coalesced into
  // shared memory, scanned LOCAL_ITEMS consecutive tiles a thread there,
  // the block's prefix added coalesced
  for (int t = tid; t < n_tiles; t += ROW_THREADS) {
    s_beg[t] = tot[t];
    s_lc[t] = (unsigned)(next[t] - pre[t]);
  }
  __syncthreads();
  int carry = 0, lcarry = 0;
  for (int base = 0; base < n_tiles; base += ROW_THREADS * LOCAL_ITEMS) {
    const int t0 = base + tid * LOCAL_ITEMS;
    int v[LOCAL_ITEMS], c[LOCAL_ITEMS];
    int sum = 0, lsum = 0;
#pragma unroll
    for (int k = 0; k < LOCAL_ITEMS; ++k) {
      const bool in = t0 + k < n_tiles;
      v[k] = in ? s_beg[t0 + k] : 0;
      c[k] = in ? (int)s_lc[t0 + k] : 0;
      sum += v[k];
      lsum += c[k];
    }
    int total, ltotal;
    int s = carry + block_exclusive_scan(sum, s_warp, &total);
    int l = lcarry + block_exclusive_scan(lsum, s_warp, &ltotal);
#pragma unroll
    for (int k = 0; k < LOCAL_ITEMS; ++k) {
      if (t0 + k < n_tiles) {
        s_beg[t0 + k] = s;
        s_lc[t0 + k] = ((unsigned)c[k] << 16) | (unsigned)l;
      }
      s += v[k];
      l += c[k];
    }
    carry += total;
    lcarry += ltotal;
  }
  __syncthreads();
  for (int t = tid; t < n_tiles; t += ROW_THREADS) {
    const int s = s_beg[t];
    if (j == 0) bin_start[t] = s < P ? s : P;
    s_beg[t] = s + pre[t];
  }
  const int n_live = carry, n_run = lcarry;
  if (j == 0 && tid == 0) bin_start[n_tiles] = n_live < P ? n_live : P;
  for (int i = n_live + j * ROW_THREADS + tid; i < P; i += G * ROW_THREADS)
    sorted_tri[i] = sentinel;
  __syncthreads();

  // 2. the run's live entries, tile by tile, in an arbitrary order
  const int64_t lo = (int64_t)j * run;
  const int64_t hi = lo + run < np ? lo + run : np;
  const int tri_lo = (int)(lo / K);
  for (int64_t i0 = lo + tid; i0 < hi; i0 += UNROLL * ROW_THREADS) {
    int t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = i0 + u * ROW_THREADS;
      t[u] = i < hi ? tile_ids[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (t[u] >= 0 && t[u] < n_tiles) {
        const unsigned lp = atomicAdd(&s_lc[t[u]], 1u) & 0xffffu;
        s_stage[lp] = ((unsigned)t[u] << 16) |
                      (unsigned)((i0 + u * ROW_THREADS) / K - tri_lo);
      }
  }
  __syncthreads();

  // 3. each entry at its bin's offset + the block's prefix + its rank
  // among the block's entries of its tile (ties, a triangle that names a
  // tile twice, by staging position)
  for (int e = tid; e < n_run; e += ROW_THREADS) {
    const unsigned v = s_stage[e];
    const int t = (int)(v >> 16);
    const unsigned w = s_lc[t];
    const int end = (int)(w & 0xffffu), begin = end - (int)(w >> 16);
    int rank = 0;
#pragma unroll 4
    for (int m = begin; m < end; ++m) {
      const unsigned u = s_stage[m];
      rank += u < v || (u == v && m < e);
    }
    const int pos = s_beg[t] + rank;
    if (pos < P) sorted_tri[pos] = tri_lo + (int)(v & 0xffffu);
  }
}

// The current device's opt-in shared memory per block; the kernels that
// keep a per-tile array in shared memory opted in to all of it. Queried
// and set once per device; racing first calls set the same values.
constexpr int MAX_DEVICES = 64;
int smem_optin[MAX_DEVICES] = {};

cudaError_t smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && smem_optin[dev] > 0) {
    *limit = smem_optin[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const void* kernels[] = {(const void*)count_kernel,
                           (const void*)count_rows_kernel};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit);
    if (err != cudaSuccess) return err;
  }
  // the placements also hold their scans' warp sums statically
  const void* placements[] = {(const void*)place_rows_kernel,
                              (const void*)place_shared_kernel};
  for (const void* k : placements) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit - (int)(ROW_THREADS / 32 * sizeof(int)));
    if (err != cudaSuccess) return err;
  }
  if (dev < MAX_DEVICES) smem_optin[dev] = *limit;
  return cudaSuccess;
}

}  // namespace

// counts (n_tiles) <- live slots per tile; in_device_memory skips the
// shared-memory histogram (the path past the card's shared memory).
extern "C" int bin_count_launch(const int* tile_ids, int64_t np, int n_tiles,
                                int* counts, int in_device_memory,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)n_tiles * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (np == 0 || n_tiles == 0) return 0;
  int smem_max = 0;
  if (!in_device_memory) {
    err = smem_limit(&smem_max);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)n_tiles * sizeof(int);
  const int64_t want = (np + 8 * COUNT_THREADS - 1) / (8 * COUNT_THREADS);
  const int blocks = (int)(want < COUNT_BLOCKS ? want : COUNT_BLOCKS);
  if (smem <= (size_t)smem_max) {
    count_kernel<<<blocks, COUNT_THREADS, smem, st>>>(tile_ids, np, n_tiles,
                                                      counts);
  } else {
    count_global_kernel<<<132 * 8, GLOBAL_THREADS, 0, st>>>(tile_ids, np,
                                                           n_tiles, counts);
  }
  return (int)cudaGetLastError();
}


// K11: bin_start (n_tiles + 1) and sorted_tri (P) from the slots, in three
// launches. G blocks each take run slots (whole triangles: a multiple of
// K); rows is (G, n_tiles) scratch, tot n_tiles; stage (np) and cur_rows
// ((G, n_tiles), when in_device_memory: the histogram and cursors past the
// card's shared memory) serve place_rows_kernel only.
extern "C" int bin_place_launch(const int* tile_ids, int64_t np, int K,
                                int n_tiles, int G, int64_t run,
                                int in_device_memory, int* rows, int* tot,
                                int* cur_rows, int* stage, int P,
                                int sentinel, int* bin_start,
                                int* sorted_tri, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (G < 1 || K < 1 || run < 0 || (int64_t)G * run < np)
    return (int)cudaErrorInvalidValue;
  int smem_max = 0;
  cudaError_t err = smem_limit(&smem_max);
  if (err != cudaSuccess) return (int)err;
  const size_t warps = ROW_THREADS / 32 * sizeof(int);
  const size_t smem = in_device_memory ? 0 : (size_t)n_tiles * sizeof(int);
  if (smem + warps > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  const size_t smem_local = (2 * (size_t)n_tiles + (size_t)run) * sizeof(int);
  const bool local = n_tiles < (1 << 16) && run < (1 << 16) &&
                     smem_local + warps <= (size_t)smem_max;
  count_rows_kernel<<<G, ROW_THREADS, smem, st>>>(
      tile_ids, np, run, n_tiles, in_device_memory, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    scan_rows_kernel<<<(n_tiles + SCAN_THREADS - 1) / SCAN_THREADS,
                       SCAN_THREADS, 0, st>>>(rows, G, n_tiles, tot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (local)
    place_shared_kernel<<<G, ROW_THREADS, smem_local, st>>>(
        tile_ids, np, run, K, n_tiles, G, rows, tot, P, sentinel, bin_start,
        sorted_tri);
  else
    place_rows_kernel<<<G, ROW_THREADS, smem, st>>>(
        tile_ids, np, run, K, n_tiles, G, rows, tot,
        in_device_memory ? cur_rows : nullptr, stage, P, sentinel, bin_start,
        sorted_tri);
  return (int)cudaGetLastError();
}
