// K11: counting-rank bin placement of the stacked binning.
//
// Replaces the TPU kernels _count_kernel and _place_kernel of
// fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py (:350, :385, launched by
// _place_pallas :414). Input: the (tile, triangle) pair slots of the
// stacked batch, tile_ids (B, T, K) int32 with the sentinel n_tiles for a
// dead slot; slot i belongs to the stacked triangle i / K = b * T + t.
// Output: bin_start (n_tiles + 1) (the scan between the two launches runs
// in torch, as the JAX package runs it in XLA) and sorted_tri (P): the
// stacked triangle id of each entry, grouped by tile, ascending inside each
// bin, cut at P (the entry cap), and the sentinel B * T past the live
// prefix. That is exactly the kept prefix of a sort of the keys
// tile * B * T + b * T + t.
//
// Bound: bytes. The function reads the slots once and writes sorted_tri
// and bin_start once: ~10.6 MB, ~0.0032 ms at the bench (1.9 M slots,
// P = 0.72 M at the autotuned cap) against HBM's 3.35 TB/s. This design
// moves ~2.2x that: the slots are read twice (count, place), the live
// entries go through the scratch and back, the counts are read thrice.
//
// Design (simple and right; no TMA or wgmma):
// 1. count_kernel: each block takes a contiguous run of slots, counts them
//    into a shared-memory histogram of n_tiles int32 (64 KB at the bench,
//    opted in once per device), skips dead slots, and flushes its non-zero
//    bins with one atomicAdd each: ~3x faster at the bench than one
//    device-memory atomicAdd per live slot (chip_smoke.py times both).
//    Where the histogram exceeds the card's shared memory,
//    count_global_kernel adds straight into device memory.
// 2. place_kernel: each live slot claims a position in its bin with an
//    atomicAdd on a cursor that starts at the bin's offset, and writes its
//    triangle id into an NP-sized scratch. The claim order is arbitrary.
// 3. sort_kernel: one warp per bin ranks each entry by the entries below it
//    (ties, which the binning never makes, by scratch position) and writes
//    it to bin_start + rank when that is below P. The rank loop runs over
//    the whole bin, held in shared memory up to SORT_CACHE entries and read
//    from device memory beyond, so a bin of any size is sorted; the cut at
//    P comes after the in-bin order, so a bin that straddles P keeps its
//    lowest triangle ids.
// 4. fill_kernel: slots from the live total to P get the sentinel B * T.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int COUNT_THREADS = 1024;
constexpr int COUNT_BLOCKS = 264;          // 2 per SM of the H100's 132
constexpr int PLACE_THREADS = 256;
constexpr int SORT_WARPS = 8;              // bins per block
constexpr int SORT_CACHE = 256;            // entries a warp keeps in smem

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

__global__ void place_kernel(const int* __restrict__ tile_ids, int64_t np,
                             int K, int n_tiles, int* __restrict__ cursor,
                             int* __restrict__ scratch) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += stride) {
    const int t = tile_ids[i];
    if (t >= 0 && t < n_tiles) scratch[atomicAdd(&cursor[t], 1)] =
        (int)(i / K);
  }
}

__global__ void sort_kernel(const int* __restrict__ bin_start_full,
                            const int* __restrict__ scratch, int n_tiles,
                            int P, int* __restrict__ sorted_tri) {
  __shared__ int cache[SORT_WARPS][SORT_CACHE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * SORT_WARPS + warp;
  if (tile >= n_tiles) return;           // the whole warp leaves together
  const int s = bin_start_full[tile];
  const int n = bin_start_full[tile + 1] - s;
  if (n == 0 || s >= P) return;
  const int* src = scratch + s;
  if (n <= SORT_CACHE) {
    for (int j = lane; j < n; j += 32) cache[warp][j] = src[j];
    __syncwarp();
    src = cache[warp];
  }
  for (int j = lane; j < n; j += 32) {
    const int v = src[j];
    int rank = 0;
    for (int m = 0; m < n; ++m) {
      const int w = src[m];
      rank += (w < v) | ((w == v) & (m < j));
    }
    if (s + rank < P) sorted_tri[s + rank] = v;
  }
}

__global__ void fill_kernel(const int* __restrict__ total_ptr, int P,
                            int sentinel, int* __restrict__ sorted_tri) {
  const int total = *total_ptr;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < P; i += stride)
    if (i >= total) sorted_tri[i] = sentinel;
}

// The current device's opt-in shared memory per block, count_kernel opted
// in to all of it. Queried and set once per device; racing first calls
// set the same values.
constexpr int MAX_DEVICES = 64;
int smem_optin[MAX_DEVICES] = {};

cudaError_t count_smem_limit(int* limit) {
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
  err = cudaFuncSetAttribute(
      count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *limit);
  if (err != cudaSuccess) return err;
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
    err = count_smem_limit(&smem_max);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)n_tiles * sizeof(int);
  const int64_t want = (np + 8 * COUNT_THREADS - 1) / (8 * COUNT_THREADS);
  const int blocks = (int)(want < COUNT_BLOCKS ? want : COUNT_BLOCKS);
  if (smem <= (size_t)smem_max) {
    count_kernel<<<blocks, COUNT_THREADS, smem, st>>>(tile_ids, np, n_tiles,
                                                      counts);
  } else {
    count_global_kernel<<<132 * 8, PLACE_THREADS, 0, st>>>(tile_ids, np,
                                                           n_tiles, counts);
  }
  return (int)cudaGetLastError();
}

// sorted_tri (P) from the slots and bin_start_full (n_tiles + 1, the
// unclamped exclusive scan of the counts). cursor (n_tiles) and scratch
// (np) are the wrapper's scratch buffers.
extern "C" int bin_place_launch(const int* tile_ids, int64_t np, int K,
                                int n_tiles, const int* bin_start_full,
                                int* cursor, int* scratch, int P,
                                int sentinel, int* sorted_tri, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (P == 0) return 0;
  if (np > 0 && n_tiles > 0) {
    cudaError_t err = cudaMemcpyAsync(cursor, bin_start_full,
                                      (size_t)n_tiles * sizeof(int),
                                      cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    const int64_t want = (np + PLACE_THREADS - 1) / PLACE_THREADS;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    place_kernel<<<blocks, PLACE_THREADS, 0, st>>>(tile_ids, np, K, n_tiles,
                                                   cursor, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sort_kernel<<<(n_tiles + SORT_WARPS - 1) / SORT_WARPS, SORT_WARPS * 32,
                  0, st>>>(bin_start_full, scratch, n_tiles, P, sorted_tri);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int fill_blocks = (P + PLACE_THREADS - 1) / PLACE_THREADS;
  fill_kernel<<<fill_blocks < 132 * 16 ? fill_blocks : 132 * 16,
                PLACE_THREADS, 0, st>>>(bin_start_full + n_tiles, P,
                                        sentinel, sorted_tri);
  return (int)cudaGetLastError();
}
