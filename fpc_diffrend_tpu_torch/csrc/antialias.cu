// K2: silhouette antialias over the stacked batch image (forward).
//
// Replaces fpc_diffrend_tpu/ops/pallas/antialias_tpu.py _fwd_kernel
// (launched by _aa_fwd_from_packed): nvdiffrast's pair blend, whose math is
// _pair_delta there and pair_delta in ops/antialias.py, kept operand for
// operand (built with -fmad=false, so every product rounds as there). The
// pair blend and the per-pixel sum live in antialias_pair.cuh, which K10's
// antialias tail shares.
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

#include "antialias_pair.cuh"

namespace {

constexpr int THREADS = 128;

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
  const aa::GlobalPlanes planes{idbuf, payload, colour, plane};
  float acc[aa::MAX_C];
  aa::blend_pixel(planes, p, (int64_t)pw, r, x, nchan, height, width,
                  sample_ph, acc);
#pragma unroll
  for (int c = 0; c < aa::MAX_C; ++c)
    if (c < nchan) out[c * plane + p] = acc[c];
}

}  // namespace

extern "C" int antialias_launch(const int* idbuf, const float* payload,
                                const float* colour, int rows, int pw,
                                int nchan, int height, int width,
                                int sample_ph, float* out, void* stream) {
  if (nchan < 1 || nchan > aa::MAX_C) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)rows * pw;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  antialias_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      idbuf, payload, colour, rows, pw, nchan, height, width, sample_ph, out);
  return (int)cudaGetLastError();
}
