// K2: silhouette antialias over the stacked batch image (forward).
//
// Replaces fpc_diffrend_tpu/ops/pallas/antialias_tpu.py _fwd_kernel
// (launched by _aa_fwd_from_packed): nvdiffrast's pair blend, whose math is
// _pair_delta there and pair_delta in ops/antialias.py, kept operand for
// operand (built with -fmad=false, so every product rounds as there). The
// pair blend lives in antialias_pair.cuh; the kernel lives in
// antialias_fwd.cuh, which K10 (csrc/fused_raster.cu) runs too.
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
//    the order above and stores; a warp stores 128 contiguous bytes a
//    plane.
// Every value is the same float, summed in the same order, as in the
// plain version.
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

#include "antialias_fwd.cuh"

extern "C" int antialias_launch(const int* idbuf, const float* payload,
                                const float* colour, int rows, int pw,
                                int nchan, int height, int width,
                                int sample_ph, float* out, void* stream) {
  if (!aa_fwd::valid(rows, pw, nchan, sample_ph))
    return (int)cudaErrorInvalidValue;
  aa_fwd::launch((cudaStream_t)stream, idbuf, payload, colour, rows, pw, nchan,
                 height, width, sample_ph, out);
  return (int)cudaGetLastError();
}
