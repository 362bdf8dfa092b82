"""The work a fit step or a view needs, and the least time the card could
take for it: max(FLOPs / peak FLOP/s, bytes / peak bytes/s), against the
published peaks of one NVIDIA H100 SXM (float32 outside the tensor cores,
HBM3), which assume its full 700 W power limit.

The counts depend only on the shapes and on what the reference's own pass
over the data found (covered pixels, pixel pairs whose triangles
differ), never on the program's buffers, planes or caps, so a
share of the least time reads the same work whatever implements it.

Bytes: the step's own inputs read once and its outputs written once. A fit
step reads the batch's uint8 reference pixels, the mesh, the rig's deltas
and the calibration, and reads and writes every parameter that the fit's
mode moves, with Adam's two moments; the parameters are counted from the
configuration's shapes and mode (:func:`param_elements`), so a leaf the
program keeps but the mode never moves costs nothing here. A view reads the mesh, the deltas, the calibration and the
parameters it uses, and writes its image.

FLOPs: the algorithm's own arithmetic, counted per sample, per triangle
of a sample, per pixel, per covered pixel and per pixel pair on a
silhouette, forward and (for a step) backward at twice the forward; each
constant is the operations of the formula named beside it, with no
recomputation and no test of a pixel against a triangle that does not
cover it.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12           # float32, H100 SXM, dense, no tensor cores
PEAK_BYTES = 3.35e12         # HBM3, H100 SXM

F32 = 4
BACKWARD = 2.0               # a backward costs twice its forward

VERTEX_FWD = 7 + 32          # screen mapping (divide, scale, offset) + mvp
TRIANGLE_FWD = 12 + 18 + 15  # area, three edge planes, depth plane
COVERED_FWD = 16 + 8 + 8 + 12  # edge and depth planes at the pixel,
#                                perspective-correct u v, uv interpolation,
#                                bilinear four-tap sample
MIP_COVERED_FWD = 12 + 3 + 11  # the second level's sample, the blend
#                                between levels, the LOD's differences
PIXEL_FWD = 1 + 4            # background composite; squared 8-bit error
EDGE_PAIR_FWD = 3 * 13 + 4   # three edge crossings, the colour blend
LAPLACIAN_PER_VERTEX = 6 * 3 + 12  # neighbour sum, mean, norm
ADAM_PER_ELEMENT = 13        # two moments, bias corrections, update


def least_time(flops: float, nbytes: float) -> dict:
    """{"s": the least time, "by": "flops" or "bytes"}."""
    tf, tb = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"s": max(tf, tb), "by": "flops" if tf >= tb else "bytes",
            "flops": flops, "bytes": nbytes}


def geometry_bytes(shape: dict) -> int:
    """Mesh (vertices, uv, faces, uv faces), deltas and calibration."""
    v, t, u = shape["vertices"], shape["triangles"], shape["uv"]
    return F32 * (3 * v + 2 * u + 6 * t + 3 * v * shape["blendshapes"]
                  + 32 * shape["cameras"])


def param_elements(shape: dict) -> int:
    """Elements of the parameters that the fit's mode moves: in every mode
    the blendshape maps (frames x frames) and maps_intermediate
    (blendshapes x frames), each camera's and each frame's pose (a
    translation and a quaternion, 3 + 4) and the texture; in "free" and
    "combined" mode also the correctives m1, m2 (frames x frames) and m3
    (3 x vertices x frames), which "prior" mode never uses."""
    nf, nc = shape["frames"], shape["cameras"]
    n = (nf * nf + shape["blendshapes"] * nf + 7 * nc + 7 * nf
         + shape["texels"] * shape["channels"])
    if shape["mode"] != "prior":
        n += 2 * nf * nf + 3 * shape["vertices"] * nf
    return n


def sample_flops(shape: dict) -> float:
    """One sample's prologue and triangle setup, forward: the prior blend
    (activations, deltas @ activations), the pose and camera matrices,
    every vertex to the screen, every triangle's planes."""
    v, t, nb, nf = (shape["vertices"], shape["triangles"],
                    shape["blendshapes"], shape["frames"])
    return (2 * nb * nf + 2 * 3 * v * nb + 3 * 128 + VERTEX_FWD * v
            + TRIANGLE_FWD * t)


def view_work(shape: dict, seen: dict) -> dict:
    """One view, forward only.

    :param shape: vertices, triangles, uv, blendshapes, frames, cameras,
        height, width, channels, texels (of the texture), mip (bool).
    :param seen: the reference's counts per view: covered, edge_pairs.
    """
    px = shape["height"] * shape["width"]
    covered_fwd = COVERED_FWD + (MIP_COVERED_FWD if shape["mip"] else 0)
    flops = (sample_flops(shape) + covered_fwd * seen["covered"]
             + PIXEL_FWD * px + EDGE_PAIR_FWD * seen["edge_pairs"])
    # the frame's column of maps, maps_intermediate, two poses
    params = shape["frames"] * (1 + shape["blendshapes"]) + 14
    nbytes = (geometry_bytes(shape)
              + F32 * (params + shape["texels"] * shape["channels"])
              + F32 * px * shape["channels"])
    return least_time(flops, nbytes)


def step_work(shape: dict, seen: dict, batch: int) -> dict:
    """One fit step of ``batch`` samples, forward and backward, and Adam.

    :param shape: as :func:`view_work`, with mode (the fit's: "prior",
        "free" or "combined").
    :param seen: the reference's counts per view: covered, edge_pairs.
    """
    px = shape["height"] * shape["width"]
    covered_fwd = COVERED_FWD + (MIP_COVERED_FWD if shape["mip"] else 0)
    per_sample = (sample_flops(shape) + covered_fwd * seen["covered"]
                  + PIXEL_FWD * px + EDGE_PAIR_FWD * seen["edge_pairs"]
                  + LAPLACIAN_PER_VERTEX * shape["vertices"])
    pyramid = (shape["texels"] * shape["channels"] / 3.0
               if shape["mip"] else 0.0)
    n_params = param_elements(shape)
    flops = ((batch * per_sample + pyramid) * (1.0 + BACKWARD)
             + ADAM_PER_ELEMENT * n_params)
    nbytes = (batch * px + geometry_bytes(shape)
              + 2 * 3 * F32 * n_params)
    return least_time(flops, nbytes)
