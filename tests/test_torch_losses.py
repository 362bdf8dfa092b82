"""The port's mesh regularizers and loss terms against the JAX package.

Tolerance: atol 1e-5. The losses are means of float32 gathers and sums;
PyTorch and XLA reduce in different orders, a few ulp at unit scale.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.data.obj import build_topology as jtopology
from fpc_diffrend_tpu.fit import losses as jlosses
from fpc_diffrend_tpu.fit.config import FitConfig as JConfig
from fpc_diffrend_tpu.ops import mesh_ops as jmesh
from fpc_diffrend_tpu_torch.data.obj import build_topology as ttopology
from fpc_diffrend_tpu_torch.fit import losses as tlosses
from fpc_diffrend_tpu_torch.fit.config import FitConfig as TConfig
from fpc_diffrend_tpu_torch.ops import mesh_ops as tmesh

ATOL = 1e-5


def _grid_mesh(rng, n=6):
    ys, xs = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n),
                         indexing="ij")
    z = 0.3 * np.exp(-(xs ** 2 + ys ** 2)) + 0.05 * rng.normal(size=xs.shape)
    verts = np.stack([xs, ys, z], -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return verts, np.asarray(faces, np.int32)


def test_topology_matches(rng):
    _, faces = _grid_mesh(rng)
    a, b = ttopology(faces, 36), jtopology(faces, 36)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))


def test_mesh_regularizers_match(rng):
    verts, faces = _grid_mesh(rng)
    topo = jtopology(faces, verts.shape[0])
    batch = np.stack([verts, verts + 0.02 * rng.normal(size=verts.shape)]
                     ).astype(np.float32)
    tv = torch.as_tensor(batch)
    t = {k: torch.as_tensor(getattr(topo, k)) for k in
         ("edges", "nbr_idx", "nbr_mask", "degree", "edge_face_pairs")}
    got_e = tmesh.mesh_edge_loss(tv, t["edges"], 0.1).numpy()
    got_l = tmesh.mesh_laplacian_smoothing_padded(
        tv, t["nbr_idx"], t["nbr_mask"], t["degree"]).numpy()
    got_n = tmesh.mesh_normal_consistency(tv, torch.as_tensor(faces),
                                          t["edge_face_pairs"]).numpy()
    for b in range(2):
        v = jnp.asarray(batch[b])
        np.testing.assert_allclose(
            got_e[b], float(jmesh.mesh_edge_loss(v, topo.edges, 0.1)),
            atol=ATOL)
        np.testing.assert_allclose(
            got_l[b], float(jmesh.mesh_laplacian_smoothing_padded(
                v, topo.nbr_idx, topo.nbr_mask, topo.degree)), atol=ATOL)
        np.testing.assert_allclose(
            got_n[b], float(jmesh.mesh_normal_consistency(
                v, faces, topo.edge_face_pairs)), atol=ATOL)


def test_photometric_loss_matches(rng):
    ref = rng.integers(0, 140, size=(3, 6, 5, 1)).astype(np.float32)
    col = rng.uniform(size=(3, 6, 5, 1)).astype(np.float32)
    got = tlosses.photometric_loss(torch.as_tensor(ref),
                                   torch.as_tensor(col)).numpy()
    for b in range(3):
        want = float(jlosses.photometric_loss(ref[b], col[b]))
        # 8-bit-scale squares (~1e4): a few ulp relative, not absolute
        np.testing.assert_allclose(got[b], want, rtol=1e-6)


def _params(rng, F=5, V=8, Bs=3):
    p = {"m1": rng.normal(size=(F, F)), "m2": rng.normal(size=(F, F)),
         "m3": rng.normal(size=(3 * V, F)), "maps": rng.normal(size=(F, F)),
         "maps_intermediate": rng.normal(size=(Bs, F)),
         "per_frame_t": rng.normal(size=(F, 3)),
         "per_frame_q": rng.normal(size=(F, 4))}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("mode,step", [("combined", 900), ("combined", 10),
                                       ("prior", 0), ("free", 0)])
def test_staging_and_temporal_match(rng, mode, step):
    p = _params(rng)
    frames = np.array([0, 3, 4, 1], np.int32)
    kw = dict(mode=mode, max_iter=1000, regularize_correctives=True,
              regularize_prior=True, weight_temporal=0.3)
    jc, tc = JConfig(**kw), TConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tf = torch.as_tensor(frames.astype(np.int64))
    np.testing.assert_allclose(
        float(tlosses.staging_regularizers(tc, tp, tf, step)),
        float(jlosses.staging_regularizers(jc, jp, jnp.asarray(frames),
                                           jnp.int32(step))), atol=ATOL)
    np.testing.assert_allclose(
        float(tlosses.temporal_smoothness(tc, tp, tf)),
        float(jlosses.temporal_smoothness(jc, jp, jnp.asarray(frames))),
        atol=ATOL)
