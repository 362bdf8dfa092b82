"""Small stacked scenes shared by the tests of the PyTorch port.

Every input is made with numpy from a seed, so the JAX package and the
port see identical arrays.
"""

import numpy as np

from fpc_diffrend_tpu.data.obj import build_topology


def quads_scene(rng, n_quads=8):
    """Overlapping quads at distinct depths with their own uv patches.

    :return: (verts (V, 3), faces (T, 3) int32, uv (V, 2), face_neighbors
        (T, 3) int32), all numpy.
    """
    verts, faces, uvs = [], [], []
    for q in range(n_quads):
        cx, cy = rng.uniform(-0.6, 0.6, 2)
        z = -0.8 + 0.2 * q
        s = rng.uniform(0.25, 0.55)
        base = len(verts)
        verts += [[cx - s, cy - s, z], [cx + s, cy - s, z + 0.05],
                  [cx + s, cy + s, z], [cx - s, cy + s, z - 0.05]]
        u0, v0 = rng.uniform(0.05, 0.6, 2)
        uvs += [[u0, v0], [u0 + 0.3, v0], [u0 + 0.3, v0 + 0.3],
                [u0, v0 + 0.3]]
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    fn = build_topology(faces, verts.shape[0]).face_neighbors
    return verts, faces, np.asarray(uvs, np.float32), fn


def clip_batch(verts, rng, B):
    """(B, V, 4) clip positions: a small offset per sample and w = 1 plus
    per-vertex noise, so perspective weights differ."""
    out = []
    for _ in range(B):
        off = rng.normal(scale=0.08, size=(1, 3)).astype(np.float32)
        w = 1.0 + 0.1 * rng.uniform(size=(verts.shape[0], 1)).astype(
            np.float32)
        out.append(np.concatenate([(verts + off) * w, w], axis=1))
    return np.stack(out).astype(np.float32)


def close_to_max(got, want, rtol):
    """got == want within ``rtol`` of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def reference_forward(data_b, aux_b, bins, k1, H, W, ph, sample):
    """The stacked forward in plain, differentiable torch ops: each
    pixel's winner record gathered from the records by K1's entry,
    resolved at the pixel's row within its sample (the records are in
    each sample's own frame), sampled and antialiased (bins and winners
    held fixed).

    :param sample: fn(tu, tv) -> (C, rows, pw) colour of the resolved uv.
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as tac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr

    B, T = data_b.shape[:2]
    _, entry, payload, _, _ = k1
    rows, pw = entry.shape
    rec = torch.cat([data_b, aux_b], -1).reshape(B * T, tr.REC)
    n_raw = bins.sorted_tri.shape[0]
    tri = torch.cat([bins.sorted_tri.long(),
                     torch.zeros(bins.gbase - n_raw, dtype=torch.long),
                     bins.global_idx.long()]).clamp(max=B * T - 1)
    hit = entry >= 0
    F = torch.where(hit[..., None], rec[tri[entry.long().clamp(min=0)]],
                    0.0)
    x = torch.arange(pw, dtype=torch.float32) + 0.5
    y = (torch.remainder(torch.arange(rows), ph).to(torch.float32)
         + 0.5)[:, None]
    pay, _ = tr.resolve_payload(F, x, y, hit, payload[2])
    colour = sample(pay[3], pay[4])
    idbuf = torch.where(hit, F[..., 12].detach().to(torch.int32), -1)
    return tac.antialias_planes_plain(idbuf, torch.stack(pay), colour, H, W,
                                      ph)
