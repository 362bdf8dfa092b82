"""Plain PyTorch reference of the fit step: prior-mode blend, pose and
camera correction, the render of ``render.py`` one sample at a time, the
photometric and Laplacian losses, autograd's backward, and Adam with its
learning-rate ramp, the corrective gate and the quaternion renorm.

It imports nothing of the program and takes nothing the program made: the
topology, the face order and the batches are worked out here again from
the inputs the benchmark hands to both sides.

``Precision.matmul`` is where the reference's matrix products go; the
control (``tf32=True``) rounds their operands to TF32's 10-bit mantissa,
forward and backward, as the tensor cores do when TF32 is allowed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import render

PARAMS = ("m1", "m2", "m3", "maps", "maps_intermediate", "t_opt", "q_opt",
          "per_frame_t", "per_frame_q", "tex")
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class TF32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, as the tensor cores
    multiply when TF32 is allowed; the backward's products round theirs
    too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return (g @ tf32_round(b).transpose(-1, -2),
                tf32_round(a).transpose(-1, -2) @ g)


@dataclasses.dataclass
class Precision:
    """How the reference multiplies matrices: float32, or TF32 (the
    control)."""

    tf32: bool = False

    def matmul(self, a, b):
        return TF32Matmul.apply(a, b) if self.tf32 else a @ b


def band_order(faces: np.ndarray) -> np.ndarray:
    """Faces stably sorted by their smallest vertex index."""
    return np.argsort(np.asarray(faces).min(axis=1), kind="stable")


def topology(faces: np.ndarray, n_vertices: int):
    """(face_neighbors (T, 3): the face across edge (v_j, v_j+1), -1 where
    no single other face shares it; neighbours: list of each vertex's
    adjacent vertices)."""
    faces = np.asarray(faces, np.int64)
    edge_faces: dict = {}
    for f, tri in enumerate(faces):
        for j in range(3):
            a, b = int(tri[j]), int(tri[(j + 1) % 3])
            edge_faces.setdefault((min(a, b), max(a, b)), []).append((f, j))
    face_neighbors = np.full(faces.shape, -1, np.int64)
    neighbours = [set() for _ in range(n_vertices)]
    for (a, b), users in edge_faces.items():
        neighbours[a].add(b)
        neighbours[b].add(a)
        if len(users) == 2:
            (fa, ja), (fb, jb) = users
            face_neighbors[fa, ja] = fb
            face_neighbors[fb, jb] = fa
    return face_neighbors, [sorted(n) for n in neighbours]


@dataclasses.dataclass
class Rig:
    """The reference's own copy of the scene, on one device."""

    v_base: torch.Tensor        # (3V,)
    faces: torch.Tensor         # (T, 3), band order
    uv: torch.Tensor
    uv_idx: torch.Tensor
    face_neighbors: torch.Tensor
    nbr_src: torch.Tensor       # directed edges, both ways
    nbr_dst: torch.Tensor
    degree: torch.Tensor
    deltas: torch.Tensor        # (3V, nB)
    proj: torch.Tensor          # (C, 4, 4)
    mv: torch.Tensor


def make_rig(inputs, device) -> Rig:
    """The reference's scene from the benchmark's inputs (numpy arrays)."""
    order = band_order(inputs.faces)
    faces = inputs.faces[order]
    uv_idx = inputs.uv_idx[order]
    n_v = inputs.vertices.shape[0] // 3
    face_neighbors, neighbours = topology(faces, n_v)
    src = np.concatenate([np.full(len(n), v)
                          for v, n in enumerate(neighbours)])
    dst = np.concatenate([np.asarray(n, np.int64) for n in neighbours])

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    return Rig(v_base=t(inputs.vertices), faces=t(faces, torch.int64),
               uv=t(inputs.uv), uv_idx=t(uv_idx, torch.int64),
               face_neighbors=t(face_neighbors, torch.int64),
               nbr_src=t(src, torch.int64), nbr_dst=t(dst, torch.int64),
               degree=t([len(n) for n in neighbours]),
               deltas=t(inputs.deltas), proj=t(inputs.proj), mv=t(inputs.mv))


def quat_rotmat(q):
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def rigid(t, q):
    """[R(q) | t; 0 0 0 1]."""
    top = torch.cat([quat_rotmat(q), t[:, None]], -1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=t.device)
    return torch.cat([top, bottom], 0)


def clip_positions(rig: Rig, params: dict, cam: int, frame: int,
                   prec: Precision):
    """Blend (prior mode) and pose one sample.

    :return: (clip (V, 4), verts (V, 3)).
    """
    act = prec.matmul(params["maps_intermediate"],
                      params["maps"][:, frame:frame + 1])
    verts = (rig.v_base + prec.matmul(rig.deltas, act)[:, 0]).reshape(-1, 3)
    mvp = prec.matmul(rig.proj[cam], prec.matmul(
        rigid(params["per_frame_t"][frame], params["per_frame_q"][frame]),
        prec.matmul(rigid(params["t_opt"][cam], params["q_opt"][cam]),
                    rig.mv[cam])))
    homo = torch.cat([verts, torch.ones_like(verts[:, :1])], -1)
    return prec.matmul(homo, mvp.T), verts


def laplacian_norm(rig: Rig, verts):
    """Mean over vertices of |mean of neighbours - vertex| (epsilon 1e-12
    inside the root)."""
    sums = torch.zeros_like(verts).index_add_(
        0, rig.nbr_src, torch.index_select(verts, 0, rig.nbr_dst))
    lap = sums / torch.clamp(rig.degree, min=1.0)[:, None] - verts
    return torch.mean(torch.sqrt(torch.sum(lap * lap, -1) + 1e-12))


def sample_loss(rig: Rig, params: dict, ref: torch.Tensor, cam: int,
                frame: int, settings: dict, prec: Precision, stats=None):
    """One sample's photometric and Laplacian terms, each not yet divided
    by the batch size: (sum of squared 8-bit errors / pixels,
    weight_laplacian * laplacian_norm ** 2)."""
    clip, verts = clip_positions(rig, params, cam, frame, prec)
    height, width = ref.shape
    img = render.render_view(clip, rig.faces, rig.uv, rig.uv_idx,
                             rig.face_neighbors, params["tex"], height,
                             width, settings.get("mip_level"), stats)
    pix = torch.mean((ref.to(torch.float32)[..., None] - img * 255.0) ** 2)
    lap = settings["weight_laplacian"] * laplacian_norm(rig, verts) ** 2
    return pix, lap


def loss_and_grads(rig: Rig, params: dict, frames_u8, cams, frames,
                   settings: dict, prec: Precision, stats=None):
    """The batch loss (mean over samples) and its gradients, one sample's
    graph at a time.

    :return: (loss float, name -> gradient tensor).
    """
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    n = len(cams)
    total = 0.0
    for cam, frame in zip(cams, frames):
        pix, lap = sample_loss(rig, leaves, frames_u8[cam, frame], cam,
                               frame, settings, prec, stats)
        part = (pix + lap) / n
        part.backward()
        total += float(part.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaves.items()}


def learning_rates(settings: dict) -> dict:
    """Each parameter's base learning rate (the five groups)."""
    base = settings["lr_base"]
    rates = {"m1": base, "m2": base, "m3": base, "maps": base,
             "maps_intermediate": base, "t_opt": settings["lr_t"],
             "per_frame_t": settings["lr_t"], "q_opt": settings["lr_q"],
             "per_frame_q": settings["lr_q"],
             "tex": base * settings["lr_tex_coef"]}
    return rates


def adam_update(params: dict, grads: dict, m: dict, v: dict, count: int,
                settings: dict) -> None:
    """One Adam update in place; ``count`` updates came before it. The
    correctives' gradients are gated to 0 in prior mode; the rates are
    ramped by lr_ramp ** (count / max_iter); the quaternions are
    renormalised after."""
    ramp = settings["lr_ramp"] ** (count / settings["max_iter"])
    rates = learning_rates(settings)
    t = count + 1
    for k in PARAMS:
        g = grads[k] * (0.0 if k in ("m1", "m2", "m3") else 1.0)
        m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g
        v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g * g
        m_hat = m[k] / (1 - BETAS[0] ** t)
        v_hat = v[k] / (1 - BETAS[1] ** t)
        params[k] = params[k] - rates[k] * ramp * m_hat / (
            torch.sqrt(v_hat) + ADAM_EPS)
    for k in ("q_opt", "per_frame_q"):
        q = params[k]
        params[k] = q / torch.clamp(
            torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)


def batches(seed: int, step: int, batch: int, n_cams: int, n_frames: int,
            device):
    """The (cams, frames) the fit loop samples for ``step`` (0-based): a
    generator of ``device`` seeded with seed + step, B camera picks then B
    frames."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + step)
    cams = torch.randint(0, n_cams, (batch,), generator=g, device=device)
    frames = torch.randint(0, n_frames, (batch,), generator=g,
                           device=device)
    return cams.tolist(), frames.tolist()


def fit_steps(rig: Rig, params0: dict, frames_u8, settings: dict,
              seed: int, batch: int, n_steps: int, prec: Precision,
              stats=None, batch_filter=None):
    """``n_steps`` reference steps from ``params0``.

    :param batch_filter: fn(cams, frames) -> (cams, frames), to plant a
        fault in the reference (the tests and the fault readings).
    :return: dict: losses [n_steps], grad1 (name -> the first step's
        gradient), params (name -> after the last step).
    """
    params = {k: v.detach().clone() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(x) for k, x in params.items()}
    n_cams, n_frames = frames_u8.shape[:2]
    losses, grad1 = [], None
    for step in range(n_steps):
        cams, frames = batches(seed, step, batch, n_cams, n_frames,
                               frames_u8.device)
        if batch_filter is not None:
            cams, frames = batch_filter(cams, frames)
        loss, grads = loss_and_grads(rig, params, frames_u8, cams, frames,
                                     settings, prec, stats)
        losses.append(loss)
        if grad1 is None:
            grad1 = grads
        adam_update(params, grads, m, v, step, settings)
    return {"losses": losses, "grad1": grad1, "params": params}
