"""Result saving (port of ``fpc_diffrend_tpu.fit.results``): per-frame OBJs,
the texture, pose.json and the config record.

The reference-format ``result/`` directory (reference fit.py:235-286):
``{i}.obj`` (vertices, uv, and faces from ``faces.txt`` if it is there),
``texture.png`` (flipped vertically, 8-bit), ``pose.json`` with per-frame
translations (F, 3) and rotation quaternions (F, 4); beside it
``config.txt``. The meshes are recomputed for every frame from the final
parameters. ``load_pose`` and ``load_result_mesh`` read a result back for
the result renderers (``tools/render_result.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import Scene
from fpc_diffrend_tpu_torch.models import blendshape
from fpc_diffrend_tpu_torch.utils.image import save_image


def final_meshes(config: FitConfig, scene: Scene, params: dict,
                 n_frames: int) -> np.ndarray:
    """(F, 3V) blended vertex positions of every frame."""
    frames = torch.arange(n_frames, device=scene.device)
    with torch.no_grad():
        out = blendshape.blend(config.mode,
                               {**params, "deltas": scene.deltas},
                               scene.v_base, frames,
                               config.combined_corrective_coefficient)
    return out.cpu().numpy()


def save_results(config: FitConfig, scene: Scene, params: dict,
                 n_frames: int, out_dir: str | None = None) -> str:
    """Write the reference-format result directory; :return: its path."""
    out_dir = out_dir or config.out_dir
    directory = os.path.join(out_dir, "result")
    os.makedirs(directory, exist_ok=True)

    meshes = final_meshes(config, scene, params, n_frames)
    uv = scene.uv.cpu().numpy()
    faces = scene.faces.cpu().numpy()
    fuv = scene.uv_idx.cpu().numpy()
    faces_txt = os.path.join(directory, "faces.txt")
    if os.path.exists(faces_txt):
        with open(faces_txt) as f:
            face_lines = f.readlines()
    else:
        face_lines = [f"f {a+1}/{au+1} {b+1}/{bu+1} {c+1}/{cu+1}\n"
                      for (a, b, c), (au, bu, cu) in zip(faces, fuv)]
    uv_lines = [f"vt {u[0]} {u[1]}\n" for u in uv]

    print(f"Saving {meshes.shape[0]} meshes...")
    for i, mesh in enumerate(meshes):
        with open(os.path.join(directory, f"{i}.obj"), "w") as f:
            f.writelines(f"v {p[0]} {p[1]} {p[2]}\n"
                         for p in mesh.reshape(-1, 3))
            f.writelines(uv_lines)
            f.writelines(face_lines)

    tex = params["tex"].detach().cpu().numpy()
    save_image(os.path.join(directory, "texture.png"), np.flip(tex, 0))
    pose = {"translation": params["per_frame_t"].detach().cpu().tolist(),
            "rotation": params["per_frame_q"].detach().cpu().tolist()}
    with open(os.path.join(directory, "pose.json"), "w") as f:
        json.dump(pose, f, separators=(",", ":"), sort_keys=True, indent=4)
    config.save(os.path.join(out_dir, "config.txt"))
    print("Everything saved successfully.")
    return directory


def load_pose(result_dir: str):
    """pose.json back: (translation (F, 3), rotation (F, 4)) float32."""
    with open(os.path.join(result_dir, "pose.json")) as f:
        d = json.load(f)
    return (np.asarray(d["translation"], np.float32),
            np.asarray(d["rotation"], np.float32))


def load_result_mesh(result_dir: str, i: int) -> np.ndarray:
    """(3V,) float32 vertices of a saved ``{i}.obj``: its ``v`` lines up to
    the first ``vt`` line (``fpc_diffrend_tpu.tools.render_result``'s
    reader, reference render_result.py:117-122)."""
    verts = []
    with open(os.path.join(result_dir, f"{i}.obj")) as f:
        for line in f:
            if line.startswith("v "):
                verts.append(line[2:])
            elif line.startswith("vt "):
                break
    return np.array(" ".join(verts).split(), dtype=np.float32)
