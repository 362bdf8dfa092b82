"""End-to-end rig demo: a 9-camera multi-view fit through the file API.

Exercises the production path as a user would: builds a synthetic head
mesh and blendshapes ON DISK, renders a ground-truth take through a
9-camera calibration (OpenCV convention, f ~ 7,000 px; the synthetic rig of
``examples.rig`` unless ``--calib`` names one), writes the frames as
uncompressed TIFFs in the reference directory layout, then runs
``fit.api.fit_take`` from those files and reports pose and loss recovery.
Runs on the CUDA device, or with ``--cpu`` on the plain PyTorch versions
of the kernels.

Usage: python -m fpc_diffrend_tpu_torch.examples.fit_rig_synthetic [--cpu]
       [--res 256] [--steps 300] [--cams 9] [--frames 2] [--batch 8]
       [--workdir DIR] [--calib PATH]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.data.frames import save_tiff
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.examples import rig
from fpc_diffrend_tpu_torch.fit import api as fit_api
from fpc_diffrend_tpu_torch.fit import loop as fit_loop
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene, load_calibration
from fpc_diffrend_tpu_torch.models.blendshape import setup_dataset
from fpc_diffrend_tpu_torch.utils.image import save_image


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cams", type=int, default=9)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8,
                    help="samples per step (1 = reference-style serial SGD)")
    ap.add_argument("--workdir", default="")
    ap.add_argument("--calib", default="",
                    help="a calibration.json (default: write the "
                    "synthetic 9-camera rig into the work directory)")
    return ap.parse_args(argv)


def ground_truth_texture() -> np.ndarray:
    """(256, 256, 1) float32, kept below the reference's [0, 140] ingest
    clip."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, 256), np.linspace(-1, 1, 256),
                         indexing="ij")
    tex = (0.18 + 0.2 * np.exp(-(xx ** 2 + yy ** 2) / 0.4)
           + 0.08 * np.sin(xx * 21) * np.sin(yy * 17)).astype(np.float32)
    return tex[..., None]


def render_take(config, scene, params, n_cams, n_frames) -> np.ndarray:
    """(C, F, H, W) uint8 frames in image row order, clipped to 139."""
    h, w = config.resolution
    frames = np.empty((n_cams, n_frames, h, w), np.uint8)
    with torch.no_grad():
        for c in range(n_cams):
            for f in range(n_frames):
                img, _ = fit_loop.render_sample(config, scene, params, c, f)
                arr = img[..., 0].cpu().numpy()[::-1]
                frames[c, f] = np.clip(np.rint(arr * 255), 0, 139).astype(
                    np.uint8)
    return frames


def write_rig(args, work: str, dev) -> dict:
    """Write the head, its blendshapes, the calibration, texture.png and
    the rendered take under ``work``.

    :return: {"config": the FitConfig of the fit, "gt_t", "coverage": each
        camera's frame-0 coverage, "renders": the ground-truth renders}.
    :raises RuntimeError: a camera's coverage is outside
        ``rig.COVERAGE``.
    """
    verts, uvs, faces = rig.head_mesh()
    # rig head position: origin + y offset 170 handled by the pipeline
    basemesh_path = os.path.join(work, "basemesh.obj")
    objlib.save_obj(basemesh_path, verts, uvs, faces)

    bl_dir = os.path.join(work, "blendshapes")
    os.makedirs(bl_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for b, offset in enumerate(rig.blendshape_deltas(verts, rng)):
        objlib.save_obj(os.path.join(bl_dir, f"bs{b}.obj"), verts + offset,
                        uvs, faces)

    calib = args.calib or os.path.join(work, "calibration.json")
    if not args.calib:
        rig.write_synthetic_calibration(calib)
    names = rig.camera_names(calib, args.cams)

    config = FitConfig(
        max_iter=args.steps, basemeshpath=basemesh_path, localblpath=bl_dir,
        imdir=os.path.join(work, "take"), calibpath=calib,
        out_dir=os.path.join(work, "out"), resolution=(args.res, args.res),
        cam_idxs=tuple(range(len(names))), batch_size=args.batch,
        log_interval=max(1, args.steps // 10),
        texpath=os.path.join(work, "texture.png"), **rig.FIT_SETTINGS)

    # intrinsics assume the 1600x1200 sensor; a reduced resolution scales
    # the field of view through the principal-point ratio
    proj, mv = load_calibration(calib, names)
    basemesh = objlib.load_obj(basemesh_path)
    deltas, _, _ = setup_dataset(bl_dir, "", args.frames,
                                 basemesh.vertices.shape[0],
                                 basemesh.vertices)
    scene = build_scene(basemesh, proj, mv, deltas, device=dev)

    # the fit starts from the captured texture (reference texpath workflow)
    tex = ground_truth_texture()
    save_image(config.texpath, np.flip(tex, 0))

    gt = state_mod.init_params(config, args.frames, scene.v_base.shape[0],
                               deltas.shape[1], tex, scene.n_cameras,
                               device=dev)
    gt_t = rng.normal(scale=0.4, size=(args.frames, 3)).astype(np.float32)
    gt["per_frame_t"] = torch.tensor(gt_t, device=dev)
    gt["maps"] = torch.zeros((args.frames, args.frames), device=dev)

    print("rendering ground-truth take through the rig calibration...",
          flush=True)
    frames = render_take(config, scene, gt, len(names), args.frames)
    for ci, cam in enumerate(names):
        camdir = os.path.join(config.imdir, f"take_{cam}")
        os.makedirs(camdir, exist_ok=True)
        for f in range(args.frames):
            save_tiff(os.path.join(camdir, f"take_{cam}_{f:02d}.tif"),
                      frames[ci, f])
    cov = rig.check_coverage(frames, names)
    print(f"take written ({len(names)} cams x {args.frames} frames, "
          f"frame-0 coverage {min(cov):.2f}-{max(cov):.2f})", flush=True)
    return {"config": config, "gt_t": gt_t, "coverage": cov,
            "renders": len(names) * args.frames}


def run(args) -> dict:
    """Write the rig's take, fit it with ``fit_take`` from the files and
    report pose recovery.

    :return: ``write_rig``'s dict and {"ok": the mean pose error ends below
        its starting value, "err0", "err", "results": the result
        directory's files, "state"}.
    """
    dev = resolve_device("cpu" if args.cpu else None)
    work = args.workdir or tempfile.mkdtemp(prefix="fpc_rig_")
    os.makedirs(work, exist_ok=True)
    print("workdir:", work, "| device:", dev, flush=True)
    out = write_rig(args, work, dev)
    config = out["config"]

    # ---- run the public API end to end from the files ----
    state = fit_api.fit_take(config, resume=False, device=dev)

    got_t = state.params["per_frame_t"].detach().cpu().numpy()
    gt_t = out["gt_t"]
    err0 = float(np.abs(gt_t).mean())
    err = float(np.abs(got_t - gt_t).mean())
    print(f"pose error: init {err0:.3f} -> {err:.3f}")
    results = sorted(os.listdir(os.path.join(config.out_dir, "result")))
    print("results:", results)
    ok = err < err0
    print("RECOVERING" if ok else "NOT RECOVERING")
    if not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    return dict(out, ok=ok, err0=err0, err=err, results=results, state=state)


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
