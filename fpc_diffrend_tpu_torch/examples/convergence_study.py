"""Convergence validation: batched SGD against reference-style serial SGD.

The reference optimizes one random (camera, frame) sample per step; the
batched fit takes several per step, which changes the optimization's
dynamics. This study runs the 9-camera rig scene (the synthetic rig of
``examples.rig`` unless ``--calib`` names a calibration; 512^2 by default)
for 2,000 steps at batch 8 and at batch 1 from identical inits and logs
the loss and pose-error curves (``convergence.json``, ``convergence.md``)
as evidence that batched fitting reaches reference-style convergence.
Runs on the CUDA device (the entry cap autotuned), or with ``--cpu`` on
the plain PyTorch versions of the kernels (uncapped).

Usage: python -m fpc_diffrend_tpu_torch.examples.convergence_study [--cpu]
       [--res 512] [--steps 2000] [--cams 9] [--frames 4]
       [--out results/convergence] [--calib PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.examples import rig
from fpc_diffrend_tpu_torch.examples.fit_rig_synthetic import (
    ground_truth_texture, render_take)
from fpc_diffrend_tpu_torch.fit import api as fit_api
from fpc_diffrend_tpu_torch.fit import loop as fit_loop
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene, load_calibration

BATCHES = (8, 1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--cams", type=int, default=9)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="results/convergence")
    ap.add_argument("--calib", default="",
                    help="a calibration.json (default: write the "
                    "synthetic 9-camera rig into --out)")
    return ap.parse_args(argv)


def make_config(args, batch: int, n_cams: int) -> FitConfig:
    return FitConfig(
        max_iter=args.steps, resolution=(args.res, args.res),
        cam_idxs=tuple(range(n_cams)), batch_size=batch,
        log_interval=max(1, args.steps // 40), steps_per_dispatch=25,
        **rig.FIT_SETTINGS)


def build_study(args, near_far=None) -> dict:
    """The rig scene, its ground truth and its take, rendered in memory.

    :param near_far: the cameras' (near, far) depth range; default the
        calibration's, [0.01, 200].
    :return: {"args", "device", "scene", "tex", "gt_t", "frames_u8" (C, F,
        H, W) on the device, "names", "coverage", "renders"}.
    :raises RuntimeError: a camera's coverage is outside
        ``rig.COVERAGE``.
    """
    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    print("device:", dev, flush=True)
    rng = np.random.default_rng(0)
    verts, uvs, faces = rig.head_mesh()
    mesh = objlib.MeshData(vertices=verts.reshape(-1), uv=uvs, faces=faces,
                           fuv=faces)
    calib = args.calib or os.path.join(args.out, "calibration.json")
    if not args.calib:
        rig.write_synthetic_calibration(calib)
    names = rig.camera_names(calib, args.cams)
    proj, mv = load_calibration(calib, names)
    if near_far is not None:       # the GL depth terms of another range
        zn, zf = near_far
        proj[:, 2, 2] = -(zf + zn) / (zf - zn)
        proj[:, 2, 3] = -(2.0 * zf * zn) / (zf - zn)
    deltas = rig.blendshape_deltas(verts, rng)
    deltas = np.ascontiguousarray(deltas.reshape(len(deltas), -1).T)
    scene = build_scene(mesh, proj, mv, deltas, device=dev)
    tex = ground_truth_texture()

    config0 = make_config(args, BATCHES[0], len(names))
    gt = state_mod.init_params(config0, args.frames, scene.v_base.shape[0],
                               rig.N_BLENDSHAPES, tex, scene.n_cameras,
                               device=dev)
    gt_t = rng.normal(scale=0.4, size=(args.frames, 3)).astype(np.float32)
    gt["per_frame_t"] = torch.tensor(gt_t, device=dev)
    print("rendering ground-truth take...", flush=True)
    # render_take gives image row order; the fit reads frames flipped
    frames = render_take(config0, scene, gt, len(names), args.frames)
    frames = np.ascontiguousarray(frames[:, :, ::-1])
    cov = rig.check_coverage(frames, names)
    print(f"take rendered, frame-0 coverage {min(cov):.2f}-{max(cov):.2f}",
          flush=True)
    return {"args": args, "device": dev, "scene": scene, "tex": tex,
            "gt_t": gt_t, "frames_u8": torch.as_tensor(frames, device=dev),
            "names": names, "coverage": cov,
            "renders": len(names) * args.frames}


def initial_state(study: dict, batch: int):
    """The fit's config at ``batch`` samples a step, its entry cap
    autotuned on the card, and the identity init's parameters.

    :return: (config, params).
    """
    args, scene, dev = study["args"], study["scene"], study["device"]
    config = make_config(args, batch, len(study["names"]))

    def init():
        return state_mod.init_params(config, args.frames,
                                     scene.v_base.shape[0],
                                     rig.N_BLENDSHAPES, study["tex"],
                                     scene.n_cameras, device=dev)

    if dev.type == "cuda":
        config = fit_api.autotune_caps(config, scene, init())
    return config, init()


def fit_batch(study: dict, batch: int, seed: int = 0,
              tag: str | None = None) -> dict:
    """Fit the take from the identity init at ``batch`` samples a step.

    :param seed: ``FitConfig.seed``, which seeds the fit's sampling.
    :param tag: the run's name in the printed lines (default "batch N").
    :return: {"curve": [{"step", "loss", "pose_err", "samples"}] after
        each dispatch, "final_pose_err", "final_loss"}.
    """
    args, scene, dev = study["args"], study["scene"], study["device"]
    config, params = initial_state(study, batch)
    config = dataclasses.replace(config, seed=seed)
    tag = tag or f"batch {batch}"
    gt_t = torch.tensor(study["gt_t"], device=dev)
    curve = []

    def cb(i, st, metrics):
        loss = float(metrics["loss"])
        perr = float(torch.mean(torch.abs(
            st.params["per_frame_t"].detach() - gt_t)))
        curve.append({"step": i, "loss": loss, "pose_err": perr,
                      "samples": (i + 1) * batch})
        if len(curve) % 8 == 1:
            print(f"  [{tag}] step {i} loss {loss:.3f} "
                  f"pose_err {perr:.4f}", flush=True)

    print(f"fitting {tag} with batch_size={batch}...", flush=True)
    state = state_mod.init_state(config, params)
    state = fit_loop.run_fit(config, scene, study["frames_u8"], args.frames,
                             callbacks=[cb], state=state)
    final_perr = float(torch.mean(torch.abs(
        state.params["per_frame_t"].detach() - gt_t)))
    out = {"curve": curve, "final_pose_err": final_perr,
           "final_loss": curve[-1]["loss"] if curve else None}
    print(f"{tag}: final loss {out['final_loss']:.3f}, pose err "
          f"{final_perr:.4f} (init {np.abs(study['gt_t']).mean():.4f})",
          flush=True)
    return out


def converged(results: dict) -> bool:
    """The claim under test: batched SGD converges at least as well as
    serial sampling, and both make real progress from the init."""
    b8, b1 = results["batch8"], results["batch1"]
    init_err = results["meta"]["init_pose_err"]
    return (b8["final_pose_err"] < 0.75 * init_err
            and b8["final_pose_err"] <= 1.1 * b1["final_pose_err"]
            and b8["final_loss"] <= 1.2 * b1["final_loss"])


def write_report(study: dict, results: dict) -> bool:
    """Add the run's meta to ``results``, write ``convergence.json`` and
    ``convergence.md`` into ``--out``; :return: :func:`converged`."""
    args = study["args"]
    results["meta"] = {"res": args.res, "steps": args.steps,
                       "cams": len(study["names"]), "frames": args.frames,
                       "init_pose_err": float(np.abs(study["gt_t"]).mean())}
    out_json = os.path.join(args.out, "convergence.json")
    with open(out_json, "w") as f:
        json.dump(results, f, indent=1)
    b8, b1 = results["batch8"], results["batch1"]
    init_err = results["meta"]["init_pose_err"]
    md = os.path.join(args.out, "convergence.md")
    with open(md, "w") as f:
        f.write(
            f"# Batched vs serial SGD convergence ({args.cams}-cam rig, "
            f"{args.res}^2, {args.steps} steps)\n\n"
            f"| run | final loss | final pose err | init pose err |\n"
            f"|---|---|---|---|\n"
            f"| batch 8 | {b8['final_loss']:.3f} | "
            f"{b8['final_pose_err']:.4f} | {init_err:.4f} |\n"
            f"| batch 1 (reference-style) | {b1['final_loss']:.3f} | "
            f"{b1['final_pose_err']:.4f} | {init_err:.4f} |\n\n"
            f"Full curves in convergence.json.\n")
    print("wrote", out_json, "and", md)
    ok = converged(results)
    print("CONVERGED" if ok else "NOT CONVERGED")
    return ok


def run(args) -> dict:
    """Build the study, fit at batch 8 and at batch 1, write the report.

    :return: {"ok": :func:`converged`, "results": convergence.json's
        content, "seconds": {batch: the fit's seconds}}.
    """
    study = build_study(args)
    results, seconds = {}, {}
    for batch in BATCHES:
        t0 = time.time()
        results[f"batch{batch}"] = fit_batch(study, batch)
        seconds[batch] = time.time() - t0
    ok = write_report(study, results)
    return {"ok": ok, "results": results, "seconds": seconds}


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
