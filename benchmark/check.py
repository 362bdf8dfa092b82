"""What decides ``correct``: the program's outputs against the plain
reference of ``benchmark/reference/``, each compared number beside its
limit.

Fit cells: the reference follows the window's first three steps from the
same inputs and compares each step's loss (relative gap), the first
step's gradient as Adam received it, by the worst leaf, and the
parameters' change after the three steps, by the median leaf. A leaf's
gap is |norm(program) - norm(reference)| over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's are nought
to rounding (the correctives, which prior mode never uses) and are left
out of both. The change takes the median leaf because its worst leaf is
not steady: after the first update a vertex can land on a pixel's centre
within rounding, so either side may cover that pixel, and such a flip in
step 2 or 3 moves a pose or map leaf's change by up to 1 % on one run
and not on the next run of the same seed.

View cell: the images a reservoir sample drawn from the seed kept from the
window, against the reference's render of the same (camera, frame) views:
the worst view's mean absolute difference in 8-bit units and its share of
pixels off by more than one 8-bit level.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import fit as ref_fit
from benchmark.reference import render as ref_render


def settings_of(config) -> dict:
    """The reference's settings from a FitConfig."""
    return dict(lr_base=config.lr_base, lr_t=config.lr_t, lr_q=config.lr_q,
                lr_tex_coef=config.lr_tex_coef, lr_ramp=config.lr_ramp,
                max_iter=config.max_iter,
                weight_laplacian=config.weight_laplacian,
                mip_level=config.max_mip_level if config.enable_mip
                else None)


def initial_params(inputs, n_frames: int, device) -> dict:
    """The reference's own initial parameters (prior mode: zero maps,
    identity maps_intermediate, identity quaternions, the inputs'
    texture)."""
    n_c = inputs.proj.shape[0]
    n_v3 = inputs.vertices.shape[0]
    n_b = inputs.deltas.shape[1]
    def z(*shape):
        return torch.zeros(shape, device=device)

    def q(n):
        return torch.cat([z(n, 3), torch.ones((n, 1), device=device)], 1)

    return {"m1": torch.eye(n_frames, device=device),
            "m2": torch.eye(n_frames, device=device), "m3": z(n_v3, n_frames),
            "maps": z(n_frames, n_frames),
            "maps_intermediate": torch.eye(n_b, n_frames, device=device),
            "t_opt": z(n_c, 3), "q_opt": q(n_c), "per_frame_t": z(n_frames, 3),
            "per_frame_q": q(n_frames), "tex": inputs.tex.detach().clone()}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def leaf_gaps(got: dict, want: dict, keep) -> dict:
    """Each leaf's |norm(got) - norm(want)| over max(norm(want), median
    leaf norm of want), over the leaves in ``keep``."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w[k] for k in keep)
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keep}


def change_gaps(got: dict, want: dict) -> dict:
    """Each live leaf's gap of the parameters' change after the steps."""
    keep = live_leaves(want["grad1"])
    p0 = got["params0"]
    return leaf_gaps({k: got["params"][k] - p0[k] for k in keep},
                     {k: want["params"][k] - p0[k] for k in keep}, keep)


def live_leaves(grad1: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    n = _norms(grad1)
    med = statistics.median(n.values())
    return sorted(k for k, v in n.items() if v >= 1e-3 * med)


def fit_numbers(got: dict, want: dict) -> dict:
    """The three compared numbers from the program's first steps (``got``:
    params0, losses, grad1, params) and the reference's (``want``:
    losses, grad1, params)."""
    keep = live_leaves(want["grad1"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(got["losses"], want["losses"])),
        "grad_gap": max(leaf_gaps({k: got["grad1"][k] for k in keep},
                                  {k: want["grad1"][k] for k in keep},
                                  keep).values()),
        "median_change_gap": statistics.median(
            change_gaps(got, want).values()),
    }


def reference_fit(config, inputs, got: dict, batch: int,
                  prec: ref_fit.Precision | None = None, stats=None,
                  batch_filter=None) -> dict:
    """The reference's first ``len(got["losses"])`` steps from the same
    inputs and seed."""
    dev = inputs.frames.device
    rig = ref_fit.make_rig(inputs, dev)
    params0 = initial_params(inputs, inputs.frames.shape[1], dev)
    return ref_fit.fit_steps(rig, params0, inputs.frames, settings_of(config),
                             config.seed, batch, len(got["losses"]),
                             prec or ref_fit.Precision(), stats,
                             batch_filter)


def reference_views(config, inputs, requests,
                    prec: ref_fit.Precision | None = None, stats=None):
    """The reference's images (H, W, C) of (camera, frame) views of the
    inputs' fitted state."""
    dev = inputs.tex.device
    rig = ref_fit.make_rig(inputs, dev)
    params = initial_params(inputs, inputs.state["maps"].shape[0], dev)
    params.update({k: v.to(dev) for k, v in inputs.state.items()})
    h, w = config.resolution
    out = []
    with torch.no_grad():
        for cam, frame in requests:
            clip, _ = ref_fit.clip_positions(rig, params, cam, frame,
                                             prec or ref_fit.Precision())
            out.append(ref_render.render_view(
                clip, rig.faces, rig.uv, rig.uv_idx, rig.face_neighbors,
                params["tex"], h, w,
                config.max_mip_level if config.enable_mip else None, stats))
    return out


def view_numbers(pairs) -> dict:
    """Worst view's numbers over (program image, reference image) pairs."""
    mad, off = 0.0, 0.0
    for got, want in pairs:
        d = torch.abs(got.to(want.device).double() - want.double()) * 255.0
        mad = max(mad, float(d.mean()))
        off = max(off, float((d > 1.0).double().mean()))
    return {"img_mad_u8": mad, "img_off_share": off}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, lines): every number at or under its limit; a NaN fails.
    Each line is 'name value limit limit'."""
    ok = True
    lines = []
    for name, value in numbers.items():
        lim = limits[name]
        good = value <= lim
        ok = ok and good
        lines.append(f"{name} {value!r} limit {lim!r}")
    return ok, lines
