"""The synthetic head and 9-camera rig the rig examples fit.

``head_mesh`` is the JAX example's closed ellipsoid head (the same
arithmetic, so both packages fit the same mesh). The reference rig's
calibration is not distributed, so ``write_synthetic_calibration`` writes
one of its kind: nine cameras of f = 7,000 px on a 1,600 x 1,200 sensor,
OpenCV convention, on an arc in front of the face, each looking at the
head's centre.
"""

from __future__ import annotations

import json

import numpy as np

SENSOR = (1600, 1200)          # the reference rig's sensor, width x height
FOCAL_PX = 7000.0
HEAD_Y = 170.0                 # load_calibration's baked y offset
DISTANCE = 150.0               # camera to head centre, inside the far plane
ARC = 1.2                      # radians the nine cameras span
COVERAGE = (0.05, 0.95)        # share of a frame above the 45 grey, by 50
N_BLENDSHAPES = 4
# the rig examples' fit settings (the JAX examples' literals)
FIT_SETTINGS = dict(lr_base=5e-4, lr_t=8e-3, lr_q=1e-5,
                    texshape=(256, 256, 1), mode="prior",
                    weight_laplacian=10.0)


def head_mesh(n_ring=48, n_seg=32, radius=9.0):
    """A closed head-ish ellipsoid mesh with cylindrical uv unwrap.

    :return: (verts (V, 3) float32, uvs (V, 2) float32, faces (T, 3)
        int32); the nose bump points to -z.
    """
    verts, uvs = [], []
    for i in range(n_seg + 1):
        theta = np.pi * i / n_seg
        for j in range(n_ring):
            phi = 2 * np.pi * j / n_ring
            x = radius * np.sin(theta) * np.cos(phi)
            y = radius * 1.25 * np.cos(theta)
            z = radius * 0.9 * np.sin(theta) * np.sin(phi)
            # a nose-ish bump toward the cameras (-z in rig space)
            bump = 2.5 * np.exp(-((phi - 4.7) ** 2 * 4 +
                                  (theta - np.pi / 2) ** 2 * 8))
            z -= bump
            verts.append([x, y, z])
            uvs.append([j / (n_ring - 1 + 1e-6), i / n_seg])
    verts = np.asarray(verts, np.float32)
    uvs = np.clip(np.asarray(uvs, np.float32), 0.01, 0.99)

    faces = []
    for i in range(n_seg):
        for j in range(n_ring):
            a = i * n_ring + j
            b = i * n_ring + (j + 1) % n_ring
            c = (i + 1) * n_ring + j
            d = (i + 1) * n_ring + (j + 1) % n_ring
            faces.append([a, b, d])
            faces.append([a, d, c])
    return verts, uvs, np.asarray(faces, np.int32)


def blendshape_deltas(verts: np.ndarray, rng: np.random.Generator,
                      n: int = N_BLENDSHAPES) -> np.ndarray:
    """``n`` smooth localised offsets of the head (jaw/brow-ish bumps),
    drawn from ``rng`` in the JAX examples' order: per blendshape a centre
    vertex, then its 3-vector scale.

    :return: (n, V, 3) float32.
    """
    out = np.empty((n,) + verts.shape, np.float32)
    for b in range(n):
        center = verts[rng.integers(0, len(verts))]
        d = np.exp(-np.sum((verts - center) ** 2, 1) / 8.0)[:, None]
        out[b] = d * rng.normal(scale=0.8, size=(1, 3))
    return out


def write_synthetic_calibration(path: str, n_cams: int = 9) -> list[str]:
    """Write a calibration.json in the reference format that
    ``fit.scene.load_calibration`` reads: per camera ``intrinsic`` (3x3),
    ``distortion`` (1x5, zero), ``rotation`` (3x3) and ``translation``
    (3x1), world to camera, OpenCV convention (+z forward, +y down).

    The cameras stand on a horizontal arc of ``ARC`` radians at
    ``DISTANCE`` from the head centre, which the baked y offset puts at
    (0, 170, 0), on the face's side (-z); each looks at the centre, so
    t = (0, 0, d) - R (0, 170, 0).

    :return: the camera names ("cam0", ...), sorted as the examples take
        them.
    """
    w, h = SENSOR
    intr = [[FOCAL_PX, 0.0, w / 2.0], [0.0, FOCAL_PX, h / 2.0],
            [0.0, 0.0, 1.0]]
    centre = np.array([0.0, HEAD_Y, 0.0])
    calib = {}
    angles = np.linspace(-ARC / 2, ARC / 2, n_cams) if n_cams > 1 else [0.0]
    for i, a in enumerate(angles):
        z_c = np.array([-np.sin(a), 0.0, np.cos(a)])   # toward the head
        y_c = np.array([0.0, -1.0, 0.0])               # image down
        rot = np.stack([np.cross(y_c, z_c), y_c, z_c])
        t = np.array([0.0, 0.0, DISTANCE]) - rot @ centre
        calib[f"cam{i}"] = {"intrinsic": intr,
                            "distortion": [[0.0] * 5],
                            "rotation": rot.tolist(),
                            "translation": t.reshape(3, 1).tolist()}
    with open(path, "w") as f:
        json.dump(calib, f, indent=1)
    return sorted(calib)


def camera_names(calibpath: str, n_cams: int) -> list[str]:
    """The first ``n_cams`` camera names of a calibration, sorted (the JAX
    examples' choice)."""
    with open(calibpath) as f:
        return sorted(json.load(f))[:n_cams]


def check_coverage(frames, names) -> list[float]:
    """Each camera's frame-0 coverage of (C, F, H, W) uint8 frames: the
    share of pixels above 50, over the 45 grey background (the JAX
    example's measure).

    :raises RuntimeError: a camera's coverage is outside ``COVERAGE``.
    """
    cov = [float((frames[c, 0] > 50).mean()) for c in range(len(names))]
    lo, hi = COVERAGE
    bad = {n: round(c, 4) for n, c in zip(names, cov) if not lo <= c <= hi}
    if bad:
        raise RuntimeError(f"the head fills too little or too much of "
                           f"frame 0 (coverage outside [{lo}, {hi}]): {bad}")
    return cov
