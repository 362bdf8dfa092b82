"""Camera calibration from 10x10 circle-grid targets (OpenCV, offline;
the port's own copy of ``fpc_diffrend_tpu.tools.calibrate``).

Parity with reference calibrate.py: detect a 10x10 circle grid (2 cm
pitch) across threshold sweeps with a blob-detector fallback, run
``cv2.calibrateCamera`` with the rig's fixed-distortion/intrinsic-guess
flags, convert Rodrigues vectors, and emit the per-camera JSON schema the
fit consumes (calibration/calibration.json). OpenCV stays a host-side
dependency (this never touches the device); the module degrades to a
clear error when cv2 is missing.
"""

from __future__ import annotations

import argparse
import codecs
import json
import os

import numpy as np


def change_cam_name(camname: str) -> str:
    """bottom/top/colour -> primary/secondary/texture (calibrate.py:21-30)."""
    return (camname.replace("bottom", "primary")
            .replace("top", "secondary")
            .replace("colour", "texture"))


def grid_object_points(n: int = 10, pitch_cm: float = 2.0) -> np.ndarray:
    """Known 3D circle-grid points, origin at center (calibrate.py:77-85)."""
    pts = []
    for y in range(n - 1, -n, -2):
        for x in range(-(n - 1), n, 2):
            pts.append([x * pitch_cm / 2.0, y * pitch_cm / 2.0, 0.0])
    return np.asarray(pts, dtype=np.float32)


def calibrate_camera(objpoints, imgpoints, image_shape,
                     intrinsic_guess=None):
    """cv2.calibrateCamera with the reference's flags (calibrate.py:50-72)."""
    import cv2

    if intrinsic_guess is None:
        intrinsic_guess = np.array(
            [[6700.0, 0.0, 800.0], [0.0, 6700.0, 600.0], [0.0, 0.0, 1.0]],
            dtype=np.float32)
    dist = np.zeros(5, np.float32)
    ret, mtx, dist, rvecs, tvecs = cv2.calibrateCamera(
        objpoints, imgpoints, image_shape[::-1], intrinsic_guess, dist,
        flags=(cv2.CALIB_ZERO_TANGENT_DIST | cv2.CALIB_USE_INTRINSIC_GUESS
               | cv2.CALIB_FIX_K1 | cv2.CALIB_FIX_K2 | cv2.CALIB_FIX_K3))
    if not ret:
        return None
    rmat = np.zeros((3, 3), np.float64)
    cv2.Rodrigues(rvecs[0], rmat)
    return {"intrinsic": mtx.tolist(), "rotation": rmat.tolist(),
            "translation": tvecs[0].tolist(), "distortion": dist.tolist()}


def detect_circle_grid(img, thresholds=(200, 190, 180, 170, 160, 150, 140)):
    """Threshold sweep + blob-detector fallback (calibrate.py:86-143)."""
    import cv2

    params = cv2.SimpleBlobDetector_Params()
    params.minThreshold = 1
    params.minCircularity = 0.05
    params.minConvexity = 0.50
    blobdetector = cv2.SimpleBlobDetector_create(params)

    inv = cv2.bitwise_not(img)
    for thres in thresholds:
        _, timg = cv2.threshold(inv, thres, 255, cv2.THRESH_BINARY)
        ret, centers = cv2.findCirclesGrid(timg, np.asarray([10, 10]))
        if not ret:
            ret, centers = cv2.findCirclesGrid(
                timg, np.asarray([10, 10]), blobDetector=blobdetector,
                flags=cv2.CALIB_CB_SYMMETRIC_GRID | cv2.CALIB_CB_CLUSTERING)
        if ret:
            return centers
    return None


def calibrate_directory(path: str, out_json: str) -> dict:
    """Calibrate every camera from a directory of grid images.

    Image files must be named ``{camname}_*``, grouped per camera
    (calibrate.py:110-161).
    """
    import cv2

    objp = grid_object_points()
    calibdict = {}
    by_cam: dict[str, list] = {}
    shapes = {}
    for fname in sorted(os.listdir(path)):
        camname = fname.split("_")[0]
        img = cv2.imread(os.path.join(path, fname),
                         flags=cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        centers = detect_circle_grid(img)
        if centers is None:
            print(f"No centers found for image {path}/{fname}")
            continue
        by_cam.setdefault(camname, []).append(centers)
        shapes[camname] = img.shape

    for camname, imgpoints in by_cam.items():
        objpoints = np.asarray([objp] * len(imgpoints), np.float32)
        result = calibrate_camera(objpoints,
                                  np.asarray(imgpoints, np.float32),
                                  shapes[camname])
        if result:
            calibdict[change_cam_name(camname)] = result

    json.dump(calibdict, codecs.open(out_json, "w", encoding="utf-8"),
              separators=(",", ":"), sort_keys=True, indent=4)
    return calibdict


def add_rodrigues(calib_json: str, out_json: str | None = None) -> dict:
    """Add rotation-vector form to a calibration JSON
    (reference calibConvertRodrigues.py)."""
    import cv2

    with open(calib_json) as f:
        calibs = json.load(f)
    for cam, calib in calibs.items():
        rvec = np.zeros(3, np.float64)
        cv2.Rodrigues(np.asarray(calib["rotation"], np.float64), rvec)
        calib["rotation_rodrigues"] = rvec.tolist()
    out = out_json or calib_json
    json.dump(calibs, codecs.open(out, "w", encoding="utf-8"),
              separators=(",", ":"), sort_keys=True, indent=4)
    return calibs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    calibrate_directory(args.images, args.out)


if __name__ == "__main__":
    main()
