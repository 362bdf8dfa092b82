"""Evaluation: heatmap videos + numerical pixel-difference CSVs (the
port's own copy of ``fpc_diffrend_tpu.tools.comparisons``, host code).

Parity with reference comparisons.py (:21-51 heatmap, :54-81 numerical),
vectorized with numpy instead of the reference's per-pixel Python loops
(comparisons.py:36-48 iterates 1.92M pixels per frame in Python).
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np


def diff_heatmap(img: np.ndarray, ref: np.ndarray,
                 colour: bool = True) -> np.ndarray:
    """Signed (blue/red) or absolute (greyscale) difference visualization.

    Matches comparisons.py:40-48: positive diffs tint red, negative blue,
    scaled by 2 per 8-bit count.
    """
    diff = img.astype(np.int32) - ref.astype(np.int32)
    h, w = diff.shape[:2]
    comp = np.full((h, w, 3), 255, np.int32)
    if colour:
        pos = np.clip(diff, 0, None) * 2
        neg = np.clip(-diff, 0, None) * 2
        comp[..., 0] -= neg
        comp[..., 1] -= pos + neg
        comp[..., 2] -= pos
    else:
        a = np.abs(diff) * 2
        comp -= a[..., None]
    return np.clip(comp, 0, 255).astype(np.uint8)


def compare_sequence(inferred_dir: str, reference_dir: str, save_dir: str,
                     n_frames: int = 120, colour: bool = True,
                     img_pattern: str = "frame{i}_pose.png",
                     ref_pattern: str = "pod2colour_pod2primary_{i:03d}.tif"):
    """Heatmap PNG per frame + mp4 (reference compareSequence)."""
    from PIL import Image

    Path(save_dir).mkdir(parents=True, exist_ok=True)
    try:
        import imageio

        writer = imageio.get_writer(f"{save_dir}/comparison_col.mp4",
                                    mode="I", fps=30, codec="libx264",
                                    bitrate="16M")
    except Exception:
        writer = None
    for i in range(n_frames):
        img = np.array(Image.open(os.path.join(inferred_dir,
                                               img_pattern.format(i=i))))
        ref = np.array(Image.open(os.path.join(reference_dir,
                                               ref_pattern.format(i=i))))
        comp = diff_heatmap(img, ref, colour)
        Image.fromarray(comp).save(f"{save_dir}/colcomp_{i}.png")
        if writer is not None:
            writer.append_data(comp)
    if writer is not None:
        writer.close()


def compare_sequence_numerical(inferred_dir: str, reference_dir: str,
                               save_dir: str, n_frames: int = 120,
                               rows=(200, 1400), cols=(100, 1100),
                               img_pattern: str = "frame{i}_pose.png",
                               ref_pattern: str =
                               "pod2colour_pod2primary_{i:03d}.tif"):
    """Mean-abs-diff over a crop -> CSV (reference compareSequenceNumerical).

    Row format matches the reference (comparisons.py:79): per-frame mean
    followed by per-row means; final line is the sequence mean.
    :return: per-frame means.
    """
    from PIL import Image

    Path(save_dir).mkdir(parents=True, exist_ok=True)
    frame_means = []
    with open(os.path.join(save_dir, "numerical_clip.csv"), "w") as f:
        for i in range(n_frames):
            img = np.array(Image.open(os.path.join(
                inferred_dir, img_pattern.format(i=i)))).astype(np.int32)
            ref = np.array(Image.open(os.path.join(
                reference_dir, ref_pattern.format(i=i)))).astype(np.int32)
            crop = np.abs(img[rows[0]:rows[1], cols[0]:cols[1]]
                          - ref[rows[0]:rows[1], cols[0]:cols[1]])
            row_means = crop.reshape(crop.shape[0], -1).mean(axis=1)
            frame_means.append(float(row_means.mean()))
            f.write(f"{frame_means[-1]}, "
                    + ", ".join(str(m) for m in row_means) + "\n")
        f.write(str(float(np.mean(frame_means))))
    return frame_means


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inferred", required=True)
    ap.add_argument("--reference", required=True)
    ap.add_argument("--save", required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--numerical", action="store_true")
    ap.add_argument("--greyscale", action="store_true")
    args = ap.parse_args()
    if args.numerical:
        compare_sequence_numerical(args.inferred, args.reference, args.save,
                                   args.frames)
    else:
        compare_sequence(args.inferred, args.reference, args.save,
                         args.frames, colour=not args.greyscale)


if __name__ == "__main__":
    main()
