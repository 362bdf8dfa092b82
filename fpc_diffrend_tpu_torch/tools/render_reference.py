"""Pack a reference TIF sequence into an mp4 (the port's own copy of
``fpc_diffrend_tpu.tools.render_reference``; reference render_reference.py).
Without an mp4 encoder (``imageio`` and ``imageio_ffmpeg``) it fails as
the JAX tool does."""

from __future__ import annotations

import argparse
import os

import numpy as np


def render_reference(refdir: str, out_path: str, fps: int = 30,
                     pattern: str | None = None) -> int:
    """Append every frame in ``refdir`` (sorted) to an mp4; returns count."""
    import imageio
    from PIL import Image

    files = sorted(f for f in os.listdir(refdir)
                   if f.lower().endswith((".tif", ".tiff", ".png")))
    if pattern:
        files = [f for f in files if pattern in f]
    writer = imageio.get_writer(out_path, mode="I", fps=fps,
                                codec="libx264", bitrate="16M")
    for f in files:
        img = np.array(Image.open(os.path.join(refdir, f)))
        writer.append_data(img)
    writer.close()
    return len(files)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refdir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fps", type=int, default=30)
    args = ap.parse_args()
    n = render_reference(args.refdir, args.out, args.fps)
    print(f"wrote {n} frames to {args.out}")


if __name__ == "__main__":
    main()
