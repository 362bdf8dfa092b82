"""Blendshape OBJ normalizer (the port's own copy of
``fpc_diffrend_tpu.tools.batchmodify``; reference batchmodify.py parity).

Rewrites every blendshape OBJ in a directory to carry the base mesh's
vt/vn/f sections, keeping only its own vertex positions — the reference's
fix for rigs whose exported blendshapes lack shared topology sections.
"""

from __future__ import annotations

import argparse
import os


def rewrite_blendshapes(bl_dir: str, basemesh_path: str,
                        out_dir: str | None = None) -> int:
    """Give every blendshape OBJ the base mesh's non-vertex sections.

    :return: number of files rewritten.
    """
    with open(basemesh_path) as f:
        base_rest = [ln for ln in f
                     if not ln.startswith("v ") and ln.strip()
                     and not ln.startswith("#")]

    out_dir = out_dir or bl_dir
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(bl_dir)):
        if not name.endswith(".obj"):
            continue
        src = os.path.join(bl_dir, name)
        with open(src) as f:
            verts = [ln for ln in f if ln.startswith("v ")]
        with open(os.path.join(out_dir, name), "w") as f:
            f.writelines(verts)
            f.writelines(base_rest)
        count += 1
    return count


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blendshapes", required=True)
    ap.add_argument("--basemesh", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    n = rewrite_blendshapes(args.blendshapes, args.basemesh, args.out)
    print(f"rewrote {n} blendshapes")


if __name__ == "__main__":
    main()
