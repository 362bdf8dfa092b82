"""Progress frames of a fit (the port's own copy of
``fpc_diffrend_tpu.utils.video``; reference ``mp4_interval``, fit.py:409-412,
637-638).

Every ``mp4_interval`` steps a [reference | render] comparison of the fixed
(camera 0, frame 0) sample is appended to ``progress.mp4`` through imageio
where it is installed with an mp4 encoder, else written as
``progress_{n:05d}.png``, as the JAX package does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fpc_diffrend_tpu_torch.utils.image import make_img, save_image


class ProgressVideo:
    """Accumulates comparison frames: mp4 through imageio, else PNGs."""

    def __init__(self, out_dir: str, fps: int = 30,
                 filename: str = "progress.mp4"):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.count = 0
        try:
            import imageio

            self.writer = imageio.get_writer(
                os.path.join(out_dir, filename), mode="I", fps=fps,
                codec="libx264", bitrate="16M")
        except Exception:
            self.writer = None

    def append(self, ref_img: np.ndarray, render_img: np.ndarray) -> None:
        """Side by side [ref | render], both (H, W[, C]) in [0, 1]."""
        ref = np.asarray(ref_img, np.float32)
        ren = np.asarray(render_img, np.float32)
        if ref.ndim == 2:
            ref = ref[..., None]
        if ren.ndim == 2:
            ren = ren[..., None]
        frame = make_img(np.stack([ref, ren]))
        frame_u8 = np.clip(np.rint(frame * 255.0), 0, 255).astype(np.uint8)
        if self.writer is not None:
            self.writer.append_data(frame_u8)
        else:
            save_image(os.path.join(self.out_dir,
                                    f"progress_{self.count:05d}.png"),
                       frame_u8)
        self.count += 1

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def progress_callback(video: ProgressVideo, config, scene, interval: int,
                      frames_u8):
    """``run_fit`` callback: every ``interval`` steps, render the fixed
    (camera 0, frame 0) sample (a stacked batch of one, as the preview
    does) and append it beside its reference frame."""
    from fpc_diffrend_tpu_torch.fit import loop as loop_mod

    one = torch.zeros((1,), dtype=torch.int64, device=scene.device)
    ref = frames_u8[0, 0].cpu().numpy().astype(np.float32)[..., None] / 255.0

    def cb(i, state, metrics):
        if not interval or i % interval:
            return
        with torch.no_grad():
            img, _ = loop_mod.render_batch(config, scene, state.params, one,
                                           one)
        video.append(ref[::-1], img[0].cpu().numpy()[::-1])

    return cb
