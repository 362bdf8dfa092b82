"""Reference-frame ingest: a take's frames loaded once into one array.

The port's own copy of ``fpc_diffrend_tpu.data.frames``. A take is
``{imdir}/{cam}/{cam}_{frame:0{digits}d}.tif`` for every camera directory;
``load_take`` decodes it into a (n_cams, n_frames, H, W) uint8 array,
clipped to [0, 140] and flipped vertically at ingest (reference
fit.py:529-532), optionally cached as a .npy file. Decoding goes through the
native runtime's threaded TIFF decoder; PIL, where it is installed, reads
the take only if that decoder rejects a file.
"""

from __future__ import annotations

import os

import numpy as np

from fpc_diffrend_tpu_torch.runtime import native


def frame_digits(n_frames: int) -> int:
    """Zero-padding width of frame numbers (reference fit.py:43)."""
    return 2 if n_frames < 100 else 3


def assert_num_frames(cams: list[str], imdir: str) -> tuple[int, int]:
    """(frame count, digit width); every camera must hold as many frames.

    :raises ValueError: the cameras disagree.
    """
    n_frames = [len(os.listdir(os.path.join(imdir, c))) for c in cams]
    if any(x != n_frames[0] for x in n_frames):
        raise ValueError("All cameras do not have the same number of "
                         f"frames! {dict(zip(cams, n_frames))}")
    return n_frames[0], frame_digits(n_frames[0])


def _load_with_pil(paths: list[str], n_cams: int, n_frames: int,
                   clip_max: int) -> np.ndarray:
    from PIL import Image

    first = np.array(Image.open(paths[0]))
    out = np.empty((n_cams * n_frames,) + first.shape[:2], np.uint8)
    for i, path in enumerate(paths):
        img = np.clip(np.array(Image.open(path)), 0, clip_max)
        out[i] = img[::-1].astype(np.uint8)
    return out.reshape((n_cams, n_frames) + first.shape[:2])


def load_take(imdir: str, cams: list[str], clip_max: int = 140,
              cache: str | None = None) -> np.ndarray:
    """All frames of a take: (n_cams, n_frames, H, W) uint8, clipped to
    [0, clip_max] and flipped vertically.

    :param cache: a .npy path; read (memory-mapped) when it exists,
        written otherwise.
    :raises RuntimeError: the native decoder rejects a file and PIL is not
        installed to read it.
    """
    if cache and os.path.exists(cache):
        return np.load(cache, mmap_mode="r")
    n_frames, digits = assert_num_frames(cams, imdir)
    paths = [os.path.join(imdir, cam, f"{cam}_{fi:0{digits}d}.tif")
             for cam in cams for fi in range(n_frames)]
    out = None
    reason = native.unavailable_reason()
    if not reason:
        probe = native.tiff_probe(paths[0])
        if probe is None:
            reason = f"{paths[0]} is not an uncompressed grayscale TIFF"
        else:
            w, h = probe
            try:
                out = native.load_tiffs(paths, w, h, clip_max=clip_max,
                                        flip=True)
                out = out.reshape(len(cams), n_frames, h, w)
            except RuntimeError as e:
                reason = str(e)
    if out is None:
        try:
            out = _load_with_pil(paths, len(cams), n_frames, clip_max)
        except ImportError as e:
            raise RuntimeError(f"cannot decode the take natively ({reason})"
                               " and PIL is not installed") from e
    if cache:
        np.save(cache, out)
    return out


def load_tiff(path: str) -> np.ndarray:
    """One grayscale TIFF as it is on disk: (H, W) uint8, neither clipped
    nor flipped (a reference frame beside a re-render). Decoded by the
    native runtime; PIL, where it is installed, reads a file it rejects.

    :raises RuntimeError: the native decoder rejects the file and PIL is
        not installed to read it.
    """
    reason = native.unavailable_reason()
    if not reason:
        probe = native.tiff_probe(path)
        if probe is not None:
            w, h = probe
            return native.load_tiffs([path], w, h, clip_max=255,
                                     flip=False)[0]
        reason = f"{path} is not an uncompressed grayscale TIFF"
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"cannot decode {path} natively ({reason}) and "
                           "PIL is not installed") from e
    return np.array(Image.open(path))


def synthetic_take(render_fn, n_cams: int, n_frames: int) -> np.ndarray:
    """A synthetic take: ``render_fn(cam, frame)`` gives an (H, W) image in
    [0, 1]; :return: (n_cams, n_frames, H, W) uint8."""
    sample = np.asarray(render_fn(0, 0))
    out = np.empty((n_cams, n_frames) + sample.shape, np.uint8)
    for c in range(n_cams):
        for f in range(n_frames):
            img = np.asarray(render_fn(c, f))
            out[c, f] = np.clip(np.rint(img * 255.0), 0, 255).astype(
                np.uint8)
    return out
