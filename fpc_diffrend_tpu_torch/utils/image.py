"""Image utilities (port of ``fpc_diffrend_tpu.utils.image``).

Whitening, normalization, highlight reduction and the gaussian kernels and
blur work on tensors (the blur is two depthwise ``F.conv2d`` passes, as
the JAX package's is two depthwise XLA convolutions); preview grids and
image files on numpy arrays.

PNG is written with the standard library (``zlib``, ``struct``): 8-bit
gray, gray + alpha, RGB or RGBA, not interlaced. The machines the port runs
on need not have PIL: ``load_image`` reads through PIL where it is
installed, and such a PNG through the standard library where it is not.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}          # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOUR_TYPE.items()}


def reduce_highlights(img, mean) -> Tensor:
    """abs(img - (img - mean)) (reference utils.py:12-15)."""
    img = torch.as_tensor(img)
    return torch.abs(img - (img - mean))


def normalize_highlights(img, alpha: float = 0.99,
                         beta: float = 0.5) -> Tensor:
    """Gamma-ish highlight compression over the image's range (reference
    utils.py:17-35)."""
    img = torch.as_tensor(img)
    lo = torch.min(img)
    rng = torch.max(img) - lo
    return (((img - lo) / rng) ** alpha * rng + lo) * beta


def whiten(image, mean, std) -> Tensor:
    """(image - mean) / std (reference utils.py:39-52)."""
    return (torch.as_tensor(image) - mean) / std


def normalize_image(image, low, high) -> Tensor:
    """(image - low) / (high - low) (reference utils.py:56-67)."""
    return (torch.as_tensor(image) - low) / (high - low)


def gaussian_1d(m: int, std: float) -> Tensor:
    """Unnormalized 1D gaussian window of ``m`` taps (reference
    utils.py:139-143)."""
    n = torch.arange(0, m, dtype=torch.float32) - (m - 1.0) / 2.0
    return torch.exp(-(n ** 2) / (2 * std * std))


def gaussian_kernel(kernel_size: int, std: float = 128.0) -> Tensor:
    """2D gaussian kernel, the outer product of two windows (reference
    utils.py:147-156)."""
    k1 = gaussian_1d(kernel_size, std)
    return torch.outer(k1, k1)


def gaussian_blur(image: Tensor, kernel_size: int, sigma: float) -> Tensor:
    """Depthwise gaussian blur of an (H, W, C) image with a normalized
    kernel and "same" zero padding, on the image's device."""
    k1 = gaussian_1d(kernel_size, sigma).to(image.device)
    k1 = k1 / torch.sum(k1)
    c = image.shape[-1]
    x = torch.movedim(image, -1, 0)[None]                 # (1, C, H, W)
    kh = k1.reshape(1, 1, -1, 1).expand(c, 1, kernel_size, 1)
    kw = k1.reshape(1, 1, 1, -1).expand(c, 1, 1, kernel_size)
    x = F.conv2d(x, kh, padding="same", groups=c)
    x = F.conv2d(x, kw, padding="same", groups=c)
    return torch.movedim(x[0], 0, -1)


def to_uint8(x) -> np.ndarray:
    """uint8 as is; anything else taken as [0, 1] and rounded."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        x = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    return x


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_image(filepath: str, x) -> None:
    """Write an (H, W) or (H, W, C) image, uint8 or float in [0, 1], as an
    8-bit PNG (C in 1..4)."""
    x = to_uint8(x)
    if x.ndim == 2:
        x = x[..., None]
    h, w, c = x.shape
    if c not in _COLOUR_TYPE:
        raise ValueError(f"cannot write {c} channels as PNG")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(x).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    with open(filepath, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` (h, 1 + w*c) uint8.

    Pixel (y, x) depends on its left, upper and upper-left neighbours, so
    the pixels of one anti-diagonal y + x = d are independent: the loop
    runs over the h + w - 1 diagonals, each one numpy pass. Skewed views
    make a diagonal a plain slice: ``rv[y, d]`` is the filtered pixel
    (y, x = d - y), and ``sv[i, e]`` is ``pad[i, e - i]`` of the output
    padded with a zero row and column, so (y, x) is written at
    ``sv[y + 1, d + 2]``, its left neighbour is ``sv[y + 1, d + 1]``, the
    upper one ``sv[y, d + 1]``, the upper-left one ``sv[y, d]``.
    """
    kinds = raw[:, :1].astype(np.int16)
    pad = np.zeros((h + 1, w + 1, c), np.uint8)
    strided = np.lib.stride_tricks.as_strided
    sv = strided(pad, (h + 1, h + w + 1, c), (w * c, c, 1))
    rv = strided(raw.reshape(-1)[1:], (h, h + w - 1, c),
                 (1 + w * c - c, c, 1), writeable=False)
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = sv[y0 + 1:y1 + 1, d + 1].astype(np.int16)
        b = sv[y0:y1, d + 1].astype(np.int16)
        ul = sv[y0:y1, d].astype(np.int16)
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        k = kinds[y0:y1]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        sv[y0 + 1:y1 + 1, d + 2] = (rv[y0:y1, d] + pred) & 255
    return pad[1:, 1:]


def _read_png(data: bytes) -> np.ndarray | None:
    """(H, W, C) uint8 of an 8-bit, non-interlaced PNG; None otherwise."""
    if not data.startswith(_PNG_SIG):
        return None
    pos, idat, header = len(_PNG_SIG), [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        return None
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in _CHANNELS:
        return None
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    if raw[:, 0].max(initial=0) > 4:
        return None
    if not raw[:, 0].any():
        return raw[:, 1:].reshape(h, w, c)
    return _unfilter(raw, h, w, c)


def load_image(filepath: str) -> np.ndarray:
    """(H, W, C) array of an image file: through PIL where it is installed,
    else an 8-bit PNG through the standard library.

    :raises RuntimeError: PIL is missing and the file is not such a PNG.
    """
    try:
        from PIL import Image
    except ImportError:
        with open(filepath, "rb") as f:
            img = _read_png(f.read())
        if img is None:
            raise RuntimeError(f"{filepath}: not an 8-bit PNG, and PIL is "
                               "not installed to read it") from None
        return img
    img = np.array(Image.open(filepath))
    return img[..., None] if img.ndim == 2 else img


def make_img(arr, ncols: int = 2) -> np.ndarray:
    """Stack N same-shape (H, W, C) images into a grid of ``ncols``."""
    arr = np.asarray(arr)
    n, height, width, nc = arr.shape
    nrows = n // ncols
    if n != nrows * ncols:
        raise ValueError(f"{n} images do not fill rows of {ncols}")
    return (arr.reshape(nrows, ncols, height, width, nc).swapaxes(1, 2)
            .reshape(height * nrows, width * ncols, nc))


def display_image(image, path: str = "preview.png") -> bool:
    """Headless stand-in for the reference's GL preview window: writes the
    current frame to a PNG."""
    save_image(path, np.asarray(image))
    return True
