"""NorPix .seq capture-file reader and TIF extractor: the port's own copy
of ``fpc_diffrend_tpu.data.seq`` (host code, the same functions and
arguments). Uncompressed frames of :func:`extract_to_tif` are read in one
bulk call through the native runtime (``runtime.native.seq_read_frames``)
where it is built, else frame by frame.

Replaces the reference's MATLAB tooling (src/matlab/ReadJpegSEQ.m,
extractSeqToTif.m): parses the 8192-byte NorPix header (fixed little-endian
field offsets, ReadJpegSEQ.m:47-96), reads uncompressed monochrome frames
by direct offset (ReadJpegSEQ.m:145-198) or JPEG-compressed frames via a
4-byte size prefix (ReadJpegSEQ.m:200-280), and exports TIF sequences in
the ``{cam}_{frame:0Nd}.tif`` layout the fit consumes.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import os
import struct

import numpy as np

HEADER_SIZE = 8192
_MAGIC = 0xFEED


@dataclasses.dataclass
class SeqHeader:
    width: int
    height: int
    bit_depth: int
    bit_depth_real: int
    image_size_bytes: int
    image_format: int
    n_frames: int
    true_image_size: int
    frame_rate: float
    compressed: bool


def read_header(f) -> SeqHeader:
    """Parse the fixed-offset NorPix header (ReadJpegSEQ.m:47-96)."""
    f.seek(0)
    raw = f.read(HEADER_SIZE)
    if len(raw) < 1024:
        raise ValueError("file too small to be a .seq")
    magic = struct.unpack_from("<I", raw, 0)[0]
    if magic != _MAGIC:
        raise ValueError(f"not a NorPix seq (magic {magic:#x})")

    def u32(off):
        return struct.unpack_from("<I", raw, off)[0]

    width = u32(548)
    height = u32(552)
    bit_depth = u32(556)
    bit_depth_real = u32(560)
    image_size_bytes = u32(564)
    image_format = u32(568)
    n_frames = u32(572)
    true_image_size = u32(580)
    frame_rate = struct.unpack_from("<d", raw, 584)[0]
    # formats >= 100 are JPEG-compressed in NorPix files; the reference
    # MATLAB also keys on the descriptive format id
    compressed = image_format in (16, 17, 18, 102, 201, 100, 101)
    return SeqHeader(width, height, bit_depth, bit_depth_real,
                     image_size_bytes, image_format, n_frames,
                     true_image_size, frame_rate, compressed)


class SeqReader:
    """Random-access frame reader for a NorPix .seq file."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self.header = read_header(self.f)
        self._offsets: list[int] | None = None
        if self.header.compressed:
            self._index_compressed()

    def _index_compressed(self):
        """Scan the variable-size compressed frame chain once."""
        h = self.header
        offsets = []
        off = HEADER_SIZE
        size = os.path.getsize(self.path)
        while off + 4 <= size and len(offsets) < h.n_frames:
            self.f.seek(off)
            (img_size,) = struct.unpack("<I", self.f.read(4))
            if img_size == 0 or off + img_size > size:
                break
            offsets.append(off)
            # frame block: 4-byte size + jpeg + 8-byte timestamp, padded
            off += img_size + 8
        self._offsets = offsets

    def __len__(self):
        return (len(self._offsets) if self._offsets is not None
                else self.header.n_frames)

    def read_frame(self, i: int) -> np.ndarray:
        h = self.header
        if h.compressed:
            assert self._offsets is not None and i < len(self._offsets)
            self.f.seek(self._offsets[i])
            (img_size,) = struct.unpack("<I", self.f.read(4))
            data = self.f.read(img_size - 4)
            from PIL import Image

            return np.array(Image.open(io.BytesIO(data)))
        # uncompressed: fixed-size records (ReadJpegSEQ.m:145-198)
        self.f.seek(HEADER_SIZE + i * h.true_image_size)
        if h.bit_depth <= 8:
            dtype, nbytes = np.uint8, h.width * h.height
        else:
            dtype, nbytes = np.uint16, h.width * h.height * 2
        buf = self.f.read(nbytes)
        return np.frombuffer(buf, dtype=dtype).reshape(h.height, h.width)

    def timestamps(self) -> list[float]:
        """Per-frame timestamps (seconds + subseconds; ReadJpegSEQ.m:282-294)."""
        h = self.header
        out = []
        for i in range(len(self)):
            if h.compressed:
                self.f.seek(self._offsets[i])
                (img_size,) = struct.unpack("<I", self.f.read(4))
                self.f.seek(self._offsets[i] + img_size)
            else:
                self.f.seek(HEADER_SIZE + i * h.true_image_size
                            + h.image_size_bytes)
            sec, ms, us = struct.unpack("<IHH", self.f.read(8))
            out.append(sec + ms / 1e3 + us / 1e6)
        return out

    def close(self):
        self.f.close()


def write_seq(path: str, frames: np.ndarray, frame_rate: float = 30.0):
    """Write an uncompressed monochrome .seq (for tests and interchange)."""
    frames = np.asarray(frames)
    n, h, w = frames.shape[:3]
    assert frames.dtype == np.uint8
    true_size = ((w * h + 8 + 8191) // 8192) * 8192
    header = bytearray(HEADER_SIZE)
    struct.pack_into("<I", header, 0, _MAGIC)
    struct.pack_into("<I", header, 548, w)
    struct.pack_into("<I", header, 552, h)
    struct.pack_into("<I", header, 556, 8)
    struct.pack_into("<I", header, 560, 8)
    struct.pack_into("<I", header, 564, w * h)
    struct.pack_into("<I", header, 568, 0)  # 0 = uncompressed monochrome
    struct.pack_into("<I", header, 572, n)
    struct.pack_into("<I", header, 580, true_size)
    struct.pack_into("<d", header, 584, frame_rate)
    with open(path, "wb") as f:
        f.write(header)
        for i in range(n):
            rec = bytearray(true_size)
            rec[: w * h] = frames[i].tobytes()
            struct.pack_into("<IHH", rec, w * h, i, 0, 0)
            f.write(rec)


def extract_to_tif(seq_path: str, out_dir: str, cam_name: str,
                   digits: int = 3) -> int:
    """Export every frame as ``{cam}_{i:0{digits}d}.tif``
    (extractSeqToTif.m parity). Returns the frame count."""
    from PIL import Image

    from fpc_diffrend_tpu_torch.runtime import native

    os.makedirs(out_dir, exist_ok=True)
    reader = SeqReader(seq_path)
    h = reader.header
    n = len(reader)
    if not h.compressed and h.bit_depth <= 8 and native.available():
        frames = native.seq_read_frames(seq_path, 0, n, h.width, h.height,
                                        h.true_image_size)
    else:
        frames = (reader.read_frame(i) for i in range(n))
    for i, img in enumerate(frames):
        Image.fromarray(img).save(
            os.path.join(out_dir, f"{cam_name}_{i:0{digits}d}.tif"))
    reader.close()
    return n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cam", required=True)
    ap.add_argument("--digits", type=int, default=3)
    args = ap.parse_args()
    n = extract_to_tif(args.seq, args.out, args.cam, args.digits)
    print(f"extracted {n} frames")


if __name__ == "__main__":
    main()
