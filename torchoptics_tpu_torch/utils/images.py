"""Test images for the imaging path.

PyTorch-side counterpart of ``torchoptics_tpu.utils.images`` (numpy only; it
keeps its own copy of what it needs). Three sources, in order of preference:

* the sample photograph the repository ships,
  ``torchoptics_tpu/data/sample_image.png`` (a public-domain portrait),
  read by path and decoded here with ``zlib`` and numpy, so it needs neither
  PIL nor matplotlib;
* :func:`load_real_test_image`, matplotlib's bundled copy of the same
  portrait (matplotlib imported only when called);
* :func:`synthetic_test_image`, a procedural resolution chart.

All return (H, W, 3) float32 in [0, 255].
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "torchoptics_tpu", "data", "sample_image.png")


def synthetic_test_image(h: int = 128, w: int = 128) -> np.ndarray:
    """Procedural resolution chart standing in for a natural photo."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r = np.hypot(yy - cy, xx - cx)
    theta = np.arctan2(yy - cy, xx - cx)
    spokes = (np.sin(theta * 24) > 0).astype(np.float32)
    rings = (np.sin(r / 4.0) > 0).astype(np.float32)
    img = np.where(r < min(h, w) / 4, spokes, rings)
    rgb = np.stack([img, np.roll(img, h // 8, 0), np.roll(img, w // 8, 1)], axis=-1)
    rgb[: h // 8, : w // 8] = [1, 0, 0]
    rgb[: h // 8, -w // 8:] = [0, 1, 0]
    rgb[-h // 8:, : w // 8] = [0, 0, 1]
    return (rgb * 255).astype(np.float32)


def _resize_nearest_box(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Cheap host-side resize: the pixel at the floor of each output
    position's scaled coordinate."""
    h, w = img.shape[:2]
    oh, ow = hw
    ys = (np.arange(oh) * (h / oh)).astype(int)
    xs = (np.arange(ow) * (w / ow)).astype(int)
    return img[ys][:, xs]


def _unfilter_row(ftype: int, row: bytearray, prior: bytearray, bpp: int) -> bytearray:
    """Undo one of the five PNG row filters in place (None, Sub, Up, Average,
    Paeth); ``prior`` is the previous reconstructed row (zeros for the
    first)."""
    n = len(row)
    if ftype == 0:
        return row
    if ftype == 1:
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif ftype == 2:
        for i in range(n):
            row[i] = (row[i] + prior[i]) & 0xFF
    elif ftype == 3:
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif ftype == 4:
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f"unknown PNG filter type {ftype}")
    return row


def decode_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced greyscale, RGB or RGBA PNG into an
    (H, W, channels) uint8 array: the IDAT stream inflated with ``zlib`` and
    the row filters undone."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    width, height, depth, colour, _, _, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(colour)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: only 8-bit, non-interlaced greyscale/RGB(A) PNGs are "
                         f"decoded here (depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    stride = width * channels
    prior = bytearray(stride)
    rows = []
    for r in range(height):
        start = r * (stride + 1)
        row = _unfilter_row(raw[start], bytearray(raw[start + 1:start + 1 + stride]), prior,
                            channels)
        rows.append(bytes(row))
        prior = row
    return np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(height, width, channels)


def encode_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) values in [0, 1] as an 8-bit RGB PNG (rows
    unfiltered, zlib-compressed), each value rounded to 8 bits; no imaging
    library is needed."""
    img = np.round(np.clip(np.asarray(rgb, np.float64), 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y, :, :3].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@functools.lru_cache(maxsize=None)
def _shipped_rgb() -> np.ndarray:
    img = decode_png(ASSET)
    if img.shape[-1] in (1, 2):                      # greyscale (+ alpha)
        img = np.repeat(img[..., :1], 3, axis=-1)
    img = img[..., :3]                               # drop alpha, as convert("RGB")
    img.setflags(write=False)
    return img


def load_real_test_image(size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """The public-domain portrait bundled with matplotlib, square
    centre-cropped; raises ImportError without matplotlib."""
    from matplotlib import cbook, image as mpimg

    path = cbook._get_data_path("sample_data", "grace_hopper.jpg")
    img = np.asarray(mpimg.imread(str(path)), dtype=np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img.max() <= 1.0:
        img = img * 255.0
    h, w = img.shape[:2]
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    img = img[top: top + side, left: left + side]
    if size is not None:
        img = _resize_nearest_box(img, size)
    return np.ascontiguousarray(img, dtype=np.float32)


def load_shipped_test_image(size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """The repository's sample photograph (512 x 512), decoded from its PNG,
    optionally resized with :func:`_resize_nearest_box`."""
    img = np.asarray(_shipped_rgb(), dtype=np.float32)
    if size is not None:
        img = _resize_nearest_box(img, size)
    return np.ascontiguousarray(img, dtype=np.float32)


def load_test_image(size: Optional[Tuple[int, int]] = None,
                    prefer_real: bool = True) -> np.ndarray:
    """Best available test image: the shipped photograph, then matplotlib's
    bundled one, else the procedural chart (as the JAX package falls back)."""
    if prefer_real:
        for loader in (load_shipped_test_image, load_real_test_image):
            try:
                return loader(size)
            except Exception:
                pass
    hw = size or (128, 128)
    return synthetic_test_image(*hw)
