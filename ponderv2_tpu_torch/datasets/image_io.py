"""PNG reading and writing with the standard library and numpy.

The JAX ``NuScenesDataset`` reads camera images with ``imageio``; the port
reads PNG itself, so that it runs where neither ``imageio`` nor PIL is
installed. ``read_png`` takes 8-bit gray, RGB and RGBA, non-interlaced,
with any of the five row filters; ``read_image`` takes other formats (JPEG,
as real nuScenes sweeps hold) through PIL when PIL is importable and raises
otherwise. ``write_png`` writes 8-bit gray, RGB or RGBA with the Sub filter
on every row, at zlib level 1 (fast, for the procedural scans' cameras).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit only): gray, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter_sequential(ftype: int, line: bytes, prev: bytearray, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) reconstruction, byte by byte: each byte's
    predictor depends on the byte reconstructed ``bpp`` before it."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def read_png(path: str) -> np.ndarray:
    """The image as uint8 (H, W) for gray, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length, type, data, CRC
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, compression, filter_method, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0 or compression != 0 \
            or filter_method != 0:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, interlace "
            f"{interlace}: only 8-bit gray/RGB/RGBA, non-interlaced, is read without PIL")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, want {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum over the row, per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(ftype, line.tobytes(),
                                                     bytearray(prev.tobytes()), bpp),
                                np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
    img = out.reshape(h, w, bpp)
    return img[..., 0] if bpp == 1 else img


def read_image(path: str) -> np.ndarray:
    """A camera image as uint8: PNG by ``read_png``; any other format through
    PIL, which must then be importable."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: not a PNG file, and PIL is not installed to read it") from None
    with Image.open(path) as im:
        return np.asarray(im)


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W), (H, W, 3) or (H, W, 4) as a PNG, every row Sub-
    filtered."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, bpp = img.shape
    color = {1: 0, 3: 2, 4: 6}[bpp]
    sub = img.copy()
    sub[:, 1:] -= img[:, :-1]  # uint8: mod 256
    rows = np.concatenate([np.ones((h, 1), np.uint8), sub.reshape(h, w * bpp)], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(_chunk(b"IEND", b""))
