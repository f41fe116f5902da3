"""PNG and JPEG reading and writing, and PIL's resize, without PIL.

The JAX package reads and writes its images with PIL and ``imageio``; the
machine with the card has neither, so the port carries its own codec:
``csrc/image_codec.cpp``, built with ``g++`` into ``csrc/_build/`` at first
use and loaded by ctypes (as ``models/point_group/cluster.py`` builds
``cluster.cpp``). A failed build raises with the compiler's output; there is
no fallback.

- PNG: ``decode_png`` reads 8-bit gray, RGB, RGBA and palette images (a
  palette image gives its indices, as ``np.array(Image.open(...))`` does) and
  16-bit gray (uint16), under all five row filters; chunks and zlib are
  handled here, the row unfilter in the library. ``encode_png`` writes uint8
  gray / RGB / RGBA or uint16 gray, every row Sub-filtered, at zlib level 1.
  Interlaced PNG, bit depths under 8 and 16-bit colour raise.
- JPEG: ``decode_jpeg`` decodes baseline Huffman JPEG (8-bit, gray or YCbCr
  at 4:4:4, 4:2:2 or 4:2:0, restart markers) to the pixels PIL gives:
  libjpeg's islow IDCT, fancy upsampling and YCbCr tables. ``encode_jpeg``
  writes baseline 4:2:0 JPEG at a quality with the Annex K tables, as PIL's
  ``save(..., quality=q)`` does. Progressive, arithmetic-coded, lossless and
  12-bit JPEG raise, naming the feature.
- ``resize_bicubic`` is PIL's ``Image.resize`` of a uint8 gray or RGB image
  (its default, bicubic, resample); ``resize_nearest`` its ``NEAREST``
  resample of a 32-bit image, the labels' path.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from ..utils.host_build import build_library

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
# PNG colour type -> channels: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
CPP = os.path.join(CSRC, "image_codec.cpp")
_ERR_LEN = 512

_CODEC: Optional[ctypes.CDLL] = None


def load_codec() -> ctypes.CDLL:
    """Build ``csrc/image_codec.cpp`` if this source has no build yet (its
    resize's double weights rounded as PIL's C code rounds them: no fused
    multiply-add, ``utils/host_build.py``), then load it. Raises with the
    compiler's output if the build fails."""
    global _CODEC
    if _CODEC is not None:
        return _CODEC
    out = build_library(CPP, BUILD_DIR)
    lib = ctypes.CDLL(out)
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    i64, i32, cp = ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p
    lib.ponder_jpeg_info.restype = ctypes.c_int
    lib.ponder_jpeg_info.argtypes = [u8p, i64, i32p, cp, ctypes.c_int]
    lib.ponder_jpeg_decode.restype = ctypes.c_int
    lib.ponder_jpeg_decode.argtypes = [u8p, i64, u8p, i64, cp, ctypes.c_int]
    lib.ponder_jpeg_encode.restype = i64
    lib.ponder_jpeg_encode.argtypes = [u8p, i32, i32, i32, i32, u8p, i64, cp, ctypes.c_int]
    lib.ponder_png_unfilter.restype = ctypes.c_int
    lib.ponder_png_unfilter.argtypes = [u8p, i64, i64, i32, u8p, cp, ctypes.c_int]
    lib.ponder_resize_bicubic_u8.restype = ctypes.c_int
    lib.ponder_resize_bicubic_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32]
    _CODEC = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


# ------------------------------------------------------------------ PNG

def _png_chunks(data: bytes, name: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length, type, data, CRC
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    return header, b"".join(idat), palette


def decode_png(data: bytes, name: str = "PNG", rgb: bool = False) -> np.ndarray:
    """The image as ``np.array(Image.open(...))`` gives it: uint8 (H, W) for
    gray and palette (its indices), (H, W, C) for gray + alpha, RGB and
    RGBA; uint16 (H, W) for 16-bit gray. With ``rgb``, as
    ``Image.open(...).convert("RGB")`` gives it: (H, W, 3) uint8, gray
    repeated, alpha dropped, a palette applied."""
    (w, h, depth, color, compression, filter_method, interlace), idat, palette = \
        _png_chunks(data, name)
    if interlace != 0:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if compression != 0 or filter_method != 0 or color not in _CHANNELS:
        raise ValueError(f"{name}: PNG of colour type {color}, compression {compression}, "
                         f"filter method {filter_method} is not supported")
    if depth != 8 and not (depth == 16 and color == 0):
        raise ValueError(f"{name}: PNG of bit depth {depth} and colour type {color} is not "
                         "supported (8-bit gray, RGB, RGBA, palette; 16-bit gray)")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data, want {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_codec().ponder_png_unfilter(_ptr(raw), h, stride, bpp, _ptr(out), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
        if rgb:
            raise ValueError(f"{name}: a 16-bit PNG has no RGB form here")
        return img
    img = out.reshape(h, w, channels)
    if not rgb:
        return img[..., 0] if channels == 1 else img
    if color == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        return palette[img[..., 0]]
    if channels in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png(path: str) -> np.ndarray:
    """``decode_png`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 3), (H, W, 4) or uint16 (H, W) as a PNG, every
    row Sub-filtered."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, color, rows = 16, 0, img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
        bpp = 2
    elif img.dtype == np.uint8:
        depth = 8
        if img.ndim == 2:
            img = img[..., None]
        bpp = img.shape[2]
        color = {1: 0, 3: 2, 4: 6}[bpp]
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"encode_png takes uint8 (gray, RGB, RGBA) or uint16 gray, not "
                         f"{img.dtype} of shape {img.shape}")
    h, w = img.shape[:2]
    sub = rows.copy()
    sub[:, bpp:] -= rows[:, :-bpp]  # uint8: mod 256
    filtered = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
            + _chunk(b"IEND", b""))


def _write(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def write_png(path: str, img: np.ndarray) -> None:
    """``encode_png`` into the file at ``path``."""
    _write(path, encode_png(img))


# ------------------------------------------------------------------ JPEG

def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """A baseline JPEG as PIL decodes it: uint8 (H, W, 3) RGB, or (H, W) for
    a gray one."""
    buf = np.frombuffer(data, np.uint8)
    lib = load_codec()
    info = np.zeros(3, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.ponder_jpeg_info(_ptr(buf), buf.size,
                            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    w, h, c = (int(v) for v in info)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    if lib.ponder_jpeg_decode(_ptr(buf), buf.size, _ptr(out), out.size, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """uint8 (H, W, 3) RGB (as 4:2:0 YCbCr) or (H, W) gray as a baseline
    JPEG at ``quality``: the file PIL's ``save(..., quality=quality)``
    writes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes uint8 (H, W) or (H, W, 3), not {img.dtype} "
                         f"of shape {img.shape}")
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    lib = load_codec()
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = 4096 + img.size * 2
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        size = lib.ponder_jpeg_encode(_ptr(img), w, h, channels, int(quality), _ptr(out), cap,
                                      err, _ERR_LEN)
        if size < 0:
            raise ValueError(err.value.decode())
        if size <= cap:
            return out[:size].tobytes()
        cap = size
    raise RuntimeError("encode_jpeg: the encoder's size changed between calls")


def write_jpeg(path: str, img: np.ndarray, quality: int = 75) -> None:
    """``encode_jpeg`` into the file at ``path``."""
    _write(path, encode_jpeg(img, quality))


# ------------------------------------------------------------------ any

def decode_image(data: bytes, name: str = "image", rgb: bool = False) -> np.ndarray:
    """A PNG or JPEG by its signature (``decode_png`` / ``decode_jpeg``);
    ``rgb`` as PIL's ``convert("RGB")``. Other formats raise."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name, rgb=rgb)
    if data[:2] == JPEG_SIGNATURE:
        img = decode_jpeg(data, name)
        return np.repeat(img[..., None], 3, axis=2) if rgb and img.ndim == 2 else img
    raise ValueError(f"{name}: neither PNG nor JPEG")


def read_image(path: str, rgb: bool = False) -> np.ndarray:
    """``decode_image`` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path, rgb=rgb)


# ------------------------------------------------------------------ resize

def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size))`` for uint8 (H, W)
    or (H, W, 3): PIL's bicubic resample; ``size`` is (width, height)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"resize_bicubic takes uint8 (H, W) or (H, W, 3), not {img.dtype} "
                         f"of shape {img.shape}")
    out_w, out_h = (int(v) for v in size)
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize_bicubic: size {size}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    if (out_w, out_h) == (w, h):
        return img.copy()
    out = np.empty((out_h, out_w) + img.shape[2:], np.uint8)
    load_codec().ponder_resize_bicubic_u8(_ptr(img), w, h, ch, _ptr(out), out_w, out_h)
    return out


def _nearest_source(out_n: int, in_n: int) -> np.ndarray:
    """PIL's ``ImagingScaleAffine``: the source index of each output pixel,
    the running sum ``scale / 2, + scale, ...`` truncated (-1: none)."""
    scale = float(np.float32(in_n)) / out_n
    pos = np.cumsum(np.r_[scale * 0.5, np.full(out_n - 1, scale)])
    idx = pos.astype(np.int64)
    return np.where((pos >= 0) & (idx < in_n), idx, -1)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.NEAREST)`` for an integer
    (H, W) image that PIL holds as 32-bit ("I": int16, int32), given back in
    ``img``'s dtype; ``size`` is (width, height)."""
    img = np.asarray(img)
    out_w, out_h = (int(v) for v in size)
    h, w = img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    xs, ys = _nearest_source(out_w, w), _nearest_source(out_h, h)
    out = img[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
    out[ys < 0] = 0
    out[:, xs < 0] = 0
    return out
