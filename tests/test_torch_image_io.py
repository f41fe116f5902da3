"""The port's image codec (``ponderv2_tpu_torch/datasets/image_io.py`` over
``csrc/image_codec.cpp``) against PIL, bit for bit.

- JPEG decode: PIL's files at 4:4:4, 4:2:2 and 4:2:0, gray, with restart
  markers, at odd sizes and at ScanNet's 1296 x 968 color frame; the pixels
  PIL decodes.
- JPEG encode: the file PIL writes (``save(..., quality=q)``), byte for
  byte, RGB and gray.
- PNG decode: every colour type the readers meet (8-bit gray, gray + alpha,
  RGB, RGBA, palette; 16-bit gray) under each of the five row filters and
  all five in turn; ``encode_png`` round-trips through PIL.
- The resizes: ``resize_bicubic`` at 1296 x 968 -> 640 x 480 (ScanNet's
  color to depth) and others, ``resize_nearest`` of int16 labels.
- Unsupported input raises, naming the feature: progressive, arithmetic-
  coded, lossless and 12-bit JPEG, interlaced PNG; a failed build raises
  with the compiler's output.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ponderv2_tpu_torch.datasets import image_io

SCANNET_COLOR_HW = (968, 1296)
SCANNET_DEPTH_HW = (480, 640)


def smooth_image(rng, h, w, c=3):
    """A photo-like image: smooth gradients under noise, so that JPEG keeps
    both low and high frequencies."""
    y, x = np.mgrid[:h, :w]
    base = np.sin(x / 17.0) * 60 + np.cos(y / 11.0) * 50 + 128
    shape = (h, w, c) if c > 1 else (h, w)
    noise = rng.randint(-40, 40, shape)
    return np.clip((base[..., None] if c > 1 else base) + noise, 0, 255).astype(np.uint8)


def pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


SIZES = [(1, 1), (2, 7), (3, 5), (8, 8), (13, 17), (33, 35), (61, 130), SCANNET_COLOR_HW]


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_decode_equals_pil(hw):
    """Every sampling (4:4:4, 4:2:2, 4:2:0) at two qualities, and gray."""
    rng = np.random.RandomState(hw[0] * 7 + hw[1])
    img = smooth_image(rng, *hw)
    for subsampling in (0, 1, 2):
        for quality in (50, 95):
            data = pil_jpeg(img, quality=quality, subsampling=subsampling)
            got = image_io.decode_jpeg(data)
            assert got.dtype == np.uint8 and got.shape == hw + (3,)
            assert np.array_equal(got, pil_decode(data)), (subsampling, quality)
    gray = pil_jpeg(img[..., 0], quality=90)
    assert np.array_equal(image_io.decode_jpeg(gray), pil_decode(gray))
    assert np.array_equal(image_io.decode_image(gray, rgb=True),
                          np.asarray(Image.open(io.BytesIO(gray)).convert("RGB")))


@pytest.mark.parametrize("option", [dict(restart_marker_blocks=3), dict(restart_marker_rows=1)],
                         ids=["every-3-blocks", "every-row"])
def test_jpeg_decode_restart_markers(option):
    rng = np.random.RandomState(1)
    img = smooth_image(rng, 61, 130)
    data = pil_jpeg(img, quality=90, **option)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # DRI, then RST0 in the data
    assert np.array_equal(image_io.decode_jpeg(data), pil_decode(data))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_encode_is_pils_file(hw):
    """At quality 95 (``extract_sens``'s) and 75 (PIL's default), RGB as
    4:2:0 and gray: the bytes PIL writes."""
    rng = np.random.RandomState(hw[0] + hw[1])
    img = smooth_image(rng, *hw)
    for quality in (75, 95):
        assert image_io.encode_jpeg(img, quality) == pil_jpeg(img, quality=quality)
        assert image_io.encode_jpeg(img[..., 1], quality) == pil_jpeg(img[..., 1],
                                                                      quality=quality)


def png_bytes(raw_rows, w, h, depth, color, filters, bpp, palette=None, interlace=0):
    """A PNG of ``raw_rows`` (h, stride) bytes with row ``y`` filtered by
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    raw = raw_rows.astype(np.int64)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(t, d):
        return struct.pack(">I", len(d)) + t + d + struct.pack(">I", zlib.crc32(t + d))

    out = image_io.PNG_SIGNATURE + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b"")


PNG_KINDS = ["gray8", "gray_alpha8", "rgb8", "rgba8", "palette8", "gray16"]


def png_case(kind, rng, h=23, w=37):
    """(raw rows, depth, colour type, bytes per pixel, palette, the array
    PIL should give)."""
    y, x = np.mgrid[:h, :w]
    ramp = (x * 5 + y * 3)
    if kind == "gray16":
        img = (ramp * 300 + rng.randint(0, 900, (h, w))).astype(np.uint16)
        return img.astype(">u2").view(np.uint8).reshape(h, -1), 16, 0, 2, None, img
    channels = {"gray8": 1, "gray_alpha8": 2, "rgb8": 3, "rgba8": 4, "palette8": 1}[kind]
    img = (ramp[..., None] + rng.randint(0, 60, (h, w, channels))).astype(np.uint8)
    color = {"gray8": 0, "gray_alpha8": 4, "rgb8": 2, "rgba8": 6, "palette8": 3}[kind]
    palette = rng.randint(0, 256, (256, 3)).astype(np.uint8) if kind == "palette8" else None
    want = img[..., 0] if channels == 1 else img
    return img.reshape(h, -1), 8, color, channels, palette, want


@pytest.mark.parametrize("kind", PNG_KINDS)
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "all"])
def test_png_decode_equals_pil(kind, filters):
    rng = np.random.RandomState(len(kind) * 13 + len(filters) + filters[0])
    raw, depth, color, bpp, palette, want = png_case(kind, rng)
    h, w = want.shape[:2]
    data = png_bytes(raw, w, h, depth, color, filters, bpp, palette)
    got = image_io.decode_png(data)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert got.dtype == pil.dtype and np.array_equal(got, pil) and np.array_equal(got, want)
    if depth == 8:
        rgb = image_io.decode_png(data, rgb=True)
        assert np.array_equal(rgb, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "gray16"])
def test_png_encode_round_trips_through_pil(kind, tmp_path):
    rng = np.random.RandomState(3)
    img = png_case(kind, rng)[-1]
    path = str(tmp_path / f"{kind}.png")
    image_io.write_png(path, img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
    assert np.array_equal(image_io.read_png(path), img)


@pytest.mark.parametrize("sizes", [(SCANNET_COLOR_HW, SCANNET_DEPTH_HW), ((13, 17), (5, 7)),
                                   ((5, 7), (13, 17)), ((20, 30), (20, 15)),
                                   ((20, 30), (10, 30))],
                         ids=["scannet", "down", "up", "width-only", "height-only"])
def test_resizes_equal_pil(sizes):
    """``resize_bicubic`` is ``Image.resize``'s default resample on uint8
    RGB and gray; ``resize_nearest`` its NEAREST on int16 labels (PIL mode
    "I"), as ``ScanNetRGBDDataset._load_dir_frame`` resizes them."""
    (h, w), (oh, ow) = sizes
    rng = np.random.RandomState(h + ow)
    img = smooth_image(rng, h, w)
    assert np.array_equal(image_io.resize_bicubic(img, (ow, oh)),
                          np.asarray(Image.fromarray(img).resize((ow, oh))))
    assert np.array_equal(image_io.resize_bicubic(img[..., 0], (ow, oh)),
                          np.asarray(Image.fromarray(img[..., 0]).resize((ow, oh))))
    labels = rng.randint(0, 41, (h, w)).astype(np.int16)
    want = np.asarray(Image.fromarray(labels).resize((ow, oh), Image.NEAREST), np.int16)
    got = image_io.resize_nearest(labels, (ow, oh))
    assert got.dtype == np.int16 and np.array_equal(got, want)


def _patched_sof(data, marker=None, precision=None):
    """PIL's baseline JPEG with its SOF0 marker or its precision byte
    changed: the header of another kind of JPEG."""
    at = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def test_unsupported_input_raises_naming_the_feature():
    rng = np.random.RandomState(4)
    img = smooth_image(rng, 24, 40)
    base = pil_jpeg(img, quality=90)
    with pytest.raises(ValueError, match="progressive JPEG"):
        image_io.decode_jpeg(pil_jpeg(img, quality=90, progressive=True))
    for marker in (0xC9, 0xCA):
        with pytest.raises(ValueError, match="arithmetic-coded JPEG"):
            image_io.decode_jpeg(_patched_sof(base, marker=marker))
    with pytest.raises(ValueError, match="lossless JPEG"):
        image_io.decode_jpeg(_patched_sof(base, marker=0xC3))
    with pytest.raises(ValueError, match="12-bit JPEG"):
        image_io.decode_jpeg(_patched_sof(base, precision=12))
    raw, depth, color, bpp, palette, want = png_case("rgb8", rng)
    data = png_bytes(raw, want.shape[1], want.shape[0], depth, color, (1,), bpp, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        image_io.decode_png(data)
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image_io.decode_image(b"GIF89a" + bytes(16))


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    broken = tmp_path / "image_codec.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(image_io, "CPP", str(broken))
    monkeypatch.setattr(image_io, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(image_io, "_CODEC", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on csrc/image_codec.cpp"):
        image_io.load_codec()
    assert not list((tmp_path / "_build").glob("*.so"))
