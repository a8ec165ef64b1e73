"""Image output utilities.

Reproduces the reference app's image post-processing
(app/main.cpp:322-340): CHW float -> HWC uint8 with a vertical flip,
written as PNG. The main path needs nothing beyond numpy and the
standard library: the native writer (native/png_writer.cpp, the
counterpart of the reference's stb_image_write) when it is built, else
the zlib + struct encoder below. Pillow is needed only off the main path
(the viewer's JPEG frames and dataset image loading), through
``require_pil``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def chw_to_png_array(img_chw, flip_vertical: bool = True) -> np.ndarray:
    """(3, H, W) float in [0, 1] -> (H, W, 3) uint8, optionally flipped
    like the reference (main.cpp:331 writes row h-1-i)."""
    img = np.asarray(img_chw)
    img = np.clip(img, 0.0, 1.0)
    hwc = np.transpose(img, (1, 2, 0))
    if flip_vertical:
        hwc = hwc[::-1]
    # the reference truncates (float * 255 -> u8 cast), not rounds
    return (hwc * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(hwc) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    hwc = np.ascontiguousarray(hwc, np.uint8)
    h, w, c = hwc.shape
    if c != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {hwc.shape}")
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), hwc.reshape(h, w * 3)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, channels) uint8. Handles the files this
    package writes and other non-interlaced 8-bit grey/RGB/RGBA PNGs
    (all five row filters)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _comp, _filt, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace})")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        else:  # sub / average / paeth depend on the pixel to the left
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                c = prev[x - channels] if x >= channels else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[x]) // 2
                else:
                    pred = int(_paeth(np.int32(a), prev[x], np.int32(c)))
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, channels)


def write_png(path, img_chw, flip_vertical: bool = True, use_native: bool = True) -> None:
    """Write a (3, H, W) float image as PNG.

    Fast path: the dependency-free C++ writer (native/png_writer.cpp);
    falls back to the standard-library encoder when the shared library is
    unavailable.
    """
    arr = chw_to_png_array(img_chw, flip_vertical)
    if use_native:
        from ..io.native import write_png_native

        if write_png_native(path, arr):
            return
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def read_png(path) -> np.ndarray:
    """PNG -> (3, H, W) float32 in [0, 1] (no flip)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    arr = arr[:, :, :3].astype(np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))


def require_pil():
    """Pillow's ``Image`` module, for the features off the main path
    (viewer JPEG frames, dataset image loading)."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - depends on the install
        raise ImportError(
            "this feature needs Pillow (PIL) to read or encode images; "
            "rendering, training and PNG output do not"
        ) from e
    return Image
