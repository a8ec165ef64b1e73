"""The standard-library PNG writer/reader on the main output path."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.utils.image import (
    decode_png,
    encode_png,
    read_png,
    write_png,
)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (120, 160)])
def test_encode_decode_roundtrip(shape):
    rng = np.random.default_rng(sum(shape))
    hwc = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(hwc)), hwc)


def test_decoder_reads_native_writer_output(tmp_path):
    """Round trip against the native C++ writer's files."""
    from luisacomputegaussiansplatting_jax.io.native import write_png_native

    rng = np.random.default_rng(0)
    hwc = rng.integers(0, 256, (29, 41, 3), dtype=np.uint8)
    path = tmp_path / "native.png"
    assert write_png_native(str(path), hwc), "native writer unavailable"
    np.testing.assert_array_equal(decode_png(path.read_bytes()), hwc)


def test_stdlib_writer_matches_native_writer(tmp_path):
    """Both writers encode the same pixels (bytes differ: the native one
    stores, the stdlib one deflates)."""
    img = np.random.default_rng(2).random((3, 24, 40)).astype(np.float32)
    write_png(str(tmp_path / "s.png"), img, use_native=False)
    write_png(str(tmp_path / "n.png"), img, use_native=True)
    np.testing.assert_array_equal(read_png(str(tmp_path / "s.png")),
                                  read_png(str(tmp_path / "n.png")))


def test_decoder_handles_all_row_filters():
    """PNGs from other encoders use filters 1-4: decode one built by
    hand with every filter against the raw pixels."""
    import struct
    import zlib

    rng = np.random.default_rng(9)
    h, w = 5, 7
    hwc = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    px = hwc.reshape(h, w * 3).astype(np.int32)
    raw = b""
    for y in range(h):
        kind = y % 5
        prev = px[y - 1] if y else np.zeros(w * 3, np.int32)
        line = np.zeros(w * 3, np.int32)
        for x in range(w * 3):
            a = px[y, x - 3] if x >= 3 else 0
            c = prev[x - 3] if x >= 3 else 0
            b = prev[x]
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[x] = (px[y, x] - pred) & 0xFF
        raw += bytes([kind]) + line.astype(np.uint8).tobytes()

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(decode_png(png), hwc)
