"""Native C++ PLY loader vs the numpy reader: byte-identical results."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.io.native import (
    build_native,
    load_gsply_native,
)
from luisacomputegaussiansplatting_jax.io.ply import load_ply, save_ply
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene


@pytest.fixture(scope="module")
def have_native():
    if not build_native():
        pytest.skip("native toolchain unavailable")
    return True


def test_native_matches_numpy(tmp_path, have_native):
    scene = random_scene(123, seed=9)
    path = tmp_path / "s.ply"
    save_ply(scene, path)

    out = load_gsply_native(str(path))
    assert out is not None, "native loader refused a standard file"
    means, sh, opacity, scales, quats = out

    ref = load_ply(path, use_native=False)
    np.testing.assert_array_equal(means, np.asarray(ref.means))
    np.testing.assert_array_equal(sh, np.asarray(ref.sh))
    np.testing.assert_allclose(opacity, np.asarray(ref.opacities), atol=2e-7)
    np.testing.assert_allclose(scales, np.asarray(ref.scales), rtol=2e-7)
    np.testing.assert_allclose(quats, np.asarray(ref.quats), atol=2e-7)


def test_native_raw_mode(tmp_path, have_native):
    scene = random_scene(17, seed=2)
    path = tmp_path / "s.ply"
    save_ply(scene, path)
    out = load_gsply_native(str(path), apply_activations=False)
    assert out is not None
    _means, _sh, opacity, scales, _quats = out
    ref = load_ply(path, apply_activations=False, use_native=False)
    np.testing.assert_array_equal(opacity, np.asarray(ref.opacities))
    np.testing.assert_array_equal(scales, np.asarray(ref.scales))


def test_native_rejects_ascii(tmp_path, have_native):
    p = tmp_path / "a.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
        "property float y\nproperty float z\nend_header\n0 0 0\n"
    )
    assert load_gsply_native(str(p)) is None  # falls back, no crash


def test_load_ply_prefers_native(tmp_path, have_native):
    scene = random_scene(64, seed=3)
    path = tmp_path / "s.ply"
    save_ply(scene, path)
    a = load_ply(path, use_native=True)
    b = load_ply(path, use_native=False)
    np.testing.assert_array_equal(np.asarray(a.means), np.asarray(b.means))
    np.testing.assert_array_equal(np.asarray(a.sh), np.asarray(b.sh))


def test_native_png_writer_roundtrip(tmp_path):
    """C++ PNG writer output must decode back bit-exact (PIL as reader)."""
    import numpy as np

    from luisacomputegaussiansplatting_jax.io.native import write_png_native

    rng = np.random.default_rng(0)
    hwc = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)  # odd sizes
    path = tmp_path / "t.png"
    ok = write_png_native(str(path), hwc)
    assert ok, "native writer unavailable or failed"
    from PIL import Image

    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, hwc)


def test_write_png_uses_native(tmp_path):
    import numpy as np

    from luisacomputegaussiansplatting_jax.utils.image import read_png, write_png

    img = np.clip(np.random.default_rng(1).random((3, 24, 40)), 0, 1).astype(
        np.float32
    )
    path = tmp_path / "x.png"
    write_png(str(path), img, flip_vertical=False)
    back = read_png(str(path))
    assert np.abs(back - np.floor(img * 255) / 255).max() <= 1 / 255
