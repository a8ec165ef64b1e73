"""Dataset loader tests with generated on-disk fixtures.

Covers the NeRF-blender (transforms_*.json) and COLMAP text-model
formats — the formats of the reference's release scenes — plus the
synthetic rigs and the checkpoint manager.
"""

import json
import math
import os

import numpy as np

from luisacomputegaussiansplatting_jax.io.dataset import (
    load_colmap_text,
    load_nerf_synthetic,
    sphere_cameras,
    synthetic_multiview,
    turntable_cameras,
)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def test_turntable_and_sphere_rigs_look_at_target():
    for cams in (turntable_cameras(6, radius=3.0), sphere_cameras(6, radius=3.0)):
        assert len(cams) == 6
        for c in cams:
            pos = np.asarray(c.position)
            front = np.asarray(c.front)
            assert abs(np.linalg.norm(pos) - 3.0) < 1e-6
            # front points at the origin
            np.testing.assert_allclose(
                front, -pos / np.linalg.norm(pos), atol=1e-6
            )
            assert abs(np.linalg.norm(front) - 1.0) < 1e-6


def test_nerf_synthetic_loader(tmp_path):
    w, h = 20, 16
    # OpenGL/NeRF c2w: camera at (0, 0, 4) looking down -z toward origin
    c2w = np.eye(4)
    c2w[2, 3] = 4.0
    meta = {
        "camera_angle_x": math.radians(60.0),
        "frames": [
            {"file_path": "./train/r_0", "transform_matrix": c2w.tolist()}
        ],
    }
    (tmp_path / "train").mkdir()
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump(meta, f)
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[:, :, 0] = 200  # red, half-transparent
    rgba[:, :, 3] = 128
    _write_png(tmp_path / "train" / "r_0.png", rgba)

    data = load_nerf_synthetic(str(tmp_path), white_background=True)
    assert len(data) == 1
    cam = data.cameras[0]
    np.testing.assert_allclose(cam.position, (0, 0, 4), atol=1e-9)
    np.testing.assert_allclose(cam.front, (0, 0, -1), atol=1e-9)
    assert cam.width == w and cam.height == h
    # fov_y from camera_angle_x scaled by aspect
    expect_fovy = math.degrees(2 * math.atan(math.tan(math.radians(30)) * h / w))
    assert abs(cam.fov - expect_fovy) < 1e-6
    img = data.targets[0]
    assert img.shape == (3, h, w)
    # alpha compositing onto white: r = 200/255*0.5 + 0.5, g = b = 0.5
    a = 128 / 255.0
    np.testing.assert_allclose(img[0], (200 / 255) * a + (1 - a), atol=2.5e-3)
    np.testing.assert_allclose(img[1], 1 - a, atol=2.5e-3)


def test_colmap_text_loader(tmp_path):
    w, h, f = 32, 24, 30.0
    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.txt", "w") as fh:
        fh.write("# comment\n")
        fh.write(f"1 PINHOLE {w} {h} {f} {f} {w/2} {h/2}\n")
    # identity rotation, camera at origin shifted: tvec = -R p => p = -tvec
    with open(sparse / "images.txt", "w") as fh:
        fh.write("# comment\n")
        fh.write("1 1 0 0 0 0 0 -5 1 img0.png\n")  # qw qx qy qz tx ty tz
        fh.write("\n")  # points2D line
    (tmp_path / "images").mkdir()
    _write_png(
        tmp_path / "images" / "img0.png",
        np.full((h, w, 3), 80, np.uint8),
    )

    data = load_colmap_text(str(tmp_path))
    assert len(data) == 1
    cam = data.cameras[0]
    np.testing.assert_allclose(cam.position, (0, 0, 5), atol=1e-9)
    np.testing.assert_allclose(cam.front, (0, 0, 1), atol=1e-9)  # +z forward
    np.testing.assert_allclose(cam.up, (0, -1, 0), atol=1e-9)  # y-down flipped
    expect_fovy = math.degrees(2 * math.atan(0.5 * h / f))
    assert abs(cam.fov - expect_fovy) < 1e-6
    assert data.targets[0].shape == (3, h, w)
    np.testing.assert_allclose(data.targets[0], 80 / 255.0, atol=1e-3)


def test_synthetic_multiview_targets_consistent():
    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.synthetic import create_cube_scene

    scene = create_cube_scene(nx=3)
    data = synthetic_multiview(
        scene, n_views=3, width=48, height=32,
        cfg=RenderConfig(max_pairs=30_000),
    )
    assert len(data) == 3
    for t in data.targets:
        assert t.shape == (3, 32, 48)
        assert np.isfinite(t).all()
    assert data.targets[0].std() > 0.01  # actual content
    assert data.scene_extent > 0


def _write_colmap_bin(root, w, h, f, qvec, tvec, img_name, points=None):
    """Tiny COLMAP binary model (the format the mip360 release scenes
    ship in sparse/0/*.bin)."""
    import struct

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, w, h))  # id=1 PINHOLE
        fh.write(struct.pack("<4d", f, f, w / 2, h / 2))
    with open(sparse / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<i", 1))
        fh.write(struct.pack("<4d", *qvec))
        fh.write(struct.pack("<3d", *tvec))
        fh.write(struct.pack("<i", 1))
        fh.write(img_name.encode() + b"\x00")
        fh.write(struct.pack("<Q", 2))  # two 2D points (skipped by loader)
        fh.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    if points is not None:
        with open(sparse / "points3D.bin", "wb") as fh:
            fh.write(struct.pack("<Q", len(points)))
            for pid, (xyz, rgb) in enumerate(points):
                fh.write(struct.pack("<Q", pid))
                fh.write(struct.pack("<3d", *xyz))
                fh.write(struct.pack("<3B", *rgb))
                fh.write(struct.pack("<d", 0.5))
                fh.write(struct.pack("<Q", 1))  # track of length 1
                fh.write(struct.pack("<ii", 1, 0))


def test_colmap_binary_loader(tmp_path):
    from luisacomputegaussiansplatting_jax.io.dataset import (
        load_colmap,
        load_colmap_points3d,
    )

    w, h, f = 32, 24, 30.0
    pts = [((1.0, 2.0, 3.0), (255, 0, 0)), ((-1.0, 0.5, 2.0), (0, 128, 255))]
    _write_colmap_bin(tmp_path, w, h, f, (1, 0, 0, 0), (0, 0, -5), "img0.png",
                      points=pts)
    (tmp_path / "images").mkdir()
    _write_png(tmp_path / "images" / "img0.png",
               np.full((h, w, 3), 80, np.uint8))

    data = load_colmap(str(tmp_path))
    assert len(data) == 1
    cam = data.cameras[0]
    np.testing.assert_allclose(cam.position, (0, 0, 5), atol=1e-9)
    np.testing.assert_allclose(cam.front, (0, 0, 1), atol=1e-9)
    np.testing.assert_allclose(cam.up, (0, -1, 0), atol=1e-9)
    expect_fovy = math.degrees(2 * math.atan(0.5 * h / f))
    assert abs(cam.fov - expect_fovy) < 1e-6
    assert data.targets[0].shape == (3, h, w)
    np.testing.assert_allclose(data.targets[0], 80 / 255.0, atol=1e-3)

    xyz, rgb = load_colmap_points3d(str(tmp_path))
    np.testing.assert_allclose(xyz, [[1, 2, 3], [-1, 0.5, 2]], atol=1e-7)
    np.testing.assert_allclose(rgb[0], [1.0, 0.0, 0.0], atol=1e-7)
    np.testing.assert_allclose(rgb[1], [0, 128 / 255, 1.0], atol=1e-7)


def test_colmap_predownscaled_images_dir(tmp_path):
    """mip360-style images_2/images_4 dirs hold pre-downscaled frames
    while sparse/0 intrinsics describe FULL resolution: fy must be
    rescaled to the on-disk resolution, keeping fov resolution-invariant
    (graphdeco scene loader behavior)."""
    from luisacomputegaussiansplatting_jax.io.dataset import load_colmap

    w, h, f = 32, 24, 30.0
    _write_colmap_bin(tmp_path, w, h, f, (1, 0, 0, 0), (0, 0, -5), "img0.png")
    (tmp_path / "images_2").mkdir()
    _write_png(tmp_path / "images_2" / "img0.png",
               np.full((h // 2, w // 2, 3), 80, np.uint8))

    data = load_colmap(str(tmp_path), images_dir="images_2")
    cam = data.cameras[0]
    assert (cam.width, cam.height) == (w // 2, h // 2)
    expect_fovy = math.degrees(2 * math.atan(0.5 * h / f))  # full-res fov
    assert abs(cam.fov - expect_fovy) < 1e-6
    assert data.targets[0].shape == (3, h // 2, w // 2)


def test_colmap_bin_and_text_models_agree(tmp_path):
    """The same model written as .bin and .txt loads identically."""
    from luisacomputegaussiansplatting_jax.io.dataset import load_colmap

    w, h, f = 16, 16, 20.0
    # a non-trivial pose: 90 deg about z plus offset
    qvec = (math.sqrt(0.5), 0.0, 0.0, math.sqrt(0.5))
    tvec = (0.3, -1.2, 4.0)
    img = (np.random.default_rng(0).uniform(0, 255, (h, w, 3))).astype(np.uint8)

    root_b = tmp_path / "b"
    root_b.mkdir()
    _write_colmap_bin(root_b, w, h, f, qvec, tvec, "i.png")
    (root_b / "images").mkdir()
    _write_png(root_b / "images" / "i.png", img)

    root_t = tmp_path / "t"
    sparse = root_t / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.txt", "w") as fh:
        fh.write(f"1 PINHOLE {w} {h} {f} {f} {w/2} {h/2}\n")
    with open(sparse / "images.txt", "w") as fh:
        fh.write("1 " + " ".join(map(str, qvec)) + " "
                 + " ".join(map(str, tvec)) + " 1 i.png\n\n")
    (root_t / "images").mkdir()
    _write_png(root_t / "images" / "i.png", img)

    db, dt = load_colmap(str(root_b)), load_colmap(str(root_t))
    for fld in ("position", "front", "up", "right", "fov"):
        np.testing.assert_allclose(
            np.asarray(getattr(db.cameras[0], fld)),
            np.asarray(getattr(dt.cameras[0], fld)), atol=1e-12)
    np.testing.assert_allclose(db.targets[0], dt.targets[0])


def test_loader_rows_match_render_orientation(tmp_path):
    """Loader-vs-render orientation: the renderer emits bottom-up rows
    (world-up content lands at HIGH row indices; render_cli and the
    reference app/main.cpp:322-337 both vflip at PNG-write). Loaded
    targets must be flipped from PIL's top-down order to match, or the
    training loss compares vertically mirrored images."""
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.ops.render import render_view
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    # one bright gaussian ABOVE the look-at target along camera-up (+z)
    w, h = 48, 48
    cam = look_at_camera((4.0, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                         fov=60.0, width=w, height=h)
    means = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    scales = jnp.full((1, 3), 0.2, jnp.float32)
    quats = jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)
    opac = jnp.ones((1,), jnp.float32)
    sh = jnp.zeros((1, 16, 3), jnp.float32).at[:, 0, :].set(2.0)
    img, _ = render_view(
        means, scales, quats, opac, sh, cam.to_view(), w, h,
        jnp.zeros((3,)), RenderConfig(max_pairs=10_000), 0,
    )
    img = np.asarray(img)
    rows = img.sum(axis=(0, 2))
    com = float((rows * np.arange(h)).sum() / max(rows.sum(), 1e-9))
    assert com > h / 2, "render convention changed: up no longer = high rows"

    # loaders: a PNG whose TOP (PIL row 0) is white must land at HIGH rows
    c2w = np.eye(4)
    c2w[2, 3] = 4.0
    meta = {"camera_angle_x": math.radians(60.0),
            "frames": [{"file_path": "./train/r_0",
                        "transform_matrix": c2w.tolist()}]}
    (tmp_path / "train").mkdir()
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump(meta, f)
    im = np.zeros((h, w, 3), np.uint8)
    im[0, :, :] = 255  # top row white
    _write_png(tmp_path / "train" / "r_0.png", im)
    data = load_nerf_synthetic(str(tmp_path))
    t = data.targets[0]
    assert t[:, h - 1, :].min() > 0.9 and t[:, 0, :].max() < 0.1

    # same for the COLMAP loader
    sparse = tmp_path / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.txt", "w") as fh:
        fh.write(f"1 PINHOLE {w} {h} 30.0 30.0 {w/2} {h/2}\n")
    with open(sparse / "images.txt", "w") as fh:
        fh.write("1 1 0 0 0 0 0 -5 1 img0.png\n\n")
    (tmp_path / "images").mkdir()
    _write_png(tmp_path / "images" / "img0.png", im)
    t = load_colmap_text(str(tmp_path)).targets[0]
    assert t[:, h - 1, :].min() > 0.9 and t[:, 0, :].max() < 0.1


def test_checkpoint_stale_tmp_files_ignored(tmp_path):
    """A crash between np.savez and os.replace leaves ckpt_*.tmp.npz;
    latest_step must skip (and clean) it instead of raising ValueError."""
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.models.checkpoint import (
        CheckpointManager,
    )

    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2, use_orbax=False)
    mgr.save(10, {"a": jnp.arange(3.0)})
    stale = os.path.join(mgr.directory, "ckpt_00000020.npz.tmp.npz")
    with open(stale, "wb") as f:
        f.write(b"partial")
    assert mgr.latest_step() == 10  # not 20, no ValueError
    step, restored = mgr.restore_latest({"a": jnp.zeros(3)})
    assert step == 10
    np.testing.assert_allclose(np.asarray(restored["a"]), np.arange(3.0))
    assert not os.path.exists(stale)  # cleaned up


def test_checkpoint_manager_roundtrip(tmp_path):
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.models.checkpoint import (
        CheckpointManager,
    )

    tree = {"a": jnp.arange(5.0), "b": (jnp.zeros((2, 3)), jnp.int32(7))}
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr.save(10, tree)
    tree2 = {"a": jnp.ones(5), "b": (jnp.ones((2, 3)), jnp.int32(0))}
    mgr.save(20, tree2)
    assert mgr.latest_step() == 20
    step, restored = mgr.restore_latest(tree)
    assert step == 20
    np.testing.assert_allclose(np.asarray(restored["a"]), np.ones(5))
    assert int(restored["b"][1]) == 0
    # restore a specific earlier step
    old = mgr.restore(10, tree)
    np.testing.assert_allclose(np.asarray(old["a"]), np.arange(5.0))
