"""Training datasets: camera rigs + target images.

The reference app hard-codes a single camera pose (app/main.cpp:188-207,
acknowledged in its README as a known limitation) and has no training, so
this module is new capability:

  * ``turntable_cameras`` / ``sphere_cameras`` — synthetic camera rigs.
  * ``SyntheticMultiView`` — renders ground-truth targets from a known
    scene with this framework's own renderer (self-supervised fit tests,
    benchmarking, demos).
  * ``load_nerf_synthetic`` — the NeRF-blender ``transforms*.json``
    format used by the reference's lego/chair release scenes.
  * ``load_colmap_text`` — COLMAP text-model cameras (images.txt /
    cameras.txt) used by the mip-NeRF-360 scenes (bicycle/garden).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional

import numpy as np

from ..utils.camera import Camera, look_at_camera


def turntable_cameras(
    n: int,
    target=(0.0, 0.0, 0.0),
    radius: float = 4.0,
    elevation_deg: float = 20.0,
    world_up=(0.0, 0.0, 1.0),
    fov: float = 60.0,
    width: int = 512,
    height: int = 512,
) -> List[Camera]:
    """n cameras on a circle looking at `target` (orbit/turntable rig)."""
    cams = []
    el = math.radians(elevation_deg)
    for i in range(n):
        az = 2.0 * math.pi * i / n
        pos = (
            target[0] + radius * math.cos(az) * math.cos(el),
            target[1] + radius * math.sin(az) * math.cos(el),
            target[2] + radius * math.sin(el),
        )
        cams.append(
            look_at_camera(pos, target, world_up, fov=fov, width=width, height=height)
        )
    return cams


def sphere_cameras(
    n: int,
    target=(0.0, 0.0, 0.0),
    radius: float = 4.0,
    world_up=(0.0, 0.0, 1.0),
    fov: float = 60.0,
    width: int = 512,
    height: int = 512,
    seed: int = 0,
) -> List[Camera]:
    """n cameras quasi-uniform on the upper sphere (fibonacci spiral)."""
    cams = []
    golden = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(n):
        z = (i + 0.5) / n  # upper hemisphere only
        r = math.sqrt(max(0.0, 1.0 - z * z))
        az = golden * i
        pos = (
            target[0] + radius * r * math.cos(az),
            target[1] + radius * r * math.sin(az),
            target[2] + radius * z,
        )
        cams.append(
            look_at_camera(pos, target, world_up, fov=fov, width=width, height=height)
        )
    return cams


@dataclasses.dataclass
class MultiViewDataset:
    """Cameras + (3, H, W) float32 target images in [0, 1]."""

    cameras: List[Camera]
    targets: List[np.ndarray]
    scene_extent: float = 1.0  # world radius (densification size threshold)

    def __len__(self):
        return len(self.cameras)


def synthetic_multiview(
    scene,
    n_views: int = 16,
    width: int = 256,
    height: int = 256,
    radius: float = 4.0,
    fov: float = 60.0,
    cfg=None,
    rig: str = "sphere",
    sh_degree: int = 3,
) -> MultiViewDataset:
    """Render ground-truth targets from `scene` with our own renderer."""
    import jax

    from ..config import RenderConfig
    from ..ops.render import render_view

    cfg = cfg or RenderConfig(max_pairs=1_000_000)
    make = sphere_cameras if rig == "sphere" else turntable_cameras
    cams = make(n_views, radius=radius, fov=fov, width=width, height=height)
    # one compile for every view: the camera is a traced CameraView
    fn = jax.jit(
        lambda view, *a: render_view(
            *a, view, width, height, cfg=cfg, sh_degree=sh_degree
        )[0]
    )
    targets = [
        np.asarray(fn(cam.to_view(), *scene.render_args())) for cam in cams
    ]
    extent = float(np.linalg.norm(np.asarray(scene.means), axis=1).max())
    return MultiViewDataset(cams, targets, scene_extent=max(extent, 1e-6))


def _camera_from_c2w(c2w: np.ndarray, fov_y_deg: float, width: int, height: int) -> Camera:
    """Camera from a 4x4 camera-to-world (OpenGL/NeRF convention:
    camera looks along -z, +y up)."""
    pos = c2w[:3, 3]
    front = -c2w[:3, 2]
    up = c2w[:3, 1]
    right = np.cross(front, up)
    return Camera(
        position=tuple(float(x) for x in pos),
        front=tuple(float(x) for x in front / np.linalg.norm(front)),
        up=tuple(float(x) for x in up / np.linalg.norm(up)),
        right=tuple(float(x) for x in right / np.linalg.norm(right)),
        fov=fov_y_deg,
        width=width,
        height=height,
    )


def load_nerf_synthetic(
    root: str,
    split: str = "train",
    white_background: bool = False,
    max_views: Optional[int] = None,
) -> MultiViewDataset:
    """NeRF-blender dataset: <root>/transforms_<split>.json + PNGs."""
    from ..utils.image import require_pil

    Image = require_pil()

    path = os.path.join(root, f"transforms_{split}.json")
    with open(path) as f:
        meta = json.load(f)
    cameras, targets = [], []
    frames = meta["frames"][:max_views] if max_views else meta["frames"]
    for frame in frames:
        img_path = os.path.join(root, frame["file_path"] + ".png")
        if not os.path.exists(img_path):
            img_path = os.path.join(root, frame["file_path"])
        im = np.asarray(Image.open(img_path), np.float32) / 255.0
        h, w = im.shape[:2]
        if im.shape[-1] == 4:  # alpha-composite onto the background
            rgb, a = im[..., :3], im[..., 3:4]
            bg = 1.0 if white_background else 0.0
            im = rgb * a + bg * (1.0 - a)
        fov_y = math.degrees(
            2.0 * math.atan(math.tan(0.5 * meta["camera_angle_x"]) * h / w)
        )
        c2w = np.asarray(frame["transform_matrix"], np.float64)
        cameras.append(_camera_from_c2w(c2w, fov_y, w, h))
        # PIL rows are top-down; the renderer emits bottom-up rows (render_cli
        # and the reference app/main.cpp:322-337 both flip at PNG-write).
        # Flip targets so the training loss compares matching orientations.
        targets.append(np.transpose(im[::-1, :, :3], (2, 0, 1)).astype(np.float32))
    positions = np.stack([np.asarray(c.position) for c in cameras])
    center = positions.mean(axis=0)
    extent = float(np.linalg.norm(positions - center, axis=1).max()) * 1.1
    return MultiViewDataset(cameras, targets, scene_extent=max(extent, 1e-6))


def _qvec2rot(q: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


# COLMAP camera-model ids -> (name, param count); colmap's camera_models.h
_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _colmap_focals(model: str, p) -> tuple:
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
        return p[0], p[0]
    if model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE",
                 "THIN_PRISM_FISHEYE"):
        return p[0], p[1]
    raise ValueError(f"unsupported COLMAP camera model {model}")


def _colmap_sparse_dir(root: str) -> str:
    sparse = os.path.join(root, "sparse", "0")
    return sparse if os.path.isdir(sparse) else os.path.join(root, "sparse")


def _read_colmap_cameras_txt(path: str) -> dict:
    cams_meta = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
            p = [float(x) for x in parts[4:]]
            fx, fy = _colmap_focals(model, p)
            cams_meta[cam_id] = (w, h, fx, fy)
    return cams_meta


def _read_colmap_images_txt(path: str) -> list:
    """[(qvec(4,), tvec(3,), cam_id, name)] per registered image."""
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#") and ln.strip()]
    out = []
    # images.txt alternates: meta line, 2D-points line
    for meta_line in lines[0::2]:
        parts = meta_line.split()
        out.append(
            (
                np.array([float(x) for x in parts[1:5]]),
                np.array([float(x) for x in parts[5:8]]),
                int(parts[8]),
                parts[9],
            )
        )
    return out


def _read_colmap_cameras_bin(path: str) -> dict:
    """cameras.bin: u64 count, then per camera i32 id, i32 model_id,
    u64 width, u64 height, f64 params[model]."""
    import struct

    cams_meta = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _COLMAP_MODELS[model_id]
            p = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            fx, fy = _colmap_focals(name, p)
            cams_meta[cam_id] = (int(w), int(h), fx, fy)
    return cams_meta


def _read_colmap_images_bin(path: str) -> list:
    """images.bin: u64 count, then per image i32 id, 4xf64 qvec, 3xf64
    tvec, i32 camera_id, cstring name, u64 npts, npts x (f64 x, f64 y,
    i64 point3d_id)."""
    import struct

    out = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            _img_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c in (b"\x00", b""):
                    break
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * npts, os.SEEK_CUR)  # skip 2D points
            out.append((qvec, tvec, cam_id, name.decode()))
    return out


def load_colmap_points3d(root: str):
    """Sparse points: (xyz (N,3) f32, rgb (N,3) f32 in [0,1]).

    The standard 3DGS initialisation (graphdeco scene/dataset_readers):
    gaussian means seeded at the COLMAP sparse points with SH DC from
    the point colour. Reads points3D.bin or points3D.txt.
    """
    import struct

    sparse = _colmap_sparse_dir(root)
    bin_path = os.path.join(sparse, "points3D.bin")
    txt_path = os.path.join(sparse, "points3D.txt")
    xyz, rgb = [], []
    if os.path.exists(bin_path):
        with open(bin_path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                # u64 id, 3xf64 xyz, 3xu8 rgb, f64 error, u64 track_len,
                # track_len x (i32 image_id, i32 point2d_idx)
                _pid = struct.unpack("<Q", f.read(8))[0]
                xyz.append(struct.unpack("<3d", f.read(24)))
                rgb.append(struct.unpack("<3B", f.read(3)))
                f.read(8)  # error
                (tlen,) = struct.unpack("<Q", f.read(8))
                f.seek(8 * tlen, os.SEEK_CUR)
    elif os.path.exists(txt_path):
        with open(txt_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                xyz.append([float(x) for x in parts[1:4]])
                rgb.append([float(x) for x in parts[4:7]])
    else:
        raise FileNotFoundError(f"no points3D.bin/txt under {sparse}")
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb


def load_colmap(
    root: str,
    images_dir: str = "images",
    max_views: Optional[int] = None,
    downscale: int = 1,
) -> MultiViewDataset:
    """COLMAP model: <root>/sparse/0/{cameras,images}.{bin,txt}.

    Binary models (what COLMAP and the mip-NeRF-360 release scenes ship,
    reference README.md:25-29) are preferred; falls back to the text
    model. COLMAP convention: world->cam rotation qvec, translation
    tvec; camera looks along +z, +y down. Converted to our Camera.
    """
    from ..utils.image import require_pil

    Image = require_pil()

    sparse = _colmap_sparse_dir(root)
    if os.path.exists(os.path.join(sparse, "cameras.bin")):
        cams_meta = _read_colmap_cameras_bin(os.path.join(sparse, "cameras.bin"))
        entries = _read_colmap_images_bin(os.path.join(sparse, "images.bin"))
    else:
        cams_meta = _read_colmap_cameras_txt(os.path.join(sparse, "cameras.txt"))
        entries = _read_colmap_images_txt(os.path.join(sparse, "images.txt"))

    cameras, targets, centers = [], [], []
    for qvec, tvec, cam_id, name in entries:
        w, h, fx, fy = cams_meta[cam_id]
        r_w2c = _qvec2rot(qvec)
        pos = -r_w2c.T @ tvec
        front = r_w2c.T @ np.array([0.0, 0.0, 1.0])  # +z forward
        up = r_w2c.T @ np.array([0.0, -1.0, 0.0])  # COLMAP y is down
        right = np.cross(front, up)
        img_path = os.path.join(root, images_dir, name)
        pil = Image.open(img_path).convert("RGB")
        if pil.height != h:
            # pre-downscaled images_dir (e.g. mip360 images_2/images_4):
            # the sparse model's intrinsics describe the FULL-res frames,
            # so rescale fy to the on-disk resolution before the fov math
            fy = fy * (pil.height / h)
        if downscale > 1:
            # filtered resize (graphdeco recipe), not strided subsampling
            # (aliases); rescale fy by the ACTUAL height ratio so the fov
            # matches the downscaled image even when h % downscale != 0
            nw, nh = pil.width // downscale, pil.height // downscale
            fy = fy * (nh / pil.height)
            pil = pil.resize((nw, nh), Image.LANCZOS)
        im = np.asarray(pil, np.float32) / 255.0
        h, w = im.shape[0], im.shape[1]
        fov_y = math.degrees(2.0 * math.atan(0.5 * h / fy))
        cameras.append(
            Camera(
                position=tuple(pos),
                front=tuple(front / np.linalg.norm(front)),
                up=tuple(up / np.linalg.norm(up)),
                right=tuple(right / np.linalg.norm(right)),
                fov=fov_y,
                width=int(w),
                height=int(h),
            )
        )
        # top-down PIL rows -> bottom-up render rows (see load_nerf_synthetic)
        targets.append(np.transpose(im[::-1], (2, 0, 1)).astype(np.float32))
        centers.append(pos)
        if max_views and len(cameras) >= max_views:
            break
    positions = np.stack(centers)
    center = positions.mean(axis=0)
    extent = float(np.linalg.norm(positions - center, axis=1).max()) * 1.1
    return MultiViewDataset(cameras, targets, scene_extent=max(extent, 1e-6))


#: backward-compatible alias (now auto-detects binary vs text models)
load_colmap_text = load_colmap
