"""Camera model and view/projection matrix construction.

Parity notes (all citations into /root/reference):
  * Camera fields and defaults: lcgs/include/lcgs/util/camera.h:15-25
    (fov is the *vertical* field of view in degrees).
  * world->view matrix: camera.h:38-51 (rows = right/up/front, translation
    by -dot(position, axis); view-space +z is the viewing direction).
  * projection matrix: camera.h:54-72 (maps z in [znear, zfar] to [0, 1],
    w_clip = z_view).
  * look-at construction: camera.h:74-82.
  * tanfov/focal derivation: lcgs/src/gs_projector/impl.cpp:34-42.

The Camera is a frozen dataclass of Python floats/tuples: it is a *static*
argument to jitted renders only in shape terms — matrices are built with
jnp so camera parameters may also be traced (e.g. for camera-pose grads).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

Vec3 = Tuple[float, float, float]


class CameraView(NamedTuple):
    """Traced camera representation: a jax pytree, so it can be vmapped
    over (multi-view batches) and fed through jit/shard_map with camera
    poses as runtime data. Image width/height stay static args."""

    view: jnp.ndarray  # (4, 4) world->view matrix
    position: jnp.ndarray  # (3,)
    tan_fovx: jnp.ndarray  # ()
    tan_fovy: jnp.ndarray  # ()


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Vec3
    front: Vec3
    up: Vec3
    right: Vec3
    fov: float = 60.0  # vertical FoV, degrees
    width: int = 512
    height: int = 512

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def tan_fovy(self) -> float:
        return math.tan(math.radians(self.fov) * 0.5)

    @property
    def tan_fovx(self) -> float:
        return self.tan_fovy * self.aspect

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)

    def resized(self, width: int, height: int) -> "Camera":
        return dataclasses.replace(self, width=width, height=height)

    def to_view(self) -> CameraView:
        return CameraView(
            view=view_matrix(self),
            position=jnp.asarray(self.position, jnp.float32),
            tan_fovx=jnp.float32(self.tan_fovx),
            tan_fovy=jnp.float32(self.tan_fovy),
        )


def look_at_camera(
    position,
    target,
    world_up,
    fov: float = 60.0,
    width: int = 512,
    height: int = 512,
) -> Camera:
    """Build a camera looking from ``position`` towards ``target``
    (parity: reference camera.h:74-82)."""
    position = np.asarray(position, np.float64)
    target = np.asarray(target, np.float64)
    world_up = np.asarray(world_up, np.float64)
    front = target - position
    front = front / np.linalg.norm(front)
    right = np.cross(front, world_up)
    right = right / np.linalg.norm(right)
    up = np.cross(right, front)
    up = up / np.linalg.norm(up)
    return Camera(
        position=tuple(float(v) for v in position),
        front=tuple(float(v) for v in front),
        up=tuple(float(v) for v in up),
        right=tuple(float(v) for v in right),
        fov=fov,
        width=width,
        height=height,
    )


def look_at_view(position, target, world_up, tan_fovy, aspect) -> CameraView:
    """Traced look-at CameraView: all args may be jax arrays (camera-pose
    gradients / vmapped view batches work through this path)."""
    position = jnp.asarray(position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    world_up = jnp.asarray(world_up, jnp.float32)
    front = target - position
    front = front / jnp.linalg.norm(front)
    right = jnp.cross(front, world_up)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, front)
    up = up / jnp.linalg.norm(up)
    top = jnp.stack([right, up, front], axis=0)
    trans = -jnp.sum(top * position[None, :], axis=1)
    view = jnp.concatenate([top, trans[:, None]], axis=1)
    view = jnp.concatenate(
        [view, jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0
    )
    tan_fovy = jnp.asarray(tan_fovy, jnp.float32)
    return CameraView(
        view=view,
        position=position,
        tan_fovx=tan_fovy * aspect,
        tan_fovy=tan_fovy,
    )


def view_matrix(cam: Camera):
    """4x4 world->view matrix; view-space z is the viewing (front) axis."""
    r = jnp.asarray(cam.right, jnp.float32)
    u = jnp.asarray(cam.up, jnp.float32)
    f = jnp.asarray(cam.front, jnp.float32)
    p = jnp.asarray(cam.position, jnp.float32)
    top = jnp.stack([r, u, f], axis=0)  # (3, 3)
    trans = -jnp.sum(top * p[None, :], axis=1)  # (3,), full f32
    m = jnp.concatenate([top, trans[:, None]], axis=1)  # (3, 4)
    bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], jnp.float32)
    return jnp.concatenate([m, bottom], axis=0)


def projection_matrix(
    tan_fovx: float, tan_fovy: float, znear: float = 0.1, zfar: float = 100.0
):
    """4x4 view->clip matrix: x/w = x/(tanfovx*z), z in [znear,zfar]->[0,1]."""
    a = zfar / (zfar - znear)
    b = -zfar * znear / (zfar - znear)
    return jnp.array(
        [
            [1.0 / tan_fovx, 0.0, 0.0, 0.0],
            [0.0, 1.0 / tan_fovy, 0.0, 0.0],
            [0.0, 0.0, a, b],
            [0.0, 0.0, 1.0, 0.0],
        ],
        jnp.float32,
    )


def camera_matrices(cam: Camera, znear: float = 0.1, zfar: float = 100.0):
    """(view 4x4, proj 4x4) for a camera (reference gs_projector/impl.cpp:34-42)."""
    return view_matrix(cam), projection_matrix(
        cam.tan_fovx, cam.tan_fovy, znear, zfar
    )
