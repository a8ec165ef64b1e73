"""Camera math tests (superset of reference test/test_camera.cpp)."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.utils.camera import (
    Camera,
    camera_matrices,
    look_at_camera,
    projection_matrix,
    view_matrix,
)


@pytest.fixture
def cam():
    return look_at_camera(
        position=(-3.0, -0.5, 3.3),
        target=(0.0, 3.0, 0.5),
        world_up=(0.0, -1.0, -1.0),
        fov=60.0,
        width=160,
        height=112,
    )


def test_lookat_orthonormal(cam):
    axes = np.stack([cam.right, cam.up, cam.front])
    gram = axes @ axes.T
    np.testing.assert_allclose(gram, np.eye(3), atol=1e-6)
    # reference convention (camera.h:74-82): up x right == front,
    # i.e. a left-handed (right, up, front) frame
    np.testing.assert_allclose(
        np.cross(cam.up, cam.right), cam.front, atol=1e-6
    )


def test_lookat_points_at_target(cam):
    to_target = np.array([0.0, 3.0, 0.5]) - np.array(cam.position)
    to_target /= np.linalg.norm(to_target)
    np.testing.assert_allclose(cam.front, to_target, atol=1e-6)


def test_view_matrix_roundtrip(cam):
    v = np.asarray(view_matrix(cam))
    p_world = np.array([0.7, -1.2, 2.5, 1.0])
    p_view = v @ p_world
    # invert: p_world = R^T (p_view - t)
    r = v[:3, :3]
    t = v[:3, 3]
    back = r.T @ (p_view[:3] - t)
    np.testing.assert_allclose(back, p_world[:3], atol=1e-5)


def test_view_matrix_camera_at_origin(cam):
    v = np.asarray(view_matrix(cam))
    p = np.append(np.asarray(cam.position), 1.0)
    np.testing.assert_allclose(v @ p, [0, 0, 0, 1], atol=1e-5)


def test_projection_near_far():
    znear, zfar = 0.1, 100.0
    p = np.asarray(projection_matrix(0.6, 0.5, znear, zfar))
    for z, expect in [(znear, 0.0), (zfar, 1.0)]:
        clip = p @ np.array([0.0, 0.0, z, 1.0])
        ndc_z = clip[2] / clip[3]
        np.testing.assert_allclose(ndc_z, expect, atol=1e-5)


def test_projection_ndc_scaling():
    tanx, tany = 0.8, 0.4
    p = np.asarray(projection_matrix(tanx, tany))
    z = 2.0
    # a point on the frustum edge maps to |ndc| = 1
    clip = p @ np.array([tanx * z, tany * z, z, 1.0])
    np.testing.assert_allclose(clip[:2] / clip[3], [1.0, 1.0], atol=1e-5)


def test_camera_matrices_consistent(cam):
    v, p = camera_matrices(cam)
    assert v.shape == (4, 4) and p.shape == (4, 4)
    # full transform of a point straight ahead lands at ndc xy ~ 0
    ahead = np.asarray(cam.position) + 3.0 * np.asarray(cam.front)
    clip = np.asarray(p) @ np.asarray(v) @ np.append(ahead, 1.0)
    np.testing.assert_allclose(clip[:2] / clip[3], [0.0, 0.0], atol=1e-5)


def test_focal_and_fov():
    cam = Camera(
        position=(0, 0, 0),
        front=(0, 0, 1),
        up=(0, 1, 0),
        right=(1, 0, 0),
        fov=90.0,
        width=200,
        height=100,
    )
    np.testing.assert_allclose(cam.tan_fovy, 1.0, atol=1e-6)
    np.testing.assert_allclose(cam.tan_fovx, 2.0, atol=1e-6)
    np.testing.assert_allclose(cam.focal_x, 50.0, atol=1e-4)
    np.testing.assert_allclose(cam.focal_y, 50.0, atol=1e-4)


def test_rodrigues_axis_angle():
    """rotate_axis_angle / rotation_from_axis_angle (reference
    transform.hpp:100-160) agree with the quaternion path and each other."""
    from luisacomputegaussiansplatting_jax.utils.transform import (
        quaternion_from_axis_angle,
        rotate_axis_angle,
        rotation_from_axis_angle,
        rotation_from_quaternion,
    )

    rng = np.random.default_rng(5)
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    angle = rng.uniform(-3.0, 3.0, size=(8,))
    aa = axis * angle[:, None]
    p = rng.normal(size=(8, 3)).astype(np.float32)

    r_aa = np.asarray(rotation_from_axis_angle(aa))
    q = np.asarray(quaternion_from_axis_angle(axis, angle))
    r_q = np.asarray(rotation_from_quaternion(q))
    np.testing.assert_allclose(r_aa, r_q, atol=1e-5)

    rotated = np.asarray(rotate_axis_angle(aa, p))
    np.testing.assert_allclose(
        rotated, np.einsum("nij,nj->ni", r_aa, p), atol=1e-5
    )
    # rotations preserve norms; zero axis-angle is the identity
    np.testing.assert_allclose(
        np.linalg.norm(rotated, axis=-1), np.linalg.norm(p, axis=-1), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(rotate_axis_angle(np.zeros((3,)), p)), p, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(rotation_from_axis_angle(np.zeros((3,)))), np.eye(3), atol=1e-6
    )
