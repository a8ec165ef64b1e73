"""Projection / conic / tile-rect vs the numpy oracle."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.ops.projection import (
    project_gaussians,
    tile_grid,
)
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

from oracle import camera_mats, project_one, tile_rect


@pytest.fixture
def cam():
    return look_at_camera((4.0, -3.0, 2.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                          fov=65.0, width=96, height=64)


@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
def test_projection_matches_oracle(cam, ewa_mode):
    scene = random_scene(64, seed=3)
    cfg = RenderConfig()
    proj = project_gaussians(
        scene.means, scene.scales, scene.quats, cam, cfg, ewa_mode=ewa_mode
    )
    view, tanfovx, tanfovy = camera_mats(cam)
    means = np.asarray(scene.means, np.float64)
    scales = np.asarray(scene.scales, np.float64)
    quats = np.asarray(scene.quats, np.float64)

    n_checked = 0
    for i in range(means.shape[0]):
        want = project_one(means[i], scales[i], quats[i], view, tanfovx,
                           tanfovy, cam.width, cam.height, ewa_mode)
        if want is None:
            assert int(proj.radius[i]) == 0
            continue
        n_checked += 1
        np.testing.assert_allclose(
            np.asarray(proj.means2d[i]), want["pix"], rtol=2e-4, atol=2e-3
        )
        np.testing.assert_allclose(
            float(proj.depth[i]), want["depth"], rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(proj.conic[i]), want["conic"], rtol=3e-3, atol=1e-4
        )
        assert abs(int(proj.radius[i]) - want["radius"]) <= 1
    assert n_checked > 10  # scene must actually exercise the visible path


@pytest.mark.parametrize("ewa_mode", ["inria", "lcgs"])
def test_projection_nonfocal_matches_oracle(cam, ewa_mode):
    """use_focal=False: the NDC-unit kernel shad_project_gs
    (gs_projector/shader.cpp:18-80) + allocate_tiles' rescale-later
    branch (gs_tile_splatter/shader.cpp:132-138), vs a numpy port."""
    scene = random_scene(64, seed=3)
    cfg = RenderConfig(use_focal=False)
    proj = project_gaussians(
        scene.means, scene.scales, scene.quats, cam, cfg, ewa_mode=ewa_mode
    )
    view, tanfovx, tanfovy = camera_mats(cam)
    means = np.asarray(scene.means, np.float64)
    scales = np.asarray(scene.scales, np.float64)
    quats = np.asarray(scene.quats, np.float64)

    n_checked = n_differs = 0
    for i in range(means.shape[0]):
        want = project_one(means[i], scales[i], quats[i], view, tanfovx,
                           tanfovy, cam.width, cam.height, ewa_mode,
                           use_focal=False)
        if want is None:
            assert int(proj.radius[i]) == 0
            continue
        n_checked += 1
        np.testing.assert_allclose(
            np.asarray(proj.means2d[i]), want["pix"], rtol=2e-4, atol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(proj.conic[i]), want["conic"], rtol=3e-3, atol=1e-4
        )
        assert abs(int(proj.radius[i]) - want["radius"]) <= 1
        # the non-square cam (96x64) must exercise the reference's H*W/4
        # cov.z quirk: the non-focal conic differs from the focal one
        focal = project_one(means[i], scales[i], quats[i], view, tanfovx,
                            tanfovy, cam.width, cam.height, ewa_mode)
        if not np.allclose(want["conic"], focal["conic"], rtol=1e-3):
            n_differs += 1
    assert n_checked > 10
    assert n_differs > 5  # W != H: the two variants genuinely diverge


def test_tile_rect_and_counts(cam):
    scene = random_scene(64, seed=5)
    cfg = RenderConfig(rect_mode="inria")
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)
    view, tanfovx, tanfovy = camera_mats(cam)
    means = np.asarray(scene.means, np.float64)
    scales = np.asarray(scene.scales, np.float64)
    quats = np.asarray(scene.quats, np.float64)

    for i in range(means.shape[0]):
        want = project_one(means[i], scales[i], quats[i], view, tanfovx,
                           tanfovy, cam.width, cam.height)
        if want is None:
            assert int(proj.tiles_touched[i]) == 0
            continue
        if abs(int(proj.radius[i]) - want["radius"]) != 0:
            continue  # radius off-by-one near ceil boundaries: skip rect check
        (x0, y0), (x1, y1) = tile_rect(want["pix"], want["radius"], gx, gy)
        assert tuple(np.asarray(proj.rect_min[i])) == (x0, y0)
        assert tuple(np.asarray(proj.rect_max[i])) == (x1, y1)
        assert int(proj.tiles_touched[i]) == max(x1 - x0, 0) * max(y1 - y0, 0)


def test_near_cull():
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, 1, 0), width=64, height=64)
    means = np.array(
        [[0, 0, 0.1], [0, 0, 0.25], [0, 0, -2.0], [0, 0, 3.0]], np.float32
    )
    n = means.shape[0]
    scales = np.full((n, 3), 0.05, np.float32)
    quats = np.tile(np.array([0, 0, 0, 1.0], np.float32), (n, 1))
    proj = project_gaussians(means, scales, quats, cam, RenderConfig())
    assert int(proj.radius[0]) == 0  # z = 0.1 < 0.2 culled
    assert int(proj.radius[1]) > 0
    assert int(proj.radius[2]) == 0  # behind camera
    assert int(proj.radius[3]) > 0
