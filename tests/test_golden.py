"""Golden-image regression tests.

The reference demonstrates cross-backend correctness with a README figure
only (doc/fig_lcgs_compare.png); here the equivalent is pinned: renders of
deterministic scenes are compared against committed golden PNGs, guarding
the full pipeline (SH -> projection -> binning -> Pallas rasterizer ->
compositing) against semantic drift. Tolerance is 1.5/255 per channel:
PNG quantization (1/255) plus reduction-order noise.
"""

import os

import jax
import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import (
    create_cube_scene,
    random_scene,
)
from luisacomputegaussiansplatting_jax.ops.render import render
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera
from luisacomputegaussiansplatting_jax.utils.image import read_png

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1.5 / 255.0


def _cam():
    return look_at_camera(
        (3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=160, height=120
    )


def test_cube_matches_golden():
    cfg = RenderConfig(max_pairs=100_000)
    scene = create_cube_scene(nx=6, scale=0.07, opacity=0.85)
    img = jax.jit(
        lambda *a: render(*a, _cam(), bg_color=(0.1, 0.2, 0.3), cfg=cfg)
    )(*scene.render_args())
    golden = read_png(os.path.join(GOLDEN, "cube_160x120.png"))
    diff = np.abs(np.asarray(img) - golden)
    assert diff.max() <= TOL, f"max diff {diff.max():.5f}"


def test_random_scene_matches_golden():
    cfg = RenderConfig(max_pairs=100_000)
    scene = random_scene(3000, seed=42, extent=2.0, scale_range=(0.02, 0.1))
    img = jax.jit(lambda *a: render(*a, _cam(), cfg=cfg))(*scene.render_args())
    golden = read_png(os.path.join(GOLDEN, "random3000_160x120.png"))
    diff = np.abs(np.asarray(img) - golden)
    assert diff.max() <= TOL, f"max diff {diff.max():.5f}"


def test_golden_not_degenerate():
    """The goldens themselves contain real content (not black frames)."""
    for name in ("cube_160x120.png", "random3000_160x120.png"):
        g = read_png(os.path.join(GOLDEN, name))
        assert g.std() > 0.05, name
