"""Configurable tile size: tile=32 renders must closely match tile=16.

Tile size changes which gaussians are *tested* per pixel (a 3-sigma rect
rounded to coarser tiles covers more pixels), so images are not
bit-identical — but any differences are tail contributions below the
1/255 alpha cutoff's neighbourhood. We require close agreement plus
exercise gradients at tile=32.
"""


import jax
import jax.numpy as jnp
import numpy as np

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.ops.render import render
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

CAM = look_at_camera(
    (3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=128, height=96
)


def test_tile32_matches_tile16():
    scene = random_scene(2000, seed=5, extent=2.0, scale_range=(0.02, 0.08))
    cfg16 = RenderConfig(max_pairs=60_000, tile=16)
    cfg32 = RenderConfig(max_pairs=60_000, tile=32)
    img16 = jax.jit(lambda *a: render(*a, CAM, cfg=cfg16))(*scene.render_args())
    img32 = jax.jit(lambda *a: render(*a, CAM, cfg=cfg32))(*scene.render_args())
    d = np.abs(np.asarray(img16) - np.asarray(img32))
    assert d.mean() < 2e-4, d.mean()
    assert d.max() < 0.05, d.max()  # accumulated sub-cutoff tail contributions


def test_rect_tile_32x16_matches_tile16():
    """Rectangular 32x16 tiles (fewer pixels
    blended per entry at modest extra entries) render within the same
    sub-cutoff tail tolerance, including with the ellipse cull +
    post-sort trim on."""
    scene = random_scene(2000, seed=5, extent=2.0, scale_range=(0.02, 0.08))
    cfg16 = RenderConfig(max_pairs=80_000, tile=16)
    cfgr = RenderConfig(max_pairs=80_000, tile=32, tile_h=16,
                        pack_mode="none", tile_cull=True,
                        max_pairs_sorted=60_000)
    img16 = jax.jit(lambda *a: render(*a, CAM, cfg=cfg16))(*scene.render_args())
    imgr = jax.jit(lambda *a: render(*a, CAM, cfg=cfgr))(*scene.render_args())
    d = np.abs(np.asarray(img16) - np.asarray(imgr))
    assert d.mean() < 2e-4, d.mean()
    assert d.max() < 0.05, d.max()


def test_rect_tile_gradients_close():
    scene = random_scene(300, seed=6, extent=1.5, scale_range=(0.05, 0.15))
    wimg = jnp.asarray(
        np.random.default_rng(0).normal(size=(3, CAM.height, CAM.width)),
        jnp.float32,
    )

    def loss(cfg):
        return lambda *a: jnp.sum(render(*a, CAM, cfg=cfg) * wimg)

    g16 = jax.grad(loss(RenderConfig(max_pairs=30_000, tile=16)), argnums=(0, 3))(
        *scene.render_args()
    )
    gr = jax.grad(
        loss(RenderConfig(max_pairs=30_000, tile=32, tile_h=16,
                          pack_mode="none", tile_cull=True)),
        argnums=(0, 3),
    )(*scene.render_args())
    for a, b in zip(g16, gr):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)


def test_tile32_gradients_finite_and_close():
    scene = random_scene(300, seed=6, extent=1.5, scale_range=(0.05, 0.15))
    wimg = jnp.asarray(
        np.random.default_rng(0).normal(size=(3, CAM.height, CAM.width)),
        jnp.float32,
    )

    def loss(cfg):
        return lambda *a: jnp.sum(render(*a, CAM, cfg=cfg) * wimg)

    g16 = jax.grad(loss(RenderConfig(max_pairs=30_000, tile=16)), argnums=(0, 3))(
        *scene.render_args()
    )
    g32 = jax.grad(loss(RenderConfig(max_pairs=30_000, tile=32)), argnums=(0, 3))(
        *scene.render_args()
    )
    for a, b in zip(g16, g32):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-3)
