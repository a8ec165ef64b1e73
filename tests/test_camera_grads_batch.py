"""Differentiable camera poses + vmapped multi-view batching.

Both are capabilities with no reference counterpart: the
CameraView is a traced pytree, so camera parameters take gradients (pose
refinement / SLAM-style use) and whole view batches render under one
vmap'd jit.
"""

import jax
import jax.numpy as jnp
import numpy as np

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.ops.render import render, render_view
from luisacomputegaussiansplatting_jax.utils.camera import (
    CameraView,
    look_at_camera,
)

CFG = RenderConfig(max_pairs=30_000)
W = H = 64


def _view(px=3.0):
    return look_at_camera(
        (px, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=W, height=H
    ).to_view()


def test_camera_position_gradient():
    scene = random_scene(200, seed=11, extent=1.0, scale_range=(0.05, 0.15))
    target = render(
        *scene.render_args(),
        look_at_camera((2.8, -2.4, 1.9), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=W, height=H),
        cfg=CFG,
    )

    def loss(view: CameraView):
        img, _ = render_view(*scene.render_args(), view, W, H, cfg=CFG)
        return jnp.mean((img - target) ** 2)

    g = jax.jit(jax.grad(loss))(_view())
    # gradients reach every camera leaf and are finite + informative
    assert np.isfinite(np.asarray(g.view)).all()
    assert np.isfinite(np.asarray(g.position)).all()
    assert float(jnp.abs(g.view).max()) > 0.0

    # one gradient step on the view matrix reduces the loss
    v0 = _view()
    l0 = float(loss(v0))
    lr = 1e-2 / (float(jnp.abs(g.view).max()) + 1e-12)
    v1 = CameraView(
        view=v0.view - lr * g.view,
        position=v0.position,
        tan_fovx=v0.tan_fovx,
        tan_fovy=v0.tan_fovy,
    )
    l1 = float(loss(v1))
    assert l1 < l0, (l0, l1)


def test_vmapped_view_batch_matches_sequential():
    scene = random_scene(300, seed=12, extent=1.5, scale_range=(0.03, 0.1))
    cams = [
        look_at_camera((3.0 - 0.8 * i, -2.5 + 0.5 * i, 2.0), (0, 0, 0),
                       (0, 0, 1), fov=70.0, width=W, height=H)
        for i in range(3)
    ]
    views = jax.tree.map(lambda *xs: jnp.stack(xs), *[c.to_view() for c in cams])

    def one(view):
        img, _ = render_view(*scene.render_args(), view, W, H, cfg=CFG)
        return img

    batch = jax.jit(jax.vmap(one))(views)
    assert batch.shape == (3, 3, H, W)
    for i, cam in enumerate(cams):
        single = render(*scene.render_args(), cam, cfg=CFG)
        np.testing.assert_allclose(
            np.asarray(batch[i]), np.asarray(single), atol=2e-5
        )
