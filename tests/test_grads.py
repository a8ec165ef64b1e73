"""Backward-pass validation.

Two independent checks of the hand-derived Pallas backward kernel:
  1. against plain JAX autodiff through the jnp reference rasterizer
     (same forward formulation, machine-generated VJP), and
  2. against central finite differences of the full render.

The reference has no backward at all (README.md:70); the graphdeco CUDA
gradients BASELINE.json names as oracle are unavailable offline, so
finite differences + independent autodiff stand in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.ops.render import render
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

CAM = look_at_camera((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1),
                     fov=70.0, width=48, height=32)
CFG_PALLAS = RenderConfig(max_pairs=10_000)
CFG_JNP = RenderConfig(max_pairs=10_000, rasterizer="jnp")
N = 40


def scene_arrays():
    scene = random_scene(N, seed=13)
    return tuple(np.asarray(a) for a in scene.render_args())


def loss_fn(cfg):
    rng = np.random.default_rng(0)
    wimg = jnp.asarray(rng.normal(size=(3, CAM.height, CAM.width)), jnp.float32)

    def loss(means, scales, quats, opac, sh, bg):
        img = render(means, scales, quats, opac, sh, CAM, bg_color=bg, cfg=cfg)
        return jnp.sum(img * wimg)

    return loss


@pytest.fixture(scope="module")
def grads():
    args = scene_arrays()
    bg = jnp.array([0.25, 0.5, 0.75], jnp.float32)
    g_pallas = jax.grad(loss_fn(CFG_PALLAS), argnums=(0, 1, 2, 3, 4, 5))(*args, bg)
    g_jnp = jax.grad(loss_fn(CFG_JNP), argnums=(0, 1, 2, 3, 4, 5))(*args, bg)
    return args, bg, g_pallas, g_jnp


def test_pallas_backward_matches_autodiff(grads):
    _, _, g_pallas, g_jnp = grads
    names = ["means", "scales", "quats", "opacities", "sh", "bg"]
    for name, a, b in zip(names, g_pallas, g_jnp):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(
            a / scale, b / scale, atol=2e-4, err_msg=name
        )


def test_grads_nonzero(grads):
    _, _, g_pallas, _ = grads
    # every parameter group must actually receive gradient signal
    for name, g in zip(["means", "scales", "quats", "opac", "sh", "bg"], g_pallas):
        assert np.abs(np.asarray(g)).max() > 1e-6, name


@pytest.mark.parametrize("argnum", [0, 1, 2, 3, 4])
def test_finite_differences(grads, argnum):
    args, bg, g_pallas, _ = grads
    rng = np.random.default_rng(0)
    wimg = rng.normal(size=(3, CAM.height, CAM.width))

    render_j = jax.jit(
        lambda *a: render(*a, CAM, bg_color=bg, cfg=CFG_PALLAS)
    )

    g = np.asarray(g_pallas[argnum])
    flat = g.reshape(-1)
    # probe the largest-|grad| coordinates (best signal-to-noise in f32)
    picks = np.argsort(-np.abs(flat))[:4]
    for idx in picks:
        an = float(flat[idx])
        fds = []
        # eps cascade: the render is only piecewise smooth (integer radius
        # / tile rects), so a given eps may straddle a binning jump; accept
        # if the FD matches at any scale of the cascade.
        for eps in (5e-4, 1e-4, 2e-5):
            pert = np.zeros_like(flat)
            pert[idx] = eps
            pert = pert.reshape(g.shape)
            hi = list(args)
            lo = list(args)
            hi[argnum] = args[argnum] + pert
            lo[argnum] = args[argnum] - pert
            # f64 contraction of the f32 image difference: avoids the f32
            # loss-summation noise swamping the eps-sized signal
            dimg = np.asarray(render_j(*hi), np.float64) - np.asarray(
                render_j(*lo), np.float64
            )
            fd = float((dimg * wimg).sum() / (2 * eps))
            fds.append(fd)
            if abs(fd - an) <= 0.05 * max(abs(an), abs(fd), 1e-3):
                break
        else:
            raise AssertionError(
                f"argnum {argnum} idx {idx}: fd cascade {fds} vs analytic {an}"
            )


def test_bg_gradient_exact(grads):
    args, bg, g_pallas, _ = grads
    # dL/dbg = sum over pixels of w_img * T  — check against aux T
    from luisacomputegaussiansplatting_jax.ops.render import render_aux

    rng = np.random.default_rng(0)
    wimg = np.asarray(
        rng.normal(size=(3, CAM.height, CAM.width)), np.float32
    )
    _, aux = render_aux(*args, CAM, bg_color=bg, cfg=CFG_PALLAS)
    t = np.asarray(aux.transmittance)
    want = (wimg * t[None]).sum(axis=(1, 2))
    np.testing.assert_allclose(np.asarray(g_pallas[5]), want, rtol=2e-4)


def test_backward_early_exit_on_saturated_tile():
    """Gradients on a saturating scene: the bwd kernel's early-exit path
    must write exact zeros for post-saturation chunks, matching the
    jnp-reference autodiff."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
    from luisacomputegaussiansplatting_jax.ops.render import render
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), (0, 1, 0),
                         fov=60.0, width=32, height=32)
    # opaque wall: transmittance crosses 1e-4 well before the ranges end
    scene = random_scene(600, seed=1, extent=0.5, scale_range=(0.2, 0.4))
    scene = scene._replace(
        opacities=np.full((600,), 0.85, np.float32).astype(np.float32)
    )
    wimg = jnp.asarray(
        np.random.default_rng(2).normal(size=(3, 32, 32)), jnp.float32
    )

    def loss(cfg):
        return lambda *a: jnp.sum(render(*a, cam, cfg=cfg) * wimg)

    g_pallas = jax.jit(
        jax.grad(loss(RenderConfig(max_pairs=16_000)), argnums=(0, 3))
    )(*scene.render_args())
    g_ref = jax.jit(
        jax.grad(
            loss(RenderConfig(max_pairs=16_000, rasterizer="jnp")),
            argnums=(0, 3),
        )
    )(*scene.render_args())
    for a, b in zip(g_pallas, g_ref):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3)
