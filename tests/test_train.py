"""Single-chip training: losses behave and a tiny scene actually fits."""

import jax
import jax.numpy as jnp
import numpy as np

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.models.losses import (
    d_ssim_l1_loss,
    l1_loss,
    psnr,
    ssim,
)
from luisacomputegaussiansplatting_jax.models.trainer import (
    TrainConfig,
    init_train_state,
    make_train_step,
)
from luisacomputegaussiansplatting_jax.ops.render import render
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera


def test_ssim_identity():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(size=(3, 40, 56)), jnp.float32)
    assert float(ssim(img, img)) > 0.9999
    noisy = img + 0.2 * jnp.asarray(rng.normal(size=img.shape), jnp.float32)
    assert float(ssim(img, jnp.clip(noisy, 0, 1))) < 0.9


def test_loss_composition():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.uniform(size=(3, 32, 32)), jnp.float32)
    b = jnp.asarray(rng.uniform(size=(3, 32, 32)), jnp.float32)
    full = float(d_ssim_l1_loss(a, b, 0.2))
    manual = 0.8 * float(l1_loss(a, b)) + 0.2 * (1 - float(ssim(a, b)))
    np.testing.assert_allclose(full, manual, rtol=1e-6)
    assert float(d_ssim_l1_loss(a, a)) < 1e-6


def test_psnr():
    a = jnp.zeros((3, 8, 8))
    b = jnp.full((3, 8, 8), 0.1)
    np.testing.assert_allclose(float(psnr(a, b)), 20.0, atol=1e-3)


def test_fit_tiny_scene():
    """Perturbed scene refits its own render: loss down, PSNR up."""
    cam = look_at_camera((2.5, -2.2, 1.8), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=48, height=32)
    cfg = RenderConfig(max_pairs=8192)
    scene = random_scene(32, seed=5)
    target = render(*scene.render_args(), cam, cfg=cfg)

    params = scene.to_params()
    rng = np.random.default_rng(7)
    params = params._replace(
        means=params.means
        + jnp.asarray(rng.normal(0, 0.05, params.means.shape), jnp.float32),
        opacity_logits=params.opacity_logits - 1.0,
    )
    # boosted lrs for a fast small-scene test
    tc = TrainConfig(lr_means=2e-3, lr_opacity=0.1)
    state, opt = init_train_state(params, tc)
    step = make_train_step(opt, cam.width, cam.height, cfg=cfg, tc=tc)

    cam_view = cam.to_view()
    losses = []
    for _ in range(30):
        state, loss, _aux = step(state, cam_view, target)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses[:3] + losses[-3:]

    img_final = render(*state.params.activate().render_args(), cam, cfg=cfg)
    img_start = render(*params.activate().render_args(), cam, cfg=cfg)
    assert float(psnr(img_final, target)) > float(psnr(img_start, target)) + 3


def test_batched_train_step_fits():
    """Multi-view batched step: loss over 3 views drops; densify stats
    accumulate across the batch."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.dataset import synthetic_multiview
    from luisacomputegaussiansplatting_jax.io.synthetic import create_cube_scene
    from luisacomputegaussiansplatting_jax.models.densify import (
        init_densify_state,
    )
    from luisacomputegaussiansplatting_jax.models.gaussians import (
        pad_params_to,
    )
    from luisacomputegaussiansplatting_jax.models.trainer import (
        init_train_state,
        make_batched_train_step,
    )

    w = h = 48
    cfg = RenderConfig(max_pairs=20_000)
    gt = create_cube_scene(nx=3, scale=0.12, opacity=0.9)
    data = synthetic_multiview(gt, n_views=3, width=w, height=h, cfg=cfg)
    views = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[c.to_view() for c in data.cameras]
    )
    targets = jnp.stack([jnp.asarray(t) for t in data.targets])

    n0, cap = 27, 64
    params = pad_params_to(gt.to_params(), cap)
    # perturb away from the optimum
    rng = np.random.default_rng(0)
    params = params._replace(
        means=params.means + jnp.asarray(
            rng.normal(0, 0.05, params.means.shape), jnp.float32
        )
    )
    state, opt = init_train_state(params)
    dstate = init_densify_state(n0, cap)
    step = make_batched_train_step(opt, w, h, cfg=cfg)

    losses = []
    for _ in range(25):
        state, dstate, loss, overflow = step(state, dstate, views, targets)
        losses.append(float(loss))
    assert not bool(overflow)
    assert losses[-1] < losses[0] * 0.8, losses[::8]
    assert int(jnp.sum((dstate.count > 0))) > 0
    assert float(dstate.count.max()) >= 3.0  # visible in all 3 views


def test_overflowing_step_is_detected():
    """A step whose expansion exceeds max_pairs must SURFACE the overflow
    (the reference silently corrupts past its L cap, app/main.cpp:245;
    this framework's overflow story must hold in training too)."""
    import jax

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.synthetic import create_cube_scene
    from luisacomputegaussiansplatting_jax.models.densify import (
        init_densify_state,
    )
    from luisacomputegaussiansplatting_jax.models.trainer import (
        init_train_state,
        make_batched_train_step,
        make_densify_train_step,
    )
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    w = h = 48
    cfg = RenderConfig(max_pairs=16)  # far too small on purpose (27
    # gaussians emit >= 27 entries, so expansion must overflow)
    gt = create_cube_scene(nx=3, scale=0.12, opacity=0.9)
    params = gt.to_params()
    n = params.means.shape[0]
    state, opt = init_train_state(params)
    dstate = init_densify_state(n, n)
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=w, height=h)
    target = jnp.zeros((3, h, w), jnp.float32)

    step1 = make_densify_train_step(opt, w, h, cfg=cfg)
    _, _, _, aux = step1(state, dstate, cam.to_view(), target)
    assert bool(aux.overflow)

    stepb = make_batched_train_step(opt, w, h, cfg=cfg)
    views = jax.tree.map(lambda *x: jnp.stack(x), cam.to_view())
    _, _, _, overflow = stepb(state, dstate, views, target[None])
    assert bool(overflow)
