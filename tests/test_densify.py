"""Adaptive density control tests (models/densify.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from luisacomputegaussiansplatting_jax.models.densify import (
    DensifyConfig,
    accumulate_stats,
    densify_step,
    init_densify_state,
    reset_opacity,
)
from luisacomputegaussiansplatting_jax.models.gaussians import (
    GaussianParams,
    pad_params_to,
)
from luisacomputegaussiansplatting_jax.models.trainer import init_train_state


def make_params(n, capacity, scale=0.01, opacity_logit=2.0, seed=0):
    rng = np.random.default_rng(seed)
    p = GaussianParams(
        means=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        log_scales=jnp.full((n, 3), np.log(scale), jnp.float32),
        quats=jnp.zeros((n, 4), jnp.float32).at[:, 3].set(1.0),
        opacity_logits=jnp.full((n,), opacity_logit, jnp.float32),
        sh_dc=jnp.asarray(rng.normal(size=(n, 1, 3)), jnp.float32),
        sh_rest=jnp.zeros((n, 15, 3), jnp.float32),
    )
    return pad_params_to(p, capacity)


def test_clone_small_high_grad():
    n, cap = 4, 16
    params = make_params(n, cap, scale=0.001)  # small => clone
    state, _ = init_train_state(params)
    dstate = init_densify_state(n, cap)
    # gaussian 1 has high accumulated grad and was visible
    grads = jnp.zeros((cap, 2)).at[1, 0].set(1.0)
    radii = jnp.zeros((cap,), jnp.int32).at[:n].set(3)
    dstate = accumulate_stats(dstate, grads, radii)
    new_p, new_opt, new_d, info = densify_step(
        state.params, state.opt_state, dstate, jax.random.PRNGKey(0),
        scene_extent=1.0, cfg=DensifyConfig(grad_threshold=0.5),
    )
    assert not bool(info.overflow)
    assert (int(info.n_cloned), int(info.n_split), int(info.n_pruned)) == (1, 0, 0)
    assert int(new_d.num_active) == n + 1  # one clone appended
    # the clone copies gaussian 1's parameters exactly
    dest = int(jnp.argmax(new_d.active[n:])) + n
    np.testing.assert_allclose(new_p.means[dest], new_p.means[1])
    np.testing.assert_allclose(new_p.sh_dc[dest], new_p.sh_dc[1])


def test_split_large_high_grad_retires_parent():
    n, cap = 4, 16
    params = make_params(n, cap, scale=0.5)  # large => split
    state, _ = init_train_state(params)
    dstate = init_densify_state(n, cap)
    grads = jnp.zeros((cap, 2)).at[2, 1].set(1.0)
    radii = jnp.zeros((cap,), jnp.int32).at[:n].set(3)
    dstate = accumulate_stats(dstate, grads, radii)
    cfg = DensifyConfig(grad_threshold=0.5, split_children=2)
    new_p, _, new_d, info = densify_step(
        state.params, state.opt_state, dstate, jax.random.PRNGKey(1),
        scene_extent=1.0, cfg=cfg,
    )
    assert not bool(info.overflow)
    assert (int(info.n_cloned), int(info.n_split)) == (0, 1)
    # parent retired, 2 children born: net +1 (the freed parent slot is
    # recycled, so slot 2 may hold a child now)
    assert int(new_d.num_active) == n + 1
    # children have shrunken scales
    child_rows = np.where(np.asarray(new_d.active))[0]
    new_scales = np.exp(np.asarray(new_p.log_scales))
    for r in child_rows:
        if r >= n or r == 2:
            assert new_scales[r].max() <= 0.5 / cfg.split_shrink + 1e-5


def test_prune_transparent():
    n, cap = 6, 8
    params = make_params(n, cap)
    params = params._replace(
        opacity_logits=params.opacity_logits.at[3].set(-10.0)  # ~0 opacity
    )
    state, _ = init_train_state(params)
    dstate = init_densify_state(n, cap)
    new_p, _, new_d, _ = densify_step(
        state.params, state.opt_state, dstate, jax.random.PRNGKey(2),
        scene_extent=1.0, cfg=DensifyConfig(grad_threshold=1e9),
    )
    assert int(new_d.num_active) == n - 1
    assert not bool(new_d.active[3])
    # parked rows are transparent and tiny
    assert float(new_p.opacity_logits[3]) <= -14.0


def test_capacity_overflow_flag():
    n, cap = 4, 5  # room for only 1 child
    params = make_params(n, cap, scale=0.001)
    state, _ = init_train_state(params)
    dstate = init_densify_state(n, cap)
    grads = jnp.zeros((cap, 2)).at[:n, 0].set(1.0)  # all want to clone
    radii = jnp.zeros((cap,), jnp.int32).at[:n].set(3)
    dstate = accumulate_stats(dstate, grads, radii)
    new_p, _, new_d, info = densify_step(
        state.params, state.opt_state, dstate, jax.random.PRNGKey(3),
        scene_extent=1.0, cfg=DensifyConfig(grad_threshold=0.5),
    )
    assert bool(info.overflow)
    assert int(new_d.num_active) == cap  # filled, none lost


def test_adam_moments_zeroed_for_new_rows():
    import optax

    n, cap = 3, 8
    params = make_params(n, cap, scale=0.001)
    state, opt = init_train_state(params)
    # fake nonzero moments everywhere
    ones = jax.tree.map(jnp.ones_like, state.params)

    def fill(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(
                mu=jax.tree.map(jnp.ones_like, s.mu),
                nu=jax.tree.map(jnp.ones_like, s.nu),
            )
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(fill(x) for x in s)
        if hasattr(s, "_fields"):
            return type(s)(**{f: fill(getattr(s, f)) for f in s._fields})
        return s

    opt_state = fill(state.opt_state)
    dstate = init_densify_state(n, cap)
    grads = jnp.zeros((cap, 2)).at[0, 0].set(1.0)
    radii = jnp.zeros((cap,), jnp.int32).at[:n].set(3)
    dstate = accumulate_stats(dstate, grads, radii)
    _, new_opt, new_d, _ = densify_step(
        params, opt_state, dstate, jax.random.PRNGKey(4),
        scene_extent=1.0, cfg=DensifyConfig(grad_threshold=0.5),
    )

    mus = []

    def collect(s):
        if isinstance(s, optax.ScaleByAdamState):
            mus.append(s.mu)
            return
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            for x in s:
                collect(x)
        elif hasattr(s, "_fields"):
            for f in s._fields:
                collect(getattr(s, f))

    collect(new_opt)
    child = int(jnp.argmax(new_d.active[n:])) + n
    for mu in mus:
        for leaf in jax.tree.leaves(mu):
            assert float(jnp.abs(leaf[child]).max()) == 0.0  # new row reset
            assert float(jnp.abs(leaf[1]).max()) == 1.0  # survivor kept


def test_reset_opacity_clamps_active_only():
    n, cap = 3, 6
    params = make_params(n, cap, opacity_logit=3.0)
    dstate = init_densify_state(n, cap)
    out = reset_opacity(params, dstate, DensifyConfig(reset_opacity_to=0.01))
    sig = 1 / (1 + np.exp(-np.asarray(out.opacity_logits[:n])))
    assert (sig <= 0.0101).all()
    np.testing.assert_allclose(
        out.opacity_logits[n:], params.opacity_logits[n:]
    )


def test_reset_opacity_zeros_opacity_adam_moments():
    """With opt_state given, the opacity group's Adam moments reset to
    zero (graphdeco replace_tensor_to_optimizer) and other groups keep
    theirs — stale moments would push opacities straight back up."""
    n, cap = 3, 6
    params = make_params(n, cap, opacity_logit=3.0)
    state, opt = init_train_state(params)
    grads = jax.tree.map(jnp.ones_like, params)
    _, opt_state = opt.update(grads, state.opt_state, params)
    dstate = init_densify_state(n, cap)
    new_p, new_opt = reset_opacity(
        params, dstate, DensifyConfig(), opt_state=opt_state
    )
    assert float(jax.nn.sigmoid(new_p.opacity_logits[:n]).max()) <= 0.0101

    def moments(s, out):
        import optax

        if isinstance(s, optax.ScaleByAdamState):
            out.append(s.mu)
        elif isinstance(s, tuple) and not hasattr(s, "_fields"):
            for x in s:
                moments(x, out)
        elif hasattr(s, "_fields"):
            for f in s._fields:
                moments(getattr(s, f), out)
        elif isinstance(s, dict):
            for v in s.values():
                moments(v, out)
        return out

    checked_opacity = checked_other = 0
    for mu in moments(new_opt, []):
        op = getattr(mu, "opacity_logits", None)
        if hasattr(op, "dtype"):
            assert float(jnp.abs(op).max()) == 0.0
            checked_opacity += 1
        mn = getattr(mu, "means", None)
        if hasattr(mn, "dtype"):
            assert float(jnp.abs(mn).max()) > 0.0
            checked_other += 1
    assert checked_opacity >= 1 and checked_other >= 1


def test_train_step_with_densify_fits():
    """End-to-end: train vs a 2-gaussian target, densify midway, loss drops."""
    import jax

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.synthetic import create_cube_scene
    from luisacomputegaussiansplatting_jax.models.trainer import (
        TrainState,
        make_densify_train_step,
    )
    from luisacomputegaussiansplatting_jax.ops.render import render
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    w = h = 64
    cfg = RenderConfig(max_pairs=20_000)
    cam = look_at_camera((3, -2.5, 2), (0, 0, 0), (0, 0, 1), fov=70,
                         width=w, height=h)
    target_scene = create_cube_scene(nx=3, scale=0.12, opacity=0.9)
    target = render(*target_scene.render_args(), cam, cfg=cfg)

    n0, cap = 8, 64
    params = make_params(n0, cap, scale=0.15, opacity_logit=0.0, seed=3)
    state, opt = init_train_state(params)
    dstate = init_densify_state(n0, cap)
    step = make_densify_train_step(opt, w, h, cfg=cfg)

    losses = []
    key = jax.random.PRNGKey(0)
    for it in range(60):
        state, dstate, loss, aux = step(state, dstate, cam.to_view(), target)
        losses.append(float(loss))
        if it == 30:
            key, sub = jax.random.split(key)
            p, o, dstate, _ = densify_step(
                state.params, state.opt_state, dstate, sub,
                scene_extent=1.5,
                cfg=DensifyConfig(grad_threshold=1e-4),
            )
            state = TrainState(p, o, state.step)
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    assert np.isfinite(losses).all()


def test_ndc_grad_norm_scaling():
    """accumulate_stats scales pixel-space probe grads by W/2, H/2 to
    graphdeco's NDC units (diff-gaussian-rasterization backward.cu
    dL_dmean2D), so DensifyConfig.grad_threshold=2e-4 is exact parity
    and resolution-independent."""
    from luisacomputegaussiansplatting_jax.models.densify import ndc_grad_norm

    g = jnp.asarray([[3e-6, 4e-6], [1e-5, 0.0]], jnp.float32)
    # raw pixel units (no resolution given)
    np.testing.assert_allclose(
        np.asarray(ndc_grad_norm(g)), [5e-6, 1e-5], rtol=1e-6
    )
    # 800x600: gx * 400, gy * 300
    np.testing.assert_allclose(
        np.asarray(ndc_grad_norm(g, 800, 600)),
        [np.hypot(3e-6 * 400, 4e-6 * 300), 1e-5 * 400],
        rtol=1e-6,
    )
    # accumulate_stats folds the scaled norm in
    cap = 2
    d0 = init_densify_state(2, cap)
    radii = jnp.asarray([5, 0], jnp.int32)  # second gaussian invisible
    d1 = accumulate_stats(d0, g, radii, 800, 600)
    np.testing.assert_allclose(
        np.asarray(d1.grad_sum),
        [np.hypot(3e-6 * 400, 4e-6 * 300), 0.0],
        rtol=1e-6,
    )
