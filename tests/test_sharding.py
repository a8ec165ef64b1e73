"""Multi-chip sharding on a virtual 8-device CPU mesh: the gaussian+tile
sharded render must reproduce the single-device render, and gradients
must flow back through the all-to-all exchange identically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.models.trainer import (
    init_train_state,
)
from luisacomputegaussiansplatting_jax.ops.render import render
from luisacomputegaussiansplatting_jax.parallel.mesh import make_mesh
from luisacomputegaussiansplatting_jax.parallel.render_sharded import (
    ShardedRenderConfig,
    render_sharded,
)
from luisacomputegaussiansplatting_jax.parallel.train_sharded import (
    make_sharded_train_step,
)
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

CAM = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                     fov=70.0, width=64, height=64)
CFG = RenderConfig(max_pairs=20_000)
SCFG = ShardedRenderConfig(max_pairs_local=8192, exchange_capacity=2048)


@pytest.fixture(scope="module")
def scene():
    return random_scene(96, seed=21)  # 96 divides by 8


def test_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("pack", ["chunk", "none"])
def test_sharded_render_matches_single(scene, tile, pack):
    """Every (tile, pack_mode) config the single-chip path supports must
    render identically sharded — including the fast tile=32 + no-pack
    production config."""
    cfg = RenderConfig(max_pairs=20_000, tile=tile, pack_mode=pack)
    mesh = make_mesh((8,), ("gs",))
    # bg is a traced argument: one compile covers both colour cases
    f_s = jax.jit(
        lambda bg, *a: render_sharded(
            *a, CAM, mesh, cfg=cfg, scfg=SCFG, bg_color=bg
        )
    )
    f_1 = jax.jit(
        lambda bg, *a: render(*a, CAM, bg_color=bg, cfg=cfg)
    )
    for bg in ((0.0, 0.0, 0.0), (0.2, 0.4, 0.6)):
        bg = jnp.asarray(bg, jnp.float32)
        img_s, aux = f_s(bg, *scene.render_args())
        assert not bool(aux.overflow)
        img_1 = f_1(bg, *scene.render_args())
        np.testing.assert_allclose(
            np.asarray(img_s), np.asarray(img_1), atol=2e-5
        )


def test_sharded_rejects_bad_exchange_capacity(scene):
    mesh = make_mesh((8,), ("gs",))
    bad = ShardedRenderConfig(max_pairs_local=8192, exchange_capacity=1000)
    with pytest.raises(ValueError, match="exchange_capacity"):
        render_sharded(*scene.render_args(), CAM, mesh, cfg=CFG, scfg=bad)


def test_sharded_nopack_grads_match_single(scene):
    """Gradients through the no-pack sharded rasterizer (boundary-chunk
    RMW path) match the single-chip no-pack gradients."""
    cfg = RenderConfig(max_pairs=20_000, tile=32, pack_mode="none")
    mesh = make_mesh((8,), ("gs",))
    rng = np.random.default_rng(1)
    wimg = jnp.asarray(
        rng.normal(size=(3, CAM.height, CAM.width)), jnp.float32
    )

    def loss_sharded(*args):
        img, _ = render_sharded(*args, CAM, mesh, cfg=cfg, scfg=SCFG)
        return jnp.sum(img * wimg)

    def loss_single(*args):
        return jnp.sum(render(*args, CAM, cfg=cfg) * wimg)

    g_s = jax.jit(jax.grad(loss_sharded, argnums=(0, 3)))(*scene.render_args())
    g_1 = jax.jit(jax.grad(loss_single, argnums=(0, 3)))(*scene.render_args())
    for name, a, b in zip("mo", g_s, g_1):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-4, err_msg=name)


def test_sharded_grads_match_single(scene):
    mesh = make_mesh((8,), ("gs",))
    rng = np.random.default_rng(0)
    wimg = jnp.asarray(
        rng.normal(size=(3, CAM.height, CAM.width)), jnp.float32
    )

    def loss_sharded(*args):
        img, _ = render_sharded(*args, CAM, mesh, cfg=CFG, scfg=SCFG)
        return jnp.sum(img * wimg)

    def loss_single(*args):
        return jnp.sum(render(*args, CAM, cfg=CFG) * wimg)

    g_s = jax.jit(jax.grad(loss_sharded, argnums=(0, 1, 2, 3, 4)))(
        *scene.render_args()
    )
    g_1 = jax.jit(jax.grad(loss_single, argnums=(0, 1, 2, 3, 4)))(
        *scene.render_args()
    )
    for name, a, b in zip("msqoh", g_s, g_1):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-4, err_msg=name)


@pytest.mark.parametrize("pack", ["chunk", "none"])
def test_sharded_bf16_exchange_matches_single_chip_bf16(scene, pack):
    """payload_dtype="bf16" sharded: the packed exchange rounds
    opacity/rgb exactly like the single-chip bf16 gather and delivers
    entries in the same merged order, so the images must match the
    single-chip bf16 render; gradients (through the composite custom
    VJP) must match the single-chip bf16 gradients."""
    cfg = RenderConfig(max_pairs=20_000, tile=16, pack_mode=pack,
                       payload_dtype="bf16")
    mesh = make_mesh((8,), ("gs",))

    img_s, aux = jax.jit(
        lambda *a: render_sharded(*a, CAM, mesh, cfg=cfg, scfg=SCFG)
    )(*scene.render_args())
    assert not bool(aux.overflow)
    img_1 = jax.jit(lambda *a: render(*a, CAM, cfg=cfg))(
        *scene.render_args()
    )
    np.testing.assert_allclose(
        np.asarray(img_s), np.asarray(img_1), atol=2e-5
    )

    rng = np.random.default_rng(3)
    wimg = jnp.asarray(
        rng.normal(size=(3, CAM.height, CAM.width)), jnp.float32
    )

    def loss_sharded(*args):
        img, _ = render_sharded(*args, CAM, mesh, cfg=cfg, scfg=SCFG)
        return jnp.sum(img * wimg)

    def loss_single(*args):
        return jnp.sum(render(*args, CAM, cfg=cfg) * wimg)

    g_s = jax.jit(jax.grad(loss_sharded, argnums=(0, 1, 2, 3, 4)))(
        *scene.render_args()
    )
    g_1 = jax.jit(jax.grad(loss_single, argnums=(0, 1, 2, 3, 4)))(
        *scene.render_args()
    )
    for name, a, b in zip("msqoh", g_s, g_1):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=3e-4,
                                   err_msg=name)


def _float_scatters(hlo: str):
    return [ln.strip() for ln in hlo.splitlines()
            if " scatter(" in ln and ("f32[" in ln or "bf16[" in ln)]


def _assert_scatters_are_segment_sums(hlo: str, what: str):
    """Every float scatter in the compiled program is the per-gaussian
    gradient segment-sum (ops.render.reduce_rows_by_id, named scope
    "grad_reduce"); every other gather in the exchange has a structured
    inverse (parallel/exchange_vjp.py) and must not lower to a scatter."""
    scatters = _float_scatters(hlo)
    assert scatters, f"{what}: no gradient segment-sum found"
    stray = [ln[:160] for ln in scatters if "grad_reduce" not in ln]
    assert not stray, f"{what}: {stray}"


def test_sharded_backward_has_no_scatter(scene):
    """The sharded backward moves gradients with sorts + row gathers, and
    its only float scatters are the per-gaussian gradient segment-sums:
    every exchange gather carries a custom VJP with a structured inverse
    (parallel/exchange_vjp.py)."""
    for pack, pdt in (
        ("chunk", "f32"),
        ("none", "f32"),
        ("chunk", "bf16"),  # the packed-exchange composite VJP
        ("none", "bf16"),
    ):
        cfg = RenderConfig(max_pairs=20_000, tile=32, pack_mode=pack,
                           payload_dtype=pdt)
        mesh = make_mesh((8,), ("gs",))

        def loss(*args):
            img, _ = render_sharded(*args, CAM, mesh, cfg=cfg, scfg=SCFG)
            return jnp.sum(img * img)

        hlo = (
            jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))
            .lower(*scene.render_args())
            .compile()
            .as_text()
        )
        _assert_scatters_are_segment_sums(hlo, f"pack={pack}/{pdt}")


def test_uneven_band_split(scene):
    """Height whose tile rows don't divide the device count."""
    cam = CAM.resized(64, 48)  # 3 tile rows over 8 devices
    mesh = make_mesh((8,), ("gs",))
    img_s, aux = jax.jit(
        lambda *a: render_sharded(*a, cam, mesh, cfg=CFG, scfg=SCFG)
    )(*scene.render_args())
    img_1 = jax.jit(lambda *a: render(*a, cam, cfg=CFG))(*scene.render_args())
    assert img_s.shape == (3, 48, 64)
    np.testing.assert_allclose(np.asarray(img_s), np.asarray(img_1), atol=2e-5)


def test_sharded_train_step_runs(scene):
    mesh = make_mesh((2, 4), ("data", "gs"))
    step_fn, opt, pad_targets = make_sharded_train_step(
        mesh, CAM.width, CAM.height, cfg=CFG, scfg=SCFG
    )
    params = scene.to_params()
    # start away from the optimum (targets are renders of `scene` itself)
    rng = np.random.default_rng(3)
    params = params._replace(
        means=params.means + jnp.asarray(
            rng.normal(0, 0.03, params.means.shape), jnp.float32
        ),
        opacity_logits=params.opacity_logits - 0.5,
    )
    state, _ = init_train_state(params)

    # 2 views (one per data shard)
    cams = [
        look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=64, height=64),
        look_at_camera((-2.5, 3.0, 1.5), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=64, height=64),
    ]
    views = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[c.to_view() for c in cams]
    )
    targets = jnp.stack(
        [render(*scene.render_args(), c, cfg=CFG) for c in cams]
    )
    targets = pad_targets(targets)

    state2, loss, overflow = step_fn(state, views, targets)
    assert np.isfinite(float(loss))
    assert not bool(overflow)
    # params actually moved
    delta = np.abs(
        np.asarray(state2.params.means) - np.asarray(state.params.means)
    ).max()
    assert delta > 0

    # loss decreases over a few steps on a fixed target
    losses = [float(loss)]
    for _ in range(6):
        state2, loss, _ov = step_fn(state2, views, targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_sharded_loss_equals_single_chip_dssim(scene):
    """The sharded loss is the full (1-w)L1 + w D-SSIM with exact 11x11
    windows across band seams (5-row ppermute halos) — it must equal the
    single-chip d_ssim_l1_loss to float precision."""
    from luisacomputegaussiansplatting_jax.models.losses import (
        d_ssim_l1_loss,
    )
    from luisacomputegaussiansplatting_jax.models.trainer import TrainConfig

    mesh = make_mesh((2, 4), ("data", "gs"))
    step_fn, opt, pad_targets = make_sharded_train_step(
        mesh, CAM.width, CAM.height, cfg=CFG, scfg=SCFG
    )
    params = scene.to_params()
    params = params._replace(opacity_logits=params.opacity_logits - 0.7)
    state, _ = init_train_state(params)

    cams = [
        look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=64, height=64),
        look_at_camera((-2.5, 3.0, 1.5), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=64, height=64),
    ]
    views = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[c.to_view() for c in cams]
    )
    targets_raw = jnp.stack(
        [render(*scene.render_args(), c, cfg=CFG) for c in cams]
    )
    _, loss, _ov = step_fn(state, views, pad_targets(targets_raw))

    # single-chip reference loss: mean over the two views
    act = jax.jit(lambda p: p.activate())(state.params)
    w = TrainConfig().ssim_weight
    ref = np.mean([
        float(d_ssim_l1_loss(
            render(*act, c, cfg=CFG), targets_raw[i], w,
        ))
        for i, c in enumerate(cams)
    ])
    np.testing.assert_allclose(float(loss), ref, rtol=2e-5)


def test_sharded_loss_halo_exactness_uneven_band(scene):
    """Height where the last band is partially outside the image: the
    SSIM halo/masking must still reproduce the single-chip loss."""
    from luisacomputegaussiansplatting_jax.models.losses import (
        d_ssim_l1_loss,
    )
    from luisacomputegaussiansplatting_jax.models.trainer import TrainConfig

    cam = CAM.resized(64, 48)  # 3 tile rows over 4 gs devices
    mesh = make_mesh((2, 4), ("data", "gs"))
    step_fn, opt, pad_targets = make_sharded_train_step(
        mesh, cam.width, cam.height, cfg=CFG, scfg=SCFG
    )
    state, _ = init_train_state(scene.to_params())
    cams = [cam, cam.resized(64, 48)]
    views = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[c.to_view() for c in cams]
    )
    rng = np.random.default_rng(5)
    targets_raw = jnp.asarray(
        rng.uniform(0, 1, (2, 3, 48, 64)), jnp.float32
    )
    _, loss, _ov = step_fn(state, views, pad_targets(targets_raw))

    act = jax.jit(lambda p: p.activate())(state.params)
    w = TrainConfig().ssim_weight
    ref = np.mean([
        float(d_ssim_l1_loss(render(*act, c, cfg=CFG), targets_raw[i], w))
        for i, c in enumerate(cams)
    ])
    np.testing.assert_allclose(float(loss), ref, rtol=2e-5)


def test_sharded_densify_step_accumulates_stats(scene):
    """densify=True: probe gradients / visibility / radii accumulate like
    the single-chip batched step, and the active mask culls."""
    from luisacomputegaussiansplatting_jax.models.densify import (
        init_densify_state,
    )

    mesh = make_mesh((2, 4), ("data", "gs"))
    step_fn, opt, pad_targets = make_sharded_train_step(
        mesh, CAM.width, CAM.height, cfg=CFG, scfg=SCFG, densify=True
    )
    params = scene.to_params()
    state, _ = init_train_state(params)
    n = params.means.shape[0]
    dstate = init_densify_state(n, n)
    # retire half the gaussians: they must collect no stats
    active = jnp.arange(n) % 2 == 0
    dstate = dstate._replace(active=active)

    cams = [
        look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=64, height=64),
        look_at_camera((-2.5, 3.0, 1.5), (0, 0, 0), (0, 0, 1),
                       fov=70.0, width=64, height=64),
    ]
    views = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[c.to_view() for c in cams]
    )
    rng = np.random.default_rng(7)
    targets = pad_targets(jnp.asarray(
        rng.uniform(0, 1, (2, 3, 64, 64)), jnp.float32
    ))

    state2, dstate2, loss, overflow = step_fn(state, dstate, views, targets)
    assert np.isfinite(float(loss))
    assert not bool(overflow)
    grad_sum = np.asarray(dstate2.grad_sum)
    count = np.asarray(dstate2.count)
    radii = np.asarray(dstate2.max_radii)
    act = np.asarray(active)
    assert (grad_sum[~act] == 0).all() and (count[~act] == 0).all()
    assert (radii[~act] == 0).all()
    assert grad_sum[act].max() > 0  # visible gaussians got screen grads
    assert count[act].max() >= 1
    assert radii[act].max() > 0


def test_exchange_capacity_overflow_flagged_and_recoverable():
    """An exchange bucket exceeding exchange_capacity must raise the
    sharded overflow flag (the signal train_cli's grow_capacity doubles
    both sharded capacities on), and doubling the capacity must clear it
    and restore the single-chip image."""
    mesh = make_mesh((8,), ("gs",))
    big = random_scene(1024, seed=5, scale_range=(0.4, 0.8))
    small = ShardedRenderConfig(max_pairs_local=8192, exchange_capacity=128)
    img, aux = jax.jit(
        lambda *a: render_sharded(*a, CAM, mesh, cfg=CFG, scfg=small)
    )(*big.render_args())
    assert bool(aux.overflow)

    grown = ShardedRenderConfig(
        max_pairs_local=8192, exchange_capacity=small.exchange_capacity * 16
    )
    img2, aux2 = jax.jit(
        lambda *a: render_sharded(*a, CAM, mesh, cfg=CFG, scfg=grown)
    )(*big.render_args())
    assert not bool(aux2.overflow)
    img1 = jax.jit(lambda *a: render(*a, CAM, cfg=CFG))(*big.render_args())
    np.testing.assert_allclose(np.asarray(img2), np.asarray(img1), atol=2e-5)


def test_sharded_train_step_has_no_scatter(scene):
    """The render-only scatter scan (above) misses the training step's
    extra gradient consumers (the means2d probe for densify stats, the
    halo-exchanged D-SSIM loss): in the FULL densify train step too,
    every float scatter is a per-gaussian gradient segment-sum."""
    from luisacomputegaussiansplatting_jax.models.densify import (
        init_densify_state,
    )

    cam = CAM.resized(64, 48)
    mesh = make_mesh((2, 4), ("data", "gs"))
    step_fn, opt, pad_targets = make_sharded_train_step(
        mesh, cam.width, cam.height, cfg=CFG, scfg=SCFG, densify=True
    )
    state, _ = init_train_state(scene.to_params())
    dstate = init_densify_state(
        scene.num_gaussians, scene.num_gaussians
    )
    views = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[cam.to_view(), cam.to_view()]
    )
    rng = np.random.default_rng(11)
    targets = pad_targets(jnp.asarray(
        rng.uniform(0, 1, (2, 3, 48, 64)), jnp.float32
    ))
    hlo = (
        jax.jit(step_fn)
        .lower(state, dstate, views, targets)
        .compile()
        .as_text()
    )
    _assert_scatters_are_segment_sums(hlo, "train step")


def test_exchange_capacity_auto_derivation(scene):
    """exchange_capacity=None derives a CHUNK-aligned skew-headroom
    default from max_pairs_local and renders identically to an explicit
    capacity."""
    from luisacomputegaussiansplatting_jax.config import CHUNK
    from luisacomputegaussiansplatting_jax.parallel.render_sharded import (
        derive_exchange_capacity,
    )

    # derivation: total buffer = skew * max_pairs_local rows, aligned
    for mpl, ndev, skew in ((8192, 8, 3.0), (1_000_000, 16, 3.0),
                            (100, 8, 1.0)):
        cap = derive_exchange_capacity(mpl, ndev, skew)
        assert cap % CHUNK == 0 and cap >= CHUNK
        assert cap >= -(-mpl // ndev) * skew - CHUNK

    mesh = make_mesh((8,), ("gs",))
    auto = ShardedRenderConfig(max_pairs_local=8192)
    assert auto.exchange_capacity is None
    img_a, aux = render_sharded(
        *scene.render_args(), CAM, mesh, cfg=CFG, scfg=auto
    )
    assert not bool(aux.overflow)
    img_e, _ = render_sharded(
        *scene.render_args(), CAM, mesh, cfg=CFG, scfg=SCFG
    )
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_e),
                               atol=2e-5)


def test_exchange_capacity_scales_with_mesh_size():
    """The auto-derived bucket capacity shrinks ~1/ndev while the TOTAL
    per-chip exchange buffer (ndev * capacity) stays flat at
    ~skew * max_pairs_local rows: scaling devices must not scale
    per-device all-to-all bytes."""
    from luisacomputegaussiansplatting_jax.config import CHUNK
    from luisacomputegaussiansplatting_jax.parallel.render_sharded import (
        derive_exchange_capacity,
    )

    mpl, skew = 1_000_000, 3.0
    caps = {n: derive_exchange_capacity(mpl, n, skew)
            for n in (1, 2, 4, 8, 16, 64, 256)}
    ndevs = sorted(caps)
    for a, b in zip(ndevs, ndevs[1:]):
        assert caps[a] > caps[b], "capacity must shrink with mesh size"
        # total per-chip buffer stays within one CHUNK-roundup per bucket
        # of the skew * mpl target — flat, never growing with ndev
        assert a * caps[a] >= mpl * skew - CHUNK
        assert b * caps[b] >= mpl * skew - CHUNK
        assert b * caps[b] <= mpl * skew + b * CHUNK
