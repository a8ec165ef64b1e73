"""pack_mode="none": raw sorted ranges read with masked loads must
reproduce the packed pipeline exactly — forward AND backward, including
saturated tiles (early exit + zero-fill) — and the backward's masked
stores must touch only the lanes of the tile that owns them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.ops.render import render
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

CAM = look_at_camera(
    (3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1), fov=70.0, width=96, height=64
)


def _scenes():
    yield "sparse", random_scene(400, seed=13, extent=2.0, scale_range=(0.02, 0.08))
    # dense + opaque: saturating tiles exercise the early-exit/zero-fill
    dense = random_scene(500, seed=14, extent=0.4, scale_range=(0.15, 0.3))
    yield "dense", dense._replace(
        opacities=np.full((500,), 0.85, np.float32)
    )


@pytest.mark.parametrize("name,scene", list(_scenes()))
def test_forward_matches_packed(name, scene):
    packed = RenderConfig(max_pairs=60_000, pack_mode="chunk")
    nopack = RenderConfig(max_pairs=60_000, pack_mode="none")
    a = jax.jit(lambda *x: render(*x, CAM, cfg=packed))(*scene.render_args())
    b = jax.jit(lambda *x: render(*x, CAM, cfg=nopack))(*scene.render_args())
    # the two modes group the log-transmittance prefix into different
    # chunks; at saturating pixels a last-ulp difference can flip an
    # entry across the T < 1e-4 stop, so dense scenes get a small band
    atol = 1e-6 if name == "sparse" else 5e-4
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


@pytest.mark.parametrize("name,scene", list(_scenes()))
def test_backward_matches_packed(name, scene):
    wimg = jnp.asarray(
        np.random.default_rng(1).normal(size=(3, CAM.height, CAM.width)),
        jnp.float32,
    )

    def loss(cfg):
        return lambda *a: jnp.sum(render(*a, CAM, cfg=cfg) * wimg)

    gp = jax.jit(jax.grad(
        loss(RenderConfig(max_pairs=60_000, pack_mode="chunk")),
        argnums=(0, 1, 2, 3, 4),
    ))(*scene.render_args())
    gn = jax.jit(jax.grad(
        loss(RenderConfig(max_pairs=60_000, pack_mode="none")),
        argnums=(0, 1, 2, 3, 4),
    ))(*scene.render_args())
    # step boundaries differ between the modes, so the backward pixel
    # sums regroup differently; ~2e-4 relative is fp noise
    atol = 3e-5 if name == "sparse" else 2e-3
    for a, b in zip(gp, gn):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=atol)


@pytest.mark.parametrize("tile,lead", [(16, 0), (16, 5), (16, 37), (32, 3)])
def test_masked_store_backward_misaligned_starts(tile, lead):
    """Two tiles whose raw ranges start at unaligned offsets, preceded by
    ``lead`` entries no tile owns (they hold live-looking payload the
    kernels must neither read nor overwrite). Owned lanes must carry the
    reference autodiff gradient; unowned lanes must stay exactly as the
    output buffer was initialised (NaN under the interpreter)."""
    from luisacomputegaussiansplatting_jax.ops.binning import BinnedGaussians
    from luisacomputegaussiansplatting_jax.ops.rasterize_pallas import (
        FIELDS, rasterize_backward, rasterize_forward, rasterize_tiles,
    )
    from luisacomputegaussiansplatting_jax.ops.rasterize_ref import (
        rasterize_reference,
    )

    cfg = RenderConfig(max_pairs=512, tile=tile, pack_mode="none")
    w, h = 2 * tile, tile
    counts = np.array([23, 41], np.int32)
    starts = np.array([lead, lead + counts[0]], np.int32)
    cap = int(starts[1] + counts[1] + 11)  # unowned tail as well
    owner = np.full(cap, -1, np.int32)
    for t in range(2):
        owner[starts[t]:starts[t] + counts[t]] = t

    rng = np.random.default_rng(tile + lead)
    tx = np.where(owner == 1, tile, 0)
    payload = np.stack([
        tx + rng.uniform(0, tile, cap),  # mean x inside the owner tile
        rng.uniform(0, tile, cap),
        rng.uniform(0.02, 0.2, cap),  # conic a
        rng.uniform(-0.01, 0.01, cap),
        rng.uniform(0.02, 0.2, cap),  # conic c
        rng.uniform(0.05, 0.6, cap),  # opacity: unowned lanes look live
        rng.uniform(0, 1, cap),
        rng.uniform(0, 1, cap),
        rng.uniform(0, 1, cap),
    ]).astype(np.float32)
    assert payload.shape == (FIELDS, cap)
    owned = owner >= 0
    s_, c_ = jnp.asarray(starts), jnp.asarray(counts)
    binned = BinnedGaussians(
        entry_gid=jnp.asarray(np.where(owned, np.arange(cap), -1)),
        entry_tile=jnp.asarray(np.maximum(owner, 0)),
        tile_starts=s_, tile_counts=c_,
        num_rendered=jnp.int32(int(owned.sum())),
        overflow=jnp.asarray(False),
    )
    wimg = jnp.asarray(rng.normal(size=(2, tile * tile, 3)), jnp.float32)

    def loss_kernel(p):
        c, t = rasterize_tiles(p, s_, c_, 2, w, h, cfg)
        return jnp.sum(c * wimg) + jnp.sum(t)

    def loss_ref(p):
        # the reference has no ranges: it sees the owned lanes only
        p = jnp.where(jnp.asarray(owned)[None, :], p, 0.0)
        c, t = rasterize_reference(p, binned, 2, w, h, cfg)
        return jnp.sum(c * wimg) + jnp.sum(t)

    p = jnp.asarray(payload)
    np.testing.assert_allclose(float(loss_kernel(p)), float(loss_ref(p)),
                               rtol=1e-5)
    g_k = np.asarray(jax.grad(loss_kernel)(p))
    g_r = np.asarray(jax.grad(loss_ref)(p))
    scale = np.abs(g_r).max()
    np.testing.assert_allclose(g_k[:, owned] / scale, g_r[:, owned] / scale,
                               atol=1e-5)

    # the raw kernel output: unowned lanes are never written
    out = rasterize_forward(p, s_, c_, 2, w, h, cfg)
    res = jnp.concatenate([jnp.swapaxes(out, 1, 2)] * 2, axis=2)
    raw = np.asarray(rasterize_backward(
        p, s_, c_, jnp.swapaxes(res, 1, 2), 2, w, h, cfg))
    assert np.isfinite(raw[:, owned]).all()
    assert np.isnan(raw[:, ~owned]).all()
