"""Rasterizer tests: Pallas kernel (interpret mode on CPU) vs jnp reference
vs numpy oracle."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import (
    create_cube_scene,
    random_scene,
)
from luisacomputegaussiansplatting_jax.ops.binning import bin_gaussians
from luisacomputegaussiansplatting_jax.ops.projection import (
    project_gaussians,
    tile_grid,
)
from luisacomputegaussiansplatting_jax.ops.rasterize_pallas import (
    rasterize_tiles,
)
from luisacomputegaussiansplatting_jax.ops.rasterize_ref import (
    rasterize_reference,
)
from luisacomputegaussiansplatting_jax.ops.render import (
    build_payload,
    render,
    render_aux,
)
from luisacomputegaussiansplatting_jax.ops.sh_eval import compute_colors
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

from oracle import oracle_render


def make_inputs(scene, cam, cfg):
    colors = compute_colors(scene.means, scene.sh, cam.position, 3)
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)
    binned = bin_gaussians(proj, gx, gy, cfg.max_pairs)
    payload = build_payload(proj, colors, scene.opacities, binned)
    return payload, binned, gx, gy


@pytest.fixture(scope="module")
def small_case():
    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=64, height=48)
    scene = random_scene(80, seed=7)
    cfg = RenderConfig(max_pairs=20_000)
    return scene, cam, cfg


def test_pallas_matches_jnp_reference(small_case):
    scene, cam, cfg = small_case
    payload, binned, gx, gy = make_inputs(scene, cam, cfg)
    color_p, trans_p = rasterize_tiles(
        payload, binned.tile_starts, binned.tile_counts,
        gx, cam.width, cam.height, cfg,
    )
    color_r, trans_r = rasterize_reference(
        payload, binned, gx, cam.width, cam.height, cfg
    )
    np.testing.assert_allclose(
        np.asarray(color_p), np.asarray(color_r), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(trans_p), np.asarray(trans_r), atol=2e-5
    )


@pytest.mark.parametrize("bg", [(0, 0, 0), (0.3, 0.6, 0.9)])
def test_render_matches_oracle(small_case, bg):
    scene, cam, cfg = small_case
    img, aux = render_aux(*scene.render_args(), cam, bg_color=bg, cfg=cfg)
    want_img, want_t = oracle_render(scene, cam, bg=bg)
    got = np.asarray(img)
    assert got.shape == (3, cam.height, cam.width)
    np.testing.assert_allclose(got, want_img, atol=5e-4)
    np.testing.assert_allclose(
        np.asarray(aux.transmittance), want_t, atol=5e-4
    )


def test_render_jnp_rasterizer_matches_oracle(small_case):
    scene, cam, _ = small_case
    cfg = RenderConfig(max_pairs=20_000, rasterizer="jnp")
    img = render(*scene.render_args(), cam, cfg=cfg)
    want_img, _ = oracle_render(scene, cam)
    np.testing.assert_allclose(np.asarray(img), want_img, atol=5e-4)


def test_cube_scene_renders_nonempty():
    cam = look_at_camera((3.0, 3.0, 3.0), (0, 0, 0), (0, 0, 1),
                         fov=60.0, width=64, height=64)
    scene = create_cube_scene(nx=6)
    cfg = RenderConfig(max_pairs=40_000)
    img, aux = render_aux(*scene.render_args(), cam, cfg=cfg)
    assert not bool(aux.overflow)
    assert int(aux.num_rendered) > 0
    got = np.asarray(img)
    assert got.max() > 0.05
    assert np.isfinite(got).all()
    want, _ = oracle_render(scene, cam)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_saturated_early_termination():
    """Opaque wall of gaussians: transmittance hits the 1e-4 stop."""
    cam = look_at_camera((0, 0, -3.0), (0, 0, 0), (0, 1, 0),
                         fov=60.0, width=32, height=32)
    # note 0.85, not 0.99: with uniform alpha the post-blend transmittance
    # steps hit exactly 1e-4 for alpha in {0.9, 0.99}, turning every pixel
    # into a knife-edge threshold decision; 0.85 crosses cleanly.
    scene = random_scene(600, seed=1, extent=0.5, scale_range=(0.2, 0.4))
    scene = scene._replace(opacities=np.full((600,), 0.85, np.float32))
    cfg = RenderConfig(max_pairs=16_000)
    import jax
    img, aux = jax.jit(
        lambda *a: render_aux(*a, cam, cfg=cfg)
    )(*scene.render_args())
    t = np.asarray(aux.transmittance)
    assert t.min() < 1e-3  # saturation reached
    # vs oracle: the T < 1e-4 stop decision is threshold-sensitive — at
    # alpha ~ 0.99 an f32-vs-f64 flip of one inclusion moves a pixel by up
    # to T_before * alpha ~ 1e-2, so compare loosely here (exact-path
    # parity is covered by the pallas-vs-jnp check below and the other
    # oracle tests away from saturation).
    want, want_t = oracle_render(scene, cam)
    diff = np.abs(np.asarray(img) - want)
    assert np.quantile(diff, 0.999) < 1e-3
    assert diff.max() < 2e-2
    # pallas vs jnp reference: same formulation, but the jnp version's
    # *global* f32 cumsum accumulates rounding across all 200k entries
    # (segment-difference trick), so the tolerance is looser than in the
    # small-case test above.
    cfg_jnp = RenderConfig(max_pairs=16_000, rasterizer="jnp")
    import jax
    img_jnp = jax.jit(
        lambda *a: render(*a, cam, cfg=cfg_jnp)
    )(*scene.render_args())
    np.testing.assert_allclose(np.asarray(img), np.asarray(img_jnp), atol=1e-3)


def test_partial_edge_tiles():
    """Non-multiple-of-16 image: edge pixels must match and not leak."""
    cam = look_at_camera((2.5, -2.0, 1.5), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=50, height=38)
    scene = random_scene(60, seed=9)
    cfg = RenderConfig(max_pairs=20_000)
    img = render(*scene.render_args(), cam, cfg=cfg)
    want, _ = oracle_render(scene, cam)
    assert np.asarray(img).shape == (3, 38, 50)
    np.testing.assert_allclose(np.asarray(img), want, atol=5e-4)


def test_strict_reference_mode_renders():
    """Full strict-parity configuration (rect_mode + ewa_mode 'lcgs'):
    the reference renderer's exact conventions render end to end and
    match the numpy oracle run in the same modes."""
    import jax

    cam = look_at_camera((2.5, -2.0, 1.5), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=64, height=48)
    scene = random_scene(120, seed=23)
    cfg = RenderConfig(max_pairs=20_000, rect_mode="lcgs")
    img = jax.jit(
        lambda *a: render(*a, cam, cfg=cfg, ewa_mode="lcgs")
    )(*scene.render_args())
    want, _ = oracle_render(scene, cam, ewa_mode="lcgs", rect_mode="lcgs")
    np.testing.assert_allclose(np.asarray(img), want, atol=5e-4)
    # and it differs from the inria default (the last tile row/column
    # never receives splats in lcgs rect mode)
    img_inria = jax.jit(lambda *a: render(*a, cam, cfg=RenderConfig(
        max_pairs=20_000)))(*scene.render_args())
    assert np.abs(np.asarray(img) - np.asarray(img_inria)).max() > 1e-4


def test_payload_dtype_bf16_close():
    """payload_dtype="bf16" (7-column packed gather) matches the f32
    path within bf16 rounding of opacity/colour; gradients stay finite
    and close."""
    import jax
    import jax.numpy as jnp

    cam = look_at_camera((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=96, height=64)
    scene = random_scene(300, seed=11, scale_range=(0.02, 0.12))
    args = scene.render_args()

    imgs, grads = {}, {}
    for pd in ("f32", "bf16"):
        cfg = RenderConfig(max_pairs=60_000, payload_dtype=pd)

        def loss(*a):
            img, _ = render_aux(*a, cam, cfg=cfg)
            return jnp.sum(img * img), img

        (l, img), g = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)
        )(*args)
        imgs[pd], grads[pd] = np.asarray(img), g

    # bf16 rounds opacity/rgb (~2^-9 relative); blended pixels stay close
    diff = np.abs(imgs["bf16"] - imgs["f32"])
    assert diff.max() < 2e-2 and diff.mean() < 1e-3

    for ga, gb in zip(grads["f32"], grads["bf16"]):
        ga, gb = np.asarray(ga), np.asarray(gb)
        assert np.all(np.isfinite(gb))
        denom = np.abs(ga).max() + 1e-6
        assert np.abs(gb - ga).max() / denom < 5e-2


def test_tight_radius_bit_exact_and_fewer_entries():
    """tight_radius shrinks radii to the exact alpha_min reach: every
    culled entry contributes exactly zero (the blend kernel skips
    alpha < alpha_min anyway), so images agree to float reduction
    order (their absence regroups the chunked prefix sums — same
    ulp-level tolerance as the tile_cull test), low-opacity splats
    emit fewer entries, and gradients agree likewise."""
    import jax
    import jax.numpy as jnp

    cam = look_at_camera((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=96, height=64)
    scene = random_scene(300, seed=31, scale_range=(0.05, 0.35))
    # force a wide opacity spread incl. very faint splats
    rng = np.random.default_rng(5)
    opac = jnp.asarray(rng.uniform(0.004, 0.9, 300).astype(np.float32))
    m, s, q, _o, sh = scene.render_args()

    base = RenderConfig(max_pairs=120_000)
    tight = RenderConfig(max_pairs=120_000, tight_radius=True)
    img_b, aux_b = jax.jit(lambda *a: render_aux(*a, cam, cfg=base))(
        m, s, q, opac, sh)
    img_t, aux_t = jax.jit(lambda *a: render_aux(*a, cam, cfg=tight))(
        m, s, q, opac, sh)
    assert int(aux_t.num_rendered) < int(aux_b.num_rendered), (
        int(aux_t.num_rendered), int(aux_b.num_rendered))
    np.testing.assert_allclose(
        np.asarray(img_t), np.asarray(img_b), atol=1e-6)

    for cfg_pair in ((base, tight),):
        g = []
        for cfg in cfg_pair:
            g.append(jax.jit(jax.grad(
                lambda *a: jnp.sum(jnp.sin(render_aux(*a, cam, cfg=cfg)[0])),
                argnums=(0, 3),
            ))(m, s, q, opac, sh))
        for a, b in zip(*g):
            a, b = np.asarray(a), np.asarray(b)
            scale = np.abs(a).max() + 1e-8
            np.testing.assert_allclose(a / scale, b / scale, atol=1e-5)


def test_saturation_latch_sticky_across_chunks():
    """A rejected high-alpha blocker must latch the pixel done FOREVER
    (reference shader.cpp:257-266 sets `done` without applying the entry
    that would cross eps). Regression: the chunk loop used to carry the
    last-APPLIED transmittance, so entries in the next chunk resurrected
    a saturated pixel (order 1e-2 color error on near-saturated pixels).

    Build one 16x16 tile with exactly 2 chunks: chunk 0 = seven
    alpha=0.5 entries (T -> 7.8e-3) then an alpha=0.99 blocker
    (test_T = 7.8e-5 < 1e-4 -> rejected, done), chunk 1 = 128 small
    alpha=0.02 entries that must all stay unapplied."""
    import jax
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.ops.binning import (
        BinnedGaussians, CHUNK,
    )
    from luisacomputegaussiansplatting_jax.ops.rasterize_pallas import (
        FIELDS,
    )

    cfg = RenderConfig(max_pairs=2 * CHUNK, tile=16)
    w = h = 16
    cap = 2 * CHUNK
    opac = np.zeros(cap, np.float32)
    opac[:7] = 0.5
    opac[7] = 0.99
    opac[CHUNK:] = 0.02
    payload = np.zeros((FIELDS, cap), np.float32)
    payload[0] = 8.0  # mean x: tile centre
    payload[1] = 8.0
    payload[2] = 1e-6  # near-flat conic: alpha ~ opacity tile-wide
    payload[4] = 1e-6
    payload[5] = opac
    payload[6:9] = 1.0  # white: any resurrected entry shows in color
    payload = jnp.asarray(payload)
    starts = jnp.asarray([0], jnp.int32)
    counts = jnp.asarray([cap], jnp.int32)
    binned = BinnedGaussians(
        entry_gid=jnp.where(jnp.asarray(opac) > 0, 1, -1).astype(jnp.int32),
        entry_tile=jnp.zeros(cap, jnp.int32),
        tile_starts=starts,
        tile_counts=counts,
        num_rendered=jnp.int32(cap),
        overflow=jnp.asarray(False),
    )

    def run_pallas(pl_):
        return rasterize_tiles(pl_, starts, counts, 1, w, h, cfg)

    def run_ref(pl_):
        return rasterize_reference(pl_, binned, 1, w, h, cfg)

    (c_p, t_p) = run_pallas(payload)
    (c_r, t_r) = run_ref(payload)
    # T after the 7 applied entries, latched (alpha ~ 0.5 up to the
    # near-flat conic falloff); exactness is asserted vs the oracle below
    t_expect = 0.5 ** 7
    np.testing.assert_allclose(np.asarray(t_p), t_expect, rtol=2e-3)
    np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_r), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(c_p), np.asarray(c_r), atol=1e-6
    )

    # gradients: chunk-1 entries are never applied -> zero payload grads
    def loss_p(pl_):
        c, t = run_pallas(pl_)
        return jnp.sum(c) + jnp.sum(t)

    def loss_r(pl_):
        c, t = run_ref(pl_)
        return jnp.sum(c) + jnp.sum(t)

    g_p = jax.grad(loss_p)(payload)
    g_r = jax.grad(loss_r)(payload)
    assert float(jnp.abs(g_p[:, CHUNK:]).max()) == 0.0
    np.testing.assert_allclose(np.asarray(g_p), np.asarray(g_r), atol=5e-4)
