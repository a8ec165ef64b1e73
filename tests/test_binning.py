"""Binning (expand + sort + tile-pack) vs a naive python loop."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.config import CHUNK, RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.ops.binning import bin_gaussians
from luisacomputegaussiansplatting_jax.ops.projection import (
    project_gaussians,
    tile_grid,
)
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera


def naive_tile_lists(proj, grid_x, grid_y):
    """Per-tile gaussian lists ordered by (f32 depth, gaussian index)."""
    tiles = {t: [] for t in range(grid_x * grid_y)}
    n = proj.radius.shape[0]
    rect_min = np.asarray(proj.rect_min)
    rect_max = np.asarray(proj.rect_max)
    depth = np.asarray(proj.depth, np.float32)
    valid = np.asarray(proj.valid)
    for i in range(n):
        if not valid[i]:
            continue
        for ty in range(rect_min[i, 1], rect_max[i, 1]):
            for tx in range(rect_min[i, 0], rect_max[i, 0]):
                tiles[tx + ty * grid_x].append(i)
    for t in tiles:
        tiles[t].sort(key=lambda i: (depth[i], i))
    return tiles


@pytest.fixture
def setup():
    cam = look_at_camera((3.5, -3.0, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=80, height=48)
    scene = random_scene(96, seed=11)
    cfg = RenderConfig(max_pairs=50_000)
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)
    binned = bin_gaussians(proj, gx, gy, cfg.max_pairs)
    return proj, binned, gx, gy


def test_entries_match_naive(setup):
    proj, binned, gx, gy = setup
    tiles = naive_tile_lists(proj, gx, gy)
    total = sum(len(v) for v in tiles.values())
    assert int(binned.num_rendered) == total
    assert not bool(binned.overflow)

    gid = np.asarray(binned.entry_gid)
    starts = np.asarray(binned.tile_starts)
    counts = np.asarray(binned.tile_counts)
    for t in range(gx * gy):
        want = tiles[t]
        got = [g for g in gid[starts[t] : starts[t] + counts[t]] if g >= 0]
        assert got == want, f"tile {t}"


def test_chunk_alignment(setup):
    _, binned, gx, gy = setup
    starts = np.asarray(binned.tile_starts)
    counts = np.asarray(binned.tile_counts)
    assert np.all(starts % CHUNK == 0)
    assert np.all(counts % CHUNK == 0)
    # ranges must be disjoint and ordered
    ends = starts + counts
    assert np.all(starts[1:] >= ends[:-1])
    # padding entries are flagged
    gid = np.asarray(binned.entry_gid)
    tile = np.asarray(binned.entry_tile)
    assert np.all((gid >= 0) == (tile >= 0))
    # every valid entry's tile matches its owning range
    for t in range(gx * gy):
        seg_tile = tile[starts[t] : ends[t]]
        assert np.all(seg_tile[seg_tile >= 0] == t)


def naive_expansion(proj, grid_x, tile, max_pairs, opacities=None,
                    alpha_min=1.0 / 255.0):
    """(gid, tile) of every expansion slot the XLA path keeps, in slot
    order: AABB entries in gaussian order, y-outer/x-inner
    (gs_tile_splatter/shader.cpp:55-67), truncated to max_pairs, then —
    with opacities — filtered by a brute-force per-pixel reach test in
    float64. Also returns the AABB total and the float64 reach margin
    of each kept-or-dropped slot (boundary cases may round either way)."""
    rect_min = np.asarray(proj.rect_min)
    rect_max = np.asarray(proj.rect_max)
    valid = np.asarray(proj.valid)
    slots = []
    for i in range(rect_min.shape[0]):
        if not valid[i]:
            continue
        for ty in range(rect_min[i, 1], rect_max[i, 1]):
            for tx in range(rect_min[i, 0], rect_max[i, 0]):
                slots.append((i, tx, ty))
    total = len(slots)
    slots = slots[:max_pairs]
    if opacities is None:
        return [(i, tx + ty * grid_x) for i, tx, ty in slots], total, None
    m2 = np.asarray(proj.means2d, np.float64)
    con = np.asarray(proj.conic, np.float64)
    op = np.asarray(opacities, np.float64)
    p = np.arange(tile, dtype=np.float64)
    kept, margins = [], []
    for i, tx, ty in slots:
        dx = (tx * tile + p)[None, :] - m2[i, 0]
        dy = (ty * tile + p)[:, None] - m2[i, 1]
        q = 0.5 * (con[i, 0] * dx * dx + con[i, 2] * dy * dy) \
            + con[i, 1] * dx * dy
        margin = np.log(op[i] / alpha_min) - q.min()
        margins.append(margin)
        if margin >= 0:
            kept.append((i, tx + ty * grid_x))
    return kept, total, np.asarray(margins)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("maxp", [256, 4096, 50_000])
def test_xla_expansion_matches_naive(maxp, cull):
    """expand_entries (scatter + cummax + one row gather) against the
    naive loop at several capacities — including truncation mid-gaussian
    — with the exact ellipse-tile cull on and off."""
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.ops.binning import expand_entries

    cam = look_at_camera((3.5, -3.0, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=80, height=48)
    scene = random_scene(200, seed=17, scale_range=(0.01, 0.3))
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam,
                             RenderConfig())
    gx, gy = tile_grid(cam.width, cam.height)
    nt = gx * gy
    op = jnp.asarray(scene.opacities) if cull else None

    t_x, d_x, g_x, tot = expand_entries(proj, gx, nt, maxp, op)
    t_x, g_x, d_x = np.asarray(t_x), np.asarray(g_x), np.asarray(d_x)
    want, total, margins = naive_expansion(proj, gx, 16, maxp, op)
    assert int(tot) == total
    live = t_x < nt
    # invalid slots: sentinel tile, gid -1, +inf depth
    assert np.all(g_x[~live] == -1) and np.all(np.isinf(d_x[~live]))
    got = list(zip(g_x[live].tolist(), t_x[live].tolist()))
    if not cull:
        assert got == want
        return
    # the closed-form cull equals the per-pixel one away from rounding
    # ties; the scene must actually lose entries to it
    assert len(want) < min(total, maxp)
    assert set(want) <= set(got) | set(
        s for s, m in zip(want, margins[margins >= 0]) if abs(m) < 1e-4)
    extra = set(got) - set(want)
    assert len(extra) <= int(np.sum(np.abs(margins) < 1e-4))


def test_max_pairs_sorted_trim():
    """Post-sort capacity trim: same image when it covers the valid
    entries, overflow flag when it would truncate one."""
    import jax
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.ops.render import render_aux

    cam = look_at_camera((3.5, -3.0, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=80, height=48)
    scene = random_scene(200, seed=17, scale_range=(0.01, 0.2))
    base = RenderConfig(max_pairs=50_000, tile_cull=True, pack_mode="none")
    img0, aux0 = jax.jit(lambda *a: render_aux(*a, cam, cfg=base))(
        *scene.render_args()
    )
    assert not bool(aux0.overflow)
    n_valid = int(jnp.sum(jnp.asarray(aux0.num_rendered)))  # AABB count

    trimmed = RenderConfig(max_pairs=50_000, tile_cull=True,
                           pack_mode="none", max_pairs_sorted=n_valid)
    img1, aux1 = jax.jit(lambda *a: render_aux(*a, cam, cfg=trimmed))(
        *scene.render_args()
    )
    assert not bool(aux1.overflow)
    np.testing.assert_allclose(np.asarray(img0), np.asarray(img1), atol=1e-6)

    tiny = RenderConfig(max_pairs=50_000, tile_cull=True,
                        pack_mode="none", max_pairs_sorted=256)
    _, aux2 = jax.jit(lambda *a: render_aux(*a, cam, cfg=tiny))(
        *scene.render_args()
    )
    assert bool(aux2.overflow)


def test_trim_rounding_no_spurious_overflow():
    """CHUNK-rounding the trim capacity to/past max_pairs must not read
    past the stream and flag a spurious overflow (a clamped OOB index
    would re-read the last valid entry)."""
    from luisacomputegaussiansplatting_jax.ops.binning import (
        bin_gaussians_nopack,
    )

    cam = look_at_camera((3.5, -3.0, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=80, height=48)
    scene = random_scene(200, seed=17, scale_range=(0.01, 0.2))
    cfg = RenderConfig(max_pairs=50_000)
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)
    total = int(bin_gaussians_nopack(proj, gx, gy, 50_000).num_rendered)
    assert 130 < total < 50_000 and total % 128 != 0

    # every slot valid, trim capacity rounds up to >= max_pairs: no trim,
    # no overflow
    b = bin_gaussians_nopack(proj, gx, gy, total, max_sorted=total - 1)
    assert not bool(b.overflow)
    # a genuinely-truncating trim still flags
    b = bin_gaussians_nopack(proj, gx, gy, total, max_sorted=total - 130)
    assert bool(b.overflow)


def test_overflow_flag():
    cam = look_at_camera((2.0, -2.0, 1.0), (0, 0, 0), (0, 0, 1),
                         width=64, height=64)
    scene = random_scene(128, seed=2, scale_range=(0.3, 0.8))
    cfg = RenderConfig(max_pairs=256)
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)
    binned = bin_gaussians(proj, gx, gy, cfg.max_pairs)
    assert bool(binned.overflow)
    assert int(binned.num_rendered) == cfg.max_pairs


def test_empty_scene():
    cam = look_at_camera((0, 0, -5.0), (0, 0, 1), (0, 1, 0),
                         width=32, height=32)
    # all gaussians behind the camera
    means = np.tile(np.array([[0, 0, -10.0]], np.float32), (8, 1))
    scales = np.full((8, 3), 0.1, np.float32)
    quats = np.tile(np.array([0, 0, 0, 1.0], np.float32), (8, 1))
    cfg = RenderConfig(max_pairs=1024)
    proj = project_gaussians(means, scales, quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)
    binned = bin_gaussians(proj, gx, gy, cfg.max_pairs)
    assert int(binned.num_rendered) == 0
    assert np.all(np.asarray(binned.tile_counts) == 0)
    assert np.all(np.asarray(binned.entry_gid) == -1)


def test_tile_cull_is_output_exact():
    """Ellipse-tile culling drops entries but must be render-exact."""
    import jax
    import numpy as np

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
    from luisacomputegaussiansplatting_jax.ops.render import render_aux
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    cam = look_at_camera((3.0, -2.5, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=96, height=64)
    # anisotropic splats: the AABB heavily overcounts vs the ellipse
    scene = random_scene(800, seed=17, extent=1.5, scale_range=(0.01, 0.2))
    on = RenderConfig(max_pairs=120_000, tile_cull=True)
    off = RenderConfig(max_pairs=120_000, tile_cull=False)
    img_on, aux_on = jax.jit(lambda *a: render_aux(*a, cam, cfg=on))(
        *scene.render_args()
    )
    img_off, aux_off = jax.jit(lambda *a: render_aux(*a, cam, cfg=off))(
        *scene.render_args()
    )
    # removed entries contribute exactly zero, but their absence regroups
    # the chunked prefix sums: agreement is ulp-level, not bitwise
    np.testing.assert_allclose(
        np.asarray(img_on), np.asarray(img_off), atol=1e-6
    )
    # gradients identical too
    import jax.numpy as jnp

    g_on = jax.jit(jax.grad(
        lambda *a: jnp.sum(jnp.sin(render_aux(*a, cam, cfg=on)[0])),
        argnums=(0, 3),
    ))(*scene.render_args())
    g_off = jax.jit(jax.grad(
        lambda *a: jnp.sum(jnp.sin(render_aux(*a, cam, cfg=off)[0])),
        argnums=(0, 3),
    ))(*scene.render_args())
    for a, b in zip(g_on, g_off):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-5)


def test_fused_sort_mode_matches_2key():
    """sort_mode="fused" (single quantized uint32 key) must produce the
    same per-tile entry SETS as the exact 2-key sort, with per-tile depth
    order correct up to quantization ties; on a generic random scene
    (depths well separated) the rendered images must agree closely."""
    import jax
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.ops.binning import (
        bin_gaussians_nopack,
    )
    from luisacomputegaussiansplatting_jax.ops.render import render_aux

    cam = look_at_camera((3.5, -3.0, 2.0), (0, 0, 0), (0, 0, 1),
                         fov=70.0, width=80, height=48)
    scene = random_scene(200, seed=23, scale_range=(0.02, 0.2))
    cfg = RenderConfig(max_pairs=50_000)
    proj = project_gaussians(scene.means, scene.scales, scene.quats, cam, cfg)
    gx, gy = tile_grid(cam.width, cam.height)

    b2 = bin_gaussians_nopack(proj, gx, gy, cfg.max_pairs)
    bf = bin_gaussians_nopack(proj, gx, gy, cfg.max_pairs,
                              sort_mode="fused")
    assert int(b2.num_rendered) == int(bf.num_rendered)
    s2, c2 = np.asarray(b2.tile_starts), np.asarray(b2.tile_counts)
    sf, cf = np.asarray(bf.tile_starts), np.asarray(bf.tile_counts)
    np.testing.assert_array_equal(s2, sf)
    np.testing.assert_array_equal(c2, cf)

    g2, gf = np.asarray(b2.entry_gid), np.asarray(bf.entry_gid)
    depth = np.asarray(proj.depth)
    for t in range(gx * gy):
        a = g2[s2[t]: s2[t] + c2[t]]
        b = gf[sf[t]: sf[t] + cf[t]]
        assert sorted(a.tolist()) == sorted(b.tolist()), f"tile {t} sets"
        # fused per-tile depth order must be monotone up to quantization:
        # exact up to ~2^-13 relative at this tiny grid (db >= 24)
        d = depth[b[b >= 0]]
        assert np.all(np.diff(d) >= -np.abs(d[:-1]) * 2**-12), f"tile {t}"

    img2 = jax.jit(lambda *a: render_aux(*a, cam, cfg=cfg)[0])(
        *scene.render_args())
    imgf = jax.jit(lambda *a: render_aux(
        *a, cam, cfg=RenderConfig(max_pairs=50_000, sort_mode="fused"))[0])(
        *scene.render_args())
    assert np.abs(np.asarray(img2) - np.asarray(imgf)).max() < 1e-5


def test_fused_sort_fallback_huge_grid():
    """When the tile grid leaves fewer than 12 depth bits, "fused" must
    fall back to the exact 2-key sort (identical output order)."""
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.ops.binning import _sort_entries

    rng = np.random.default_rng(3)
    L = 4096
    num_tiles = 1 << 22  # tb = 23 -> db = 9 < 12: must fall back
    tile = jnp.asarray(rng.integers(0, num_tiles, L).astype(np.int32))
    depth = jnp.asarray(rng.uniform(0.2, 30.0, L).astype(np.float32))
    gid = jnp.asarray(np.arange(L, dtype=np.int32))
    t_f, g_f = _sort_entries(tile, depth, gid, num_tiles, "fused")
    t_2, g_2 = _sort_entries(tile, depth, gid, num_tiles, "2key")
    np.testing.assert_array_equal(np.asarray(t_f), np.asarray(t_2))
    np.testing.assert_array_equal(np.asarray(g_f), np.asarray(g_2))
