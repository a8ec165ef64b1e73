"""Pure-jnp reference rasterizer (O(entries x pixels-per-tile) memory).

Semantically identical to the Pallas kernels in rasterize_pallas.py —
same cutoffs as the reference renderer (gs_tile_splatter/shader.cpp:249-274)
expressed with segment-wise cumulative log-transmittance instead of a
sequential blend loop. Used as the numerical oracle in tests and as a
CPU/debug fallback for tiny scenes (materialises an (entries, 256) alpha
matrix, so it does not scale to whole frames of real scenes).

Differentiable end-to-end via plain autodiff, which independently
cross-checks the hand-derived Pallas backward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import TILE, RenderConfig
from .binning import BinnedGaussians

PIX = TILE * TILE


def rasterize_reference(
    payload,
    binned: BinnedGaussians,
    grid_x: int,
    width: int,
    height: int,
    cfg: RenderConfig,
    tile_offset: int = 0,
):
    """Returns (color (num_tiles, PIX, 3), transmittance (num_tiles, PIX, 1)).

    Args:
      payload: (FIELDS, capacity) float32 in the rasterize_pallas
        field-major layout.
      binned: binning result (entry_tile gives each entry's owning tile).
      tile_offset: global index of tile 0 (a band of consecutive tiles
        cut out of a larger frame), as rasterize_tiles' tile_offset.
    """
    tw, th = cfg.tile_wh
    pix = tw * th
    capacity = payload.shape[1]
    num_tiles = binned.tile_starts.shape[0]
    tile = jnp.clip(binned.entry_tile, 0, num_tiles - 1)

    # per-entry pixel coordinates of its tile
    tile_y = (tile + tile_offset) // grid_x
    tile_x = tile + tile_offset - tile_y * grid_x
    lane = jnp.arange(pix, dtype=jnp.int32)[None, :]
    ix = tile_x[:, None] * tw + lane % tw
    iy = tile_y[:, None] * th + lane // tw
    inside = (ix < width) & (iy < height)
    px = ix.astype(jnp.float32)
    py = iy.astype(jnp.float32)

    mx, my = payload[0, :, None], payload[1, :, None]
    ca, cb, cc = payload[2, :, None], payload[3, :, None], payload[4, :, None]
    op = payload[5, :, None]

    dx = mx - px
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = jnp.minimum(op * jnp.exp(power), cfg.alpha_max)
    live = (power <= 0.0) & (alpha >= cfg.alpha_min) & inside
    alpha = jnp.where(live, alpha, 0.0)

    # segment-wise inclusive prefix of log(1 - alpha) over each tile's
    # range: a scan that restarts at every range start, so no sum ever
    # crosses a tile boundary (a global cumsum minus its value at the
    # range start loses f32 precision once millions of entries precede
    # the tile)
    log1ma = jnp.log1p(-alpha)
    first = jnp.arange(capacity) == jnp.take(binned.tile_starts, tile)
    first = jnp.broadcast_to(first[:, None], log1ma.shape)

    def restart_add(a, b):
        (va, fa), (vb, fb) = a, b
        return jnp.where(fb, vb, va + vb), fa | fb

    s_inc, _ = jax.lax.associative_scan(restart_add, (log1ma, first))
    t_after = jnp.exp(s_inc)
    t_before = jnp.exp(s_inc - log1ma)
    applied = (t_after >= cfg.transmittance_eps) & (alpha > 0.0)
    w = jnp.where(applied, t_before * alpha, 0.0)

    # accumulate per tile
    seg = tile
    color = jnp.zeros((num_tiles, pix, 3), jnp.float32)
    for c, field in enumerate((6, 7, 8)):
        contrib = w * payload[field, :, None]
        color = color.at[:, :, c].add(
            jax.ops.segment_sum(contrib, seg, num_segments=num_tiles)
        )
    t_fin = jnp.ones((num_tiles, pix), jnp.float32)
    t_candidates = jnp.where(applied, t_after, 1.0)
    t_fin = t_fin.at[seg].min(t_candidates)
    # out-of-image pixels are dead from the start (T = 0)
    tiles = jnp.arange(num_tiles, dtype=jnp.int32) + tile_offset
    t_ix = (tiles % grid_x)[:, None] * tw + lane % tw
    t_iy = (tiles // grid_x)[:, None] * th + lane // tw
    t0 = ((t_ix < width) & (t_iy < height)).astype(jnp.float32)
    t_fin = t_fin * t0
    return color, t_fin[:, :, None]
