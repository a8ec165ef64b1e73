"""Tile binning: expand gaussians into (tile, depth)-sorted splat entries.

Static-shape redesign of the reference's four-stage binning
(lcgs/src/gs_tile_splatter/impl.cpp:87-156):

  reference (GPU, 4 sync points + D2H readback)      this module (one jit)
  ------------------------------------------------   -----------------------------
  shad_allocate_tiles -> tiles_touched                counts from projection op
  LCPP DeviceScan::InclusiveSum                       jnp.cumsum (XLA-native scan)
  readback num_rendered, alloc L                      static capacity + overflow flag
  shad_copy_with_keys (variable-fanout scatter)       scatter-heads + cummax expansion
  LCPP DeviceRadixSort 64-bit (tile<<32|depth) keys   lax.sort, 2 lexicographic keys
  shad_get_ranges (boundary detect)                   vectorised searchsorted

The variable-fanout scatter (reference shader.cpp:55-67: each gaussian
writes its rect's tiles at a dynamic offset) becomes a static-shape
slot-wise form: each output *slot* computes its source gaussian: scatter gaussian
ids at their start offsets, forward-fill with a cummax scan, then derive
the within-rect tile from the slot's local index. Everything is static
shape; entries beyond capacity are dropped and flagged (the reference
silently corrupts memory past its L=20'000'000 cap, app/main.cpp:245).

Finally (pack_mode="chunk"), each tile's range is re-packed so it starts
at a CHUNK-aligned offset — the reference-faithful layout.

The pieces are exposed separately (expand_entries / sort_entries /
pack_ranges) because the multi-chip path (parallel/render_sharded.py)
interleaves an all-to-all exchange between expansion and packing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CHUNK
from .projection import ProjectedGaussians


class BinnedGaussians(NamedTuple):
    """Splat entries sorted by (tile, depth), padded per tile to CHUNK.

    Entry arrays have static length ``capacity``; ``entry_gid[i] == -1``
    marks padding. ``tile_starts[t]`` is CHUNK-aligned and
    ``tile_counts[t]`` is a multiple of CHUNK.
    """

    entry_gid: jnp.ndarray  # (capacity,) int32 gaussian index, -1 = pad
    entry_tile: jnp.ndarray  # (capacity,) int32 owning tile, -1 = pad
    tile_starts: jnp.ndarray  # (num_tiles,) int32
    tile_counts: jnp.ndarray  # (num_tiles,) int32 (multiples of CHUNK)
    num_rendered: jnp.ndarray  # () int32: entries retained post cull/trim
    overflow: jnp.ndarray  # () bool: AABB expansion slots exceeded max_pairs


def forward_fill_ids(starts, valid, capacity: int):
    """slot -> source-row map: scatter row ids at their start offsets and
    forward-fill with an inclusive cummax (rows with valid[i]=False are
    dropped; their zero extent means no slot maps to them)."""
    n = starts.shape[0]
    ids = jnp.arange(n, dtype=jnp.int32)
    scatter_idx = jnp.where(valid, starts, capacity)  # out-of-range = drop
    heads = jnp.zeros((capacity,), jnp.int32)
    heads = heads.at[scatter_idx].max(ids, mode="drop")
    return jax.lax.cummax(heads)


def _saturate_total(total, counts):
    """Guard the int32 cumsum wrap: on divergent scenes the summed AABB
    areas can exceed 2^31, making ``total`` negative (or wrapped back
    positive) — which would defeat every downstream ``total > capacity``
    overflow check and reproduce the exact silent-corruption mode this
    design exists to prevent. An f32 re-sum detects the wrap (relative
    error ~2^-24 is irrelevant against a 2^31 threshold) and pins total
    to INT32_MAX so overflow fires loudly."""
    total_f = jnp.sum(counts.astype(jnp.float32))
    return jnp.where(
        total_f >= jnp.float32(2**31 - 1), jnp.int32(2**31 - 1), total
    )


def ellipse_tile_reaches(mx, my, ca, cb, cc, op, x0, x1, y0, y1,
                         alpha_min):
    """Exact ellipse-tile reach test: can ANY pixel centre in the box
    [x0,x1]x[y0,y1] receive alpha = op * exp(-q) >= alpha_min? The
    minimum of the convex quadratic q(d) = 0.5 d^T conic d over the box
    is closed-form: 0 if the mean is inside, else the best of the four
    edge-constrained minimizers."""
    inside = (mx >= x0) & (mx <= x1) & (my >= y0) & (my <= y1)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def edge_x(xe):
        dx = xe - mx
        ys = jnp.clip(my - (cb / jnp.maximum(cc, 1e-12)) * dx, y0, y1)
        return q(dx, ys - my)

    def edge_y(ye):
        dy = ye - my
        xs = jnp.clip(mx - (cb / jnp.maximum(ca, 1e-12)) * dy, x0, x1)
        return q(xs - mx, dy)

    q_min = jnp.where(
        inside,
        0.0,
        jnp.minimum(
            jnp.minimum(edge_x(x0), edge_x(x1)),
            jnp.minimum(edge_y(y0), edge_y(y1)),
        ),
    )
    # alpha = op * exp(-q) >= alpha_min  <=>  q <= log(op / alpha_min)
    return q_min <= jnp.log(jnp.maximum(op, 1e-12) / alpha_min)


@jax.named_scope("expand")
def expand_entries(
    proj: ProjectedGaussians,
    grid_x: int,
    num_tiles: int,
    max_pairs: int,
    opacities=None,
    tile=16,
    alpha_min: float = 1.0 / 255.0,
):
    """Expand each gaussian's tile rect into one entry per touched tile.

    Returns (tile_id, depth, gid, total): (max_pairs,) arrays; invalid
    slots have tile_id == num_tiles (sorts last), depth == +inf, gid == -1.
    Emission order within a gaussian is y-outer/x-inner, matching the
    reference key scatter (gs_tile_splatter/shader.cpp:55-67).

    All per-slot lookups ride ONE row gather from a packed (P, K) int32
    table:
    col 0 = start offset, col 1 = rect_min_x | rect_min_y << 16,
    col 2 = rect width, col 3 = depth float bits (monotone for the
    positive, near-culled depths that reach binning); with ``opacities``
    given, cols 4-9 carry mean/conic/opacity float bits.

    Ellipse-tile culling (exact): when ``opacities`` is provided, an
    entry whose tile cannot receive any alpha >= alpha_min contribution
    is invalidated. The minimum of the conic quadratic over the tile's
    pixel-centre box is computed in closed form (interior, else the best
    of the four edge-constrained minimizers of the convex quadratic), so
    only entries the rasterizer would skip at every pixel are dropped —
    image and gradients are exact up to summation regrouping (removed
    zeros shift chunk boundaries), and per-tile ranges shrink by the
    AABB-vs-ellipse overcount.
    """
    from .projection import _tile_wh

    tw, th = _tile_wh(tile)
    counts = proj.tiles_touched.astype(jnp.int32)  # (P,)
    ends = jnp.cumsum(counts)
    starts = ends - counts
    total = ends[-1] if counts.shape[0] > 0 else jnp.int32(0)
    total = _saturate_total(total, counts)

    def fbits(x):
        return jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)

    cols = [
        starts,
        proj.rect_min[:, 0] | (proj.rect_min[:, 1] << 16),
        jnp.maximum(proj.rect_max[:, 0] - proj.rect_min[:, 0], 1),
        fbits(proj.depth),
    ]
    if opacities is not None:
        cols += [
            fbits(proj.means2d[:, 0]),
            fbits(proj.means2d[:, 1]),
            fbits(proj.conic[:, 0]),
            fbits(proj.conic[:, 1]),
            fbits(proj.conic[:, 2]),
            fbits(opacities.reshape(-1)),
        ]
    table = jnp.stack(cols, axis=1)  # (P, 4 or 10) int32

    slot_gid = forward_fill_ids(starts, proj.valid, max_pairs)  # (L,)
    slot = jnp.arange(max_pairs, dtype=jnp.int32)
    slot_valid = slot < jnp.minimum(total, max_pairs)

    g = jnp.take(table, slot_gid, axis=0)  # (L, K) — the one gather
    local = slot - g[:, 0]
    min_x = g[:, 1] & 0xFFFF
    min_y = g[:, 1] >> 16
    rect_w = g[:, 2]
    tile_x = min_x + local % rect_w
    tile_y = min_y + local // rect_w

    if opacities is not None:

        def f32(col):
            return jax.lax.bitcast_convert_type(g[:, col], jnp.float32)

        mx, my = f32(4), f32(5)
        ca, cb, cc = f32(6), f32(7), f32(8)
        op = f32(9)
        # tile pixel-centre box (pixels sit at integer coordinates)
        x0 = (tile_x * tw).astype(jnp.float32)
        x1 = x0 + (tw - 1)
        y0 = (tile_y * th).astype(jnp.float32)
        y1 = y0 + (th - 1)
        slot_valid = slot_valid & ellipse_tile_reaches(
            mx, my, ca, cb, cc, op, x0, x1, y0, y1, alpha_min
        )

    tile_id = tile_x + tile_y * grid_x
    tile_id = jnp.where(slot_valid, tile_id, num_tiles)
    depth = jnp.where(
        slot_valid,
        jax.lax.bitcast_convert_type(g[:, 3], jnp.float32),
        jnp.inf,
    )
    gid = jnp.where(slot_valid, slot_gid, -1)
    return tile_id, depth, gid, total


def pack_ranges(sorted_tile, num_tiles: int, capacity: int):
    """CHUNK-pad each tile's sorted range.

    Args:
      sorted_tile: (L,) int32 non-decreasing tile ids (sentinel >= num_tiles
        for invalid entries).
      capacity: output slot count (>= L + num_tiles * CHUNK covers the
        worst case).

    Returns:
      src: (capacity,) int32 index into the sorted arrays.
      in_range: (capacity,) bool — False marks padding slots.
      slot_tile: (capacity,) int32 owning tile of each slot.
      tile_starts/tile_counts: (num_tiles,) int32, CHUNK-aligned.
    """
    tids = jnp.arange(num_tiles, dtype=jnp.int32)
    range_start = jnp.searchsorted(sorted_tile, tids, side="left").astype(jnp.int32)
    range_end = jnp.searchsorted(sorted_tile, tids, side="right").astype(jnp.int32)
    tile_len = range_end - range_start

    padded_len = ((tile_len + CHUNK - 1) // CHUNK) * CHUNK
    padded_end = jnp.cumsum(padded_len)
    padded_start = padded_end - padded_len

    slot = jnp.arange(capacity, dtype=jnp.int32)
    slot_tile = forward_fill_ids(padded_start, padded_len > 0, capacity)
    # one row gather from the small per-tile table instead of three 1-D ones
    table = jnp.stack([padded_start, tile_len, range_start], axis=1)  # (T, 3)
    t = jnp.take(table, slot_tile, axis=0)  # (capacity, 3)
    local = slot - t[:, 0]
    in_range = (local < t[:, 1]) & (slot < padded_end[-1])
    src = jnp.clip(t[:, 2] + local, 0, sorted_tile.shape[0] - 1)
    return src, in_range, slot_tile, padded_start.astype(jnp.int32), padded_len.astype(jnp.int32)


def pack_slot_inverse(sorted_tile, tile_starts, num_tiles: int, capacity: int):
    """Closed-form inverse of pack_ranges' slot assignment.

    Entry k of the sorted stream (owning tile t = sorted_tile[k] < num_tiles)
    sits at slot tile_starts[t] + (k - range_start[t]) — the layout invariant
    pack_ranges establishes above (each tile's range copied contiguously from
    its CHUNK-aligned padded start). Entries with sentinel tiles
    (>= num_tiles) map to ``capacity`` (past the end -> callers treat as
    zero-gradient). Lives here so the inverse and the forward layout change
    together; used by the sharded backward (parallel/exchange_vjp.py) to turn
    the pack gather's VJP into one row gather instead of a scatter.

    Args:
      sorted_tile: (L,) int32 non-decreasing tile ids.
      tile_starts: (num_tiles,) int32 — pack_ranges' padded_start output.

    Returns (L,) int32 slot index, == capacity for sentinel entries.
    """
    tids = jnp.arange(num_tiles, dtype=jnp.int32)
    range_start = jnp.searchsorted(sorted_tile, tids, side="left").astype(
        jnp.int32
    )
    k = jnp.arange(sorted_tile.shape[0], dtype=jnp.int32)
    t_safe = jnp.clip(sorted_tile, 0, num_tiles - 1)
    # one row gather from the packed 2-column table (per-field takes cost
    # per ROW each, CLAUDE.md) over the L-length entry stream
    table = jnp.stack([tile_starts, range_start], axis=1)  # (T, 2)
    t = jnp.take(table, t_safe, axis=0)  # (L, 2)
    return jnp.where(
        sorted_tile < num_tiles, t[:, 0] + (k - t[:, 1]), capacity
    )


class NoPackBinned(NamedTuple):
    """Splat entries sorted by (tile, depth) with raw (unpadded) ranges.

    The rasterizer's no-pack mode reads each tile's range
    [start, start + count) directly from the sorted stream with masked
    loads — so no CHUNK-repacking pass and no slot->sorted-index remap
    gather exist. ``entry_gid`` IS the sorted gaussian-id stream.
    """

    entry_gid: jnp.ndarray  # (max_pairs,) int32, -1 = pad
    entry_tile: jnp.ndarray  # (max_pairs,) int32 owning tile
    tile_starts: jnp.ndarray  # (num_tiles,) int32 (NOT aligned)
    tile_counts: jnp.ndarray  # (num_tiles,) int32 (NOT padded)
    num_rendered: jnp.ndarray  # () int32
    overflow: jnp.ndarray  # () bool


@jax.named_scope("entry_sort")
def _sort_entries(tile_id, depth, gid, num_tiles: int, sort_mode: str):
    """Sort expansion entries by (tile, depth) -> (sorted_tile, sorted_gid).

    "2key": stable two-key sort. Exact parity with the reference's stable
    LSD radix sort over packed (tile<<32)|float_bits(depth) 64-bit keys
    (gs_tile_splatter/shader.cpp:59-62): full f32 depth order, ties keep
    gaussian order.

    "fused": the same packing idea compressed into ONE uint32 key —
    tile rides the top tb = ceil(log2(num_tiles+2)) bits, depth's
    positive-f32 bit pattern (monotone in value) quantized to the low
    db = 32-tb bits (8 exponent + db-8 mantissa bits, i.e. ~2^-(db-8)
    relative depth resolution: ~2^-13 at db=21, the 1080p/tile=32
    case): a single-key 2-operand unstable sort instead of a 3-operand
    stable one. Blend order differs from "2key" only between splats whose depths collide
    within quantization; falls back to "2key" when the grid is so large
    that db < 12.
    """
    if sort_mode == "fused":
        tb = (num_tiles + 1).bit_length()
        db = 32 - tb
        if db >= 12:
            dbits = jax.lax.bitcast_convert_type(depth, jnp.int32)
            # invalid entries may carry arbitrary depth bits: mask to the
            # field so they cannot corrupt the (sentinel) tile bits
            dq = jax.lax.shift_right_logical(dbits, 31 - db) & ((1 << db) - 1)
            key = (tile_id.astype(jnp.uint32) << db) | dq.astype(jnp.uint32)
            skey, sgid = jax.lax.sort((key, gid), num_keys=1, is_stable=False)
            stile = jax.lax.shift_right_logical(
                skey, jnp.uint32(db)
            ).astype(jnp.int32)
            return stile, sgid
        sort_mode = "2key"
    if sort_mode != "2key":
        raise ValueError(f"unknown sort_mode: {sort_mode!r}")
    stile, _d, sgid = jax.lax.sort(
        (tile_id, depth, gid), num_keys=2, is_stable=True
    )
    return stile, sgid


def bin_gaussians_nopack(
    proj: ProjectedGaussians,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    opacities=None,
    tile: int = 16,
    alpha_min: float = 1.0 / 255.0,
    max_sorted: int | None = None,
    sort_mode: str = "2key",
) -> NoPackBinned:
    """Expand and sort splat entries; ranges stay unpadded (no-pack mode).

    max_sorted: optional smaller static capacity for the post-sort
    stream. Valid entries compact to a prefix after the sort (invalid /
    ellipse-culled slots carry the sentinel tile and sort last), so with
    tile_cull on, the payload gather and backward reduction can run at
    the post-cull size instead of the AABB expansion capacity. Truncating
    a VALID entry raises the overflow flag.
    """
    num_tiles = grid_x * grid_y
    tile_id, depth, gid, total = expand_entries(
        proj, grid_x, num_tiles, max_pairs, opacities, tile, alpha_min
    )
    overflow = total > max_pairs

    sorted_tile, sorted_gid = _sort_entries(
        tile_id, depth, gid, num_tiles, sort_mode
    )
    # chunk-rounding can push cap to/past max_pairs (max_pairs need not be
    # CHUNK-aligned); then the trim is a no-op and sorted_gid[cap] would
    # clamp to the last element and raise a spurious overflow — skip it.
    if max_sorted is not None and _round_up_chunk(max_sorted) < max_pairs:
        cap = _round_up_chunk(max_sorted)
        overflow |= sorted_gid[cap] >= 0  # a valid entry got cut off
        sorted_tile = sorted_tile[:cap]
        sorted_gid = sorted_gid[:cap]

    tids = jnp.arange(num_tiles, dtype=jnp.int32)
    start = jnp.searchsorted(sorted_tile, tids, side="left").astype(jnp.int32)
    end = jnp.searchsorted(sorted_tile, tids, side="right").astype(jnp.int32)

    return NoPackBinned(
        entry_gid=sorted_gid,
        entry_tile=sorted_tile,
        tile_starts=start,
        tile_counts=end - start,
        num_rendered=_num_retained(sorted_tile, num_tiles),
        overflow=overflow,
    )


def _round_up_chunk(x: int) -> int:
    return (x + CHUNK - 1) // CHUNK * CHUNK


def _num_retained(sorted_tile, num_tiles: int):
    """Entries that actually survive into the rasterized stream (post
    ellipse cull and post-sort trim): valid entries carry tile ids
    < num_tiles and sort first, so one log-time searchsorted counts
    them. The pre-cull AABB slot count stays the overflow criterion
    (capacity is sized for expansion slots), but the reported
    num_rendered now matches what the kernels blend."""
    return jnp.searchsorted(
        sorted_tile, jnp.int32(num_tiles), side="left"
    ).astype(jnp.int32)


def bin_gaussians(
    proj: ProjectedGaussians,
    grid_x: int,
    grid_y: int,
    max_pairs: int,
    opacities=None,
    tile: int = 16,
    alpha_min: float = 1.0 / 255.0,
    max_sorted: int | None = None,
    sort_mode: str = "2key",
) -> BinnedGaussians:
    """Expand, sort and tile-pack splat entries (single-shard path).

    Returns BinnedGaussians with ``capacity = max_pairs + num_tiles*CHUNK``.
    max_sorted: see bin_gaussians_nopack. sort_mode: see _sort_entries.
    """
    num_tiles = grid_x * grid_y
    tile_id, depth, gid, total = expand_entries(
        proj, grid_x, num_tiles, max_pairs, opacities, tile, alpha_min
    )
    overflow = total > max_pairs

    sorted_tile, sorted_gid = _sort_entries(
        tile_id, depth, gid, num_tiles, sort_mode
    )
    eff_pairs = max_pairs
    # see bin_gaussians_nopack: skip the trim when rounding reaches max_pairs
    if max_sorted is not None and _round_up_chunk(max_sorted) < max_pairs:
        eff_pairs = _round_up_chunk(max_sorted)
        overflow |= sorted_gid[eff_pairs] >= 0
        sorted_tile = sorted_tile[:eff_pairs]
        sorted_gid = sorted_gid[:eff_pairs]

    capacity = eff_pairs + num_tiles * CHUNK
    src, in_range, slot_tile, tile_starts, tile_counts = pack_ranges(
        sorted_tile, num_tiles, capacity
    )
    entry_gid = jnp.where(in_range, jnp.take(sorted_gid, src), -1)
    entry_tile = jnp.where(in_range, slot_tile, -1)

    return BinnedGaussians(
        entry_gid=entry_gid,
        entry_tile=entry_tile,
        tile_starts=tile_starts,
        tile_counts=tile_counts,
        num_rendered=_num_retained(sorted_tile, num_tiles),
        overflow=overflow,
    )
