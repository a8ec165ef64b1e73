"""Multi-chip differentiable rendering: gaussians + tiles sharded over a mesh.

The reference has no distributed path at all (single Device/Stream,
app/main.cpp:162-163). This module is the scale-out design from
SURVEY.md section 7.6:

  * gaussians are sharded over the mesh axis: each chip runs SH eval, EWA
    projection and rect expansion on its P/D shard only;
  * the image's tile grid is sharded as horizontal bands of tile rows:
    chip d owns tile rows [d*rows_per_dev, (d+1)*rows_per_dev);
  * each chip buckets its splat entries by owning chip (entries are
    already tile-sorted, so buckets are contiguous slices) and exchanges
    payload buckets with a single jax.lax.all_to_all;
  * the receiver merges by (tile, depth, global gaussian id) — the 3-key
    sort reproduces the single-chip stable order exactly — CHUNK-packs,
    and rasterizes its band with the same Pallas kernels (tile_offset
    selects the band's global tile coordinates).

Differentiability: the whole pipeline is jnp + all_to_all + the custom-vjp
rasterizer, so jax.grad works through it; the transpose of all_to_all
routes per-entry payload gradients back to the chip that owns the source
gaussian — per-gaussian parameter gradients need *no* psum (each gaussian
lives on exactly one chip). Only scalar losses need a psum.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..config import CHUNK, RenderConfig
from ..utils.camera import Camera, CameraView
from ..ops.binning import expand_entries, pack_ranges, pack_slot_inverse
from ..ops.projection import project_gaussians, tile_grid
from ..ops.rasterize_pallas import rasterize_tiles
from ..ops.sh_eval import compute_colors


@dataclasses.dataclass(frozen=True)
class ShardedRenderConfig:
    """Static capacities of the exchange (all per-device)."""

    #: expansion capacity per device (entries its local gaussians emit).
    max_pairs_local: int = 1_000_000
    #: bucket capacity per (source, destination) device pair. ``None``
    #: auto-derives from max_pairs_local (see derive_exchange_capacity).
    exchange_capacity: int | None = None
    #: skew headroom of the auto-derivation: a bucket may hold up to
    #: ``skew * max_pairs_local / ndev`` entries before overflowing.
    #: The measured (src, dst) bucket skew of the 6M north-star scene is
    #: <= 2.4 at ndev <= 16 (BASELINE.md round 4, scripts/perf/
    #: exchange_skew.py); 3.0 covers it with margin. Overflow is still
    #: flagged (aux.overflow) and train_cli auto-doubles on it.
    exchange_skew: float = 3.0


def derive_exchange_capacity(
    max_pairs_local: int, ndev: int, skew: float = 3.0
) -> int:
    """Bucket capacity so total exchange buffer = skew * max_pairs_local
    rows per chip: an even tile distribution fills buckets to
    max_pairs_local / ndev; real scenes concentrate entries in central
    tile bands, measured <= 2.4x the even share at the 6M north-star
    config (exchange_skew.py). Always >= CHUNK and CHUNK-aligned (the
    rasterizer reads CHUNK-aligned slices)."""
    even = -(-max_pairs_local // ndev)
    return max(_round_up(int(even * skew), CHUNK), CHUNK)


class _ShardAux(NamedTuple):
    overflow: jnp.ndarray  # () bool — any capacity exceeded on any chip
    num_rendered: jnp.ndarray  # () int32 — total entries across chips


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def render_sharded(
    means3d,
    scales,
    quats_xyzw,
    opacities,
    sh_coeffs,
    camera: "Camera | CameraView",
    mesh: Mesh,
    axis: str = "gs",
    width: int | None = None,
    height: int | None = None,
    bg_color=(0.0, 0.0, 0.0),
    cfg: RenderConfig = RenderConfig(),
    scfg: ShardedRenderConfig = ShardedRenderConfig(),
    sh_degree: int = 3,
    ewa_mode: str = "inria",
):
    """Render one view with gaussians and tiles sharded over ``axis``.

    The gaussian arrays must be sharded (or shardable) along their leading
    axis over ``axis``; P must divide evenly (pad with GaussianScene.pad_to).

    Supports every RenderConfig the single-chip path does (tile 16/32,
    pack_mode chunk/none, tile_cull, use_focal, rect_mode).

    Returns (image (3, H, W) sharded by rows over ``axis``, _ShardAux).
    """
    if isinstance(camera, Camera):
        width, height = camera.width, camera.height
        camera = camera.to_view()
    ndev = mesh.shape[axis]
    if scfg.exchange_capacity is None:
        scfg = dataclasses.replace(
            scfg,
            exchange_capacity=derive_exchange_capacity(
                scfg.max_pairs_local, ndev, scfg.exchange_skew
            ),
        )
    _validate_sharded_cfg(cfg, scfg)
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    rows_per_dev = -(-grid_y // ndev)
    tiles_per_dev = rows_per_dev * grid_x

    p_total = means3d.shape[0]
    if p_total % ndev:
        raise ValueError(f"gaussian count {p_total} not divisible by {ndev}")
    p_shard = p_total // ndev

    fn = functools.partial(
        _render_shard,
        ndev=ndev,
        p_shard=p_shard,
        grid_x=grid_x,
        tiles_per_dev=tiles_per_dev,
        width=width,
        height=height,
        sh_degree=sh_degree,
        cfg=cfg,
        scfg=scfg,
        axis=axis,
        ewa_mode=ewa_mode,
    )
    spec_g = P(axis)
    fn = shard_map(
        fn,
        mesh=mesh,
        in_specs=(spec_g, spec_g, spec_g, spec_g, spec_g, P(), P()),
        out_specs=(P(None, axis, None), P(), P(axis)),
        check_vma=False,
    )
    band, aux, _radii = fn(
        means3d,
        scales,
        quats_xyzw,
        opacities,
        sh_coeffs,
        camera,
        jnp.asarray(bg_color, jnp.float32),
    )
    image = band[:, :height, :width]
    return image, _ShardAux(
        overflow=aux.overflow.reshape(()), num_rendered=aux.num_rendered.reshape(())
    )


def _validate_sharded_cfg(cfg: RenderConfig, scfg: ShardedRenderConfig):
    """Reject configurations that would mis-render instead of failing."""
    if cfg.pack_mode not in ("chunk", "none"):
        raise ValueError(f"unknown pack_mode: {cfg.pack_mode!r}")
    if scfg.exchange_capacity % CHUNK:
        raise ValueError(
            f"exchange_capacity {scfg.exchange_capacity} must be a multiple "
            f"of CHUNK={CHUNK} (the rasterizer reads CHUNK-aligned slices)"
        )
    if cfg.rasterizer != "pallas":
        raise ValueError("the sharded path supports rasterizer='pallas' only")
    if cfg.max_pairs_sorted is not None:
        raise ValueError(
            "max_pairs_sorted is a single-chip option; sharded capacities "
            "are set via ShardedRenderConfig"
        )
    if cfg.sort_mode != "2key":
        raise ValueError(
            "sort_mode is a single-chip option: the sharded path already "
            "uses a 1-key unstable local sort + exact 3-key receiver merge "
            "(strictly cheaper than the fused single-chip key); pass the "
            "default '2key'"
        )
    # cfg.payload_dtype="bf16" moves the payload through the exchange
    # packed as 7 int32 columns (-22% exchange payload bytes; same
    # opacity/rgb rounding as the single-chip bf16 gather) via the
    # composite custom VJP in parallel/exchange_vjp.py.


def _render_shard(
    means3d,
    scales,
    quats,
    opacities,
    sh_coeffs,
    cam_view: CameraView,
    bg,
    *,
    ndev: int,
    p_shard: int,
    grid_x: int,
    tiles_per_dev: int,
    width: int,
    height: int,
    sh_degree: int,
    cfg: RenderConfig,
    scfg: ShardedRenderConfig,
    axis: str,
    ewa_mode: str = "inria",
    active_mask=None,
    means2d_probe=None,
):
    """Per-device body (runs under shard_map).

    Returns (band (3, band_h, W_pad), _ShardAux, radii (p_shard,)).
    active_mask / means2d_probe are the per-shard training hooks (see
    ops.projection.project_gaussians)."""
    dev = jax.lax.axis_index(axis)
    num_tiles_padded = tiles_per_dev * ndev
    tile_w, tile_h = cfg.tile_wh

    # ---- local compute on this chip's gaussian shard -------------------
    from ..ops.render import _selection_opacity

    colors = compute_colors(means3d, sh_coeffs, cam_view.position, sh_degree)
    proj = project_gaussians(
        means3d, scales, quats, cam_view, cfg, ewa_mode=ewa_mode,
        width=width, height=height, active_mask=active_mask,
        means2d_probe=means2d_probe,
        opacities=_selection_opacity(opacities, cfg) if cfg.tight_radius
        else None,
    )

    l_loc = scfg.max_pairs_local
    cull_op = _selection_opacity(opacities, cfg) if cfg.tile_cull else None
    tile_id, depth, gid, total = expand_entries(
        proj, grid_x, num_tiles_padded, l_loc, cull_op, cfg.tile_wh,
        cfg.alpha_min,
    )
    overflow = total > l_loc

    # sort local entries by tile ONLY — owner = tile // tiles_per_dev is
    # monotone in tile, so owner buckets are contiguous slices. The local
    # depth order is irrelevant: the receiver's 3-key merge below fully
    # re-sorts by (tile, depth, gid), so a 1-key unstable sort yields
    # the exact same final order as a stable 2-key sort would.
    sorted_tile, sorted_depth, sorted_gid = jax.lax.sort(
        (tile_id, depth, gid), num_keys=1, is_stable=False
    )

    # per-entry payload columns in the kernel field layout, plus routing
    # metadata; gid becomes global so the receiver can tie-break depth
    # exactly like the single-chip stable sort. One fused row gather from
    # the packed per-gaussian table (see ops.render.gather_payload).
    from ..ops.render import payload_table
    from .exchange_vjp import (
        take_table_rows, slice_buckets, permute_rows, pack_gather,
        exchange_rows_packed,
    )

    valid = sorted_gid >= 0
    table = payload_table(proj, colors, opacities)  # (P_shard, FIELDS)
    # "bf16" moves the payload through the whole exchange PACKED as 7
    # int32 columns (-22% exchange payload bytes; same opacity/rgb rounding
    # as the single-chip bf16 gather) — one composite custom VJP, since
    # cotangents cannot flow through int32 intermediates
    use_packed = cfg.payload_dtype == "bf16"
    if not use_packed:
        # custom VJP: the gradient reduction back to the table is the
        # per-gaussian segment-sum (parallel/exchange_vjp)
        pf = take_table_rows(table, sorted_gid)  # (L, FIELDS)
    # blend ORDER is non-differentiable (standard 3DGS); cut the depth
    # tangent path so the merge sort below never enters the VJP graph
    sorted_depth = jax.lax.stop_gradient(sorted_depth)
    gid_global = jnp.where(valid, sorted_gid + dev * p_shard, -1)

    # ---- bucket by owner chip ------------------------------------------
    bcap = scfg.exchange_capacity
    bounds = jnp.arange(ndev + 1, dtype=jnp.int32) * tiles_per_dev
    cuts = jnp.searchsorted(sorted_tile, bounds, side="left").astype(jnp.int32)
    owner_start = cuts[:-1]  # (ndev,)
    owner_len = cuts[1:] - cuts[:-1]
    overflow |= jnp.any(owner_len > bcap)

    j = jnp.arange(bcap, dtype=jnp.int32)[None, :]  # (1, B)
    src_idx = owner_start[:, None] + j  # (ndev, B)
    bucket_valid = j < owner_len[:, None]
    src_idx = jnp.clip(src_idx, 0, l_loc - 1)

    # custom VJP: buckets are disjoint contiguous slices, so the payload
    # gradient comes back via searchsorted + one row gather
    if not use_packed:
        send_pf = slice_buckets(pf, cuts, bcap)  # (ndev, B, 9)
    send_tile = jnp.where(bucket_valid, jnp.take(sorted_tile, src_idx), -1)
    send_gid = jnp.where(bucket_valid, jnp.take(gid_global, src_idx), -1)
    send_depth = jnp.where(
        bucket_valid, jnp.take(sorted_depth, src_idx), jnp.inf
    )
    send_meta = jnp.stack([send_tile, send_gid], axis=-1)  # (ndev, B, 2) i32

    # ---- the collective: one all-to-all ---------------------------------
    if not use_packed:
        recv_pf = jax.lax.all_to_all(send_pf, axis, 0, 0, tiled=False)
        recv_pf = recv_pf.reshape(ndev * bcap, 9)
    recv_depth = jax.lax.all_to_all(send_depth, axis, 0, 0, tiled=False)
    recv_meta = jax.lax.all_to_all(send_meta, axis, 0, 0, tiled=False)

    recv_depth = recv_depth.reshape(ndev * bcap)
    recv_tile = recv_meta[..., 0].reshape(ndev * bcap)
    recv_gid = recv_meta[..., 1].reshape(ndev * bcap)

    # local tile index within this chip's band; invalid -> sentinel
    ltile = recv_tile - dev * tiles_per_dev
    invalid = recv_gid < 0
    ltile = jnp.where(invalid, tiles_per_dev, ltile)
    recv_depth = jnp.where(invalid, jnp.inf, recv_depth)
    recv_gid_key = jnp.where(invalid, jnp.int32(2**31 - 1), recv_gid)

    # ---- merge: 3-key sort == single-chip stable (tile, depth) order ----
    idx0 = jnp.arange(ndev * bcap, dtype=jnp.int32)
    s_ltile, _sd, _sg, perm = jax.lax.sort(
        (ltile, recv_depth, recv_gid_key, idx0), num_keys=3, is_stable=False
    )
    # custom VJP: the inverse permutation (one 2-operand sort + one row
    # gather) replaces the take-VJP scatter
    if not use_packed:
        s_pf = permute_rows(recv_pf, perm)

    if cfg.pack_mode == "chunk":
        cap_loc = _round_up(ndev * bcap + tiles_per_dev * CHUNK, CHUNK)
        src, in_range, _slot_tile, starts, counts = pack_ranges(
            s_ltile, tiles_per_dev, cap_loc
        )
        # closed-form inverse slot of each sorted entry (defined next to
        # pack_ranges so the layout invariant changes in one place);
        # sentinel-tile entries map past cap_loc -> zero gradient
        slot_of_entry = pack_slot_inverse(
            s_ltile, starts, tiles_per_dev, cap_loc
        )
        if use_packed:
            cols = exchange_rows_packed(
                table, (sorted_gid, cuts, src, in_range, slot_of_entry),
                perm, bcap, axis, "chunk",
            )
        else:
            cols = pack_gather(s_pf, src, in_range, slot_of_entry)
    else:  # "none": raw sorted ranges, read with masked loads
        tids = jnp.arange(tiles_per_dev, dtype=jnp.int32)
        starts = jnp.searchsorted(s_ltile, tids, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(s_ltile, tids, side="right").astype(jnp.int32)
        counts = ends - starts
        if use_packed:
            cols = exchange_rows_packed(
                table, (sorted_gid, cuts), perm, bcap, axis, "none",
            )
        else:
            cols = s_pf
    payload = cols.T  # (FIELDS, capacity)

    # ---- rasterize this chip's band -------------------------------------
    color, trans = rasterize_tiles(
        payload,
        starts,
        counts,
        grid_x,
        width,
        height,
        cfg,
        tile_offset=(dev * tiles_per_dev).reshape(1),
    )
    band_h = tiles_per_dev // grid_x * tile_h
    c = color.reshape(tiles_per_dev // grid_x, grid_x, tile_h, tile_w, 3)
    c = c.transpose(4, 0, 2, 1, 3).reshape(3, band_h, grid_x * tile_w)
    t = trans.reshape(tiles_per_dev // grid_x, grid_x, tile_h, tile_w)
    t = t.transpose(0, 2, 1, 3).reshape(band_h, grid_x * tile_w)
    band = c + bg[:, None, None] * t[None]

    total_all = jax.lax.psum(jnp.minimum(total, l_loc), axis)
    overflow = jax.lax.psum(overflow.astype(jnp.int32), axis) > 0
    aux = _ShardAux(
        overflow=overflow.reshape(1), num_rendered=total_all.reshape(1)
    )
    return band, aux, proj.radius
