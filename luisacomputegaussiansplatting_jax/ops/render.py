"""End-to-end differentiable render: the whole frame as one jittable graph.

Equivalent of the reference per-frame hot path (app/main.cpp:266-308 ->
SHProcessor.process + GSProjector.forward + GSTileSplatter.forward) but with
no host synchronisation at all: the reference performs 4 stream synchronises
plus a device->host readback of num_rendered *per frame*
(gs_tile_splatter/impl.cpp:100-146); here static capacities keep everything
inside a single XLA program, and the backward pass (absent in the
reference) falls out of jax.grad through the custom-vjp rasterizer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TILE, RenderConfig
from ..utils.camera import Camera, CameraView
from ..utils.packing import stack_cols, unstack_cols
from .binning import BinnedGaussians, bin_gaussians, bin_gaussians_nopack
from .projection import ProjectedGaussians, project_gaussians, tile_grid
from .rasterize_pallas import FIELDS, rasterize_tiles
from .rasterize_ref import rasterize_reference
from .sh_eval import compute_colors


class RenderAux(NamedTuple):
    """Side outputs of a render (diagnostics / densification statistics)."""

    radii: jnp.ndarray  # (N,) int32 splat radius (0 = culled)
    transmittance: jnp.ndarray  # (H, W) final per-pixel transmittance
    num_rendered: jnp.ndarray  # () int32 expanded entry count
    overflow: jnp.ndarray  # () bool capacity exceeded
    means2d: jnp.ndarray  # (N, 2) pixel-space centres (for position grads)


def _selection_opacity(opacities, cfg):
    """Opacity as the ENTRY-SELECTION stages must see it.

    tight_radius reach and the expansion tile cull decide which entries
    exist from ``alpha = o * exp(power) >= alpha_min``; the blend kernel
    decides the same inequality from the PAYLOAD opacity, which under
    payload_dtype="bf16" is bf16-rounded. An o within one bf16 ulp of a
    reach boundary would make the two disagree (entries culled that the
    blend accepts, or kept that it rejects), breaking the options'
    output-exactness guarantee — so selection uses the rounded value the
    kernel will actually blend."""
    if cfg.payload_dtype == "bf16":
        return opacities.astype(jnp.bfloat16).astype(jnp.float32)
    return opacities


def payload_table(proj: ProjectedGaussians, colors, opacities):
    """(N, FIELDS) row-major per-gaussian payload table (differentiable).

    Row layout matches the kernel field order (rasterize_pallas.py docstring).
    """
    mx, my = unstack_cols(proj.means2d)
    ca, cb, cc = unstack_cols(proj.conic)
    r, g, b = unstack_cols(colors)
    cols = stack_cols(
        mx, my, ca, cb, cc, opacities.reshape(-1), r, g, b
    ).astype(jnp.float32)
    assert cols.shape[1] == FIELDS
    return cols


def _pack_table7(table):
    """(N, 9) f32 -> (N, 7) int32: mean/conic keep their f32 bits;
    (opacity, r) and (g, b) pack as bf16 pairs."""

    def fbits(x):
        return jax.lax.bitcast_convert_type(x, jnp.int32)

    def h16(x):
        return jax.lax.bitcast_convert_type(
            x.astype(jnp.bfloat16), jnp.uint16
        ).astype(jnp.int32)

    cols = [fbits(table[:, i]) for i in range(5)]
    cols.append((h16(table[:, 5]) << 16) | h16(table[:, 6]))
    cols.append((h16(table[:, 7]) << 16) | h16(table[:, 8]))
    return jnp.stack(cols, axis=1)


def _unpack_rows7(rows):
    """(capacity, 7) int32 -> (capacity, FIELDS) f32 (_pack_table7 inverse).

    ALL unpack work stays in gather-row space (elementwise bitcasts +
    one column-slice concat, which XLA fuses into a single loop fusion);
    the caller does ONE wholesale transpose afterwards — the same shape
    discipline as the f32 path. Slicing per-field rows out of a
    logically-transposed view instead makes XLA rematerialize the full
    (7, capacity) transpose+copy once per field."""
    f32c = jax.lax.bitcast_convert_type(rows, jnp.float32)
    hi = jax.lax.bitcast_convert_type(
        (rows >> 16).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    lo = jax.lax.bitcast_convert_type(
        rows.astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    return jnp.concatenate(
        [f32c[:, 0:5], hi[:, 5:6], lo[:, 5:6], hi[:, 6:7], lo[:, 6:7]],
        axis=1,
    )


@jax.named_scope("grad_reduce")
def reduce_rows_by_id(gid, rows, n_out: int):
    """Per-gaussian gradient reduction: (L,) gid in [-1, n_out) + (L, F)
    rows -> (n_out, F) sums. Rows with gid < 0 are dropped exactly —
    their values (unwritten backward-kernel slots) are never read into
    a sum. XLA lowers the scatter-add to atomics on the GPU, the idiom
    of a CUDA 3DGS backward; the summation order within a gaussian is
    not fixed."""
    valid = gid >= 0
    return jax.ops.segment_sum(
        jnp.where(valid[:, None], rows, 0.0),
        jnp.where(valid, gid, n_out),
        num_segments=n_out,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
@jax.named_scope("payload_gather")
def gather_payload(table, entry_gid, n_rows: int, payload_dtype: str = "f32"):
    """(N, FIELDS) table + (capacity,) gid -> (FIELDS, capacity) payload.

    One fused row gather instead of one gather per field. With
    payload_dtype="bf16" the row shrinks to 7 int32 columns (see
    RenderConfig.payload_dtype).

    VJP: the per-entry cotangent rows are summed per gaussian
    (reduce_rows_by_id); padding slots (gid < 0) are dropped exactly,
    never accumulated into gaussian 0.
    """
    safe = jnp.maximum(entry_gid, 0)
    valid = entry_gid >= 0
    if payload_dtype == "bf16":
        packed = _pack_table7(table)  # (N, 7) int32
        rows = jnp.take(packed, safe, axis=0)  # (capacity, 7)
        rows = jnp.where(valid[:, None], rows, 0)
        return _unpack_rows7(rows).T  # (FIELDS, capacity) f32
    if payload_dtype != "f32":
        raise ValueError(f"unknown payload_dtype: {payload_dtype!r}")
    rows = jnp.take(table, safe, axis=0)  # (capacity, FIELDS)
    return jnp.where(valid[:, None], rows, 0.0).T


def _gather_payload_fwd(table, entry_gid, n_rows: int,
                        payload_dtype: str = "f32"):
    return gather_payload(table, entry_gid, n_rows, payload_dtype), entry_gid


def _gather_payload_bwd(n_rows, payload_dtype, entry_gid, d_payload):
    d_table = reduce_rows_by_id(entry_gid, d_payload.T, n_rows)
    d_gid = np.broadcast_to(
        np.zeros((), dtype=jax.dtypes.float0), entry_gid.shape
    )
    return d_table, d_gid


gather_payload.defvjp(_gather_payload_fwd, _gather_payload_bwd)


def build_payload(
    proj: ProjectedGaussians,
    colors,
    opacities,
    binned: BinnedGaussians,
    payload_dtype: str = "f32",
):
    """Gather the (FIELDS, capacity) field-major payload (differentiable).

    payload_dtype: row width/precision of the forward gather (see
    RenderConfig.payload_dtype).
    """
    table = payload_table(proj, colors, opacities)
    return gather_payload(
        table, binned.entry_gid, table.shape[0], payload_dtype
    )


def _tiles_to_image(color, trans, grid_x: int, grid_y: int, width: int, height: int, tile=TILE):
    """(num_tiles, tile_w*tile_h, C) -> (C, H, W) crop."""
    from .projection import _tile_wh

    tw, th = _tile_wh(tile)

    def reshape(x):
        c = x.shape[2]
        x = x.reshape(grid_y, grid_x, th, tw, c)
        x = x.transpose(4, 0, 2, 1, 3).reshape(c, grid_y * th, grid_x * tw)
        return x[:, :height, :width]

    return reshape(color), reshape(trans)[0]


def prepare_view(
    means3d,
    scales,
    quats_xyzw,
    opacities,
    sh_coeffs,
    cam_view: CameraView,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    ewa_mode: str = "inria",
    active_mask=None,
    means2d_probe=None,
):
    """Everything before the blend: SH colours, projection, binning and
    the payload gather. Returns (proj, binned, payload, grid_x, grid_y);
    ``payload`` is the (FIELDS, capacity) rasterizer input for
    ``binned``'s tile ranges."""
    colors = compute_colors(means3d, sh_coeffs, cam_view.position, sh_degree)
    proj = project_gaussians(
        means3d,
        scales,
        quats_xyzw,
        cam_view,
        cfg,
        scale_modifier,
        ewa_mode,
        width=width,
        height=height,
        active_mask=active_mask,
        means2d_probe=means2d_probe,
        opacities=_selection_opacity(opacities, cfg) if cfg.tight_radius
        else None,
    )
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    cull_op = _selection_opacity(opacities, cfg) if cfg.tile_cull else None
    if cfg.pack_mode == "chunk":
        binner = bin_gaussians
    elif cfg.pack_mode == "none":
        binner = bin_gaussians_nopack
    else:
        raise ValueError(f"unknown pack_mode: {cfg.pack_mode!r}")
    binned = binner(
        proj, grid_x, grid_y, cfg.max_pairs, cull_op, cfg.tile_wh,
        cfg.alpha_min, cfg.max_pairs_sorted, cfg.sort_mode,
    )
    payload = build_payload(proj, colors, opacities, binned,
                            cfg.payload_dtype)
    return proj, binned, payload, grid_x, grid_y


def render_view(
    means3d,
    scales,
    quats_xyzw,
    opacities,
    sh_coeffs,
    cam_view: CameraView,
    width: int,
    height: int,
    bg_color=(0.0, 0.0, 0.0),
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    ewa_mode: str = "inria",
    active_mask=None,
    means2d_probe=None,
):
    """Render with a traced CameraView (vmap-able over view batches).

    active_mask / means2d_probe: training hooks, see
    ops.projection.project_gaussians.

    Returns (image (3, H, W), RenderAux)."""
    proj, binned, payload, grid_x, grid_y = prepare_view(
        means3d, scales, quats_xyzw, opacities, sh_coeffs, cam_view, width,
        height, cfg, sh_degree, scale_modifier, ewa_mode, active_mask,
        means2d_probe,
    )
    if cfg.rasterizer == "pallas":
        color, trans = rasterize_tiles(
            payload,
            binned.tile_starts,
            binned.tile_counts,
            grid_x,
            width,
            height,
            cfg,
        )
    elif cfg.rasterizer == "jnp":
        color, trans = rasterize_reference(
            payload, binned, grid_x, width, height, cfg
        )
    else:
        raise ValueError(f"unknown rasterizer: {cfg.rasterizer!r}")

    img_c, img_t = _tiles_to_image(
        color, trans, grid_x, grid_y, width, height, cfg.tile_wh
    )
    bg = jnp.asarray(bg_color, jnp.float32)
    image = img_c + bg[:, None, None] * img_t[None, :, :]

    aux = RenderAux(
        radii=proj.radius,
        transmittance=img_t,
        num_rendered=binned.num_rendered,
        overflow=binned.overflow,
        means2d=proj.means2d,
    )
    return image, aux


def render_aux(
    means3d,
    scales,
    quats_xyzw,
    opacities,
    sh_coeffs,
    camera: Camera,
    bg_color=(0.0, 0.0, 0.0),
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    ewa_mode: str = "inria",
):
    """Render a view; returns (image (3, H, W) in [0,1]-ish, RenderAux).

    All gaussian inputs are the *activated* parameters:
      means3d (N,3), scales (N,3) exp'd, quats_xyzw (N,4) normalised,
      opacities (N,) sigmoided, sh_coeffs (N, K, 3).
    Differentiable w.r.t. every gaussian input and bg_color.
    """
    return render_view(
        means3d,
        scales,
        quats_xyzw,
        opacities,
        sh_coeffs,
        camera.to_view(),
        camera.width,
        camera.height,
        bg_color,
        cfg,
        sh_degree,
        scale_modifier,
        ewa_mode,
    )


def render(
    means3d,
    scales,
    quats_xyzw,
    opacities,
    sh_coeffs,
    camera: Camera,
    bg_color=(0.0, 0.0, 0.0),
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    scale_modifier: float = 1.0,
    ewa_mode: str = "inria",
):
    """Like render_aux but returns only the (3, H, W) image."""
    image, _ = render_aux(
        means3d,
        scales,
        quats_xyzw,
        opacities,
        sh_coeffs,
        camera,
        bg_color,
        cfg,
        sh_degree,
        scale_modifier,
        ewa_mode,
    )
    return image
