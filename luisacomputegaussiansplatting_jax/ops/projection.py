"""Gaussian preprocessing: world -> screen projection, conic, tile rects.

Fusion of two reference kernels into one differentiable jnp
stage (XLA fuses the whole thing into a handful of VPU loops):
  * GSProjector forward (lcgs/src/gs_projector/shader.cpp:82-139, the
    default focal variant): view/clip transform, near cull, Sigma_3D,
    frustum-clamped EWA -> 2D covariance in pixel units.
  * The analytic first half of shad_allocate_tiles
    (lcgs/src/gs_tile_splatter/shader.cpp:102-163): low-pass, conic,
    radius, NDC->pixel, tile rect and touched-tile count.

Instead of the reference's in-place buffer overwrites (covs_2d becomes the
conic, means_2d becomes pixel coords, shader.cpp:159-161) all results are
returned as fresh functional outputs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import TILE, RenderConfig
from ..utils.camera import Camera, CameraView
from ..utils.gaussian import (
    clamp_to_frustum_comps,
    conic_and_radius_comps,
    covariance_3d_elems,
    ewa_project_cov_comps,
    view_rotate_cov_elems,
)
from ..utils.packing import stack_cols, unstack_cols
from ..utils.transform import ndc2pix


class ProjectedGaussians(NamedTuple):
    """Per-gaussian screen-space quantities (all shape (N, ...))."""

    means2d: jnp.ndarray  # (N, 2) pixel-space centres
    depth: jnp.ndarray  # (N,) view-space z
    conic: jnp.ndarray  # (N, 3) packed inverse 2D covariance (A, B, C)
    radius: jnp.ndarray  # (N,) int32 splat radius in pixels (0 = culled)
    rect_min: jnp.ndarray  # (N, 2) int32 inclusive tile-rect min (x, y)
    rect_max: jnp.ndarray  # (N, 2) int32 exclusive tile-rect max (x, y)
    tiles_touched: jnp.ndarray  # (N,) int32 number of tiles overlapped
    valid: jnp.ndarray  # (N,) bool: survives near cull & touches tiles


def _tile_wh(tile) -> tuple[int, int]:
    """Normalize an int (square) or (w, h) tile spec."""
    if isinstance(tile, tuple):
        return tile
    return tile, tile


def tile_grid(
    width: int, height: int, tile: "int | tuple" = TILE, tile_h: int | None = None
) -> tuple[int, int]:
    """(grid_x, grid_y) tile counts for an image size."""
    tw, th = _tile_wh(tile)
    th = tile_h or th
    return (width + tw - 1) // tw, (height + th - 1) // th


def _tile_rect(means2d, radius, grid_x: int, grid_y: int, mode: str, tile=TILE):
    """Tile rectangle [min, max) covered by a splat disc.

    mode "lcgs" reproduces reference lcgs/src/module.cpp:29-35 (clamps the
    exclusive max to grid-1, so the last tile row/column never receives
    splats); mode "inria" clamps to grid like the graphdeco rasterizer.
    """
    tw, th = _tile_wh(tile)
    r = radius.astype(jnp.float32)
    lo_x = jnp.floor((means2d[..., 0] - r) / tw).astype(jnp.int32)
    lo_y = jnp.floor((means2d[..., 1] - r) / th).astype(jnp.int32)
    hi_x = jnp.floor((means2d[..., 0] + r + tw - 1) / tw).astype(jnp.int32)
    hi_y = jnp.floor((means2d[..., 1] + r + th - 1) / th).astype(jnp.int32)
    if mode == "lcgs":
        max_lo, max_hi = grid_x - 1, grid_x - 1
        may_lo, may_hi = grid_y - 1, grid_y - 1
    elif mode == "inria":
        max_lo, max_hi = grid_x - 1, grid_x
        may_lo, may_hi = grid_y - 1, grid_y
    else:
        raise ValueError(f"unknown rect_mode: {mode!r}")
    rect_min = jnp.stack(
        [jnp.clip(lo_x, 0, max_lo), jnp.clip(lo_y, 0, may_lo)], axis=-1
    )
    rect_max = jnp.stack(
        [jnp.clip(hi_x, 0, max_hi), jnp.clip(hi_y, 0, may_hi)], axis=-1
    )
    return rect_min, rect_max


def project_gaussians(
    means3d,
    scales,
    quats_xyzw,
    camera: "Camera | CameraView",
    cfg: RenderConfig = RenderConfig(),
    scale_modifier: float = 1.0,
    ewa_mode: str = "inria",
    width: int | None = None,
    height: int | None = None,
    active_mask=None,
    means2d_probe=None,
    opacities=None,
) -> ProjectedGaussians:
    """Project gaussians into screen space and bin-precompute tile rects.

    Args:
      means3d: (N, 3) world centres.
      scales: (N, 3) exp-activated scales.
      quats_xyzw: (N, 4) unit quaternions (x, y, z, w).
      camera: a static Camera, or a traced CameraView (then width/height
        must be given).
      cfg: pipeline constants.
      scale_modifier: global multiplier on scales
        (reference gs_projector/shader.cpp:128).
      ewa_mode: see utils.gaussian.ewa_project_cov.
      active_mask: optional (N,) bool; False rows are culled outright
        (static-capacity training: retired slots must not even be binned,
        since the +lowpass covariance floor gives every gaussian a
        nonzero pixel radius).
      means2d_probe: optional (N, 2) zeros added to the pixel-space
        centres; its gradient is the screen-space positional gradient the
        densification policy accumulates (graphdeco's viewspace_grad).
      opacities: optional (N,) activated opacities; with
        cfg.tight_radius, shrinks each splat's pixel radius from the
        reference's fixed 3 sigma (shader.cpp:139-148) to
        min(radius_sigma, sqrt(2 ln(o / alpha_min))) sigma — the EXACT
        reach of the alpha >= alpha_min test the blend kernel applies
        per pixel (shader.cpp:257-266), so the rendered image is
        identical up to float reduction order while low-opacity
        splats touch fewer tiles
        (fewer expansion slots + shorter sorts). Ignored when
        cfg.tight_radius is False.
    """
    if isinstance(camera, Camera):
        width, height = camera.width, camera.height
        camera = camera.to_view()
    if width is None or height is None:
        raise ValueError("width/height are required with a CameraView")
    view = camera.view
    view3 = view[:3, :3]
    tan_fovx, tan_fovy = camera.tan_fovx, camera.tan_fovy
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    # All math below is component-wise over (N,) vectors: the VPU-native
    # form, fused by XLA into a few elementwise passes, with no f32[N, 1]
    # intermediates in the VJP (see utils/packing.py for why that matters).
    mx, my, mz = unstack_cols(means3d)
    px = mx * view3[0, 0] + my * view3[0, 1] + mz * view3[0, 2] + view[0, 3]
    py = mx * view3[1, 0] + my * view3[1, 1] + mz * view3[1, 2] + view[1, 3]
    depth = mx * view3[2, 0] + my * view3[2, 1] + mz * view3[2, 2] + view[2, 3]
    in_front = depth >= cfg.near

    # NDC via the projection matrix: x_ndc = x /(tanfovx * z), with the
    # reference's +1e-6 on w (gs_projector/shader.cpp:116).
    safe_z = jnp.where(in_front, depth, 1.0)
    inv_w = 1.0 / (safe_z + cfg.w_eps)
    pix_x = ndc2pix(px / tan_fovx * inv_w, width)
    pix_y = ndc2pix(py / tan_fovy * inv_w, height)
    if means2d_probe is not None:
        prx, pry = unstack_cols(means2d_probe)
        pix_x = pix_x + prx
        pix_y = pix_y + pry
    means2d = stack_cols(pix_x, pix_y)

    sx, sy, sz = unstack_cols(scales)
    if scale_modifier != 1.0:
        sx, sy, sz = sx * scale_modifier, sy * scale_modifier, sz * scale_modifier
    qx, qy, qz, qw = unstack_cols(quats_xyzw)
    cov3d = covariance_3d_elems((sx, sy, sz), (qx, qy, qz, qw))
    sigma_view = view_rotate_cov_elems(cov3d, view3, ewa_mode)
    tx, ty, tz = clamp_to_frustum_comps(
        px, py, safe_z, tan_fovx, tan_fovy, cfg.frustum_clamp
    )
    if cfg.use_focal:
        a, b, c = ewa_project_cov_comps(
            sigma_view, tx, ty, tz, focal_x, focal_y
        )
    else:
        # shad_project_gs (gs_projector/shader.cpp:18-80): unit-focal
        # Jacobian, rescaled to NDC units here, then the "rescale-later"
        # half from allocate_tiles (gs_tile_splatter/shader.cpp:132-138,
        # use_focal=false branch) — applied in the reference's two-step
        # order, including its cov.z res.y*res.x quirk (see config).
        a, b, c = ewa_project_cov_comps(sigma_view, tx, ty, tz, 1.0, 1.0)
        a = a * (1.0 / (tan_fovx * tan_fovx))
        b = b * (1.0 / (tan_fovx * tan_fovy))
        c = c * (1.0 / (tan_fovy * tan_fovy))
        a = a * (width * width * 0.25)
        b = b * (width * height * 0.25)
        c = c * (height * width * 0.25)
    tight_sigma = None
    if cfg.tight_radius and opacities is not None:
        # exact alpha_min reach (see docstring); no gradient flows into
        # the integer radius anyway, but cut the tangent path explicitly
        o = jax.lax.stop_gradient(opacities.reshape(-1))
        tight_sigma = jnp.sqrt(jnp.maximum(
            2.0 * jnp.log(jnp.maximum(o, 1e-12) / cfg.alpha_min), 0.0
        ))
        tight_sigma = jnp.where(o > cfg.alpha_min, tight_sigma, 0.0)
    (ca, cb, cc), radius = conic_and_radius_comps(
        a, b, c, cfg.lowpass, cfg.radius_sigma, cfg.det_eps, tight_sigma
    )
    conic = stack_cols(ca, cb, cc)
    radius = jnp.where(in_front, radius, 0)
    if active_mask is not None:
        radius = jnp.where(active_mask, radius, 0)

    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    rect_min, rect_max = _tile_rect(
        means2d, radius, grid_x, grid_y, cfg.rect_mode, cfg.tile_wh
    )
    tiles_touched = jnp.maximum(rect_max[..., 0] - rect_min[..., 0], 0) * jnp.maximum(
        rect_max[..., 1] - rect_min[..., 1], 0
    )
    tiles_touched = jnp.where(radius > 0, tiles_touched, 0).astype(jnp.int32)
    valid = tiles_touched > 0

    return ProjectedGaussians(
        means2d=means2d,
        depth=depth,
        conic=conic,
        radius=radius,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles_touched,
        valid=valid,
    )
