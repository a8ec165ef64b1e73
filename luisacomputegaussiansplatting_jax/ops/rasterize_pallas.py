"""Pallas tile rasterizer for the GPU (Triton): forward + backward blending.

Redesign of the reference forward rasterizer
(lcgs/src/gs_tile_splatter/shader.cpp:167-289) plus the backward pass the
reference lacks (README.md:70: forward only).

Design (one program = one tile, as the reference's "block = tile"):

  * The tile's pixels lie along one block axis (tile_w * tile_h: 256 or
    1024) and a step of ``step`` sorted entries along the other. Each step
    loads the entries' nine payload fields with masked loads over the
    tile's range ``[start, start + count)``, so ranges need no alignment
    and a tile never reads a neighbour's entries.
  * The sequential dependence of front-to-back compositing
    (T *= 1 - alpha) is restructured as a *cumulative log-transmittance*
    along the step axis:
      S[p, j] = sum_{k<=j} log(1 - alpha[p, k])       (jnp.cumsum)
    so the only loop left is over steps.
  * Blend-rule parity with the reference (shader.cpp:249-274): alpha =
    min(0.99, opacity * exp(power)), contributions skipped when power > 0
    or alpha < 1/255, and blending stops for a pixel once its
    transmittance would fall below 1e-4. Because transmittance is
    monotonically non-increasing, "stop at gaussian j*" is exactly the
    per-entry predicate T_in * exp(S[j]) >= 1e-4 — no sequential scan
    needed.
  * Early tile termination: the step loop exits once every pixel in the
    tile is saturated (the reference's per-pixel `done` flag, aggregated
    per tile).

The backward kernel replays the forward step loop and computes analytic
gradients w.r.t. every payload field. The key identity that avoids a
back-to-front second pass: for pixel p,

  sum_{k>j} w_k b_k  =  dot(C_p, G_p) - sum_{k<=j} w_k b_k

where C_p is the *final* pre-background colour (a forward residual),
G_p = dL/dC_p, w_k the blend weights and b_k = dot(c_k, G_p). So a single
front-to-back replay with a carried prefix accumulator yields

  dL/dalpha_j = T_before_j * b_j
                - (suffix_wb_j + T_final * dL/dT_final) / (1 - alpha_j).

Each program writes the gradients of its own tile's entries only, with
masked stores, so programs never share an output element and the grid
runs in any order. Entries that no tile owns are left unwritten; binning
gives every such entry ``gid < 0`` and the gradient reduction drops it.

Memory layout:
  * payload: (FIELDS=9, capacity) float32, field-major. Rows:
    [0] mean_x_px [1] mean_y_px [2] conic_a [3] conic_b [4] conic_c
    [5] opacity (0 marks padding) [6] r [7] g [8] b.
    Entries are sorted by (tile, depth) (binning.py).
  * tile outputs: (num_tiles, 4, tile_w*tile_h) rows [r, g, b, T];
    backward residual (num_tiles, 8, tile_w*tile_h) rows [dL/dC rgb,
    dL/dT, C_final rgb, T_final]: every kernel access is one contiguous
    row of pixels.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import backend
from ..config import RenderConfig

FIELDS = 9  # payload rows (mean xy, conic abc, opacity, rgb)


@dataclasses.dataclass(frozen=True)
class Launch:
    """Triton launch shape of one blend kernel."""

    #: sorted entries blended per loop step (a power of two)
    step: int
    num_warps: int


#: (pixels per tile, "fwd" | "bwd") -> Launch, chosen on an H100 by
#: scripts/perf/gpu_breakdown.py's sweep at the 2M/1080p headline scene
#: (PERF.md): one entry per step won at both tile sizes — the
#: reference's sequential per-pixel loop (shader.cpp:249-274), with
#: fewer live values per thread than any wider step.
LAUNCH = {
    (256, "fwd"): Launch(step=1, num_warps=2),
    (256, "bwd"): Launch(step=1, num_warps=2),
    (1024, "fwd"): Launch(step=1, num_warps=4),
    (1024, "bwd"): Launch(step=1, num_warps=2),
}


def _tile_dims(cfg: RenderConfig):
    """(tile_w, tile_h, pixels-per-tile)."""
    tw, th = cfg.tile_wh
    pix = tw * th
    if pix & (pix - 1):
        raise ValueError(f"tile_w * tile_h = {pix} must be a power of two")
    return tw, th, pix


def _launch(pix: int, kind: str, launch: Launch | None) -> Launch:
    if launch is not None:
        return launch
    return LAUNCH.get((pix, kind)) or LAUNCH[(256 if pix <= 256 else 1024,
                                              kind)]


def _pixel_coords(tile_idx, grid_x: int, width: int, height: int,
                  tile_w: int, tile_h: int):
    """Global (x, y) pixel coordinates of a tile's pixels as (pix, 1),
    plus the initial transmittance (1 in-image, 0 for pixels hanging past
    the image edge — the reference's `inside` predicate,
    gs_tile_splatter/shader.cpp:195-196, which also feeds tile
    early-out)."""
    pix = tile_w * tile_h
    tile_y = tile_idx // grid_x
    tile_x = tile_idx - tile_y * grid_x
    p = jnp.arange(pix, dtype=jnp.int32)[:, None]
    ix = tile_x * tile_w + p % tile_w
    iy = tile_y * tile_h + p // tile_w
    inside = (ix < width) & (iy < height)
    return ix.astype(jnp.float32), iy.astype(jnp.float32), jnp.where(
        inside, 1.0, 0.0)


def _load_step(payload_ref, start, end, c, step: int):
    """The nine payload fields of entries [start + c*step, +step) as
    (step,) vectors; lanes at or past ``end`` read 0 (opacity 0 never
    contributes). Also returns the lane mask."""
    off = start + c * step
    mask = off + jnp.arange(step, dtype=jnp.int32) < end
    fields = [
        plgpu.load(payload_ref.at[f, pl.ds(off, step)], mask=mask, other=0.0)
        for f in range(FIELDS)
    ]
    return fields, mask


def _step_blend(fields, px, py, t_in, cfg: RenderConfig, need_report=True):
    """Shared forward math for one step.

    Args:
      fields: FIELDS (step,) payload vectors from _load_step.
      px, py: (pix, 1) pixel coordinates.
      t_in: (pix, 1) incoming CHAIN transmittance — the product of
        (1 - alpha) over every previous live entry, applied or not (see
        t_chain below). Before the first rejected entry this equals the
        applied-only transmittance; after one it is < transmittance_eps
        forever, which is exactly what keeps the reference's per-pixel
        `done` latch sticky across steps (shader.cpp:257-266 sets done
        and stops WITHOUT applying the entry that would cross eps).

    Returns dict of (pix, step) / (pix, 1) intermediates. Carry contract
    for the step loops: feed `t_chain` into the next step's t_in; report
    `t_last` (the last APPLIED value, the reference's output T) only
    where `has_applied`, else keep the previous report. Both carries
    agree until the first rejection, after which nothing is ever applied
    again (chain < eps and monotone non-increasing), so weights computed
    from the chain are exact for every applied entry.
    """
    mx, my, ca, cb, cc, op = (f[None, :] for f in fields[:6])
    dx = mx - px  # (pix, step)
    dy = my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha_raw = op * jnp.exp(power)
    clamped = alpha_raw > cfg.alpha_max
    alpha = jnp.minimum(alpha_raw, cfg.alpha_max)
    live = (power <= 0.0) & (alpha >= cfg.alpha_min)
    alpha = jnp.where(live, alpha, 0.0)

    log1ma = jnp.log1p(-alpha)
    s_inc = jnp.cumsum(log1ma, axis=1)  # inclusive prefix, entry axis
    t_after = t_in * jnp.exp(s_inc)
    # t_before = t_in * exp(s_inc - log1ma) == t_after / (1 - alpha):
    # one division instead of a second transcendental per pair
    t_before = t_after / (1.0 - alpha)
    applied = (t_after >= cfg.transmittance_eps) & (alpha > 0.0)
    w = jnp.where(applied, t_before * alpha, 0.0)
    # chain over ALL live entries (applied or not): the sticky-done
    # carry. t_after is non-increasing along the step axis (a float sum
    # of non-positive terms never grows), so its min is its last column.
    t_chain = jnp.min(t_after, axis=1, keepdims=True)
    out = dict(alpha=alpha, clamped=clamped, applied=applied, w=w,
               t_before=t_before, t_chain=t_chain, dx=dx, dy=dy)
    if need_report:
        out["has_applied"] = jnp.max(
            jnp.where(applied, 1.0, 0.0), axis=1, keepdims=True) > 0.0
        out["t_last"] = jnp.min(
            jnp.where(applied, t_after, t_in), axis=1, keepdims=True)
    return out


# ---------------------------------------------------------------------------
# forward kernel
# ---------------------------------------------------------------------------


def _forward_kernel(starts_ref, counts_ref, offset_ref, payload_ref, out_ref,
                    *, grid_x: int, width: int, height: int,
                    cfg: RenderConfig, step: int):
    tile = pl.program_id(0)
    start = starts_ref[tile]
    end = start + counts_ref[tile]
    n_steps = (end - start + step - 1) // step
    tw, th, pix = _tile_dims(cfg)
    # tile-sharded strips: offset_ref[0] is this shard's first global tile
    px, py, t0 = _pixel_coords(offset_ref[0] + tile, grid_x, width, height,
                               tw, th)

    def cond(carry):
        c, _tc, _to, _cr, _cg, _cb, chain_max = carry
        # once every pixel's chain is below eps nothing can ever apply
        # again (the chain is monotone non-increasing): the reference's
        # sticky done latch, tile-wide
        return (c < n_steps) & (chain_max >= cfg.transmittance_eps)

    def body(carry):
        c, t_chain, t_out, cr, cg, cb, _m = carry
        fields, _ = _load_step(payload_ref, start, end, c, step)
        f = _step_blend(fields, px, py, t_chain, cfg)
        w = f["w"]
        cr = cr + jnp.sum(w * fields[6][None, :], axis=1, keepdims=True)
        cg = cg + jnp.sum(w * fields[7][None, :], axis=1, keepdims=True)
        cb = cb + jnp.sum(w * fields[8][None, :], axis=1, keepdims=True)
        # carry split (see _step_blend): chain gates, last-applied reports
        t_out = jnp.where(f["has_applied"], f["t_last"], t_out)
        t_chain = f["t_chain"]
        return (c + 1, t_chain, t_out, cr, cg, cb, jnp.max(t_chain))

    zeros = jnp.zeros((pix, 1), jnp.float32)
    init = (jnp.int32(0), t0, t0, zeros, zeros, zeros, jnp.float32(1.0))
    _c, _tc, t_fin, cr, cg, cb, _ = jax.lax.while_loop(cond, body, init)
    for k, v in enumerate((cr, cg, cb, t_fin)):
        out_ref[tile, k, :] = v.reshape(pix)


def _offset_arg(tile_offset):
    if tile_offset is None:
        return jnp.zeros((1,), jnp.int32)
    return tile_offset


def rasterize_forward(payload, tile_starts, tile_counts, grid_x: int,
                      width: int, height: int, cfg: RenderConfig,
                      tile_offset=None, launch: Launch | None = None):
    """Run the forward kernel.

    Args:
      payload: (FIELDS, capacity) float32, entries sorted by (tile, depth).
      tile_starts/tile_counts: (num_tiles,) int32 range of each tile.
      grid_x: tiles per row.
      tile_offset: optional (1,) int32 — global index of this shard's
        first tile (tile-sharded strips); defaults to 0.
      launch: Triton launch shape (default: LAUNCH for this tile size).

    Returns:
      (num_tiles, 4, tile_w*tile_h) float32 rows [r, g, b, T].
    """
    num_tiles = tile_starts.shape[0]
    _tw, _th, pix = _tile_dims(cfg)
    lp = _launch(pix, "fwd", launch)
    kernel = functools.partial(_forward_kernel, grid_x=grid_x, width=width,
                               height=height, cfg=cfg, step=lp.step)
    return pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_shape=jax.ShapeDtypeStruct((num_tiles, 4, pix), jnp.float32),
        name="blend_forward",
        **backend.pallas_call_kwargs(lp.num_warps),
    )(tile_starts, tile_counts, _offset_arg(tile_offset), payload)


# ---------------------------------------------------------------------------
# backward kernel
# ---------------------------------------------------------------------------


def _backward_kernel(starts_ref, counts_ref, offset_ref, payload_ref, res_ref,
                     grads_ref, *, grid_x: int, width: int, height: int,
                     cfg: RenderConfig, step: int):
    """res_ref rows per tile: [0:3] dL/dC, [3] dL/dT, [4:7] C_final,
    [7] T_final, each (pix,)."""
    tile = pl.program_id(0)
    start = starts_ref[tile]
    end = start + counts_ref[tile]
    n_steps = (end - start + step - 1) // step
    tw, th, pix = _tile_dims(cfg)
    px, py, t0 = _pixel_coords(offset_ref[0] + tile, grid_x, width, height,
                               tw, th)

    g_r, g_g, g_b, g_t, c_r, c_g, c_b, t_fin = (
        res_ref[tile, k, :][:, None] for k in range(8))
    # total sum_k w_k b_k over the whole tile == dot(C_final, G) per pixel
    cg_total = c_r * g_r + c_g * g_g + c_b * g_b
    tail = t_fin * g_t  # T_final * dL/dT_final

    def store_step(c, values, mask):
        off = start + c * step
        for k, v in enumerate(values):
            plgpu.store(grads_ref.at[k, pl.ds(off, step)], v, mask=mask)

    def cond(carry):
        c, _t, _p, chain_max = carry
        # post-saturation steps receive exactly zero gradients (applied
        # is False for every pixel), so stop like the forward pass does
        return (c < n_steps) & (chain_max >= cfg.transmittance_eps)

    def body(carry):
        c, t_chain, prefix, _m = carry  # (pix, 1), (pix, 1)
        fields, mask = _load_step(payload_ref, start, end, c, step)
        f = _step_blend(fields, px, py, t_chain, cfg, need_report=False)
        alpha, w, applied = f["alpha"], f["w"], f["applied"]
        dx, dy = f["dx"], f["dy"]
        _mx, _my, ca, cb, cc, op, r, g, b = fields

        bdot = g_r * r[None, :] + g_g * g[None, :] + g_b * b[None, :]
        wb = w * bdot
        suffix = cg_total - (prefix + jnp.cumsum(wb, axis=1))
        d_alpha = f["t_before"] * bdot - (suffix + tail) / (1.0 - alpha)
        # alpha = min(alpha_max, opacity * g): zero grad where clamped
        d_alpha = jnp.where(applied & jnp.logical_not(f["clamped"]),
                            d_alpha, 0.0)
        d_pow = d_alpha * alpha  # d(alpha)/d(power) = opacity * g = alpha

        # power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy with dx = mx - px:
        # pixel sums of d_pow against [1, dx, dy, dx^2, dx dy, dy^2]
        pdx = d_pow * dx
        pdy = d_pow * dy
        s0 = jnp.sum(d_pow, axis=0)
        sdx = jnp.sum(pdx, axis=0)
        sdy = jnp.sum(pdy, axis=0)
        sxx = jnp.sum(pdx * dx, axis=0)
        sxy = jnp.sum(pdx * dy, axis=0)
        syy = jnp.sum(pdy * dy, axis=0)
        d_mx = -(ca * sdx + cb * sdy)
        d_my = -(cc * sdy + cb * sdx)
        # sum_p d_alpha * g == sum_p d_pow / op (alpha = op*g where live)
        d_op = jnp.where(op > 0.0, s0 / jnp.where(op > 0.0, op, 1.0), 0.0)
        d_r = jnp.sum(w * g_r, axis=0)
        d_g = jnp.sum(w * g_g, axis=0)
        d_b = jnp.sum(w * g_b, axis=0)
        store_step(c, (d_mx, d_my, -0.5 * sxx, -sxy, -0.5 * syy, d_op,
                       d_r, d_g, d_b), mask)

        t_new = f["t_chain"]
        prefix_new = prefix + jnp.sum(wb, axis=1, keepdims=True)
        return (c + 1, t_new, prefix_new, jnp.max(t_new))

    init = (jnp.int32(0), t0, jnp.zeros((pix, 1), jnp.float32),
            jnp.float32(1.0))
    c_f, _t, _p, _m = jax.lax.while_loop(cond, body, init)

    # entries past an early exit still own their slots: zero gradients
    def zero_body(c, carry):
        off = start + c * step
        mask = off + jnp.arange(step, dtype=jnp.int32) < end
        store_step(c, [jnp.zeros((step,), jnp.float32)] * FIELDS, mask)
        return carry

    jax.lax.fori_loop(c_f, n_steps, zero_body, jnp.int32(0))


def rasterize_backward(payload, tile_starts, tile_counts, residual,
                       grid_x: int, width: int, height: int,
                       cfg: RenderConfig, tile_offset=None,
                       launch: Launch | None = None):
    """Run the backward kernel.

    Args:
      residual: (num_tiles, 8, tile_w*tile_h): rows
        [dC rgb, dT, C_final rgb, T_final].

    Returns:
      (FIELDS, capacity) float32 per-entry gradients (payload layout);
      entries outside every tile's range are unwritten garbage — callers
      must drop entries with gid < 0 (binning guarantees they receive no
      gradient).
    """
    num_tiles = tile_starts.shape[0]
    _tw, _th, pix = _tile_dims(cfg)
    lp = _launch(pix, "bwd", launch)
    kernel = functools.partial(_backward_kernel, grid_x=grid_x, width=width,
                               height=height, cfg=cfg, step=lp.step)
    return pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        out_shape=jax.ShapeDtypeStruct(payload.shape, jnp.float32),
        name="blend_backward",
        **backend.pallas_call_kwargs(lp.num_warps),
    )(tile_starts, tile_counts, _offset_arg(tile_offset), payload, residual)


# ---------------------------------------------------------------------------
# custom-vjp wrapper
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6))
def rasterize_tiles(payload, tile_starts, tile_counts, grid_x: int,
                    width: int, height: int, cfg: RenderConfig,
                    tile_offset=None):
    """Differentiable tile rasterization.

    Returns (color (num_tiles, tile_w*tile_h, 3), transmittance
    (num_tiles, tile_w*tile_h, 1)); tile_w*tile_h follows cfg.tile_wh.
    Gradients flow to ``payload`` only (binning indices are structural).
    """
    out = rasterize_forward(payload, tile_starts, tile_counts, grid_x,
                            width, height, cfg, tile_offset)
    return _split_out(out)


def _split_out(out):
    out = jnp.swapaxes(out, 1, 2)  # (num_tiles, pix, 4)
    return out[:, :, 0:3], out[:, :, 3:4]


def _rasterize_fwd(payload, tile_starts, tile_counts, grid_x, width, height,
                   cfg, tile_offset=None):
    color, trans = rasterize_tiles(payload, tile_starts, tile_counts, grid_x,
                                   width, height, cfg, tile_offset)
    return (color, trans), (payload, tile_starts, tile_counts, tile_offset,
                            color, trans)


def _rasterize_bwd(grid_x, width, height, cfg, res, cotangents):
    payload, tile_starts, tile_counts, tile_offset, color, trans = res
    d_color, d_trans = cotangents
    residual = jnp.swapaxes(
        jnp.concatenate([d_color, d_trans, color, trans], axis=2), 1, 2)
    d_payload = rasterize_backward(payload, tile_starts, tile_counts,
                                   residual, grid_x, width, height, cfg,
                                   tile_offset)
    zero_int = np.zeros((), dtype=jax.dtypes.float0)
    d_starts = np.broadcast_to(zero_int, tile_starts.shape)
    d_counts = np.broadcast_to(zero_int, tile_counts.shape)
    d_offset = None
    if tile_offset is not None:
        d_offset = np.broadcast_to(zero_int, tile_offset.shape)
    return d_payload, d_starts, d_counts, d_offset


rasterize_tiles.defvjp(_rasterize_fwd, _rasterize_bwd)
