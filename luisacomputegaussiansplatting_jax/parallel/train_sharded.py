"""Multi-chip 3DGS training step: view data-parallelism x gaussian/tile
sharding on a 2D mesh ("data", "gs").

Layout:
  * GaussianParams / optimizer state: sharded over "gs" (each gs-group of
    chips owns P/n_gs gaussians), replicated over "data".
  * Camera batch + target images: sharded over "data" (views) and over
    "gs" (image tile-row bands, matching render_sharded's output layout).
  * Forward/backward: render via the all-to-all exchange over "gs";
    photometric loss psum'd over both axes; parameter gradients psum'd
    over "data" only (over "gs" each shard's grads are already local —
    the transposed all-to-all routed them home).
  * Loss: the full 3DGS (1-w)*L1 + w*D-SSIM. SSIM's 11x11 window crosses
    band seams, so each device ppermute-exchanges a 5-row halo with its
    band neighbours (one send up, one send down) and blurs
    the extended band; the cropped SSIM map equals the single-chip map
    exactly (band edges at the true image border see the same zero
    padding the single-chip SAME conv uses).

This is the analog of the reference's missing distributed
layer (SURVEY.md section 2: "Parallelism inventory: NONE in reference").
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..models.gaussians import GaussianParams
from ..models.losses import ssim_map
from ..models.trainer import TrainConfig, TrainState, make_optimizer
from ..ops.projection import tile_grid
from ..utils.camera import CameraView
from .render_sharded import (
    ShardedRenderConfig, _render_shard, derive_exchange_capacity,
)

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

#: SSIM window half-width: rows of halo each band needs from its neighbours
_HALO = 5


def _exchange_band_halos(x, axis: str, n_dev: int, halo: int = _HALO):
    """(C, band_h, W) -> (C, band_h + 2*halo, W) with neighbour rows.

    Device d's band covers image rows [d*band_h, (d+1)*band_h); the rows
    above live on d-1 (its last `halo` rows), below on d+1. Edge devices
    receive zeros — exactly the single-chip SAME-conv zero padding.
    """
    up = jax.lax.ppermute(
        x[:, -halo:, :], axis, [(i, i + 1) for i in range(n_dev - 1)]
    )
    down = jax.lax.ppermute(
        x[:, :halo, :], axis, [(i + 1, i) for i in range(n_dev - 1)]
    )
    return jnp.concatenate([up, x, down], axis=1)


def _band_photometric_sums(band, target_band, dev_gs, *, axis, n_gs,
                           band_h, width, height):
    """Masked (l1_sum, ssim_sum) of one band vs its target band.

    Sums over valid pixels only; divide by 3*H*W after the psum to get
    the single-chip means exactly.
    """
    # one halo exchange for pred+target stacked on the channel axis
    both = jnp.concatenate([band, target_band], axis=0)  # (6, band_h, W)
    ext = _exchange_band_halos(both, axis, n_gs)
    smap = ssim_map(ext[:3], ext[3:])[:, _HALO:_HALO + band_h, :]

    rows = dev_gs * band_h + jnp.arange(band_h)
    mask = (
        (rows < height).astype(jnp.float32)[None, :, None]
        * (jnp.arange(band.shape[2]) < width).astype(jnp.float32)[None, None, :]
    )
    l1_sum = jnp.sum(jnp.abs(band - target_band) * mask)
    ssim_sum = jnp.sum(smap * mask)
    return l1_sum, ssim_sum


def make_sharded_train_step(
    mesh: Mesh,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    scfg: ShardedRenderConfig = ShardedRenderConfig(),
    sh_degree: int = 3,
    tc: TrainConfig = TrainConfig(),
    bg_color=(0.0, 0.0, 0.0),
    data_axis: str = "data",
    gs_axis: str = "gs",
    ewa_mode: str = "inria",
    densify: bool = False,
):
    """Build (step_fn, opt, shardings) for the 2D-mesh training step.

    step_fn(state, cam_views, targets) -> (state, loss, overflow):
      cam_views: CameraView pytree with a leading view-batch axis V
        (V divisible by mesh.shape[data_axis]).
      targets: (V, 3, H_pad, W_pad) with H_pad = band-aligned height
        (pad_targets below) and W_pad = tile-aligned width.

    With densify=True, step_fn(state, dstate, cam_views, targets) ->
    (state, dstate, loss, overflow): dstate is a DensifyState at the
    full capacity C (arrays shardable over gs); screen-space probe
    gradients, visibility counts and max radii are accumulated exactly
    like the single-chip make_batched_train_step.
    """
    from ..models.densify import DensifyState

    n_data = mesh.shape[data_axis]
    n_gs = mesh.shape[gs_axis]
    if scfg.exchange_capacity is None:
        import dataclasses

        scfg = dataclasses.replace(
            scfg,
            exchange_capacity=derive_exchange_capacity(
                scfg.max_pairs_local, n_gs, scfg.exchange_skew
            ),
        )
    tile_w, tile_h = cfg.tile_wh
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    rows_per_dev = -(-grid_y // n_gs)
    tiles_per_dev = rows_per_dev * grid_x
    band_h = rows_per_dev * tile_h
    w_pad = grid_x * tile_w
    opt = make_optimizer(tc)
    bg = jnp.asarray(bg_color, jnp.float32)

    def local_step(params, opt_state, step_no, active, cam_views, targets):
        """Per-device body. params: gaussian shard; active: (P_shard,)
        bool or None; cam_views: V_loc local views; targets:
        (V_loc, 3, band_h, w_pad) local image bands."""
        dev_gs = jax.lax.axis_index(gs_axis)
        v_loc = targets.shape[0]
        p_shard = params.means.shape[0]
        # one probe PER local view: graphdeco accumulates per-view
        # ||dL_v/d means2d||; a shared probe would norm the view-summed
        # gradient (understated ~V-fold with cancellation) — same fix as
        # models/trainer.make_batched_train_step
        probe = jnp.zeros((v_loc, p_shard, 2), jnp.float32)

        def loss_fn(p: GaussianParams, probe):
            scene = p.activate()

            def one_view(cam_view, target_band, pr):
                band, aux, radii = _render_shard(
                    scene.means,
                    scene.scales,
                    scene.quats,
                    scene.opacities,
                    scene.sh,
                    cam_view,
                    bg,
                    ndev=n_gs,
                    p_shard=p_shard,
                    grid_x=grid_x,
                    tiles_per_dev=tiles_per_dev,
                    width=width,
                    height=height,
                    sh_degree=sh_degree,
                    cfg=cfg,
                    scfg=scfg,
                    axis=gs_axis,
                    ewa_mode=ewa_mode,
                    active_mask=active,
                    means2d_probe=pr,
                )
                l1_sum, ssim_sum = _band_photometric_sums(
                    band, target_band, dev_gs, axis=gs_axis, n_gs=n_gs,
                    band_h=band_h, width=width, height=height,
                )
                return l1_sum, ssim_sum, aux.overflow, radii

            l1_tot = jnp.float32(0.0)
            ssim_tot = jnp.float32(0.0)
            overflow = jnp.zeros((1,), bool)
            radii_max = jnp.zeros((p_shard,), jnp.int32)
            vis_count = jnp.zeros((p_shard,), jnp.float32)
            for v in range(v_loc):  # static, small per-device view count
                cam_v = jax.tree.map(lambda x: x[v], cam_views)
                l1_v, ssim_v, ov, radii = one_view(
                    cam_v, targets[v], probe[v]
                )
                l1_tot = l1_tot + l1_v
                ssim_tot = ssim_tot + ssim_v
                overflow = overflow | ov
                radii_max = jnp.maximum(radii_max, radii)
                vis_count = vis_count + (radii > 0).astype(jnp.float32)
            # single-chip means over all pixels / views across the mesh
            denom = 3.0 * height * width * v_loc * n_data
            l1_mean = jax.lax.psum(l1_tot, (data_axis, gs_axis)) / denom
            ssim_mean = jax.lax.psum(ssim_tot, (data_axis, gs_axis)) / denom
            loss = (1.0 - tc.ssim_weight) * l1_mean + tc.ssim_weight * (
                1.0 - ssim_mean
            )
            return loss, (overflow, radii_max, vis_count)

        (loss, (overflow, radii_max, vis_count)), (grads, probe_grad) = (
            jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
                params, probe
            )
        )
        # params are replicated over the data axis -> psum their grads;
        # over gs each shard's grads are already complete and local
        grads = jax.lax.pmean(grads, data_axis)
        updates, new_opt = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        overflow = jax.lax.psum(overflow.astype(jnp.int32), data_axis) > 0
        # densification statistics (graphdeco accumulates over every view
        # the gaussian was seen in; views live on the data axis)
        radii_max = jax.lax.pmax(radii_max, data_axis)
        vis_count = jax.lax.psum(vis_count, data_axis)
        from ..models.densify import ndc_grad_norm

        # probe_grad[v] = dL/d probe_v = (1/V) x view v's own gradient
        # (the loss is the V-view mean, V = v_loc * n_data): undo the
        # scaling, norm PER VIEW, sum local views, psum over data
        g_local = ndc_grad_norm(
            probe_grad * jnp.float32(v_loc * n_data), width, height
        )  # (v_loc, p_shard)
        g_norm = jax.lax.psum(jnp.sum(g_local, axis=0), data_axis)
        seen = vis_count > 0
        stats = (jnp.where(seen, g_norm, 0.0), vis_count, radii_max)
        return new_params, new_opt, step_no + 1, loss.reshape(1), overflow, stats

    spec_gs = P(gs_axis)

    def _leaf_spec(x):
        # optimizer-state scalars (e.g. Adam step counts) stay replicated
        return spec_gs if getattr(x, "ndim", 0) >= 1 else P()

    _cache = {}

    def _compiled(opt_state):
        key = jax.tree.structure(opt_state)
        if key not in _cache:
            opt_specs = jax.tree.map(_leaf_spec, opt_state)
            fn = shard_map(
                local_step,
                mesh=mesh,
                in_specs=(
                    spec_gs,
                    opt_specs,
                    P(),
                    spec_gs if densify else P(),
                    P(data_axis),
                    P(data_axis, None, gs_axis, None),
                ),
                out_specs=(
                    spec_gs, opt_specs, P(), P(), P(),
                    (spec_gs, spec_gs, spec_gs),
                ),
                check_vma=False,
            )
            _cache[key] = jax.jit(fn)
        return _cache[key]

    if densify:
        def step_fn(state: TrainState, dstate, cam_views, targets):
            fn = _compiled(state.opt_state)
            new_params, new_opt, new_step, loss, overflow, stats = fn(
                state.params, state.opt_state, state.step, dstate.active,
                cam_views, targets,
            )
            g_norm, vis, radii = stats
            new_dstate = DensifyState(
                grad_sum=dstate.grad_sum + g_norm,
                count=dstate.count + vis,
                max_radii=jnp.maximum(dstate.max_radii, radii),
                active=dstate.active,
            )
            return (
                TrainState(new_params, new_opt, new_step),
                new_dstate,
                loss.reshape(())[()],
                overflow.reshape(())[()],
            )
    else:
        def step_fn(state: TrainState, cam_views, targets):
            fn = _compiled(state.opt_state)
            new_params, new_opt, new_step, loss, overflow, _stats = fn(
                state.params, state.opt_state, state.step, None,
                cam_views, targets,
            )
            return (
                TrainState(new_params, new_opt, new_step),
                loss.reshape(())[()],
                overflow.reshape(())[()],
            )

    def pad_targets(targets):
        """(V, 3, H, W) -> band/tile aligned (V, 3, band_h*n_gs, w_pad)."""
        v = targets.shape[0]
        h_pad = band_h * n_gs
        out = jnp.zeros((v, 3, h_pad, w_pad), jnp.float32)
        return out.at[:, :, :height, :width].set(targets)

    return step_fn, opt, pad_targets
