"""Single-chip 3DGS training step (the capability the reference lacks:
doc/roadmap.md lists "Support Training" as unchecked future work).

Follows the graphdeco recipe: Adam with per-parameter-group learning
rates, photometric (1-w)*L1 + w*D-SSIM loss, activations applied inside
the jitted step (raw params are the optimised pytree).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from .. import backend
from ..config import RenderConfig
from ..ops.render import render_view
from ..utils.camera import CameraView
from .gaussians import GaussianParams
from .losses import d_ssim_l1_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Learning rates per parameter group (graphdeco defaults).

    The position (means) learning rate follows graphdeco's exponential
    decay from lr_means to lr_means_final over lr_means_decay_steps
    (their get_expon_lr_func), with both endpoints multiplied by
    spatial_lr_scale — set it to the scene extent (graphdeco's
    cameras_extent) so positions move at a world-scale-appropriate rate.
    Set lr_means_decay_steps=0 for a constant rate.
    """

    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_means_decay_steps: int = 30_000
    #: graphdeco's spatial_lr_scale (scene extent); multiplies the
    #: means lr endpoints. 1.0 = unit-scale scenes.
    spatial_lr_scale: float = 1.0
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 5e-2
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 2.5e-3 / 20.0
    ssim_weight: float = 0.2
    adam_eps: float = 1e-15


def make_optimizer(tc: TrainConfig = TrainConfig()) -> optax.GradientTransformation:
    """Per-group Adam, matching 3DGS's per-tensor learning rates."""

    def adam(lr):
        return optax.adam(lr, eps=tc.adam_eps)

    sls = tc.spatial_lr_scale
    if tc.lr_means_decay_steps > 0:
        means_lr = optax.exponential_decay(
            init_value=tc.lr_means * sls,
            transition_steps=tc.lr_means_decay_steps,
            decay_rate=tc.lr_means_final / tc.lr_means,
            end_value=tc.lr_means_final * sls,
        )
        adam_means = optax.adam(means_lr, eps=tc.adam_eps)
    else:
        adam_means = adam(tc.lr_means * sls)

    labels = GaussianParams(
        means="means",
        log_scales="scales",
        quats="quats",
        opacity_logits="opacity",
        sh_dc="sh_dc",
        sh_rest="sh_rest",
    )
    return optax.multi_transform(
        {
            "means": adam_means,
            "scales": adam(tc.lr_scales),
            "quats": adam(tc.lr_quats),
            "opacity": adam(tc.lr_opacity),
            "sh_dc": adam(tc.lr_sh_dc),
            "sh_rest": adam(tc.lr_sh_rest),
        },
        labels,
    )


class TrainState(NamedTuple):
    params: GaussianParams
    opt_state: optax.OptState
    step: jnp.ndarray


def init_train_state(params: GaussianParams, tc: TrainConfig = TrainConfig()):
    opt = make_optimizer(tc)
    return TrainState(params=params, opt_state=opt.init(params), step=jnp.int32(0)), opt


def photometric_loss(
    params: GaussianParams,
    cam_view: CameraView,
    target,  # (3, H, W)
    width: int,
    height: int,
    bg_color,
    cfg: RenderConfig,
    sh_degree: int,
    ssim_weight: float,
):
    scene = params.activate()
    img, aux = render_view(
        scene.means,
        scene.scales,
        scene.quats,
        scene.opacities,
        scene.sh,
        cam_view,
        width,
        height,
        bg_color,
        cfg,
        sh_degree,
    )
    return d_ssim_l1_loss(img, target, ssim_weight), (img, aux)


def make_train_step(
    opt: optax.GradientTransformation,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    tc: TrainConfig = TrainConfig(),
    bg_color=(0.0, 0.0, 0.0),
):
    """Jitted single-view training step:
    (state, cam_view, target) -> (state, loss, aux)."""

    @functools.partial(jax.jit, donate_argnums=backend.donate_argnums(0))
    def step(state: TrainState, cam_view: CameraView, target):
        (loss, (_img, aux)), grads = jax.value_and_grad(
            photometric_loss, has_aux=True
        )(
            state.params,
            cam_view,
            target,
            width,
            height,
            bg_color,
            cfg,
            sh_degree,
            tc.ssim_weight,
        )
        updates, new_opt = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        return (
            TrainState(new_params, new_opt, state.step + 1),
            loss,
            aux,
        )

    return step


def make_densify_train_step(
    opt: optax.GradientTransformation,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    tc: TrainConfig = TrainConfig(),
    bg_color=(0.0, 0.0, 0.0),
):
    """Training step that also accumulates adaptive-density statistics.

    The graphdeco recipe needs the *screen-space* positional gradient per
    gaussian; it is obtained through a zero-valued means2d probe added in
    projection (ops/projection.py), whose gradient IS dL/d(means2d) in
    pixel units. Retired capacity slots are culled via the active mask.

    Returns step(state, dstate, cam_view, target) ->
    (state, dstate, loss, aux)."""
    from .densify import DensifyState, accumulate_stats

    @functools.partial(jax.jit, donate_argnums=backend.donate_argnums(0))
    def step(state: TrainState, dstate: DensifyState, cam_view: CameraView, target):
        probe = jnp.zeros((state.params.means.shape[0], 2), jnp.float32)

        def loss_fn(params: GaussianParams, probe):
            scene = params.activate()
            img, aux = render_view(
                scene.means,
                scene.scales,
                scene.quats,
                scene.opacities,
                scene.sh,
                cam_view,
                width,
                height,
                bg_color,
                cfg,
                sh_degree,
                active_mask=dstate.active,
                means2d_probe=probe,
            )
            return d_ssim_l1_loss(img, target, tc.ssim_weight), (img, aux)

        (loss, (_img, aux)), (grads, probe_grad) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(state.params, probe)
        updates, new_opt = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_dstate = accumulate_stats(
            dstate, probe_grad, aux.radii, width, height
        )
        return (
            TrainState(new_params, new_opt, state.step + 1),
            new_dstate,
            loss,
            aux,
        )

    return step


def make_batched_train_step(
    opt: optax.GradientTransformation,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    sh_degree: int = 3,
    tc: TrainConfig = TrainConfig(),
    bg_color=(0.0, 0.0, 0.0),
):
    """Densify-aware step over a BATCH of views (vmapped render).

    Several views per step amortise the per-step dispatch and fill the
    device; graphdeco trains one view per step because its CUDA
    rasterizer is single-view. Densification stats: probe-grad norms are
    summed over the batch, visibility counts add 1 per view seen,
    max radii take the batch max.

    Returns step(state, dstate, views, targets) with views a stacked
    CameraView pytree (B, ...) and targets (B, 3, H, W).
    """
    from .densify import DensifyState

    @functools.partial(jax.jit, donate_argnums=backend.donate_argnums(0))
    def step(state: TrainState, dstate, views: CameraView, targets):
        n = state.params.means.shape[0]
        n_views = targets.shape[0]
        # per-view probes: graphdeco accumulates ||dL_v/d means2d|| per
        # VIEW; a single shared probe would yield the norm of the
        # batch-summed gradient — understated ~B-fold (plus cross-view
        # cancellation), silently starving densification at B > 1
        probe = jnp.zeros((n_views, n, 2), jnp.float32)

        def loss_fn(params: GaussianParams, probe):
            scene = params.activate()

            def one(view, target, pr):
                img, aux = render_view(
                    scene.means,
                    scene.scales,
                    scene.quats,
                    scene.opacities,
                    scene.sh,
                    view,
                    width,
                    height,
                    bg_color,
                    cfg,
                    sh_degree,
                    active_mask=dstate.active,
                    means2d_probe=pr,
                )
                return (
                    d_ssim_l1_loss(img, target, tc.ssim_weight),
                    (aux.radii, aux.overflow),
                )

            losses, (radii, overflow) = jax.vmap(one)(views, targets, probe)
            return jnp.mean(losses), (radii, jnp.any(overflow))

        (loss, (radii, overflow)), (grads, probe_grad) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(state.params, probe)
        updates, new_opt = opt.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)

        from .densify import ndc_grad_norm

        visible = radii > 0  # (B, N)
        # probe_grad[v] = (1/B) * dL_v/d probe (the loss is the batch
        # mean); undo the 1/B so each view's norm matches a graphdeco
        # single-view step, then sum per-view norms
        g = ndc_grad_norm(
            probe_grad * jnp.float32(n_views), width, height
        )  # (B, N)
        g_sum = jnp.sum(jnp.where(visible, g, 0.0), axis=0)
        new_dstate = DensifyState(
            grad_sum=dstate.grad_sum + g_sum,
            count=dstate.count + jnp.sum(visible, axis=0).astype(jnp.float32),
            max_radii=jnp.maximum(dstate.max_radii, jnp.max(radii, axis=0)),
            active=dstate.active,
        )
        return (
            TrainState(new_params, new_opt, state.step + 1),
            new_dstate,
            loss,
            overflow,
        )

    return step
