"""Adaptive density control (clone / split / prune) at static capacity.

The reference renderer has no training at all (doc/roadmap.md lists it as
unchecked future work), so this module follows the original graphdeco 3DGS
recipe — the de-facto behaviour a 3DGS user expects:

  * accumulate the screen-space positional gradient norm and visibility
    count per gaussian between densification rounds;
  * every ``interval`` steps: CLONE small high-gradient gaussians (copy,
    both keep moving), SPLIT large high-gradient ones into children
    sampled from the parent (scales / 1.6, parent retired), and PRUNE
    gaussians with opacity below ``min_opacity`` or overly large radii;
  * periodically reset all opacities toward zero.

Static-shape design: the parameter pytree lives at a FIXED capacity C with
an ``active`` mask — densification never reshapes anything, it rewrites
rows. Retired/never-born rows are fully culled in projection via the
mask (ops/projection.py active_mask), so they cost no binning entries.
New children are scattered into free slots located with one argsort;
Adam moments of every non-survivor row are reset to zero (children
always land in non-survivor slots), matching graphdeco's optimizer
surgery. The whole round is one jitted function.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .gaussians import GaussianParams


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """graphdeco-default thresholds (their train.py / gaussian_model.py)."""

    #: screen-space grad-norm threshold, in graphdeco's NDC-scaled
    #: units (their 2e-4 default): the trainers accumulate probe grads
    #: through ndc_grad_norm (pixel grad x W/2, H/2), so this value is
    #: exact graphdeco parity and resolution-independent.
    grad_threshold: float = 2e-4
    #: fraction of the scene extent below which a gaussian is "small"
    #: (cloned) rather than "large" (split).
    percent_dense: float = 0.01
    #: children per split and the scale shrink factor. graphdeco couples
    #: the shrink to the child count (0.8 * N so the children's combined
    #: opacity mass stays under the parent's); None derives it, an
    #: explicit float overrides.
    split_children: int = 2
    split_scale_shrink: float | None = None
    #: prune gaussians whose opacity falls below this.
    min_opacity: float = 0.005
    #: prune gaussians whose max screen radius exceeded this many pixels
    #: (0 disables, as in graphdeco before step 3000).
    max_screen_radius: int = 0
    #: prune gaussians larger than this fraction of the scene extent
    #: (0 disables).
    max_world_scale_frac: float = 0.1
    #: opacity ceiling applied by reset_opacity.
    reset_opacity_to: float = 0.01

    @property
    def split_shrink(self) -> float:
        if self.split_scale_shrink is not None:
            return self.split_scale_shrink
        return 0.8 * self.split_children


class DensifyInfo(NamedTuple):
    """Per-round densification counters (the observability graphdeco's
    train.py gets from its grow/prune prints)."""

    overflow: jnp.ndarray  # () bool — children dropped (capacity full)
    n_cloned: jnp.ndarray  # () int32
    n_split: jnp.ndarray  # () int32
    n_pruned: jnp.ndarray  # () int32 — opacity/size prunes (not split retirees)


class DensifyState(NamedTuple):
    grad_sum: jnp.ndarray  # (C,) f32: sum of ||d L / d means2d||
    count: jnp.ndarray  # (C,) f32: rounds the gaussian was visible
    max_radii: jnp.ndarray  # (C,) i32: max screen radius since last round
    active: jnp.ndarray  # (C,) bool

    @property
    def num_active(self):
        return jnp.sum(self.active.astype(jnp.int32))


def init_densify_state(n_active: int, capacity: int) -> DensifyState:
    if n_active > capacity:
        raise ValueError(f"{n_active} gaussians > capacity {capacity}")
    return DensifyState(
        grad_sum=jnp.zeros((capacity,), jnp.float32),
        count=jnp.zeros((capacity,), jnp.float32),
        max_radii=jnp.zeros((capacity,), jnp.int32),
        active=jnp.arange(capacity) < n_active,
    )


def ndc_grad_norm(probe_grad, width=None, height=None):
    """||dL/d means2d|| in graphdeco's NDC-scaled units.

    The probe gradient (ops/projection.py means2d_probe) is in PIXEL
    units; graphdeco's densify threshold (2e-4) applies to gradients
    w.r.t. half-screen NDC coordinates — their rasterizer backward
    multiplies the pixel-space gradient by W/2, H/2
    (diff-gaussian-rasterization backward.cu dL_dmean2D). Scaling here
    makes DensifyConfig.grad_threshold=2e-4 exact graphdeco parity AND
    resolution-independent (an unscaled pixel-unit threshold shrinks
    ~W/2-fold: at 200px the p99.9 avg grad measures ~4e-5 — below any
    fixed pixel threshold, so growth never triggered).

    width/height None keeps raw pixel units (unit tests).
    """
    g = probe_grad
    if width is not None:
        g = g * jnp.asarray(
            [width * 0.5, (height or width) * 0.5], g.dtype
        )
    return jnp.sqrt(jnp.sum(g * g, axis=-1))


def accumulate_stats(
    state: DensifyState, probe_grad, radii, width=None, height=None
) -> DensifyState:
    """Fold one training step's stats in.

    Args:
      probe_grad: (C, 2) gradient of the loss w.r.t. the pixel-space
        means2d probe (see ops/projection.py means2d_probe).
      radii: (C,) int32 screen radii from RenderAux (0 = not visible).
      width/height: render resolution; when given, the grad norm is
        accumulated in graphdeco's NDC-scaled units (see ndc_grad_norm)
        so grad_threshold defaults carry across resolutions.
    """
    visible = radii > 0
    g = ndc_grad_norm(probe_grad, width, height)
    return DensifyState(
        grad_sum=state.grad_sum + jnp.where(visible, g, 0.0),
        count=state.count + visible.astype(jnp.float32),
        max_radii=jnp.maximum(state.max_radii, radii),
        active=state.active,
    )


def densify_step(
    params: GaussianParams,
    opt_state,
    state: DensifyState,
    key,
    scene_extent: float,
    cfg: DensifyConfig = DensifyConfig(),
):
    """One densify-and-prune round (jittable; static capacity).

    Args:
      params: GaussianParams at capacity C.
      opt_state: optax state from models.trainer.make_optimizer (Adam
        moments of all rewritten rows are zeroed).
      key: PRNG key for split sampling.
      scene_extent: world-space scene radius (graphdeco: camera extent).

    Returns:
      (params, opt_state, DensifyState, DensifyInfo): stats reset;
      info.overflow is True if children were dropped because capacity
      ran out; the counters record this round's clone/split/prune sizes.
    """
    from ..utils.transform import rotation_from_quaternion

    c = params.means.shape[0]
    active = state.active
    avg_grad = state.grad_sum / jnp.maximum(state.count, 1.0)
    scales = jnp.exp(params.log_scales)
    scale_max = jnp.max(scales, axis=1)
    opacity = jax.nn.sigmoid(params.opacity_logits)

    high_grad = active & (avg_grad > cfg.grad_threshold) & (state.count > 0)
    small = scale_max <= cfg.percent_dense * scene_extent
    prune = active & (opacity < cfg.min_opacity)
    # size pruning is gated on max_screen_radius like graphdeco (enabled
    # there only after step 3000, and the world-size prune rides with it)
    if cfg.max_screen_radius > 0:
        prune |= active & (state.max_radii > cfg.max_screen_radius)
        if cfg.max_world_scale_frac > 0:
            prune |= active & (
                scale_max > cfg.max_world_scale_frac * scene_extent
            )
    clone = high_grad & small & ~prune
    want_split = high_grad & ~small & ~prune

    # ---- split-placement gate (capacity-safe) ---------------------------
    # A split retires its parent, so a parent whose children cannot ALL
    # be placed must NOT split — otherwise the highest-gradient content
    # is deleted outright at full capacity. Gate conservatively against
    # the free-slot count WITHOUT any split retirement (other retiring
    # splits only ADD free slots, so a parent that fits under this bound
    # fits under the final count too); demoted parents stay alive
    # unchanged and are retried next round.
    n_free0 = jnp.sum(jnp.logical_not(active & ~prune).astype(jnp.int32))
    kids_per0 = (
        clone.astype(jnp.int32)
        + want_split.astype(jnp.int32) * cfg.split_children
    )
    kid_end0 = jnp.cumsum(kids_per0)
    split = want_split & (kid_end0 <= n_free0)

    # a split parent is retired after emitting its children
    survivors = active & ~prune & ~split

    # ---- free-slot allocation -------------------------------------------
    # free slots ascending (one argsort); the k-th child takes free_ids[k]
    _, free_ids = jax.lax.sort(
        (survivors.astype(jnp.int32), jnp.arange(c, dtype=jnp.int32)),
        num_keys=1,
        is_stable=True,
    )
    n_free = jnp.sum(jnp.logical_not(survivors).astype(jnp.int32))

    kids_per = clone.astype(jnp.int32) + split.astype(jnp.int32) * cfg.split_children
    kid_end = jnp.cumsum(kids_per)
    kid_start = kid_end - kids_per
    # clones beyond capacity are dropped (parent survives); demoted
    # splits count as overflow too so callers grow capacity
    overflow = (kid_end[-1] > n_free) | jnp.any(want_split & ~split)

    # split children: positions ~ N(mean, Sigma) via quat-rotated scaled
    # normals (graphdeco gaussian_model.densify_and_split)
    kmax = cfg.split_children
    eps = jax.random.normal(key, (c, kmax, 3), jnp.float32)
    qn = params.quats / jnp.clip(
        jnp.linalg.norm(params.quats, axis=1, keepdims=True), 1e-12
    )
    rot = rotation_from_quaternion(qn)  # (C, 3, 3)
    offsets = jnp.einsum("nij,nkj->nki", rot, eps * scales[:, None, :])
    split_means = params.means[:, None, :] + offsets  # (C, kmax, 3)
    split_log_scales = params.log_scales - jnp.log(cfg.split_shrink)

    new_params = params
    new_active = survivors

    for ci in range(kmax):
        src = GaussianParams(
            means=jnp.where(split[:, None], split_means[:, ci, :], params.means),
            log_scales=jnp.where(
                split[:, None], split_log_scales, params.log_scales
            ),
            quats=params.quats,
            opacity_logits=params.opacity_logits,
            sh_dc=params.sh_dc,
            sh_rest=params.sh_rest,
        )
        has_kid = (clone | split) if ci == 0 else split
        rank = kid_start + ci
        ok = has_kid & (rank < n_free)
        dest = jnp.where(ok, jnp.take(free_ids, jnp.clip(rank, 0, c - 1)), c)

        def scatter(dst_arr, src_arr, dest=dest):
            return dst_arr.at[dest].set(src_arr, mode="drop")

        new_params = jax.tree.map(scatter, new_params, src)
        new_active = new_active.at[dest].set(True, mode="drop")

    # Adam-moment surgery: children always land in non-survivor slots, so
    # zeroing every non-survivor row resets exactly the rewritten rows.
    opt_state = _zero_adam_moments_where(opt_state, jnp.logical_not(survivors))

    # park retired rows: transparent + tiny (belt over the active mask)
    parked = jnp.logical_not(new_active)
    new_params = new_params._replace(
        opacity_logits=jnp.where(parked, -15.0, new_params.opacity_logits),
        log_scales=jnp.where(parked[:, None], -18.0, new_params.log_scales),
    )

    fresh = DensifyState(
        grad_sum=jnp.zeros((c,), jnp.float32),
        count=jnp.zeros((c,), jnp.float32),
        max_radii=jnp.zeros((c,), jnp.int32),
        active=new_active,
    )
    info = DensifyInfo(
        overflow=overflow,
        n_cloned=jnp.sum(clone.astype(jnp.int32)),
        n_split=jnp.sum(split.astype(jnp.int32)),
        n_pruned=jnp.sum(prune.astype(jnp.int32)),
    )
    return new_params, opt_state, fresh, info


def reset_opacity(
    params: GaussianParams,
    state: DensifyState,
    cfg: DensifyConfig = DensifyConfig(),
    opt_state=None,
):
    """Clamp every active opacity to at most ``reset_opacity_to``
    (graphdeco reset_opacity: min(opacity, 0.01) in activation space).

    When ``opt_state`` is given, the opacity-group Adam moments are
    zeroed as well (graphdeco's replace_tensor_to_optimizer): stale
    moments from pre-reset gradients would otherwise immediately push
    opacities back up. Returns (params, opt_state) in that case.
    """
    target_logit = jnp.log(cfg.reset_opacity_to) - jnp.log1p(
        -cfg.reset_opacity_to
    )
    new_logits = jnp.where(
        state.active,
        jnp.minimum(params.opacity_logits, target_logit),
        params.opacity_logits,
    )
    new_params = params._replace(opacity_logits=new_logits)
    if opt_state is None:
        return new_params
    return new_params, _zero_adam_moments_field(opt_state, "opacity_logits")


def _zero_adam_moments_field(opt_state, field: str):
    """Zero mu/nu of one GaussianParams field in every ScaleByAdamState.

    multi_transform wraps each group with optax.masked, so each group's
    mu/nu is a GaussianParams pytree with MaskedNode on the non-selected
    fields — zeroing `field` wherever it is a real array touches exactly
    that group's moments."""
    import optax

    def zero_field(moments):
        if hasattr(moments, "_fields") and field in moments._fields:
            val = getattr(moments, field)
            if hasattr(val, "dtype"):  # real array (MaskedNode has none)
                return moments._replace(**{field: jnp.zeros_like(val)})
        return moments

    def rebuild(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(mu=zero_field(s.mu), nu=zero_field(s.nu))
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(rebuild(sub) for sub in s)
        if hasattr(s, "_fields"):
            return type(s)(**{f: rebuild(getattr(s, f)) for f in s._fields})
        if isinstance(s, dict):
            return {k: rebuild(v) for k, v in s.items()}
        return s

    return rebuild(opt_state)


def _zero_adam_moments_where(opt_state, row_mask):
    """Zero mu/nu rows of every ScaleByAdamState where row_mask is True.

    Works through optax.multi_transform wrappers: MaskedNode leaves have
    no array leaves, so tree-mapping the moment pytrees touches only the
    real per-group arrays (all of which are (C, ...) rows)."""
    import optax

    def zero_rows(arr):
        mask = row_mask.reshape((row_mask.shape[0],) + (1,) * (arr.ndim - 1))
        return jnp.where(mask, jnp.zeros_like(arr), arr)

    def rebuild(s):
        if isinstance(s, optax.ScaleByAdamState):
            return s._replace(
                mu=jax.tree.map(zero_rows, s.mu),
                nu=jax.tree.map(zero_rows, s.nu),
            )
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(rebuild(sub) for sub in s)
        if hasattr(s, "_fields"):
            return type(s)(**{f: rebuild(getattr(s, f)) for f in s._fields})
        if isinstance(s, dict):
            return {k: rebuild(v) for k, v in s.items()}
        return s

    return rebuild(opt_state)
