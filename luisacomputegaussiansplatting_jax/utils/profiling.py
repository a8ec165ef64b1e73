"""Profiling utilities.

The reference's only instrumentation is a wall clock around the frame
loop (app/main.cpp:225,317-320) and an ImGui FPS counter. Here:

  * ``trace(logdir)`` — jax.profiler device trace (TensorBoard/Perfetto).
  * ``stage_timings(...)`` — per-stage wall times of the render pipeline,
    each stage jitted and timed in isolation (isolated stages can
    mispredict the fused frame; prefer a trace of the fused step).
  * ``Timer`` — reps/warmup wall-clock helper that blocks on device
    results (correct under async dispatch).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax


class Timer:
    """Median-of-reps wall timer with compile warmup."""

    def __init__(self, warmup: int = 1, reps: int = 5):
        self.warmup = warmup
        self.reps = reps

    def time(self, fn: Callable, *args) -> float:
        """Seconds per call of jit(fn)(*args), device-synchronized."""
        f = jax.jit(fn)
        for _ in range(self.warmup):
            out = f(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(self.reps):
            out = f(*args)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / self.reps


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace into `logdir`."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_timings(
    scene,
    camera,
    cfg=None,
    sh_degree: int = 3,
    reps: int = 5,
    include_backward: bool = True,
) -> Dict[str, float]:
    """Per-stage seconds of one frame at this scene/camera/config.

    Stages: sh_eval, projection, binning, payload, rasterize_fwd,
    full_forward, and (optionally) full_fwd_bwd.
    """
    import jax.numpy as jnp

    from ..config import RenderConfig
    from ..ops.binning import bin_gaussians
    from ..ops.projection import project_gaussians, tile_grid
    from ..ops.render import build_payload, render
    from ..ops.rasterize_pallas import rasterize_forward
    from ..ops.sh_eval import compute_colors

    cfg = cfg or RenderConfig()
    width, height = camera.width, camera.height
    view = camera.to_view()
    grid_x, grid_y = tile_grid(width, height)
    means, scales, quats, opac, sh = scene.render_args()
    t = Timer(reps=reps)
    out: Dict[str, float] = {}

    out["sh_eval"] = t.time(
        lambda m, s: compute_colors(m, s, view.position, sh_degree), means, sh
    )
    out["projection"] = t.time(
        lambda m, s, q: project_gaussians(
            m, s, q, view, cfg, width=width, height=height
        ),
        means,
        scales,
        quats,
    )
    proj = jax.jit(
        lambda m, s, q: project_gaussians(
            m, s, q, view, cfg, width=width, height=height
        )
    )(means, scales, quats)
    out["binning"] = t.time(
        lambda p: bin_gaussians(p, grid_x, grid_y, cfg.max_pairs), proj
    )
    binned = jax.jit(
        lambda p: bin_gaussians(p, grid_x, grid_y, cfg.max_pairs)
    )(proj)
    colors = jax.jit(
        lambda m, s: compute_colors(m, s, view.position, sh_degree)
    )(means, sh)
    out["payload"] = t.time(
        lambda pr, c, o, b: build_payload(pr, c, o, b), proj, colors, opac, binned
    )
    payload = jax.jit(build_payload)(proj, colors, opac, binned)
    out["rasterize_fwd"] = t.time(
        lambda p: rasterize_forward(
            p, binned.tile_starts, binned.tile_counts, grid_x, width, height, cfg
        ),
        payload,
    )
    out["full_forward"] = t.time(
        lambda *a: render(*a, camera, cfg=cfg, sh_degree=sh_degree),
        means, scales, quats, opac, sh,
    )
    if include_backward:
        out["full_fwd_bwd"] = t.time(
            jax.value_and_grad(
                lambda *a: jnp.sum(render(*a, camera, cfg=cfg, sh_degree=sh_degree)),
                argnums=(0, 1, 2, 3, 4),
            ),
            means, scales, quats, opac, sh,
        )
    return out


def _chained_time(fn, args, reps: int = 4) -> float:
    """Seconds per call with CHAINED-dependent repetitions: each rep's
    traced salt input depends on the previous rep's output, so no
    repetition can be served from a cached result.
    fn must take (salt, *args). Returns (t_n - t_1) / (reps - 1).
    """
    import jax.numpy as jnp
    import numpy as np

    f = jax.jit(fn)

    def opaque(out):
        leaf = jax.tree.leaves(out)[0]
        return leaf.ravel()[0].astype(jnp.float32) * 1e-30

    def seq(n):
        out = f(jnp.float32(0.0), *args)
        for _ in range(n - 1):
            out = f(opaque(out), *args)
        return jax.tree.map(np.asarray, out)

    seq(2)  # compile + warm
    t0 = time.perf_counter(); seq(1); t1 = time.perf_counter() - t0
    t0 = time.perf_counter(); seq(reps); tn = time.perf_counter() - t0
    return max((tn - t1) / (reps - 1), 0.0)


def backward_timings(
    scene, camera, cfg=None, sh_degree: int = 3, reps: int = 4,
) -> Dict[str, float]:
    """Attribute the backward pass: per-pullback-stage seconds.

    Stages (their sum should match fwd_bwd_total - forward):
      rast_bwd   — d_image -> d_payload (tiles_to_image + rasterizer VJP)
      reduce_bwd — d_payload -> d_table (gather_payload VJP: segment-sum)
      params_bwd — d_table -> d_params (payload_table/projection/SH VJPs)
    plus `forward` and `fwd_bwd_total` for the cross-check. All stages
    use chained-dependent timing (see _chained_time). The reference has
    no backward at all (README.md:70) — this instruments the north-star
    fwd+bwd metric.
    """
    import jax.numpy as jnp

    from ..config import RenderConfig
    from ..ops.binning import bin_gaussians_nopack, bin_gaussians
    from ..ops.projection import project_gaussians, tile_grid
    from ..ops.render import (
        build_payload, payload_table, render, _tiles_to_image,
    )
    from ..ops.rasterize_pallas import rasterize_tiles
    from ..ops.sh_eval import compute_colors

    cfg = cfg or RenderConfig()
    width, height = camera.width, camera.height
    view = camera.to_view()
    grid_x, grid_y = tile_grid(width, height, cfg.tile_wh)
    means, scales, quats, opac, sh = scene.render_args()
    out: Dict[str, float] = {}

    proj = jax.jit(
        lambda m, s, q: project_gaussians(
            m, s, q, view, cfg, width=width, height=height,
            opacities=opac if cfg.tight_radius else None,
        )
    )(means, scales, quats)
    colors = jax.jit(
        lambda m, s: compute_colors(m, s, view.position, sh_degree)
    )(means, sh)
    binner = (
        bin_gaussians_nopack if cfg.pack_mode == "none" else bin_gaussians
    )
    cull_op = opac if cfg.tile_cull else None
    binned = jax.jit(
        lambda p, o: binner(
            p, grid_x, grid_y, cfg.max_pairs, o, cfg.tile_wh,
            cfg.alpha_min, cfg.max_pairs_sorted, cfg.sort_mode,
        )
    )(proj, cull_op)
    payload = jax.jit(
        build_payload, static_argnums=(4,)
    )(proj, colors, opac, binned, cfg.payload_dtype)

    out["forward"] = _chained_time(
        lambda salt, m: render(
            m, scales, quats, opac, sh, camera,
            bg_color=jnp.zeros(3) + salt, cfg=cfg, sh_degree=sh_degree,
        ),
        (means,), reps,
    )

    def rast_loss(salt, pl):
        def g(p):
            color, trans = rasterize_tiles(
                p, binned.tile_starts, binned.tile_counts, grid_x,
                width, height, cfg,
            )
            img_c, img_t = _tiles_to_image(
                color, trans, grid_x, grid_y, width, height, cfg.tile_wh
            )
            return jnp.sum(img_c * (1.0 + salt)) + jnp.sum(img_t)

        return jax.grad(g)(pl)

    out["rast_bwd"] = _chained_time(rast_loss, (payload,), reps)

    import sys as _sys

    # ops/__init__ re-exports the render FUNCTION, shadowing the
    # submodule attribute; resolve the module via sys.modules
    render_mod = _sys.modules["luisacomputegaussiansplatting_jax.ops.render"]

    table = jax.jit(payload_table)(proj, colors, opac)
    d_payload = jnp.ones_like(payload)

    def reduce_loss(salt, tb):
        def g(t):
            pl = render_mod.gather_payload(
                t, binned.entry_gid, t.shape[0], cfg.payload_dtype,
            )
            return jnp.vdot(pl, d_payload * (1.0 + salt))

        return jax.grad(g)(tb)

    out["reduce_bwd"] = _chained_time(reduce_loss, (table,), reps)

    d_table = jnp.ones_like(table)

    def params_loss(salt, m, s, q, o, shc):
        def g(mm, ss, qq, oo, sc):
            cl = compute_colors(mm, sc, view.position, sh_degree)
            pr = project_gaussians(
                mm, ss, qq, view, cfg, width=width, height=height,
                opacities=oo if cfg.tight_radius else None,
            )
            tb = payload_table(pr, cl, oo)
            return jnp.vdot(tb, d_table * (1.0 + salt))

        return jax.grad(g, argnums=(0, 1, 2, 3, 4))(m, s, q, o, shc)

    out["params_bwd"] = _chained_time(
        params_loss, (means, scales, quats, opac, sh), reps
    )

    out["fwd_bwd_total"] = _chained_time(
        lambda salt, m: jax.grad(
            lambda mm: jnp.sum(
                render(
                    mm, scales, quats, opac, sh, camera,
                    bg_color=jnp.zeros(3) + salt, cfg=cfg,
                    sh_degree=sh_degree,
                )
            )
        )(m),
        (means,), reps,
    )
    return out
