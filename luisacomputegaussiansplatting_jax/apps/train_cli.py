"""3DGS training CLI — the capability the reference roadmap left unchecked
("Support Training without python binding", doc/roadmap.md:4).

Trains a gaussian scene against a multi-view dataset with the graphdeco
recipe: per-group Adam, (1-w) L1 + w D-SSIM loss, adaptive density
control (clone/split/prune + opacity resets), periodic checkpoints, and a
final graphdeco-compatible PLY export.

    # self-supervised smoke run (targets rendered from a synthetic scene):
    python -m luisacomputegaussiansplatting_jax.apps.train_cli \
        --synthetic-gt 4000 --views 24 --res 256x256 --iters 800 \
        --capacity 20000 --out /tmp/fit

    # NeRF-synthetic (lego/chair) or COLMAP (bicycle/garden):
    python -m ... --nerf-synthetic /data/lego --iters 30000 ...
    python -m ... --colmap /data/bicycle --downscale 4 ...

    # multi-device: views data-parallel x gaussian/tile sharding:
    python -m ... --colmap /data/bicycle --shard --mesh 2x4 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic-gt", type=int, default=None,
                     help="fit against views rendered from a random scene with N gaussians")
    src.add_argument("--nerf-synthetic", type=str, default=None,
                     help="NeRF-blender dataset root (transforms_train.json)")
    src.add_argument("--colmap", type=str, default=None,
                     help="COLMAP dataset root (sparse/0 + images/)")
    p.add_argument("--init-ply", type=str, default=None,
                   help="initialise from a 3DGS .ply instead of random points")
    p.add_argument("--downscale", type=int, default=1,
                   help="integer downscale of COLMAP images")
    p.add_argument("--init-points", type=int, default=2000,
                   help="random init point count (no --init-ply)")
    p.add_argument("--capacity", type=int, default=50_000,
                   help="static gaussian capacity (densification headroom)")
    p.add_argument("--views", type=int, default=24, help="synthetic-gt view count")
    p.add_argument("--res", type=str, default="256x256", help="synthetic-gt resolution")
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--max-pairs", type=int, default=1_000_000)
    p.add_argument("--tile", type=int, default=16, choices=[16, 32])
    p.add_argument("--tile-h", type=int, default=None,
                   help="tile height (rectangular tiles; default square)")
    p.add_argument("--pack", choices=["chunk", "none"], default="none",
                   help="rasterizer range layout; 'none' is faster and the "
                        "training default")
    p.add_argument("--payload", choices=["f32", "bf16"], default="f32",
                   help="payload-gather precision (see render_cli --payload)")
    p.add_argument("--sort", choices=["2key", "fused"], default="2key",
                   help="entry-sort key layout (see render_cli --sort)")
    p.add_argument("--tight-radius", action="store_true",
                   help="exact alpha_min splat radii (see render_cli)")
    p.add_argument("--tile-cull", action="store_true",
                   help="exact ellipse-tile cull (see render_cli)")
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--sh-upgrade-every", type=int, default=1000,
                   help="raise the active SH degree by one every N iters "
                        "(graphdeco oneupSHdegree); 0 = full degree always")
    p.add_argument("--views-per-step", type=int, default=1,
                   help="views rendered per optimiser step (vmapped batch)")
    p.add_argument("--densify-from", type=int, default=100)
    p.add_argument("--densify-until", type=int, default=None,
                   help="default iters // 2")
    p.add_argument("--densify-interval", type=int, default=100)
    p.add_argument("--opacity-reset-interval", type=int, default=0,
                   help="0 disables (graphdeco: 3000)")
    p.add_argument("--grad-threshold", type=float, default=2e-4,
                   help="densify grad threshold in graphdeco's NDC-scaled "
                        "units (their default 2e-4; resolution-independent)")
    p.add_argument("--shard", action="store_true",
                   help="multi-device training: views data-parallel x "
                        "gaussian/tile sharding on a 2D device mesh "
                        "(needs more than one device)")
    p.add_argument("--mesh", type=str, default=None,
                   help="DATAxGS device mesh shape (default: auto)")
    p.add_argument("--max-pairs-local", type=int, default=None,
                   help="per-device expansion capacity (sharded; default "
                        "max-pairs / n_gs, CHUNK-rounded)")
    p.add_argument("--exchange-capacity", type=int, default=None,
                   help="per (src,dst)-device bucket capacity (sharded; "
                        "default = max-pairs-local)")
    p.add_argument("--ckpt-every", type=int, default=0, help="0 disables")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--out", type=str, default="out_train")
    p.add_argument("--platform", type=str, default=None,
                   help="jax platform override ('cpu' for tests)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=0, help="0 disables")
    p.add_argument("--bg", type=str, default="black", choices=["black", "white"])
    return p


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return -10.0 * np.log10(max(mse, 1e-10))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from .. import backend
    from ..config import RenderConfig
    from ..io.dataset import (
        load_colmap,
        load_colmap_points3d,
        load_nerf_synthetic,
        synthetic_multiview,
    )
    from ..io.ply import load_ply, save_ply
    from ..io.synthetic import random_scene
    from ..models.checkpoint import CheckpointManager
    from ..models.densify import (
        DensifyConfig,
        densify_step,
        init_densify_state,
        reset_opacity,
    )
    from ..models.gaussians import GaussianParams, pad_params_to
    from ..models.trainer import (
        TrainConfig,
        TrainState,
        init_train_state,
        make_densify_train_step,
    )
    from ..utils.image import write_png

    backend.route()  # fail fast on a platform the kernels do not support
    backend.enable_compile_cache()
    if args.shard and len(jax.devices()) < 2:
        print(f"error: --shard needs more than one device, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    key = jax.random.PRNGKey(args.seed)

    # ---- dataset --------------------------------------------------------
    if args.synthetic_gt:
        w, h = (int(x) for x in args.res.split("x"))
        gt = random_scene(args.synthetic_gt, seed=args.seed + 1,
                          extent=1.5, scale_range=(0.02, 0.08))
        data = synthetic_multiview(
            gt, n_views=args.views, width=w, height=h, radius=4.0,
            cfg=RenderConfig(max_pairs=args.max_pairs),
            sh_degree=args.sh_degree,
        )
        name = f"syntheticgt{args.synthetic_gt}"
    elif args.nerf_synthetic:
        data = load_nerf_synthetic(
            args.nerf_synthetic, white_background=args.bg == "white"
        )
        name = os.path.basename(os.path.normpath(args.nerf_synthetic))
    else:
        data = load_colmap(args.colmap, downscale=args.downscale)
        name = os.path.basename(os.path.normpath(args.colmap))
    width, height = data.cameras[0].width, data.cameras[0].height
    print(f"dataset: {len(data)} views at {width}x{height}, "
          f"extent {data.scene_extent:.2f}")

    # ---- device mesh (multi-device training) -----------------------------
    mesh = None
    if args.shard:
        from ..parallel.mesh import make_mesh

        ndev = len(jax.devices())
        if args.mesh:
            n_data, n_gs = (int(x) for x in args.mesh.split("x"))
            if n_data * n_gs != ndev:
                print(f"error: mesh {args.mesh} != {ndev} devices",
                      file=sys.stderr)
                return 2
        else:
            n_data = 2 if ndev % 2 == 0 and ndev > 1 else 1
            n_gs = ndev // n_data
        mesh = make_mesh((n_data, n_gs), ("data", "gs"))
        args.capacity = -(-args.capacity // n_gs) * n_gs  # shardable
        print(f"mesh: {n_data} data x {n_gs} gs devices")

    # ---- init -----------------------------------------------------------
    colmap_pts = None
    if args.colmap and not args.init_ply:
        try:
            colmap_pts = load_colmap_points3d(args.colmap)
        except FileNotFoundError:
            pass
    if args.init_ply:
        scene0 = load_ply(args.init_ply)
        params = scene0.to_params()
    elif colmap_pts is not None:
        # graphdeco init (scene/gaussian_model.create_from_pcd): means at
        # the COLMAP sparse points, SH DC from point colour, scales =
        # log(mean 3-NN distance), opacity = inverse_sigmoid(0.1)
        from scipy.spatial import cKDTree

        from ..utils.sh import sh_from_color

        xyz, rgb = colmap_pts
        if xyz.shape[0] > args.capacity // 2:
            sel = rng.choice(xyz.shape[0], args.capacity // 2, replace=False)
            xyz, rgb = xyz[sel], rgb[sel]
        d, _ = cKDTree(xyz).query(xyz, k=min(4, xyz.shape[0]))
        nn = np.sqrt(np.clip((d[:, 1:] ** 2).mean(axis=1), 1e-14, None))
        n0 = xyz.shape[0]
        k = (args.sh_degree + 1) ** 2
        params = GaussianParams(
            means=jnp.asarray(xyz),
            log_scales=jnp.asarray(np.log(nn)[:, None].repeat(3, 1), jnp.float32),
            quats=jnp.zeros((n0, 4), jnp.float32).at[:, 3].set(1.0),
            opacity_logits=jnp.full((n0,), float(np.log(0.1 / 0.9)), jnp.float32),
            sh_dc=jnp.asarray(np.asarray(sh_from_color(rgb))[:, None, :], jnp.float32),
            sh_rest=jnp.zeros((n0, k - 1, 3), jnp.float32),
        )
        print(f"init from COLMAP points3D: {n0} points")
    else:
        # random points in the scene volume, dim + semi-transparent
        n0 = args.init_points
        pts = rng.uniform(-1, 1, (n0, 3)).astype(np.float32) * data.scene_extent * 0.7
        k = (args.sh_degree + 1) ** 2
        params = GaussianParams(
            means=jnp.asarray(pts),
            log_scales=jnp.full((n0, 3), np.log(0.05 * data.scene_extent), jnp.float32),
            quats=jnp.zeros((n0, 4), jnp.float32).at[:, 3].set(1.0),
            opacity_logits=jnp.full((n0,), -2.0, jnp.float32),
            sh_dc=jnp.asarray(rng.normal(0, 0.3, (n0, 1, 3)), jnp.float32),
            sh_rest=jnp.zeros((n0, k - 1, 3), jnp.float32),
        )
    n0 = params.means.shape[0]
    params = pad_params_to(params, args.capacity)
    # graphdeco's spatial_lr_scale: position lr endpoints scale with the
    # scene extent (their cameras_extent) so geometry moves at a
    # world-appropriate rate
    tc = TrainConfig(spatial_lr_scale=float(data.scene_extent))
    state, opt = init_train_state(params, tc)
    dstate = init_densify_state(n0, args.capacity)
    print(f"init: {n0} gaussians, capacity {args.capacity}")

    cfg = RenderConfig(max_pairs=args.max_pairs, tile=args.tile,
                       tile_h=args.tile_h, pack_mode=args.pack,
                       payload_dtype=args.payload, sort_mode=args.sort,
                       tight_radius=args.tight_radius,
                       tile_cull=args.tile_cull)
    scfg = None
    pad_targets_fn = None
    if mesh is not None:
        from ..config import CHUNK
        from ..parallel.render_sharded import (
            ShardedRenderConfig, derive_exchange_capacity,
        )

        mpl = args.max_pairs_local or max(args.max_pairs // n_gs, CHUNK)
        mpl = -(-mpl // CHUNK) * CHUNK
        # skew-derived default (see derive_exchange_capacity); overflow
        # still auto-doubles via grow_capacity below
        bcap = args.exchange_capacity or derive_exchange_capacity(mpl, n_gs)
        bcap = -(-bcap // CHUNK) * CHUNK
        scfg = ShardedRenderConfig(max_pairs_local=mpl, exchange_capacity=bcap)
    bg = (1.0, 1.0, 1.0) if args.bg == "white" else (0.0, 0.0, 0.0)
    dcfg = DensifyConfig(grad_threshold=args.grad_threshold)
    from ..models.trainer import make_batched_train_step

    # one step function per active SH degree (graphdeco raises the degree
    # during training; each degree is its own compiled program)
    _step_cache = {}

    def step_for_degree(deg: int):
        if deg not in _step_cache:
            if mesh is not None:
                from ..parallel.train_sharded import make_sharded_train_step

                step, _o, pad_t = make_sharded_train_step(
                    mesh, width, height, cfg=cfg, scfg=scfg, sh_degree=deg,
                    tc=tc, bg_color=bg, densify=True,
                )
                _step_cache[deg] = (step, pad_t)
            elif args.views_per_step > 1:
                _step_cache[deg] = make_batched_train_step(
                    opt, width, height, cfg=cfg, sh_degree=deg, tc=tc,
                    bg_color=bg,
                )
            else:
                _step_cache[deg] = make_densify_train_step(
                    opt, width, height, cfg=cfg, sh_degree=deg, tc=tc,
                    bg_color=bg,
                )
        return _step_cache[deg]
    densify_fn = jax.jit(
        lambda p, o, d, k: densify_step(
            p, o, d, k, data.scene_extent, dcfg
        )
    )
    reset_fn = jax.jit(lambda p, d, o: reset_opacity(p, d, dcfg, opt_state=o))

    def grow_capacity():
        """Render-pair overflow: double the static capacities and rebuild
        the compiled steps (the static-shape analog of the reference's temp
        buffer x2 growth, gs_tile_splatter/impl.cpp:31-61 — but triggered
        by a *detected* overflow instead of silently corrupting past L,
        app/main.cpp:245)."""
        nonlocal cfg, scfg
        cfg = dataclasses.replace(cfg, max_pairs=cfg.max_pairs * 2)
        if scfg is not None:
            scfg = ShardedRenderConfig(
                max_pairs_local=scfg.max_pairs_local * 2,
                exchange_capacity=scfg.exchange_capacity * 2,
            )
        _step_cache.clear()
        print(f"[overflow] raising max_pairs to {cfg.max_pairs} and "
              "recompiling (entries were dropped this interval)",
              file=sys.stderr)

    ckpt = None
    start_iter = 0
    if args.ckpt_every:
        ckpt = CheckpointManager(os.path.join(args.out, "ckpt"))
        if args.resume:
            latest, restored = ckpt.restore_latest((state, dstate))
            if latest is not None:
                state, dstate = restored
                start_iter = latest
                print(f"resumed from step {latest}")

    views = [c.to_view() for c in data.cameras]
    targets = [jnp.asarray(t) for t in data.targets]
    densify_until = args.densify_until or args.iters // 2

    from ..ops.render import render_view

    @jax.jit
    def eval_render(params, active, view):
        scene = params.activate()
        img, _ = render_view(
            *scene.render_args(), view, width, height, bg, cfg,
            args.sh_degree, active_mask=active,
        )
        return img

    t0 = time.perf_counter()
    last_loss = float("nan")
    ov_acc = jnp.asarray(False)  # sticky device-side overflow flag
    for it in range(start_iter, args.iters):
        if args.sh_upgrade_every > 0:
            deg = min(args.sh_degree, it // args.sh_upgrade_every)
        else:
            deg = args.sh_degree
        step_fn = step_for_degree(deg)
        if mesh is not None:
            step_s, pad_t = step_fn
            nv = n_data * args.views_per_step
            vis = rng.choice(len(data), size=nv, replace=nv > len(data))
            v_batch = jax.tree.map(
                lambda *xs: jnp.stack(xs), *[views[v] for v in vis]
            )
            t_batch = pad_t(jnp.stack([targets[v] for v in vis]))
            state, dstate, loss, overflow = step_s(
                state, dstate, v_batch, t_batch
            )
            ov_acc = ov_acc | overflow
        elif args.views_per_step > 1:
            vis = rng.choice(
                len(data),
                size=args.views_per_step,
                replace=args.views_per_step > len(data),
            )
            v_batch = jax.tree.map(
                lambda *xs: jnp.stack(xs), *[views[v] for v in vis]
            )
            t_batch = jnp.stack([targets[v] for v in vis])
            state, dstate, loss, overflow = step_fn(
                state, dstate, v_batch, t_batch
            )
            ov_acc = ov_acc | overflow
        else:
            vi = int(rng.integers(0, len(data)))
            state, dstate, loss, aux = step_fn(
                state, dstate, views[vi], targets[vi]
            )
            ov_acc = ov_acc | aux.overflow

        do_densify = (
            args.densify_from <= it < densify_until
            and (it + 1) % args.densify_interval == 0
        )
        if do_densify:
            key, sub = jax.random.split(key)
            params, opt_state, dstate, dinfo = densify_fn(
                state.params, state.opt_state, dstate, sub
            )
            state = TrainState(params, opt_state, state.step)
            print(
                f"[{it+1}] densify: +{int(dinfo.n_cloned)} cloned "
                f"+{int(dinfo.n_split)} split -{int(dinfo.n_pruned)} pruned "
                f"-> {int(dstate.num_active)} active",
                file=sys.stderr,
            )
            if bool(dinfo.overflow):
                print(f"[{it+1}] WARNING: capacity full, children dropped",
                      file=sys.stderr)
        if (
            args.opacity_reset_interval
            and (it + 1) % args.opacity_reset_interval == 0
            and it < densify_until
        ):
            new_p, new_o = reset_fn(state.params, dstate, state.opt_state)
            state = TrainState(new_p, new_o, state.step)

        if (it + 1) % args.log_every == 0:
            last_loss = float(loss)
            n_act = int(dstate.num_active)
            dt = time.perf_counter() - t0
            print(
                f"[{it+1}/{args.iters}] loss {last_loss:.5f}  "
                f"active {n_act}  {(it + 1 - start_iter) / dt:.1f} it/s",
                flush=True,
            )
            if bool(ov_acc):  # render-pair overflow: entries were dropped
                grow_capacity()
                ov_acc = jnp.asarray(False)
        if args.eval_every and (it + 1) % args.eval_every == 0:
            from ..models.losses import ssim

            img = eval_render(state.params, dstate.active, views[0])
            s_val = float(ssim(jnp.clip(img, 0, 1), targets[0]))
            print(
                f"  eval view0 PSNR {psnr(img, targets[0]):.2f} dB  "
                f"SSIM {s_val:.4f}"
            )
        if ckpt and args.ckpt_every and (it + 1) % args.ckpt_every == 0:
            ckpt.save(it + 1, (state, dstate))

    if bool(ov_acc):
        grow_capacity()  # report the tail-interval overflow loudly
    if args.iters > start_iter:
        last_loss = float(loss)  # one sync; covers runs shorter than log_every

    # ---- export ---------------------------------------------------------
    scene = jax.jit(lambda p: p.activate())(state.params)
    active = np.asarray(dstate.active)
    from ..models.gaussians import GaussianScene

    packed = GaussianScene(
        *(np.asarray(x)[active] for x in scene)
    )
    out_ply = os.path.join(args.out, f"{name}_trained.ply")
    save_ply(packed, out_ply)
    print(f"saved {int(active.sum())} gaussians to {out_ply}")

    from ..models.losses import ssim as _ssim

    img = eval_render(state.params, dstate.active, views[0])
    final_psnr = psnr(img, targets[0])
    final_ssim = float(_ssim(jnp.clip(img, 0, 1), targets[0]))
    write_png(os.path.join(args.out, f"{name}_view0.png"), np.asarray(img),
              flip_vertical=False)
    write_png(os.path.join(args.out, f"{name}_view0_target.png"),
              np.asarray(targets[0]), flip_vertical=False)
    print(
        f"final: loss {last_loss:.5f}, view0 PSNR {final_psnr:.2f} dB, "
        f"SSIM {final_ssim:.4f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
