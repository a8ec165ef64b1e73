"""Render CLI — the JAX counterpart of the reference app
(app/main.cpp:35-343), flag-for-flag where it makes sense:

    python -m luisacomputegaussiansplatting_jax.apps.render_cli \
        --ply scene.ply --res 1600x1063 --out out --world colmap --exp_N 10

  reference flag        here                      notes
  --------------------  ------------------------  ---------------------------
  --res WxH             --res WxH                 default 1600x1063 (main.cpp:38)
  --ply PATH            --ply PATH                or --synthetic N
  --backend dx|cuda|..  (jax picks gpu/cpu)       --platform to force
  --out DIR             --out DIR                 writes <ply>_<platform>.png
  --world colmap|blend  --world colmap|blender    world-up choice (main.cpp:199)
  --exp_N N             --exp_N N                 frames for FPS timing
  --display             (no ImGui; see viewer)    --camera flags instead

Camera defaults are the reference's hard-coded garden pose
(main.cpp:191-197); override with --cam-pos/--cam-target/--fov.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def parse_vec3(s: str):
    v = [float(x) for x in s.replace(",", " ").split()]
    if len(v) != 3:
        raise argparse.ArgumentTypeError(f"expected 3 floats, got {s!r}")
    return tuple(v)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ply", type=str, default=None, help="3DGS .ply scene")
    p.add_argument(
        "--synthetic",
        type=int,
        default=None,
        help="render a synthetic random scene with N gaussians instead",
    )
    p.add_argument("--res", type=str, default="1600x1063", help="WxH")
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--world", choices=["colmap", "blender"], default="colmap")
    p.add_argument("--exp_N", type=int, default=1, help="timed repetitions")
    p.add_argument("--platform", type=str, default=None, help="jax platform override")
    p.add_argument("--cam-pos", type=parse_vec3, default=(-3.0, -0.5, 3.3))
    p.add_argument("--cam-target", type=parse_vec3, default=(0.0, 3.0, 0.5))
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--bg", type=parse_vec3, default=(0.0, 0.0, 0.0))
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--max-pairs", type=int, default=8_000_000)
    p.add_argument("--shard", action="store_true",
                   help="shard gaussians+tiles over all devices (needs more "
                        "than one device)")
    p.add_argument("--ewa", choices=["inria", "lcgs"], default="inria")
    p.add_argument("--rect", choices=["inria", "lcgs"], default="inria",
                   help="tile-rect clamp convention; 'lcgs' reproduces the "
                        "reference's module.cpp:29-35 binning exactly")
    p.add_argument("--projection", choices=["focal", "ndc"], default="focal",
                   help="EWA Jacobian variant: 'focal' (reference default, "
                        "gs_projector.h:42) or 'ndc' (shad_project_gs, the "
                        "rescale-later kernel)")
    p.add_argument("--tile", type=int, default=16, choices=[16, 32],
                   help="rasterizer tile edge; 32 is faster for scenes of "
                        "small splats (minor border differences)")
    p.add_argument("--tile-h", type=int, default=None,
                   help="tile height (rectangular tiles, e.g. --tile 32 "
                        "--tile-h 16; default square)")
    p.add_argument("--pack", choices=["chunk", "none"], default="chunk",
                   help="'none' skips range repacking (faster; identical "
                        "up to float reduction order)")
    p.add_argument("--tight-radius", action="store_true",
                   help="shrink splat radii to the exact alpha_min reach "
                        "sqrt(2 ln(o/alpha_min)) sigma (image identical "
                        "up to reduction order; fewer expansion slots "
                        "for faint splats)")
    p.add_argument("--tile-cull", action="store_true",
                   help="exact ellipse-tile cull during binning (drops "
                        "AABB entries no pixel of the tile can receive; "
                        "image identical up to reduction order)")
    p.add_argument("--sort", choices=["2key", "fused"], default="2key",
                   help="entry-sort keys: 'fused' packs (tile, quantized "
                        "depth) into one 32-bit key (one sort operand "
                        "fewer; blend-order deviations only below ~2^-13 "
                        "relative depth)")
    p.add_argument("--payload", choices=["f32", "bf16"], default="f32",
                   help="per-entry payload precision: 'bf16' packs "
                        "opacity+rgb through the capacity gather as bf16 "
                        "(narrower gather rows; rounding below the 1/255 "
                        "output quantisation)")
    p.add_argument("--save-raw", type=str, default=None,
                   help="also save the float (3,H,W) frame as .npy "
                        "(exact cross-platform comparisons)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from .. import backend
    from ..config import RenderConfig
    from ..io.ply import load_ply
    from ..io.synthetic import random_scene
    from ..ops.render import render_aux
    from ..parallel.mesh import make_mesh
    from ..parallel.render_sharded import render_sharded
    from ..utils.camera import look_at_camera
    from ..utils.image import write_png

    backend.route()  # fail fast on a platform the kernels do not support
    backend.enable_compile_cache()
    if args.shard and len(jax.devices()) < 2:
        print(f"error: --shard needs more than one device, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2
    w, h = (int(x) for x in args.res.split("x"))

    if args.ply:
        scene = load_ply(args.ply)
        name = os.path.splitext(os.path.basename(args.ply))[0]
    elif args.synthetic:
        scene = random_scene(args.synthetic, seed=0)
        name = f"synthetic{args.synthetic}"
    else:
        print("error: --ply or --synthetic required", file=sys.stderr)
        return 2

    # world-up convention (reference main.cpp:193-202)
    world_up = (0.0, -1.0, -1.0) if args.world == "colmap" else (0.0, 0.0, 1.0)
    cam = look_at_camera(
        args.cam_pos, args.cam_target, world_up, fov=args.fov, width=w, height=h
    )
    cfg = RenderConfig(max_pairs=args.max_pairs, tile=args.tile,
                       tile_h=args.tile_h,
                       pack_mode=args.pack, rect_mode=args.rect,
                       payload_dtype=args.payload, sort_mode=args.sort,
                       tight_radius=args.tight_radius,
                       tile_cull=args.tile_cull,
                       use_focal=args.projection == "focal")
    print(f"num_gaussians: {scene.num_gaussians}")
    print(f"rendering {w}x{h} on {jax.default_backend()} ({len(jax.devices())} device(s))")

    # bg is a traced argument, perturbed per repetition below so that no
    # repetition can be served from a cached result
    if args.shard:
        mesh = make_mesh()
        ndev = len(jax.devices())
        pad = -scene.num_gaussians % ndev
        if pad:
            scene = scene.pad_to(scene.num_gaussians + pad)
        fn = jax.jit(
            lambda bg, *a: render_sharded(
                *a, cam, mesh, bg_color=bg, cfg=cfg, sh_degree=args.sh_degree
            )
        )
    else:
        fn = jax.jit(
            lambda bg, *a: render_aux(
                *a, cam, bg_color=bg, cfg=cfg, sh_degree=args.sh_degree,
                ewa_mode=args.ewa,
            )
        )

    import numpy as _np

    bg0 = jnp.asarray(args.bg, jnp.float32)
    img, aux = fn(bg0, *scene.render_args())
    img.block_until_ready()  # compile + first frame

    t0 = time.perf_counter()
    for i in range(args.exp_N):
        img, aux = fn(bg0 + i * 1e-7, *scene.render_args())
    _np.asarray(img[:, :1, :1])  # fetch: forces the queue to drain
    dt = time.perf_counter() - t0

    n_rendered = int(aux.num_rendered)
    print(f"num_rendered: {n_rendered}")
    if bool(np.asarray(aux.overflow)):
        print("WARNING: pair capacity overflow — raise --max-pairs", file=sys.stderr)
    fps = args.exp_N / dt if dt > 0 else float("inf")
    print(f"exp time: {dt * 1000:.2f} ms  fps: {fps:.2f} (N={args.exp_N})")
    print(f"pixels/s: {w * h * fps:.3e}")
    if args.exp_N > 1:
        # per-rep diagnostic: each rep blocked on its own result
        per = []
        for i in range(min(args.exp_N, 3)):
            t1 = time.perf_counter()
            img_d, _ = fn(bg0 + (i + 1) * 1e-6, *scene.render_args())
            img_d.block_until_ready()
            per.append((time.perf_counter() - t1) * 1e3)
        print("rep_ms:", " ".join(f"{v:.1f}" for v in per))

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"{name}_{jax.default_backend()}.png")
    write_png(out_path, np.asarray(img))
    print(f"result saved in {out_path}")
    if args.save_raw:
        np.save(args.save_raw, np.asarray(img, np.float32))
        print(f"raw frame saved in {args.save_raw}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
