"""Benchmark harness: fwd+bwd pixels/s at 1080p on one GPU.

Measures pixels/s for forward+backward at 1080p on synthetic scenes
generated on the device from a seed (the reference's released .ply
scenes are not available offline). Two scales run:

  * headline: 2M gaussians / ~7.8M AABB pairs.
  * north_star: 6M gaussians / ~12.6M AABB pairs — the mip-NeRF 360
    bicycle scale of BASELINE.json.

Each scale runs in its own child process, one after the other, so only
one process holds the card at a time; the parent never imports JAX.
Timing: after the compile call and one warm-up call, each timed
repetition's traced bg input depends on the previous repetition's loss,
so no repetition can be served from a cached result; the mean over the
repetitions, blocked at the end, is reported.

Fails without a GPU. Prints ONE json line:
  {"metric": ..., "value": N, "unit": ..., "device": {...},
   "card": "<nvidia-smi name, power.limit>", "north_star": {...}}
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

WIDTH, HEIGHT = 1920, 1080

# (n_gaussians, cfg kwargs, timed reps)
CONFIGS = {
    # production-fast configuration: tile=32 no-pack with the exact
    # ellipse cull, post-sort capacity trim, bf16-packed payload gather
    # and the fused sort key
    "headline": (
        2_000_000,
        dict(max_pairs=4_500_000, tile=32, pack_mode="none",
             tile_cull=True, max_pairs_sorted=3_900_000,
             payload_dtype="bf16", sort_mode="fused"),
        10,
    ),
    # the BASELINE.json north-star scale (~bicycle: 6M gaussians)
    "north_star": (
        6_000_000,
        dict(max_pairs=13_000_000, tile=32, pack_mode="none",
             tile_cull=True, max_pairs_sorted=10_600_000,
             payload_dtype="bf16", sort_mode="fused"),
        5,
    ),
}


def headline_camera(width=WIDTH, height=HEIGHT):
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    return look_at_camera(
        (3.5, -3.0, 2.2), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
        fov=65.0, width=width, height=height,
    )


def bench_scene(n_gaussians: int, seed: int = 0):
    """The benchmark scene, generated on the device."""
    from luisacomputegaussiansplatting_jax.io.synthetic import (
        random_scene_device,
    )

    return random_scene_device(
        n_gaussians, seed=seed, extent=3.0, scale_range=(0.004, 0.02)
    )


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run_child(name: str) -> None:
    """Measure one config on the GPU; print {"px_s": ..., ...}."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax import backend
    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.ops.render import render_aux

    backend.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {dev.platform!r})")

    n_gaussians, cfg_kwargs, reps = CONFIGS[name]
    cfg = RenderConfig(**cfg_kwargs)
    cam = headline_camera()
    args = bench_scene(n_gaussians).render_args()

    def loss(means, scales, quats, opac, sh, bg):
        img, aux = render_aux(
            means, scales, quats, opac, sh, cam, bg_color=bg, cfg=cfg
        )
        return jnp.sum(img), aux.overflow

    # one compile: the overflow flag rides value_and_grad's aux output
    # (overflow would silently drop entries and flatter the numbers)
    step = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)
    )

    bg0 = jnp.zeros((3,), jnp.float32)
    print(f"bench[{name}]: compiling fwd+bwd...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    (val, overflow), _g = step(*args, bg0)
    jax.block_until_ready(_g)
    compile_s = time.perf_counter() - t0
    print(f"bench[{name}]: compiled in {compile_s:.1f}s", file=sys.stderr,
          flush=True)
    assert not bool(overflow), "bench capacity overflow: raise max_pairs"
    # one more untimed step: the first executions after a compile also
    # build the program's CUDA graphs
    (val, _overflow), g = step(*args, bg0 + val * 1e-20)
    jax.block_until_ready(g)

    t0 = time.perf_counter()
    for _ in range(reps):
        bg = bg0 + val * 1e-20
        (val, _overflow), g = step(*args, bg)
    jax.block_until_ready((val, g))
    dt = (time.perf_counter() - t0) / reps

    print(json.dumps({
        "px_s": WIDTH * HEIGHT / dt, "ms": dt * 1e3, "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


def main():
    me = os.path.abspath(__file__)
    card = card_name_and_power_limit()
    print(f"bench: card {card}", file=sys.stderr, flush=True)
    results = {}
    for name in CONFIGS:
        proc = subprocess.run(
            [sys.executable, "-u", me, "--child", name],
            capture_output=True, text=True,
        )
        sys.stderr.write(proc.stderr)
        if proc.returncode:
            raise SystemExit(f"bench[{name}] failed (rc {proc.returncode})")
        results[name] = json.loads(proc.stdout.strip().splitlines()[-1])

    head, ns = results["headline"], results["north_star"]
    print(json.dumps({
        "metric": "pixels_per_s_fwd_bwd_1080p",
        "value": head["px_s"],
        "unit": "pixels/s",
        "fwd_bwd_ms": head["ms"],
        "device": head["device"],
        "card": card,
        "north_star": {
            "scene": "6M gaussians (bicycle scale)",
            "pixels_per_s": ns["px_s"],
            "fwd_bwd_ms": ns["ms"],
        },
    }))


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        run_child(sys.argv[2])
    else:
        main()
