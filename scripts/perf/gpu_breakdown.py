"""Kernel choices and per-layer split of the fwd+bwd frame on one GPU.

Four measurements, each in this one process (one process holds the card):

  sweep     Triton blend-kernel launch shapes (entries per step, warps)
            at the bench headline scene, per kernel and tile size.
  blend     Triton blend fwd+bwd against the plain XLA blend
            (ops/rasterize_ref.py) at 250K gaussians, 800x800.
  plain2m   whether the plain XLA blend fits at the 2M/1080p headline:
            its compiled temp size, then one run.
  trace     a jax.profiler trace of the headline fwd+bwd step, reduced to
            device time per layer (named scopes: expand, entry_sort,
            payload_gather, grad_reduce; kernels blend_forward and
            blend_backward) plus the top ops.

    python -u scripts/perf/gpu_breakdown.py [--only sweep,blend,plain2m,trace]

Writes chiprun_out/gpu_breakdown.json; prints a summary.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import CONFIGS, HEIGHT, WIDTH, bench_scene, headline_camera  # noqa: E402
from luisacomputegaussiansplatting_jax import backend  # noqa: E402
from luisacomputegaussiansplatting_jax.config import RenderConfig  # noqa: E402
from luisacomputegaussiansplatting_jax.ops import rasterize_pallas as rp  # noqa: E402
from luisacomputegaussiansplatting_jax.ops.projection import tile_grid  # noqa: E402
from luisacomputegaussiansplatting_jax.ops.rasterize_ref import (  # noqa: E402
    rasterize_reference,
)
from luisacomputegaussiansplatting_jax.ops.render import (  # noqa: E402
    prepare_view, render_aux,
)

OUT = os.path.join(ROOT, "chiprun_out")
SCOPES = ("blend_forward", "blend_backward", "grad_reduce", "expand",
          "entry_sort", "payload_gather")


def timed(f, *args, reps=5):
    """Mean ms per blocked call after one warm call."""
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def binned_payload(n, width, height, cfg, seed=0):
    args = bench_scene(n, seed).render_args()
    cam = headline_camera(width, height)
    binned, payload = jax.jit(
        lambda *a: prepare_view(*a, cam.to_view(), width, height, cfg)[1:3]
    )(*args)
    gx, _ = tile_grid(width, height, cfg.tile_wh)
    return binned, payload, gx


def sweep(steps=(1, 2, 4, 8), warps_set=(2, 4, 8)):
    n, kw, _ = CONFIGS["headline"]
    out = {}
    for tile, pack in ((32, "none"), (16, "chunk")):
        cfg = RenderConfig(**dict(kw, tile=tile, pack_mode=pack,
                                  max_pairs_sorted=None if pack == "chunk"
                                  else kw["max_pairs_sorted"],
                                  max_pairs=kw["max_pairs"] * (2 if tile == 16
                                                               else 1)))
        binned, payload, gx = binned_payload(n, WIDTH, HEIGHT, cfg)
        nt, pix = binned.tile_starts.shape[0], tile * tile
        res = jax.random.uniform(jax.random.PRNGKey(0), (nt, 8, pix))
        s, c = binned.tile_starts, binned.tile_counts
        rows = []
        for kind in ("fwd", "bwd"):
            for step in steps:
                for warps in warps_set:
                    lp = rp.Launch(step, warps)
                    if kind == "fwd":
                        f = jax.jit(lambda p, lp=lp: rp.rasterize_forward(
                            p, s, c, gx, WIDTH, HEIGHT, cfg, launch=lp))
                        a = (payload,)
                    else:
                        f = jax.jit(lambda p, r, lp=lp: rp.rasterize_backward(
                            p, s, c, r, gx, WIDTH, HEIGHT, cfg, launch=lp))
                        a = (payload, res)
                    try:
                        ms = timed(f, *a, reps=3)
                        rows.append([kind, step, warps, ms])
                    except Exception as e:  # report, keep sweeping
                        rows.append([kind, step, warps,
                                     f"error: {str(e)[:200]}"])
                    print(f"sweep tile{tile}: {rows[-1]}", flush=True)
        out[f"tile{tile}_{pack}"] = dict(
            entries=int(binned.num_rendered), rows=rows,
            default={k: rp.LAUNCH[(pix, k)].__dict__ for k in ("fwd", "bwd")})
    return out


def blend_vs_plain(n=250_000, width=800, height=800):
    import dataclasses

    out = {}
    for tile, pack in ((16, "chunk"), (32, "none")):
        cfg = RenderConfig(max_pairs=3_000_000, tile=tile, pack_mode=pack,
                           tile_cull=pack == "none")
        binned, _, _ = binned_payload(n, width, height, cfg)
        # trim the post-sort capacity to what the scene needs: the plain
        # blend materialises (capacity x pixels-per-tile) intermediates
        cfg = dataclasses.replace(
            cfg, max_pairs_sorted=int(binned.num_rendered) * 21 // 20 + 128)
        binned, payload, gx = binned_payload(n, width, height, cfg)
        nt, pix = binned.tile_starts.shape[0], tile * tile
        ct = (jax.random.normal(jax.random.PRNGKey(1), (nt, pix, 3)),
              jax.random.normal(jax.random.PRNGKey(2), (nt, pix, 1)))

        def fwd_bwd(fn):
            return jax.jit(lambda p, ct: jax.vjp(fn, p)[1](ct)[0])

        kern = fwd_bwd(lambda p: rp.rasterize_tiles(
            p, binned.tile_starts, binned.tile_counts, gx, width, height, cfg))
        plain = fwd_bwd(lambda p: rasterize_reference(
            p, binned, gx, width, height, cfg))
        row = dict(entries=int(binned.num_rendered))
        row["triton_ms"] = timed(kern, payload, ct)
        try:
            with jax.default_matmul_precision("highest"):
                row["plain_ms"] = timed(plain, payload, ct)
        except Exception as e:
            row["plain_ms"] = f"error: {str(e)[:300]}"
        # repeat the kernel so drift shows
        row["triton_ms_again"] = timed(kern, payload, ct)
        out[f"tile{tile}_{pack}"] = row
        print(f"blend {n}@{width}x{height} tile{tile}: {row}", flush=True)
    return out


def plain_at_2m():
    n, kw, _ = CONFIGS["headline"]
    cfg = RenderConfig(**kw)
    binned, payload, gx = binned_payload(n, WIDTH, HEIGHT, cfg)
    fn = jax.jit(lambda p: rasterize_reference(p, binned, gx, WIDTH, HEIGHT,
                                               cfg)[0].sum())
    out = dict(entries=int(binned.num_rendered),
               capacity=int(payload.shape[1]))
    try:
        comp = fn.lower(payload).compile()
        ma = comp.memory_analysis()
        out["temp_bytes"] = int(getattr(ma, "temp_size_in_bytes", -1))
        out["fwd_ms"] = timed(comp, payload, reps=2)
    except Exception as e:
        out["error"] = str(e)[:400]
    print(f"plain blend at 2M/1080p: {out}", flush=True)
    return out


def hlo_scopes(hlo_text: str):
    """HLO instruction name -> op_name metadata (named-scope path)."""
    m = {}
    for line in hlo_text.splitlines():
        mi = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        mo = re.search(r'op_name="([^"]*)"', line)
        if mi and mo:
            m[mi.group(1)] = mo.group(1)
    return m


def categorize(name: str, op_name: str) -> str:
    text = f"{name} {op_name}"
    for scope in SCOPES:
        if scope in text:
            return scope
    return "other"


def trace(reps=3):
    n, kw, _ = CONFIGS["headline"]
    cfg = RenderConfig(**kw)
    cam = headline_camera()
    args = bench_scene(n).render_args()

    def loss(*a):
        img, aux = render_aux(*a, cam, cfg=cfg)
        return jnp.sum(img), aux.overflow

    args = tuple(args)
    # trace the very executable whose HLO text names the scopes
    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True)).lower(*args).compile()
    scopes = hlo_scopes(step.as_text())
    jax.block_until_ready(step(*args))
    logdir = tempfile.mkdtemp(prefix="trace_headline_")
    with jax.profiler.trace(logdir):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(*args)
        jax.block_until_ready(out)
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    pb = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                          recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(pb)
    per_cat = collections.Counter()
    per_op = collections.Counter()
    unmapped = collections.Counter()
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = str(stats.get("hlo_op", ev.name))
                op_name = scopes.get(hlo) or scopes.get(ev.name) or str(
                    stats.get("tf_op", ""))
                if hlo not in scopes and ev.name not in scopes:
                    unmapped[f"{ev.name} | {sorted(stats)}"] += ev.duration_ns
                per_cat[categorize(ev.name + " " + hlo, op_name)] += (
                    ev.duration_ns)
                per_op[f"{ev.name} [{op_name[-80:]}]"] += ev.duration_ns
                spans.append((ev.start_ns, ev.end_ns))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    total = sum(per_cat.values())
    out = dict(
        wall_ms_per_step_traced=wall_ms,
        device_busy_ms_per_step=busy / reps / 1e6,
        device_window_ms_per_step=window / reps / 1e6,
        kernel_ms_per_step={k: v / reps / 1e6 for k, v in per_cat.items()},
        share_of_kernel_time={k: v / total for k, v in per_cat.items()},
        top_ops_ms=[(k, v / reps / 1e6) for k, v in per_op.most_common(25)],
        scope_map_size=len(scopes),
        unmapped_top=[(k[:200], v / reps / 1e6)
                      for k, v in unmapped.most_common(5)],
    )
    print(f"trace headline: {json.dumps(out, indent=1)}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="sweep,blend,plain2m,trace")
    ap.add_argument("--steps", default="1,2,4,8",
                    help="sweep: entries per step")
    ap.add_argument("--warps", default="2,4,8", help="sweep: warps")
    args = ap.parse_args()
    parts = args.only.split(",")
    backend.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (platform {dev.platform!r})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = dict(device=dev.device_kind, card=card)
    print(f"card: {card}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    fns = dict(
        sweep=lambda: sweep(tuple(map(int, args.steps.split(","))),
                            tuple(map(int, args.warps.split(",")))),
        blend=blend_vs_plain, plain2m=plain_at_2m, trace=trace)
    for part in parts:
        result[part] = fns[part]()
        with open(os.path.join(OUT, "gpu_breakdown.json"), "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
