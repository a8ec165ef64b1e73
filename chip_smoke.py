#!/usr/bin/env python3
"""Smoke test of the renderer and trainer on one NVIDIA GPU.

    python3 chip_smoke.py                 # phases 0-3 on one card
    python3 chip_smoke.py --four-cards    # the sharded path on four cards

One process holds the card(s) throughout; every phase failure exits
non-zero and prints no result line.

  0. device   — JAX must see a GPU; prints the card, JAX and XLA setup.
  1. kernel   — the Triton blend kernels against the plain reference
                rasterizer (ops/rasterize_ref.py), forward image and
                d_payload, at tile 16 / pack "chunk" and tile 32 /
                pack "none".
  2. render   — jax.value_and_grad through ops/render.render_aux at the
                bench headline scene (2M gaussians, 1920x1080), with a
                band of tiles through the image centre compared against
                the plain reference on the same binned entries.
  3. train    — steps of the multi-view training step with densify
                statistics at a mip-NeRF 360-like size.
  --four-cards (only this phase): the sharded render on a ("gs",) 4-way
                mesh and the sharded train step on a ("data", "gs") 2x2
                mesh, compared with the single-card render and step.

The last line of standard output is
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: phase-1 limits (see PERF.md for the measured values beside them)
IMAGE_MAX_ABS = 1e-4
DPAYLOAD_REL_L2 = 1e-3
#: phase-4 limit on |sharded - single-card| image difference
SHARDED_IMAGE_MAX_ABS = 1e-4
#: phase-4 limit on the relative difference of the first-step losses
SHARDED_LOSS_REL = 1e-4


class PhaseError(RuntimeError):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise PhaseError(msg)


def _mib(x) -> float:
    return x / 2**20


def peak_bytes(dev) -> int:
    stats = dev.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------------


def phase_device(need: int = 1):
    """Fail unless JAX's first device is a GPU and ``need`` of them exist;
    print what is being measured on."""
    import jax

    from luisacomputegaussiansplatting_jax import backend

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= need, f"need {need} GPUs, JAX sees {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(card.returncode == 0, f"nvidia-smi failed: {card.stderr.strip()}")
    print(f"device: {devs[0].device_kind}, {len(devs)} visible")
    for line in card.stdout.strip().splitlines():
        print(f"card: {line}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r};"
          f" compile cache {backend.compile_cache_dir()}")
    return devs


# ---------------------------------------------------------------------------
# phase 1: kernel vs plain reference
# ---------------------------------------------------------------------------


def _rel_l2(a, b, mask):
    import numpy as np

    a = np.where(mask, np.asarray(a, np.float64), 0.0)
    b = np.where(mask, np.asarray(b, np.float64), 0.0)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den > 0 else float(
        np.linalg.norm(a))


def compare_kernel(n_gaussians: int, width: int, height: int, tile: int,
                   pack: str, max_pairs: int, seed: int = 0):
    """Blend-kernel image and d_payload against rasterize_reference on
    the entries the normal binning produces. Returns (image max |diff|,
    {field: d_payload relative L2})."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_scene, headline_camera
    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.ops.rasterize_pallas import (
        rasterize_tiles,
    )
    from luisacomputegaussiansplatting_jax.ops.rasterize_ref import (
        rasterize_reference,
    )
    from luisacomputegaussiansplatting_jax.ops.projection import tile_grid
    from luisacomputegaussiansplatting_jax.ops.render import prepare_view

    cfg = RenderConfig(max_pairs=max_pairs, tile=tile, pack_mode=pack,
                       tile_cull=pack == "none")
    cam = headline_camera(width, height)
    args = bench_scene(n_gaussians, seed).render_args()
    binned, payload = jax.jit(
        lambda *a: prepare_view(*a, cam.to_view(), width, height, cfg)[1:3]
    )(*args)
    gx, _gy = tile_grid(width, height, cfg.tile_wh)
    check(not bool(binned.overflow), f"phase 1 capacity overflow ({tile})")
    check(int(binned.num_rendered) > 0, "phase 1 rendered no entries")

    def run(fn):  # (output, d_payload) for cotangent ct
        return jax.jit(lambda p, ct: (lambda out, vjp: (out, vjp(ct)[0]))(
            *jax.vjp(fn, p)))

    def kern(p):
        return rasterize_tiles(p, binned.tile_starts, binned.tile_counts, gx,
                               width, height, cfg)

    def ref(p):
        return rasterize_reference(p, binned, gx, width, height, cfg)

    rng = np.random.default_rng(seed)
    nt, pix = binned.tile_starts.shape[0], tile * tile
    ct = (jnp.asarray(rng.normal(size=(nt, pix, 3)), jnp.float32),
          jnp.asarray(rng.normal(size=(nt, pix, 1)), jnp.float32))
    with jax.default_matmul_precision("highest"):
        (ck, tk), gk = run(kern)(payload, ct)
        (cr, tr), gr = run(ref)(payload, ct)
    img_err = max(float(jnp.max(jnp.abs(ck - cr))),
                  float(jnp.max(jnp.abs(tk - tr))))
    valid = np.asarray(binned.entry_gid) >= 0
    gk, gr = np.asarray(gk), np.asarray(gr)
    names = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity",
             "r", "g", "b")
    rel = {n: _rel_l2(gk[f], gr[f], valid) for f, n in enumerate(names)}
    return img_err, rel, int(binned.num_rendered)


def phase_kernel(n_gaussians=60_000, width=512, height=512,
                 max_pairs=1_500_000):
    for tile, pack in ((16, "chunk"), (32, "none")):
        img_err, rel, n = compare_kernel(n_gaussians, width, height, tile,
                                         pack, max_pairs)
        worst = max(rel, key=rel.get)
        print(f"phase 1 [tile {tile}, pack {pack}, {n} entries]: image "
              f"max|d| {img_err:.3e} (limit {IMAGE_MAX_ABS:.0e}); d_payload "
              f"rel L2 max {rel[worst]:.3e} at {worst} (limit "
              f"{DPAYLOAD_REL_L2:.0e}); "
              + " ".join(f"{k}={v:.2e}" for k, v in rel.items()))
        check(img_err <= IMAGE_MAX_ABS,
              f"kernel image differs from reference by {img_err:.3e}")
        check(rel[worst] <= DPAYLOAD_REL_L2,
              f"kernel d_payload[{worst}] rel L2 {rel[worst]:.3e}")


# ---------------------------------------------------------------------------
# phase 2: full-width render fwd+bwd
# ---------------------------------------------------------------------------


def band_vs_reference(args, cam, cfg, image, entry_budget: int):
    """Max |diff| between ``image`` (bg 0) and the plain reference on the
    binned entries of a run of tiles in the centre tile row."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from luisacomputegaussiansplatting_jax.ops.binning import BinnedGaussians
    from luisacomputegaussiansplatting_jax.ops.rasterize_ref import (
        rasterize_reference,
    )
    from luisacomputegaussiansplatting_jax.ops.projection import tile_grid
    from luisacomputegaussiansplatting_jax.ops.render import prepare_view

    w, h = cam.width, cam.height
    tw, th = cfg.tile_wh
    binned, payload = jax.jit(
        lambda *a: prepare_view(*a, cam.to_view(), w, h, cfg)[1:3])(*args)
    gx, gy = tile_grid(w, h, cfg.tile_wh)
    starts = np.asarray(binned.tile_starts)
    counts = np.asarray(binned.tile_counts)
    row = gy // 2
    c0 = c1 = gx // 2  # grow [c0, c1) outwards within the entry budget
    while c1 - c0 < gx:
        n0, n1 = max(c0 - 1, 0), min(c1 + 1, gx)
        t0, t1 = row * gx + n0, row * gx + n1 - 1
        if starts[t1] + counts[t1] - starts[t0] > entry_budget and c1 > c0:
            break
        c0, c1 = n0, n1
    t0, t1 = row * gx + c0, row * gx + c1 - 1
    s, e = int(starts[t0]), int(starts[t1] + counts[t1])
    tiles = c1 - c0
    sub = BinnedGaussians(
        entry_gid=binned.entry_gid[s:e],
        entry_tile=binned.entry_tile[s:e] - t0,
        tile_starts=jnp.asarray(starts[t0:t1 + 1] - s),
        tile_counts=jnp.asarray(counts[t0:t1 + 1]),
        num_rendered=jnp.int32(e - s), overflow=jnp.asarray(False),
    )
    with jax.default_matmul_precision("highest"):
        color, _t = jax.jit(lambda p: rasterize_reference(
            p, sub, gx, w, h, cfg, tile_offset=t0))(payload[:, s:e])
    ref = np.asarray(color).reshape(tiles, th, tw, 3).transpose(3, 1, 0, 2)
    ref = ref.reshape(3, th, tiles * tw)
    x0, y0 = c0 * tw, row * th
    got = np.asarray(image)[:, y0:y0 + th, x0:x0 + tiles * tw]
    ref = ref[:, :got.shape[1], :got.shape[2]]
    return float(np.abs(got - ref).max()), tiles, e - s


def phase_render(n_gaussians=None, width=None, height=None, cfg_kwargs=None,
                 reps=5, entry_budget=300_000):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import CONFIGS, HEIGHT, WIDTH, bench_scene, headline_camera
    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.ops.render import render_aux

    n_head, head_kwargs, _reps = CONFIGS["headline"]
    n_gaussians = n_gaussians or n_head
    width, height = width or WIDTH, height or HEIGHT
    cfg = RenderConfig(**(cfg_kwargs or head_kwargs))
    cam = headline_camera(width, height)
    args = bench_scene(n_gaussians).render_args()

    def loss(means, scales, quats, opac, sh, bg):
        img, aux = render_aux(means, scales, quats, opac, sh, cam,
                              bg_color=bg, cfg=cfg)
        return jnp.sum(img), (img, aux)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True))
    bg = jnp.zeros((3,), jnp.float32)
    t0 = time.perf_counter()
    (val, (img, aux)), grads = step(*args, bg)
    jax.block_until_ready(grads)
    compile_s = time.perf_counter() - t0
    check(not bool(aux.overflow), "phase 2 capacity overflow")
    check(int(aux.num_rendered) > 0, "phase 2 rendered nothing")
    check(bool(jnp.all(jnp.isfinite(img))), "phase 2 image not finite")
    for name, g in zip("means scales quats opacities sh".split(), grads):
        check(bool(jnp.all(jnp.isfinite(g))), f"phase 2 d{name} not finite")
    check(float(jnp.max(jnp.abs(grads[0]))) > 0, "phase 2 zero gradients")

    per_rep = []
    for _ in range(reps + 1):  # one more warm step, then blocked reps
        t0 = time.perf_counter()
        (val, (img, aux)), grads = step(*args, bg + val * 1e-20)
        jax.block_until_ready((val, grads))
        per_rep.append((time.perf_counter() - t0) * 1e3)
    per_rep = per_rep[1:]
    step_ms = sorted(per_rep)[len(per_rep) // 2]
    peak = peak_bytes(jax.devices()[0])
    mem = step.lower(*args, bg).compile().memory_analysis()

    band_err, tiles, entries = band_vs_reference(args, cam, cfg, img,
                                                 entry_budget)
    print(f"phase 2 [{n_gaussians} gaussians, {width}x{height}, tile "
          f"{cfg.tile}, pack {cfg.pack_mode}]: num_rendered "
          f"{int(aux.num_rendered)}; compile+first step {compile_s:.1f} s; "
          f"fwd+bwd {step_ms:.2f} ms/step (median of {reps} blocked reps: "
          + " ".join(f"{t:.2f}" for t in per_rep) + "); step memory: temp "
          f"{_mib(mem.temp_size_in_bytes):.0f} MiB + args "
          f"{_mib(mem.argument_size_in_bytes):.0f} MiB + out "
          f"{_mib(mem.output_size_in_bytes):.0f} MiB; process peak "
          f"{_mib(peak):.0f} MiB; centre band {tiles} tiles / {entries} "
          f"entries vs reference max|d| {band_err:.3e} (limit "
          f"{IMAGE_MAX_ABS:.0e})")
    check(band_err <= IMAGE_MAX_ABS,
          f"phase 2 band differs from reference by {band_err:.3e}")
    return step_ms


# ---------------------------------------------------------------------------
# phase 3: training steps
# ---------------------------------------------------------------------------


def train_setup(n_active, capacity, width, height, n_views, seed=1):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_scene
    from luisacomputegaussiansplatting_jax.models.densify import (
        init_densify_state,
    )
    from luisacomputegaussiansplatting_jax.models.gaussians import (
        pad_params_to,
    )
    from luisacomputegaussiansplatting_jax.models.trainer import (
        init_train_state,
    )
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    params = pad_params_to(bench_scene(n_active, seed).to_params(), capacity)
    state, opt = init_train_state(params)
    dstate = init_densify_state(n_active, capacity)
    cams = [
        look_at_camera((4.0 * np.cos(a), 4.0 * np.sin(a), 1.5), (0, 0, 0),
                       (0, 0, 1), fov=60.0, width=width, height=height)
        for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False)
    ]
    views = jax.tree.map(lambda *xs: jnp.stack(xs), *[c.to_view() for c in cams])
    targets = jax.random.uniform(jax.random.PRNGKey(seed),
                                 (n_views, 3, height, width), jnp.float32)
    return state, opt, dstate, views, targets


def phase_train(n_active=1_000_000, capacity=2_000_000, width=1237,
                height=822, n_views=4, steps=5, max_pairs=3_000_000):
    import jax
    import jax.numpy as jnp

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.models.trainer import (
        make_batched_train_step,
    )

    cfg = RenderConfig(max_pairs=max_pairs, tile=32, pack_mode="none",
                       tile_cull=True)
    state, opt, dstate, views, targets = train_setup(
        n_active, capacity, width, height, n_views)
    step = make_batched_train_step(opt, width, height, cfg=cfg, sh_degree=3)
    means0 = jnp.array(state.params.means)
    t0 = time.perf_counter()
    mem = step.lower(state, dstate, views, targets).compile().memory_analysis()
    print(f"phase 3 step memory: temp {_mib(mem.temp_size_in_bytes):.0f} MiB"
          f" + args {_mib(mem.argument_size_in_bytes):.0f} MiB + out "
          f"{_mib(mem.output_size_in_bytes):.0f} MiB", flush=True)
    state, dstate, loss, overflow = step(state, dstate, views, targets)
    jax.block_until_ready(state)
    compile_s = time.perf_counter() - t0
    losses = [float(loss)]
    check(not bool(overflow), "phase 3 capacity overflow")
    per_rep = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        state, dstate, loss, overflow = step(state, dstate, views, targets)
        jax.block_until_ready(state)
        per_rep.append((time.perf_counter() - t0) * 1e3)
    step_ms = sorted(per_rep)[len(per_rep) // 2]
    losses.append(float(loss))
    moved = float(jnp.max(jnp.abs(state.params.means - means0)))
    seen = int(jnp.sum(dstate.count > 0))
    peak = peak_bytes(jax.devices()[0])
    print(f"phase 3 [{n_active} active / {capacity} capacity, {n_views} "
          f"views of {width}x{height}, SH 3]: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; compile+first step {compile_s:.1f} s; "
          f"{step_ms:.2f} ms/step (median of {steps - 1} blocked: "
          + " ".join(f"{t:.2f}" for t in per_rep) + f"); params moved "
          f"{moved:.3e}; {seen} gaussians with densify stats; peak "
          f"{_mib(peak):.0f} MiB")
    check(all(map(lambda v: v == v and abs(v) < float("inf"), losses)),
          f"phase 3 loss not finite: {losses}")
    check(moved > 0, "phase 3 parameters did not move")
    check(seen > 0, "phase 3 accumulated no densify statistics")
    check(not bool(overflow), "phase 3 capacity overflow")


# ---------------------------------------------------------------------------
# --four-cards: the sharded path
# ---------------------------------------------------------------------------


def phase_sharded(n_gaussians=1_000_000, width=1920, height=1080,
                  max_pairs=3_000_000, train_width=1237, train_height=822,
                  train_active=500_000, train_capacity=1_000_000):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import bench_scene, headline_camera
    from luisacomputegaussiansplatting_jax.config import CHUNK, RenderConfig
    from luisacomputegaussiansplatting_jax.models.trainer import (
        make_batched_train_step,
    )
    from luisacomputegaussiansplatting_jax.parallel.mesh import make_mesh
    from luisacomputegaussiansplatting_jax.parallel.render_sharded import (
        ShardedRenderConfig, render_sharded,
    )
    from luisacomputegaussiansplatting_jax.parallel.train_sharded import (
        make_sharded_train_step,
    )
    from luisacomputegaussiansplatting_jax.ops.render import render

    ndev = 4
    devs = jax.devices()[:ndev]
    cfg = RenderConfig(max_pairs=max_pairs, tile=32, pack_mode="none",
                       tile_cull=True)
    local = -(-max_pairs // ndev // CHUNK) * CHUNK
    scfg = ShardedRenderConfig(max_pairs_local=local)

    # sharded render on a 4-way ("gs",) mesh vs the single-card render
    cam = headline_camera(width, height)
    args = bench_scene(n_gaussians).render_args()
    mesh = make_mesh((ndev,), ("gs",), devices=devs)
    t0 = time.perf_counter()
    img_s, aux = jax.jit(lambda *a: render_sharded(
        *a, cam, mesh, cfg=cfg, scfg=scfg))(*args)
    img_s = np.asarray(img_s)
    t_s = time.perf_counter() - t0
    check(not bool(aux.overflow), "sharded render overflow")
    with jax.default_device(devs[0]):
        img_1 = np.asarray(jax.jit(lambda *a: render(*a, cam, cfg=cfg))(*args))
    err = float(np.abs(img_s - img_1).max())
    print(f"four-cards render [{n_gaussians} gaussians, {width}x{height}, "
          f"mesh gs={ndev}]: {int(aux.num_rendered)} entries; compile+first "
          f"{t_s:.1f} s; |sharded - single| max {err:.3e} (limit "
          f"{SHARDED_IMAGE_MAX_ABS:.0e})")
    check(err <= SHARDED_IMAGE_MAX_ABS,
          f"sharded render differs from single-card by {err:.3e}")

    # sharded train step on a 2x2 ("data", "gs") mesh vs one card
    state, opt, dstate, views, targets = train_setup(
        train_active, train_capacity, train_width, train_height, 2)
    mesh2 = make_mesh((2, 2), ("data", "gs"), devices=devs)
    tcfg = RenderConfig(max_pairs=max_pairs, tile=32, pack_mode="none",
                        tile_cull=True)
    tlocal = -(-max_pairs // 2 // CHUNK) * CHUNK
    step_s, _opt, pad_t = make_sharded_train_step(
        mesh2, train_width, train_height, cfg=tcfg,
        scfg=ShardedRenderConfig(max_pairs_local=tlocal), densify=True)
    t0 = time.perf_counter()
    state_s, dstate_s, loss_s, ov_s = step_s(state, dstate, views,
                                            pad_t(targets))
    loss_s = float(loss_s)
    t_c = time.perf_counter() - t0
    # the first call's inputs live on one card and its outputs on the
    # mesh: the second call compiles again for the sharded inputs
    for _ in range(4):
        t0 = time.perf_counter()
        state_s, dstate_s, loss_k, ov_k = step_s(state_s, dstate_s, views,
                                                pad_t(targets))
        jax.block_until_ready(state_s)
        step_ms = (time.perf_counter() - t0) * 1e3
    # last: the single-card step donates ``state`` on the GPU route
    step_1 = make_batched_train_step(opt, train_width, train_height, cfg=tcfg)
    with jax.default_device(devs[0]):
        _s1, _d1, loss_1, ov_1 = step_1(state, dstate, views, targets)
        loss_1 = float(loss_1)
    rel = abs(loss_s - loss_1) / max(abs(loss_1), 1e-12)
    print(f"four-cards train [{train_active} active / {train_capacity}, 2 "
          f"views of {train_width}x{train_height}, mesh data=2 x gs=2]: "
          f"loss {loss_s:.6f} vs single-card {loss_1:.6f} (rel "
          f"{rel:.2e}, limit {SHARDED_LOSS_REL:.0e}); compile+first "
          f"{t_c:.1f} s; {step_ms:.2f} ms/step (4th blocked step)")
    check(not bool(ov_s) and not bool(ov_1), "sharded train overflow")
    check(rel <= SHARDED_LOSS_REL, f"sharded loss differs: rel {rel:.2e}")
    check(np.isfinite(float(loss_k)), "sharded train loss not finite")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        import jax

        from luisacomputegaussiansplatting_jax import backend
    except ImportError as e:
        print(f"chip_smoke: FAIL: cannot import the package: {e}",
              file=sys.stderr)
        return 2
    backend.enable_compile_cache()
    need = 4 if args.four_cards else 1
    try:
        phase_device(need)
        if args.four_cards:
            phase_sharded()
        else:
            phase_kernel()
            phase_render()
            phase_train()
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
