"""Exchange bucket-occupancy skew at the 6M north-star scale.

Measures the occupancy distribution behind the sharded path's
per-(src,dst) bucket capacity (`ShardedRenderConfig.exchange_capacity`):
expand the 6M scene once on one device, then
for hypothetical mesh sizes ndev in {2,4,8,16} histogram entries by
  src = gid // (N / ndev)          (gaussian shard that emits the entry)
  dst = tile // tiles_per_dev      (tile band that rasterizes it)
which is EXACTLY the bucket length the sharded path computes per chip
(render_sharded.py cuts/owner_len — entries are tile-sorted so buckets
are contiguous slices). Prints, per ndev: total entries, per-src totals
(expansion capacity check), and the max/mean/p99 (src,dst) bucket, i.e.
the skew factor the exchange_capacity auto-derivation must cover.

Usage: python -u scripts/perf/exchange_skew.py [n_gaussians]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from luisacomputegaussiansplatting_jax import backend  # noqa: E402

backend.enable_compile_cache()

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import (
    random_scene_device,
)
from luisacomputegaussiansplatting_jax.ops.binning import expand_entries
from luisacomputegaussiansplatting_jax.ops.projection import (
    project_gaussians, tile_grid,
)
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

W, H = 1920, 1080
N = int(sys.argv[1]) if len(sys.argv) > 1 else 6_000_000
CFG = RenderConfig(max_pairs=13_000_000, tile=32, tile_cull=True)

cam = look_at_camera((3.5, -3.0, 2.2), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                     fov=65.0, width=W, height=H)
view = cam.to_view()
scene = random_scene_device(N, seed=0, extent=3.0, scale_range=(0.004, 0.02))
means, scales, quats, opac, sh = scene.render_args()
gx, gy = tile_grid(W, H, CFG.tile_wh)
num_tiles = gx * gy


# explicit args: closed-over arrays would embed as HLO constants
@jax.jit
def buckets(means, scales, quats, opac):
    proj = project_gaussians(means, scales, quats, view, CFG,
                             width=W, height=H)
    tile_id, depth, gid, total = expand_entries(
        proj, gx, num_tiles, CFG.max_pairs, opac, CFG.tile_wh, CFG.alpha_min,
    )
    valid = gid >= 0
    outs = {"total": total, "valid": valid.sum()}
    for ndev in (2, 4, 8, 16):
        p_shard = N // ndev
        rows_per_dev = -(-gy // ndev)
        tiles_per_dev = rows_per_dev * gx
        src = jnp.where(valid, gid // p_shard, 0)
        dst = jnp.where(valid, tile_id // tiles_per_dev, 0)
        flat = jnp.where(valid, src * ndev + dst, ndev * ndev)
        occ = jnp.bincount(flat, length=ndev * ndev + 1)[:-1]
        outs[f"occ{ndev}"] = occ
    return outs


t0 = time.perf_counter()
o = jax.tree.map(np.asarray, buckets(means, scales, quats, opac))
print(f"computed in {time.perf_counter()-t0:.0f}s  "
      f"total={o['total']} valid={o['valid']}", flush=True)
for ndev in (2, 4, 8, 16):
    occ = o[f"occ{ndev}"].reshape(ndev, ndev)
    per_src = occ.sum(axis=1)
    mx, mean = int(occ.max()), float(occ.mean())
    even = o["valid"] / (ndev * ndev)
    print(f"ndev={ndev:2d}: per-src max={per_src.max()} "
          f"(cap max_pairs_local), bucket max={mx} mean={mean:.0f} "
          f"even-share={even:.0f} skew=max/even={mx / even:.2f}",
          flush=True)
    print(f"  per-dst totals: {occ.sum(axis=0).tolist()}")
