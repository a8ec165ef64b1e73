"""The profiling APIs must run and return the documented stage keys.

(The reference's only instrumentation is a wall clock around its frame
loop, app/main.cpp:225,317-320 — stage attribution is framework-added.)
"""

from luisacomputegaussiansplatting_jax.config import RenderConfig
from luisacomputegaussiansplatting_jax.io.synthetic import random_scene
from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera
from luisacomputegaussiansplatting_jax.utils.profiling import (
    backward_timings,
    stage_timings,
)

CAM = look_at_camera((3.2, -2.8, 2.1), (0, 0, 0), (0, 0, 1),
                     fov=70.0, width=64, height=64)


def test_stage_timings_keys():
    sc = random_scene(150, seed=2, scale_range=(0.02, 0.12))
    out = stage_timings(sc, CAM, RenderConfig(max_pairs=30_000), reps=1)
    for k in ("sh_eval", "projection", "binning", "payload",
              "rasterize_fwd", "full_forward", "full_fwd_bwd"):
        assert k in out and out[k] >= 0.0, k


def test_backward_timings_stages_production_config():
    """The VJP attribution must cover the production fast config
    (fused sort, bf16 payload, tile cull)."""
    sc = random_scene(150, seed=2, scale_range=(0.02, 0.12))
    cfg = RenderConfig(max_pairs=30_000, tile=32, pack_mode="none",
                       tile_cull=True, sort_mode="fused",
                       payload_dtype="bf16")
    out = backward_timings(sc, CAM, cfg, reps=2)
    for k in ("forward", "rast_bwd", "reduce_bwd", "params_bwd",
              "fwd_bwd_total"):
        assert k in out and out[k] >= 0.0, k
