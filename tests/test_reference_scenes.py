"""Real-scene validation against the reference's published renders.

The reference repo's ground truth is the pair of CUDA-backend renders it
publishes (README.md:51-65):

  * doc/nerf_blender_lego_30000_cuda.png   (blender world)
  * doc/mip360_bicycle_30000_cuda.png      (colmap world)

rendered at the hard-coded lego/bicycle pose (app/main.cpp:194-196,
commented block: pos (-3, -0.5, 2.3), target (0, 0, 0.5), world_up
(0, -1, 0), switched to (0, 0, 1) for blender worlds at main.cpp:199-202)
at the default 1600x1063 resolution (main.cpp:38) with fov 60
(util/camera.h:19).

The scene PLYs (release downloads, README.md:25-29) are NOT in this
environment, so these tests skip unless you point LCGS_SCENE_DIR at a
directory containing them:

    export LCGS_SCENE_DIR=/path/to/scenes   # nerf_blender_lego_30000.ply etc.
    python -m pytest tests/test_reference_scenes.py -v

Equivalent CLI recipe (strict reference-parity mode):

    python -m luisacomputegaussiansplatting_jax.apps.render_cli \
        --ply $LCGS_SCENE_DIR/nerf_blender_lego_30000.ply \
        --res 1600x1063 --cam-pos="-3,-0.5,2.3" --cam-target 0,0,0.5 \
        --world blender --ewa lcgs --rect lcgs --tile 16 --out /tmp/r

then compare /tmp/r/*.png against /root/reference/doc/*_cuda.png.
"""

import os

import numpy as np
import pytest

SCENE_DIR = os.environ.get("LCGS_SCENE_DIR", "/root/scenes")
REF_DOC = "/root/reference/doc"

CASES = [
    # (ply name, golden png, world up) — pose per app/main.cpp:194-202
    (
        "nerf_blender_lego_30000.ply",
        "nerf_blender_lego_30000_cuda.png",
        (0.0, 0.0, 1.0),  # blender world
    ),
    (
        "mip360_bicycle_30000.ply",
        "mip360_bicycle_30000_cuda.png",
        (0.0, -1.0, 0.0),  # colmap world at the lego/bicycle pose block
    ),
]


def _have(ply):
    return os.path.exists(os.path.join(SCENE_DIR, ply))


@pytest.mark.parametrize("ply,golden,world_up", CASES,
                         ids=[c[0].split("_")[-2] for c in CASES])
def test_matches_reference_published_render(ply, golden, world_up):
    if not _have(ply):
        pytest.skip(
            f"{ply} not present: the build env has zero egress (DNS "
            "resolution fails; the GitHub release URLs in reference "
            "README.md:25-29 are unreachable by construction) and no "
            "local copy exists. External pixel parity is proxied by (1) "
            "the on-card kernel-vs-reference checks (chip_smoke.py), "
            "(2) golden pins vs the numpy oracle "
            "(tests/test_golden.py), and (3) exact activation/pose/"
            "constant parity cited per reference file:line throughout. "
            "Set LCGS_SCENE_DIR to run this test when the PLYs exist."
        )
    from PIL import Image

    from luisacomputegaussiansplatting_jax.config import RenderConfig
    from luisacomputegaussiansplatting_jax.io.ply import load_ply
    from luisacomputegaussiansplatting_jax.ops.render import render_aux
    from luisacomputegaussiansplatting_jax.utils.camera import look_at_camera

    w, h = 1600, 1063  # main.cpp:38
    scene = load_ply(os.path.join(SCENE_DIR, ply))
    cam = look_at_camera(
        (-3.0, -0.5, 2.3), (0.0, 0.0, 0.5), world_up,
        fov=60.0, width=w, height=h,
    )
    cfg = RenderConfig(max_pairs=20_000_000, tile=16, rect_mode="lcgs")
    img, aux = render_aux(
        *scene.render_args(), cam, bg_color=(0.0, 0.0, 0.0), cfg=cfg,
        sh_degree=3, ewa_mode="lcgs",
    )
    assert not bool(np.asarray(aux.overflow))
    # renderer rows are bottom-up; the published PNG is upright
    ours = np.transpose(np.asarray(img), (1, 2, 0))[::-1]
    ref = np.asarray(Image.open(os.path.join(REF_DOC, golden)).convert("RGB"),
                     np.float32) / 255.0
    assert ref.shape == ours.shape, (ref.shape, ours.shape)
    mad = float(np.abs(ours - ref).mean())
    mse = float(((ours - ref) ** 2).mean())
    psnr = -10.0 * np.log10(max(mse, 1e-12))
    # strict-parity mode: small residuals from fp order + sort-tie breaks
    assert mad < 0.01, f"mean abs diff {mad:.4f} vs published render"
    assert psnr > 30.0, f"PSNR {psnr:.1f} dB vs published render"
