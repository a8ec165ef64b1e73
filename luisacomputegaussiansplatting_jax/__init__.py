"""LuisaComputeGaussianSplatting in JAX: a differentiable 3D Gaussian
splatting framework built from scratch in JAX/XLA/Pallas.

Feature-parity target: LuisaGroup/LuisaComputeGaussianSplatting (forward
renderer: SH eval -> EWA projection -> tile binning/sort -> alpha-blend
rasterization), re-designed as one static-shape XLA program per frame,
plus the backward pass, multi-device sharding and training that the
reference lacks.

Public API::

    from luisacomputegaussiansplatting_jax import (
        Camera, RenderConfig, GaussianScene, render, load_ply, save_ply,
    )
"""

from .config import RenderConfig, TILE
from .utils.camera import Camera, look_at_camera
from .models.gaussians import GaussianScene, GaussianParams
from .ops.render import render, render_aux
from .io.ply import load_ply, save_ply
from .io.synthetic import create_cube_scene, random_scene

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "look_at_camera",
    "RenderConfig",
    "GaussianScene",
    "GaussianParams",
    "render",
    "render_aux",
    "load_ply",
    "save_ply",
    "create_cube_scene",
    "random_scene",
    "TILE",
    "__version__",
]
