"""Synthetic scene generators for tests and benchmarks.

The reference ships a debug cube generator (app/gaussians.cpp:47-73,
GaussiansData::create_cube) and relies on released .ply scenes for
everything else; since those scenes are not redistributable, the benchmark
harness here uses reproducible random scenes with realistic statistics
instead.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..models.gaussians import GaussianScene
from ..utils.sh import num_sh_coeffs, sh_from_color


def create_cube_scene(
    origin=(-1.0, -1.0, -1.0),
    side=(2.0, 2.0, 2.0),
    nx: int = 8,
    scale: float = 0.05,
    opacity: float = 0.8,
    sh_degree: int = 3,
) -> GaussianScene:
    """Regular grid of isotropic gaussians coloured by normalised position
    (reference parity: app/gaussians.cpp:47-73 generates the same grid)."""
    u = np.arange(nx, dtype=np.float32) / nx
    grid = np.stack(np.meshgrid(u, u, u, indexing="ij"), axis=-1).reshape(-1, 3)
    means = np.asarray(origin, np.float32) + grid * np.asarray(side, np.float32)
    n = means.shape[0]
    k = num_sh_coeffs(sh_degree)
    colors = grid  # position-coded RGB
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = np.asarray(sh_from_color(colors))
    quats = np.zeros((n, 4), np.float32)
    quats[:, 3] = 1.0
    return GaussianScene(
        means=jnp.asarray(means),
        scales=jnp.full((n, 3), scale, jnp.float32),
        quats=jnp.asarray(quats),
        opacities=jnp.full((n,), opacity, jnp.float32),
        sh=jnp.asarray(sh),
    )


def random_scene(
    n: int,
    seed: int = 0,
    extent: float = 3.0,
    scale_range=(0.01, 0.15),
    sh_degree: int = 3,
    sh_rest_std: float = 0.05,
) -> GaussianScene:
    """Reproducible random scene with anisotropic, rotated gaussians."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    log_lo, log_hi = np.log(scale_range[0]), np.log(scale_range[1])
    scales = np.exp(rng.uniform(log_lo, log_hi, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opacities = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    k = num_sh_coeffs(sh_degree)
    sh = np.zeros((n, k, 3), np.float32)
    base = rng.uniform(0.05, 0.95, (n, 3))
    sh[:, 0, :] = np.asarray(sh_from_color(base))
    if k > 1:
        sh[:, 1:, :] = rng.normal(0.0, sh_rest_std, (n, k - 1, 3))
    return GaussianScene(
        means=jnp.asarray(means),
        scales=jnp.asarray(scales),
        quats=jnp.asarray(quats),
        opacities=jnp.asarray(opacities),
        sh=jnp.asarray(sh),
    )


def random_scene_device(
    n: int,
    seed: int = 0,
    extent: float = 3.0,
    scale_range=(0.01, 0.15),
    sh_degree: int = 3,
    sh_rest_std: float = 0.05,
) -> GaussianScene:
    """random_scene generated ON DEVICE with jax.random (same
    distributions, different realization).

    Use for benchmark-scale scenes: host-side numpy generation of
    ~1.4 GB (6M gaussians) plus its upload is slow; this path builds the
    arrays where they are consumed. Tests keep the numpy random_scene (their
    fixtures/goldens depend on its exact values).
    """
    import functools

    import jax

    log_lo = float(np.log(scale_range[0]))
    log_hi = float(np.log(scale_range[1]))
    k = num_sh_coeffs(sh_degree)

    @functools.partial(jax.jit, static_argnums=())
    def gen(key):
        ks = jax.random.split(key, 6)
        means = jax.random.uniform(
            ks[0], (n, 3), jnp.float32, -extent, extent
        )
        scales = jnp.exp(
            jax.random.uniform(ks[1], (n, 3), jnp.float32, log_lo, log_hi)
        )
        quats = jax.random.normal(ks[2], (n, 4), jnp.float32)
        quats = quats / jnp.linalg.norm(quats, axis=1, keepdims=True)
        opacities = jax.random.uniform(ks[3], (n,), jnp.float32, 0.2, 0.95)
        base = jax.random.uniform(ks[4], (n, 3), jnp.float32, 0.05, 0.95)
        sh0 = sh_from_color(base)[:, None, :]
        if k > 1:
            rest = (
                jax.random.normal(ks[5], (n, k - 1, 3), jnp.float32)
                * sh_rest_std
            )
            sh = jnp.concatenate([sh0, rest], axis=1)
        else:
            sh = sh0
        return means, scales, quats, opacities, sh

    means, scales, quats, opacities, sh = gen(jax.random.PRNGKey(seed))
    return GaussianScene(
        means=means, scales=scales, quats=quats, opacities=opacities, sh=sh
    )
