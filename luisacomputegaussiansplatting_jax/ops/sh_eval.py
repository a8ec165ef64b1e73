"""Per-gaussian view-dependent colour from SH coefficients.

Equivalent of the reference SHProcessor kernel
(lcgs/src/sh_preprocessor.cpp:159-166 dispatches one thread per gaussian;
here the whole batch is one fused VPU-vectorised jnp expression that XLA
fuses into the surrounding render graph). Fully differentiable — including
the direction term the reference left TODO (lcgs/include/lcgs/util/sh.hpp).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.sh import eval_sh_color


def compute_colors(means, sh_coeffs, cam_pos, degree: int = 3):
    """RGB colour per gaussian.

    Args:
      means: (N, 3) gaussian centres (world space).
      sh_coeffs: (N, K, 3) SH coefficients, K >= (degree+1)^2.
      cam_pos: (3,) camera position.
      degree: active SH degree (0..3).

    Returns:
      (N, 3) RGB in [0, 1]; dir = normalize(mean - cam_pos) per
      reference sh_preprocessor.cpp:162-163.
    """
    from ..utils.packing import stack_cols, unstack_cols

    cam_pos = jnp.asarray(cam_pos, means.dtype)
    mx, my, mz = unstack_cols(means)
    dx, dy, dz = mx - cam_pos[0], my - cam_pos[1], mz - cam_pos[2]
    inv = 1.0 / jnp.maximum(jnp.sqrt(dx * dx + dy * dy + dz * dz), 1e-12)
    dirs = stack_cols(dx * inv, dy * inv, dz * inv)
    return eval_sh_color(sh_coeffs, dirs, degree)
