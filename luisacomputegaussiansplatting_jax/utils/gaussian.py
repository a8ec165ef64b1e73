"""3D gaussian covariance construction and EWA screen-space projection.

Math parity (citations into /root/reference):
  * Sigma = R S S^T R^T from quaternion + scale:
    lcgs/include/lcgs/util/gaussian.hpp:15-28.
  * EWA first-order projection with focal-scaled Jacobian:
    gaussian.hpp:52-70 (the default `use_focal=true` path,
    lcgs/include/lcgs/gs_projector.h:42).
  * frustum clamp of the linearisation point t: gs_projector/shader.cpp:146-158.

EWA convention note: the reference composes `T = V3 @ J_std^T` and returns
`T^T Sigma T = J (V3^T Sigma V3) J^T`, i.e. it rotates the world covariance
by the *inverse* view rotation (gaussian.hpp:61-69 after the col-major
transposes are unfolded). The original graphdeco 3DGS CUDA rasterizer — the
validation oracle named by BASELINE.json — uses the standard
`J (V3 Sigma V3^T) J^T`. `ewa_mode="inria"` (default) implements the
standard form; `ewa_mode="lcgs"` reproduces the reference's variant for
strict parity runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .transform import rotation_from_quaternion

# ---------------------------------------------------------------------------
# Component-wise ("unstacked") variants.
#
# All hot per-gaussian math below operates on (N,) vectors and 3x3 python
# lists of them. This is the VPU-native layout AND it avoids f32[N, 1]
# intermediates in the backward pass, which XLA tiles to (8, 128) — a 128x
# memory expansion that OOMs multi-million-gaussian training steps (see
# utils/packing.py).
# ---------------------------------------------------------------------------


def rotation_elems(qx, qy, qz, qw):
    """3x3 rotation matrix elements from (x, y, z, w) quaternion components
    (parity: reference transform.hpp:188-212, unfolded row-major)."""
    return [
        [
            1 - 2 * (qy * qy + qz * qz),
            2 * (qx * qy - qz * qw),
            2 * (qx * qz + qy * qw),
        ],
        [
            2 * (qx * qy + qz * qw),
            1 - 2 * (qx * qx + qz * qz),
            2 * (qy * qz - qx * qw),
        ],
        [
            2 * (qx * qz - qy * qw),
            2 * (qy * qz + qx * qw),
            1 - 2 * (qx * qx + qy * qy),
        ],
    ]


def covariance_3d_elems(s, q):
    """Sigma = R S S^T R^T as 6 unique elements.

    Args:
      s: 3-tuple of (N,) exp-activated scales.
      q: 4-tuple of (N,) unit quaternion components (x, y, z, w).

    Returns:
      3x3 symmetric python matrix of (N,) arrays.
    """
    r = rotation_elems(*q)
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]
    cov = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for k in range(i, 3):
            cov[i][k] = cov[k][i] = sum(m[i][j] * m[k][j] for j in range(3))
    return cov


def view_rotate_cov_elems(cov, view3, ewa_mode="inria"):
    """Congruence transform of a symmetric 3x3 per-gaussian covariance by
    the (3, 3) view rotation: V Sigma V^T ("inria", standard EWA) or
    V^T Sigma V ("lcgs", the reference's variant — see module docstring).

    Args:
      cov: 3x3 python matrix of (N,) arrays (symmetric).
      view3: (3, 3) traced array (scalar elements).

    Returns:
      3x3 symmetric python matrix of (N,) arrays.
    """
    if ewa_mode == "inria":
        v = [[view3[i, j] for j in range(3)] for i in range(3)]
    elif ewa_mode == "lcgs":
        v = [[view3[j, i] for j in range(3)] for i in range(3)]
    else:
        raise ValueError(f"unknown ewa_mode: {ewa_mode!r}")
    # tmp = V @ Sigma
    tmp = [
        [sum(v[i][j] * cov[j][k] for j in range(3)) for k in range(3)]
        for i in range(3)
    ]
    out = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for l in range(i, 3):
            out[i][l] = out[l][i] = sum(
                tmp[i][k] * v[l][k] for k in range(3)
            )
    return out


def clamp_to_frustum_comps(px, py, pz, tan_fovx, tan_fovy, clamp_factor=1.3):
    """Component form of :func:`clamp_to_frustum`."""
    lim_x = clamp_factor * tan_fovx
    lim_y = clamp_factor * tan_fovy
    tx = jnp.clip(px / pz, -lim_x, lim_x) * pz
    ty = jnp.clip(py / pz, -lim_y, lim_y) * pz
    return tx, ty, pz


def ewa_project_cov_comps(sigma_view, tx, ty, tz, focal_x, focal_y):
    """J Sigma_view J^T for the sparse 2x3 pixel-space EWA Jacobian.

    Args:
      sigma_view: 3x3 python matrix of (N,) arrays (view-space covariance).
      tx, ty, tz: (N,) frustum-clamped view-space positions.

    Returns:
      (a, b, c): (N,) packed 2D covariance (before the low-pass filter).
    """
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    s00, s01, s02 = sigma_view[0][0], sigma_view[0][1], sigma_view[0][2]
    s11, s12, s22 = sigma_view[1][1], sigma_view[1][2], sigma_view[2][2]

    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)
    return a, b, c


def conic_and_radius_comps(a, b, c, lowpass=0.3, radius_sigma=3.0,
                           det_eps=1e-6, tight_sigma=None):
    """Component form of :func:`conic_and_radius`.

    tight_sigma: optional (N,) per-splat sigma reach (e.g.
    sqrt(2 ln(o/alpha_min)), the exact alpha_min cutoff distance). The
    radius then shrinks to min(radius_sigma, tight_sigma)-based discs.
    The +2 px margin absorbs the tile-rect formula's fractional
    truncation (floor((p + r + tw-1)/tw) covers pixels only up to
    p + r - 1, and an f32 floor flip at a tile boundary costs up to one
    tile row): with it, every pixel whose alpha can reach alpha_min
    stays inside the rect, keeping renders exact (up to reduction
    order regrouping) vs the full
    radius_sigma disc. tight_sigma <= 0 (opacity <= alpha_min) culls
    the splat outright.
    """
    a = a + lowpass
    c = c + lowpass
    det = a * c - b * b
    inv_det = 1.0 / (det + det_eps)
    conic = (c * inv_det, -b * inv_det, a * inv_det)
    mid = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.1, mid * mid - det))
    sq = jnp.sqrt(mid + disc)
    radius = jnp.ceil(radius_sigma * sq).astype(jnp.int32)
    if tight_sigma is not None:
        r_t = jnp.ceil(tight_sigma * sq).astype(jnp.int32) + 2
        radius = jnp.where(
            tight_sigma > 0.0, jnp.minimum(radius, r_t), 0
        )
    return conic, radius


def covariance_3d(scales, quats_xyzw):
    """World-space covariance Sigma = R S S^T R^T.

    Args:
      scales: (N, 3) positive scales (already exp-activated).
      quats_xyzw: (N, 4) unit quaternions in (x, y, z, w) order.

    Returns:
      (N, 3, 3) symmetric covariance matrices.
    """
    rot = rotation_from_quaternion(quats_xyzw)  # (N, 3, 3)
    m = rot * scales[..., None, :]  # R @ diag(s)
    # HIGHEST keeps f32 (default matmul precision may drop to TF32/bf16)
    return jnp.einsum(
        "...ij,...kj->...ik", m, m, precision=jax.lax.Precision.HIGHEST
    )


def clamp_to_frustum(p_view, tan_fovx, tan_fovy, clamp_factor=1.3):
    """Clamp the EWA linearisation point into an expanded view frustum
    (parity: gs_projector/shader.cpp:146-158)."""
    z = p_view[..., 2]
    lim_x = clamp_factor * tan_fovx
    lim_y = clamp_factor * tan_fovy
    x = jnp.clip(p_view[..., 0] / z, -lim_x, lim_x) * z
    y = jnp.clip(p_view[..., 1] / z, -lim_y, lim_y) * z
    return jnp.stack([x, y, z], axis=-1)


def ewa_project_cov(cov3d, t, view3, focal_x, focal_y, ewa_mode="inria"):
    """Project world covariances to 2D pixel-space covariances.

    Args:
      cov3d: (N, 3, 3) world covariance.
      t: (N, 3) frustum-clamped view-space positions.
      view3: (3, 3) rotation block of the world->view matrix.
      focal_x, focal_y: focal lengths in pixels.
      ewa_mode: "inria" (standard EWA; graphdeco-compatible) or "lcgs"
        (reference variant, see module docstring).

    Returns:
      (N, 3) packed upper-triangular 2D covariance (a, b, c) for
      [[a, b], [b, c]], in pixel^2 units (before the low-pass filter).
    """
    hi = jax.lax.Precision.HIGHEST
    if ewa_mode == "inria":
        sigma_view = jnp.einsum("ij,njk,lk->nil", view3, cov3d, view3, precision=hi)
    elif ewa_mode == "lcgs":
        sigma_view = jnp.einsum("ji,njk,kl->nil", view3, cov3d, view3, precision=hi)
    else:
        raise ValueError(f"unknown ewa_mode: {ewa_mode!r}")

    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    # J rows: d(pix)/d(view) for the two image axes (2x3 standard Jacobian).
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    s00 = sigma_view[..., 0, 0]
    s01 = sigma_view[..., 0, 1]
    s02 = sigma_view[..., 0, 2]
    s11 = sigma_view[..., 1, 1]
    s12 = sigma_view[..., 1, 2]
    s22 = sigma_view[..., 2, 2]

    # cov2d = J Sigma_view J^T, expanded for the sparse J.
    a = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    b = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)
    return jnp.stack([a, b, c], axis=-1)


def conic_and_radius(cov2d, lowpass=0.3, radius_sigma=3.0, det_eps=1e-6):
    """Low-pass filter, invert to conic, and bound the splat radius.

    Parity: gs_tile_splatter/shader.cpp:139-148 (+0.3 on the diagonal,
    conic = inv(cov), radius = ceil(3 * sqrt(max eigenvalue)); the sqrt
    argument is floored at 0.1 as in the reference's max(0.1f, ...)).

    Returns:
      conic: (N, 3) packed inverse covariance (A, B, C).
      radius: (N,) int32 pixel radius (ceil), 0 only if inputs degenerate.
    """
    a = cov2d[..., 0] + lowpass
    b = cov2d[..., 1]
    c = cov2d[..., 2] + lowpass
    det = a * c - b * b
    inv_det = 1.0 / (det + det_eps)
    conic = jnp.stack([c * inv_det, -b * inv_det, a * inv_det], axis=-1)
    mid = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.1, mid * mid - det))
    lambda_max = mid + disc
    radius = jnp.ceil(radius_sigma * jnp.sqrt(lambda_max)).astype(jnp.int32)
    return conic, radius
