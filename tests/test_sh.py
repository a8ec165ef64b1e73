"""SH evaluation vs the independent numpy oracle."""

import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.ops.sh_eval import compute_colors
from luisacomputegaussiansplatting_jax.utils.sh import (
    eval_sh_color,
    num_sh_coeffs,
    sh_from_color,
)

from oracle import sh_color as oracle_sh_color


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_matches_oracle(degree):
    rng = np.random.default_rng(degree)
    n = 32
    sh = rng.normal(0, 0.5, (n, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    got = np.asarray(eval_sh_color(sh, dirs.astype(np.float32), degree))
    want = np.stack(
        [oracle_sh_color(sh[i], dirs[i], degree) for i in range(n)]
    )
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dc_only_roundtrip():
    colors = np.array([[0.2, 0.5, 0.9], [1.0, 0.0, 0.3]], np.float32)
    sh = np.zeros((2, 1, 3), np.float32)
    sh[:, 0, :] = np.asarray(sh_from_color(colors))
    dirs = np.array([[0, 0, 1.0], [1.0, 0, 0]], np.float32)
    got = np.asarray(eval_sh_color(sh, dirs, 0))
    np.testing.assert_allclose(got, colors, atol=1e-6)


def test_clamping():
    sh = np.full((1, 1, 3), 10.0, np.float32)
    out = np.asarray(eval_sh_color(sh, np.array([[0, 0, 1.0]], np.float32), 0))
    np.testing.assert_allclose(out, 1.0)
    out = np.asarray(
        eval_sh_color(-sh, np.array([[0, 0, 1.0]], np.float32), 0)
    )
    np.testing.assert_allclose(out, 0.0)


def test_num_coeffs():
    assert [num_sh_coeffs(d) for d in range(4)] == [1, 4, 9, 16]


def test_compute_colors_direction():
    # a gaussian straight ahead of the camera: dir = +front
    rng = np.random.default_rng(0)
    sh = rng.normal(0, 0.3, (1, 16, 3)).astype(np.float32)
    means = np.array([[0.0, 0.0, 5.0]], np.float32)
    got = np.asarray(compute_colors(means, sh, (0.0, 0.0, 0.0), 3))
    want = oracle_sh_color(sh[0], np.array([0.0, 0.0, 1.0]), 3)
    np.testing.assert_allclose(got[0], want, atol=1e-5)
