"""The per-gaussian gradient reduction (ops.render.reduce_rows_by_id, a
plain segment-sum) against a numpy oracle, and the payload-gather VJP
built on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from luisacomputegaussiansplatting_jax.ops.render import (
    gather_payload,
    reduce_rows_by_id,
)


def _oracle(gid, rows, n_out):
    out = np.zeros((n_out, rows.shape[1]), np.float64)
    for g, r in zip(np.asarray(gid), np.asarray(rows, np.float64)):
        if 0 <= g < n_out:
            out[g] += r
    return out


def _check(gid, rows, n_out):
    got = np.asarray(jax.jit(reduce_rows_by_id, static_argnums=2)(
        jnp.asarray(gid), jnp.asarray(rows), n_out))
    want = _oracle(gid, rows, n_out)
    assert got.shape == (n_out, rows.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_sum_matches_oracle(seed):
    """Unsorted ids, repeated ids, some dropped (gid < 0)."""
    rng = np.random.default_rng(seed)
    n_out, L = 300, 5000
    gid = rng.integers(-1, n_out, L).astype(np.int32)
    rows = rng.normal(size=(L, 9)).astype(np.float32)
    _check(gid, rows, n_out)


def test_dropped_rows_never_read():
    """gid < 0 rows hold garbage (unwritten backward-kernel slots): NaN
    and inf there must not reach any sum."""
    rng = np.random.default_rng(3)
    n_out, L = 50, 800
    gid = rng.integers(0, n_out, L).astype(np.int32)
    rows = rng.normal(size=(L, 9)).astype(np.float32)
    gid[::3] = -1
    rows[::3] = np.nan
    rows[1::6] = np.where(gid[1::6, None] < 0, np.inf, rows[1::6])
    _check(gid, np.where(gid[:, None] < 0, 0.0, rows).astype(np.float32),
           n_out)
    got = np.asarray(reduce_rows_by_id(jnp.asarray(gid), jnp.asarray(rows),
                                       n_out))
    assert np.isfinite(got).all()


def test_empty_segments_are_zero():
    """Ids cluster on a few gaussians; every other output row is 0."""
    rng = np.random.default_rng(4)
    n_out, L = 1000, 3000
    gid = rng.choice([3, 500, 999], L).astype(np.int32)
    rows = rng.normal(size=(L, 9)).astype(np.float32)
    got = np.asarray(reduce_rows_by_id(jnp.asarray(gid), jnp.asarray(rows),
                                       n_out))
    untouched = np.setdiff1d(np.arange(n_out), [3, 500, 999])
    assert np.all(got[untouched] == 0.0)
    _check(gid, rows, n_out)


def test_large_id_gaps():
    """Sparse ids spread over a large table (big gaps between them)."""
    rng = np.random.default_rng(5)
    n_out = 200_000
    ids = np.array([0, 7, 65_536, 131_071, 199_999], np.int32)
    gid = rng.choice(ids, 4000).astype(np.int32)
    gid[:100] = -1
    rows = rng.normal(size=(4000, 3)).astype(np.float32)
    got = np.asarray(reduce_rows_by_id(jnp.asarray(gid), jnp.asarray(rows),
                                       n_out))
    want = _oracle(gid, rows, n_out)
    np.testing.assert_allclose(got[ids], want[ids], rtol=1e-5, atol=1e-5)
    mask = np.ones(n_out, bool)
    mask[ids] = False
    assert np.all(got[mask] == 0.0)


@pytest.mark.parametrize("payload_dtype", ["f32", "bf16"])
def test_gather_payload_grad_matches_dense(payload_dtype):
    """gather_payload's custom VJP == autodiff of the plain gather."""
    rng = np.random.default_rng(7)
    n, cap = 37, 4096
    table = jnp.asarray(rng.normal(size=(n, 9)).astype(np.float32))
    gid = jnp.asarray(np.where(rng.random(cap) < 0.2, -1,
                               rng.integers(0, n, cap)).astype(np.int32))
    ct = jnp.asarray(rng.normal(size=(9, cap)).astype(np.float32))

    def f(t):
        return jnp.vdot(gather_payload(t, gid, n, payload_dtype), ct)

    def f_ref(t):
        safe = jnp.maximum(gid, 0)
        rows = jnp.where((gid >= 0)[:, None], jnp.take(t, safe, axis=0), 0.0)
        return jnp.vdot(rows.T, ct)

    g = jax.grad(f)(table)
    g_ref = jax.grad(f_ref)(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-4,
                               atol=1e-5)
