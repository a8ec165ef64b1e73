"""Unit tests for the exchange VJPs (parallel/exchange_vjp).

Each op's custom VJP must equal the autodiff gradient of its plain
jnp.take formulation (which XLA would lower to scatter-add — the point
of the custom path is identical math, different movement).
Single-process CPU, no mesh: all ops except the all_to_all composite are
collective-free.
"""

import jax
import jax.numpy as jnp
import numpy as np

from luisacomputegaussiansplatting_jax.parallel.exchange_vjp import (
    _bucket_inverse,
    _invperm,
    pack_gather,
    permute_rows,
    slice_buckets,
    take_table_rows,
)


def _rand(shape, seed=0):
    return jnp.asarray(
        np.random.default_rng(seed).normal(size=shape), jnp.float32
    )


def _grads_match(custom_fn, ref_fn, table, d_seed=1):
    out = custom_fn(table)
    ref = ref_fn(table)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    w = _rand(out.shape, d_seed)
    g_c = jax.grad(lambda t: jnp.sum(custom_fn(t) * w))(table)
    g_r = jax.grad(lambda t: jnp.sum(ref_fn(t) * w))(table)
    np.testing.assert_allclose(
        np.asarray(g_c), np.asarray(g_r), rtol=1e-6, atol=1e-6
    )


def test_take_table_rows_matches_autodiff():
    table = _rand((13, 9))
    gid = jnp.asarray([0, 5, 5, -1, 12, 3, 5, -1, 0], jnp.int32)

    def ref(t):
        return jnp.where(
            gid[:, None] >= 0, jnp.take(t, jnp.maximum(gid, 0), axis=0), 0.0
        )

    _grads_match(lambda t: take_table_rows(t, gid), ref, table)


def test_slice_buckets_matches_autodiff():
    rows = _rand((20, 4), seed=2)
    # buckets [0:3) [3:3) [3:11) [11:15); rows 15.. unassigned; bucket 2
    # overflows bcap=6 (rows 9,10 dropped)
    cuts = jnp.asarray([0, 3, 3, 11, 15], jnp.int32)
    bcap = 6

    def ref(r):
        j = jnp.arange(bcap, dtype=jnp.int32)[None, :]
        src = jnp.clip(cuts[:-1][:, None] + j, 0, r.shape[0] - 1)
        valid = j < (cuts[1:] - cuts[:-1])[:, None]
        return jnp.where(valid[..., None], jnp.take(r, src, axis=0), 0.0)

    _grads_match(lambda r: slice_buckets(r, cuts, bcap), ref, rows)


def test_permute_rows_matches_autodiff():
    rows = _rand((17, 5), seed=3)
    perm = jnp.asarray(np.random.default_rng(4).permutation(17), jnp.int32)
    _grads_match(
        lambda r: permute_rows(r, perm),
        lambda r: jnp.take(r, perm, axis=0),
        rows,
    )


def test_pack_gather_matches_autodiff():
    from luisacomputegaussiansplatting_jax.ops.binning import pack_ranges

    rows = _rand((12, 3), seed=5)
    # sorted tiles with a sentinel tail (tile 4 = invalid for T=4)
    s_tile = jnp.asarray([0, 0, 0, 1, 2, 2, 2, 2, 2, 4, 4, 4], jnp.int32)
    T, cap = 4, 24
    src, in_range, _st, starts, _cnt = pack_ranges(s_tile, T, cap)
    tids = jnp.arange(T, dtype=jnp.int32)
    range_start = jnp.searchsorted(s_tile, tids, side="left").astype(jnp.int32)
    k = jnp.arange(s_tile.shape[0], dtype=jnp.int32)
    t_safe = jnp.clip(s_tile, 0, T - 1)
    slot = jnp.where(
        s_tile < T,
        jnp.take(starts, t_safe) + (k - jnp.take(range_start, t_safe)),
        cap,
    )

    def ref(r):
        return jnp.where(in_range[:, None], jnp.take(r, src, axis=0), 0.0)

    _grads_match(lambda r: pack_gather(r, src, in_range, slot), ref, rows)


def test_bucket_inverse_roundtrip():
    cuts = jnp.asarray([0, 3, 3, 11, 15], jnp.int32)
    idx, valid = _bucket_inverse(cuts, 20, 6)
    idx, valid = np.asarray(idx), np.asarray(valid)
    # every assigned position maps to the exact (bucket, offset) slot
    for i in range(20):
        assigned = [
            (d, i - int(cuts[d]))
            for d in range(4)
            if int(cuts[d]) <= i < int(cuts[d + 1]) and i - int(cuts[d]) < 6
        ]
        if assigned:
            d, b = assigned[0]
            assert valid[i] and idx[i] == d * 6 + b, i
        else:
            assert not valid[i], i


def test_invperm():
    perm = jnp.asarray(np.random.default_rng(7).permutation(33), jnp.int32)
    inv = np.asarray(_invperm(perm))
    np.testing.assert_array_equal(np.asarray(perm)[inv], np.arange(33))
