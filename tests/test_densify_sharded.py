"""Densification under GSPMD sharding: the same densify_step jitted over
gs-sharded parameters must reproduce the single-device result (XLA
inserts the gathers the global argsort/cumsum need; outputs re-shard)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from luisacomputegaussiansplatting_jax.models.densify import (
    DensifyConfig,
    DensifyState,
    accumulate_stats,
    densify_step,
    init_densify_state,
)
from luisacomputegaussiansplatting_jax.models.trainer import init_train_state
from luisacomputegaussiansplatting_jax.parallel.mesh import make_mesh

from test_densify import make_params


def test_densify_step_matches_under_sharding():
    n, cap = 24, 64  # divisible by 8 devices
    params = make_params(n, cap, scale=0.001)
    state, _ = init_train_state(params)
    dstate = init_densify_state(n, cap)
    grads = jnp.zeros((cap, 2)).at[1, 0].set(1.0).at[5, 1].set(1.0)
    radii = jnp.zeros((cap,), jnp.int32).at[:n].set(3)
    dstate = accumulate_stats(dstate, grads, radii)
    cfg = DensifyConfig(grad_threshold=0.5)
    key = jax.random.PRNGKey(0)

    # single-device reference
    ref_p, ref_opt, ref_d, ref_info = jax.jit(
        lambda p, o, d, k: densify_step(p, o, d, k, 1.0, cfg)
    )(state.params, state.opt_state, dstate, key)

    # gs-sharded: every (cap, ...) array split over 8 devices
    mesh = make_mesh((8,), ("gs",))
    row_sharding = NamedSharding(mesh, P("gs"))

    def shard_rows(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == cap:
            return jax.device_put(x, row_sharding)
        return x

    sp = jax.tree.map(shard_rows, state.params)
    so = jax.tree.map(shard_rows, state.opt_state)
    sd = DensifyState(*(shard_rows(x) for x in dstate))
    out_p, out_opt, out_d, out_info = jax.jit(
        lambda p, o, d, k: densify_step(p, o, d, k, 1.0, cfg)
    )(sp, so, sd, key)

    assert bool(out_info.overflow) == bool(ref_info.overflow)
    assert out_info[1:] == ref_info[1:]  # clone/split/prune counters match
    np.testing.assert_array_equal(
        np.asarray(out_d.active), np.asarray(ref_d.active)
    )
    for a, b in zip(jax.tree.leaves(out_p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    for a, b in zip(jax.tree.leaves(out_opt), jax.tree.leaves(ref_opt)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
