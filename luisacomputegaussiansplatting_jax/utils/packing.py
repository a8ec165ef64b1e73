"""Column pack/unpack with layout-friendly VJPs.

The default VJPs of ``jnp.stack(cols, axis=1)`` (split into (N, 1)
slices) and of column slicing ``a[:, i]`` (pad back to (N, 1))
materialize one narrow (N, 1) buffer per column; on layouts that pad the
minor dimension those buffers blow device memory on
multi-million-gaussian backward passes. Whether the GPU
needs this is not measured yet (ROADMAP C2).

These helpers keep the forward ops identical but route the cotangents
through one (N, K) <-> (K, N) transpose + contiguous row slices, whose
layouts are benign (a (K, N) array pads K to the next multiple of 8).
All per-gaussian math in this package works on (N,) vectors and
crosses into packed (N, K) arrays only through this module.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.custom_vjp
def stack_cols(*cols):
    """K x (N,) -> (N, K); VJP avoids (N, 1)-shaped cotangents."""
    return jnp.stack(cols, axis=1)


def _stack_fwd(*cols):
    return stack_cols(*cols), None


def _stack_bwd(_, d):
    dt = d.T  # (K, N): one transpose, 8-sublane padding only
    return tuple(dt[i] for i in range(dt.shape[0]))


stack_cols.defvjp(_stack_fwd, _stack_bwd)


@jax.custom_vjp
def unstack_cols(a):
    """(N, K) -> tuple of K (N,) columns; VJP stacks (no (N, 1) pads)."""
    return tuple(a[:, i] for i in range(a.shape[1]))


def _unstack_fwd(a):
    return unstack_cols(a), None


def _unstack_bwd(_, d_cols):
    return (jnp.stack(d_cols, axis=1),)


unstack_cols.defvjp(_unstack_fwd, _unstack_bwd)
