"""Custom VJPs for the sharded exchange pipeline.

The sharded renderer (render_sharded._render_shard) moves payload rows
through four gathers: table -> sorted entries -> owner buckets ->
(all_to_all) -> merge permutation -> packed ranges. Differentiating
plain ``jnp.take`` would turn every one of them into a scatter-add on
the backward pass, although only the first is a true reduction. Each
gather has a *structured inverse*:

  * table rows by gaussian id  -> per-gaussian segment-sum
    (ops.render.reduce_rows_by_id — ids repeat, a true reduction);
  * contiguous bucket slices   -> the inverse map position->bucket is a
    searchsorted + one row gather (slices are disjoint and contiguous);
  * a merge permutation        -> the inverse permutation, recovered by
    one 2-operand unstable sort, then one row gather;
  * chunk-packed range slots   -> slot(entry) is closed-form from the
    per-tile range/pad starts, again one row gather.

So every float scatter in the sharded backward is the per-gaussian
gradient segment-sum (asserted by
tests/test_sharding.py::test_sharded_backward_has_no_scatter).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _int_zero_cotangent(x):
    return np.broadcast_to(np.zeros((), dtype=jax.dtypes.float0), x.shape)


def _bucket_inverse(cuts, l_loc: int, bcap: int):
    """Position i -> (flat bucket slot, valid): the inverse of disjoint
    contiguous bucket slicing (see _slice_rows)."""
    ndev = cuts.shape[0] - 1
    i = jnp.arange(l_loc, dtype=jnp.int32)
    o = jnp.clip(
        jnp.searchsorted(cuts, i, side="right").astype(jnp.int32) - 1,
        0,
        ndev - 1,
    )
    b = i - jnp.take(cuts, o)
    valid = (b >= 0) & (b < bcap) & (i < jnp.take(cuts, o + 1))
    idx = jnp.clip(o * bcap + b, 0, ndev * bcap - 1)
    return idx, valid


def _invperm(perm):
    """Inverse permutation via one 2-operand unstable sort (perm is
    unique, so the unstable sort is exact) — never a scatter."""
    m = perm.shape[0]
    iota = jnp.arange(m, dtype=jnp.int32)
    _, inv = jax.lax.sort((perm, iota), num_keys=1, is_stable=False)
    return inv


# ---------------------------------------------------------------------------
# table rows by (repeating) gaussian id: VJP is a segment-sum reduction
# ---------------------------------------------------------------------------


@jax.custom_vjp
def take_table_rows(table, gid):
    """(N, F) table + (L,) gid in [-1, N) -> (L, F); gid<0 rows are 0.

    VJP: d_table = reduce_rows_by_id(gid, d_rows), the per-gaussian
    segment-sum with gid < 0 rows dropped.
    """
    safe = jnp.maximum(gid, 0)
    return jnp.where(gid[:, None] >= 0, jnp.take(table, safe, axis=0), 0.0)


def _take_table_fwd(table, gid):
    return take_table_rows(table, gid), (gid, table.shape[0])


def _take_table_bwd(res, d_rows):
    from ..ops.render import reduce_rows_by_id

    gid, n = res
    d_table = reduce_rows_by_id(gid, d_rows, n)
    return d_table, _int_zero_cotangent(gid)


take_table_rows.defvjp(_take_table_fwd, _take_table_bwd)


# ---------------------------------------------------------------------------
# disjoint contiguous bucket slices: VJP is searchsorted + one gather
# ---------------------------------------------------------------------------


def _slice_rows(rows, cuts, bcap: int):
    """Pure bucket-slice forward, dtype-generic (f32 payload or packed
    int32): (L, F) rows + (ndev+1,) cuts -> (ndev, bcap, F), bucket d =
    rows[cuts[d] : cuts[d+1]] zero-padded / truncated to bcap.

    Shared by slice_buckets and exchange_rows_packed so the truncation
    rule the backward (_bucket_inverse) must mirror is defined once."""
    l_loc = rows.shape[0]
    j = jnp.arange(bcap, dtype=jnp.int32)[None, :]
    start = cuts[:-1]
    blen = cuts[1:] - start
    src = jnp.clip(start[:, None] + j, 0, l_loc - 1)
    valid = j < jnp.minimum(blen, bcap)[:, None]
    zero = jnp.zeros((), rows.dtype)
    return jnp.where(valid[..., None], jnp.take(rows, src, axis=0), zero)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def slice_buckets(rows, cuts, bcap: int):
    """(L, F) rows + (ndev+1,) cuts -> (ndev, bcap, F) bucket slices.

    Bucket d holds rows[cuts[d] : cuts[d+1]] (zero-padded / truncated to
    bcap). Rows at positions >= cuts[-1] belong to no bucket.

    VJP: position i lives in bucket o(i) = searchsorted(cuts, i,
    'right')-1 at offset b = i - cuts[o], so d_rows is ONE row gather of
    the flattened cotangent — buckets are disjoint, nothing accumulates.
    """
    return _slice_rows(rows, cuts, bcap)


def _slice_buckets_fwd(rows, cuts, bcap):
    return slice_buckets(rows, cuts, bcap), (cuts, rows.shape[0])


def _slice_buckets_bwd(bcap, res, d_send):
    cuts, l_loc = res
    ndev = cuts.shape[0] - 1
    idx, valid = _bucket_inverse(cuts, l_loc, bcap)
    flat = d_send.reshape(ndev * bcap, d_send.shape[-1])
    d_rows = jnp.where(valid[:, None], jnp.take(flat, idx, axis=0), 0.0)
    return d_rows, _int_zero_cotangent(cuts)


slice_buckets.defvjp(_slice_buckets_fwd, _slice_buckets_bwd)


# ---------------------------------------------------------------------------
# permutation: VJP recovers the inverse permutation with one cheap sort
# ---------------------------------------------------------------------------


@jax.custom_vjp
def permute_rows(rows, perm):
    """(M, F) rows + (M,) permutation -> rows[perm].

    VJP: d_rows = d_out[invperm] where invperm = values of one
    2-operand unstable sort of (perm, iota) — perm is unique, so the
    unstable network is exact and ~an order cheaper than hauling F
    payload operands through a sort (or scattering).
    """
    return jnp.take(rows, perm, axis=0)


def _permute_rows_fwd(rows, perm):
    return permute_rows(rows, perm), perm


def _permute_rows_bwd(perm, d_out):
    d_rows = jnp.take(d_out, _invperm(perm), axis=0)
    return d_rows, _int_zero_cotangent(perm)


permute_rows.defvjp(_permute_rows_fwd, _permute_rows_bwd)


# ---------------------------------------------------------------------------
# chunk-packed range slots: VJP is the closed-form slot(entry) gather
# ---------------------------------------------------------------------------


@jax.custom_vjp
def pack_gather(rows, src, in_range, slot_of_entry):
    """(M, F) rows -> (capacity, F) packed slots (ops.binning.pack_ranges).

    src/in_range come from pack_ranges; slot_of_entry is the closed-form
    inverse (entry k of tile t sits at padded_start[t] + rank within the
    tile; entries outside every range pass a sentinel >= capacity).

    VJP: d_rows = d_cols[slot_of_entry] — pack_ranges assigns each
    in-range entry exactly one slot, so the inverse is one row gather.
    """
    return jnp.where(
        in_range[:, None], jnp.take(rows, src, axis=0), 0.0
    )


def _pack_gather_fwd(rows, src, in_range, slot_of_entry):
    return (
        pack_gather(rows, src, in_range, slot_of_entry),
        (src, in_range, slot_of_entry),
    )


def _pack_gather_bwd(res, d_cols):
    src, in_range, slot_of_entry = res
    cap = d_cols.shape[0]
    valid = slot_of_entry < cap
    idx = jnp.clip(slot_of_entry, 0, cap - 1)
    d_rows = jnp.where(valid[:, None], jnp.take(d_cols, idx, axis=0), 0.0)
    return (
        d_rows,
        _int_zero_cotangent(src),
        _int_zero_cotangent(in_range),
        _int_zero_cotangent(slot_of_entry),
    )


pack_gather.defvjp(_pack_gather_fwd, _pack_gather_bwd)


# ---------------------------------------------------------------------------
# bf16-packed exchange: the whole table -> packed-columns pipeline as ONE
# differentiable unit (cotangents cannot flow through int32 intermediates,
# so the packed path cannot reuse the per-op VJPs above)
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def exchange_rows_packed(table, idx, perm, bcap: int, axis: str,
                         pack_mode: str):
    """bf16-packed sharded payload exchange (cfg.payload_dtype="bf16").

    Forward: pack the (P, 9) f32 table into 7 int32 columns
    (mean/conic keep f32 bits, opacity+rgb ride as bf16 pairs —
    ops.render._pack_table7, same rounding as the single-chip bf16
    gather), move the PACKED rows through gather -> bucket slices ->
    all_to_all -> merge permutation -> range slots, and unpack to
    (capacity, 9) f32 at the very end. Exchange payload bytes: 36 -> 28
    per entry (-22%); the reverse (cotangent) exchange moves f32 rows.

    idx: (sorted_gid, cuts) + (src, in_range, slot_of_entry) for
    pack_mode="chunk" (ints; zero cotangents).

    Backward: the same route inverted — closed-form slot/permutation/
    bucket inverses (one row gather each), the self-adjoint all_to_all,
    then the per-gaussian segment-sum back to the table.
    """
    from ..ops.render import _pack_table7, _unpack_rows7

    sorted_gid, cuts, *pidx = idx
    packed = _pack_table7(table)  # (P, 7) int32
    safe = jnp.maximum(sorted_gid, 0)
    rows = jnp.where(
        sorted_gid[:, None] >= 0, jnp.take(packed, safe, axis=0), 0
    )  # (L, 7)
    ndev = cuts.shape[0] - 1
    send = _slice_rows(rows, cuts, bcap)  # (ndev, B, 7)
    recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
    s_rows = jnp.take(recv.reshape(ndev * bcap, 7), perm, axis=0)
    if pack_mode == "chunk":
        src, in_range, _slot = pidx
        cols7 = jnp.where(
            in_range[:, None], jnp.take(s_rows, src, axis=0), 0
        )
    else:
        cols7 = s_rows
    return _unpack_rows7(cols7)  # (capacity, 9) f32


def _exchange_packed_fwd(table, idx, perm, bcap, axis, pack_mode):
    out = exchange_rows_packed(table, idx, perm, bcap, axis, pack_mode)
    return out, (idx, perm, table.shape[0])


def _exchange_packed_bwd(bcap, axis, pack_mode, res, d_cols):
    from ..ops.render import reduce_rows_by_id

    idx, perm, n_rows = res
    sorted_gid, cuts, *pidx = idx
    m = perm.shape[0]
    if pack_mode == "chunk":
        _src, _in_range, slot_of_entry = pidx
        cap = d_cols.shape[0]
        svalid = slot_of_entry < cap
        sidx = jnp.clip(slot_of_entry, 0, cap - 1)
        d_s = jnp.where(
            svalid[:, None], jnp.take(d_cols, sidx, axis=0), 0.0
        )  # (M, 9)
    else:
        d_s = d_cols[:m]
    d_recv = jnp.take(d_s, _invperm(perm), axis=0)  # (M, 9)
    ndev = cuts.shape[0] - 1
    d_recv_w = d_recv.reshape(ndev, bcap, 9)
    d_send = jax.lax.all_to_all(d_recv_w, axis, 0, 0, tiled=False)
    d_send = d_send.reshape(ndev * bcap, 9)
    l_loc = sorted_gid.shape[0]
    inv_idx, inv_valid = _bucket_inverse(cuts, l_loc, bcap)
    d_pf = jnp.where(
        inv_valid[:, None], jnp.take(d_send, inv_idx, axis=0), 0.0
    )  # (L, 9)
    d_table = reduce_rows_by_id(sorted_gid, d_pf, n_rows)
    d_idx = tuple(_int_zero_cotangent(x) for x in idx)
    return d_table, d_idx, _int_zero_cotangent(perm)


exchange_rows_packed.defvjp(_exchange_packed_fwd, _exchange_packed_bwd)
