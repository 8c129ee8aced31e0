"""Expand-sort-contract SpGEMM kernels: the uniform-cap (rows, cap)
rectangle formulation.

Two kernels live here since the flat product stream (ops/stream.py) took
over general row processing:

- ``direct_chunk`` — single-A-nonzero rows, C row = valA * B row (the
  analogue of directSpGEMMNumericImplementation,
  /root/reference/include/GPU/spECK_HashSpGEMM.cuh:543-569).
- ``esc_fixed`` — the one-shot fused count+numeric kernel over ALL rows at
  one static capacity: fully jittable, scatter-free, no host decisions —
  the building block the SPMD mesh path (speck_tpu.parallel) runs per
  shard inside shard_map, where data-dependent chunking is impossible.

The expand stage resolves each product slot's owning A nonzero with an
interleaved key sort + doubling forward fill (no atomics, no hash maps —
replacing spECK's shared-memory hash probes, include/HashMap.cuh); the
sort+contract stages group duplicate columns and compute run sums exactly
like ops/stream.py. Everything is a FLAT batched computation — no
lax.scan, no vmap (the flat form was chosen before the H100 port; not
yet measured on the H100).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _iota_like(x):
    return jax.lax.broadcasted_iota(jnp.int32, x.shape, dimension=1)


@jax.jit
def pack_csr_arrays(indices: jax.Array, data: jax.Array):
    """Interleave (col id, value) into one (nnz, 2) int32 record so each
    random read costs ONE gather index instead of two (chosen before the
    H100 port; not yet measured on the H100).
    32-bit values only; callers pass None for wider dtypes and the kernels
    fall back to two gathers."""
    return jnp.stack(
        [indices.astype(jnp.int32),
         jax.lax.bitcast_convert_type(data, jnp.int32)], axis=-1
    )


def packable(data) -> bool:
    return data.dtype.itemsize == 4


def _owner_fill(live, e, chans, cap: int):
    """Owner payloads for every product slot: one key sort + a doubling
    forward fill + one rank sort — all in the fast lane (batched 2-D sorts
    and elementwise shifts), zero scatters/gathers.

    Each live A slot owns product positions t in [e, e+blen). Interleave
    A-slot records (key 2e — live starts are strictly increasing, so keys
    are unique) with product slots (key 2t+1); after one stable key sort,
    every product slot's owner is the nearest even-key record to its left,
    so a last-non-null forward fill (Hillis-Steele doubling over the parity
    mask) propagates the owner's payload channels onto its products. A
    second rank sort (product key t, others past the end) restores product
    order. This replaces the marker-scatter + owner-rank take_along
    formulation of the same mapping (the analogue of spECK's
    threads-per-nnz striding, spECK_HashSpGEMM.cuh:39-128).

    live: (R, cap) bool; e: (R, cap) start positions (valid where live);
    chans: tuple of (R, cap) int-typed payload channels. Returns the
    channels reindexed by product slot t (garbage past a row's last
    product; callers mask with t < ops).
    """
    R = live.shape[0]
    t2 = jnp.arange(cap, dtype=jnp.int32)[None, :] * 2 + 1
    key = jnp.concatenate(
        [jnp.where(live, 2 * e, 2 * cap + 1),
         jnp.broadcast_to(t2, (R, cap))], axis=1
    )
    s = jax.lax.sort(
        (key,) + tuple(
            jnp.concatenate([c, jnp.zeros((R, cap), c.dtype)], axis=1)
            for c in chans),
        dimension=1, num_keys=1,
    )
    key_s, vals = s[0], list(s[1:])
    is_owner = (key_s & 1) == 0     # even key <=> live A-slot record
    filled = is_owner
    d, W = 1, 2 * cap
    while d < W:
        f_s = jnp.concatenate([jnp.zeros((R, d), bool), filled[:, :-d]],
                              axis=1)
        take = ~filled & f_s
        for i, v in enumerate(vals):
            v_s = jnp.concatenate(
                [jnp.zeros((R, d), v.dtype), v[:, :-d]], axis=1)
            vals[i] = jnp.where(take, v_s, v)
        filled |= f_s
        d <<= 1
    key2 = jnp.where(is_owner, jnp.int32(2 * cap), key_s >> 1)
    out = jax.lax.sort((key2,) + tuple(vals), dimension=1, num_keys=1)
    return tuple(o[:, :cap] for o in out[1:])


def _expand(rows, valid_rows, a_indptr, a_indices, a_data,
            b_start, b_len, b_indices, b_data, cap: int, n_cols: int,
            with_values: bool, a_packed=None, b_packed=None,
            b_meta=None):
    """Gather the (rows, cap) rectangle of intermediate products.

    B is described by per-row (start, length) arrays rather than an indptr so
    that gathered/padded B layouts (multi-device all_gather of row shards)
    work unchanged; for a plain CSR, b_start = indptr[:-1], b_len = diff.

    The owning A nonzero of each product slot is resolved by ``_owner_fill``
    (sort + forward fill); its payload u = source_base - start makes the
    source index simply u + t. Zero-length B rows are excluded from the fill
    (they own no products and must not shadow a live slot's payload).

    The pass is shaped to minimize random ops (a choice made before the
    H100 port; not yet measured on the H100): per-A-slot record
    gathers plus the irreducible random read of B's (column id, value)
    record per product — everything else is sorts and elementwise passes.

    Returns (col, val, ops): col[r, t] is the B column id of product t of
    row r (or the sentinel ``n_cols`` when t >= ops[r]); val is the product
    valA*valB (0 beyond ops); ops is the live product count per row.
    """
    R = rows.shape[0]
    r = jnp.where(valid_rows, rows, 0)
    a0 = a_indptr[r]
    alen = jnp.where(valid_rows, a_indptr[r + 1] - a0, 0)

    j = jnp.arange(cap, dtype=jnp.int32)[None, :]
    va = j < alen[:, None]
    aidx = jnp.where(va, a0[:, None] + j, 0)
    if a_packed is not None:
        ap = a_packed[aidx]                             # (R, cap, 2)
        acol = jnp.where(va, ap[..., 0], 0)
        aval_raw = ap[..., 1]
    else:
        acol = jnp.where(va, a_indices[aidx], 0)
        aval_raw = None
    if b_meta is not None:
        bm = b_meta[acol]                               # (R, cap, 2)
        bstart_a = bm[..., 0]
        blen = jnp.where(va, bm[..., 1], 0)
    else:
        bstart_a = b_start[acol]
        blen = jnp.where(va, b_len[acol], 0)
    cum = jnp.cumsum(blen, axis=1)                      # (R, cap)
    ops = cum[:, -1]
    e = cum - blen                                      # slot start positions

    # owner payloads per product slot via sort + forward fill (no scatters,
    # no take_along; the fill is log2(2*cap) elementwise passes)
    live = va & (blen > 0)
    u = bstart_a - e                                    # src base - start
    if with_values:
        if aval_raw is not None:
            araw = aval_raw
        else:
            araw = jax.lax.bitcast_convert_type(
                jnp.where(va, a_data[aidx], 0), jnp.int32
            ) if a_data.dtype.itemsize == 4 else None
        if araw is not None:
            uc, ar = _owner_fill(live, e, (u, araw), cap)
            ac = jax.lax.bitcast_convert_type(ar, jnp.float32)
        else:
            aval = jnp.where(va, a_data[aidx], 0)
            uc, ac = _owner_fill(live, e, (u, aval), cap)
    else:
        (uc,) = _owner_fill(live, e, (u,), cap)
        ac = None
    t = j
    valid_t = t < ops[:, None]
    src = jnp.where(valid_t, uc + t, 0)
    if b_packed is not None:
        bp = b_packed[src]                              # (R, cap, 2)
        col = jnp.where(valid_t, bp[..., 0], jnp.int32(n_cols))
        bval = jax.lax.bitcast_convert_type(bp[..., 1], jnp.float32)
    else:
        col = jnp.where(valid_t, b_indices[src], jnp.int32(n_cols))
        bval = None
    if with_values:
        if bval is None:
            bval = b_data[src]
        val = jnp.where(valid_t, ac * bval, 0)
    else:
        val = None
    return col, val, ops


def _run_boundaries(col_s, n_cols: int):
    """first/last masks of equal-column runs of a sorted rectangle
    (sentinel ``n_cols`` runs excluded from ``last``)."""
    R = col_s.shape[0]
    prev = jnp.concatenate(
        [jnp.full((R, 1), -1, jnp.int32), col_s[:, :-1]], axis=1
    )
    nxt = jnp.concatenate(
        [col_s[:, 1:], jnp.full((R, 1), -2, jnp.int32)], axis=1
    )
    first = col_s != prev
    last = (col_s != nxt) & (col_s < n_cols)
    return first, last


def _run_sums(val_s, first):
    """Per-run sums at run-last positions: segmented inclusive scan
    restarting at each run boundary (numerically local — no cross-run
    cancellation). Replaces the hash-map atomic_add accumulation
    (HashMap.cuh:99-107).

    Hand-rolled Hillis-Steele doubling (log2(W) shifted-add steps, plain
    elementwise HLO): jax.lax.associative_scan computes the same thing but
    its recursive slice/concat tree compiles slowly, and a
    global-cumsum-difference trick loses ~eps * |row prefix| to
    cancellation."""
    W = val_s.shape[1]
    v, f = val_s, first
    d = 1
    while d < W:
        pad_v = jnp.zeros_like(v[:, :d])
        pad_f = jnp.ones_like(f[:, :d])
        v_s = jnp.concatenate([pad_v, v[:, :-d]], axis=1)
        f_s = jnp.concatenate([pad_f, f[:, :-d]], axis=1)
        v = jnp.where(f, v, v + v_s)
        f = f | f_s
        d <<= 1
    return v


def _compact_by_rank(last, col_s, run_sum):
    """Move run-last (col, sum) pairs to the front, order preserved: rank
    keys < W for run-lasts, W+t for the rest, then one key sort."""
    W = col_s.shape[1]
    t = jnp.arange(W, dtype=jnp.int32)[None, :]
    rank = jnp.cumsum(last.astype(jnp.int32), axis=1) - 1
    key = jnp.where(last, rank, W + t)
    _, cols_c, vals_c = jax.lax.sort((key, col_s, run_sum), dimension=1, num_keys=1)
    return cols_c, vals_c


@partial(
    jax.jit,
    static_argnames=("chunk_rows", "cap"),
    donate_argnames=("c_cols", "c_vals"),
)
def direct_chunk(rows_sorted, start, valid, a_indptr, a_indices,
                 a_data, b_indptr, b_indices, b_data, row_offsets,
                 c_cols, c_vals, *, chunk_rows: int, cap: int):
    """Numeric fill for single-A-nonzero rows: C row = valA * B row, already
    sorted — a pure gather + masked scatter, no expansion or sort.

    Analogue of directSpGEMMNumericImplementation
    (spECK_HashSpGEMM.cuh:543-569). Assumes B rows are canonical (sorted,
    no duplicate columns), like the reference's direct path.
    """
    rows = jax.lax.dynamic_slice_in_dim(rows_sorted, start, chunk_rows)
    valid_rows = jnp.arange(chunk_rows, dtype=jnp.int32) < valid
    r = jnp.where(valid_rows, rows, 0)
    p = a_indptr[r]                       # the row's single nonzero
    acol = a_indices[p]
    aval = a_data[p]
    b0 = b_indptr[acol]
    blen = b_indptr[acol + 1] - b0

    t = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid_t = (t < blen[:, None]) & valid_rows[:, None]
    src = jnp.where(valid_t, b0[:, None] + t, 0)
    cols = b_indices[src]
    vals = aval[:, None] * b_data[src]

    oob = c_cols.shape[0]
    flat = jnp.where(valid_t, row_offsets[r][:, None] + t, oob)
    c_cols = c_cols.at[flat].set(cols, mode="drop", unique_indices=True)
    c_vals = c_vals.at[flat].set(vals, mode="drop", unique_indices=True)
    return c_cols, c_vals


# ---------------------------------------------------------------------------
# Fused one-shot kernel (uniform cap, no binning) — the SPMD/mesh building
# block and the driver entry's flagship fn.
# ---------------------------------------------------------------------------

def esc_fixed(a_indptr, a_indices, a_data, b_start, b_len, b_indices, b_data,
              *, cap: int, n_cols: int):
    """One-shot fused count+numeric over ALL rows at a single capacity.

    Scatter-free and fully jittable (no data-dependent allocation): returns
    (counts (m,), cols (m, cap), vals (m, cap)) where each row's first
    counts[r] slots hold the compacted, column-sorted result. Compaction uses
    a second key sort instead of a scatter, so the whole kernel is
    gather/sort/scan only — the shape XLA and a SPMD mesh want. This is the
    uniform-shape kernel used per shard by the distributed path
    (speck_tpu.parallel) and by __graft_entry__.entry().
    """
    m = a_indptr.shape[0] - 1
    rows = jnp.arange(m, dtype=jnp.int32)
    valid_rows = jnp.ones((m,), dtype=bool)
    col, val, _ = _expand(
        rows, valid_rows, a_indptr, a_indices, a_data,
        b_start, b_len, b_indices, b_data, cap, n_cols, with_values=True,
    )
    col_s, val_s = jax.lax.sort((col, val), dimension=1, num_keys=1)
    first, last = _run_boundaries(col_s, n_cols)
    run_sum = _run_sums(val_s, first)
    counts = jnp.sum(last, axis=1, dtype=jnp.int32)
    cols_c, vals_c = _compact_by_rank(last, col_s, run_sum)
    return counts, cols_c[:, :cap], vals_c[:, :cap]
