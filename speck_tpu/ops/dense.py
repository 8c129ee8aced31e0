"""Dense-window SpGEMM tiles as batched matmuls.

A re-expression of spECK's dense-mode kernels (iterateMatrixDenseNumeric /
denseSpGEMMNumeric and their counting twins,
/root/reference/include/GPU/spECK_HashSpGEMM.cuh:1175-1711): spECK
accumulates a row into a shared-memory dense value window + presence bitmap
over a column range and compacts with a block scan. Here the same idea
becomes dense matrix products (XLA hands them to cuBLAS): a tile of TR
consecutive rows with a bounded
k-range (A columns) and a bounded output column range becomes

    C_tile[TR, CW]   = A_dense[TR, KW] @ B_dense[KW, CW]      (values, fp)
    cnt_tile[TR, CW] = A_pat[TR, KW]  @ B_pat[KW, CW]         (bf16 -> f32, exact)

where A_dense/B_dense are densified CSR fragments. The pattern
matmul gives the exact structural presence (cnt > 0), independent of value
cancellation — the analogue of spECK's presence bitmap (`prefix`,
spECK_HashSpGEMM.cuh:1210-1233). Presence-masked rank compaction emits the
row sorted by construction, exactly like the reference's dense mode
(":1260-1296 — sorted for free").

Eligibility (host decision on tiny per-tile device stats, the analogue of
spECK's rowColMinMax-driven dense heuristic, Multiply.cu:379 +
common.cuh:303-319): a tile of TR consecutive rows is dense-eligible iff
  - its A-column (k) range spans <= KW,
  - its output-column range (union of referenced B row col ranges) spans <= CW,
  - max A row length <= LA and max referenced B row length <= LB.
Everything else falls back to the ESC bins (ops/esc.py). For banded /
FEM-class matrices every tile qualifies and the whole SpGEMM runs as
matmuls instead of the sort path.

Requires canonical A and B (sorted, deduplicated columns) — the same
assumption the reference's direct path makes; the planner gates on it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .analysis import cumsum1d

INT_MAX = jnp.iinfo(jnp.int32).max


@partial(jax.jit, static_argnames=("tile_rows", "m"))
def tile_stats(a_indptr, a_indices, b_indptr, b_indices,
               row_ops, a_len, *, tile_rows: int, m: int):
    """Per-tile dense-eligibility statistics, computed on device so only
    O(m / tile_rows) scalars cross the device->host boundary.

    Returns ONE stacked (6, T) int32 array [kmin, kspan, cmin, cspan,
    amax, bmax] (T = ceil(m / tile_rows)):
      kmin, kspan   — A-column window base and span
      cmin, cspan   — output-column window base and span
      amax          — max A row length in the tile
      bmax          — max referenced-B-row length in the tile
    Padding rows (beyond m) are neutral (empty).
    """
    T = -(-m // tile_rows)
    mpad = T * tile_rows

    alen = a_indptr[1:] - a_indptr[:-1]
    nonempty = alen > 0
    # canonical A: per-row k range = first/last column id
    a_kmin = jnp.where(nonempty, a_indices[a_indptr[:-1]], INT_MAX)
    a_kmax = jnp.where(
        nonempty, a_indices[jnp.maximum(a_indptr[1:] - 1, 0)], -1
    )

    # canonical B: per-row output-column range = first/last column id
    b_len = b_indptr[1:] - b_indptr[:-1]
    b_ne = b_len > 0
    b_cmin = jnp.where(b_ne, b_indices[b_indptr[:-1]], INT_MAX)
    b_cmax = jnp.where(b_ne, b_indices[jnp.maximum(b_indptr[1:] - 1, 0)], -1)

    # per-A-row output range / max referenced B row length: segment min/max
    # over A's nonzeros (the readOperations rowColMinMax analogue,
    # common.cuh:303-319,380-392)
    nnz = a_indices.shape[0]
    # blocked cumsum (analysis.cumsum1d) over nnz
    seg = cumsum1d(jnp.zeros((nnz,), jnp.int32).at[a_indptr[1:-1]].add(
        1, mode="drop")) if nnz else jnp.zeros((0,), jnp.int32)
    # Three separate 1-D gathers at a_indices, not one (nnz, 3) record
    # gather: a minor dimension of 3 can be tile-padded by the compiler
    # (it ran a 50M-nnz input out of memory before the H100 port).
    gcmin = jax.ops.segment_min(b_cmin[a_indices], seg, num_segments=m)
    gcmax = jax.ops.segment_max(b_cmax[a_indices], seg, num_segments=m)
    gblen = jax.ops.segment_max(b_len[a_indices], seg, num_segments=m)
    no_ops = row_ops <= 0
    gcmin = jnp.where(no_ops, INT_MAX, gcmin)
    gcmax = jnp.where(no_ops, -1, gcmax)
    gblen = jnp.where(no_ops, 0, gblen)

    def tile_reduce(x, red, fill):
        xp = jnp.concatenate([x, jnp.full((mpad - m,), fill, x.dtype)])
        return red(xp.reshape(T, tile_rows), axis=1)

    kmin = tile_reduce(a_kmin, jnp.min, INT_MAX)
    kmax = tile_reduce(a_kmax, jnp.max, -1)
    cmin = tile_reduce(gcmin, jnp.min, INT_MAX)
    cmax = tile_reduce(gcmax, jnp.max, -1)
    amax = tile_reduce(a_len, jnp.max, 0)
    bmax = tile_reduce(gblen, jnp.max, 0)
    # empty tiles (no A entries / no referenced B columns) get span 0 so the
    # planner's eligibility guard (cspan > 0) can exclude them from the
    # dense-tile budget instead of letting them displace real tiles
    kspan = jnp.where(kmax < 0, 0, kmax - kmin + 1)
    cspan = jnp.where(cmax < 0, 0, cmax - cmin + 1)
    kmin = jnp.where(kmax < 0, 0, kmin)
    cmin = jnp.where(cmax < 0, 0, cmin)
    # one stacked array so the host needs a single D2H fetch (each fetch
    # through a remote transport is a potential multi-second stall)
    return jnp.stack([kmin, kspan, cmin, cspan, amax, bmax])


def _gather_rect(indptr, indices, data, rows, valid, width: int,
                 packed=None):
    """(R, width) rectangle of a CSR fragment: col ids, values, live mask.

    With ``packed`` ((nnz, 2) interleaved col/value-bits records, see
    esc.pack_csr_arrays), each element costs ONE 8-byte record gather
    instead of two 4-byte gathers (chosen before the H100 port; not yet
    measured on the H100)."""
    r = jnp.where(valid, rows, 0)
    p0 = indptr[r]
    ln = jnp.where(valid, indptr[r + 1] - p0, 0)
    j = jnp.arange(width, dtype=jnp.int32)[None, :]
    live = j < ln[:, None]
    idx = jnp.where(live, p0[:, None] + j, 0)
    if packed is not None:
        rec = packed[idx]
        cols = jnp.where(live, rec[..., 0], 0)
        vals = jnp.where(
            live, jax.lax.bitcast_convert_type(rec[..., 1], jnp.float32), 0)
        return cols, vals, live
    cols = jnp.where(live, indices[idx], 0)
    vals = jnp.where(live, data[idx], 0) if data is not None else None
    return cols, vals, live


def _densify_scatter(loc, val, width: int):
    """Densification by one flat masked scatter per plane: dense[r, loc] =
    val. Scatter cost is one index per INPUT nonzero (R*L), vs the sort
    trick's two (R*(L+W))-wide sorts — wins when L << W (sparse fragments
    into wide windows)."""
    R, L = loc.shape
    r = jax.lax.broadcasted_iota(jnp.int32, (R, L), 0)
    flat = jnp.where(loc < width, r * width + loc, R * width)
    dense = jnp.zeros((R * width,), val.dtype).at[flat].set(
        val, mode="drop", unique_indices=True).reshape(R, width)
    hit = jnp.zeros((R * width,), jnp.bool_).at[flat].set(
        True, mode="drop", unique_indices=True).reshape(R, width)
    return dense, hit


def _densify_sorted(loc, val, width: int):
    """Densification of per-row sorted sparse fragments via two batched
    sorts instead of scatters (chosen before the H100 port; not yet
    measured on the H100).

    loc: (R, L) ascending per row, unique within a row (canonical CSR; pad
    entries hold a value >= width); val: (R, L). Returns
    (dense (R, width), pattern (R, width) bool) with
    dense[r, loc[r, l]] = val[r, l].

    Merge trick: concatenate the L entries with ``width`` background slots
    (one per output column), sort by (column, entry-before-background);
    after the sort every background slot's immediate left neighbor is its
    matching entry iff one exists (entry columns are unique). A second
    rank sort moves the backgrounds — already in column order — to the
    front, yielding the dense window directly.
    """
    R, L = loc.shape
    W = width
    kcol = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (R, W))
    # key = col*2 + is_background: entries sort immediately before their
    # background slot; pad entries (loc >= W) sort past every background
    key1 = jnp.concatenate([loc * 2, kcol * 2 + 1], axis=1)
    vals = jnp.concatenate([val, jnp.zeros((R, W), val.dtype)], axis=1)
    key1, vals = jax.lax.sort((key1, vals), dimension=1, num_keys=1)

    is_bg = (key1 & 1) == 1
    col = key1 >> 1
    prev_col = jnp.concatenate(
        [jnp.full((R, 1), -1, jnp.int32), col[:, :-1]], axis=1
    )
    prev_bg = jnp.concatenate(
        [jnp.ones((R, 1), bool), is_bg[:, :-1]], axis=1
    )
    prev_val = jnp.concatenate(
        [jnp.zeros((R, 1), vals.dtype), vals[:, :-1]], axis=1
    )
    matched = is_bg & ~prev_bg & (prev_col == col)

    # rank sort: background slots (distinct cols 0..W-1) to the front, in
    # column order; everything else past them
    key2 = jnp.where(is_bg, col, jnp.int32(2 * W + L))
    out_val = jnp.where(matched, prev_val, 0)
    _, dense, hit8 = jax.lax.sort(
        (key2, out_val, matched.astype(jnp.int8)), dimension=1, num_keys=1
    )
    return dense[:, :W], hit8[:, :W] > 0


@partial(
    jax.jit,
    static_argnames=("tile_rows", "kw", "cw", "la", "lb", "m", "k_dim",
                     "n_cols", "densify"),
    donate_argnames=("nnz_row",),
)
def dense_tiles(r0s, kbases, cbases, a_indptr, a_indices, a_data,
                b_indptr, b_indices, b_data, nnz_row, a_packed=None,
                b_packed=None, *,
                tile_rows: int, kw: int, cw: int, la: int, lb: int,
                m: int, k_dim: int, n_cols: int, densify: str = "scatter"):
    """Fused count+numeric for a batch of dense-eligible tiles as ONE flat
    batched computation: all K tiles' rows are flattened to a (K*TR, ...)
    problem, the matmuls run as one batched dot, and the compaction is one
    flat 2-D sort. No lax.scan / vmap anywhere: nested forms lowered to
    slow loops before the H100 port (not yet measured on the H100).

    Memory per call is K * (TR*kw + kw*cw + ~4*TR*cw) * 4 bytes; the planner
    slices a big tile batch into multiple calls to bound this.

    Padding tiles (r0 >= m) contribute nothing. Returns
    (nnz_row, (counts (K,TR), cols (K,TR,cw), vals (K,TR,cw))) — the staging
    layout the dense_emit scatter consumes (tiles cover consecutive rows).
    """
    K = r0s.shape[0]
    t_tr = jnp.arange(tile_rows, dtype=jnp.int32)[None, :]
    t_cw = jnp.arange(cw, dtype=jnp.int32)[None, :]

    # ---- A side: (K*TR, la) rectangle -> (K*TR, kw) dense window
    rows = (r0s[:, None] + t_tr).reshape(-1)            # (K*TR,)
    vrow = rows < m
    acol, aval, alive = _gather_rect(
        a_indptr, a_indices, a_data, jnp.minimum(rows, m - 1), vrow, la,
        packed=a_packed,
    )
    kb_row = jnp.repeat(kbases, tile_rows)
    kloc = jnp.where(alive, acol - kb_row[:, None], kw)  # pads sort last
    _dens = _densify_scatter if densify == "scatter" else _densify_sorted
    A_dense, A_hit = _dens(kloc, aval, kw)

    # ---- B side: (K*kw, lb) rectangle -> (K*kw, cw) dense window
    ks = (kbases[:, None] + jnp.arange(kw, dtype=jnp.int32)[None, :]).reshape(-1)
    vk = ks < k_dim
    bcol, bval, blive = _gather_rect(
        b_indptr, b_indices, b_data, jnp.minimum(ks, k_dim - 1), vk, lb,
        packed=b_packed,
    )
    cb_k = jnp.repeat(cbases, kw)
    cloc = jnp.where(blive, bcol - cb_k[:, None], cw)
    B_dense, B_hit = _dens(cloc, bval, cw)

    # ---- matmuls: values + structural counts. The value einsum keeps
    # precision=HIGHEST so a GPU computes it in f32, not TF32 (TF32 keeps
    # ~3 decimal digits, outside the oracle compare's 1e-3). Counts are
    # exact in fp (products are 1.0, accumulation f32 while counts stay
    # <= dense_la) — the pattern matmul is spECK's presence bitmap
    # analogue (spECK_HashSpGEMM.cuh:1210-1233)
    A3 = A_dense.reshape(K, tile_rows, kw)
    B3 = B_dense.reshape(K, kw, cw)
    C_vals = jnp.einsum(
        "abk,akc->abc", A3, B3, precision=jax.lax.Precision.HIGHEST
    ).reshape(K * tile_rows, cw)
    C_cnt = jnp.einsum(
        "abk,akc->abc",
        A_hit.reshape(K, tile_rows, kw).astype(jnp.bfloat16),
        B_hit.reshape(K, kw, cw).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    ).reshape(K * tile_rows, cw)

    cb_row = jnp.repeat(cbases, tile_rows)
    present = (C_cnt > 0.5) & vrow[:, None] & ((cb_row[:, None] + t_cw) < n_cols)
    counts = jnp.sum(present, axis=1, dtype=jnp.int32)
    nnz_row = nnz_row.at[jnp.where(vrow, rows, m)].set(
        counts, mode="drop", unique_indices=True
    )

    # ---- presence-masked compaction via rank sort; ascending ranks
    # preserve column order so rows come out sorted, like the reference's
    # dense mode (:1260-1296)
    rank = jnp.cumsum(present.astype(jnp.int32), axis=1) - 1
    key = jnp.where(present, rank, cw + t_cw)
    cols_g = jnp.where(present, cb_row[:, None] + t_cw, n_cols)
    _, cols_c, vals_c = jax.lax.sort(
        (key, cols_g, C_vals), dimension=1, num_keys=1
    )
    return nnz_row, (
        counts.reshape(K, tile_rows),
        cols_c.reshape(K, tile_rows, cw),
        vals_c.reshape(K, tile_rows, cw),
    )


@partial(
    jax.jit,
    static_argnames=("tile_rows", "cw", "m", "emit_cap"),
    donate_argnames=("c_cols", "c_vals"),
)
def dense_emit(r0s, counts, cols_c, vals_c, row_offsets, c_cols, c_vals, *,
               tile_rows: int, cw: int, m: int, emit_cap: int = 0):
    """Emit one dense batch's staged rows into the final CSR arrays — one
    flat masked scatter over all K*TR rows (tiles cover consecutive rows, so
    row ids are r0 + offset; padding tiles land out of bounds and drop).

    ``emit_cap`` (0 = cw) trims the scatter to the true max row nnz (known
    after the offset scan): the window width cw is an upper bound, often far
    wider than any actual row, and scatter cost scales with slot count."""
    ec = min(cw, emit_cap) if emit_cap else cw
    K = r0s.shape[0]
    rows = (r0s[:, None] + jnp.arange(tile_rows, dtype=jnp.int32)[None, :]
            ).reshape(-1)                                # (K*TR,)
    vrow = rows < m
    cnt = counts.reshape(-1)
    t = jnp.arange(ec, dtype=jnp.int32)[None, :]
    live = (t < cnt[:, None]) & vrow[:, None]
    oob = c_cols.shape[0]
    base = row_offsets[jnp.where(vrow, rows, 0)]
    flat = jnp.where(live, base[:, None] + t, oob)
    c_cols = c_cols.at[flat].set(cols_c.reshape(-1, cw)[:, :ec], mode="drop",
                                 unique_indices=True)
    c_vals = c_vals.at[flat].set(vals_c.reshape(-1, cw)[:, :ec], mode="drop",
                                 unique_indices=True)
    return c_cols, c_vals


@partial(
    jax.jit,
    static_argnames=("tile_rows", "cw", "m", "nnz"),
)
def dense_gather_emit(cols_c, vals_c, row_offsets, *,
                      tile_rows: int, cw: int, m: int, nnz: int = 0):
    """Emit for the pure-dense case (every tile eligible — full_cover — and
    no ESC rows): builds the final CSR arrays with gathers instead of a
    masked scatter.

    Requires the staged tiles to cover rows 0..m in order (tile i = rows
    [i*tile_rows, ...)), so output row r's staged slots live at flat index
    r*cw + o. The output length (total nnz) is static per compile.

    One random read per output: the per-row term (r*cw - row_offsets[r])
    is constant over a row's output segment, so it is scattered at each
    live row's start and forward-filled (ffill1d) rather than gathered
    per element, and (col, val) travel as one packed 8-byte record.
    """
    from .stream import ffill1d

    total = nnz if nnz else 1
    i = jnp.arange(total, dtype=jnp.int32)
    m_rows = row_offsets.shape[0] - 1
    r = jnp.arange(m_rows, dtype=jnp.int32)
    starts = row_offsets[:-1]
    live = (row_offsets[1:] - starts) > 0
    pos = jnp.where(live, starts, total)
    seed = jnp.zeros((total,), jnp.int32).at[pos].set(
        r * cw - starts, mode="drop", unique_indices=True)
    fl = jnp.zeros((total,), bool).at[pos].set(
        True, mode="drop", unique_indices=True)
    src = jnp.clip(ffill1d(seed, fl) + i, 0, cols_c.size - 1)
    cols_f = cols_c.reshape(-1)
    vals_f = vals_c.reshape(-1)
    if vals_f.dtype.itemsize == 4:
        packed = jnp.stack(
            [cols_f, jax.lax.bitcast_convert_type(vals_f, jnp.int32)],
            axis=-1)
        rec = packed[src]
        return rec[..., 0], jax.lax.bitcast_convert_type(
            rec[..., 1], vals_f.dtype)
    return cols_f[src], vals_f[src]
