"""DIA (diagonal-plane) fast path for globally band-limited SpGEMM.

A reinterpretation of spECK's dense-accumulator mode
(/root/reference/include/GPU/spECK_HashSpGEMM.cuh:1175-1298 and the
dense-method selection in spGEMMNumericLauncher :1761-1793): where the
reference routes individual rows whose output-column RANGE is bounded to a
shared-memory dense window, this path routes a whole matrix whose
DIAGONAL range is bounded to dense diagonal planes.

Identity: write A = sum_d diag(a_d) S^d (S = the shift operator, a_d the
d-th diagonal stored as a length-m vector indexed by ROW).  Then

    C[i, i+e] = sum_{d1+d2=e} a_{d1}[i] * b_{d2}[i+d1]

i.e. every output diagonal is a short sum of elementwise vector products
of A-diagonals with row-shifted B-diagonals.  The whole multiply becomes
span_A flat fused multiply-adds over (span_B, m) planes — NO random
gathers, NO sorts, pure streaming through device memory — while every
general-SpGEMM path pays ~2 random reads per product.
Structure (symbolic counting) falls out of the same convolution applied to
0/1 presence planes, exactly like the pattern matmul of the dense path
(ops/dense.py) and the reference's presence bitmap (`prefix`,
spECK_HashSpGEMM.cuh:1210-1233).

Eligibility is a host decision on four scalars from the single planning
readback (ops/stream.py plan_device_stream): the min/max of (col - row)
over A and over B.  With span_X = dmax_X - dmin_X + 1 the arithmetic cost
is m * span_A * span_B fused multiply-adds; the planner requires this to
be within ``dia_waste_cap`` of the true product count, spans within
``dia_span_cap``, and the plane memory within ``dia_mem_budget``
(speck_tpu/utils/config.py).  Banded FEM-class matrices (BASELINE config
1) qualify with zero waste; anything skewed or unstructured falls through
to the stream/dense/direct routing.

Requires canonical A and B (first/last column of a row = that row's
column min/max, which makes the band stats exact).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class DiaState:
    """Host + device state of a DIA-routed plan.

    Two flavors share this state and the staging/emission machinery:
    contiguous-band DIA (``off_a is None``; span_* are diagonal RANGES)
    and sparse DIA (``off_a``/``off_b`` are the explicit present-offset
    lists; span_* are PLANE COUNTS nd_a/nd_b/nd_c and ``doffs`` maps
    output plane index -> diagonal offset)."""

    span_a: int
    span_b: int
    span_c: int
    dmin_a: int
    dmin_b: int
    slot_a: jax.Array            # (nnz_a,) plane slot of each A nonzero
    slot_b: jax.Array            # (nnz_b,) plane slot of each B nonzero
    present: jax.Array           # (m, span_c) bool structural presence
    staged: Optional[tuple] = None   # (cols_s (m, span_c), vals_s) sorted
    # uniform-rows fast emit (dia_offsets_meta): rows [p, q) are all
    # full, their staged block is the final CSR payload at shift offs_p
    uniform: Optional[tuple] = None  # (p, q, offs_p)
    # sparse-DIA flavor (see sdia_conv): static present-offset lists and
    # the device output-offset table (doffs[j] = off_c[j])
    off_a: Optional[tuple] = None
    off_b: Optional[tuple] = None
    doffs: Optional[jax.Array] = None


def plane_bytes(m: int, k: int, n_out: int, sa: int, sb: int,
                itemsize: int = 4) -> int:
    """Peak working-set estimate of the DIA pipeline (planes + shifted B +
    output planes + staged compaction), for the planner's memory gate."""
    sc = sa + sb - 1
    return itemsize * (
        2 * sa * m            # A value+hit planes
        + 2 * sb * k          # B value+hit planes
        + 2 * sb * (m + sa)   # shifted B planes
        + 2 * sc * m          # C value+count planes
        + 3 * sc * m          # staged cols/vals + present
    )


@partial(jax.jit, static_argnames=("dmin", "span", "rows", "masked"))
def dia_slots(indptr, indices, row_keep=None, *, dmin: int, span: int,
              rows: int, masked: bool = False):
    """Flat plane slot of every CSR nonzero: slot = (col - row - dmin) *
    rows + row.  Row ids per nonzero come from a boundary scatter +
    blocked cumsum (run-length decode, no atomics).

    masked (per-row DIA split): nonzeros of rows with ``row_keep`` False
    get an out-of-range slot so the plane scatters drop them — the
    planes then hold only the DIA-routed rows' contributions."""
    from .analysis import cumsum1d

    nnz = indices.shape[0]
    if nnz == 0:
        return jnp.zeros((0,), jnp.int32)
    rid = jnp.zeros((nnz,), jnp.int32).at[indptr[1:-1]].add(
        1, mode="drop")
    rid = cumsum1d(rid)
    d = indices - rid - jnp.int32(dmin)
    # out-of-band entries cannot exist when the band stats are exact
    # (canonical inputs); clip defensively so a bad input cannot scatter
    # out of the plane buffer
    slot = jnp.clip(d, 0, span - 1) * jnp.int32(rows) + rid
    if masked:
        slot = jnp.where(row_keep[rid], slot, jnp.int32(span) * rows)
    return slot


@partial(jax.jit, static_argnames=("dmin", "dmax"))
def dia_row_inband(indptr, indices, *, dmin: int, dmax: int):
    """Per-row in-band mask: every nonzero of the row has (col - row) in
    [dmin, dmax] (exact for canonical rows via first/last column ids);
    empty rows are vacuously in-band. Used to mask the B operand's
    planes in the per-row DIA split."""
    rows = indptr.shape[0] - 1
    rowi = jnp.arange(rows, dtype=jnp.int32)
    ln = indptr[1:] - indptr[:-1]
    ne = ln > 0
    first = indices[indptr[:-1]] - rowi
    last = indices[jnp.maximum(indptr[1:] - 1, 0)] - rowi
    return (~ne) | ((first >= jnp.int32(dmin)) & (last <= jnp.int32(dmax)))


@partial(jax.jit, static_argnames=("span", "rows"))
def dia_planes(slot, data, *, span: int, rows: int):
    """Value and presence planes from precomputed slots: val_planes[d, i]
    = sum of entries on diagonal d at row i (duplicates merge by
    addition, matching product semantics); hit marks structural presence
    (explicit zeros included, like the reference's index-only compare
    semantics, source/GPU/Compare.cu:38-47)."""
    size = span * rows
    val = jnp.zeros((size,), data.dtype).at[slot].add(
        data, mode="drop").reshape(span, rows)
    hit = jnp.zeros((size,), jnp.float32).at[slot].add(
        1.0, mode="drop").reshape(span, rows)
    return val, hit


@partial(jax.jit, static_argnames=("sa", "sb", "m", "k", "dmin_a",
                                   "with_hit"))
def dia_conv(a_val, a_hit, b_val, b_hit, *, sa: int, sb: int, m: int,
             k: int, dmin_a: int, with_hit: bool):
    """The diagonal convolution: C[e, i] = sum_{j1} A[j1, i] *
    B[e - j1, i + dmin_a + j1] as span_a statically-unrolled flat
    multiply-adds (no scan — nested scan lowers catastrophically on this
    backend).  Returns (C_val (sc, m), C_cnt (sc, m) or None).

    The B planes are first row-shifted by dmin_a with a static pad+slice
    (dmin_a is host-known from the planning readback), so every loop
    iteration is a static slice: BP[:, j1 : j1 + m]."""
    sc = sa + sb - 1
    wt = m + sa - 1          # shifted-plane width
    pad_l = max(0, -dmin_a)
    pad_r = max(0, (wt + dmin_a) - k)
    s0 = dmin_a + pad_l      # static, >= 0

    def shift(planes):
        p = jnp.pad(planes, ((0, 0), (pad_l, pad_r)))
        return jax.lax.slice(p, (0, s0), (sb, s0 + wt))

    bp_val = shift(b_val)
    bp_hit = shift(b_hit) if with_hit else None
    c_val = jnp.zeros((sc, m), a_val.dtype)
    c_cnt = jnp.zeros((sc, m), jnp.float32) if with_hit else None
    for j1 in range(sa):
        bw = jax.lax.slice(bp_val, (0, j1), (sb, j1 + m))
        seg = a_val[j1][None, :] * bw
        cur = jax.lax.dynamic_slice(c_val, (j1, 0), (sb, m))
        c_val = jax.lax.dynamic_update_slice(c_val, cur + seg, (j1, 0))
        if with_hit:
            bwh = jax.lax.slice(bp_hit, (0, j1), (sb, j1 + m))
            segh = a_hit[j1][None, :] * bwh
            curh = jax.lax.dynamic_slice(c_cnt, (j1, 0), (sb, m))
            c_cnt = jax.lax.dynamic_update_slice(
                c_cnt, curh + segh, (j1, 0))
    return c_val, c_cnt


# ---------------------------------------------------------------------------
# Sparse DIA: planes indexed by an explicit offset LIST (the stencil class)
# ---------------------------------------------------------------------------
#
# A 3-D 27-point stencil matrix (the nlpkkt/BASELINE stencil class) has
# exactly 27 present diagonals spread over a ~2*G^2-wide band: the
# contiguous-band gate rejects it (span >> cap, waste ~span^2/27^2), yet
# it is the PERFECT diagonal-plane workload. Sparse DIA stores only the
# present diagonals — planes (nd, rows) — and convolves the offset lists:
# C's diagonal (da + db) accumulates a_val[da] * shift(b_val[db], da).
# The offset lists are HOST-known (from the attached HostCSR: one
# O(nnz + span) bincount), so every shift is a static slice and the whole
# multiply is nd_a * nd_b fused vector multiply-adds — no gathers, no
# sorts, the same speed-of-light regime as contiguous DIA but on the
# sparse-band class the reference serves with its hash kernels.


def sdia_lut(offs: "np.ndarray", dmin: int, span: int):
    """Host (span,) lookup table: diagonal (d - dmin) -> plane index."""
    import numpy as np

    lut = np.zeros(span, np.int32)
    lut[np.asarray(offs, np.int64) - dmin] = np.arange(len(offs),
                                                       dtype=np.int32)
    return lut


@partial(jax.jit, static_argnames=("dmin", "rows",))
def sdia_slots(indptr, indices, lut, *, dmin: int, rows: int):
    """Flat plane slot of every CSR nonzero for LIST-indexed planes:
    slot = lut[col - row - dmin] * rows + row (every nonzero lies on a
    present diagonal by construction of the offset list)."""
    from .analysis import cumsum1d

    nnz = indices.shape[0]
    if nnz == 0:
        return jnp.zeros((0,), jnp.int32)
    rid = jnp.zeros((nnz,), jnp.int32).at[indptr[1:-1]].add(1, mode="drop")
    rid = cumsum1d(rid)
    d = jnp.clip(indices - rid - jnp.int32(dmin), 0, lut.shape[0] - 1)
    return lut[d] * jnp.int32(rows) + rid


def sdia_pad(off_a, m: int, k: int):
    """Static B-plane padding so every per-pair shift is an in-range
    slice: returns (pad_l, pad_r)."""
    return max(0, -min(off_a)), max(0, m + max(off_a) - k)


def sdia_plane_bytes(m: int, k: int, nd_a: int, nd_b: int, nd_c: int,
                     pad_w: int, itemsize: int = 4) -> int:
    """Peak working set of the sparse-DIA pipeline (memory gate)."""
    return itemsize * (
        2 * nd_a * m          # A value+hit planes
        + 2 * nd_b * k        # B value+hit planes
        + 2 * nd_b * pad_w    # padded B planes
        + 2 * nd_c * m        # C value+count planes
        + 3 * nd_c * m        # staged cols/vals + present
    )


@partial(jax.jit, static_argnames=("off_a", "off_b", "off_c", "blk",
                                   "win", "pad_l", "with_hit"))
def _sdia_conv_block(a_val, a_hit, bp, bph, r0, *, off_a: tuple,
                     off_b: tuple, off_c: tuple, blk: int, win: int,
                     pad_l: int, with_hit: bool):
    """One row block [r0, r0+blk) of the list-offset convolution: the
    unrolled pair FMAs run over block-length vectors, so XLA's temp
    working set is O(pairs * blk) instead of O(pairs * m) — the
    whole-matrix form runs out of compile-time memory at stencil scale
    (63 GB modeled for 729 pairs x 1.06M rows). bp/bph are the FULL
    padded B planes; the block's window is one dynamic_slice."""
    min_da = min(off_a)
    oc_index = {d: i for i, d in enumerate(off_c)}
    groups: dict = {}
    for ia, da in enumerate(off_a):
        for ib, db in enumerate(off_b):
            groups.setdefault(oc_index[da + db], []).append((ia, da, ib))
    a_blk = jax.lax.dynamic_slice(a_val, (0, r0), (a_val.shape[0], blk))
    ah_blk = (jax.lax.dynamic_slice(a_hit, (0, r0),
                                    (a_hit.shape[0], blk))
              if with_hit else a_blk)
    w0 = pad_l + min_da + r0
    bp_win = jax.lax.dynamic_slice(bp, (0, w0), (bp.shape[0], win))
    bph_win = (jax.lax.dynamic_slice(bph, (0, w0), (bph.shape[0], win))
               if with_hit else bp_win)
    acc_v = []
    acc_h = []
    for oc in range(len(off_c)):
        av = jnp.zeros((blk,), a_val.dtype)
        ah = jnp.zeros((blk,), jnp.float32) if with_hit else None
        for ia, da, ib in groups.get(oc, ()):
            s0 = da - min_da
            bw = jax.lax.slice(bp_win, (ib, s0), (ib + 1, s0 + blk))[0]
            av = av + a_blk[ia] * bw
            if with_hit:
                bwh = jax.lax.slice(bph_win, (ib, s0),
                                    (ib + 1, s0 + blk))[0]
                ah = ah + ah_blk[ia] * bwh
        acc_v.append(av)
        if with_hit:
            acc_h.append(ah)
    c_val = jnp.stack(acc_v) if acc_v else jnp.zeros((0, blk), a_val.dtype)
    c_cnt = (jnp.stack(acc_h) if with_hit and acc_h else None)
    return c_val, c_cnt


# row-block size for the blocked sparse-DIA convolution: bounds the
# unrolled pair FMAs' temp working set (pairs * SDIA_ROW_BLOCK floats)
SDIA_ROW_BLOCK = 1 << 17


def sdia_conv_blocked(a_val, a_hit, b_val, b_hit, *, off_a: tuple,
                      off_b: tuple, off_c: tuple, m: int, k: int,
                      with_hit: bool, row_block: int = SDIA_ROW_BLOCK):
    """sdia_conv in row blocks: ~m/row_block dispatches of ONE compiled
    block kernel + a concatenate. Memory-bounded at any m."""
    if m <= row_block:
        return sdia_conv(a_val, a_hit, b_val, b_hit, off_a=off_a,
                         off_b=off_b, off_c=off_c, m=m, k=k,
                         with_hit=with_hit)
    blk = row_block
    nblk = -(-m // blk)
    m_pad = nblk * blk
    pad_l, pad_r = sdia_pad(off_a, m_pad, k)
    bp = jnp.pad(b_val, ((0, 0), (pad_l, pad_r)))
    bph = jnp.pad(b_hit, ((0, 0), (pad_l, pad_r))) if with_hit else bp
    if m_pad > m:
        a_val = jnp.pad(a_val, ((0, 0), (0, m_pad - m)))
        a_hit = (jnp.pad(a_hit, ((0, 0), (0, m_pad - m)))
                 if with_hit else a_val)
    win = blk + (max(off_a) - min(off_a))
    pieces_v = []
    pieces_h = []
    for bidx in range(nblk):
        cv, ch = _sdia_conv_block(
            a_val, a_hit, bp, bph, jnp.int32(bidx * blk),
            off_a=tuple(off_a), off_b=tuple(off_b), off_c=tuple(off_c),
            blk=blk, win=win, pad_l=pad_l, with_hit=with_hit)
        pieces_v.append(cv)
        pieces_h.append(ch)
    c_val = jnp.concatenate(pieces_v, axis=1)[:, :m]
    c_cnt = (jnp.concatenate(pieces_h, axis=1)[:, :m]
             if with_hit else None)
    return c_val, c_cnt


@partial(jax.jit, static_argnames=("off_a", "off_b", "off_c", "m", "k",
                                   "with_hit"))
def sdia_conv(a_val, a_hit, b_val, b_hit, *, off_a: tuple, off_b: tuple,
              off_c: tuple, m: int, k: int, with_hit: bool):
    """List-offset diagonal convolution: for every (da, db) pair,
    C_plane[index of da+db] += a_val[da] * b_val[db] shifted by da.
    All offsets are static python ints, so every shift is a static
    slice; pairs are grouped by output plane and accumulated in
    python (statically unrolled — one fused elementwise kernel)."""
    oc_index = {d: i for i, d in enumerate(off_c)}
    pad_l, pad_r = sdia_pad(off_a, m, k)
    bp = jnp.pad(b_val, ((0, 0), (pad_l, pad_r)))
    bph = jnp.pad(b_hit, ((0, 0), (pad_l, pad_r))) if with_hit else None
    nd_b = len(off_b)
    groups: dict = {}
    for ia, da in enumerate(off_a):
        for ib, db in enumerate(off_b):
            groups.setdefault(oc_index[da + db], []).append((ia, da, ib))
    acc_v = []
    acc_h = []
    for oc in range(len(off_c)):
        av = jnp.zeros((m,), a_val.dtype)
        ah = jnp.zeros((m,), jnp.float32) if with_hit else None
        for ia, da, ib in groups.get(oc, ()):
            s0 = pad_l + da
            bw = jax.lax.slice(bp, (ib, s0), (ib + 1, s0 + m))[0]
            av = av + a_val[ia] * bw
            if with_hit:
                bwh = jax.lax.slice(bph, (ib, s0), (ib + 1, s0 + m))[0]
                ah = ah + a_hit[ia] * bwh
        acc_v.append(av)
        if with_hit:
            acc_h.append(ah)
    c_val = jnp.stack(acc_v) if acc_v else jnp.zeros((0, m), a_val.dtype)
    c_cnt = (jnp.stack(acc_h) if with_hit and acc_h else None)
    return c_val, c_cnt


@partial(jax.jit, static_argnames=("sa", "sb", "m", "k", "dmin_a", "sc",
                                   "n_cols", "base_c", "impl", "same"))
def dia_count_pipeline(slot_a, a_data, slot_b, b_data, *, sa: int,
                       sb: int, m: int, k: int, dmin_a: int, sc: int,
                       n_cols: int, base_c: int, impl: str, same: bool):
    """planes + convolution + count/stage as ONE dispatch (fewer
    launches and host round trips). The reference's analogue is one
    fused kernel launch per bin (spECK_HashSpGEMM.cuh:1800)."""
    av, ah = dia_planes(slot_a, a_data, span=sa, rows=m)
    bv, bh = (av, ah) if same else dia_planes(slot_b, b_data, span=sb,
                                              rows=k)
    c_val, c_cnt = dia_conv(av, ah, bv, bh, sa=sa, sb=sb, m=m, k=k,
                            dmin_a=dmin_a, with_hit=True)
    return dia_count_stage(c_val, c_cnt, sc=sc, m=m, n_cols=n_cols,
                           base_c=base_c, impl=impl)


@partial(jax.jit, static_argnames=("sa", "sb", "m", "k", "dmin_a",
                                   "with_hit", "same"))
def dia_rows_conv_fused(slot_a, a_data, slot_b, b_data, *, sa: int,
                        sb: int, m: int, k: int, dmin_a: int,
                        with_hit: bool, same: bool = False):
    """planes + convolution in ONE dispatch for the per-row DIA split
    (cfg.dia_rows — configs 1b/4's banded bulk)."""
    av, ah = dia_planes(slot_a, a_data, span=sa, rows=m)
    bv, bh = (av, ah) if same else dia_planes(slot_b, b_data, span=sb,
                                              rows=k)
    return dia_conv(av, ah, bv, bh, sa=sa, sb=sb, m=m, k=k,
                    dmin_a=dmin_a, with_hit=with_hit)


def _rank_compact(cvT, present, *, sc: int, m: int, n_cols: int,
                  base_c: int, impl: str, doffs=None):
    """Compact each row's present entries to the front, in diagonal
    order (= ascending column order within a row, so output is sorted
    for free).  impl="sort": one rank sort; impl="scatter": two flat
    scatters to i*sc + rank — dense in-order per-row write prefixes,
    the same A/B as the stream's _compact_rect (ops/stream.py).
    ``doffs`` (sparse DIA): per-plane diagonal offsets replacing the
    contiguous base_c + e."""
    e = jnp.arange(sc, dtype=jnp.int32)[None, :]
    i = jnp.arange(m, dtype=jnp.int32)[:, None]
    col_of_e = (jnp.int32(base_c) + e) if doffs is None else doffs[None, :]
    cols_g = jnp.where(present, i + col_of_e, n_cols)
    rank = jnp.cumsum(present, axis=1, dtype=jnp.int32) - 1
    if impl == "scatter":
        flat = jnp.where(present, i * sc + rank, m * sc).reshape(-1)
        cols_s = jnp.full((m * sc,), n_cols, jnp.int32).at[flat].set(
            cols_g.reshape(-1), mode="drop",
            unique_indices=True).reshape(m, sc)
        vals_s = jnp.zeros((m * sc,), cvT.dtype).at[flat].set(
            cvT.reshape(-1), mode="drop",
            unique_indices=True).reshape(m, sc)
        return cols_s, vals_s
    key = jnp.where(present, rank, sc + e)
    _, cols_s, vals_s = jax.lax.sort(
        (key, cols_g, cvT), dimension=1, num_keys=1)
    return cols_s, vals_s


@partial(jax.jit, static_argnames=("sc", "m", "n_cols", "base_c", "impl"))
def dia_count_stage(c_val, c_cnt, doffs=None, *, sc: int, m: int,
                    n_cols: int, base_c: int, impl: str = "sort"):
    """Counting + staging from the output planes: transpose to row-major,
    compact each row's present entries to the front (columns come out
    sorted for free — diagonal index order IS column order within a
    row).  Returns (nnz_row, present, cols_s, vals_s).  ``doffs``:
    sparse-DIA per-plane offsets (see _rank_compact)."""
    cvT = c_val.T                      # (m, sc)
    present = c_cnt.T > 0.5            # exact: fp32 counts of 1.0 adds
    counts = jnp.sum(present, axis=1, dtype=jnp.int32)
    cols_s, vals_s = _rank_compact(cvT, present, sc=sc, m=m,
                                   n_cols=n_cols, base_c=base_c,
                                   impl=impl, doffs=doffs)
    return counts, present, cols_s, vals_s


@partial(jax.jit, static_argnames=("sc", "m", "n_cols", "base_c", "impl"))
def dia_numeric_stage(c_val, present, doffs=None, *, sc: int, m: int,
                      n_cols: int, base_c: int, impl: str = "sort"):
    """Numeric re-staging against a KNOWN structure (plan reuse): same
    rank compaction, presence taken from the stored structural mask so
    value cancellation cannot change the emitted pattern."""
    return _rank_compact(c_val.T, present, sc=sc, m=m, n_cols=n_cols,
                         base_c=base_c, impl=impl, doffs=doffs)


@partial(jax.jit, static_argnames=("sc",))
def dia_offsets_meta(counts, *, sc: int):
    """Row offsets plus the uniform-run scalars in ONE readback.

    meta = [nnz, max_count, p, q, run_ok, offs_p]: [p, q) is the row
    range between the FIRST and LAST full rows (count == sc), run_ok=1
    iff every row in it is full and none outside is. For such a run the
    staged rows are the final CSR payload at the constant shift offs_p
    (all sc slots live, compaction is the identity, columns ascend by
    construction) — the host emits them as one contiguous copy instead
    of nnz random gathers (the banded interior: every row of BASELINE
    config 1 except the ~2*half_band band-clipped edge rows)."""
    from .analysis import cumsum1d

    m = counts.shape[0]
    offs = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), cumsum1d(counts)])
    full = counts == jnp.int32(sc)
    idx = jnp.arange(m, dtype=jnp.int32)
    p = jnp.min(jnp.where(full, idx, m))
    q = jnp.max(jnp.where(full, idx, -1)) + 1
    nfull = jnp.sum(full.astype(jnp.int32))
    run_ok = (nfull > 0) & (nfull == q - p)
    offs_p = offs[jnp.clip(p, 0, m)]
    meta = jnp.stack([
        offs[-1], jnp.max(counts, initial=0), p, q,
        run_ok.astype(jnp.int32), offs_p,
    ])
    return offs, meta


@partial(jax.jit, static_argnames=("base_c",))
def dia_scatter_emit(cvT, present, row_offsets, c_cols, c_vals, *,
                     base_c: int):
    """Per-row-DIA emission into a shared output, straight from the
    UNCOMPACTED (m, sc) output planes: each present entry scatters to
    row_offsets[r] + rank (rank = its position among the row's present
    entries; diagonal order IS ascending column order, so output rows
    are sorted for free and no rank-compact staging pass is needed).
    Rows routed to other paths have all-False presence and write
    nothing, so this composes with the stream/dense/direct emits over
    one C buffer — the mixed-routing analogue of the reference's
    per-block numeric writes to preallocated C."""
    m, sc = cvT.shape
    e = jnp.arange(sc, dtype=jnp.int32)[None, :]
    i = jnp.arange(m, dtype=jnp.int32)[:, None]
    cols_g = i + jnp.int32(base_c) + e
    rank = jnp.cumsum(present, axis=1, dtype=jnp.int32) - 1
    base = row_offsets[:-1][:, None]
    oob = c_cols.shape[0]
    flat = jnp.where(present, base + rank, oob).reshape(-1)
    c_cols = c_cols.at[flat].set(cols_g.reshape(-1), mode="drop",
                                 unique_indices=True)
    c_vals = c_vals.at[flat].set(cvT.reshape(-1), mode="drop",
                                 unique_indices=True)
    return c_cols, c_vals


@partial(jax.jit, static_argnames=("sc", "r0", "r1", "o0", "n_out"))
def dia_emit_edge(cols_s, vals_s, row_offsets, *, sc: int, r0: int,
                  r1: int, o0: int, n_out: int):
    """Gather-emit of outputs [o0, o0 + n_out) covering staged rows
    [r0, r1) — the non-uniform edge rows of a uniform-emit plan. All
    bounds are host-known after the meta readback, so shapes are
    static and exact (no padding)."""
    from .analysis import cumsum1d

    i = jnp.arange(n_out, dtype=jnp.int32)
    marks = jnp.zeros((n_out,), jnp.int32)
    if r1 - r0 > 1:
        marks = marks.at[row_offsets[r0 + 1:r1] - o0].add(1, mode="drop")
    rid = r0 + cumsum1d(marks)
    src = rid * sc + (i + o0 - row_offsets[rid])
    src = jnp.clip(src, 0, cols_s.size - 1)
    if vals_s.dtype.itemsize == 4:
        packed = jnp.stack(
            [cols_s.reshape(-1),
             jax.lax.bitcast_convert_type(vals_s.reshape(-1), jnp.int32)],
            axis=-1)
        rec = packed[src]
        return rec[..., 0], jax.lax.bitcast_convert_type(
            rec[..., 1], vals_s.dtype)
    return cols_s.reshape(-1)[src], vals_s.reshape(-1)[src]
