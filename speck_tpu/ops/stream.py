"""Stream ESC: flat product-stream SpGEMM kernels.

Successor to the per-row-rectangle ESC kernels (ops/esc.py) and the
analogue of BOTH of spECK's hard-row mechanisms at once:

- the shared-memory hash kernels with their per-size-class bins
  (/root/reference/include/GPU/spECK_HashSpGEMM.cuh:39-1173, bin ladder
  spECK_HashLoadBalancer.cuh:49-117), and
- the windowed giant-row machinery: the dense-window resume cursor
  (iterateMatrixDenseNumeric, spECK_HashSpGEMM.cuh:1175-1298) and the
  shared->global hash-map flush/restart protocol (:106-126) that let one
  row's products be processed across multiple passes.

Design
======

Every intermediate product of C = A @ B gets one slot in a single flat
stream, tight-packed (fill ~0.96 on the bench distributions; the SPMD
mesh path uses the same tight layout at a fixed shard-wide W):

  - rows are sorted by DESCENDING product count (one planning sort);
  - wide rows (ops > W) come first with exact ceil(ops/W) W-multiple
    allocations; contained rows pack back-to-back at e = cumsum(q),
    q = max(ops, min_q); the few rows whose allocation would straddle a
    width-W rectangle-row boundary (at most one per boundary) relocate
    through three further tight rounds, then a pow2-aligned tail — see
    _tight_layout. A second stable sort by final e restores ascending
    order; relocation holes are dead slots (killed by the rowend check);
  - the stream is chopped into fixed (G, W) chunks. Rows with q <= W are
    packed many-per-rectangle-row and never straddle a rectangle row or
    chunk boundary; rows with q > W ("wide rows") own whole rectangle
    rows and are finished by the level ladder below.

Per chunk (all flat batched ops -- no scan/vmap, see ops/esc.py notes):

  decode   row id and owning A-slot of every stream position via boundary
           scatters + blocked cumsums (run-length decode; replaces the
           owner-fill sorts of esc._expand -- O(products) elementwise work
           plus one O(m)/O(nnz) scatter per chunk).
  gather   the A-slot record (u = b_row_start - p0, prodend, valA) at sid,
           then the B (col, valB) record at u + t: TWO random gathers per
           live product -- the irreducible data movement.
  sort     each rectangle row by (row, col): one single-key sort on the
           packed key rid_local*C + col when it fits int32, else a two-key
           lax.sort. Output rows come out column-sorted for free.
  contract segmented Hillis-Steele scans give run boundaries (exact per-row
           nnz) and run sums (numeric values), exactly like esc._contract.
  compact  one rank sort moves run-last entries to the rectangle-row front
           (uniform staged layout consumed by emission and by the levels).

Wide rows (q > W): their per-rectangle-row compacted partial results are
re-streamed through "merge levels": level L re-sorts F=4 adjacent level
L-1 segments as one 4x-wider rectangle row and contracts again, until the
row fits one rectangle row and is final. This is the resume-cursor idea
expressed as iterated compaction: each level either dedups (hash-map flush
analogue) or just widens geometrically, so a row with 5e7+ products
finishes in ~log4(ops/W) levels with O(ops) total slots across levels.

Counting and numeric phases share all of this; when staging memory allows,
ONE pass produces both (the fused mode), else the numeric phase re-expands
(two-phase, like the reference's stages 7 and 13).

Capacity limits: total quantized products per call < 2^31 (int32 stream
positions; the reference's own row/col ceiling is 2^27, Multiply.cu:57-66).
Larger problems must be row-blocked by the caller.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import ProductOverflow
from .analysis import cumsum1d

INT_MAX = jnp.iinfo(jnp.int32).max

# power-of-two class ladder: q class k has q = 1 << k
N_QCLASS = 32

# tight layout: wide-row segment counts shipped in the planning pack
# (exact ceil(ops/W) per wide row); beyond this many wide rows the host
# falls back to ONE extra fetch of the wide rows' ops
N_WSEG_PACK = 512


def _pow2ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _cumsum_w(x: jax.Array) -> jax.Array:
    """Inclusive cumsum along axis 1 via Hillis-Steele doubling: log2(W)
    shifted adds, all vectorized (chosen over jnp.cumsum before the H100
    port; not yet measured on the H100)."""
    W = x.shape[1]
    d = 1
    while d < W:
        x = x + jnp.concatenate(
            [jnp.zeros_like(x[:, :d]), x[:, :-d]], axis=1)
        d <<= 1
    return x


def _cumsum_rect(x: jax.Array) -> jax.Array:
    """Inclusive cumsum over a (G, W) array in flat row-major order:
    per-row cumsum + row-carry (the 2-D form of analysis.cumsum1d)."""
    inner = _cumsum_w(x)
    carry = jnp.concatenate(
        [jnp.zeros((1,), x.dtype), jnp.cumsum(inner[:, -1])[:-1]]
    )
    return inner + carry[:, None]


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def _plan_stream_impl(row_ops, stream_mask, direct_mask, a_indptr, a_indices,
                      a_data32, b_start, b_len, *, min_q: int, m: int,
                      tight: bool = False, w_fixed: Optional[int] = None):
    """Device planning pass for the stream layout (row layout + A-slot
    records; the SPMD mesh path uses this combined form).

    Returns (rows_sorted, e, q_sorted, el, ops_sorted, p0, su, sa, src,
    pend, hist_pack):
      rows_sorted (m,)  row ids sorted by descending q (stream rows first,
                        then direct rows by descending copy-length class,
                        then everything else)
      e (m,)            aligned stream start of each SORTED row (int32)
      q_sorted (m,)     product quantum per sorted row (0 for non-stream)
      el (m,)           exclusive cumsum of LIVE ops in sorted order (the
                        post-sort live-slot prefix; row j's live entries
                        occupy [el[j] - rect_base, +ops) of its rectangle
                        row after the sort packs dead slots to the end)
      ops_sorted (m,)   live product count per sorted row
      p0 (nnz,)         stream start of each kept sorted-order A-slot
                        (zero-product slots compacted out; INT_MAX tail)
      su/sa (nnz,)      per-kept-slot channels u = b_row_start - p0 and
                        valA bits (see build_srec)
      hist_pack (2*N_QCLASS,) int32: stream q-class histogram | direct
                        copy-length-class histogram
    """
    (rows_sorted, e, q_sorted, el, ops_sorted, _e2, _q2,
     hist_pack, _tp) = _plan_rows_impl(
        row_ops, stream_mask, direct_mask, min_q=min_q, m=m,
        tight=tight, w_fixed=w_fixed)
    p0, su, sa, src, pend = build_srec(a_indptr, a_indices, a_data32,
                                       b_start, b_len, rows_sorted, e,
                                       q_sorted, m=m)
    return (rows_sorted, e, q_sorted, el, ops_sorted, p0, su, sa, src,
            pend, hist_pack)


@partial(jax.jit,
         static_argnames=("min_q", "m", "tight", "w0", "w_cap",
                          "w_fixed"))
def _plan_rows_impl(row_ops, stream_mask, direct_mask, *, min_q: int,
                    m: int, accum_mask=None, span=None,
                    tight: bool = False, w0: int = 8192,
                    w_cap: int = 65536, w_fixed: Optional[int] = None):
    """Row-level half of stream planning: sort, stream offsets, live
    prefixes, class histograms — everything O(m).

    Two layouts:

    - pow2 (``tight=False``, the SPMD mesh path): q = pow2ceil(ops),
      descending sort, aligned cumsum — fill ops/q in (0.5, 1].
    - tight (``tight=True``, the single-chip path): near-perfect packing.
      The rectangle width W is chosen HERE (the adaptive ladder
      min(max(w0, 2^(maxclass-10)), 65536) moved on-device; the host reads
      it back in the pack). Wide rows (ops > W) get exact
      ceil(ops/W)-segment W-multiple allocations; contained rows are
      placed back-to-back at e = cumsum(max(ops, min_q)); the few rows
      that would straddle a W boundary (at most one per boundary) are
      relocated to a pow2-aligned region appended past the stream end.
      A second stable sort by final e restores the ascending-e order every
      consumer (decode, counting, gather emit) requires. Fill ~0.95+ vs
      ~0.72 pow2 — every per-slot cost (sorts, gathers, decodes) shrinks
      proportionally.

    With ``accum_mask``/``span``, eligible huge rows form a FOURTH region
    sorted first (grouped by span class descending): they get their own
    tightly packed product space (e2 — no quantization; the accumulator
    does not sort, so no alignment is needed) and sentinel e = -1 in the
    main stream (counted by rid bases, never decoded into chunks).

    Returns (rows_sorted, e, q_sorted, el, ops_sorted, e2, q2_sorted,
    hist_pack, tight_pack) where tight_pack (4 + N_WSEG_PACK int32) =
    [W, total_q, n_wide, r_wide, wide_segs...] (zeros when tight=False).
    """
    ops = jnp.maximum(row_ops, 0)
    # exact integer ceil(log2): count powers of two below ops (float log2
    # is off by ulps exactly at the class boundaries). Class 31 = rows
    # beyond the 2^30 per-row ceiling; plan_layout rejects those.
    pows = jnp.int32(1) << jnp.arange(31, dtype=jnp.int32)
    clog2 = jnp.sum(ops[:, None] > pows[None, :], axis=1, dtype=jnp.int32)
    qc = jnp.maximum(clog2, int(np.log2(min_q)))
    if accum_mask is None:
        accum_mask = jnp.zeros((m,), bool)
        span = jnp.ones((m,), jnp.int32)
    sp = jnp.maximum(span, 1)
    sc = jnp.sum(sp[:, None] > pows[None, :], axis=1, dtype=jnp.int32)
    qc = jnp.where(stream_mask, qc, 0)
    dc = jnp.where(direct_mask, clog2, 0)
    sc = jnp.where(accum_mask, sc, 0)

    # sort key: region (0 accum / 1 stream / 2 direct / 3 rest), then
    # descending class (span class for accum, q class otherwise); tight
    # adds a -ops key so stream rows are exactly descending by ops
    region = jnp.where(accum_mask, 0,
                       jnp.where(stream_mask, 1,
                                 jnp.where(direct_mask, 2, 3)))
    subkey = jnp.where(accum_mask, N_QCLASS - 1 - sc,
                       jnp.where(stream_mask, N_QCLASS - 1 - qc,
                                 jnp.where(direct_mask,
                                           N_QCLASS - 1 - dc, 0)))
    key = region * (2 * N_QCLASS) + subkey
    row_ids = jnp.arange(m, dtype=jnp.int32)
    if tight:
        _, _, rows_sorted = jax.lax.sort(
            (key, -ops, row_ids), dimension=0, num_keys=2, is_stable=True)
    else:
        _, rows_sorted = jax.lax.sort(
            (key, row_ids), dimension=0, num_keys=1, is_stable=True)

    cls = jnp.arange(N_QCLASS, dtype=jnp.int32)
    s_hist = jnp.sum((qc[None, :] == cls[:, None]) & stream_mask[None, :],
                     axis=1, dtype=jnp.int32)
    d_hist = jnp.sum((dc[None, :] == cls[:, None]) & direct_mask[None, :],
                     axis=1, dtype=jnp.int32)
    a_hist = jnp.sum((sc[None, :] == cls[:, None]) & accum_mask[None, :],
                     axis=1, dtype=jnp.int32)
    a_psum = jnp.sum(
        jnp.where((sc[None, :] == cls[:, None]) & accum_mask[None, :],
                  ops[None, :], 0), axis=1, dtype=jnp.int32)
    hist_pack = jnp.concatenate([s_hist, d_hist, a_hist, a_psum])

    if tight:
        return _tight_layout(rows_sorted, ops, qc, stream_mask,
                             accum_mask, s_hist, hist_pack,
                             min_q=min_q, m=m, w0=w0, w_cap=w_cap,
                             w_fixed=w_fixed)

    # aligned stream offsets over sorted order (pow2 q, descending => each
    # e is q-aligned; see module docstring)
    q_sorted = jnp.where(stream_mask[rows_sorted],
                         jnp.int32(1) << qc[rows_sorted], 0)
    e = cumsum1d(q_sorted) - q_sorted  # exclusive
    # accum rows sort BEFORE the stream region: sentinel -1 keeps them
    # counted by rid bases (#(e < chunk_start)) but never decoded into a
    # chunk; direct/rest rows AFTER the region keep the natural cumsum
    # value (= total_q), which already excludes them from earlier chunks
    e = jnp.where(accum_mask[rows_sorted], -1, e)
    ops_sorted = jnp.where(stream_mask[rows_sorted], ops[rows_sorted], 0)
    el = cumsum1d(ops_sorted) - ops_sorted
    # accumulator product space: tight (no alignment needed — no sorting);
    # accum rows are first, so the natural cumsum is globally ascending
    q2_sorted = jnp.where(accum_mask[rows_sorted], ops[rows_sorted], 0)
    e2 = cumsum1d(q2_sorted) - q2_sorted
    tight_pack = jnp.zeros((4 + N_WSEG_PACK,), jnp.int32)
    return (rows_sorted, e, q_sorted, el, ops_sorted, e2, q2_sorted,
            hist_pack, tight_pack)


def _tight_layout(rows1, ops, qc, stream_mask, accum_mask, s_hist,
                  hist_pack, *, min_q: int, m: int, w0: int,
                  w_cap: int = 65536, w_fixed: Optional[int] = None):
    """Tight stream placement (see _plan_rows_impl): exact wide segments,
    back-to-back contained rows, straddler relocation, final e-sort.
    ``tight_total_host`` is the exact numpy twin of this placement's
    total — keep the two in sync."""
    if w_fixed is not None:
        # SPMD mesh path: W is a host-static shard shape parameter
        W = jnp.int32(w_fixed)
    else:
        # adaptive rectangle width, decided on device from the q-class
        # histogram (host reads W back from tight_pack[0] — the single
        # source of truth for the ladder)
        cls = jnp.arange(N_QCLASS, dtype=jnp.int32)
        maxcls = jnp.max(jnp.where(s_hist > 0, cls, -1))
        W = jnp.minimum(
            jnp.maximum(jnp.int32(w0),
                        jnp.int32(1) << jnp.clip(maxcls - 10, 0, 16)),
            jnp.int32(max(w0, w_cap)))

    ops1 = ops[rows1]
    stream1 = stream_mask[rows1]
    accum1 = accum_mask[rows1]
    wide1 = stream1 & (ops1 > W)
    segs1 = jnp.where(wide1, (ops1 + W - 1) // W, 0)
    # mid-size contained rows (q > W/8) take their pow2 quantum UPFRONT:
    # the descending sort makes them a contiguous region of non-increasing
    # pow2 allocations right after the W-aligned wide region, so every
    # start is self-aligned and they can never straddle. Relocation holes
    # are never reclaimed (a straddler's round-0 reservation goes dead),
    # so back-to-back packing of rows ~W/2 wide loses ~2.2x to holes
    # (measured on the mixed banded+outliers bench: 13.8M slots for 6.3M
    # quanta); pow2 caps that class's waste at 2x and in exchange the
    # small-row region's straddle rate drops to <= (W/8)/W.
    qe1 = jnp.maximum(ops1, min_q)
    qp1 = jnp.int32(1) << qc[rows1]
    q1 = jnp.where(wide1, segs1 * W,
                   jnp.where(stream1,
                             jnp.where(qe1 > W // 8, qp1, qe1), 0))
    # round 0: wide rows (W-aligned by construction) + contained rows
    # back-to-back. A contained row whose allocation [e, e+q) crosses a W
    # boundary relocates to the next round's region (its slot becomes a
    # hole, dead by the rowend check); each round's straddler fraction is
    # ~avg_row/W, so three tight rounds leave ~(avg/W)^3 of the rows for
    # the final pow2-aligned tail.
    c = cumsum1d(q1)
    e_try = c - q1
    strad = stream1 & ~wide1 & ((e_try // W) != ((e_try + q1 - 1) // W))
    e_f1 = jnp.where(stream1 & ~strad, e_try, 0)
    total_q = c[-1]
    base = ((total_q + W - 1) // W) * W
    pend = strad
    for _ in range(2):
        alloc = jnp.where(pend, q1, 0)
        c = cumsum1d(alloc)
        e_try = base + c - alloc
        strad = pend & ((e_try // W) != ((e_try + q1 - 1) // W))
        e_f1 = jnp.where(pend & ~strad, e_try, e_f1)
        placed = c[-1] > 0
        total_q = jnp.where(placed, base + c[-1], total_q)
        base = jnp.where(placed, ((base + c[-1] + W - 1) // W) * W, base)
        pend = strad
    # final tail: pow2 allocations from a W-aligned base (descending pow2
    # from an aligned base => every start is self-aligned, no straddling)
    qs2 = jnp.where(pend, jnp.int32(1) << qc[rows1], 0)
    c2 = cumsum1d(qs2)
    e_f1 = jnp.where(pend, base + c2 - qs2, e_f1)
    total_q = jnp.where(c2[-1] > 0, base + c2[-1], total_q)
    q_f1 = jnp.where(pend, qs2, q1)
    e_f1 = jnp.where(stream1, e_f1,
                     jnp.where(accum1, jnp.int32(-1), total_q))
    # accumulator product space (sort-1 order == final order for the
    # accum prefix; non-accum rows all carry the constant total)
    q2_1 = jnp.where(accum1, ops1, 0)
    e2_1 = cumsum1d(q2_1) - q2_1

    # restore ascending-e order (stable: equal keys — the accum -1s and
    # the direct/rest total_q tail — keep their region ordering)
    idx1 = jnp.arange(m, dtype=jnp.int32)
    _, pi = jax.lax.sort((e_f1, idx1), dimension=0, num_keys=1,
                         is_stable=True)
    rows_sorted = rows1[pi]
    e = e_f1[pi]
    q_sorted = q_f1[pi]
    ops_sorted = jnp.where(stream1, ops1, 0)[pi]
    el = cumsum1d(ops_sorted) - ops_sorted
    e2 = e2_1[pi]
    q2_sorted = q2_1[pi]

    # pack: W, totals, and the wide rows' exact segment counts (final
    # positions [n_accum, n_accum + n_wide); K-capped, host falls back to
    # one extra fetch past the cap)
    n_wide = jnp.sum(wide1, dtype=jnp.int32)
    r_wide = jnp.sum(segs1, dtype=jnp.int32)
    n_accum = jnp.sum(accum1, dtype=jnp.int32)
    ops_pad = jnp.concatenate(
        [ops_sorted, jnp.zeros((N_WSEG_PACK,), jnp.int32)])
    wwin = jax.lax.dynamic_slice(ops_pad, (n_accum,), (N_WSEG_PACK,))
    k_idx = jnp.arange(N_WSEG_PACK, dtype=jnp.int32)
    wsegs = jnp.where(k_idx < n_wide, (wwin + W - 1) // W, 0)
    tight_pack = jnp.concatenate(
        [jnp.stack([W, total_q, n_wide, r_wide]), wsegs])
    return (rows_sorted, e, q_sorted, el, ops_sorted, e2, q2_sorted,
            hist_pack, tight_pack)


def tight_total_host(row_ops: np.ndarray, W: int,
                     min_q: int) -> int:
    """Exact numpy twin of _tight_layout's stream total (same rounds,
    same roundups) — the SPMD mesh path sizes its static shard shapes
    with this. Kept in lockstep with the device code; pinned by
    tests/test_stream.py::test_tight_total_host_matches_device."""
    ops = np.asarray(row_ops, np.int64)
    ops = np.sort(ops[ops > 0])[::-1]
    if ops.size == 0:
        return 0
    wide = ops > W
    qe = np.maximum(ops, min_q)
    q = np.where(wide, -(-ops // W) * W,
                 np.where(qe > W // 8, _pow2ceil_arr(qe), qe))
    c = np.cumsum(q)
    e_try = c - q
    strad = ~wide & ((e_try // W) != ((e_try + q - 1) // W))
    total_q = int(c[-1])
    base = -(-total_q // W) * W
    pend = strad
    for _ in range(2):
        alloc = np.where(pend, q, 0)
        c = np.cumsum(alloc)
        e_try = base + c - alloc
        strad = pend & ((e_try // W) != ((e_try + q - 1) // W))
        if c[-1] > 0:
            total_q = int(base + c[-1])
            base = -(-(base + int(c[-1])) // W) * W
        pend = strad
    qs2 = np.where(pend, _pow2ceil_arr(np.maximum(ops, min_q)), 0)
    tail = int(qs2.sum())
    if tail > 0:
        total_q = base + tail
    return total_q


def _pow2ceil_arr(x: np.ndarray) -> np.ndarray:
    x = np.maximum(np.asarray(x, np.int64), 1)
    return 1 << np.ceil(np.log2(x.astype(np.float64))).astype(np.int64)


@partial(jax.jit, static_argnames=("m", "nl", "compact", "pack_gathers"))
def build_srec(a_indptr, a_indices, a_data32, b_start, b_len, rows_sorted,
               e, q_sorted, *, m: int, nl: Optional[int] = None,
               compact: bool = True, pack_gathers: bool = False):
    """Per-sorted-A-slot stream records (the O(nnz) half of planning):
    (p0, su, sa, src, pend) — see _plan_stream_impl. Split out so
    matrices with no stream rows (pure dense / direct) skip it entirely.

    The channels are SEPARATE 1-D arrays (not an (nnz, 2) record): they
    are only ever read channel-wise by the boundary scatters of the
    "fill" expand, and XLA has been observed to materialize (N, small)
    int arrays with a padded tiling — a 64x physical blow-up that ran a
    50M-nnz input out of memory before the H100 port.

    Zero-product A-slots (empty B rows, non-stream rows) are COMPACTED
    out: kept slots have strictly increasing p0 (each consumes >= 1
    product position), so any G*W-product chunk intersects at most
    G*W + 2 records and the expand can scatter from a dynamic-slice
    window instead of all nnz records per chunk (O(nnz)-per-chunk was a
    13x blow-up on the 50M-nnz giant-row bench). The compacted tail is
    p0 = INT_MAX sentinels, harmless to searchsorted and the window.

    ``nl``: size of the record arrays AND of all internal per-slot work
    — an upper bound on the LIVE (stream-routed) A slots, known to the
    host from the planning pack before this runs. On inputs where most
    nonzeros feed non-stream rows (the 50M-nnz giant-row bench routes
    ~85k of 50M slots through the stream) this turns the ~8 O(nnz)
    passes into O(live) ones. None = nnz (the SPMD mesh path, where no
    readback is available).

    ``compact=False``: skip the 5 compaction scatters — SAFE
    iff every chunk's expand can see ALL records (NL <= one chunk's
    G*W + 2, so the dynamic-slice window never engages): zero-product
    slots then merely duplicate a p0 value and the expand's
    equal-p0-winner logic already resolves those.
    ``pack_gathers``: gather (b_start, b_len) and (a_col, a_val) as
    8-byte records — 2 random reads instead of 4 (kept off past ~8M
    slots, where an (N, 2) tiling transient can bite, see above)."""
    stream_mask_s = q_sorted > 0
    nnz = a_indices.shape[0]
    NL = max(nnz if nl is None else min(nl, nnz), 1)
    alen = a_indptr[1:] - a_indptr[:-1]
    alen_eff = jnp.where(stream_mask_s, alen[rows_sorted], 0)
    ca = cumsum1d(alen_eff)            # inclusive; ca[-1] = live A-slots
    ca_excl = ca - alen_eff
    # sorted-slot s belongs to sorted row rid_s: run-length decode
    sridb = jnp.zeros((NL,), jnp.int32).at[ca_excl].add(
        1, mode="drop")
    rid_s = cumsum1d(sridb) - 1
    rid_s = jnp.clip(rid_s, 0, m - 1)
    src = a_indptr[rows_sorted[rid_s]] + (
        jnp.arange(NL, dtype=jnp.int32) - ca_excl[rid_s])
    src = jnp.clip(src, 0, max(nnz - 1, 0))
    live_s = jnp.arange(NL, dtype=jnp.int32) < ca[-1]
    if pack_gathers:
        arec = jnp.stack([a_indices, a_data32], axis=-1)[src]
        acol = arec[..., 0]
        a32s = arec[..., 1]
        brec = jnp.stack([b_start, b_len], axis=-1)[acol]
        bst = brec[..., 0]
        blen = brec[..., 1]
    else:
        acol = a_indices[src]
        a32s = a_data32[src]
        bst = b_start[acol]
        blen = b_len[acol]
    blen = jnp.where(live_s, blen, 0)
    cb = cumsum1d(blen)
    # product start of sorted slot s: e[rid_s] + products of earlier slots
    # of the same row
    row_first = jnp.clip(ca_excl[rid_s], 0, NL - 1)
    cb_excl = cb - blen
    cb_rowbase = cb_excl - jnp.take(cb_excl, row_first)
    p0 = jnp.where(live_s, e[rid_s] + cb_rowbase, jnp.int32(INT_MAX))
    u = jnp.where(live_s, bst - p0, 0)
    pend = jnp.where(live_s, p0 + blen, 0)
    if not compact:
        return (p0, u, jnp.where(live_s, a32s, 0),
                jnp.where(live_s, src, 0), pend)
    # compact: keep only slots that own at least one product
    keep = live_s & (blen > 0)
    rank = cumsum1d(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, rank, NL)
    size = (NL,)

    def compact_(x, fill):
        return jnp.full(size, fill, jnp.int32).at[tgt].set(
            x, mode="drop", unique_indices=True)

    return (compact_(p0, INT_MAX), compact_(u, 0),
            compact_(a32s, 0), compact_(src, 0), compact_(pend, 0))


@partial(
    jax.jit,
    static_argnames=("min_q", "direct_ok", "use_dense", "tile_rows",
                     "kw_max", "cw_max", "la_max", "lb_max", "max_tiles",
                     "m", "use_accum", "accum_min_ops", "accum_span_cap",
                     "w0", "w_cap", "use_dia_rows", "dia_span_cap",
                     "dia_waste_cap", "dia_mem_budget", "dia_itemsize"),
)
def plan_device_stream(a_indptr, a_indices, a_data32, b_indptr, b_indices,
                       row_ops, row_ops_f, a_len, *, min_q: int,
                       direct_ok: bool,
                       use_dense: bool, tile_rows: int, kw_max: int,
                       cw_max: int, la_max: int, lb_max: int,
                       max_tiles: int, m: int, use_accum: bool = False,
                       accum_min_ops: int = 1 << 14,
                       accum_span_cap: int = 1 << 20, w0: int = 8192,
                       w_cap: int = 65536, use_dia_rows: bool = False,
                       dia_span_cap: int = 512,
                       dia_waste_cap: float = 8.0,
                       dia_mem_budget: int = 1 << 30,
                       dia_itemsize: int = 4):
    """Single-dispatch planning: dense-tile eligibility (ops/dense.py),
    direct/stream masks, the tight stream layout sort, and the A-slot
    records -- ONE packed int32 readback serves every host decision (the
    analogue of the reference's planning D2H points, Multiply.cu:249-252
    and spECK_HashLoadBalancer.cuh:330-331).

    pack = [stream q-class hist (32) | direct class hist (32) |
            accum class hist (32) | accum product sums (32) |
            n_eligible_tiles | kw_eff | cw_eff | la_eff | lb_eff |
            a_dmin | a_dmax | b_dmin | b_dmax | sum_products_sat |
            max_row_products_sat | sum_products_exact |
            dia_dlo_a | dia_dhi_a | dia_dlo_b | dia_dhi_b | n_dia |
            n_live_slots | n_live_slots_accum |
            W | total_q | n_wide | r_wide | wide_segs (N_WSEG_PACK)]

    The a/b_dmin/dmax + sp_sat scalars feed the DIA fast-path gate
    (ops/dia.py): the min/max of (col - row) over A and over B (exact for
    canonical matrices: a row's first/last column id is its min/max), and
    the total product count saturated to int32 (only used as a host
    waste-ratio heuristic, so saturation is benign). When the early gate
    (plan_gate) already computed these 7 scalars, they are INTENTIONALLY
    recomputed here so the pack layout stays fixed — the duplicate is
    O(m) device work, dead only on the route where the gate already won.
    The tight-layout tail (see _plan_rows_impl) carries the device-chosen
    rectangle width and the exact stream totals.
    """
    from .dense import tile_stats

    # host-analysis path ships ONLY row_ops (one H2D instead of four);
    # the companions are derived here. row_ops_f from int32 is exact on
    # that path because _check_limits already proved no row wrapped.
    if a_len is None:
        a_len = a_indptr[1:] - a_indptr[:-1]
    if row_ops_f is None:
        row_ops_f = row_ops.astype(jnp.float32)

    # ---- per-row DIA split (cfg.dia_rows): robust band + row mask ----
    # The whole-matrix DIA gate fails when a few rows break the band;
    # here a band with a 5%-per-side outlier allowance (k-th order
    # statistics of the per-row diagonal extents) selects the banded
    # BULK for the diagonal-plane route. A row qualifies iff its own
    # extent fits the robust band AND every B row it touches is in-band,
    # so each C row is produced by exactly one path. The span/waste/
    # memory gates of the whole-matrix route (spgemm._dia_spans) are
    # evaluated HERE on device: a failed gate zeroes the mask before the
    # other routes partition the rows, so routing needs no second
    # readback.
    if use_dia_rows and m > 0 and a_indices.shape[0] > 0:
        kb = b_indptr.shape[0] - 1
        rowi = jnp.arange(m, dtype=jnp.int32)
        ne_a = a_len > 0
        a_first_d = a_indices[a_indptr[:-1]] - rowi
        a_last_d = a_indices[jnp.maximum(a_indptr[1:] - 1, 0)] - rowi
        n_ne = jnp.sum(ne_a.astype(jnp.int32))
        pad = n_ne // 20
        dmin_s = jnp.sort(jnp.where(ne_a, a_first_d, INT_MAX))
        dmax_s = jnp.sort(jnp.where(ne_a, a_last_d, INT_MAX))
        dlo_a = dmin_s[jnp.clip(pad, 0, m - 1)]
        dhi_a = dmax_s[jnp.clip(n_ne - 1 - pad, 0, m - 1)]
        rowk = jnp.arange(kb, dtype=jnp.int32)
        blen_d = b_indptr[1:] - b_indptr[:-1]
        ne_b = blen_d > 0
        b_first_d = b_indices[b_indptr[:-1]] - rowk
        b_last_d = b_indices[jnp.maximum(b_indptr[1:] - 1, 0)] - rowk
        n_ne_b = jnp.sum(ne_b.astype(jnp.int32))
        padb = n_ne_b // 20
        bmin_s = jnp.sort(jnp.where(ne_b, b_first_d, INT_MAX))
        bmax_s = jnp.sort(jnp.where(ne_b, b_last_d, INT_MAX))
        dlo_b = bmin_s[jnp.clip(padb, 0, kb - 1)]
        dhi_b = bmax_s[jnp.clip(n_ne_b - 1 - padb, 0, kb - 1)]
        # empty B rows are vacuously in-band (contribute nothing)
        b_in = (~ne_b) | ((b_first_d >= dlo_b) & (b_last_d <= dhi_b))
        a_in = ne_a & (a_first_d >= dlo_a) & (a_last_d <= dhi_a)
        nnz_a = a_indices.shape[0]
        seg_d = cumsum1d(jnp.zeros((nnz_a,), jnp.int32).at[
            a_indptr[1:-1]].add(1, mode="drop"))
        all_b_in = jax.ops.segment_min(
            b_in[a_indices].astype(jnp.int32), seg_d,
            num_segments=m) == 1
        dia_mask = a_in & all_b_in & (row_ops > 0)
        sa_d = dhi_a - dlo_a + 1
        sb_d = dhi_b - dlo_b + 1
        sc_d = sa_d + sb_d - 1
        dia_ops = jnp.sum(jnp.where(dia_mask, row_ops_f, 0.0))
        mf = jnp.float32(m)
        kf = jnp.float32(kb)
        saf = sa_d.astype(jnp.float32)
        sbf = sb_d.astype(jnp.float32)
        scf = sc_d.astype(jnp.float32)
        # dia.plane_bytes in f32 arithmetic (overflow-immune)
        planes_f = jnp.float32(dia_itemsize) * (
            2 * saf * mf + 2 * sbf * kf + 2 * sbf * (mf + saf)
            + 2 * scf * mf + 3 * scf * mf)
        ok = ((dlo_a <= dhi_a) & (dlo_b <= dhi_b)
              & (sa_d <= dia_span_cap) & (sb_d <= dia_span_cap)
              & (jnp.maximum(jnp.maximum(saf * mf, sbf * kf), scf * mf)
                 < 2.0 ** 31)
              & (mf * saf * sbf
                 <= dia_waste_cap * jnp.maximum(dia_ops, 1.0))
              & (planes_f <= jnp.float32(dia_mem_budget)))
        dia_mask = dia_mask & ok
        n_dia = jnp.sum(dia_mask.astype(jnp.int32))
        dia_pack = jnp.stack([dlo_a, dhi_a, dlo_b, dhi_b, n_dia]
                             ).astype(jnp.int32)
    else:
        dia_mask = jnp.zeros((m,), bool)
        dia_pack = jnp.stack(
            [jnp.int32(1), jnp.int32(0), jnp.int32(1), jnp.int32(0),
             jnp.int32(0)])

    if use_dense and m > 0:
        stats = tile_stats(a_indptr, a_indices, b_indptr, b_indices,
                           row_ops, a_len, tile_rows=tile_rows, m=m)
        kmin, kspan, cmin, cspan, amax, bmax = (stats[i] for i in range(6))
        T = kmin.shape[0]
        elig = (
            (kspan <= kw_max) & (cspan <= cw_max)
            & (amax <= la_max) & (bmax <= lb_max) & (cspan > 0)
        )
        # tiles holding any per-row-DIA row are ineligible (the planes
        # outrank the dense windows; each row rides exactly one path)
        padm = T * tile_rows - m
        dia_t = jnp.any(jnp.concatenate(
            [dia_mask, jnp.zeros((padm,), bool)]).reshape(T, tile_rows),
            axis=1)
        elig = elig & ~dia_t
        elig = elig & (jnp.cumsum(elig.astype(jnp.int32)) <= max_tiles)
        n_elig = jnp.sum(elig, dtype=jnp.int32)
        tid = jnp.arange(T, dtype=jnp.int32)
        key = jnp.where(elig, tid, T + tid)
        key_s, kb_s, cb_s = jax.lax.sort(
            (key, kmin, cmin), dimension=0, num_keys=1)
        is_real = key_s < T
        r0 = jnp.where(is_real, key_s * tile_rows, m)
        valid = jnp.where(
            is_real, jnp.minimum(tile_rows, m - key_s * tile_rows), 0)
        kb_s = jnp.where(is_real, kb_s, 0)
        cb_s = jnp.where(is_real, cb_s, 0)
        kw_eff = jnp.max(jnp.where(elig, kspan, 0))
        cw_eff = jnp.max(jnp.where(elig, cspan, 0))
        la_eff = jnp.max(jnp.where(elig, amax, 0))
        lb_eff = jnp.max(jnp.where(elig, bmax, 0))
        dense_mask = jnp.repeat(
            elig, tile_rows, total_repeat_length=T * tile_rows)[:m]
    else:
        n_elig = jnp.int32(0)
        r0 = jnp.zeros((0,), jnp.int32)
        kb_s = jnp.zeros((0,), jnp.int32)
        cb_s = jnp.zeros((0,), jnp.int32)
        valid = jnp.zeros((0,), jnp.int32)
        kw_eff = cw_eff = la_eff = lb_eff = jnp.int32(0)
        dense_mask = jnp.zeros((m,), bool)

    if direct_ok:
        direct_mask = ((a_len == 1) & (row_ops > 0) & ~dense_mask
                       & ~dia_mask)
    else:
        direct_mask = jnp.zeros((m,), bool)
    if use_accum and m > 0:
        # per-row output-column range (segment min/max over A's nonzeros —
        # the rowColMinMax analogue, common.cuh:303-319); canonical B, so
        # a B row's range is its first/last column id
        b_len = b_indptr[1:] - b_indptr[:-1]
        b_ne = b_len > 0
        b_cmin = jnp.where(b_ne, b_indices[b_indptr[:-1]], INT_MAX)
        b_cmax = jnp.where(
            b_ne, b_indices[jnp.maximum(b_indptr[1:] - 1, 0)], -1)
        nnz = a_indices.shape[0]
        # blocked cumsum (analysis.cumsum1d) over nnz
        seg = (cumsum1d(jnp.zeros((nnz,), jnp.int32).at[
            a_indptr[1:-1]].add(1, mode="drop")) if nnz
            else jnp.zeros((0,), jnp.int32))
        gcmin = jax.ops.segment_min(b_cmin[a_indices], seg, num_segments=m)
        gcmax = jax.ops.segment_max(b_cmax[a_indices], seg, num_segments=m)
        span = jnp.maximum(gcmax - jnp.minimum(gcmin, gcmax) + 1, 1)
        gcmin = jnp.where(gcmax < 0, 0, gcmin)
        accum_mask = (
            (row_ops > accum_min_ops) & (span <= accum_span_cap)
            & ~dense_mask & ~direct_mask & ~dia_mask & (row_ops > 0))
    else:
        gcmin = jnp.zeros((m,), jnp.int32)
        span = jnp.ones((m,), jnp.int32)
        accum_mask = jnp.zeros((m,), bool)
    stream_mask = ((row_ops > 0) & ~direct_mask & ~dense_mask
                   & ~accum_mask & ~dia_mask)
    (rows_sorted, e, q_sorted, el, ops_sorted, e2, q2_sorted,
     hist, tight_pack) = _plan_rows_impl(
        row_ops, stream_mask, direct_mask, min_q=min_q, m=m,
        accum_mask=accum_mask, span=span, tight=True, w0=w0,
        w_cap=w_cap)
    cmin_sorted = gcmin[rows_sorted]
    # direct rows' exact counts come free from the analysis pass (their C
    # row is a copy of one B row), like the reference's direct method
    # (spECK_HashSpGEMM.cuh:572-589). The O(nnz) A-slot records are built
    # lazily by the caller (build_srec) only when stream rows exist.
    nnz_init = jnp.where(direct_mask, row_ops, 0)
    gate = _gate_scalars(a_indptr, a_indices, b_indptr, b_indices,
                         row_ops, row_ops_f, a_len, m=m)
    # live A-slot counts of the stream / accumulator regions: lets the
    # host size build_srec's record arrays to the LIVE slots instead of
    # all of nnz(A) (the giant-row bench routes ~85k of 50M slots)
    n_live = jnp.sum(jnp.where(stream_mask, a_len, 0))
    n_live2 = jnp.sum(jnp.where(accum_mask, a_len, 0))
    pack = jnp.concatenate([
        hist,
        jnp.stack([n_elig, kw_eff, cw_eff, la_eff, lb_eff]).astype(jnp.int32),
        gate,
        dia_pack,
        jnp.stack([n_live, n_live2]).astype(jnp.int32),
        tight_pack,
    ])
    return (rows_sorted, e, q_sorted, el, ops_sorted, e2, q2_sorted,
            cmin_sorted, nnz_init, r0, kb_s, cb_s, valid, dia_mask, pack)


def _gate_scalars(a_indptr, a_indices, b_indptr, b_indices, row_ops,
                  row_ops_f, a_len, *, m: int):
    """The 7 routing/guard scalars as one int32 array:
    [a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat, sp_exact].

    DIA band stats: min/max of (col - row) from each canonical row's
    first/last column id — O(m) gathers, no per-nnz work. Totals from
    the f32 twin are immune to the int32 per-row wrap (mxrow_sat detects
    rows whose int32 row_ops would be garbage); sp_exact is the exact
    int32 product total (valid whenever the plan proceeds at all — the
    no-duplicate fast path tests nnz(C) == sp_exact)."""
    rowi = jnp.arange(m, dtype=jnp.int32)
    ne_a = a_len > 0
    if a_indices.shape[0] > 0 and m > 0:
        a_first = a_indices[a_indptr[:-1]] - rowi
        a_last = a_indices[jnp.maximum(a_indptr[1:] - 1, 0)] - rowi
        a_dmin = jnp.min(jnp.where(ne_a, a_first, INT_MAX))
        a_dmax = jnp.max(jnp.where(ne_a, a_last, -INT_MAX))
    else:
        a_dmin, a_dmax = jnp.int32(INT_MAX), jnp.int32(-INT_MAX)
    kd = b_indptr.shape[0] - 1
    if b_indices.shape[0] > 0 and kd > 0:
        rowk = jnp.arange(kd, dtype=jnp.int32)
        b_lenr = b_indptr[1:] - b_indptr[:-1]
        ne_b = b_lenr > 0
        b_first = b_indices[b_indptr[:-1]] - rowk
        b_last = b_indices[jnp.maximum(b_indptr[1:] - 1, 0)] - rowk
        b_dmin = jnp.min(jnp.where(ne_b, b_first, INT_MAX))
        b_dmax = jnp.max(jnp.where(ne_b, b_last, -INT_MAX))
    else:
        b_dmin, b_dmax = jnp.int32(INT_MAX), jnp.int32(-INT_MAX)
    sp_sat = jnp.int32(jnp.clip(
        jnp.sum(jnp.maximum(row_ops_f, 0.0)), 0.0, 2.0 ** 31 - 2))
    mxrow_sat = jnp.int32(jnp.clip(
        jnp.max(jnp.maximum(row_ops_f, 0.0), initial=0.0),
        0.0, 2.0 ** 31 - 2))
    sp_exact = jnp.sum(jnp.maximum(row_ops, 0))
    return jnp.stack([a_dmin, a_dmax, b_dmin, b_dmax, sp_sat,
                      mxrow_sat, sp_exact]).astype(jnp.int32)


@partial(jax.jit, static_argnames=("m",))
def plan_gate(a_indptr, a_indices, b_indptr, b_indices, row_ops,
              row_ops_f, *, m: int):
    """Early routing gate: ONLY the 7 gate scalars, dispatched and read
    back BEFORE the O(m log m) stream/dense planning. When the DIA fast
    path (ops/dia.py) wins, the expensive speculative planning is never
    dispatched at all; when it loses, the overflow guards still ran
    before the heavy pass, so row-blocked calls skip a full wasted plan.
    Cost when the gate loses: one extra small readback."""
    a_len = a_indptr[1:] - a_indptr[:-1]
    return _gate_scalars(a_indptr, a_indices, b_indptr, b_indices,
                         row_ops, row_ops_f, a_len, m=m)


# ---------------------------------------------------------------------------
# Chunk kernel
# ---------------------------------------------------------------------------


def _ffill_rows(vals, filled):
    """Segmented forward fill over the flat row-major order of (G, W)
    channel planes: every unfilled slot takes the value of the nearest
    filled slot at or before it (across rectangle-row boundaries).
    Hillis-Steele doubling within rows + a log2(G) carry fill across the
    per-row last columns -- all elementwise/vector work, no gathers.
    Returns (filled_vals_tuple, filled_mask)."""
    G, W = filled.shape
    d = 1
    while d < W:
        f_s = jnp.concatenate(
            [jnp.zeros((G, d), bool), filled[:, :-d]], axis=1)
        take = ~filled & f_s
        vals = tuple(
            jnp.where(take, jnp.concatenate(
                [jnp.zeros((G, d), v.dtype), v[:, :-d]], axis=1), v)
            for v in vals)
        filled = filled | f_s
        d <<= 1
    # carry across rows: exclusive shift of each row's last column, then
    # the same doubling fill over the G-sized carry vectors
    cf = jnp.concatenate([jnp.zeros((1,), bool), filled[:-1, -1]])
    cv = [jnp.concatenate([jnp.zeros((1,), v.dtype), v[:-1, -1]])
          for v in vals]
    d = 1
    while d < G:
        f_s = jnp.concatenate([jnp.zeros((d,), bool), cf[:-d]])
        take = ~cf & f_s
        cv = [jnp.where(take,
                        jnp.concatenate([jnp.zeros((d,), x.dtype), x[:-d]]),
                        x) for x in cv]
        cf = cf | f_s
        d <<= 1
    out = tuple(jnp.where(filled, v, c[:, None])
                for v, c in zip(vals, cv))
    return out, filled | cf[:, None]


def ffill1d(val, filled, block: int = 4096):
    """Segmented forward fill over a flat 1-D array (the 1-D twin of
    _ffill_rows, blocked like analysis.cumsum1d): every unfilled slot
    takes the nearest filled value at or before it. Replaces per-element
    gathers of row-constant tables with one scatter + log passes of
    vector work."""
    n = val.shape[0]
    nb = max(-(-n // block), 1)
    padn = nb * block - n
    if padn:
        val = jnp.concatenate([val, jnp.zeros((padn,), val.dtype)])
        filled = jnp.concatenate([filled, jnp.zeros((padn,), bool)])
    (v,), _ = _ffill_rows((val.reshape(nb, block),),
                          filled.reshape(nb, block))
    return v.reshape(-1)[:n]


def _expand_chunk(e, rowend, p0, su, sa, pend, b_packed, b_indices,
                  b_data, a_data, a_srcmap, chunk_start, rid_base,
                  sid_base, G: int, W: int, n_cols: int, f64: bool,
                  expand_impl: str = "fill"):
    """The shared expand stage: decode (rid, sid) for every slot of chunk
    [chunk_start, chunk_start + G*W) of a product space described by
    (e, p0, su, sa), gather the B records, and form the products.
    Returns (rid, col, val, dead).

    rowend (m,): per-sorted-row live product end (e + ops) in this
    product space -- the "decode" impl kills slots at t >= rowend[rid].
    pend (nnz,): per-A-slot product end (p0 + b_len) -- the "fill" impl
    forward-fills it alongside the A-record so deadness is a plain
    compare, with NO per-slot gather (the rowend[rid] m-table gather was
    half the expand stage before the H100 port; not yet measured on the
    H100).

    expand_impl="fill" (default): the per-slot A-record (u, valA, pend)
    is FORWARD-FILLED from boundary scatters at the A-slot starts (p0)
    instead of decoded+gathered per slot -- kills the sid run-length
    decode, the O(G*W) random record gather, and the rowend dead-check
    gather; what remains random is the ONE irreducible b_packed record
    gather per live product. "decode" keeps the older per-slot
    decode+gather form.

    The fill scatters source from a dynamic-slice WINDOW of the record
    arrays around sid_base: build_srec compacts zero-product slots, so
    kept p0 is strictly increasing and at most CP + 2 records can
    intersect one chunk. Scattering all nnz records per chunk made
    per-chunk cost O(nnz + CP) -- a 13x blow-up on the 50M-nnz
    giant-row bench where nnz ~ products."""
    t = chunk_start + jax.lax.broadcasted_iota(
        jnp.int32, (G, W), 0) * W + jax.lax.broadcasted_iota(
        jnp.int32, (G, W), 1)
    rid = _decode(e, rid_base, chunk_start, G, W)
    nnzA = su.shape[0]
    m = rowend.shape[0]
    CP = G * W
    if expand_impl == "fill":
        # channel 2: valA bits (f32) or the A-source index (f64)
        ch2 = a_srcmap if f64 else sa
        K = min(nnzA, CP + 2)
        if K < nnzA:
            base = jnp.clip(sid_base - 1, 0, nnzA - K)
            p0w = jax.lax.dynamic_slice(p0, (base,), (K,))
            uw = jax.lax.dynamic_slice(su, (base,), (K,))
            aw = jax.lax.dynamic_slice(ch2, (base,), (K,))
            pw = jax.lax.dynamic_slice(pend, (base,), (K,))
        else:
            p0w, uw, aw, pw = p0, su, ch2, pend
        rel = p0w - chunk_start
        # kept slots have strictly increasing p0 (build_srec compaction);
        # the guard survives for the K == nnzA degenerate path where the
        # INT_MAX tail sentinels share a value
        winner = jnp.concatenate([p0w[:-1] != p0w[1:],
                                  jnp.ones((1,), bool)])
        tgt = jnp.where(winner & (rel >= 0) & (rel < CP), rel, CP)
        # carry-in: the run straddling the chunk start is the last slot
        # with p0 < chunk_start (= sid_base - 1); boundary scatters land
        # after and override a boundary exactly at position 0
        pidx = jnp.clip(sid_base - 1, 0, nnzA - 1)
        cidx = jnp.where(sid_base > 0, 0, CP)
        u2 = (jnp.zeros((CP,), jnp.int32)
              .at[cidx].set(su[pidx], mode="drop")
              .at[tgt].set(uw, mode="drop"))
        a2 = (jnp.zeros((CP,), jnp.int32)
              .at[cidx].set(ch2[pidx], mode="drop")
              .at[tgt].set(aw, mode="drop"))
        f2 = (jnp.zeros((CP,), bool)
              .at[cidx].set(True, mode="drop")
              .at[tgt].set(True, mode="drop"))
        (u, ach), filled = _ffill_rows(
            (u2.reshape(G, W), a2.reshape(G, W)), f2.reshape(G, W))
        # live state: +1 at each run start (p0), -1 at its end (pend);
        # runs never overlap (pend[i] <= p0[i+1]), so the running sum is
        # 0/1 — this replaces forward-filling a third (pend) channel and
        # the per-slot compare against it. The carry run contributes +1
        # at slot 0 only while still live (its -1 lands in-window when
        # its pend does).
        rel_end = pw - chunk_start
        end_tgt = jnp.where(winner & (rel_end > 0) & (rel_end < CP)
                            & (rel < CP), rel_end, CP)
        cidx_l = jnp.where((sid_base > 0) & (pend[pidx] > chunk_start),
                           0, CP)
        marks = (jnp.zeros((CP,), jnp.int32)
                 .at[cidx_l].add(1, mode="drop")
                 .at[tgt].add(1, mode="drop")
                 .at[end_tgt].add(-1, mode="drop"))
        live = _cumsum_rect(marks.reshape(G, W)) > 0
        dead = ~live | (rid < 0)
        bsrc = jnp.where(dead, 0, u + t)
        if f64:
            aval = a_data[jnp.clip(ach, 0, a_data.shape[0] - 1)]
        else:
            aval = jax.lax.bitcast_convert_type(ach, jnp.float32)
    else:
        sid = _decode(p0, sid_base, chunk_start, G, W)
        sid_c = jnp.clip(sid, 0, nnzA - 1)
        u = su[sid_c]
        dead = (t >= rowend[jnp.clip(rid, 0, m - 1)]) | (sid < 0) | (rid < 0)
        bsrc = jnp.where(dead, 0, u + t)
        if f64:
            aval = a_data[a_srcmap[sid_c]]
        else:
            aval = jax.lax.bitcast_convert_type(sa[sid_c], jnp.float32)
    if f64:
        col = jnp.where(dead, jnp.int32(n_cols), b_indices[bsrc])
        val = jnp.where(dead, 0.0, aval * b_data[bsrc])
    else:
        bp = b_packed[bsrc]
        col = jnp.where(dead, jnp.int32(n_cols), bp[..., 0])
        bval = jax.lax.bitcast_convert_type(bp[..., 1], jnp.float32)
        val = jnp.where(dead, 0.0, aval * bval)
    return rid, col, val, dead


def _decode(boundary_pos, base, chunk_start, G: int, W: int):
    """Run-length id decode for one chunk: id[t] = base + #(pos <= t) - 1
    over t in [chunk_start, chunk_start + G*W)."""
    CP = G * W
    rel = boundary_pos - chunk_start
    # negative scatter indices WRAP in XLA (python-style); push them out of
    # bounds so mode="drop" actually drops them
    rel = jnp.where(rel < 0, CP, rel)
    marks = jnp.zeros((CP,), jnp.int32).at[rel].add(1, mode="drop")
    return base + _cumsum_rect(marks.reshape(G, W)) - 1


def _sort_cols(col, val):
    """Single-key (col, val) row sort. lax.sort at every width: on the
    H100 it matched or beat the blocked bitonic merge at the giant-row
    finish's 2^23 width (PERF.md, bring-up findings)."""
    return jax.lax.sort((col, val), dimension=1, num_keys=1)


def _sort_rect(rid, col, val, n_cols: int, pack_bits: int):
    """Sort each rectangle row by (rid, col) with ALL dead slots
    (col >= n_cols) last -- live entries pack to the rectangle-row front
    in row order (the invariant the O(m) counting and the gather emit
    depend on). pack_bits > 0: single-key sort on
    rid_local << pack_bits | col."""
    if pack_bits > 0:
        rid0 = rid[:, :1]
        keyk = ((rid - rid0) << pack_bits) | col
        keyk = jnp.where(col >= n_cols, INT_MAX, keyk)
        keyk, val_s = jax.lax.sort((keyk, val), dimension=1, num_keys=1)
        col_s = jnp.where(keyk == INT_MAX, jnp.int32(n_cols),
                          keyk & ((1 << pack_bits) - 1))
        rid_s = jnp.where(keyk == INT_MAX, rid0 + 0 * keyk,
                          rid0 + (keyk >> pack_bits))
        return rid_s, col_s, val_s
    rid = jnp.where(col >= n_cols, INT_MAX, rid)
    return jax.lax.sort((rid, col, val), dimension=1, num_keys=2)


def _contract_rect(rid_s, col_s, val_s, n_cols: int):
    """Run boundaries + segmented run sums of (rid, col)-sorted rows.
    Returns (last, run_sum): last marks the final slot of each live run.
    The Hillis-Steele doubling is a chain of elementwise shift/select
    steps that XLA fuses (see PERF.md for its share of chunk time)."""
    G, W = col_s.shape
    changed = jnp.concatenate(
        [jnp.ones((G, 1), bool),
         (col_s[:, 1:] != col_s[:, :-1]) | (rid_s[:, 1:] != rid_s[:, :-1])],
        axis=1)
    nxt_change = jnp.concatenate([changed[:, 1:], jnp.ones((G, 1), bool)],
                                 axis=1)
    last = nxt_change & (col_s < n_cols)
    v, f = val_s, changed
    d = 1
    while d < W:
        v_s = jnp.concatenate([jnp.zeros_like(v[:, :d]), v[:, :-d]], axis=1)
        f_s = jnp.concatenate([jnp.ones_like(f[:, :d]), f[:, :-d]], axis=1)
        v = jnp.where(f, v, v + v_s)
        f = f | f_s
        d <<= 1
    return last, v


def _compact_rect(last, rid_s, col_s, run_sum, compact_impl: str = "sort"):
    """Move run-last entries to the rectangle-row front (order kept).
    Returns (rid_c, col_c, val_c, counts).

    compact_impl="sort": one rank sort (key = rank among run-lasts, dead
    slots pushed past W). compact_impl="scatter": three flat scatters to
    g*W + rank — the write targets are the dense per-row prefixes, in
    order, the sequential-write pattern kindest to a scatter; dead
    slots become
    (INT_MAX, INT_MAX, 0) fills, satisfying every consumer's col >=
    n_cols dead test. Both forms are element-identical on the live
    prefix of each rectangle row."""
    G, W = col_s.shape
    rank = jnp.cumsum(last.astype(jnp.int32), axis=1) - 1
    counts = jnp.sum(last, axis=1, dtype=jnp.int32)
    if compact_impl == "scatter":
        g = jax.lax.broadcasted_iota(jnp.int32, (G, W), 0)
        flat = jnp.where(last, g * W + rank, G * W).reshape(-1)

        def sc(x, fill):
            return jnp.full((G * W,), fill, x.dtype).at[flat].set(
                x.reshape(-1), mode="drop",
                unique_indices=True).reshape(G, W)

        return (sc(rid_s, jnp.int32(INT_MAX)),
                sc(col_s, jnp.int32(INT_MAX)),
                sc(run_sum, jnp.zeros((), run_sum.dtype)), counts)
    t = jax.lax.broadcasted_iota(jnp.int32, (G, W), 1)
    key = jnp.where(last, rank, W + t)
    _, rid_c, col_c, val_c = jax.lax.sort(
        (key, rid_s, col_s, run_sum), dimension=1, num_keys=1)
    return rid_c, col_c, val_c, counts


@partial(jax.jit, static_argnames=("n_cols", "compact_impl"),
         donate_argnames=("rid_s", "col_s", "val_s"))
def compact_staged(rid_s, col_s, val_s, counts, *, n_cols: int,
                   compact_impl: str = "sort"):
    """Compact a RAW staged chunk (sorted planes from
    stream_chunk(stage_raw=True)) after the fact: run-last flags are
    recomputed from neighbor changes and the partial run sums at those
    positions are already the full sums. Runs only when the no-duplicate
    fast path's nnz(C) == products test failed."""
    G, W = col_s.shape
    changed = jnp.concatenate(
        [jnp.ones((G, 1), bool),
         (col_s[:, 1:] != col_s[:, :-1]) | (rid_s[:, 1:] != rid_s[:, :-1])],
        axis=1)
    nxt_change = jnp.concatenate([changed[:, 1:], jnp.ones((G, 1), bool)],
                                 axis=1)
    last = nxt_change & (col_s < n_cols)
    return _compact_rect(last, rid_s, col_s, val_s,
                         compact_impl=compact_impl)


@partial(
    jax.jit,
    static_argnames=("G", "W", "n_cols", "pack_bits", "stage", "f64",
                     "compact_impl", "stage_raw", "expand_impl"),
    donate_argnames=("nnz_row",),
)
def stream_chunk(rows_sorted, e, rowend, q_sorted, el, ops_sorted, p0,
                 su, sa, pend, b_packed, b_indices, b_data, a_data,
                 a_srcmap, nnz_row, chunk_start, rid_base, sid_base, *,
                 G: int,
                 W: int, n_cols: int, pack_bits: int, stage: bool,
                 f64: bool, compact_impl: str = "sort",
                 stage_raw: bool = False, expand_impl: str = "fill"):
    """One fused count(+stage) pass over stream chunk
    [chunk_start, chunk_start + G*W).

    Counting: every row CONTAINED in this chunk (q <= W) gets its exact
    nnz via an O(m) row-segment difference over the per-rectangle-row
    cumulative run-last counts -- after the sort, a row's live entries
    occupy [el[j]-rect_base, +ops) of its rectangle row, so its distinct
    count is cl[seg_end] - cl[seg_start-1]. This replaces a per-slot
    scatter-add (G*W indices) with a few m-sized gathers. Wide rows
    (q > W) are counted by the level ladder.
    stage=True additionally returns the compacted (rid, col, val, counts)
    staged rectangle rows for emission / the levels.
    """
    with jax.named_scope("stream_expand"):
        rid, col, val, _ = _expand_chunk(
            e, rowend, p0, su, sa, pend, b_packed, b_indices, b_data,
            a_data, a_srcmap, chunk_start, rid_base, sid_base, G, W,
            n_cols, f64, expand_impl=expand_impl)
    with jax.named_scope("stream_sort"):
        rid_s, col_s, val_s = _sort_rect(rid, col, val, n_cols, pack_bits)
    with jax.named_scope("stream_contract"):
        last, run_sum = _contract_rect(rid_s, col_s, val_s, n_cols)

    # O(m) counting for rows contained in this chunk
    m = nnz_row.shape[0]
    CP = G * W
    cl = _cumsum_w(last.astype(jnp.int32)).reshape(-1)   # per-rect cumsum
    contained = ((q_sorted > 0) & (q_sorted <= W)
                 & (e >= chunk_start) & (e < chunk_start + CP))
    g = jnp.clip((e - chunk_start) // W, 0, G - 1)
    # first sorted row of each of this chunk's rectangle rows
    g_first = jnp.searchsorted(
        e, chunk_start + jnp.arange(G, dtype=jnp.int32) * W).astype(
        jnp.int32)
    lrel = el - el[jnp.clip(g_first[g], 0, m - 1)]
    seg_end = g * W + lrel + ops_sorted - 1
    seg_before = g * W + lrel - 1
    cnt = (cl[jnp.clip(seg_end, 0, CP - 1)]
           - jnp.where(lrel > 0, cl[jnp.clip(seg_before, 0, CP - 1)], 0))
    cnt = jnp.where(contained & (ops_sorted > 0), cnt, 0)
    target = jnp.where(contained, rows_sorted, m)
    nnz_row = nnz_row.at[target].set(cnt, mode="drop", unique_indices=True)

    if not stage:
        return nnz_row, None
    if stage_raw:
        # defer compaction: stage the sorted-but-uncompacted planes. When
        # the whole plan turns out duplicate-free (nnz(C) == products,
        # checked against the exact product total after the offsets
        # readback), every live slot IS a run-last and the raw planes are
        # element-identical to the compacted ones — the compact pass was
        # pure waste. Otherwise compact_staged() runs once per raw chunk.
        counts = jnp.sum(last, axis=1, dtype=jnp.int32)
        return nnz_row, (rid_s, col_s, run_sum, counts)
    with jax.named_scope("stream_compact"):
        rid_c, col_c, val_c, counts = _compact_rect(
            last, rid_s, col_s, run_sum, compact_impl=compact_impl)
    return nnz_row, (rid_c, col_c, val_c, counts)


@partial(
    jax.jit,
    static_argnames=("G", "W", "n_cols", "pack_bits", "stage_wide", "f64",
                     "compact_impl", "expand_impl"),
    donate_argnames=("c_cols", "c_vals"),
)
def stream_chunk_numeric(rows_sorted, e, rowend, p0, su, sa, pend,
                         b_packed, b_indices, b_data, a_data, a_srcmap,
                         row_offsets, c_cols, c_vals, chunk_start,
                         rid_base, sid_base,
                         n_wide, *, G: int, W: int, n_cols: int,
                         pack_bits: int, stage_wide: bool, f64: bool,
                         compact_impl: str = "sort",
                         expand_impl: str = "fill"):
    """Two-phase numeric pass over one chunk: same expand/sort/contract as
    stream_chunk, but contained rows' run-last entries scatter STRAIGHT to
    their exact offsets (no staging) — the analogue of the reference's
    numeric kernels writing to pre-allocated C (spECK_HashSpGEMM.cuh:
    591-738). stage_wide additionally returns the compacted rectangle rows
    (chunks that hold wide-row segments feed the merge levels).
    """
    with jax.named_scope("stream_expand"):
        rid, col, val, _ = _expand_chunk(
            e, rowend, p0, su, sa, pend, b_packed, b_indices, b_data,
            a_data, a_srcmap, chunk_start, rid_base, sid_base, G, W,
            n_cols, f64, expand_impl=expand_impl)
    with jax.named_scope("stream_sort"):
        rid_s, col_s, val_s = _sort_rect(rid, col, val, n_cols, pack_bits)
    with jax.named_scope("stream_contract"):
        last, run_sum = _contract_rect(rid_s, col_s, val_s, n_cols)

    # rank among the row's run-lasts via segmented exclusive count
    cl = jnp.cumsum(last.astype(jnp.int32), axis=1)
    ce = cl - last.astype(jnp.int32)
    tl = jax.lax.broadcasted_iota(jnp.int32, (G, W), 1)
    is_first = jnp.concatenate(
        [jnp.ones((G, 1), bool), rid_s[:, 1:] != rid_s[:, :-1]], axis=1)
    firstpos = jnp.where(is_first, tl, 0)
    filled = is_first
    d = 1
    while d < W:
        shifted = jnp.concatenate(
            [jnp.zeros((G, d), jnp.int32), firstpos[:, :-d]], axis=1)
        f_s = jnp.concatenate(
            [jnp.zeros((G, d), bool), filled[:, :-d]], axis=1)
        take = ~filled & f_s
        firstpos = jnp.where(take, shifted, firstpos)
        filled = filled | f_s
        d <<= 1
    rank = ce - jnp.take_along_axis(ce, firstpos, axis=1)

    m = rows_sorted.shape[0]
    row = rows_sorted[jnp.clip(rid_s, 0, m - 1)]
    live = last & (rid_s >= n_wide)
    oob = c_cols.shape[0]
    flat = jnp.where(live, row_offsets[row] + rank, oob)
    c_cols = c_cols.at[flat].set(col_s, mode="drop", unique_indices=True)
    c_vals = c_vals.at[flat].set(run_sum, mode="drop", unique_indices=True)
    if not stage_wide:
        return c_cols, c_vals, None
    with jax.named_scope("stream_compact"):
        rid_c, col_c, val_c, counts = _compact_rect(
            last, rid_s, col_s, run_sum, compact_impl=compact_impl)
    return c_cols, c_vals, (rid_c, col_c, val_c, counts)


# ---------------------------------------------------------------------------
# Dense-span accumulator for huge rows with bounded column ranges
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("G", "W", "n_cols", "f64", "expand_impl"),
    donate_argnames=("acc", "pres"),
)
def stream_chunk_accum(e2, rowend2, p02, su2, sa2, pend2, b_packed,
                       b_indices,
                       b_data, a_data, a_srcmap, abase, cmin_s, acc, pres,
                       chunk_start, rid_base, sid_base, row_lo, row_hi, *,
                       G: int, W: int, n_cols: int, f64: bool,
                       expand_impl: str = "fill"):
    """One expand + scatter-add pass over accumulator-stream chunk
    [chunk_start, chunk_start + G*W): products of rows in the active part
    [row_lo, row_hi) land at acc[abase[rid] + col - cmin[rid]] (abase is
    PART-local; other rows' products are dropped this pass).

    The analogue of the reference's dense mode for SINGLE huge rows
    (spGEMMNumericLauncher routes 'single row & dense enough' blocks to
    the dense-window accumulator, spECK_HashSpGEMM.cuh:1761-1793,
    1175-1298): no sorting, no hashing — a row whose products dedup into
    a bounded column span pays one scatter-add per product instead of
    sort+contract over every slot.
    """
    rid, col, val, dead = _expand_chunk(
        e2, rowend2, p02, su2, sa2, pend2, b_packed, b_indices, b_data,
        a_data,
        a_srcmap, chunk_start, rid_base, sid_base, G, W, n_cols, f64,
        expand_impl=expand_impl)
    na = abase.shape[0]
    rid_c = jnp.clip(rid, 0, na - 1)
    live = (~dead) & (rid >= row_lo) & (rid < row_hi)
    tgt = abase[rid_c] + (col - cmin_s[rid_c])
    tgt = jnp.where(live, tgt, acc.shape[0])
    acc = acc.at[tgt].add(val, mode="drop")
    pres = pres.at[tgt].max(1, mode="drop")
    return acc, pres


@partial(
    jax.jit,
    static_argnames=("R_c", "S_c", "count"),
    donate_argnames=("nnz_row",),
)
def accum_finalize(rows_sorted, acc_slice, pres_slice, cmin_s, rid_of_out,
                   nnz_row, *, R_c: int, S_c: int, count: bool):
    """Turn one span class's accumulators into staged compacted rows:
    presence gives exact counts, columns are cmin + index (ascending by
    construction — sorted for free, like the reference's dense mode
    ':1260-1296'). Returns (nnz_row, (rid, col_c, val_c, counts)) in the
    staged-buffer format stream_emit consumes."""
    acc = acc_slice.reshape(R_c, S_c)
    pres = pres_slice.reshape(R_c, S_c)
    idx = jax.lax.broadcasted_iota(jnp.int32, (R_c, S_c), 1)
    m = rows_sorted.shape[0]
    rid_b = jnp.broadcast_to(rid_of_out[:, None], (R_c, S_c))
    last = (pres > 0) & (rid_b >= 0)
    cols = jnp.where(last, cmin_s[jnp.clip(rid_b, 0, m - 1)] + idx, 0)
    counts = jnp.sum(last, axis=1, dtype=jnp.int32)
    if count:
        tgt = jnp.where(rid_of_out >= 0,
                        rows_sorted[jnp.clip(rid_of_out, 0, m - 1)], m)
        nnz_row = nnz_row.at[tgt].set(counts, mode="drop",
                                      unique_indices=True)
    _, col_c, val_c, counts = _compact_rect(last, rid_b, cols, acc)
    return nnz_row, (rid_of_out, col_c, val_c, counts)


# ---------------------------------------------------------------------------
# Merge levels for wide rows
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("F", "W_in", "n_cols", "count", "compact_impl"),
    donate_argnames=("nnz_row",),
)
def stream_level(rows_sorted, rid_in, col_in, val_in, counts_in, in_map,
                 final_mask, nnz_row, *, F: int, W_in: int, n_cols: int,
                 count: bool = True, compact_impl: str = "sort"):
    """One merge level: each output rectangle row re-sorts F input segments
    (width W_in each, compacted prefixes of counts_in) of ONE wide row and
    contracts them. Rows whose segments all fit here (final_mask) get
    counted; every output is compacted for the next level / emission.

    in_map (R_out, F): input rectangle-row indices (-1 = none).
    """
    R_out = in_map.shape[0]
    W_out = F * W_in
    srcrow = in_map.reshape(-1)                       # (R_out*F,)
    okrow = srcrow >= 0
    src = jnp.clip(srcrow, 0, max(rid_in.shape[0] - 1, 0))
    j = jax.lax.broadcasted_iota(jnp.int32, (R_out * F, W_in), 1)
    livein = okrow[:, None] & (j < counts_in[src][:, None])
    col = jnp.where(livein, col_in[src], jnp.int32(n_cols)).reshape(
        R_out, W_out)
    val = jnp.where(livein, val_in[src], 0.0).reshape(R_out, W_out)
    rid_out = jnp.max(jnp.where(okrow, rid_in[src], -1).reshape(R_out, F),
                      axis=1)

    col_s, val_s = _sort_cols(col, val)
    rid_b = jnp.broadcast_to(rid_out[:, None], (R_out, W_out))
    last, run_sum = _contract_rect(rid_b, col_s, val_s, n_cols)

    if count:
        m = nnz_row.shape[0]
        cnt_target = jnp.where(
            last & final_mask[:, None] & (rid_b >= 0),
            rows_sorted[jnp.clip(rid_b, 0, m - 1)], m)
        nnz_row = nnz_row.at[cnt_target].add(1, mode="drop")

    _, col_c, val_c, counts = _compact_rect(last, rid_b, col_s, run_sum,
                                            compact_impl=compact_impl)
    return nnz_row, (rid_out, col_c, val_c, counts)


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("wide_only", "contained_only"),
    donate_argnames=("c_cols", "c_vals"),
)
def stream_emit(rows_sorted, rid_c, col_c, val_c, counts, n_wide,
                row_offsets, c_cols, c_vals, *,
                wide_only: bool = False, contained_only: bool = False):
    """Scatter one staged buffer's compacted entries into the final CSR
    arrays. Entries of row r go to row_offsets[r] + rank, where rank is
    the entry's index within the row (entries of a row are contiguous and
    ordered within one rectangle row by construction: contained rows fit a
    level-0 rectangle row; wide rows emit only from their single final
    merge row).

    contained_only: skip wide rows (level-0 buffers); wide_only: only
    final wide rows (level buffers, final_mask pre-applied via counts=0).
    """
    R, W = col_c.shape
    t = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
    live = t < counts[:, None]
    if wide_only:
        live = live & (rid_c >= 0)
    if contained_only:
        live = live & (rid_c >= n_wide)
    # rank within row: entries are grouped by rid at the rect-row front in
    # order, so rank = t - first position of this rid in the rect row
    is_first = jnp.concatenate(
        [jnp.ones((R, 1), bool), rid_c[:, 1:] != rid_c[:, :-1]], axis=1)
    firstpos = jnp.where(is_first, t, 0)
    d = 1
    while d < W:
        shifted = jnp.concatenate(
            [jnp.zeros((R, d), jnp.int32), firstpos[:, :-d]], axis=1)
        f_s = jnp.concatenate(
            [jnp.zeros((R, d), bool), is_first[:, :-d]], axis=1)
        take = ~is_first & f_s
        firstpos = jnp.where(take, shifted, firstpos)
        is_first = is_first | f_s
        d <<= 1
    rank = t - firstpos
    m = rows_sorted.shape[0]
    row = rows_sorted[jnp.clip(rid_c, 0, m - 1)]
    oob = c_cols.shape[0]
    flat = jnp.where(live, row_offsets[row] + rank, oob)
    c_cols = c_cols.at[flat].set(col_c, mode="drop", unique_indices=True)
    c_vals = c_vals.at[flat].set(val_c, mode="drop", unique_indices=True)
    return c_cols, c_vals


@partial(jax.jit, static_argnames=("n_wide",))
def wide_entry_totals(wcnt, wide_rid, *, n_wide: int):
    """Per-wide-row total staged entries after level 0 (sum of its
    rectangle rows' compacted counts) — the small readback that lets the
    host lay the finish pass out tightly."""
    return jax.ops.segment_sum(wcnt, wide_rid, num_segments=n_wide)


@partial(
    jax.jit,
    static_argnames=("R2", "W2", "W0", "E_pad", "n_cols", "count",
                     "compact_impl"),
    donate_argnames=("nnz_row",),
)
def stream_wide_finish(rows_sorted, wcol_flat, wval_flat, wcnt,
                       entry_excl, row_total, rid_of_out, nnz_row, *,
                       R2: int, W2: int, W0: int, E_pad: int, n_cols: int,
                       count: bool, compact_impl: str = "sort"):
    """Adaptive wide-row finish: gather each wide row's level-0 staged
    entries (compacted, deduplicated per rectangle row) into ONE (R2, W2)
    rectangle sized by the TRUE entry totals, then a single sort+contract
    completes the row. Replaces the geometric merge-level ladder whose
    per-level width growth made giant rows pay ~n_levels full passes at
    degrading sort throughput (the ladder remains the fallback for rows
    whose entries exceed stream_max_width).

    wcol_flat/wval_flat: flattened (r_wide * W0) staged wide buffers;
    wcnt (r_wide,): per-rectangle-row live counts; entry_excl (R2,):
    host-computed exclusive entry prefix per output row; row_total (R2,):
    true entries per row; rid_of_out (R2,): sorted row index of each
    output row.
    """
    from .analysis import cumsum1d

    r_wide = wcnt.shape[0]
    # entry id -> (source rectangle row, position) via run-length decode
    ccum = cumsum1d(wcnt)
    ccum_excl = ccum - wcnt
    marks = jnp.zeros((E_pad,), jnp.int32).at[ccum_excl].add(
        1, mode="drop")
    blk = marks.reshape(max(E_pad // 4096, 1), -1)
    rr_tab = _cumsum_rect(blk).reshape(-1) - 1
    rr_tab = jnp.clip(rr_tab, 0, r_wide - 1)

    j = jax.lax.broadcasted_iota(jnp.int32, (R2, W2), 1)
    e_id = entry_excl[:, None] + j
    dead = (j >= row_total[:, None]) | (e_id >= E_pad)
    e_c = jnp.clip(e_id, 0, E_pad - 1)
    rr = rr_tab[e_c]
    src = rr * W0 + (e_c - ccum_excl[rr])
    src = jnp.clip(src, 0, wcol_flat.shape[0] - 1)
    col = jnp.where(dead, jnp.int32(n_cols), wcol_flat[src])
    val = jnp.where(dead, 0.0, wval_flat[src])

    col_s, val_s = _sort_cols(col, val)
    rid_b = jnp.broadcast_to(rid_of_out[:, None], (R2, W2))
    last, run_sum = _contract_rect(rid_b, col_s, val_s, n_cols)
    counts = jnp.sum(last, axis=1, dtype=jnp.int32)
    if count:
        m = nnz_row.shape[0]
        tgt = jnp.where(rid_of_out >= 0,
                        rows_sorted[jnp.clip(rid_of_out, 0, m - 1)], m)
        nnz_row = nnz_row.at[tgt].set(counts, mode="drop",
                                      unique_indices=True)
    _, col_c, val_c, counts = _compact_rect(last, rid_b, col_s, run_sum,
                                            compact_impl=compact_impl)
    return nnz_row, (rid_of_out, col_c, val_c, counts)


@partial(jax.jit, static_argnames=("W", "nnz"))
def stream_gather_emit(rows_sorted, e, row_offsets, cols_flat,
                       vals_flat, *, W: int, nnz: int):
    """Build the contained-row portion of C by GATHERING from the
    concatenated staged chunk buffers instead of scattering every staged
    slot. Scatter cost is proportional to G*W slots (~3% live on sparse
    outputs); gather cost is proportional to nnz(C) -- ~30x less traffic
    on the banded benchmark.

    Per output index i, only ONE random read: the packed staged record.
    The per-row source base (a row's staged entries are the compacted
    prefix of ONE rectangle row, since contained rows never straddle) is
    constant over the row's output segment, so instead of gathering an
    m-table per output it is
    SCATTERED at each live row's output start and forward-filled
    (ffill1d — one m-scatter + log passes of vector work).
    Rows not in the stream (direct/dense/wide) fill garbage here and
    are overwritten by their own emit passes.
    """
    from .analysis import cumsum1d

    m = rows_sorted.shape[0]
    total = max(nnz, 1)
    R_total = cols_flat.shape[0] // W
    nnz_row = row_offsets[1:] - row_offsets[:-1]
    scnt = nnz_row[rows_sorted]
    scum = cumsum1d(scnt) - scnt                  # exclusive, sorted order
    # first sorted row of each global rectangle row
    gg_first = jnp.searchsorted(
        e, jnp.arange(max(R_total, 1), dtype=jnp.int32) * W).astype(
        jnp.int32)
    rect_base = scum[jnp.clip(gg_first, 0, m - 1)]
    gg_s = jnp.clip(e // W, 0, max(R_total - 1, 0))
    base_sorted = (gg_s * W + scum - rect_base[gg_s]
                   - row_offsets[rows_sorted])

    # seed each live row's base at its output start, forward-fill across
    # its segment (live rows' starts are unique; empty rows seed nothing)
    pos = jnp.where(scnt > 0, row_offsets[rows_sorted], total)
    seed = jnp.zeros((total,), jnp.int32).at[pos].set(
        base_sorted, mode="drop", unique_indices=True)
    fl = jnp.zeros((total,), bool).at[pos].set(
        True, mode="drop", unique_indices=True)
    i = jnp.arange(total, dtype=jnp.int32)
    src = jnp.clip(ffill1d(seed, fl) + i, 0, cols_flat.shape[0] - 1)
    if vals_flat.dtype.itemsize == 4:
        packed = jnp.stack(
            [cols_flat,
             jax.lax.bitcast_convert_type(vals_flat, jnp.int32)], axis=-1)
        rec = packed[src]
        return rec[..., 0], jax.lax.bitcast_convert_type(
            rec[..., 1], vals_flat.dtype)
    return cols_flat[src], vals_flat[src]


# ---------------------------------------------------------------------------
# Host-side stream layout (pure numpy, driven by the histogram readback)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """Everything the host derives from the planning readback: chunk
    schedule, wide-row segment table, merge-level plans. Per-chunk row/
    A-slot bases live on device (searchsorted over the e / p0 arrays)."""

    W: int
    G: int                    # rect rows per chunk
    # rect rows of the LAST chunk (<= G): a stream whose total is not a
    # multiple of G*W otherwise pays a nearly-dead full chunk (config
    # 1b: 1026 rect rows over 512-row chunks left 2 live rows in chunk
    # 3). Shrunk only when the wide region fits the full chunks.
    g_last: int
    n_chunks: int
    total_q: int              # stream length (sum of allocations)
    n_wide: int               # wide rows (q > W), first in sorted order
    r_wide: int               # rect rows owned by wide rows
    wide_segs: np.ndarray     # (n_wide,) segments per wide row
    n_stream_rows: int
    n_direct_rows: int
    direct_classes: List[Tuple[int, int, int]]  # (cap, start, count)


def plan_layout(hist: np.ndarray, d_hist: np.ndarray, W: int,
                product_budget: int, *, total_q: Optional[int] = None,
                n_wide: Optional[int] = None, r_wide: Optional[int] = None,
                wide_segs: Optional[np.ndarray] = None) -> StreamLayout:
    """Derive the full stream layout from the planning readback (the
    analogue of spECK's blockStarts D2H,
    spECK_HashLoadBalancer.cuh:330-331).

    With the tight-layout keywords (from the device pack) the exact
    totals are used; without them (pow2 mode, e.g. the SPMD mesh path and
    unit tests) they are derived from the class histogram. The int32
    ceiling guard always uses the pow2 class bound — an upper bound on
    the tight total — so the ceiling semantics match either mode."""
    qs = 1 << np.arange(N_QCLASS, dtype=np.int64)
    class_sum = int((hist.astype(np.int64) * qs).sum())
    # the tight layout's relocation rounds and pow2 tail can round bases
    # up past the pow2 class bound by a few W; 4W of margin keeps the
    # guard an upper bound on the device's actual tight total
    if class_sum + 4 * W >= 2**31:
        raise ProductOverflow(
            f"stream of ~{class_sum} quantized products exceeds the 2^31 "
            "int32 ceiling; row-block the multiply")
    n_stream_rows = int(hist.sum())
    if total_q is None:
        # pow2 layout: totals straight from the class histogram
        total_q = class_sum
        wide_classes = [k for k in range(N_QCLASS)
                        if (1 << k) > W and hist[k]]
        n_wide = int(sum(hist[k] for k in wide_classes))
        wide_segs = np.concatenate([
            np.full(int(hist[k]), (1 << k) // W, np.int64)
            for k in sorted(wide_classes, reverse=True)
        ]) if n_wide else np.zeros(0, np.int64)
        r_wide = int(wide_segs.sum())
    else:
        wide_segs = np.asarray(wide_segs, np.int64)

    G = max(1, product_budget // W)
    # exact-size G: when the whole stream fits one chunk, a
    # pow2/pow4 G ladder left up to 2x dead slots in the single chunk
    # (config 4: 2.18M live in a 4M-slot chunk, every per-slot cost
    # inflated 1.8x). Round need up to a multiple of 8 rect rows —
    # bounded shape diversity, near-exact fill.
    need = -(-max(total_q, 1) // W)
    if need < G:
        G = max(8, -(-need // 8) * 8) if need > 8 else max(1, need)
    n_chunks = -(-total_q // (G * W)) if total_q else 0
    # last-chunk shrink (see StreamLayout.g_last); wide rows must stay
    # in full chunks (_wide_slices assumes stride G)
    g_last = G
    if n_chunks > 1:
        rem = need - (n_chunks - 1) * G
        if rem < G and (n_chunks - 1) * G >= (r_wide or 0):
            g_last = max(8, -(-rem // 8) * 8) if rem > 8 \
                else max(1, rem)

    n_direct = int(d_hist.sum())
    direct_classes = []
    start = n_stream_rows
    for k in range(N_QCLASS - 1, -1, -1):
        cnt = int(d_hist[k])
        if cnt:
            direct_classes.append((1 << k, start, cnt))
            start += cnt
    return StreamLayout(
        W=W, G=G, g_last=g_last, n_chunks=n_chunks, total_q=total_q,
        n_wide=n_wide, r_wide=r_wide, wide_segs=wide_segs,
        n_stream_rows=n_stream_rows, n_direct_rows=n_direct,
        direct_classes=direct_classes,
    )


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One merge level: in_map rows of the previous buffer into F-wide
    output rectangle rows; final rows finish (count + emit) here."""

    F: int
    W_in: int
    in_map: np.ndarray      # (R_out, F) int32, -1 padded
    final_mask: np.ndarray  # (R_out,) bool
    segs_out: np.ndarray    # (n_unfinished_rows,) for the next level


def plan_levels(layout: StreamLayout, F: int = 4,
                max_width: int = 1 << 24) -> List[LevelPlan]:
    """Merge-level schedule for the wide rows (host numpy).

    Level 0 input = the first r_wide rectangle rows of the stream (width
    W); each level groups up to F consecutive segments of one row. A row
    is final when all its remaining segments fit one output row.
    """
    plans: List[LevelPlan] = []
    segs = layout.wide_segs.copy()
    rows = np.arange(layout.n_wide)
    W_in = layout.W
    while len(rows):
        starts = np.concatenate([[0], np.cumsum(segs)])[:-1]
        f_eff = min(F, max(max_width // W_in, 2))
        out_rows = []
        final = []
        segs_out = []
        keep_rows = []
        for i, r in enumerate(rows):
            s0, ns = int(starts[i]), int(segs[i])
            n_out = -(-ns // f_eff)
            for o in range(n_out):
                seg_ids = np.full(f_eff, -1, np.int64)
                lo = s0 + o * f_eff
                hi = min(s0 + ns, lo + f_eff)
                seg_ids[: hi - lo] = np.arange(lo, hi)
                out_rows.append(seg_ids)
                final.append(n_out == 1)
            if n_out > 1:
                keep_rows.append(r)
                segs_out.append(n_out)
        plans.append(LevelPlan(
            F=f_eff, W_in=W_in,
            in_map=np.asarray(out_rows, np.int32).reshape(-1, f_eff),
            final_mask=np.asarray(final, bool),
            segs_out=np.asarray(segs_out, np.int64),
        ))
        rows = np.asarray(keep_rows)
        segs = np.asarray(segs_out, np.int64)
        W_in = W_in * f_eff
    return plans
