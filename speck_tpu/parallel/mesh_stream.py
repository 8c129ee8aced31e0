"""SPMD mesh SpGEMM on the flat product stream.

Replaces the fixed-cap shard_map path's global per-row capacity (which
paid the widest row's rectangle on every row of every shard) with the
stream formulation: each shard runs the full stream pipeline on its local
A rows -- planning sort, tight packing, (G, W) chunks, sort/contract,
device-side offsets, emission into a padded output -- entirely inside ONE
jitted ``shard_map``. Per-shard working memory is bounded: transient
chunk work is G*W slots; RETAINED staging is capped by
``cfg.fused_staging_budget`` (past it, contained chunks run count-only
and re-expand straight into C in the emission pass, the single-chip
two-phase analogue), ladder levels retain only rows that finish there,
and rows past ``cfg.mesh_split_min_ops`` products leave the ladder
entirely via k-split. Skewed matrices shard cleanly; ops-balanced A
ranges (``balanced_row_ranges``) keep the shared chunk count off the
heaviest shard.

The rectangle width W stays at the configured chunk width regardless of
skew: rows wider than W own whole rectangle rows and are finished by a
merge-level ladder INSIDE the SPMD body (static depth, host-planned
in_maps shipped as sharded arrays — _mesh_wide_plans), exactly like the
single-chip ladder (ops/spgemm._run_wide). One 10^6-op row on one shard
no longer inflates every shard's chunk-sort width.

B exchange over the mesh axis (ICI on a real slice):

- ``exchange="allgather"``: every shard gathers all B row shards
  (jax.lax.all_gather), then indexes rows directly -- the correctness
  baseline.
- ``exchange="needset"``: the host computes, per (dst, src) shard pair,
  exactly which B rows dst needs (the per-partition generalization of the
  reference's per-row column-range analysis, toRowColMinMax,
  /root/reference/include/common.cuh:303-319); the rows' (col, val)
  records move in D-1 round-robin ``jax.lax.ppermute`` rounds (round r:
  src s -> dst (s+r)%D), each round padded only to ITS OWN largest pair —
  self-need is a local gather (zero communication) and all-empty rounds
  are skipped outright. A's column ids are pre-remapped to
  received-buffer slots on the host. meta["stats"] reports the
  exchanged-bytes reduction vs all_gather.

Kernel-family routing (the single-chip DIA/dense/stream auto-select,
ops/spgemm, hoisted across devices): banded/stencil inputs take the
per-shard diagonal-plane convolution with a fixed ring-halo exchange
(_mesh_sdia_gate/_mesh_sdia_spgemm); tile-bounded inputs under
``exchange="allgather"`` take the dense route — densify + batched
matmuls per shard against the replicated B
(_mesh_dense_gate/_mesh_dense_spgemm). Under needset the stream keeps
precedence over dense: the need-set plan can move far less than the
replication the dense route requires (zero for block structure).

The reference is single-GPU (SURVEY.md §2.2); this layer is new design
per the BASELINE.json north star.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.csr import HostCSR
from ..ops.analysis import cumsum1d
from ..ops.esc import pack_csr_arrays
from ..ops.stream import (_compact_rect, _contract_rect, _plan_stream_impl,
                          _pow2ceil, _sort_cols, stream_chunk,
                          stream_chunk_numeric, stream_emit, stream_level,
                          tight_total_host)
from ..utils.config import SpgemmConfig
from .dist import ROW_AXIS, _pad_to, _slice_rows


def _mesh_wide_plans(shard_ops: List[np.ndarray], W: int, F: int,
                     max_width: int, n_cols: Optional[int] = None):
    """Host ladder plans for the in-SPMD wide-row merge levels.

    Buffer-width cap (the giant-row mesh memory fix): every level's
    input/output buffers are truncated to pow2ceil(n_cols) columns —
    a compacted segment never holds more than n_cols distinct columns,
    so the truncation is lossless, and the VIRTUAL width ladder (which
    fixes the level structure) no longer materializes multi-megawide
    buffers whose compile-time constant folding OOMed the CPU mesh at
    2^27 products (pred[1, 2^24] constants, one per doubling-loop
    step). Specs carry W_buf_in/W_buf_out; in_map structure is
    unchanged.

    Per shard: wide rows (ops > W, device sort order = ops descending;
    ties have equal segment counts, so host order is interchangeable)
    own ceil(ops/W) level-0 rectangle rows; each level merges up to
    f_eff consecutive segments of one row into one output row of width
    f_eff * W_in. Unlike the single-chip ladder (ops/spgemm._run_wide),
    in_maps are ABSOLUTE into the full previous buffer (no host
    compaction between levels — shard_map shapes are static), and all
    shards are padded to one common (R_out, depth) schedule; pad rows
    carry in_map = -1 and final = False and produce nothing.

    Returns (r_wide_max, wide_rid (D, r_wide_max), specs) where specs is
    a list of dicts {F, W_in, R_out, in_map (D, R_out, F), final
    (D, R_out)}."""
    D = len(shard_ops)
    wide_segs = []
    for ops in shard_ops:
        w = np.sort(ops[ops > W])[::-1]
        wide_segs.append(-(-w // W))
    r_wides = [int(s.sum()) for s in wide_segs]
    r_wide_max = max(r_wides + [0])
    if r_wide_max == 0:
        return 0, np.zeros((D, 1), np.int32), []
    wide_rid = np.full((D, r_wide_max), -1, np.int32)
    for d, segs in enumerate(wide_segs):
        if len(segs):
            wide_rid[d, : int(segs.sum())] = np.repeat(
                np.arange(len(segs)), segs)

    # per-shard absolute level schedules
    per_shard: List[List[dict]] = []
    depth = 0
    for segs in wide_segs:
        rows = []
        base = 0
        for rid, s in enumerate(segs):
            rows.append((rid, list(range(base, base + int(s)))))
            base += int(s)
        levels = []
        W_in = W
        while rows:
            f_eff = min(F, max(max_width // W_in, 2))
            in_map, final, nxt = [], [], []
            out_base = 0
            for rid, segids in rows:
                n_out = -(-len(segids) // f_eff)
                outs = []
                for o in range(n_out):
                    grp = segids[o * f_eff: (o + 1) * f_eff]
                    in_map.append(grp + [-1] * (f_eff - len(grp)))
                    final.append(n_out == 1)
                    outs.append(out_base)
                    out_base += 1
                if n_out > 1:
                    nxt.append((rid, outs))
            levels.append(dict(F=f_eff, W_in=W_in,
                               in_map=np.asarray(in_map, np.int32),
                               final=np.asarray(final, bool)))
            rows = nxt
            W_in *= f_eff
        per_shard.append(levels)
        depth = max(depth, len(levels))

    # pad across shards to one common schedule (F/W_in agree by
    # construction: both derive only from W and the level index)
    cap = _pow2ceil(n_cols) if n_cols else None
    specs = []
    W_in = W
    w_buf = W if cap is None else min(W, cap)
    for li in range(depth):
        f_eff = min(F, max(max_width // W_in, 2))
        R_out = max((lv[li]["in_map"].shape[0]
                     for lv in per_shard if li < len(lv)), default=1)
        R_out = max(R_out, 1)
        im = np.full((D, R_out, f_eff), -1, np.int32)
        fm = np.zeros((D, R_out), bool)
        for d, lv in enumerate(per_shard):
            if li < len(lv):
                k = lv[li]["in_map"].shape[0]
                im[d, :k] = lv[li]["in_map"]
                fm[d, :k] = lv[li]["final"]
        w_out = f_eff * w_buf if cap is None else min(cap, f_eff * w_buf)
        specs.append(dict(F=f_eff, W_in=W_in, R_out=R_out,
                          in_map=im, final=fm,
                          W_buf_in=w_buf, W_buf_out=w_out))
        W_in *= f_eff
        w_buf = w_out
    return r_wide_max, wide_rid, specs


def _host_row_ops(a: HostCSR, b_len: np.ndarray) -> np.ndarray:
    alen = np.diff(a.row_offsets)
    ops = np.zeros(a.rows, np.int64)
    np.add.at(ops, np.repeat(np.arange(a.rows), alen),
              b_len[np.asarray(a.col_ids, np.int64)])
    return ops


# ---------------------------------------------------------------------------
# Pre-sharded inputs: a process
# only needs ITS OWN row shards' payloads. Everything cross-shard the
# host planner consumes is per-shard metadata (row lengths, stream
# totals, wide-row op lists, k-split candidates) exchanged as small
# padded arrays; the payload arrays are assembled as zero-filled stacks
# whose non-local entries are never materialized (make_array_from_
# callback only asks for addressable shards) and the need-set exchange
# plan itself is computed on device from the truly-sharded arrays.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RowShards:
    """A row-sharded matrix for ``mesh_stream_spgemm``: shape (m, n),
    rows dealt in contiguous blocks over D shards — equal ceil(m/D)
    counts by default, or explicit ``ranges_`` (the ops-balanced A
    partition, ``balanced_row_ranges``). This process holds the HostCSR
    row slices of the shards its devices own (all of them under a
    single controller).

    ``local``: dict shard-index -> HostCSR (rows == that shard's row
    count, offsets rebased to the slice)."""

    m: int
    n: int
    D: int
    local: dict
    ranges_: Optional[list] = None

    @property
    def ranges(self):
        if self.ranges_ is not None:
            return self.ranges_
        m_loc = max(1, -(-self.m // self.D))
        return [(min(d * m_loc, self.m), min((d + 1) * m_loc, self.m))
                for d in range(self.D)]

    @classmethod
    def from_global(cls, a: HostCSR, D: int,
                    ranges: Optional[list] = None) -> "RowShards":
        sh = cls(m=a.rows, n=a.cols, D=D, local={},
                 ranges_=(list(ranges) if ranges is not None else None))
        sh.local = {d: _slice_rows(a, r0, r1)
                    for d, (r0, r1) in enumerate(sh.ranges)}
        return sh

    @classmethod
    def from_local(cls, m: int, n: int, D: int,
                   local: dict) -> "RowShards":
        """Multi-controller constructor: ``local`` holds only the shards
        whose devices belong to this process."""
        return cls(m=m, n=n, D=D, local=dict(local))

    @property
    def all_local(self) -> bool:
        return len(self.local) == self.D


def _tight_weights(row_ops: np.ndarray, W: int, min_q: int) -> np.ndarray:
    """Per-row stream allocation under the tight layout (ops/stream.py
    _tight_layout): wide rows take exact W-multiples, mid-size rows
    (q > W/8) their pow2 quantum, small rows max(ops, min_q). The
    balance weight must match the real allocation or pow2-quantized
    heavy rows systematically overload their shards."""
    from ..ops.stream import _pow2ceil_arr

    ops = np.asarray(row_ops, np.int64)
    qe = np.maximum(ops, min_q)
    return np.where(ops > W, (-(-ops // W)) * W,
                    np.where(qe > W // 8, _pow2ceil_arr(qe), qe))


def balanced_row_ranges(row_ops: np.ndarray, D: int, min_q: int = 8,
                        W: int = 8192) -> list:
    """Contiguous shard boundaries equalizing cumulative per-row stream
    allocation (the tight layout's quantized weight, _tight_weights)
    instead of row counts: the mesh-axis form of the reference's
    load-balanced row binning (spECK_HashLoadBalancer.cuh:205-305).
    O(m) host work on metadata the planner already has."""
    w = _tight_weights(row_ops, W, min_q)
    m = w.shape[0]
    if m == 0:
        return [(0, 0)] * D
    c = np.cumsum(w)
    total = int(c[-1])
    bounds = np.searchsorted(c, [total * d // D for d in range(1, D)],
                             side="left")
    bounds = np.concatenate([[0], np.minimum(bounds + 1, m), [m]])
    bounds = np.maximum.accumulate(bounds)
    return [(int(bounds[d]), int(bounds[d + 1])) for d in range(D)]


def _owner_of(r: int, ranges) -> int:
    """Owner shard of global row r under contiguous (possibly
    ops-balanced) ranges."""
    for d, (r0, r1) in enumerate(ranges):
        if r0 <= r < r1:
            return d
    raise ValueError(f"row {r} outside sharded ranges {ranges}")


def _combine_max(x: np.ndarray) -> np.ndarray:
    """Elementwise max across processes (identity under one controller).
    Per-shard metadata is zero-filled where non-local, so max recovers
    the owner's values everywhere."""
    if jax.process_count() == 1:
        return x
    from jax.experimental import multihost_utils

    return np.max(np.asarray(multihost_utils.process_allgather(x)),
                  axis=0)


def _stack_shards(ash: RowShards, dtype=jnp.float32):
    """stack_row_shards over a RowShards: per-shard padded (D, m_loc+1)
    indptr / (D, nnz_max) cols / data, zero-filled for non-local shards.
    m_loc is the LARGEST shard's row count (ranges may be ops-balanced);
    nnz_max is agreed across processes via one scalar combine."""
    D = ash.D
    m_loc = max([1] + [r1 - r0 for r0, r1 in ash.ranges])
    nnz_loc = np.zeros(D, np.int64)
    for d, sl in ash.local.items():
        nnz_loc[d] = sl.nnz
    nnz_loc = _combine_max(nnz_loc)
    nnz_max = max(1, int(nnz_loc.max(initial=0)))
    ai = np.zeros((D, m_loc + 1), np.int32)
    ax = np.zeros((D, nnz_max), np.int32)
    ad = np.zeros((D, nnz_max), np.dtype(dtype))
    for d, sl in ash.local.items():
        ai[d] = _pad_to(np.asarray(sl.row_offsets, np.int32), m_loc + 1,
                        fill=int(sl.nnz))
        ax[d, : sl.nnz] = np.asarray(sl.col_ids, np.int32)
        ad[d, : sl.nnz] = np.asarray(sl.data, np.dtype(dtype))
    return ai, ax, ad, ash.ranges


def _shard_row_lens(bsh: RowShards) -> np.ndarray:
    """Global B row lengths (the only O(b_rows) host metadata the
    planner needs; payloads never cross hosts): per-shard diffs,
    combined."""
    D = bsh.D
    k_loc = max(1, -(-bsh.m // D))
    lens = np.zeros((D, k_loc), np.int64)
    for d, sl in bsh.local.items():
        ln = np.diff(np.asarray(sl.row_offsets, np.int64))
        lens[d, : ln.shape[0]] = ln
    return _combine_max(lens).reshape(-1)[: bsh.m]


def _drop_rows(sl: HostCSR, local_ids: np.ndarray) -> HostCSR:
    """Copy of a local shard with the given local rows emptied."""
    ip = np.asarray(sl.row_offsets, np.int64)
    drop = np.zeros(sl.nnz, bool)
    for r in local_ids:
        drop[ip[r]: ip[r + 1]] = True
    lens = ip[1:] - ip[:-1]
    lens2 = lens.copy()
    lens2[local_ids] = 0
    ip2 = np.zeros(sl.rows + 1, np.int64)
    np.cumsum(lens2, out=ip2[1:])
    keep = ~drop
    return HostCSR(rows=sl.rows, cols=sl.cols, row_offsets=ip2,
                   col_ids=np.asarray(sl.col_ids)[keep],
                   data=np.asarray(sl.data)[keep])


@dataclasses.dataclass
class NeedsetStats:
    """Communication-volume accounting for the need-set exchange."""

    allgather_bytes: int   # (col, val) bytes every shard receives via all_gather
    needset_bytes: int     # padded (col, val) bytes exchanged per shard
    pairs_nnz: np.ndarray  # (D, D) true nnz needed dst<-src
    # executed exchange: "needset", "needset_overlap", or
    # "allgather(auto)" when the auto gate fell back because the padded
    # plan would move more bytes than replication
    mode: str = "needset"

    @property
    def zero_comm(self) -> bool:
        """True when no bytes cross the interconnect at all (pure
        block-diagonal need: every non-self round empty)."""
        return self.needset_bytes == 0

    @property
    def reduction(self) -> float:
        if self.needset_bytes == 0:
            return float("inf")
        return self.allgather_bytes / self.needset_bytes


# ---------------------------------------------------------------------------
# Device-side need-set planning
#
# The older host planner did per-shard np.unique over all of
# A's columns plus D^2 per-pair loops with per-row np.arange
# concatenations -- O(nnz log nnz) host work that also required the FULL
# A and B on every process. The device planner computes the
# per-partition generalization of the reference's per-row column-range
# analysis (toRowColMinMax, /root/reference/include/common.cuh:303-319)
# as per-dst B-row need BITMAPS on device, reads back only the D^2
# per-pair block counts (the only data-dependent static shapes), and
# derives every table the exchange needs -- received-buffer slot map,
# A-column remap, per-round send gather plans -- in one more jitted
# pass. Per-shard cost is O(nnz/D + b_rows) vector work; the cross-shard
# dependency is only the bitmap itself (b_rows bools), which under jit
# moves as a collective instead of requiring replicated host copies.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("D", "k_loc"))
def _needset_bitmaps(ax, nnz_d, spl_cols, spl_nnz, b_len_pad, *,
                     D: int, k_loc: int):
    """Phase A: per-dst need bitmap over (padded) B rows + per-(dst,src)
    needed-row / needed-nnz counts.

    ax (D, nnz_max) int32 padded A column ids; nnz_d (D,) live counts;
    spl_cols (D, spl_cap) k-split slot columns (or a (D, 1) dummy with
    spl_nnz = 0); b_len_pad (D*k_loc,) B row lengths.

    Returns (need (D, D, k_loc) bool, rows_cnt (D, D) int32,
    nnz_cnt (D, D) int32)."""
    b_rows_pad = D * k_loc

    def one(ax_d, n_s, spl_d, spl_n):
        valid = jnp.arange(ax_d.shape[0], dtype=jnp.int32) < n_s
        need = jnp.zeros((b_rows_pad,), bool).at[
            jnp.where(valid, ax_d, b_rows_pad)].set(True, mode="drop")
        vs = jnp.arange(spl_d.shape[0], dtype=jnp.int32) < spl_n
        need = need.at[jnp.where(vs, spl_d, b_rows_pad)].set(
            True, mode="drop")
        return need.reshape(D, k_loc)

    need = jax.vmap(one)(ax, nnz_d, spl_cols, spl_nnz)
    rows_cnt = jnp.sum(need, axis=2, dtype=jnp.int32)
    nnz_cnt = jnp.sum(
        jnp.where(need, b_len_pad.reshape(1, D, k_loc), 0),
        axis=2, dtype=jnp.int32)
    return need, rows_cnt, nnz_cnt


@partial(jax.jit, static_argnames=("D", "k_loc", "P_rows"))
def _needset_recv_tables(need, b_len_pad, seg_off_by_r, *,
                         D: int, k_loc: int, P_rows: int):
    """Phase B1 (dst side): received-buffer row tables + the column LUT.

    For dst d and source src, the needed rows of src's block occupy
    received-buffer slots src*P_rows + rank (rank = order within the
    block); their records land at seg_off[(d-src)%D] + running offset.
    Returns (rb_start (D, D*P_rows), rb_len (D, D*P_rows),
    lut (D, D*k_loc) int32 received-slot of every B row)."""
    RB = D * P_rows
    lens3 = jnp.broadcast_to(
        b_len_pad.reshape(1, D, k_loc), (D, D, k_loc))
    lens_n = jnp.where(need, lens3, 0)
    rank = jnp.cumsum(need.astype(jnp.int32), axis=2) - need
    start_in_pair = jnp.cumsum(lens_n, axis=2) - lens_n
    src_ids = jnp.arange(D, dtype=jnp.int32)
    slot = src_ids[None, :, None] * P_rows + rank          # (D, D, k_loc)
    d_ids = jnp.arange(D, dtype=jnp.int32)
    r_of = (d_ids[:, None] - src_ids[None, :]) % D          # (D, D)
    base = seg_off_by_r[r_of][:, :, None]                   # (D, D, 1)
    tgt = jnp.where(need, slot, RB).reshape(D, -1)

    def scat(vals):
        return jnp.zeros((D, RB), jnp.int32).at[
            jnp.arange(D)[:, None], tgt].set(vals.reshape(D, -1),
                                             mode="drop")

    rb_start = scat(base + start_in_pair)
    rb_len = scat(lens_n)
    # LUT: global B row -> received slot (0 where not needed; such rows
    # are never referenced by this dst's A columns)
    row_tgt = jnp.where(need,
                        jax.lax.broadcasted_iota(jnp.int32, (D, D, k_loc), 1)
                        * k_loc
                        + jax.lax.broadcasted_iota(
                            jnp.int32, (D, D, k_loc), 2),
                        D * k_loc).reshape(D, -1)
    lut = jnp.zeros((D, D * k_loc), jnp.int32).at[
        jnp.arange(D)[:, None], row_tgt].set(
        jnp.where(need, slot, 0).reshape(D, -1), mode="drop")
    return rb_start, rb_len, lut


@partial(jax.jit, static_argnames=("r", "Rr", "D", "k_loc"))
def _needset_send_plan(need, b_len_pad, *, r: int, Rr: int,
                       D: int, k_loc: int):
    """Phase B2 (src side), one round: the per-src gather plan moving the
    B records dst=(src+r)%D needs. Returns (send_idx (D, Rr) int32
    src-local record positions, send_valid (D, Rr) bool)."""
    # need[dst=(s+r)%D, src=s, :] for every s = diagonal of the rolled cube
    needr = jnp.roll(need, -r, axis=0)                      # [s] -> need[s+r]
    blk = jnp.diagonal(needr, axis1=0, axis2=1).T           # (D, k_loc)
    lens = jnp.broadcast_to(b_len_pad.reshape(D, k_loc), blk.shape)
    lens_n = jnp.where(blk, lens, 0)
    starts = jnp.cumsum(lens_n, axis=1) - lens_n            # excl, per src
    total = jnp.sum(lens_n, axis=1)                         # (D,)
    live = blk & (lens > 0)
    # compact (row-in-block, payload start, local record base) by rank
    rank = jnp.cumsum(live.astype(jnp.int32), axis=1) - live
    tgt = jnp.where(live, rank, Rr)
    loc_base = jnp.cumsum(lens, axis=1) - lens              # src-local CSR
    arangeD = jnp.arange(D)[:, None]

    def compact(vals):
        return jnp.zeros((D, Rr), jnp.int32).at[
            arangeD, tgt].set(vals, mode="drop")

    starts_c = compact(starts)
    base_c = compact(loc_base)
    # run-length decode: segment id of each payload position
    marks = jnp.zeros((D, Rr), jnp.int32).at[
        arangeD, jnp.where(live, starts, Rr)].add(1, mode="drop")
    seg = jnp.cumsum(marks, axis=1) - 1
    segc = jnp.clip(seg, 0, Rr - 1)
    i = jnp.arange(Rr, dtype=jnp.int32)[None, :]
    idx = jnp.take_along_axis(base_c, segc, axis=1) + (
        i - jnp.take_along_axis(starts_c, segc, axis=1))
    valid = i < total[:, None]
    return jnp.where(valid, idx, 0), valid


@jax.jit
def _lut_gather(lut, idx):
    """Per-shard LUT remap: out[d, i] = lut[d, idx[d, i]]."""
    return jnp.take_along_axis(
        lut, jnp.clip(idx, 0, lut.shape[1] - 1), axis=1)


def _plan_needset_device(ax_h, nnz_d_h, spl_cols_h, spl_nnz_h, b_len_h,
                         D: int, k_loc: int, put,
                         pad_exact: bool = True):
    """Run phases A/B and return the same plan products the host planner
    yields: (pair_nnz (D,D) np, round_nnz list, ax lut (device, sharded),
    rb_start, rb_len (device, sharded), send plan builder).

    The ONLY host readback is the D^2 pair counts (static shapes for the
    round padding) -- the reference's analogous sync is its 8-byte
    analysis readback (/root/reference/source/GPU/Multiply.cu:249-252)."""
    b_rows_pad = D * k_loc
    b_len_pad = np.zeros(b_rows_pad, np.int32)
    b_len_pad[: b_len_h.shape[0]] = b_len_h
    b_len_dev = jnp.asarray(b_len_pad)
    if spl_cols_h is None:
        spl_cols_h = np.zeros((D, 1), np.int32)
        spl_nnz_h = np.zeros((D,), np.int32)
    need, rows_cnt, nnz_cnt = _needset_bitmaps(
        put(np.asarray(ax_h, np.int32)), put(np.asarray(nnz_d_h, np.int32)),
        put(np.asarray(spl_cols_h, np.int32)),
        put(np.asarray(spl_nnz_h, np.int32)),
        b_len_dev, D=D, k_loc=k_loc)
    rows_cnt_h = _fetch_global(rows_cnt)
    pair_nnz = _fetch_global(nnz_cnt).astype(np.int64)
    P_rows = int(_pow2ceil(max(1, int(rows_cnt_h.max(initial=1)))))
    round_nnz = []
    for r in range(D):
        mx = max(int(pair_nnz[(s + r) % D, s]) for s in range(D))
        round_nnz.append((mx if pad_exact else int(_pow2ceil(mx)))
                         if mx > 0 else 0)
    seg_off = np.concatenate([[0], np.cumsum(round_nnz)]).astype(np.int64)
    if seg_off[-1] >= 2 ** 31:
        raise ValueError(
            f"need-set exchange would stage {int(seg_off[-1])} B records "
            "per shard, past the 2^31 int32 ceiling; use more shards")
    rb_start, rb_len, lut = _needset_recv_tables(
        need, b_len_dev, jnp.asarray(seg_off[:-1].astype(np.int32)),
        D=D, k_loc=k_loc, P_rows=P_rows)

    def send_plans():
        out = []
        for r in range(D):
            if round_nnz[r] == 0:
                continue
            si, sv = _needset_send_plan(
                need, b_len_dev, r=r, Rr=round_nnz[r], D=D, k_loc=k_loc)
            out.append((si, sv))
        return out

    return dict(pair_nnz=pair_nnz, round_nnz=round_nnz, seg_off=seg_off,
                P_rows=P_rows, rb_start=rb_start, rb_len=rb_len, lut=lut,
                send_plans=send_plans)


# at most this many rows take the k-split path per call (bounds the
# padded host-exchange arrays); excess candidates DEGRADE to the
# in-SPMD wide-row ladder instead of raising (rows past the int32
# stream ceiling always split and are never dropped)
_KSPLIT_MAX_ROWS = 64


def _plan_ksplit_shards(ash: RowShards, ops_sh: np.ndarray,
                        b_len_h: np.ndarray, D: int, k_locB: int,
                        split_min: int, subrow_max: int = 1 << 30,
                        np_dtype=np.float32):
    """Host plan for k-split rows (single-row sharding): rows with more
    products than ``split_min`` (and ALWAYS rows a single shard cannot
    hold) are removed from their owner shard's local A and their
    nonzeros re-dealt BY B-ROW-OWNER: shard s gets the slots whose
    a_col lies in its B shard, so the partial products need no remote B
    rows at all (needset: pure self-need). Partials merge via one
    all_gather + sort (see _make_shard_body).

    Degrade paths (the reference degrades to slower kernels, never
    refuses):
    - more than _KSPLIT_MAX_ROWS candidates: only the heaviest 64 (plus
      every must-split row) take this path; the rest ride the ladder.
    - a sub-row past ``subrow_max`` products on one shard: SECONDARY
      split into consecutive slot parts, each its own pipeline row; all
      of a row's partials still merge in the owner's one sort (the
      merge width grows by max_parts instead of raising).

    ``ops_sh`` (D, m_loc): per-shard row ops (globally combined).
    Candidate rows' slot payloads are exchanged as small padded arrays,
    so pre-sharded multi-controller inputs never ship full matrices.
    Returns (ash_eff, ops_sh_eff, ksp|None) where ash_eff has the split
    rows emptied in their owner shards.

    The reference's analogue is the global-map flush/restart that lets
    ONE row's products span many passes of one GPU
    (spECK_HashSpGEMM.cuh:106-126); here the passes are mesh shards."""
    subrow_max = min(subrow_max, 1 << 30)
    # a row no single shard can ladder must split regardless of knobs
    must_min = 1 << 30
    split_min = min(split_min, must_min)
    ranges = ash.ranges
    hits = ops_sh > split_min                     # (D, m_loc), global info
    n_split = int(hits.sum())
    if n_split == 0:
        return ash, ops_sh, None
    d_ids, j_ids = np.nonzero(hits)
    cand = np.array(
        [(ranges[d][0] + j, ops_sh[d, j])
         for d, j in zip(d_ids, j_ids)], np.int64)
    if n_split > _KSPLIT_MAX_ROWS:
        must = cand[cand[:, 1] > must_min]
        opt = cand[cand[:, 1] <= must_min]
        room = max(_KSPLIT_MAX_ROWS - must.shape[0], 0)
        # heaviest first; deterministic tie-break on row id
        order = np.lexsort((opt[:, 0], -opt[:, 1]))
        cand = np.concatenate([must, opt[order[:room]]])
        n_split = cand.shape[0]
        if n_split == 0:
            return ash, ops_sh, None
    split_ids = np.sort(cand[:, 0])
    # exchange the split rows' slot payloads: owner fills, others zero
    lens = np.zeros(n_split, np.int64)
    for j, r in enumerate(split_ids):
        d = _owner_of(int(r), ranges)
        if d in ash.local:
            ip = np.asarray(ash.local[d].row_offsets, np.int64)
            lr = int(r) - ranges[d][0]
            lens[j] = ip[lr + 1] - ip[lr]
    lens = _combine_max(lens)
    L = max(1, int(lens.max(initial=1)))
    scols = np.zeros((n_split, L), np.int64)
    svals = np.zeros((n_split, L), np.float64)
    for j, r in enumerate(split_ids):
        d = _owner_of(int(r), ranges)
        if d in ash.local:
            sl = ash.local[d]
            ip = np.asarray(sl.row_offsets, np.int64)
            lr = int(r) - ranges[d][0]
            o0, o1 = int(ip[lr]), int(ip[lr + 1])
            scols[j, : o1 - o0] = np.asarray(sl.col_ids[o0:o1], np.int64)
            svals[j, : o1 - o0] = np.asarray(sl.data[o0:o1])
    # owner-exclusive zero-filled data: sum-combine recovers it everywhere
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        scols = np.sum(multihost_utils.process_allgather(scols), axis=0)
        svals = np.sum(multihost_utils.process_allgather(svals), axis=0)
    # drop the split rows from their owner shards + zero their ops
    ash_eff = RowShards(m=ash.m, n=ash.n, D=D, local=dict(ash.local),
                        ranges_=ash.ranges_)
    ops_eff = ops_sh.copy()
    for j, r in enumerate(split_ids):
        d = _owner_of(int(r), ranges)
        ops_eff[d, int(r) - ranges[d][0]] = 0
        if d in ash_eff.local:
            ash_eff.local[d] = _drop_rows(
                ash_eff.local[d],
                np.array([int(r) - ranges[d][0]]))
    # per-shard sub-CSR: split row j's slots whose col is owned by B
    # shard s, secondary-split into max_parts consecutive part-rows of
    # <= subrow_max products each (part p of row j = pipeline row
    # j * max_parts + p; empty parts contribute nothing)
    sub_cols = [[None] * n_split for _ in range(D)]
    sub_vals = [[None] * n_split for _ in range(D)]
    sub_parts = np.ones((D, n_split), np.int64)
    for j in range(n_split):
        cj = scols[j, : lens[j]]
        vj = svals[j, : lens[j]]
        own = cj // k_locB
        for s in range(D):
            sel = own == s
            cs, vs = cj[sel], vj[sel]
            sub_cols[s][j] = cs
            sub_vals[s][j] = vs
            ops_slots = b_len_h[cs]
            if int(ops_slots.max(initial=0)) > subrow_max:
                raise ValueError(
                    f"one B row has {int(ops_slots.max())} nonzeros, "
                    f"past the per-part ceiling {subrow_max}; cannot "
                    "split below one (A-slot, B-row) product block")
            if int(ops_slots.sum()) > subrow_max:
                # greedy consecutive grouping under the ceiling
                acc, parts = 0, 1
                for o in ops_slots:
                    if acc + int(o) > subrow_max:
                        parts += 1
                        acc = int(o)
                    else:
                        acc += int(o)
                sub_parts[s, j] = parts
    max_parts = int(sub_parts.max(initial=1))
    n_rows = n_split * max_parts
    # part slot slices + per-part ops
    sub_ops = np.zeros((D, n_rows), np.int64)
    part_slice = {}
    for s in range(D):
        for j in range(n_split):
            ops_slots = b_len_h[sub_cols[s][j]]
            cuts = [0]
            acc = 0
            for i, o in enumerate(ops_slots):
                if acc + int(o) > subrow_max and acc > 0:
                    cuts.append(i)
                    acc = int(o)
                else:
                    acc += int(o)
            cuts.append(len(ops_slots))
            for p in range(len(cuts) - 1):
                lo, hi = cuts[p], cuts[p + 1]
                part_slice[(s, j, p)] = (lo, hi)
                sub_ops[s, j * max_parts + p] = int(
                    ops_slots[lo:hi].sum())
    assert sub_ops.max(initial=0) <= subrow_max
    spl_cap = max(1, max(
        sum(len(c) for c in sub_cols[s]) for s in range(D)))
    spl_indptr = np.zeros((D, n_rows + 1), np.int64)
    spl_cols = np.zeros((D, spl_cap), np.int64)
    spl_vals = np.zeros((D, spl_cap), np_dtype)
    for s in range(D):
        off = 0
        for j in range(n_split):
            for p in range(max_parts):
                if (s, j, p) in part_slice:
                    lo, hi = part_slice[(s, j, p)]
                    c = sub_cols[s][j][lo:hi]
                    spl_cols[s, off: off + len(c)] = c
                    spl_vals[s, off: off + len(c)] = \
                        sub_vals[s][j][lo:hi]
                    off += len(c)
                spl_indptr[s, j * max_parts + p + 1] = off
    ksp = dict(split_ids=split_ids, n_split=n_split, n_rows=n_rows,
               max_parts=max_parts, spl_indptr=spl_indptr,
               spl_cols=spl_cols, spl_vals=spl_vals, sub_ops=sub_ops,
               spl_cap=spl_cap)
    return ash_eff, ops_eff, ksp


def _stream_pipeline(cfg, G: int, W: int, n_cols: int, ai, ax, ad,
                     b_start, b_len, b_payload, wide_rid, level_args,
                     specs, *, m: int, n_ch: int, rw_max: int,
                     row_mask=None, f64: bool = False, emit_to=None):
    """One stream pipeline over a local CSR (traced inside shard_map):
    plan, chunks, wide-row ladder. ``row_mask`` (m,) restricts the
    pipeline to a subset of rows (ops forced to 0 elsewhere) — the
    overlap mode runs one pipeline per exchange round over the rows
    whose need is satisfied by that round's prefix of the received
    buffer.

    Per-shard retained memory is BOUNDED:

    - ladder levels with no final row anywhere retain nothing — their
      buffers are consumed by the next level and freed (specs[li]
      carries the host-known "any final here" flag);
    - when the full staged-chunk set would exceed
      ``cfg.fused_staging_budget`` (3 int32 planes per slot, the
      single-chip fused/two-phase bar, ops/spgemm.py), only chunks
      holding wide-row segments stage; the rest run count-only here and
      re-expand straight into C in the emission pass
      (stream_chunk_numeric — nothing retained per chunk);
    - with ``emit_to=(offsets, cols, vals)`` (static offsets, e.g. the
      k-split partial buffers) every chunk/level emits IMMEDIATELY and
      the return is just (nnz_row, cols, vals).

    Without emit_to, returns (nnz_row, rows_sorted, q_sorted, staged,
    level_out, state): staged entries are None for unstaged chunks and
    ``state`` carries everything _emit_pipeline needs to re-expand
    them."""
    CP = G * W
    blen_a = b_len[ax]
    cse = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), cumsum1d(blen_a)])
    row_ops = cse[ai[1:]] - cse[ai[:-1]]
    if row_mask is not None:
        row_ops = jnp.where(row_mask, row_ops, 0)
    stream_mask = row_ops > 0
    no_direct = jnp.zeros((m,), bool)
    if f64:
        a32 = jnp.zeros(ad.shape, jnp.int32)
        b_ind = b_payload[:, 0]
        b_dat = jax.lax.bitcast_convert_type(
            b_payload[:, 1:3], jnp.float64)
    else:
        a32 = jax.lax.bitcast_convert_type(ad, jnp.int32)
        b_ind = b_payload[:, 0]
        b_dat = ad                       # unused on the packed f32 path
    (rows_sorted, e, q_sorted, el, ops_sorted, p0, su, sa, src, pend,
     _) = _plan_stream_impl(
        row_ops, stream_mask, no_direct, ai, ax, a32, b_start, b_len,
        min_q=cfg.stream_min_q, m=m, tight=True, w_fixed=W)
    nnz_row = jnp.zeros((m,), jnp.int32)
    rowend = jnp.where(q_sorted > 0, e + ops_sorted, -1)
    n_wide_dev = jnp.sum((q_sorted > W).astype(jnp.int32))
    fused = 3 * n_ch * CP <= cfg.fused_staging_budget
    if emit_to is not None:
        offs_e, cols_e, vals_e = emit_to
    staged = []
    for c in range(n_ch):
        cs = jnp.int32(c * CP)
        # wide-row segments live in the first rw_max rectangle rows
        # (descending sort); only those chunks must stage for the ladder
        has_wide = c * G < rw_max
        do_stage = emit_to is not None or fused or has_wide
        nnz_row, stg = stream_chunk(
            rows_sorted, e, rowend, q_sorted, el, ops_sorted, p0,
            su, sa, pend, b_payload, b_ind, b_dat, ad, src,
            nnz_row, cs,
            jnp.searchsorted(e, cs).astype(jnp.int32),
            jnp.searchsorted(p0, cs).astype(jnp.int32),
            G=G, W=W, n_cols=n_cols, pack_bits=0, stage=do_stage,
            f64=f64)
        if emit_to is not None and not has_wide:
            cols_e, vals_e = stream_emit(
                rows_sorted, stg[0], stg[1], stg[2], stg[3],
                n_wide_dev, offs_e, cols_e, vals_e,
                contained_only=True)
            stg = None
        staged.append(stg if do_stage else None)
    level_out = []
    if rw_max > 0 and specs:
        rid_in = wide_rid
        wb0 = specs[0]["W_buf_in"]
        wst = [s for s in staged[: -(-rw_max // G)] if s is not None]
        # compacted segments hold <= min(W, n_cols) live entries, so the
        # column truncation to the capped buffer width is lossless
        wcol = jnp.concatenate([s[1] for s in wst])[:rw_max, :wb0]
        wval = jnp.concatenate([s[2] for s in wst])[:rw_max, :wb0]
        wcnt = jnp.concatenate([s[3] for s in wst])[:rw_max]
        wcnt = jnp.where(rid_in >= 0, wcnt, 0)
        if emit_to is not None:
            # wide chunks were retained only for the ladder; their
            # contained rows still need emission
            for stg in wst:
                cols_e, vals_e = stream_emit(
                    rows_sorted, stg[0], stg[1], stg[2], stg[3],
                    n_wide_dev, offs_e, cols_e, vals_e,
                    contained_only=True)
        for li, spec in enumerate(specs):
            in_map = level_args[2 * li]
            final = level_args[2 * li + 1]
            nnz_row, (rid_out, col_c, val_c, counts) = stream_level(
                rows_sorted, rid_in, wcol, wval, wcnt,
                in_map, final, nnz_row,
                F=spec["F"], W_in=spec["W_buf_in"], n_cols=n_cols,
                count=True, compact_impl=cfg.stream_compact_impl)
            if spec["W_buf_out"] < col_c.shape[1]:
                col_c = col_c[:, : spec["W_buf_out"]]
                val_c = val_c[:, : spec["W_buf_out"]]
            if bool(np.asarray(spec["final"]).any()):
                fcnt = jnp.where(final, counts, 0)
                if emit_to is not None:
                    rid_b = jnp.broadcast_to(rid_out[:, None],
                                             col_c.shape)
                    cols_e, vals_e = stream_emit(
                        rows_sorted, rid_b, col_c, val_c, fcnt,
                        jnp.int32(0), offs_e, cols_e, vals_e,
                        wide_only=True)
                else:
                    level_out.append((rid_out, col_c, val_c, fcnt))
            rid_in, wcol, wval, wcnt = rid_out, col_c, val_c, counts
    if emit_to is not None:
        return nnz_row, cols_e, vals_e
    state = dict(e=e, rowend=rowend, el=el, ops_sorted=ops_sorted,
                 p0=p0, su=su, sa=sa, src=src, pend=pend,
                 b_payload=b_payload, b_ind=b_ind, b_dat=b_dat, ad=ad,
                 n_wide_dev=n_wide_dev)
    return nnz_row, rows_sorted, q_sorted, staged, level_out, state


def _emit_pipeline(cfg, G: int, W: int, n_cols: int, pipe, offs,
                   c_cols, c_vals, *, f64: bool = False):
    """Emission pass for one _stream_pipeline result: staged chunks
    scatter their compacted entries (stream_emit); unstaged chunks
    (two-phase, staging budget) re-expand straight into C
    (stream_chunk_numeric — per-chunk transients only, nothing
    retained); retained ladder levels emit their final rows."""
    _, rows_sorted, q_sorted, staged, level_out, st = pipe
    CP = G * W
    zero = jnp.int32(0)
    for c, stg in enumerate(staged):
        if stg is not None:
            c_cols, c_vals = stream_emit(
                rows_sorted, stg[0], stg[1], stg[2], stg[3],
                st["n_wide_dev"], offs, c_cols, c_vals,
                contained_only=True)
        else:
            cs = jnp.int32(c * CP)
            c_cols, c_vals, _ = stream_chunk_numeric(
                rows_sorted, st["e"], st["rowend"], st["p0"], st["su"],
                st["sa"], st["pend"], st["b_payload"], st["b_ind"],
                st["b_dat"], st["ad"], st["src"], offs, c_cols, c_vals,
                cs,
                jnp.searchsorted(st["e"], cs).astype(jnp.int32),
                jnp.searchsorted(st["p0"], cs).astype(jnp.int32),
                st["n_wide_dev"], G=G, W=W, n_cols=n_cols, pack_bits=0,
                stage_wide=False, f64=f64,
                compact_impl=cfg.stream_compact_impl)
    for rid_out, col_c, val_c, fcnt in level_out:
        rid_b = jnp.broadcast_to(rid_out[:, None], col_c.shape)
        c_cols, c_vals = stream_emit(
            rows_sorted, rid_b, col_c, val_c, fcnt, zero,
            offs, c_cols, c_vals, wide_only=True)
    return c_cols, c_vals


def _ksplit_merge(cfg, p_cols, p_vals, spl_tgt, spl_emit, nnz_row, *,
                  n_split: int, PM: int, Wm: int, n_cols: int):
    """Exchange the k-split partial rows and merge each with ONE
    sort+contract (all of a row's part-rows across all shards land in
    its Wm-wide merge row). The owner takes the counts; returns
    (nnz_row, (spl_emit, col_m, val_m, cnt_m)) for emission."""
    g_c = jax.lax.all_gather(
        p_cols.reshape(n_split, PM), ROW_AXIS)   # (D, n_split, PM)
    g_v = jax.lax.all_gather(p_vals.reshape(n_split, PM), ROW_AXIS)
    D_ax = g_c.shape[0]
    mc = jnp.transpose(g_c, (1, 0, 2)).reshape(n_split, D_ax * PM)
    mv = jnp.transpose(g_v, (1, 0, 2)).reshape(n_split, D_ax * PM)
    if Wm > D_ax * PM:
        mc = jnp.pad(mc, ((0, 0), (0, Wm - D_ax * PM)),
                     constant_values=n_cols)
        mv = jnp.pad(mv, ((0, 0), (0, Wm - D_ax * PM)))
    col_s, val_s = _sort_cols(mc, mv)
    rid_bm = jax.lax.broadcasted_iota(jnp.int32, (n_split, Wm), 0)
    last, run_sum = _contract_rect(rid_bm, col_s, val_s, n_cols)
    _, col_m, val_m, cnt_m = _compact_rect(
        last, rid_bm, col_s, run_sum,
        compact_impl=cfg.stream_compact_impl)
    nnz_row = nnz_row.at[spl_tgt].set(cnt_m, mode="drop",
                                      unique_indices=True)
    return nnz_row, (spl_emit, col_m, val_m, cnt_m)


def _make_shard_body(cfg: SpgemmConfig, m_loc: int, W: int, G: int,
                     n_chunks: int, out_cap: int, n_cols: int,
                     r_wide_max: int = 0, level_specs=(), ks=None,
                     f64: bool = False):
    """The per-shard stream pipeline (traced inside shard_map): analysis,
    planning, chunked count+stage, the wide-row merge-level ladder
    (static depth, host-planned in_maps arrive as sharded args),
    device-side offsets, emission. W stays at the configured chunk
    width regardless of skew — a wide row owns whole rectangle rows and
    the ladder finishes it, exactly like the single-chip path
    (ops/spgemm._run_wide) but with the level schedule shipped as data."""
    val_dtype = jnp.float64 if f64 else jnp.float32

    def _pipeline(ai, ax, ad, b_start, b_len, b_payload, wide_rid,
                  level_args, specs, m: int, n_ch: int, rw_max: int,
                  row_mask=None, emit_to=None):
        return _stream_pipeline(
            cfg, G, W, n_cols, ai, ax, ad, b_start, b_len, b_payload,
            wide_rid, level_args, specs, m=m, n_ch=n_ch, rw_max=rw_max,
            row_mask=row_mask, f64=f64, emit_to=emit_to)

    def shard_body(ai, ax, ad, b_start, b_len, b_payload, wide_rid,
                   *level_args):
        zero = jnp.int32(0)
        n_main = 2 * len(level_specs)
        main_lv = [x[0] for x in level_args[:n_main]]
        pipe = _pipeline(ai, ax, ad, b_start, b_len, b_payload,
                         wide_rid[0], main_lv, level_specs, m_loc,
                         n_chunks, r_wide_max)
        nnz_row = pipe[0]

        # ---- k-split rows: local partials over the shard's OWN B rows,
        # all_gather + one merge sort, owner counts/emits (the mesh form
        # of the reference's global-map multi-pass for one row,
        # spECK_HashSpGEMM.cuh:106-126). The partial offsets are STATIC
        # (row i at i*P), so the sub-pipeline emits incrementally —
        # nothing staged beyond the partial buffers themselves. ----
        merged = None
        if ks is not None:
            n_split, n_rows = ks["n_split"], ks["n_rows"]
            P, PM, Wm = ks["P"], ks["PM"], ks["Wm"]
            rest = level_args[n_main:]
            si, sx, sv = rest[0][0], rest[1][0], rest[2][0]
            spl_tgt, spl_emit = rest[3][0], rest[4][0]
            spl_wrid = rest[5]
            spl_lv = [x[0] for x in rest[6:]]
            offs_p = jnp.arange(n_rows + 1, dtype=jnp.int32) * P
            p_cols = jnp.full((n_rows * P,), n_cols, jnp.int32)
            p_vals = jnp.zeros((n_rows * P,), val_dtype)
            _, p_cols, p_vals = _pipeline(
                si, sx, sv, b_start, b_len, b_payload, spl_wrid[0],
                spl_lv, ks["specs"], n_rows, ks["n_chunks"],
                ks["rw_max"], emit_to=(offs_p, p_cols, p_vals))
            nnz_row, merged = _ksplit_merge(
                cfg, p_cols, p_vals, spl_tgt, spl_emit, nnz_row,
                n_split=n_split, PM=PM, Wm=Wm, n_cols=n_cols)

        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), cumsum1d(nnz_row)])
        c_cols = jnp.zeros((out_cap,), jnp.int32)
        c_vals = jnp.zeros((out_cap,), val_dtype)
        c_cols, c_vals = _emit_pipeline(cfg, G, W, n_cols, pipe, offs,
                                        c_cols, c_vals, f64=f64)
        if merged is not None:
            spl_emit, col_m, val_m, cnt_m = merged
            rid_e = jnp.broadcast_to(spl_emit[:, None], col_m.shape)
            ident = jnp.arange(m_loc, dtype=jnp.int32)
            c_cols, c_vals = stream_emit(
                ident, rid_e, col_m, val_m, cnt_m, zero,
                offs, c_cols, c_vals, wide_only=True)
        return nnz_row[None], c_cols[None], c_vals[None]

    return shard_body


# ---------------------------------------------------------------------------
# Mesh (sparse-)DIA route: diagonal-plane convolution sharded over rows
# with a fixed tiny halo exchange
#
# The single-chip (s)DIA fast path (ops/dia.py) is already row-blocked;
# here the row blocks are mesh shards. Each shard builds its LOCAL A and
# B diagonal planes, receives only the <= span_A halo rows of B's planes
# from its two ring neighbors (two ppermutes of (nd_b, halo) slices —
# fixed, tiny, data-independent), and runs the offset-list convolution
# over its row block. No gathers, no sorts, no need-set machinery: the
# banded/stencil class's whole exchange is the halo. This is the
# reference's dense-mode selection (spECK_HashSpGEMM.cuh:1761-1793)
# hoisted across devices; ineligible inputs fall through to the stream.
# ---------------------------------------------------------------------------


def _mesh_sdia_gate(ash: RowShards, bsh: RowShards, cfg: SpgemmConfig,
                    total_ops: float, D: int):
    """Host eligibility for the mesh DIA route, from per-shard local
    metadata only (multi-controller safe: extremes and the offset
    bitmaps combine across processes). Mirrors the single-chip gates
    (ops/spgemm._sdia_gate): square same-sharding operands, band range
    within sdia_span_cap, nd_a*nd_b within sdia_pair_cap, work within
    dia_waste_cap of the true product count, halo from ring neighbors
    only. Returns dict(off_a, off_b, dmin_a, dmin_b) or None."""
    if not cfg.enable_sdia:
        return None
    m, k = ash.m, bsh.m
    if m != k or ash.ranges_ is not None or bsh.ranges_ is not None:
        return None            # square, equal-count sharding only
    m_loc = max(1, -(-m // D))

    def extremes(sh):
        lo = np.full(1, np.iinfo(np.int64).max, np.int64)
        hi = np.full(1, np.iinfo(np.int64).min, np.int64)
        for d, sl in sh.local.items():
            ip = np.asarray(sl.row_offsets, np.int64)
            ln = ip[1:] - ip[:-1]
            ne = ln > 0
            if not ne.any():
                continue
            r0 = sh.ranges[d][0]
            rid = np.arange(sl.rows, dtype=np.int64) + r0
            ci = np.asarray(sl.col_ids, np.int64)
            first = ci[np.minimum(ip[:-1], max(ci.size - 1, 0))] - rid
            last = ci[np.maximum(ip[1:] - 1, 0)] - rid
            lo[0] = min(lo[0], int(first[ne].min()))
            hi[0] = max(hi[0], int(last[ne].max()))
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            lo = -np.max(multihost_utils.process_allgather(-lo), axis=0)
            hi = np.max(multihost_utils.process_allgather(hi), axis=0)
        return int(lo[0]), int(hi[0])

    a_dmin, a_dmax = extremes(ash)
    b_dmin, b_dmax = extremes(bsh)
    if a_dmin > a_dmax or b_dmin > b_dmax:
        return None
    span_a = a_dmax - a_dmin + 1
    span_b = b_dmax - b_dmin + 1
    if span_a > cfg.sdia_span_cap or span_b > cfg.sdia_span_cap:
        return None
    # halo must come from the immediate ring neighbors only
    if max(0, -a_dmin) > m_loc or max(0, a_dmax) > m_loc:
        return None

    def offsets(sh, dmin, span):
        bits = np.zeros(span, np.int64)
        for d, sl in sh.local.items():
            ip = np.asarray(sl.row_offsets, np.int64)
            r0 = sh.ranges[d][0]
            rid = np.repeat(np.arange(sl.rows, dtype=np.int64) + r0,
                            ip[1:] - ip[:-1])
            dd = np.asarray(sl.col_ids, np.int64) - rid - dmin
            bits |= np.bincount(dd, minlength=span).astype(bool).astype(
                np.int64)
        bits = _combine_max(bits)
        return np.flatnonzero(bits) + dmin

    off_a = offsets(ash, a_dmin, span_a)
    off_b = (off_a if bsh is ash
             else offsets(bsh, b_dmin, span_b))
    nd_a, nd_b = len(off_a), len(off_b)
    if nd_a * nd_b > cfg.sdia_pair_cap:
        return None
    if m * nd_a * nd_b > cfg.dia_waste_cap * max(total_ops, 1.0):
        return None
    off_c = np.unique(off_a[:, None] + off_b[None, :])
    nd_c = len(off_c)
    # per-shard plane working set (value + hit planes, window, output,
    # staged) within the memory budget and int32 flat-slot range
    win = m_loc + span_a
    if max(nd_a, nd_b, nd_c) * max(m_loc, win) >= 2 ** 31:
        return None
    per_shard = 4 * (2 * nd_a * m_loc + 2 * nd_b * win
                     + 2 * nd_c * m_loc + 3 * nd_c * m_loc)
    if per_shard > cfg.dia_mem_budget:
        return None
    return dict(off_a=tuple(int(x) for x in off_a),
                off_b=tuple(int(x) for x in off_b),
                off_c=tuple(int(x) for x in off_c),
                dmin_a=a_dmin, dmin_b=b_dmin,
                span_a=span_a, span_b=span_b)


def _mesh_sdia_spgemm(ash: RowShards, bsh: RowShards, mesh: Mesh,
                      cfg: SpgemmConfig, sd: dict, dtype, b_nnz: int):
    """Execute the mesh DIA route (see section comment). Output format
    matches the stream mesh ((nnz_row, cols, vals, meta), assembled by
    mesh_stream_to_host_csr)."""
    from ..ops.dia import _rank_compact, sdia_lut
    from ..ops.dia import SDIA_ROW_BLOCK

    D = mesh.devices.size
    m, n = ash.m, bsh.n
    m_loc = max(1, -(-m // D))
    off_a, off_b, off_c = sd["off_a"], sd["off_b"], sd["off_c"]
    nd_a, nd_b, nd_c = len(off_a), len(off_b), len(off_c)
    dmin_a, dmin_b = sd["dmin_a"], sd["dmin_b"]
    halo_l = max(0, -min(off_a))
    halo_r = max(0, max(off_a))
    win = halo_l + m_loc + halo_r
    lut_a = np.asarray(sdia_lut(np.asarray(off_a), dmin_a,
                                sd["span_a"]))
    lut_b = np.asarray(sdia_lut(np.asarray(off_b), dmin_b,
                                sd["span_b"]))
    oc_index = {dd: i for i, dd in enumerate(off_c)}
    groups: dict = {}
    for ia, da in enumerate(off_a):
        for ib, db in enumerate(off_b):
            groups.setdefault(oc_index[da + db], []).append((ia, da, ib))
    same = bsh is ash
    ai_h, ax_h, ad_h, a_ranges = _stack_shards(ash, dtype)
    bi_h, bx_h, bd_h, _ = ((ai_h, ax_h, ad_h, a_ranges) if same
                           else _stack_shards(bsh, dtype))
    r0s = np.array([r0 for r0, _ in a_ranges], np.int32).reshape(D, 1)
    out_cap = _pow2ceil(max(m_loc * nd_c, 1))
    # row blocks bound the unrolled pair FMAs' temps (ops/dia.py)
    blk = min(m_loc, SDIA_ROW_BLOCK)
    nblk = -(-m_loc // blk)

    def put(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P(ROW_AXIS))
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    lutA_d = jnp.asarray(lut_a)
    lutB_d = jnp.asarray(lut_b)
    doffs = jnp.asarray(np.asarray(off_c, np.int32))

    def planes(ip, cx, cd, r0_, lut, dmin, nd):
        nnz_pad = cx.shape[0]
        live = jnp.arange(nnz_pad, dtype=jnp.int32) < ip[-1]
        marks = jnp.zeros((nnz_pad,), jnp.int32).at[ip[1:-1]].add(
            1, mode="drop")
        rid = cumsum1d(marks)
        dd = jnp.clip(cx - (rid + r0_) - jnp.int32(dmin), 0,
                      lut.shape[0] - 1)
        slot = jnp.where(live, lut[dd] * jnp.int32(m_loc) + rid,
                         jnp.int32(nd * m_loc))
        val = jnp.zeros((nd * m_loc,), cd.dtype).at[slot].add(
            jnp.where(live, cd, 0), mode="drop").reshape(nd, m_loc)
        hit = jnp.zeros((nd * m_loc,), jnp.float32).at[slot].add(
            jnp.where(live, 1.0, 0.0), mode="drop").reshape(nd, m_loc)
        return val, hit

    def step(ai, ax, ad, bi, bx, bd, r0):
        ai_, ax_, ad_ = ai[0], ax[0], ad[0]
        bi_, bx_, bd_ = bi[0], bx[0], bd[0]
        r0_ = r0[0, 0]
        av, ahit = planes(ai_, ax_, ad_, r0_, lutA_d, dmin_a, nd_a)
        if same:
            bv, bhit = av, ahit
        else:
            bv, bhit = planes(bi_, bx_, bd_, r0_, lutB_d, dmin_b, nd_b)

        # ring halo exchange: left halo rows from shard d-1, right from
        # d+1. Wrapped garbage at the mesh edges is harmless: it only
        # ever multiplies zero A-plane entries (rows outside the band /
        # pad rows have no A nonzeros).
        def window(pl):
            parts = []
            if halo_l:
                parts.append(jax.lax.ppermute(
                    pl[:, m_loc - halo_l:], ROW_AXIS,
                    [(s, (s + 1) % D) for s in range(D)]))
            parts.append(pl)
            if halo_r:
                parts.append(jax.lax.ppermute(
                    pl[:, :halo_r], ROW_AXIS,
                    [(s, (s - 1) % D) for s in range(D)]))
            return jnp.concatenate(parts, axis=1) if len(parts) > 1 \
                else pl

        bw_v = window(bv)
        bw_h = window(bhit)
        # pad to whole row blocks so every block slice is in range
        m_pad = nblk * blk
        if m_pad > m_loc:
            pw = ((0, 0), (0, m_pad - m_loc))
            av, ahit = jnp.pad(av, pw), jnp.pad(ahit, pw)
            bw_v, bw_h = jnp.pad(bw_v, pw), jnp.pad(bw_h, pw)
        # blocked list-offset convolution (ops/dia.py sdia_conv pattern):
        # window position of C local row i, pair offset da = halo_l + i
        # + da; all slice starts static per (block, pair)
        pieces_v, pieces_h = [], []
        for bidx in range(nblk):
            rb0 = bidx * blk
            acc_v, acc_h = [], []
            a_blk = jax.lax.slice(av, (0, rb0), (nd_a, rb0 + blk))
            ah_blk = jax.lax.slice(ahit, (0, rb0), (nd_a, rb0 + blk))
            for oc in range(nd_c):
                vv = jnp.zeros((blk,), ad_.dtype)
                hh = jnp.zeros((blk,), jnp.float32)
                for ia, da, ib in groups.get(oc, ()):
                    s0 = halo_l + rb0 + da
                    bwv = jax.lax.slice(bw_v, (ib, s0),
                                        (ib + 1, s0 + blk))[0]
                    bwh = jax.lax.slice(bw_h, (ib, s0),
                                        (ib + 1, s0 + blk))[0]
                    vv = vv + a_blk[ia] * bwv
                    hh = hh + ah_blk[ia] * bwh
                acc_v.append(vv)
                acc_h.append(hh)
            pieces_v.append(jnp.stack(acc_v))
            pieces_h.append(jnp.stack(acc_h))
        c_val = (jnp.concatenate(pieces_v, axis=1) if nblk > 1
                 else pieces_v[0])[:, :m_loc]
        c_cnt = (jnp.concatenate(pieces_h, axis=1) if nblk > 1
                 else pieces_h[0])[:, :m_loc]

        cvT = c_val.T
        present = c_cnt.T > 0.5     # exact: fp32 counts of 1.0 adds
        counts = jnp.sum(present, axis=1, dtype=jnp.int32)
        # doffs gives the diagonal; the column is global row + diagonal
        # = (r0 + i) + doffs — _rank_compact adds its LOCAL row iota i,
        # so shift the offsets by r0 (traced scalar, shape-free)
        cols_s, vals_s = _rank_compact(
            cvT, present, sc=nd_c, m=m_loc, n_cols=n, base_c=0,
            impl=cfg.stream_compact_impl, doffs=doffs + r0_)
        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), cumsum1d(counts)])
        j = jax.lax.broadcasted_iota(jnp.int32, (m_loc, nd_c), 1)
        flat = jnp.where(j < counts[:, None], offs[:-1][:, None] + j,
                         out_cap)
        c_cols = jnp.zeros((out_cap,), jnp.int32).at[flat].set(
            cols_s, mode="drop", unique_indices=True)
        c_vals = jnp.zeros((out_cap,), ad_.dtype).at[flat].set(
            vals_s, mode="drop", unique_indices=True)
        return counts[None], c_cols[None], c_vals[None]

    args_ = (put(ai_h), put(ax_h), put(ad_h), put(bi_h), put(bx_h),
             put(bd_h), put(r0s))
    key = ("sdia", _mesh_key(mesh), _cfg_key(cfg), str(jnp.dtype(dtype)),
           m, n, m_loc, off_a, off_b, off_c, dmin_a, dmin_b, blk, nblk,
           out_cap, same, _argsig(args_))
    sharded, reused = _cached_step(key, lambda: jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(ROW_AXIS),) * 7,
        out_specs=(P(ROW_AXIS),) * 3)))
    _set_last_exec(sharded, args_)
    nnz_row, cols, vals = sharded(*args_)
    itemsize = jnp.dtype(dtype).itemsize
    stats = NeedsetStats(
        allgather_bytes=b_nnz * (4 + itemsize),
        needset_bytes=(halo_l + halo_r) * nd_b * 2 * itemsize,
        pairs_nnz=np.zeros((D, D), np.int64),
        mode="dia_halo",
    )
    meta = {"ranges": a_ranges, "out_cap": out_cap, "m_loc": m_loc,
            "shape": (m, n), "stats": stats, "ksplit": None,
            "route": "sdia", "compiled_reused": reused}
    return nnz_row, cols, vals, meta


def _mesh_dense_gate(ash: RowShards, bsh: RowShards, b_len_h: np.ndarray,
                     cfg: SpgemmConfig, D: int):
    """Host eligibility for the mesh dense route, from per-shard
    local metadata only (multi-controller safe, like _mesh_sdia_gate).

    The single-chip dense-tile criteria (ops/dense.py: the analogue of
    spECK's per-block dense-mode select, spECK_HashSpGEMM.cuh:1761-1793)
    hoisted to per-shard row tiles: EVERY non-empty tile of
    ``dense_tile_rows`` consecutive local rows must have A-column span
    <= dense_kw, output-column span <= dense_cw, and per-row lengths
    <= dense_la / dense_lb. Full cover only — a single ineligible tile
    sends the whole multiply to the stream (the mesh has no per-tile
    mixed routing; the single-chip path does).

    Returns dict(kb, cb (D, K) tile window bases, K, kw, cw, la, lb)
    or None. The route replicates B (all_gather), so the caller only
    consults this gate when exchange == "allgather" — under needset the
    stream's exchange plan can move far less than replication (zero for
    block structure) and keeps precedence."""
    if not cfg.enable_dense:
        return None
    tr = cfg.dense_tile_rows
    m_loc = max([1] + [r1 - r0 for r0, r1 in ash.ranges])
    K = -(-m_loc // tr)
    k_dim = bsh.m
    k_loc = max(1, -(-k_dim // D))
    INTM = np.iinfo(np.int64).max

    # global per-B-row first / last+1 column (O(k) ints, owner-combined;
    # empty rows: first = INTM, last+1 = 0 — both max-combine safely)
    bf = np.zeros((D, k_loc), np.int64)
    bl1 = np.zeros((D, k_loc), np.int64)
    for d, sl in bsh.local.items():
        ip = np.asarray(sl.row_offsets, np.int64)
        ci = np.asarray(sl.col_ids, np.int64)
        ln = ip[1:] - ip[:-1]
        ne = ln > 0
        if ci.size:
            f = np.where(ne, ci[np.minimum(ip[:-1], ci.size - 1)], INTM)
            l1 = np.where(ne, ci[np.maximum(ip[1:] - 1, 0)] + 1, 0)
        else:
            f = np.full(sl.rows, INTM, np.int64)
            l1 = np.zeros(sl.rows, np.int64)
        bf[d, : sl.rows] = f
        bl1[d, : sl.rows] = l1
    bf = _combine_max(bf).reshape(-1)[:k_dim]
    bl1 = _combine_max(bl1).reshape(-1)[:k_dim]

    kb = np.zeros((D, K), np.int64)
    cb = np.zeros((D, K), np.int64)
    # [violations, kspan, cspan, la, lb] per shard, owner-combined
    stat = np.zeros((D, 5), np.int64)
    for d, sl in ash.local.items():
        ip = np.asarray(sl.row_offsets, np.int64)
        ci = np.asarray(sl.col_ids, np.int64)
        lens = ip[1:] - ip[:-1]
        ne = lens > 0
        if ci.size:
            afirst = np.where(ne, ci[np.minimum(ip[:-1], ci.size - 1)],
                              INTM)
            alast = np.where(ne, ci[np.maximum(ip[1:] - 1, 0)], -1)
            starts = np.minimum(ip[:-1], ci.size - 1)
            # per-row output range / max referenced-B-row length over the
            # row's B rows (reduceat; empty rows masked — reduceat on an
            # empty segment returns the element at its start)
            rmin = np.minimum.reduceat(bf[ci], starts)
            rmax = np.maximum.reduceat(bl1[ci] - 1, starts)
            rlb = np.maximum.reduceat(b_len_h[ci], starts)
            cmin = np.where(ne, rmin, INTM)
            cmax = np.where(ne, rmax, -1)
            lb_r = np.where(ne, rlb, 0)
        else:
            afirst = np.full(sl.rows, INTM, np.int64)
            alast = np.full(sl.rows, -1, np.int64)
            cmin = np.full(sl.rows, INTM, np.int64)
            cmax = np.full(sl.rows, -1, np.int64)
            lb_r = np.zeros(sl.rows, np.int64)

        def tiles(x, red, fill):
            pad = K * tr - sl.rows
            xp = (np.concatenate([x, np.full(pad, fill, np.int64)])
                  if pad else x)
            return red(xp.reshape(K, tr), axis=1)

        t_kmin = tiles(afirst, np.min, INTM)
        t_kmax = tiles(alast, np.max, -1)
        t_cmin = tiles(cmin, np.min, INTM)
        t_cmax = tiles(cmax, np.max, -1)
        t_la = tiles(lens, np.max, 0)
        t_lb = tiles(lb_r, np.max, 0)
        live = t_kmax >= 0
        kspan = np.where(live, t_kmax - t_kmin + 1, 0)
        # output-empty tiles (all products vanish) keep cspan 0
        cspan = np.where(live & (t_cmax >= 0), t_cmax - t_cmin + 1, 0)
        bad = live & ((kspan > cfg.dense_kw) | (cspan > cfg.dense_cw)
                      | (t_la > cfg.dense_la) | (t_lb > cfg.dense_lb))
        stat[d] = [int(bad.sum()), int(kspan.max(initial=0)),
                   int(cspan.max(initial=0)), int(t_la.max(initial=0)),
                   int(t_lb.max(initial=0))]
        kb[d] = np.where(live, t_kmin, 0)
        cb[d] = np.where(live & (t_cmax >= 0), t_cmin, 0)
    stat = _combine_max(stat)
    kb = _combine_max(kb)
    cb = _combine_max(cb)
    if int(stat[:, 0].max(initial=0)) > 0:
        return None

    def up(x, q, lo):
        return max(lo, -(-int(x) // q) * q)

    kw = up(stat[:, 1].max(initial=1), 128, 128)
    cw = up(stat[:, 2].max(initial=1), 128, 128)
    la = up(stat[:, 3].max(initial=1), 8, 8)
    lb = up(stat[:, 4].max(initial=1), 8, 8)
    # per-shard working set (dense windows, matmul outputs, staged rows,
    # padded output) within the memory budget
    out_cap = _pow2ceil(max(1, m_loc * cw))
    bytes_ = 4 * (2 * K * tr * kw + 2 * K * kw * cw + 4 * K * tr * cw
                  + K * tr * (la + lb)) + out_cap * 12
    if bytes_ > cfg.dia_mem_budget:
        return None
    return dict(kb=kb.astype(np.int32), cb=cb.astype(np.int32), K=K,
                kw=kw, cw=cw, la=la, lb=lb)


def _mesh_dense_spgemm(ash: RowShards, bsh: RowShards, mesh: Mesh,
                       cfg: SpgemmConfig, dn: dict, dtype, b_nnz: int):
    """Execute the mesh dense route: B replicated by all_gather,
    every shard runs its row tiles as densify -> batched matmul
    (values + exact bf16 pattern counts) -> rank-sort compaction —
    ops/dense.dense_tiles restructured for the SPMD body (local A,
    gathered B addressed shard-by-shard). Output format matches the
    stream mesh ((nnz_row, cols, vals, meta) for
    mesh_stream_to_host_csr)."""
    from ..ops.dense import _densify_scatter, _densify_sorted

    D = mesh.devices.size
    m, n = ash.m, bsh.n
    k_dim = bsh.m
    tr, K = cfg.dense_tile_rows, dn["K"]
    kw, cw, la, lb = dn["kw"], dn["cw"], dn["la"], dn["lb"]
    ai_h, ax_h, ad_h, a_ranges = _stack_shards(ash, dtype)
    bi_h, bx_h, bd_h, _ = _stack_shards(bsh, dtype)
    bnnz_max = bx_h.shape[1]
    m_loc = ai_h.shape[1] - 1
    rows_d = np.array([[r1 - r0] for r0, r1 in a_ranges], np.int32)
    out_cap = _pow2ceil(max(1, m_loc * cw))
    _dens = (_densify_scatter if cfg.dense_densify == "scatter"
             else _densify_sorted)

    def put(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P(ROW_AXIS))
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    def step(ai, ax, ad, bi, bx, bd, kb, cb, rdv):
        ai_, ax_, ad_ = ai[0], ax[0], ad[0]
        kb_, cb_, nrows = kb[0], cb[0], rdv[0, 0]
        # ---- B replication: per-shard payloads concatenate with pad
        # gaps; global row q lives in shard q // k_loc at local offset
        # q - shard*k_loc, so (start, len) come straight from the
        # gathered indptrs (the run_allgather addressing)
        g_indptr = jax.lax.all_gather(bi[0], ROW_AXIS)      # (D, k_loc+1)
        g_cols = jax.lax.all_gather(bx[0], ROW_AXIS).reshape(-1)
        g_vals = jax.lax.all_gather(bd[0], ROW_AXIS).reshape(-1)
        base = jnp.arange(D, dtype=jnp.int32)[:, None] * bnnz_max
        b_start = (g_indptr[:, :-1] + base).reshape(-1)
        b_len = (g_indptr[:, 1:] - g_indptr[:, :-1]).reshape(-1)

        # ---- A side: (K*tr, la) rectangles -> (K*tr, kw) dense windows
        rows = (jnp.arange(K, dtype=jnp.int32)[:, None] * tr
                + jnp.arange(tr, dtype=jnp.int32)[None, :]).reshape(-1)
        vrow = rows < nrows
        r = jnp.where(vrow, rows, 0)
        p0 = ai_[r]
        ln = jnp.where(vrow, ai_[r + 1] - p0, 0)
        j = jnp.arange(la, dtype=jnp.int32)[None, :]
        alive = j < ln[:, None]
        idx = jnp.where(alive, p0[:, None] + j, 0)
        acol = jnp.where(alive, ax_[idx], 0)
        aval = jnp.where(alive, ad_[idx], 0)
        kb_row = jnp.repeat(kb_, tr)
        kloc = jnp.where(alive, acol - kb_row[:, None], kw)
        A_dense, A_hit = _dens(kloc, aval, kw)

        # ---- B side: (K*kw, lb) rectangles over the tiles' k-windows.
        # Window rows the shard's A never references multiply zero
        # A_dense columns, so their values are harmless
        ks = (kb_[:, None]
              + jnp.arange(kw, dtype=jnp.int32)[None, :]).reshape(-1)
        vk = ks < k_dim
        kq = jnp.where(vk, ks, 0)
        q0 = b_start[kq]
        qln = jnp.where(vk, b_len[kq], 0)
        jb = jnp.arange(lb, dtype=jnp.int32)[None, :]
        blive = jb < qln[:, None]
        bidx = jnp.where(blive, q0[:, None] + jb, 0)
        bcol = jnp.where(blive, g_cols[bidx], 0)
        bval = jnp.where(blive, g_vals[bidx], 0)
        cb_k = jnp.repeat(cb_, kw)
        cloc = jnp.where(blive, bcol - cb_k[:, None], cw)
        B_dense, B_hit = _dens(cloc, bval, cw)

        # ---- matmuls: values at precision=HIGHEST (f32 on a GPU, not
        # TF32); exact structural counts (bf16 pattern matmul, counts
        # <= dense_la <= 256 — the presence bitmap analogue,
        # spECK_HashSpGEMM.cuh:1210-1233)
        A3 = A_dense.reshape(K, tr, kw)
        B3 = B_dense.reshape(K, kw, cw)
        C_vals = jnp.einsum(
            "abk,akc->abc", A3, B3,
            precision=jax.lax.Precision.HIGHEST).reshape(K * tr, cw)
        C_cnt = jnp.einsum(
            "abk,akc->abc",
            A_hit.reshape(K, tr, kw).astype(jnp.bfloat16),
            B_hit.reshape(K, kw, cw).astype(jnp.bfloat16),
            preferred_element_type=jnp.float32).reshape(K * tr, cw)

        cb_row = jnp.repeat(cb_, tr)
        tcw = jnp.arange(cw, dtype=jnp.int32)[None, :]
        present = ((C_cnt > 0.5) & vrow[:, None]
                   & ((cb_row[:, None] + tcw) < n))
        # rank-sort compaction: rows come out column-sorted for free
        rank = jnp.cumsum(present.astype(jnp.int32), axis=1) - 1
        key = jnp.where(present, rank, cw + tcw)
        cols_g = jnp.where(present, cb_row[:, None] + tcw, n)
        _, cols_c, vals_c = jax.lax.sort(
            (key, cols_g, C_vals), dimension=1, num_keys=1)

        counts = jnp.sum(present, axis=1, dtype=jnp.int32)[:m_loc]
        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), cumsum1d(counts)])
        jj = jax.lax.broadcasted_iota(jnp.int32, (m_loc, cw), 1)
        flat = jnp.where(jj < counts[:, None], offs[:-1][:, None] + jj,
                         out_cap)
        c_cols = jnp.zeros((out_cap,), jnp.int32).at[flat].set(
            cols_c[:m_loc], mode="drop", unique_indices=True)
        c_vals = jnp.zeros((out_cap,), ad_.dtype).at[flat].set(
            vals_c[:m_loc], mode="drop", unique_indices=True)
        return counts[None], c_cols[None], c_vals[None]

    args_ = (put(ai_h), put(ax_h), put(ad_h), put(bi_h), put(bx_h),
             put(bd_h), put(dn["kb"]), put(dn["cb"]), put(rows_d))
    key = ("dense", _mesh_key(mesh), _cfg_key(cfg),
           str(jnp.dtype(dtype)), m, n, k_dim, tr, K, kw, cw, la, lb,
           m_loc, out_cap, bnnz_max, _argsig(args_))
    sharded, reused = _cached_step(key, lambda: jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(ROW_AXIS),) * 9,
        out_specs=(P(ROW_AXIS),) * 3)))
    _set_last_exec(sharded, args_)
    nnz_row, cols, vals = sharded(*args_)
    itemsize = jnp.dtype(dtype).itemsize
    rep = b_nnz * (4 + itemsize)
    stats = NeedsetStats(allgather_bytes=rep, needset_bytes=rep,
                         pairs_nnz=np.zeros((D, D), np.int64),
                         mode="dense_allgather")
    meta = {"ranges": a_ranges, "out_cap": out_cap, "m_loc": m_loc,
            "shape": (m, n), "stats": stats, "ksplit": None,
            "route": "dense", "compiled_reused": reused}
    return nnz_row, cols, vals, meta


def mesh_stream_spgemm(
    a,
    b,
    mesh: Mesh,
    cfg: Optional[SpgemmConfig] = None,
    exchange: str = "allgather",
    dtype=jnp.float32,
):
    """C = A @ B as ONE jitted SPMD step over ``mesh`` (see module
    docstring). Returns (nnz_row, cols, vals, meta): padded row-major
    per-shard outputs; assemble with ``mesh_stream_to_host_csr``.

    ``a`` / ``b``: HostCSR (full matrix on this host), or RowShards
    (pre-sharded: this process holds only its own devices' row shards;
    cross-shard host metadata is exchanged as small padded arrays and
    the need-set exchange plan is computed on device, so no process
    ever needs the full payloads).

    ``dtype``: jnp.float32 (packed 8-byte B records) or jnp.float64
    (12-byte records, requires jax x64 — the mesh form of the
    reference's primary Executor<double>, source/runspECK.cpp:21)."""
    D = mesh.devices.size
    cfg = cfg or SpgemmConfig()
    f64 = jnp.dtype(dtype) == jnp.dtype(jnp.float64)
    np_dtype = np.float64 if f64 else np.float32
    CH = 3 if f64 else 2           # payload channels: col + value words
    rec_bytes = 4 * CH
    bsh = b if isinstance(b, RowShards) else RowShards.from_global(b, D)
    if bsh.ranges_ is not None:
        eq = RowShards(m=bsh.m, n=bsh.n, D=bsh.D, local={}).ranges
        if list(map(tuple, bsh.ranges)) != eq:
            raise ValueError(
                "B must be sharded in equal ceil(m/D) row blocks (the "
                "owner arithmetic col // k_loc depends on it); only A "
                "supports ops-balanced ranges")
    b_len_h = _shard_row_lens(bsh)
    b_nnz = int(b_len_h.sum())
    if isinstance(a, RowShards):
        ash = a
    elif cfg.mesh_balance_rows:
        # ops-balanced contiguous A partition: the
        # heavy rows of a power-law matrix no longer pin the shared
        # n_chunks to one overloaded shard. Gate: only move boundaries
        # when equal-count ranges are actually imbalanced (>1.25x max/
        # mean) — aligned structure (block-diagonal inputs) keeps its
        # zero-communication boundaries.
        ops_full = _host_row_ops(a, b_len_h)
        w = np.maximum(ops_full, cfg.stream_min_q)
        eq = RowShards(m=a.rows, n=a.cols, D=D, local={}).ranges
        eq_tot = np.array([int(w[r0:r1].sum()) for r0, r1 in eq])
        mean_w = max(float(eq_tot.mean()), 1.0)
        if float(eq_tot.max(initial=0)) > 1.25 * mean_w:
            ash = RowShards.from_global(
                a, D, ranges=balanced_row_ranges(ops_full, D,
                                                 cfg.stream_min_q))
        else:
            ash = RowShards.from_global(a, D)
    else:
        ash = RowShards.from_global(a, D)
    if ash.D != D or bsh.D != D:
        raise ValueError(
            f"RowShards built for D={ash.D}/{bsh.D}, mesh has {D}")
    if ash.n != bsh.m:
        raise ValueError(
            f"dimension mismatch: A is {(ash.m, ash.n)}, "
            f"B is {(bsh.m, bsh.n)}")
    if exchange not in ("allgather", "needset", "needset_overlap"):
        raise ValueError(f"unknown exchange mode {exchange!r}")
    n_cols = bsh.n

    # per-shard row ops (owners compute, combined): the host analysis
    # all static shapes derive from — O(m) metadata, no payloads
    a_ranges0 = ash.ranges
    m_locA = max([1] + [r1 - r0 for r0, r1 in a_ranges0])
    ops_sh = np.zeros((D, m_locA), np.int64)
    for d, sl in ash.local.items():
        o = _host_row_ops(sl, b_len_h)
        ops_sh[d, : o.shape[0]] = o
    ops_sh = _combine_max(ops_sh)

    # ---- mesh (s)DIA route: banded/stencil inputs take the diagonal-
    # plane convolution with a fixed tiny halo exchange instead of the
    # stream (same host gates as the single-chip route; the ``exchange``
    # argument is moot — the halo IS the exchange) ----
    sd = _mesh_sdia_gate(ash, bsh, cfg, float(ops_sh.sum()), D)
    if sd is not None:
        return _mesh_sdia_spgemm(ash, bsh, mesh, cfg, sd, dtype, b_nnz)

    # ---- mesh dense route: tile-bounded inputs run densify +
    # batched matmuls per shard. B is replicated, so the gate is only
    # consulted when the caller already chose replication (allgather);
    # under needset the exchange plan's (possibly zero) communication
    # keeps precedence over matmul throughput ----
    if exchange == "allgather":
        dn = _mesh_dense_gate(ash, bsh, b_len_h, cfg, D)
        if dn is not None:
            return _mesh_dense_spgemm(ash, bsh, mesh, cfg, dn, dtype,
                                      b_nnz)

    # k-split rows (single-row sharding): removed from their owner's
    # local A, their slots re-dealt by B-row owner (_plan_ksplit_shards)
    k_locB = max(1, -(-bsh.m // D))
    ash_eff, ops_sh, ksp = _plan_ksplit_shards(
        ash, ops_sh, b_len_h, D, k_locB, cfg.mesh_split_min_ops,
        cfg.mesh_subrow_max_ops, np_dtype)

    ai_h, ax_h, ad_h, a_ranges = _stack_shards(ash_eff, dtype)
    m_loc = ai_h.shape[1] - 1

    def _pack_payload(bx_, bd_):
        if f64:
            return jnp.concatenate(
                [bx_[:, None],
                 jax.lax.bitcast_convert_type(bd_, jnp.int32)], axis=-1)
        return pack_csr_arrays(bx_, bd_)

    # per-shard stream shape parameters (host analysis; SPMD needs one
    # static shape across shards). W stays at the configured chunk width
    # regardless of skew: rows wider than W own whole rectangle rows and
    # the in-SPMD merge ladder finishes them (_mesh_wide_plans) — one
    # 10^6-op row no longer inflates every shard's sort width. Per-shard
    # totals use the exact host twin of the device's tight layout.
    min_q = cfg.stream_min_q
    shard_ops = []
    for d, (r0, r1) in enumerate(a_ranges):
        ops = ops_sh[d, : r1 - r0]
        assert not ops.size or int(ops.max(initial=0)) <= 2 ** 30, \
            "post-split row past 2^30 (unreachable: _plan_ksplit_shards)"
        shard_ops.append(ops)
    W = cfg.stream_width
    total_qs = []
    for (r0, r1), ops in zip(a_ranges, shard_ops):
        total_qs.append(tight_total_host(ops, W, min_q))
        if total_qs[-1] >= 2 ** 31:
            raise ValueError(
                f"shard rows {r0}:{r1} pack to {total_qs[-1]} stream "
                "slots, past the 2^31 int32 ceiling; use more shards")
    G = max(1, cfg.product_budget // W)
    # exact-size G (mirrors plan_layout): when every shard's
    # stream fits one chunk, the full budget rectangle left up to ~27x
    # dead slots at small scales — size the chunk to the largest
    # shard's live rect rows (multiple of 8). The k-split sub-pipeline
    # shares CP, so its totals join the sizing.
    need = -(-max(total_qs + [1]) // W)
    if ksp is not None:
        need = max(need, -(-max(
            [tight_total_host(ksp["sub_ops"][s], W, min_q)
             for s in range(D)] + [1]) // W))
    if need < G:
        G = max(8, -(-need // 8) * 8) if need > 8 else max(1, need)
    CP = G * W
    n_chunks = max(1, -(-max(total_qs + [1]) // CP))
    out_cap_base = max(total_qs + [1])
    r_wide_max, wide_rid_h, level_specs = _mesh_wide_plans(
        shard_ops, W, cfg.stream_level_factor, cfg.stream_max_width,
        n_cols=n_cols)

    # ---- k-split static parameters ----
    ks = None
    if ksp is not None:
        n_split, n_rows = ksp["n_split"], ksp["n_rows"]
        max_parts = ksp["max_parts"]
        sub_ops = ksp["sub_ops"]            # (D, n_rows) per part-row
        tq_s = [tight_total_host(sub_ops[s], W, min_q) for s in range(D)]
        if max(tq_s) >= 2 ** 31:
            raise ValueError(
                f"a k-split shard packs to {max(tq_s)} stream slots, "
                "past the 2^31 int32 ceiling; use more shards")
        rw_max_s, spl_wide_rid_h, spl_specs = _mesh_wide_plans(
            [sub_ops[s] for s in range(D)], W,
            cfg.stream_level_factor, cfg.stream_max_width,
            n_cols=n_cols)
        P_spl = _pow2ceil(max(1, min(n_cols, int(sub_ops.max(initial=1)))))
        PM = max_parts * P_spl
        Wm = _pow2ceil(D * PM)
        # owner shard / local row of each split row; non-owners drop
        spl_tgt_h = np.full((D, n_split), m_loc, np.int32)
        spl_emit_h = np.full((D, n_split), -1, np.int32)
        out_extra = np.zeros(D, np.int64)
        for j, r in enumerate(ksp["split_ids"]):
            for s, (r0, r1) in enumerate(a_ranges):
                if r0 <= r < r1:
                    spl_tgt_h[s, j] = r - r0
                    spl_emit_h[s, j] = r - r0
                    out_extra[s] += min(n_cols, D * PM)
        ks = dict(n_split=n_split, n_rows=n_rows, P=P_spl, PM=PM,
                  Wm=Wm, n_chunks=max(1, -(-max(tq_s + [1]) // CP)),
                  rw_max=rw_max_s, specs=spl_specs)
        out_cap_base += int(out_extra.max(initial=0))
    out_cap = _pow2ceil(out_cap_base)
    body = _make_shard_body(cfg, m_loc, W, G, n_chunks, out_cap, n_cols,
                            r_wide_max=r_wide_max,
                            level_specs=level_specs, ks=ks, f64=f64)
    # static signature of the shard body for the compiled-step cache
    # (everything that shapes its trace beyond the arg shapes)
    ks_key = None if ks is None else (
        ks["n_split"], ks["n_rows"], ks["P"], ks["PM"], ks["Wm"],
        ks["n_chunks"], ks["rw_max"], _specs_key(ks["specs"]))
    body_key = (m_loc, W, G, n_chunks, out_cap, n_cols, r_wide_max,
                _specs_key(level_specs), ks_key, f64)
    compiled_reused = False

    def put(x):
        # make_array_from_callback works identically under one controller
        # and under multi-process (jax.distributed): every process holds
        # the same full host array and each only materializes the shards
        # its local devices own (addressable-shard assembly).
        x = np.asarray(x)
        sh = NamedSharding(mesh, P(ROW_AXIS))
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    stats = None

    def extra_args(spl_cols_arr):
        """wide_rid + main level maps (+ the split pipeline's inputs;
        spl_cols_arr is mode-specific: global B row ids under allgather,
        received-buffer slots under needset)."""
        args = [put(wide_rid_h)]
        for spec in level_specs:
            args.append(put(spec["in_map"]))
            args.append(put(spec["final"]))
        if ksp is not None:
            args += [put(ksp["spl_indptr"].astype(np.int32)),
                     (spl_cols_arr if isinstance(spl_cols_arr, jax.Array)
                      else put(np.asarray(spl_cols_arr, np.int32))),
                     put(ksp["spl_vals"]),
                     put(spl_tgt_h), put(spl_emit_h),
                     put(spl_wide_rid_h)]
            for spec in ks["specs"]:
                args.append(put(spec["in_map"]))
                args.append(put(spec["final"]))
        return args

    n_ladder = (1 + 2 * len(level_specs)
                + ((6 + 2 * len(ks["specs"])) if ksp is not None else 0))

    def run_allgather():
        nonlocal compiled_reused
        bi_h, bx_h, bd_h, _ = _stack_shards(bsh, dtype)
        bnnz_max = bx_h.shape[1]

        def step(ai, ax, ad, bi, bx, bd, wide_rid, *lv):
            ai, ax, ad = ai[0], ax[0], ad[0]
            g_indptr = jax.lax.all_gather(bi[0], ROW_AXIS)   # (D, k_loc+1)
            g_packed = jax.lax.all_gather(
                _pack_payload(bx[0], bd[0]), ROW_AXIS).reshape(-1, CH)
            base = jnp.arange(D, dtype=jnp.int32)[:, None] * bnnz_max
            b_start = (g_indptr[:, :-1] + base).reshape(-1)
            b_len = (g_indptr[:, 1:] - g_indptr[:, :-1]).reshape(-1)
            return body(ai, ax, ad, b_start, b_len, g_packed, wide_rid,
                        *lv)

        args_ = (put(ai_h), put(ax_h), put(ad_h), put(bi_h), put(bx_h),
                 put(bd_h),
                 *extra_args(ksp["spl_cols"] if ksp is not None
                             else None))
        key = ("stream_ag", _mesh_key(mesh), _cfg_key(cfg),
               str(jnp.dtype(dtype)), body_key, bnnz_max, n_ladder,
               _argsig(args_))
        sharded, reused = _cached_step(
            key, lambda: jax.jit(jax.shard_map(
                step, mesh=mesh,
                in_specs=(P(ROW_AXIS),) * (6 + n_ladder),
                out_specs=(P(ROW_AXIS),) * 3)))
        compiled_reused = reused
        _set_last_exec(sharded, args_)
        return sharded(*args_)

    if exchange == "allgather":
        nnz_row, cols, vals = run_allgather()
    else:
        k_loc = max(1, -(-bsh.m // D))
        if cfg.mesh_device_planning:
            # ---- need-set exchange plan (DEVICE; see the planner
            # section above). Host work is O(D^2) scalars only.
            nnz_d_h = np.asarray(ai_h[:, -1], np.int32)
            dp = _plan_needset_device(
                ax_h, nnz_d_h,
                ksp["spl_cols"] if ksp is not None else None,
                ksp["spl_indptr"][:, -1] if ksp is not None else None,
                b_len_h, D, k_loc, put,
                pad_exact=cfg.mesh_round_pad_exact)
            pair_nnz = dp["pair_nnz"]
            round_nnz = dp["round_nnz"]
            seg_off = dp["seg_off"]
            rb_start_a, rb_len_a = dp["rb_start"], dp["rb_len"]
            ax_remap_a = _lut_gather(dp["lut"], put(ax_h))
            spl_cols_remap = (
                _lut_gather(dp["lut"], put(ksp["spl_cols"].astype(
                    np.int32))) if ksp is not None else None)
            live_sends = []
            for si, sv in dp["send_plans"]():
                live_sends.append(si)
                live_sends.append(sv)
        else:
            # ---- need-set exchange plan (host numpy fallback;
            # requires every shard's payload on this host) ----
            if not (ash_eff.all_local and bsh.all_local):
                raise ValueError(
                    "host need-set planning needs the full matrices on "
                    "every process; pre-sharded RowShards inputs require "
                    "MeshDevicePlanning=true (the default)")
            b_off = np.concatenate(
                [[0], np.cumsum(b_len_h)]).astype(np.int64)
            # need set per dst shard: unique B rows referenced by its A
            # cols (plus its k-split slots' cols — those are always
            # self-owned, so they only enlarge the zero-communication
            # round 0)
            needs: List[np.ndarray] = []
            for s, (r0, r1) in enumerate(a_ranges):
                sl = ash_eff.local[s]
                cols_need = np.asarray(sl.col_ids, np.int64)
                if ksp is not None:
                    nz_s = int(ksp["spl_indptr"][s, -1])
                    cols_need = np.concatenate(
                        [cols_need,
                         ksp["spl_cols"][s, :nz_s].astype(np.int64)])
                needs.append(np.unique(cols_need))
            pair_rows = [[nd[(nd // k_loc) == s] for s in range(D)]
                         for nd in needs]
            pair_nnz = np.array([[int(b_len_h[pr].sum()) for pr in row]
                                 for row in pair_rows])
            # round r moves pairs src -> dst=(src+r)%D; round 0 is the
            # local self-need (no communication). Each round pads to its
            # own max.
            _round_max = [max(pair_nnz[(s + r) % D, s] for s in range(D))
                          for r in range(D)]
            round_nnz = [
                (int(mx) if cfg.mesh_round_pad_exact
                 else int(_pow2ceil(int(mx)))) if mx > 0 else 0
                for mx in _round_max]
            seg_off = np.concatenate([[0], np.cumsum(round_nnz)])

            # per-round send gather plan (src-local nnz positions) and,
            # per dst, the received-buffer (start, len) of every needed
            # row
            send_idx = [np.zeros((D, round_nnz[r]), np.int64)
                        for r in range(D)]
            send_valid = [np.zeros((D, round_nnz[r]), bool)
                          for r in range(D)]
            P_rows = int(_pow2ceil(max(1, max(
                len(pr) for row in pair_rows for pr in row))))
            RB = D * P_rows
            rb_start = np.zeros((D, RB), np.int32)
            rb_len = np.zeros((D, RB), np.int32)
            ax_remap = np.array(ax_h)
            spl_cols_remap = (np.array(ksp["spl_cols"])
                              if ksp is not None else None)
            for src in range(D):
                for r in range(D):
                    dst = (src + r) % D
                    rows = pair_rows[dst][src]
                    lens = b_len_h[rows]
                    nz = int(lens.sum())
                    if nz:
                        pos = np.concatenate(
                            [np.arange(b_off[q], b_off[q + 1])
                             for q in rows])
                        send_idx[r][src, :nz] = pos - b_off[src * k_loc]
                        send_valid[r][src, :nz] = True
            for dst in range(D):
                lut = np.zeros(bsh.m, np.int64)
                for src in range(D):
                    r = (dst - src) % D
                    rows = pair_rows[dst][src]
                    lens = b_len_h[rows]
                    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
                    slots = src * P_rows + np.arange(len(rows))
                    rb_start[dst, slots] = seg_off[r] + starts
                    rb_len[dst, slots] = lens
                    lut[rows] = slots
                ax_remap[dst] = lut[np.asarray(ax_h[dst], np.int64)]
                if spl_cols_remap is not None:
                    spl_cols_remap[dst] = lut[
                        np.asarray(ksp["spl_cols"][dst], np.int64)]
            rb_start_a, rb_len_a = put(rb_start), put(rb_len)
            ax_remap_a = put(ax_remap)
            if spl_cols_remap is not None:
                spl_cols_remap = np.asarray(spl_cols_remap, np.int32)
            live_sends = []
            for r in range(D):
                if round_nnz[r] == 0:
                    continue
                live_sends.append(put(send_idx[r].astype(np.int32)))
                live_sends.append(put(send_valid[r]))

        # ---- auto-fallback gate: each round pads to
        # its largest (dst, src) pair (exact by default,
        # MeshRoundPadExact), which can still make a scattered need
        # pattern move MORE bytes than full replication; fall back to
        # all_gather and say so ----
        needset_bytes = int(sum(round_nnz[1:])) * rec_bytes
        allgather_bytes = b_nnz * rec_bytes
        if cfg.mesh_exchange_auto and needset_bytes > allgather_bytes:
            nnz_row, cols, vals = run_allgather()
            stats = NeedsetStats(
                allgather_bytes=allgather_bytes,
                needset_bytes=needset_bytes, pairs_nnz=pair_nnz,
                mode="allgather(auto)")
            meta = {"ranges": a_ranges, "out_cap": out_cap,
                    "m_loc": m_loc, "shape": (ash.m, bsh.n),
                    "stats": stats, "ksplit": _ksplit_meta(ksp),
                    "route": "stream",
                    "compiled_reused": compiled_reused}
            return nnz_row, cols, vals, meta

        _, bx_h, bd_h, _ = _stack_shards(bsh, dtype)
        perms = [[(s, (s + r) % D) for s in range(D)] for r in range(D)]
        payload_rounds = [r for r in range(D) if round_nnz[r] > 0]

        if exchange == "needset_overlap":
            # ---- comm/compute overlap (SURVEY §5.8 north star: "bin-k
            # numeric compute overlaps bin-k+1 communication"). Every
            # row is assigned to the LAST exchange round its columns
            # need (max over its slots of (d - owner) % D); round group
            # r runs as its own masked stream pipeline against the
            # received-buffer PREFIX holding rounds <= r, built up by
            # one dynamic_update_slice per payload round. The group-0
            # pipeline depends only on the local self-need gather, so
            # the scheduler can run it while every ppermute round is
            # still in flight; group r's chunks start as soon as round
            # r lands. Rows are computed exactly once — no cross-round
            # merge is ever needed.
            masks_h = np.zeros((D, D, m_loc), bool)  # [round, shard, row]
            for d, sl in ash_eff.local.items():
                alen = np.diff(np.asarray(sl.row_offsets, np.int64))
                owner = np.asarray(sl.col_ids, np.int64) // k_loc
                rnd = (d - owner) % D
                rmax = np.zeros(sl.rows, np.int64)
                np.maximum.at(rmax, np.repeat(np.arange(sl.rows), alen),
                              rnd)
                masks_h[rmax, d, np.arange(sl.rows)] = True
            masks_h = _combine_max(masks_h.astype(np.uint8)).astype(bool)
            rounds_live = [r for r in range(D)
                           if bool((masks_h[r] & (ops_sh > 0)).any())]
            if not rounds_live:
                rounds_live = [0]
            n_chunks_r, rw_max_r, wide_rid_r, specs_r = {}, {}, {}, {}
            for r in rounds_live:
                ops_list = [
                    np.where(masks_h[r, d, : r1 - r0],
                             ops_sh[d, : r1 - r0], 0)
                    for d, (r0, r1) in enumerate(a_ranges)]
                tqs = [tight_total_host(o, W, min_q) for o in ops_list]
                n_chunks_r[r] = max(1, -(-max(tqs + [1]) // CP))
                rw_max_r[r], wide_rid_r[r], specs_r[r] = _mesh_wide_plans(
                    ops_list, W, cfg.stream_level_factor,
                    cfg.stream_max_width, n_cols=n_cols)

            overlap_extras = []
            for r in rounds_live:
                overlap_extras.append(put(masks_h[r]))
                overlap_extras.append(put(wide_rid_r[r]))
                for spec in specs_r[r]:
                    overlap_extras.append(put(spec["in_map"]))
                    overlap_extras.append(put(spec["final"]))
            if ksp is not None:
                overlap_extras += [
                    put(ksp["spl_indptr"].astype(np.int32)),
                    (spl_cols_remap
                     if isinstance(spl_cols_remap, jax.Array)
                     else put(np.asarray(spl_cols_remap, np.int32))),
                    put(ksp["spl_vals"]),
                    put(spl_tgt_h), put(spl_emit_h),
                    put(spl_wide_rid_h)]
                for spec in ks["specs"]:
                    overlap_extras.append(put(spec["in_map"]))
                    overlap_extras.append(put(spec["final"]))
            n_extras = len(overlap_extras)
            RBT = max(int(seg_off[-1]), 1)

            def step(ai, axr, ad, bx, bd, rbs, rbl, *rest):
                ex = rest[:n_extras]
                sends = rest[n_extras:]
                ai_, axr_, ad_ = ai[0], axr[0], ad[0]
                b_start_, b_len_ = rbs[0], rbl[0]
                packed = _pack_payload(bx[0], bd[0])
                base_buf = jnp.zeros((RBT, CH), jnp.int32)
                chain = {}
                buf = base_buf
                si = 0
                for r in payload_rounds:
                    sidx, sval = sends[2 * si][0], sends[2 * si + 1][0]
                    si += 1
                    payload = packed[jnp.clip(sidx, 0,
                                              packed.shape[0] - 1)]
                    payload = jnp.where(sval[:, None], payload, 0)
                    if r != 0:
                        payload = jax.lax.ppermute(payload, ROW_AXIS,
                                                   perms[r])
                    buf = jax.lax.dynamic_update_slice(
                        buf, payload, (int(seg_off[r]), 0))
                    chain[r] = buf

                def buf_for(r):
                    best = None
                    for pr in payload_rounds:
                        if pr <= r:
                            best = pr
                    return chain[best] if best is not None else base_buf

                zero = jnp.int32(0)
                nnz_row = jnp.zeros((m_loc,), jnp.int32)
                pipes = []
                idx = 0
                for r in rounds_live:
                    mask = ex[idx][0]
                    wrid = ex[idx + 1]
                    lv = [ex[idx + 2 + i][0]
                          for i in range(2 * len(specs_r[r]))]
                    idx += 2 + 2 * len(specs_r[r])
                    res = _stream_pipeline(
                        cfg, G, W, n_cols, ai_, axr_, ad_, b_start_,
                        b_len_, buf_for(r), wrid[0], lv, specs_r[r],
                        m=m_loc, n_ch=n_chunks_r[r], rw_max=rw_max_r[r],
                        row_mask=mask, f64=f64)
                    nnz_row = nnz_row + res[0]
                    pipes.append(res)

                merged = None
                if ksp is not None:
                    n_split, n_rows = ks["n_split"], ks["n_rows"]
                    Pp, PMp, Wm = ks["P"], ks["PM"], ks["Wm"]
                    si_ = ex[idx][0]
                    sx_ = ex[idx + 1][0]
                    sv_ = ex[idx + 2][0]
                    spl_tgt = ex[idx + 3][0]
                    spl_emit = ex[idx + 4][0]
                    spl_wrid = ex[idx + 5]
                    spl_lv = [x[0] for x in
                              ex[idx + 6: idx + 6 + 2 * len(ks["specs"])]]
                    # k-split slots are self-owned by construction:
                    # their records live in the round-0 prefix
                    offs_p = jnp.arange(n_rows + 1,
                                        dtype=jnp.int32) * Pp
                    p_cols = jnp.full((n_rows * Pp,), n_cols, jnp.int32)
                    p_vals = jnp.zeros((n_rows * Pp,),
                                       jnp.float64 if f64
                                       else jnp.float32)
                    _, p_cols, p_vals = _stream_pipeline(
                        cfg, G, W, n_cols, si_, sx_, sv_, b_start_,
                        b_len_, buf_for(0), spl_wrid[0], spl_lv,
                        ks["specs"], m=n_rows, n_ch=ks["n_chunks"],
                        rw_max=ks["rw_max"], f64=f64,
                        emit_to=(offs_p, p_cols, p_vals))
                    nnz_row, merged = _ksplit_merge(
                        cfg, p_cols, p_vals, spl_tgt, spl_emit,
                        nnz_row, n_split=n_split, PM=PMp, Wm=Wm,
                        n_cols=n_cols)

                offs = jnp.concatenate(
                    [jnp.zeros((1,), jnp.int32), cumsum1d(nnz_row)])
                c_cols = jnp.zeros((out_cap,), jnp.int32)
                c_vals = jnp.zeros((out_cap,),
                                   jnp.float64 if f64 else jnp.float32)
                for pipe_r in pipes:
                    c_cols, c_vals = _emit_pipeline(
                        cfg, G, W, n_cols, pipe_r, offs, c_cols,
                        c_vals, f64=f64)
                if merged is not None:
                    spl_emit_m, col_m, val_m, cnt_m = merged
                    rid_e = jnp.broadcast_to(spl_emit_m[:, None],
                                             col_m.shape)
                    ident = jnp.arange(m_loc, dtype=jnp.int32)
                    c_cols, c_vals = stream_emit(
                        ident, rid_e, col_m, val_m, cnt_m, zero,
                        offs, c_cols, c_vals, wide_only=True)
                return nnz_row[None], c_cols[None], c_vals[None]

            n_in = 7 + n_extras + len(live_sends)
            args_ = (put(ai_h), ax_remap_a, put(ad_h), put(bx_h),
                     put(bd_h), rb_start_a, rb_len_a, *overlap_extras,
                     *live_sends)
            key = ("stream_ov", _mesh_key(mesh), _cfg_key(cfg),
                   str(jnp.dtype(dtype)), m_loc, W, G, out_cap, n_cols,
                   tuple(int(x) for x in round_nnz),
                   tuple(payload_rounds), tuple(rounds_live), RBT,
                   tuple((r, n_chunks_r[r], rw_max_r[r],
                          _specs_key(specs_r[r])) for r in rounds_live),
                   ks_key, n_extras, f64, _argsig(args_))
            sharded, compiled_reused = _cached_step(
                key, lambda: jax.jit(jax.shard_map(
                    step, mesh=mesh, in_specs=(P(ROW_AXIS),) * n_in,
                    out_specs=(P(ROW_AXIS),) * 3)))
            _set_last_exec(sharded, args_)
            nnz_row, cols, vals = sharded(*args_)
        else:
            def step(ai, axr, ad, bx, bd, rbs, rbl, wide_rid, *rest):
                lv = rest[: n_ladder - 1]
                sends = rest[n_ladder - 1:]
                ai, axr, ad = ai[0], axr[0], ad[0]
                packed = _pack_payload(bx[0], bd[0])
                segs = []
                si = 0
                for r in payload_rounds:
                    sidx, sval = sends[2 * si][0], sends[2 * si + 1][0]
                    si += 1
                    payload = packed[jnp.clip(sidx, 0,
                                              packed.shape[0] - 1)]
                    payload = jnp.where(sval[:, None], payload, 0)
                    if r == 0:
                        segs.append(payload)        # self-need: no comm
                    else:
                        segs.append(jax.lax.ppermute(payload, ROW_AXIS,
                                                     perms[r]))
                b_payload = (jnp.concatenate(segs) if segs
                             else jnp.zeros((1, CH), jnp.int32))
                return body(ai, axr, ad, rbs[0], rbl[0], b_payload,
                            wide_rid, *lv)

            n_in = 7 + n_ladder + len(live_sends)
            args_ = (put(ai_h), ax_remap_a, put(ad_h), put(bx_h),
                     put(bd_h), rb_start_a, rb_len_a,
                     *extra_args(spl_cols_remap), *live_sends)
            key = ("stream_ns", _mesh_key(mesh), _cfg_key(cfg),
                   str(jnp.dtype(dtype)), body_key,
                   tuple(int(x) for x in round_nnz),
                   tuple(payload_rounds), n_ladder, _argsig(args_))
            sharded, compiled_reused = _cached_step(
                key, lambda: jax.jit(jax.shard_map(
                    step, mesh=mesh, in_specs=(P(ROW_AXIS),) * n_in,
                    out_specs=(P(ROW_AXIS),) * 3)))
            _set_last_exec(sharded, args_)
            nnz_row, cols, vals = sharded(*args_)
        stats = NeedsetStats(
            # per-shard volume actually moved over the interconnect:
            # all_gather replicates all of B's records; the need-set
            # rounds move only the padded non-self rounds
            allgather_bytes=allgather_bytes,
            needset_bytes=needset_bytes,
            pairs_nnz=pair_nnz,
            mode=exchange,
        )

    meta = {"ranges": a_ranges, "out_cap": out_cap, "m_loc": m_loc,
            "shape": (ash.m, bsh.n), "stats": stats,
            "ksplit": _ksplit_meta(ksp), "route": "stream",
            "compiled_reused": compiled_reused}
    return nnz_row, cols, vals, meta


_last_exec = None

# ---- compiled-step cache (mesh plan reuse) -------------------------
# The mesh form of the single-chip plan_spgemm/execute split: repeated
# multiplies whose HOST plan has the same static signature (same shard
# shapes, chunk/ladder/exchange-round layout, cfg, mesh) reuse the SAME
# jitted step object, so jax's jit cache hits — no retrace, no
# recompile. This is safe because every step closure is deliberately
# arg-complete: all structure-dependent ARRAYS (indptrs, col ids,
# remaps, ladder in_maps, exchange tables, send plans) ride the
# argument list (the multi-controller requirement already forced this),
# so two plans with equal static keys trace to the same computation.
# The AMG/GNN repeated-numeric case (same structure, new values) hits
# by construction; host planning (numpy) still runs and rebuilds the
# args. Bounded LRU; meta["compiled_reused"] reports a hit.
from collections import OrderedDict  # noqa: E402

_step_cache: "OrderedDict" = OrderedDict()
_STEP_CACHE_CAP = 8


def _mesh_key(mesh: Mesh):
    return (tuple(str(d) for d in mesh.devices.flat), mesh.axis_names)


def _cfg_key(cfg: SpgemmConfig):
    # SpgemmConfig is a frozen dataclass: hashable by field values
    return cfg


def _specs_key(specs):
    return tuple((s["F"], s["W_in"], s["R_out"], s["in_map"].shape,
                  s.get("W_buf_in"), s.get("W_buf_out")) for s in specs)


def _argsig(args):
    """Shape/dtype signature of a device-arg tuple — the mechanical part
    of a step's static key (everything the trace can see of an arg)."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in args)


def _cached_step(key, build):
    """Return (jitted step, reused: bool) for the given static key."""
    fn = _step_cache.get(key)
    if fn is not None:
        _step_cache.move_to_end(key)
        return fn, True
    fn = build()
    _step_cache[key] = fn
    while len(_step_cache) > _STEP_CACHE_CAP:
        _step_cache.popitem(last=False)
    return fn, False


def _set_last_exec(fn, args):
    global _last_exec
    _last_exec = (fn, args)


def last_exec():
    """Debug/benchmark hook: the (jitted step, device args) of the most
    recent mesh_stream_spgemm dispatch. Re-invoking times the pure SPMD
    step — no host replanning, no recompilation (the jit object is
    reused)."""
    return _last_exec


def _ksplit_meta(ksp) -> Optional[dict]:
    """Plan summary surfaced in meta so callers/tests can assert the
    single-row sharding actually engaged."""
    if ksp is None:
        return None
    return dict(n_split=int(ksp["n_split"]), n_rows=int(ksp["n_rows"]),
                max_parts=int(ksp["max_parts"]),
                split_ids=np.asarray(ksp["split_ids"]).tolist())


def _fetch_global(x) -> np.ndarray:
    """Fetch a possibly non-fully-addressable sharded array to host.
    Under multi-process (jax.distributed) every process gets the full
    logical array via an all-gather over hosts; single-controller this
    is a plain device fetch."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


def mesh_stream_to_host_csr(nnz_row, cols, vals, meta) -> HostCSR:
    """Assemble the padded per-shard outputs into one HostCSR (every
    process gets the full matrix; see _fetch_global)."""
    m, n = meta["shape"]
    m_loc, out_cap = meta["m_loc"], meta["out_cap"]
    nnz_row = _fetch_global(nnz_row).reshape(-1, m_loc)
    cols = _fetch_global(cols).reshape(-1, out_cap)
    vals = _fetch_global(vals).reshape(-1, out_cap)
    parts_c, parts_v, counts = [], [], []
    for d, (r0, r1) in enumerate(meta["ranges"]):
        cnt = nnz_row[d][: r1 - r0]
        tot = int(cnt.sum())
        parts_c.append(cols[d][:tot])
        parts_v.append(vals[d][:tot])
        counts.append(cnt)
    cnt_all = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    offsets = np.zeros(m + 1, np.int64)
    if cnt_all.shape[0]:
        np.cumsum(cnt_all, out=offsets[1:1 + cnt_all.shape[0]])
        offsets[1 + cnt_all.shape[0]:] = offsets[cnt_all.shape[0]]
    return HostCSR(
        rows=m, cols=n, row_offsets=offsets,
        col_ids=(np.concatenate(parts_c) if parts_c
                 else np.zeros(0, np.int64)),
        data=(np.concatenate(parts_v) if parts_v else np.zeros(0)),
    )
