"""SpGEMM orchestrator: the analogue of MultiplyspECKImplementation
(/root/reference/source/GPU/Multiply.cu:51-1122).

Pipeline stages (mirroring Multiply.cu's 9-stage structure; stage names match
include/Timings.h / Multiply.cu:1099-1113):

  1. analysis            (readOperations, Multiply.cu:245-252)  -> ops/analysis.py
  2. planning            (load balancer + dense heuristic,
                          :281-353, :379)                       -> ops/stream.py
                          plan_device_stream: ONE device pass, ONE readback
  3. symbolic counting   (h_SpGEMMCountLauncher, :494-553)      -> stream chunks
  4. wide-row merges     (global-map / windowed giant rows,
                          spECK_HashSpGEMM.cuh:106-126, 1175-1298) -> stream levels
  5. offset scan + alloc (cub ExclusiveSum + alloc C, :570-601) -> cumsum + host sync
  6. numeric / emission  (h_SpGEMMNumericLauncher, :837-1014)   -> staged emit or
                          two-phase numeric chunks

Row routing (the analogue of the per-block method selection,
spECK_HashSpGEMM.cuh:1761-1793):
  - dense-eligible row tiles  -> dense-window matmuls (ops/dense.py)
  - single-A-nonzero rows     -> direct copy (ops/esc.py direct_chunk)
  - everything else           -> the flat product stream (ops/stream.py),
    which packs small rows tightly AND windows giant rows via merge levels
    (one mechanism; see ops/stream.py docstring)

Exactly TWO host syncs per plan: the packed planning readback and the
nnz/max readback after the offset scan (the reference's two D2H points,
Multiply.cu:249-252, 572-575).

Beyond the reference: when staging memory allows, counting and numeric are
FUSED (one expand/sort yields both phases), and the symbolic result is
reusable -- ``plan_spgemm``/``execute`` skip analysis/counting for repeated
multiplies with identical structure (AMG setup, graph contractions).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import ProductOverflow, SpgemmConfig
from ..utils.timings import Timings, StageTimer
from .analysis import (analyze, cumsum1d, host_analyze,
                       host_band_extremes, host_gate_lite)
from .dense import dense_emit, dense_gather_emit, dense_tiles
from .device_csr import DeviceCSR, host_of
from .dia import (
    DiaState,
    dia_conv,
    dia_count_pipeline,
    dia_count_stage,
    dia_emit_edge,
    dia_numeric_stage,
    dia_offsets_meta,
    dia_planes,
    dia_row_inband,
    dia_rows_conv_fused,
    dia_scatter_emit,
    dia_slots,
    plane_bytes,
    sdia_conv_blocked,
    sdia_lut,
    sdia_pad,
    sdia_plane_bytes,
    sdia_slots,
)
from .esc import direct_chunk, pack_csr_arrays, packable
from .stream import (
    N_QCLASS,
    N_WSEG_PACK,
    LevelPlan,
    StreamLayout,
    accum_finalize,
    build_srec,
    compact_staged,
    plan_device_stream,
    plan_gate,
    plan_layout,
    plan_levels,
    stream_chunk,
    stream_chunk_accum,
    stream_chunk_numeric,
    stream_emit,
    stream_gather_emit,
    stream_level,
    stream_wide_finish,
    wide_entry_totals,
)


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _bucket_rows(count: int, full: int) -> int:
    """Direct-chunk row count: the budget-limited size for populous
    classes, else the next power of 4 >= count (bounded compile-shape
    ladder)."""
    if count >= full:
        return full
    pow4 = 1 << (((count - 1).bit_length() + 1) // 2 * 2) if count > 1 else 1
    return max(1, min(full, pow4))


@dataclasses.dataclass(frozen=True)
class DenseGroup:
    """Dense-eligible row tiles (ops/dense.py), pre-sliced into dispatch
    batches: batch b covers tiles [boffs[b], boffs[b+1]) of the padded
    per-tile arrays (device-resident; only their count crossed to the
    host). Tile i covers rows [r0s[i], r0s[i] + valids[i])."""

    r0s: jax.Array
    kbases: jax.Array
    cbases: jax.Array
    valids: jax.Array
    boffs: List[int]
    tile_rows: int
    # effective window dims: fitted to the eligible tiles' actual spans
    # (rounded to a bounded class ladder) — the config values are only
    # eligibility ceilings. Sort/matmul cost scales with these.
    kw: int
    cw: int
    la: int
    lb: int
    # True iff EVERY row tile of the matrix is dense-eligible, so tile i
    # covers rows [i*tile_rows, ...) in order and staged row index ==
    # matrix row index (the gather-emit precondition).
    full_cover: bool = False

    @property
    def staging_slots(self) -> int:
        return len(self.r0s) * self.tile_rows * self.cw

    def batches(self):
        for b in range(len(self.boffs) - 1):
            s, e = self.boffs[b], self.boffs[b + 1]
            yield (self.r0s[s:e], self.kbases[s:e],
                   self.cbases[s:e], self.valids[s:e])


@dataclasses.dataclass(frozen=True)
class DirectGroup:
    """Fixed-shape chunks of one direct-copy class (single-A-nonzero rows,
    C row = valA * B row): chunk c covers rows_sorted[starts[c] :
    starts[c]+rows], first valids[c] live, copy capacity ``cap``."""

    cap: int
    rows: int
    starts: np.ndarray
    valids: np.ndarray


@dataclasses.dataclass
class StreamState:
    """Device + host state of the stream path, kept on the plan."""

    layout: StreamLayout
    lplans: List[LevelPlan]
    rows_sorted: jax.Array      # (m,) sorted by descending q
    rows_padded: jax.Array      # rows_sorted padded for direct slicing
    e: jax.Array                # (m,) aligned stream starts
    q_sorted: jax.Array         # (m,) product quantum per sorted row
    el: jax.Array               # (m,) exclusive live-ops prefix
    ops_sorted: jax.Array       # (m,) live products per sorted row
    p0: jax.Array               # (nnz,) A-slot stream starts (compacted)
    su: jax.Array               # (nnz,) u = b_row_start - p0 per slot
    sa: jax.Array               # (nnz,) valA bits per slot
    pend: jax.Array             # (nnz,) A-slot product ends (p0 + b_len)
    src: jax.Array              # (nnz,) sorted-slot -> A nnz index
    sid_bases: jax.Array        # (n_chunks,) A-slots with p0 < chunk start
    rid_bases: jax.Array        # (n_chunks,) rows with e < chunk start
    pack_bits: int
    fused: bool
    staged: Optional[list] = None       # per-chunk (rid, col, val, counts)
    level_bufs: Optional[list] = None   # per-level (rid, col, val, fcnt)
    wide_rid_in: Optional[jax.Array] = None
    # adaptive wide-finish classes (host params from the totals readback):
    # list of dicts with keys R2, W2, E_pad, entry_excl, row_total,
    # rid_of_out — None means the geometric ladder is in use
    finish: Optional[list] = None
    # per-row live product end e + ops (dead-slot detection in expand)
    rowend: Optional[jax.Array] = None
    rowend2: Optional[jax.Array] = None
    # dense-span accumulator region (huge rows with bounded column
    # ranges, sorted first): its own product space + host part/class plan
    n_accum: int = 0
    e2: Optional[jax.Array] = None
    p02: Optional[jax.Array] = None
    su2: Optional[jax.Array] = None
    sa2: Optional[jax.Array] = None
    pend2: Optional[jax.Array] = None
    src2: Optional[jax.Array] = None
    sid_bases2: Optional[jax.Array] = None
    rid_bases2: Optional[jax.Array] = None
    cmin_s: Optional[jax.Array] = None   # (m,) out-col window base, sorted
    abase: Optional[jax.Array] = None    # (m,) accumulator slot base
    accum: Optional[dict] = None         # host plan: n_chunks2, parts
    accum_bufs: Optional[list] = None    # staged finalize outputs
    # lazy cache of the concatenated staged buffers (cols, vals), so
    # repeated execute() calls on a fused plan don't re-copy O(total_q)
    # slots per call (AMG-style plan reuse)
    staged_flat: Optional[tuple] = None


@dataclasses.dataclass
class DiaRowGroup:
    """Per-row DIA split state (cfg.dia_rows): the banded BULK of a
    matrix whose whole-matrix DIA gate failed rides diagonal planes;
    outlier rows ride the stream/dense/direct paths. Each C row is
    produced by exactly one path (a row qualifies only if every B row it
    touches is in-band), so emission is a plain scatter into shared C.
    The per-row form of the reference's per-block method
    auto-select (spECK_HashSpGEMM.cuh:1761-1793)."""

    span_a: int
    span_b: int
    span_c: int
    dmin_a: int
    dmin_b: int
    slot_a: jax.Array        # (nnz_a,) masked plane slots (dia rows only)
    slot_b: jax.Array        # (nnz_b,) masked plane slots (in-band B rows)
    present: jax.Array       # (m, span_c) structural presence
    cvT: Optional[jax.Array] = None   # staged (m, span_c) value plane


@dataclasses.dataclass
class SpgemmPlan:
    """Symbolic (structure) result of C = A @ B, reusable across numeric
    runs."""

    A: DeviceCSR
    B: DeviceCSR
    cfg: SpgemmConfig
    row_offsets: jax.Array   # (m+1,) int32
    nnz: int
    sum_products: jax.Array  # () device scalar; float() it lazily
    stream: Optional[StreamState] = None
    groups: List[DirectGroup] = dataclasses.field(default_factory=list)
    dense: Optional["DenseGroup"] = None
    dense_staged: Optional[List[tuple]] = None
    max_count: int = 0
    dia: Optional[DiaState] = None
    dia_rows: Optional[DiaRowGroup] = None

    @property
    def shape(self):
        return (self.A.shape[0], self.B.shape[1])

    @property
    def routes(self) -> Tuple[str, ...]:
        """The routes this plan's rows take, from its non-empty parts:
        "dia" / "sdia" (whole-matrix diagonal planes, contiguous or
        sparse), "dia_rows" (per-row DIA split), "dense", "direct",
        "stream". Empty for an empty product."""
        out = []
        if self.dia is not None:
            out.append("sdia" if self.dia.off_a is not None else "dia")
        if self.dia_rows is not None:
            out.append("dia_rows")
        if self.dense is not None:
            out.append("dense")
        if any(int(np.sum(g.valids)) > 0 for g in self.groups):
            out.append("direct")
        ss = self.stream
        if ss is not None and (ss.layout.total_q > 0 or ss.accum):
            out.append("stream")
        return tuple(out)

    def _chunk_args(self, A, B, ss: StreamState):
        """Operand arrays for numeric re-expansion (possibly new values)."""
        f64 = not packable(A.data)
        if f64:
            sa = ss.sa
            b_packed = jnp.zeros((1, 2), jnp.int32)
        else:
            sa = jax.lax.bitcast_convert_type(
                A.data.astype(jnp.float32), jnp.int32)[ss.src]
            b_packed = pack_csr_arrays(B.indices,
                                       B.data.astype(jnp.float32))
        return sa, b_packed, f64

    def execute(
        self,
        A: Optional[DeviceCSR] = None,
        B: Optional[DeviceCSR] = None,
        timings: Optional[Timings] = None,
    ) -> DeviceCSR:
        """Numeric phase: fill C's values (and columns) at exact offsets.

        A/B may carry new ``data`` but must have the plan's structure.
        """
        use_staged = A is None and B is None
        A = self.A if A is None else A
        B = self.B if B is None else B
        m, n = self.shape
        track = timings is not None and timings.measure_all
        if self.dia is not None:
            return self._execute_dia(A, B, use_staged, timings, track)
        ssg = self.stream
        gather_emit = (
            use_staged and ssg is not None and ssg.fused
            and ssg.staged is not None and ssg.layout.total_q > 0
            and self.nnz > 0
        )
        if gather_emit:
            # contained stream rows by GATHER over the concatenated staged
            # buffers (~nnz(C) traffic instead of all G*W staged slots);
            # dense/direct/wide rows overwrite their regions below.
            # Concatenate once per plan, not per execute().
            if ssg.staged_flat is None:
                ssg.staged_flat = (
                    jnp.concatenate(
                        [stg[1].reshape(-1) for stg in ssg.staged]),
                    jnp.concatenate(
                        [stg[2].reshape(-1) for stg in ssg.staged]),
                )
            cols_flat, vals_flat = ssg.staged_flat
            c_cols, c_vals = stream_gather_emit(
                ssg.rows_sorted, ssg.e, self.row_offsets,
                cols_flat, vals_flat, W=ssg.layout.W, nnz=self.nnz)
        else:
            c_cols = jnp.zeros((max(self.nnz, 1),), jnp.int32)
            c_vals = jnp.zeros((max(self.nnz, 1),), A.data.dtype)
        with StageTimer(timings, "spGEMMNumeric", track) as st:
            if self.dense is not None:
                d = self.dense
                # pure-dense fast path: every tile dense-eligible
                # (full_cover), no stream/direct rows -> staged row index
                # == matrix row index; build C by gather, not scatter
                pure = (
                    use_staged and self.dense_staged is not None
                    and not self.groups and d.full_cover and self.nnz > 0
                    and (self.stream is None
                         or self.stream.layout.n_stream_rows == 0)
                )
                if pure:
                    if len(self.dense_staged) == 1:
                        _, cols_c, vals_c = self.dense_staged[0]
                    else:
                        cols_c = jnp.concatenate(
                            [s[1].reshape(-1, d.cw)
                             for s in self.dense_staged])
                        vals_c = jnp.concatenate(
                            [s[2].reshape(-1, d.cw)
                             for s in self.dense_staged])
                    c_cols, c_vals = dense_gather_emit(
                        cols_c, vals_c, self.row_offsets,
                        tile_rows=d.tile_rows, cw=d.cw, m=m, nnz=self.nnz,
                    )
                    st.stop(c_cols, c_vals)
                    return DeviceCSR(
                        indptr=self.row_offsets, indices=c_cols,
                        data=c_vals, shape=(m, n), nnz=self.nnz,
                    )
                for bi, (r0s, kbs, cbs, valids) in enumerate(d.batches()):
                    if use_staged and self.dense_staged is not None:
                        counts, cols_c, vals_c = self.dense_staged[bi]
                    else:
                        f64d = not packable(A.data)
                        apk = None if f64d else pack_csr_arrays(
                            A.indices, A.data)
                        bpk = apk if (B.indices is A.indices
                                      and B.data is A.data) else (
                            None if f64d else pack_csr_arrays(
                                B.indices, B.data))
                        _, (counts, cols_c, vals_c) = dense_tiles(
                            r0s, kbs, cbs,
                            A.indptr, A.indices, A.data,
                            B.indptr, B.indices, B.data,
                            jnp.zeros((m,), jnp.int32), apk, bpk,
                            tile_rows=d.tile_rows, kw=d.kw,
                            cw=d.cw, la=d.la, lb=d.lb,
                            m=m, k_dim=A.shape[1], n_cols=n,
                            densify=self.cfg.dense_densify,
                        )
                    c_cols, c_vals = dense_emit(
                        r0s, counts, cols_c, vals_c,
                        self.row_offsets, c_cols, c_vals,
                        tile_rows=d.tile_rows, cw=d.cw, m=m,
                        emit_cap=_pow2(self.max_count),
                    )
            ss = self.stream
            if (ss is not None and ss.layout.n_chunks > 0
                    and ss.layout.total_q > 0):
                lo = ss.layout
                G, W = lo.G, lo.W
                CP = G * W
                # first n_accum + n_wide sorted rows are emitted by the
                # accumulator / wide paths, not the contained scatter
                nwj = jnp.int32(ss.n_accum + lo.n_wide)
                if use_staged and ss.fused and ss.staged is not None:
                    # contained rows already emitted by the gather pass
                    level_bufs = ss.level_bufs or []
                else:
                    sa_n, b_packed, f64 = self._chunk_args(A, B, ss)
                    # wide values from a two-phase plan were merged once at
                    # plan time; don't recompute staging we would discard
                    reuse_levels = bool(use_staged and not ss.fused
                                        and ss.level_bufs)
                    wide_staged = []
                    for c in range(lo.n_chunks):
                        has_wide = (c * G < lo.r_wide) and not reuse_levels
                        Gc = (lo.g_last if c == lo.n_chunks - 1 else G)
                        c_cols, c_vals, stg = stream_chunk_numeric(
                            ss.rows_sorted, ss.e, ss.rowend, ss.p0, ss.su,
                            sa_n, ss.pend, b_packed, B.indices, B.data,
                            A.data,
                            ss.src, self.row_offsets, c_cols, c_vals,
                            jnp.int32(c * CP),
                            ss.rid_bases[c], ss.sid_bases[c], nwj,
                            G=Gc, W=W, n_cols=n, pack_bits=ss.pack_bits,
                            stage_wide=has_wide, f64=f64,
                            compact_impl=self.cfg.stream_compact_impl,
                            expand_impl=self.cfg.stream_expand_impl)
                        if stg is not None:
                            wide_staged.append(stg)
                    if reuse_levels:
                        level_bufs = ss.level_bufs
                    else:
                        level_bufs = _run_wide(
                            ss, wide_staged, None, n, count=False,
                            max_width=self.cfg.stream_max_width,
                            compact_impl=self.cfg.stream_compact_impl)[1]
                for rid_out, col_c, val_c, fcnt in level_bufs:
                    rid_b = jnp.broadcast_to(rid_out[:, None], col_c.shape)
                    c_cols, c_vals = stream_emit(
                        ss.rows_sorted, rid_b, col_c, val_c, fcnt, nwj,
                        self.row_offsets, c_cols, c_vals, wide_only=True)
            if ss is not None and ss.accum:
                if use_staged and ss.accum_bufs is not None:
                    accum_bufs = ss.accum_bufs
                else:
                    accum_bufs = _run_accum(
                        ss, A, B, None, n, count=False,
                        expand_impl=self.cfg.stream_expand_impl)[1]
                zero = jnp.int32(0)
                for rid_out, col_c, val_c, fcnt in accum_bufs:
                    rid_b = jnp.broadcast_to(rid_out[:, None], col_c.shape)
                    c_cols, c_vals = stream_emit(
                        ss.rows_sorted, rid_b, col_c, val_c, fcnt, zero,
                        self.row_offsets, c_cols, c_vals, wide_only=True)
            for g in self.groups:
                for start, valid in zip(g.starts, g.valids):
                    if valid == 0:
                        continue
                    c_cols, c_vals = direct_chunk(
                        self.stream.rows_padded, int(start), int(valid),
                        A.indptr, A.indices, A.data,
                        B.indptr, B.indices, B.data,
                        self.row_offsets, c_cols, c_vals,
                        chunk_rows=g.rows, cap=g.cap,
                    )
            if self.dia_rows is not None:
                dg = self.dia_rows
                if use_staged and dg.cvT is not None:
                    cvT = dg.cvT
                else:
                    # new values: rebuild the value planes against the
                    # stored (masked) slots and re-convolve
                    c_val, _ = dia_rows_conv_fused(
                        dg.slot_a, A.data, dg.slot_b, B.data,
                        sa=dg.span_a, sb=dg.span_b, m=m,
                        k=A.shape[1], dmin_a=dg.dmin_a, with_hit=False)
                    cvT = c_val.T
                c_cols, c_vals = dia_scatter_emit(
                    cvT, dg.present, self.row_offsets, c_cols, c_vals,
                    base_c=dg.dmin_a + dg.dmin_b)
            st.stop(c_cols, c_vals)
        return DeviceCSR(
            indptr=self.row_offsets,
            indices=c_cols,
            data=c_vals,
            shape=(m, n),
            nnz=self.nnz,
        )

    def _execute_dia(self, A, B, use_staged, timings, track):
        """Numeric phase of a DIA-routed plan (ops/dia.py): staged
        buffers emit directly; new values rebuild the value planes and
        re-stage against the stored structural presence mask."""
        d = self.dia
        m, n = self.shape
        k = A.shape[1]
        base_c = d.dmin_a + d.dmin_b
        with StageTimer(timings, "spGEMMNumeric", track) as st:
            if use_staged and d.staged is not None:
                cols_s, vals_s = d.staged
            else:
                av, ah = dia_planes(d.slot_a, A.data,
                                    span=d.span_a, rows=m)
                if (B.indices is A.indices and B.data is A.data
                        and B.shape == A.shape):
                    bv, bh = av, ah
                else:
                    bv, bh = dia_planes(d.slot_b, B.data,
                                        span=d.span_b, rows=k)
                if d.off_a is not None:
                    # sparse-DIA flavor: list-offset convolution
                    off_c = tuple(sorted({a + b for a in d.off_a
                                          for b in d.off_b}))
                    c_val, _ = sdia_conv_blocked(
                        av, ah, bv, bh, off_a=d.off_a, off_b=d.off_b,
                        off_c=off_c, m=m, k=k, with_hit=False)
                    cols_s, vals_s = dia_numeric_stage(
                        c_val, d.present, d.doffs, sc=d.span_c, m=m,
                        n_cols=n, base_c=0,
                        impl=self.cfg.stream_compact_impl)
                else:
                    c_val, _ = dia_conv(
                        av, ah, bv, bh, sa=d.span_a, sb=d.span_b, m=m,
                        k=k, dmin_a=d.dmin_a, with_hit=False)
                    cols_s, vals_s = dia_numeric_stage(
                        c_val, d.present, sc=d.span_c, m=m, n_cols=n,
                        base_c=base_c, impl=self.cfg.stream_compact_impl)
            if self.nnz > 0 and d.uniform is not None:
                # uniform-rows fast emit: the all-full interior block is
                # the final payload at a constant shift — one contiguous
                # copy (memory-bandwidth) instead of nnz random gathers;
                # only the band-clipped edge rows gather
                up, uq, u_offs = d.uniform
                sc = d.span_c
                mid_n = (uq - up) * sc
                cols_f = cols_s.reshape(-1)
                vals_f = vals_s.reshape(-1)
                parts_c = []
                parts_v = []
                if u_offs > 0:
                    ec, ev = dia_emit_edge(
                        cols_s, vals_s, self.row_offsets, sc=sc,
                        r0=0, r1=up, o0=0, n_out=u_offs)
                    parts_c.append(ec)
                    parts_v.append(ev)
                parts_c.append(
                    jax.lax.slice(cols_f, (up * sc,), (uq * sc,)))
                parts_v.append(
                    jax.lax.slice(vals_f, (up * sc,), (uq * sc,)))
                tail_n = self.nnz - u_offs - mid_n
                if tail_n > 0:
                    ec, ev = dia_emit_edge(
                        cols_s, vals_s, self.row_offsets, sc=sc,
                        r0=uq, r1=m, o0=u_offs + mid_n, n_out=tail_n)
                    parts_c.append(ec)
                    parts_v.append(ev)
                c_cols = (parts_c[0] if len(parts_c) == 1
                          else jnp.concatenate(parts_c))
                c_vals = (parts_v[0] if len(parts_v) == 1
                          else jnp.concatenate(parts_v))
            elif self.nnz > 0:
                c_cols, c_vals = dense_gather_emit(
                    cols_s, vals_s, self.row_offsets,
                    tile_rows=1, cw=d.span_c, m=m, nnz=self.nnz)
            else:
                c_cols = jnp.zeros((1,), jnp.int32)
                c_vals = jnp.zeros((1,), A.data.dtype)
            st.stop(c_cols, c_vals)
        return DeviceCSR(
            indptr=self.row_offsets, indices=c_cols, data=c_vals,
            shape=(m, n), nnz=self.nnz,
        )


@jax.jit
def _offsets_from_counts(nnz_row: jax.Array):
    offs = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), cumsum1d(nnz_row)]
    )
    # nnz and max row count packed into one array -> ONE host fetch
    meta = jnp.stack([offs[-1], jnp.max(nnz_row, initial=0)])
    return offs, meta


def _wide_slices(ss: StreamState, wide_staged):
    lo = ss.layout
    G = lo.G
    wcol = jnp.concatenate(
        [wide_staged[i][1][: min(G, lo.r_wide - i * G)]
         for i in range(len(wide_staged))])
    wval = jnp.concatenate(
        [wide_staged[i][2][: min(G, lo.r_wide - i * G)]
         for i in range(len(wide_staged))])
    wcnt = jnp.concatenate(
        [wide_staged[i][3][: min(G, lo.r_wide - i * G)]
         for i in range(len(wide_staged))])
    return wcol, wval, wcnt


def _plan_accum(a_hist: np.ndarray, a_psum: np.ndarray, CP: int,
                budget: int):
    """Host layout of the accumulator region from the planning pack:
    span classes in device sort order (descending), greedily split into
    parts whose accumulator slots fit ``budget``. Returns
    (n_accum, total_p2, n_chunks2, parts, class_meta) where class_meta =
    [(k, rows, span)] desc and parts = [dict(row_lo, row_hi, part_base,
    slots, classes=[(R_pad, S, off, rid_of_out np.ndarray)])]."""
    classes = [(k, int(a_hist[k]), 1 << k)
               for k in range(N_QCLASS - 1, -1, -1) if a_hist[k]]
    n_accum = int(a_hist.sum())
    total_p2 = int(a_psum.sum())
    if total_p2 >= 2 ** 31:
        raise ProductOverflow(
            f"accumulator region of {total_p2} products exceeds the 2^31 "
            "int32 ceiling; row-block the multiply")
    n_chunks2 = -(-total_p2 // CP) if total_p2 else 0
    # greedy parts: rows in device sort order (span class descending);
    # each part's padded accumulator slots stay <= budget (a lone row
    # wider than the budget still gets one slot run of its own)
    parts = []
    # PART-LOCAL accumulator offsets (global offsets could overflow int32
    # for many wide spans; rows outside the active part are masked by the
    # kernel's row range, so local offsets suffice)
    abase = np.zeros(max(n_accum, 1), np.int32)
    row = 0
    cur = None
    for k, rows, span in classes:
        done = 0
        while done < rows:
            if cur is None:
                cur = dict(row_lo=row, row_hi=row, slots=0, classes=[])
            avail = (budget - cur["slots"]) // span
            if avail < 1:
                if cur["classes"]:
                    parts.append(cur)
                    cur = None
                    continue
                avail = 1  # single row wider than the budget
            take = min(rows - done, avail)
            R_pad = _pow2(take)
            rid = np.full(R_pad, -1, np.int32)
            rid[:take] = np.arange(row, row + take)
            abase[row: row + take] = (cur["slots"]
                                      + np.arange(take, dtype=np.int64)
                                      * span).astype(np.int32)
            cur["classes"].append((R_pad, span, cur["slots"], rid))
            cur["slots"] += R_pad * span
            row += take
            done += take
            cur["row_hi"] = row
    if cur is not None and cur["classes"]:
        parts.append(cur)
    return n_accum, total_p2, n_chunks2, parts, abase


def _run_accum(ss: StreamState, A, B, nnz_row, n_cols: int, count: bool,
               expand_impl: str = "fill"):
    """Drive the accumulator region: expand + scatter-add every product
    into its row's dense span window, then finalize per span class (the
    reference's dense mode for single huge rows,
    spECK_HashSpGEMM.cuh:1761-1793). Returns (nnz_row, staged bufs)."""
    from .esc import packable

    ac = ss.accum
    if not ac or ac["n_chunks2"] == 0:
        return nnz_row, []
    if nnz_row is None:
        nnz_row = jnp.zeros((ss.rows_sorted.shape[0],), jnp.int32)
        count = False
    f64 = not packable(A.data)
    if f64:
        sa2 = ss.sa2
        b_packed = jnp.zeros((1, 2), jnp.int32)
    else:
        sa2 = jax.lax.bitcast_convert_type(
            A.data.astype(jnp.float32), jnp.int32)[ss.src2]
        b_packed = pack_csr_arrays(B.indices, B.data.astype(jnp.float32))
    G, W = ac["G"], ac["W"]
    CP = G * W
    bufs = []
    vdtype = A.data.dtype
    for part in ac["parts"]:
        acc = jnp.zeros((part["slots"],), vdtype)
        pres = jnp.zeros((part["slots"],), jnp.int32)
        lo_j = jnp.int32(part["row_lo"])
        hi_j = jnp.int32(part["row_hi"])
        for c in range(ac["n_chunks2"]):
            acc, pres = stream_chunk_accum(
                ss.e2, ss.rowend2, ss.p02, ss.su2, sa2, ss.pend2, b_packed,
                B.indices,
                B.data, A.data, ss.src2, ss.abase, ss.cmin_s, acc, pres,
                jnp.int32(c * CP), ss.rid_bases2[c], ss.sid_bases2[c],
                lo_j, hi_j, G=G, W=W, n_cols=n_cols, f64=f64,
                expand_impl=expand_impl)
        for R_pad, S, off, rid in part["classes"]:
            nnz_row, buf = accum_finalize(
                ss.rows_sorted, acc[off: off + R_pad * S],
                pres[off: off + R_pad * S], ss.cmin_s,
                jnp.asarray(rid), nnz_row, R_c=R_pad, S_c=S, count=count)
            bufs.append(buf)
    return nnz_row, bufs


def _finish_classes(totals: np.ndarray, rid_live: np.ndarray):
    """Lay out the finish pass over the CURRENT wide buffers: rows
    bucketed by pow2(entry total) class so one oversized row does not
    inflate every row's sort width. ``totals`` are per-live-row entry
    counts in buffer (ascending-rid) order; rid_live the sorted-row ids."""
    entry_excl = np.concatenate([[0], np.cumsum(totals)])[:-1]
    e_total = int(totals.sum())
    E_pad = _pow2(max(e_total, 2))
    classes = {}
    for i, tot in enumerate(totals):
        classes.setdefault(_pow2(max(int(tot), 8)), []).append(i)
    out = []
    for W2, idxs in sorted(classes.items(), reverse=True):
        R2 = _pow2(len(idxs))
        rid = np.full(R2, -1, np.int32)
        rid[: len(idxs)] = rid_live[idxs]
        ee = np.full(R2, e_total, np.int32)
        ee[: len(idxs)] = entry_excl[idxs]
        rt = np.zeros(R2, np.int32)
        rt[: len(idxs)] = totals[idxs]
        out.append(dict(
            R2=R2, W2=W2, E_pad=E_pad,
            entry_excl=jnp.asarray(ee), row_total=jnp.asarray(rt),
            rid_of_out=jnp.asarray(rid)))
    return out


def _run_wide(ss: StreamState, wide_staged, nnz_row, n_cols: int,
              count: bool, max_width: int, compact_impl: str = "sort"):
    """Finish the wide rows with the hybrid ladder->finish strategy: run
    geometric merge levels only until the remaining rows' DEDUPLICATED
    entry totals fit ``max_width`` (checked with a small per-level
    readback — the analogue of the reference's global-map sizing D2H,
    Multiply.cu:397), then complete each row in ONE sort at its true
    entry width. The count pass records the structure in ss.finish; the
    numeric pass replays it without readbacks."""
    lo = ss.layout
    if lo.n_wide == 0 or not wide_staged:
        return nnz_row, []
    if nnz_row is None:
        nnz_row = jnp.zeros((ss.rows_sorted.shape[0],), jnp.int32)
        count = False
    wcol, wval, wcnt = _wide_slices(ss, wide_staged)
    rid_in = ss.wide_rid_in
    W_in = lo.W
    deciding = ss.finish is None
    if deciding:
        ss.finish = dict(ladder_levels=len(ss.lplans), classes=None,
                         W_in=W_in)
    bufs = []
    li = 0
    while True:
        if deciding:
            # rid values are global sorted ids; the accum region sorts
            # first, so wide-row segment ids start at n_accum
            totals = np.asarray(wide_entry_totals(
                wcnt, rid_in - ss.n_accum, n_wide=lo.n_wide)
            ).astype(np.int64)
            loc = np.asarray(rid_in) - ss.n_accum
            # live rows in buffer order (ascending rid, one entry run each)
            live_loc = np.unique(loc)
            live_tot = totals[live_loc]
            keep_live = live_tot > 0
            live_loc, live_tot = live_loc[keep_live], live_tot[keep_live]
            if live_tot.size == 0:
                ss.finish.update(ladder_levels=li, classes=[])
                break
            if _pow2(int(live_tot.max())) <= max_width:
                ss.finish.update(
                    ladder_levels=li, W_in=W_in,
                    classes=_finish_classes(live_tot,
                                            live_loc + ss.n_accum))
                deciding = False
        if not deciding and li >= ss.finish["ladder_levels"]:
            classes = ss.finish["classes"]
            if classes is not None:
                wc_flat = wcol.reshape(-1)
                wv_flat = wval.reshape(-1)
                for f in classes:
                    nnz_row, buf = stream_wide_finish(
                        ss.rows_sorted, wc_flat, wv_flat, wcnt,
                        f["entry_excl"], f["row_total"], f["rid_of_out"],
                        nnz_row, R2=f["R2"], W2=f["W2"],
                        W0=ss.finish["W_in"], E_pad=f["E_pad"],
                        n_cols=n_cols, count=count,
                        compact_impl=compact_impl)
                    bufs.append(buf)
            break
        if li >= len(ss.lplans):
            break
        lp = ss.lplans[li]
        nnz_row, (rid_out, col_c, val_c, counts) = stream_level(
            ss.rows_sorted, rid_in, wcol, wval, wcnt,
            jnp.asarray(lp.in_map), jnp.asarray(lp.final_mask), nnz_row,
            F=lp.F, W_in=lp.W_in, n_cols=n_cols, count=count,
            compact_impl=compact_impl)
        if lp.final_mask.any():
            # keep a level's buffer only if some row finalizes (= emits)
            # there; pass-through levels would otherwise pin O(stream)
            # memory each
            fi = jnp.asarray(np.nonzero(lp.final_mask)[0], jnp.int32)
            bufs.append((rid_out[fi], col_c[fi], val_c[fi], counts[fi]))
        keep = ~lp.final_mask
        if not keep.any():
            if deciding:
                ss.finish.update(ladder_levels=li + 1, classes=None)
            break
        ki = jnp.asarray(np.nonzero(keep)[0], jnp.int32)
        rid_in, wcol, wval, wcnt = (rid_out[ki], col_c[ki], val_c[ki],
                                    counts[ki])
        W_in = W_in * lp.F
        li += 1
    return nnz_row, bufs


def _plan_dia(A: DeviceCSR, B: DeviceCSR, cfg: SpgemmConfig,
              timings: Optional[Timings], stats, dmin_a: int, dmin_b: int,
              sa: int, sb: int, track: bool) -> SpgemmPlan:
    """Complete a DIA-routed plan: fused count+numeric over diagonal
    planes (ops/dia.py), one offsets/nnz readback — the same TWO-sync
    protocol as the general path.  (Called from inside plan_spgemm's
    loadBalanceCounting timer; for DIA runs that stage timer therefore
    covers planning AND counting — the per-stage split below is still
    recorded.)"""
    m, n = A.shape[0], B.shape[1]
    k = A.shape[1]
    sc = sa + sb - 1
    with StageTimer(timings, "spGEMMCounting", track) as st:
        same = (B.indices is A.indices and B.data is A.data
                and B.shape == A.shape)
        slot_a = dia_slots(A.indptr, A.indices, dmin=dmin_a, span=sa,
                           rows=m)
        slot_b = slot_a if same else dia_slots(
            B.indptr, B.indices, dmin=dmin_b, span=sb, rows=k)
        # planes + conv + stage in ONE dispatch (dispatch diet)
        counts, present, cols_s, vals_s = dia_count_pipeline(
            slot_a, A.data, slot_b, B.data, sa=sa, sb=sb, m=m, k=k,
            dmin_a=dmin_a, sc=sc, n_cols=n, base_c=dmin_a + dmin_b,
            impl=cfg.stream_compact_impl, same=same)
        st.stop(counts)
    with StageTimer(timings, "allocC", track):
        row_offsets, meta = dia_offsets_meta(counts, sc=sc)
        nnz, max_count, up, uq, u_ok, u_offs = (
            int(x) for x in np.asarray(meta))  # host sync
    # uniform-rows fast emit: take it when the all-full interior run
    # covers at least half the output (otherwise the two edge gathers
    # approach the cost of one full gather and the split buys nothing)
    uniform = None
    if (cfg.dia_uniform_emit and u_ok and nnz > 0
            and (uq - up) * sc >= nnz // 2):
        uniform = (up, uq, u_offs)
    # staged planes are 2 int32-sized planes per (row, diag) slot
    staged = ((cols_s, vals_s)
              if 2 * sc * m <= cfg.fused_staging_budget else None)
    return SpgemmPlan(
        A=A, B=B, cfg=cfg, row_offsets=row_offsets, nnz=nnz,
        sum_products=stats.sum_products, max_count=max_count,
        dia=DiaState(span_a=sa, span_b=sb, span_c=sc, dmin_a=dmin_a,
                     dmin_b=dmin_b, slot_a=slot_a, slot_b=slot_b,
                     present=present, staged=staged, uniform=uniform),
    )


import functools


@functools.partial(jax.jit, static_argnames=("span",))
def _diag_bitmap_dev(indptr, indices, dmin, *, span: int):
    """Presence bitmap over diagonal offsets (col - row - dmin): one
    O(nnz) device pass (boundary scatter + blocked cumsum + max
    scatter)."""
    nnz = indices.shape[0]
    marks = jnp.zeros((nnz,), jnp.int32).at[indptr[1:-1]].add(
        1, mode="drop")
    rid = cumsum1d(marks)
    d = jnp.clip(indices - rid - dmin, 0, span - 1)
    return jnp.zeros((span,), jnp.int32).at[d].max(1, mode="drop")


# past this span the device bitmap fetch outweighs the host bincount
_DIAG_DEV_SPAN_MAX = 1 << 22


def _diag_offsets(dev, h, dmin: int, span: int) -> np.ndarray:
    """Distinct diagonal offsets (col - row) present in a matrix.

    Device form by default (one O(nnz) vector pass + a (span,) bitmap
    fetch): the host numpy form needs an O(nnz) row-id decode
    (repeat/bincount+cumsum passes over 28.6M nnz for the stencil
    class). Falls back to host bincount for
    spans past the fetch-size cutoff or device-less calls."""
    if dev is not None and span <= _DIAG_DEV_SPAN_MAX:
        bm = np.asarray(_diag_bitmap_dev(dev.indptr, dev.indices,
                                         jnp.int32(dmin), span=span))
        return np.flatnonzero(bm) + dmin
    ip = np.asarray(h.row_offsets, np.int64)
    rid = np.repeat(np.arange(h.rows, dtype=np.int64), ip[1:] - ip[:-1])
    d = np.asarray(h.col_ids, np.int64) - rid
    return np.flatnonzero(np.bincount(d - dmin, minlength=span)) + dmin


def _sdia_gate(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR, ah, bh, hg):
    """Sparse-DIA eligibility (host-only; needs the attached HostCSR
    copies): present-offset lists small enough (pair cap), band range
    within sdia_span_cap, work m*nd_a*nd_b within dia_waste_cap of the
    true product count, planes within dia_mem_budget. Returns
    (off_a, off_b, span_a, span_b) or None."""
    if not cfg.enable_sdia or ah is None or bh is None:
        return None
    if not (hg.a_dmin <= hg.a_dmax and hg.b_dmin <= hg.b_dmax):
        return None
    m, n = A.shape[0], B.shape[1]
    k = A.shape[1]
    span_a = hg.a_dmax - hg.a_dmin + 1
    span_b = hg.b_dmax - hg.b_dmin + 1
    if span_a > cfg.sdia_span_cap or span_b > cfg.sdia_span_cap:
        return None
    # nd_a >= nnz/m (a row's nonzeros sit on distinct diagonals), so the
    # pair cap is provably unreachable when the average row is too long —
    # skip the O(nnz) scans outright
    if ah.nnz * bh.nnz > cfg.sdia_pair_cap * m * bh.rows:
        return None
    off_a = _diag_offsets(A, ah, hg.a_dmin, span_a)
    off_b = off_a if bh is ah else _diag_offsets(B, bh, hg.b_dmin,
                                                 span_b)
    nd_a, nd_b = len(off_a), len(off_b)
    if nd_a * nd_b > cfg.sdia_pair_cap:
        return None
    off_c = np.unique(off_a[:, None] + off_b[None, :])
    nd_c = len(off_c)
    if max(nd_a * m, nd_b * k, nd_c * m) >= 2 ** 31:
        return None
    if m * nd_a * nd_b > cfg.dia_waste_cap * max(hg.sum_products, 1.0):
        return None
    pad_l, pad_r = sdia_pad(tuple(int(x) for x in off_a), m, k)
    itemsize = jnp.dtype(A.data.dtype).itemsize
    if sdia_plane_bytes(m, k, nd_a, nd_b, nd_c, k + pad_l + pad_r,
                        itemsize) > cfg.dia_mem_budget:
        return None
    return off_a, off_b, span_a, span_b


def _plan_sdia(A: DeviceCSR, B: DeviceCSR, cfg: SpgemmConfig,
               timings: Optional[Timings], stats, off_a, off_b,
               span_a: int, span_b: int, *, track: bool) -> SpgemmPlan:
    """Complete a sparse-DIA plan (ops/dia.py sdia_conv): planes indexed
    by the present-offset lists, fused count+numeric, one nnz readback —
    the path for the 3-D stencil class (nlpkkt) whose 27 diagonals
    spread over a band the contiguous gate rejects."""
    m, n = A.shape[0], B.shape[1]
    k = A.shape[1]
    hg = stats
    ta = tuple(int(x) for x in off_a)
    tb = tuple(int(x) for x in off_b)
    off_c = np.unique(np.asarray(off_a)[:, None] + np.asarray(off_b)[None, :])
    tc = tuple(int(x) for x in off_c)
    nd_a, nd_b, nd_c = len(ta), len(tb), len(tc)
    dmin_a, dmin_b = hg.a_dmin, hg.b_dmin
    with StageTimer(timings, "spGEMMCounting", track) as st:
        lut_a = jnp.asarray(sdia_lut(off_a, dmin_a, span_a))
        slot_a = sdia_slots(A.indptr, A.indices, lut_a, dmin=dmin_a,
                            rows=m)
        if (B.indices is A.indices and B.data is A.data
                and B.shape == A.shape):
            slot_b = slot_a
            av, ah_p = dia_planes(slot_a, A.data, span=nd_a, rows=m)
            bv, bh_p = av, ah_p
        else:
            lut_b = jnp.asarray(sdia_lut(off_b, dmin_b, span_b))
            slot_b = sdia_slots(B.indptr, B.indices, lut_b, dmin=dmin_b,
                                rows=k)
            av, ah_p = dia_planes(slot_a, A.data, span=nd_a, rows=m)
            bv, bh_p = dia_planes(slot_b, B.data, span=nd_b, rows=k)
        c_val, c_cnt = sdia_conv_blocked(av, ah_p, bv, bh_p, off_a=ta,
                                         off_b=tb, off_c=tc, m=m, k=k,
                                         with_hit=True)
        doffs = jnp.asarray(off_c.astype(np.int32))
        counts, present, cols_s, vals_s = dia_count_stage(
            c_val, c_cnt, doffs, sc=nd_c, m=m, n_cols=n, base_c=0,
            impl=cfg.stream_compact_impl)
        st.stop(counts)
    with StageTimer(timings, "allocC", track):
        row_offsets, meta = dia_offsets_meta(counts, sc=nd_c)
        nnz, max_count, up, uq, u_ok, u_offs = (
            int(x) for x in np.asarray(meta))  # host sync
    uniform = None
    if (cfg.dia_uniform_emit and u_ok and nnz > 0
            and (uq - up) * nd_c >= nnz // 2):
        uniform = (up, uq, u_offs)
    staged = ((cols_s, vals_s)
              if 2 * nd_c * m <= cfg.fused_staging_budget else None)
    return SpgemmPlan(
        A=A, B=B, cfg=cfg, row_offsets=row_offsets, nnz=nnz,
        sum_products=stats.sum_products, max_count=max_count,
        dia=DiaState(span_a=nd_a, span_b=nd_b, span_c=nd_c,
                     dmin_a=dmin_a, dmin_b=dmin_b, slot_a=slot_a,
                     slot_b=slot_b, present=present, staged=staged,
                     uniform=uniform, off_a=ta, off_b=tb, doffs=doffs),
    )


def _host_dia_rows_plausible(ah, bh, cfg: SpgemmConfig) -> bool:
    """O(rows) host twin of the per-row DIA split's robust-band gate
    (stream.plan_device_stream, 5%-per-side order statistics of the
    per-row diagonal extents): when even the robust band blows the span
    cap, the split provably cannot engage, and the O(nnz) device
    machinery (extent sorts + the all-B-rows-in-band segment_min over
    every A slot) is pure waste (seconds of planning on the 50M-nnz
    giant-row bench before the H100 port)."""

    def robust(ipx, cix, rows):
        ip = np.asarray(ipx, np.int64)
        ci = np.asarray(cix, np.int64)
        lens = ip[1:] - ip[:-1]
        ne = lens > 0
        n_ne = int(ne.sum())
        if n_ne == 0:
            return 0, -1
        rid = np.arange(int(rows), dtype=np.int64)
        first = ci[np.minimum(ip[:-1], max(ci.size - 1, 0))] - rid
        last = ci[np.maximum(ip[1:] - 1, 0)] - rid
        pad = n_ne // 20
        fs = np.sort(first[ne])
        ls = np.sort(last[ne])
        return int(fs[min(pad, n_ne - 1)]), int(ls[max(n_ne - 1 - pad, 0)])

    dlo_a, dhi_a = robust(ah.row_offsets, ah.col_ids, ah.rows)
    dlo_b, dhi_b = robust(bh.row_offsets, bh.col_ids, bh.rows)
    return bool(dhi_a >= dlo_a and dhi_b >= dlo_b
                and dhi_a - dlo_a + 1 <= cfg.dia_span_cap
                and dhi_b - dlo_b + 1 <= cfg.dia_span_cap)


def _host_dense_plausible(ah, tile_rows: int, kw_max: int,
                          bh=None, cw_max: int = 0) -> bool:
    """O(rows) (+ one O(nnz) gather when ``bh`` is given) host
    pre-reject for the dense-tile route: a row tile is eligible
    only if its A column RANGE fits the k-window AND its OUTPUT column
    range (union of referenced B rows' col ranges) fits the c-window;
    tile ranges are min/max of per-row first/last columns (canonical
    CSR). When NO tile passes these necessary conditions, the device
    tile_stats pass (O(nnz) k-range scans, wasted on the giant-row bench
    and on the rect config, where random P columns make every tile's
    output span blow the window) is skipped."""
    ip = np.asarray(ah.row_offsets, np.int64)
    ci = np.asarray(ah.col_ids, np.int64)
    m = int(ah.rows)
    if m == 0 or ci.size == 0:
        return False
    lens = ip[1:] - ip[:-1]
    ne = lens > 0
    INTM = np.iinfo(np.int64).max

    def tiles(first, last):
        nt = -(-m // tile_rows)
        padn = nt * tile_rows - m
        f = (np.concatenate([first, np.full(padn, INTM, np.int64)])
             if padn else first)
        la = (np.concatenate([last, np.full(padn, -1, np.int64)])
              if padn else last)
        return (f.reshape(nt, tile_rows).min(axis=1),
                la.reshape(nt, tile_rows).max(axis=1))

    first = np.where(ne, ci[np.minimum(ip[:-1], ci.size - 1)], INTM)
    last = np.where(ne, ci[np.maximum(ip[1:] - 1, 0)], -1)
    tmin, tmax = tiles(first, last)
    ok = (tmax >= 0) & (tmax - tmin + 1 <= kw_max)
    if not ok.any():
        return False
    if bh is None or cw_max <= 0:
        return True
    # output-span necessary condition: per-A-row out range = min/max of
    # referenced B rows' first/last columns (one O(nnz) host gather)
    bip = np.asarray(bh.row_offsets, np.int64)
    bci = np.asarray(bh.col_ids, np.int64)
    if bci.size == 0:
        return False
    bne = (bip[1:] - bip[:-1]) > 0
    bfirst = np.where(bne, bci[np.minimum(bip[:-1], bci.size - 1)], INTM)
    blast = np.where(bne, bci[np.maximum(bip[1:] - 1, 0)], -1)
    cmin = np.full(m, INTM, np.int64)
    cmax = np.full(m, -1, np.int64)
    starts = np.minimum(ip[:-1], max(ci.size - 1, 0))
    vf = bfirst[ci]
    vl = blast[ci]
    if ci.size:
        rmin = np.minimum.reduceat(vf, starts)
        rmax = np.maximum.reduceat(vl, starts)
        cmin = np.where(ne, rmin, INTM)
        cmax = np.where(ne, rmax, -1)
    cmin_t, cmax_t = tiles(cmin, cmax)
    return bool((ok & (cmax_t >= 0)
                 & (cmax_t - cmin_t + 1 <= cw_max)).any())


def _dia_spans(cfg: SpgemmConfig, A: DeviceCSR, B: DeviceCSR,
               a_dmin: int, a_dmax: int, b_dmin: int, b_dmax: int,
               sp_sat: int):
    """DIA fast-path eligibility (ops/dia.py) from the gate scalars:
    returns (span_a, span_b) when the whole multiply should run over
    diagonal planes, else None. Hard int32 guard independent of the
    (INI-raisable) memory budget: plane slot arithmetic is span*rows +
    row in int32 (dia_slots), and the staging compaction flattens to
    m*sc."""
    if not (a_dmin <= a_dmax and b_dmin <= b_dmax):
        return None
    m, n = A.shape[0], B.shape[1]
    sa = a_dmax - a_dmin + 1
    sb = b_dmax - b_dmin + 1
    itemsize = jnp.dtype(A.data.dtype).itemsize
    sc_g = sa + sb - 1
    if (sa <= cfg.dia_span_cap and sb <= cfg.dia_span_cap
            and max(sa * m, sb * A.shape[1], sc_g * m) < 2 ** 31
            and m * sa * sb <= cfg.dia_waste_cap * max(sp_sat, 1)
            and plane_bytes(m, A.shape[1], n, sa, sb, itemsize)
            <= cfg.dia_mem_budget):
        return sa, sb
    return None


def _check_limits(cfg: SpgemmConfig, sp_sat: int, mxrow_sat: int):
    """int32 stream-position ceiling: beyond this the tight layout's
    cumsums wrap and the plan would be garbage. spgemm() catches and
    re-runs as row blocks (the reference's analogue is its hard 2^27
    dimension limit, Multiply.cu:57-66; we lift it by auto-blocking
    instead of refusing). A row with >= 2^30 products can also wrap its
    own int32 row_ops (the analysis pass is only per-row exact below
    2^31, analysis.py); both totals come from the wrap-immune f32 twin
    in the gate scalars."""
    if mxrow_sat >= 1 << 30:
        raise ProductOverflow(
            f"a single row has ~{mxrow_sat} intermediate products, "
            "near the int32 per-row ceiling; shard over a mesh "
            "(parallel/mesh_stream.py)")
    if sp_sat >= cfg.block_products:
        raise ProductOverflow(
            f"~{sp_sat:.3g} intermediate products exceed one plan's "
            f"budget ({cfg.block_products}); use spgemm() (auto row "
            "blocking) or shard over a mesh")


def plan_spgemm(
    A: DeviceCSR,
    B: DeviceCSR,
    cfg: Optional[SpgemmConfig] = None,
    timings: Optional[Timings] = None,
) -> SpgemmPlan:
    """Analysis + planning + symbolic counting: everything up to (and
    including) C's row offsets."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(
            f"dimension mismatch: A is {A.shape}, B is {B.shape}"
        )
    cfg = cfg or SpgemmConfig()
    m, n = A.shape[0], B.shape[1]
    track = timings is not None and timings.measure_all

    if m == 0 or A.nnz == 0:
        # empty product: C has m all-empty rows (early exit parity with
        # sumProducts == 0, Multiply.cu:256-261)
        return SpgemmPlan(
            A=A, B=B, cfg=cfg,
            row_offsets=jnp.zeros((m + 1,), jnp.int32), nnz=0,
            sum_products=np.asarray(0.0, jnp.result_type(float)),
        )

    hg = None
    ah = bh = None
    if cfg.host_analysis and m > 0 and A.nnz > 0:
        ah, bh = host_of(A), host_of(B)
        if ah is None or (bh is None and B is not A):
            ah = bh = None
    if ah is not None and A.nnz <= cfg.host_analysis_max_nnz:
        # analysis + gate scalars on host numpy (HostCSR copies kept
        # by device_put_csr): no analysis dispatch, no gate readback
        # — every planning decision below needs ZERO device syncs
        with StageTimer(timings, "countProducts", track):
            hg = host_analyze(ah, ah if (B is A or bh is ah) else bh)

    dia_possible = bool(
        cfg.enable_dia and A.canonical and B.canonical
        and A.nnz > 0 and B.nnz > 0)
    # host-side band plausibility (free, no readback): a canonical row
    # with L nonzeros spans >= L diagonals, so span_a >= max row nnz >=
    # nnz/m. When the average row alone exceeds the span cap, DIA is
    # provably ineligible and the early gate readback would be a pure
    # waste — fall through to the fused form where the gate scalars
    # ride the planning readback.
    band_plausible = bool(
        A.nnz <= m * cfg.dia_span_cap
        and B.nnz <= max(B.shape[0], 1) * cfg.dia_span_cap)
    gate_done = False
    dia_lite_rejected = False
    if hg is None and ah is not None and dia_possible:
        # LITE host gate for inputs past host_analysis_max_nnz: band
        # extremes are O(rows) (first/last columns) and sum_products is
        # one gather-free bincount dot — so a 28M-nnz 27-point stencil
        # still takes the sparse-DIA route (far cheaper than the
        # stream) without the O(nnz) host
        # gather the full analysis would pay. A lite MISS is exact
        # (same band math, exact product total), so the device early
        # gate below is skipped as redundant.
        with StageTimer(timings, "loadBalanceCounting", track):
            bh_eff = ah if (B is A or bh is ah) else bh
            ext = host_band_extremes(ah, bh_eff)
            a0, a1, b0, b1 = ext
            sa_l, sb_l = a1 - a0 + 1, b1 - b0 + 1
            contig_ok = bool(
                a0 <= a1 and b0 <= b1 and sa_l <= cfg.dia_span_cap
                and sb_l <= cfg.dia_span_cap)
            sdia_ok = bool(
                cfg.enable_sdia and a0 <= a1 and b0 <= b1
                and sa_l <= cfg.sdia_span_cap
                and sb_l <= cfg.sdia_span_cap
                and ah.nnz * bh_eff.nnz
                <= cfg.sdia_pair_cap * m * bh_eff.rows)
            if contig_ok or sdia_ok:
                lite = host_gate_lite(ah, bh_eff, ext)
                spans = _dia_spans(cfg, A, B, lite.a_dmin, lite.a_dmax,
                                   lite.b_dmin, lite.b_dmax, lite.sp_sat)
                if spans is not None:
                    return _plan_dia(A, B, cfg, timings, lite,
                                     lite.a_dmin, lite.b_dmin,
                                     spans[0], spans[1], track)
                sd = _sdia_gate(cfg, A, B, ah, bh_eff, lite)
                if sd is not None:
                    return _plan_sdia(A, B, cfg, timings, lite, *sd,
                                      track=track)
            dia_lite_rejected = True
    if hg is None:
        with StageTimer(timings, "countProducts", track) as st:
            stats = analyze(A, B)
            st.stop(stats.row_ops)
    if hg is not None:
        # host gate: same decisions as plan_gate, no device round trip
        with StageTimer(timings, "loadBalanceCounting", track):
            if dia_possible:
                spans = _dia_spans(cfg, A, B, hg.a_dmin, hg.a_dmax,
                                   hg.b_dmin, hg.b_dmax, hg.sp_sat)
                if spans is not None:
                    return _plan_dia(A, B, cfg, timings, hg,
                                     hg.a_dmin, hg.b_dmin,
                                     spans[0], spans[1], track)
                # sparse DIA: offset LISTS (stencil class) — host-only
                # gate, needs the attached HostCSR for the offset scan
                sd = _sdia_gate(cfg, A, B, ah,
                                ah if (B is A or bh is ah) else bh, hg)
                if sd is not None:
                    return _plan_sdia(A, B, cfg, timings, hg, *sd,
                                      track=track)
            _check_limits(cfg, hg.sp_sat, hg.mxrow_sat)
            gate_done = True
            stats = hg.to_device()
    elif (dia_possible and cfg.dia_gate_early and band_plausible
          and not dia_lite_rejected):
        # early routing gate: read back ONLY the 7 gate scalars before
        # dispatching the O(m log m) stream/dense planning. When DIA
        # wins, that speculative planning never runs; when it loses,
        # the overflow guards already ran, so the row-blocked path skips
        # a full wasted plan. Cost on a losing gate: one extra small
        # readback.
        with StageTimer(timings, "loadBalanceCounting", track):
            gate = np.asarray(plan_gate(
                A.indptr, A.indices, B.indptr, B.indices,
                stats.row_ops, stats.row_ops_f, m=m))
            (a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat,
             sp_exact) = (int(x) for x in gate)
            spans = _dia_spans(cfg, A, B, a_dmin, a_dmax, b_dmin, b_dmax,
                               sp_sat)
            if spans is not None:
                return _plan_dia(A, B, cfg, timings, stats,
                                 a_dmin, b_dmin, spans[0], spans[1],
                                 track)
            _check_limits(cfg, sp_sat, mxrow_sat)
            gate_done = True

    with StageTimer(timings, "loadBalanceCounting", track):
        direct_ok = bool(B.canonical) and cfg.enable_direct
        use_dense = bool(
            cfg.enable_dense and A.canonical and B.canonical
            and m > 0 and A.nnz > 0 and B.nnz > 0
        )
        tr = cfg.dense_tile_rows
        max_tiles = max(0, cfg.fused_staging_budget // (tr * cfg.dense_cw))
        if use_dense and ah is not None:
            bh_d = ah if (B is A or bh is ah) else bh
            use_dense = _host_dense_plausible(
                ah, tr, cfg.dense_kw,
                bh=(bh_d if A.nnz <= cfg.host_analysis_max_nnz
                    else None),
                cw_max=cfg.dense_cw)
        f64 = not packable(A.data)
        a32 = (jnp.zeros_like(A.indices) if f64 else
               jax.lax.bitcast_convert_type(
                   A.data.astype(jnp.float32), jnp.int32))
        use_accum = bool(cfg.enable_accum and B.canonical and m > 0
                         and A.nnz > 0)
        use_dia_rows = bool(cfg.dia_rows and dia_possible)
        if use_dia_rows and ah is not None:
            use_dia_rows = _host_dia_rows_plausible(
                ah, ah if (B is A or bh is ah) else bh, cfg)
            if use_dia_rows:
                # a HOST-CONFIRMED per-row DIA split claims the banded
                # bulk, leaving dense tiles ineligible (any tile holding
                # a dia row is excluded) — the O(nnz) tile_stats pass
                # would be discarded work. Rows the device band gate
                # then rejects ride the stream instead: correct,
                # marginally slower, and rare
                # (non-banded inputs fail the host gate first).
                use_dense = False
        (rows_sorted, e, q_sorted, el, ops_sorted, e2, q2_sorted,
         cmin_sorted, nnz_init, t_r0, t_kb, t_cb, t_valid, dia_mask,
         pack) = plan_device_stream(
            A.indptr, A.indices, a32, B.indptr, B.indices,
            stats.row_ops, stats.row_ops_f, stats.a_len,
            min_q=cfg.stream_min_q, direct_ok=direct_ok,
            use_dense=use_dense and max_tiles > 0, tile_rows=tr,
            kw_max=cfg.dense_kw, cw_max=cfg.dense_cw,
            la_max=cfg.dense_la, lb_max=cfg.dense_lb,
            max_tiles=max_tiles, m=m, use_accum=use_accum,
            accum_min_ops=cfg.accum_min_ops,
            accum_span_cap=cfg.accum_span_cap, w0=cfg.stream_width,
            w_cap=cfg.stream_width_cap,
            use_dia_rows=use_dia_rows,
            dia_span_cap=cfg.dia_span_cap,
            dia_waste_cap=cfg.dia_waste_cap,
            dia_mem_budget=cfg.dia_mem_budget,
            dia_itemsize=jnp.dtype(A.data.dtype).itemsize,
        )
        pack_h = np.asarray(pack)  # the ONE planning host sync
        s_hist = pack_h[:N_QCLASS]
        d_hist = pack_h[N_QCLASS: 2 * N_QCLASS]
        a_hist = pack_h[2 * N_QCLASS: 3 * N_QCLASS]
        a_psum = pack_h[3 * N_QCLASS: 4 * N_QCLASS]
        n_elig, kw_e, cw_e, la_e, lb_e = (
            int(x) for x in pack_h[4 * N_QCLASS: 4 * N_QCLASS + 5])
        (a_dmin, a_dmax, b_dmin, b_dmax, sp_sat, mxrow_sat,
         sp_exact) = (
            int(x) for x in pack_h[4 * N_QCLASS + 5: 4 * N_QCLASS + 12])
        # per-row DIA split (robust band + routed row count)
        (dr_dlo_a, dr_dhi_a, dr_dlo_b, dr_dhi_b, n_dia) = (
            int(x) for x in pack_h[4 * N_QCLASS + 12: 4 * N_QCLASS + 17])
        # live A-slot counts (stream / accum regions): size build_srec
        n_live, n_live2 = (
            int(x) for x in pack_h[4 * N_QCLASS + 17: 4 * N_QCLASS + 19])
        # tight-layout tail (stream.py _plan_rows_impl): the rectangle
        # width (adaptive ladder computed on device), exact stream total,
        # and the wide rows' exact segment counts
        tight_h = pack_h[4 * N_QCLASS + 19:]
        W, total_q, n_wide_t, r_wide_t = (int(x) for x in tight_h[:4])

        # ---- DIA fast path (ops/dia.py) and the int32 overflow guards.
        # With the early gate (dia_gate_early, the default) both already
        # ran before the heavy planning above; this is the fallback for
        # EnableDia=false / DiaGateEarly=false / non-canonical inputs,
        # where the scalars ride the single planning readback instead.
        if not gate_done:
            if dia_possible:
                spans = _dia_spans(cfg, A, B, a_dmin, a_dmax, b_dmin,
                                   b_dmax, sp_sat)
                if spans is not None:
                    return _plan_dia(A, B, cfg, timings, stats,
                                     a_dmin, b_dmin, spans[0], spans[1],
                                     track)
            _check_limits(cfg, sp_sat, mxrow_sat)
        # wide-row exact segment counts: from the pack when they fit its
        # N_WSEG_PACK window, else ONE extra fetch of the wide rows' ops
        n_accum_h = int(a_hist.sum())
        if n_wide_t <= N_WSEG_PACK:
            wide_segs = tight_h[4: 4 + n_wide_t].astype(np.int64)
        else:
            wide_ops = np.asarray(
                ops_sorted[n_accum_h: n_accum_h + n_wide_t], np.int64)
            wide_segs = -(-wide_ops // W)
        layout = plan_layout(
            s_hist, d_hist, W, cfg.product_budget, total_q=total_q,
            n_wide=n_wide_t, r_wide=r_wide_t, wide_segs=wide_segs)
        lplans = plan_levels(layout, F=cfg.stream_level_factor,
                             max_width=cfg.stream_max_width)
        # accumulator region sorts FIRST: every layout-derived row offset
        # (stream rid bases, direct class starts) shifts by n_accum
        n_accum, total_p2, n_chunks2, accum_parts, abase_h = _plan_accum(
            a_hist, a_psum, layout.G * W, cfg.accum_budget)

        # direct-copy chunk groups per copy-length class; the accumulator
        # region sorts BEFORE the stream region, so every layout-derived
        # row offset shifts by n_accum
        groups: List[DirectGroup] = []
        max_chunk_rows = 1
        for cap, start, count in layout.direct_classes:
            start = start + n_accum
            full = max(1, 4 * cfg.product_budget // cap)
            rpc = _bucket_rows(count, full)
            max_chunk_rows = max(max_chunk_rows, rpc)
            n_chunks = math.ceil(count / rpc)
            k = _pow2(n_chunks)
            starts = np.zeros(k, np.int32)
            valids = np.zeros(k, np.int32)
            for c in range(n_chunks):
                starts[c] = start + c * rpc
                valids[c] = min(rpc, count - c * rpc)
            groups.append(DirectGroup(cap=cap, rows=rpc, starts=starts,
                                      valids=valids))
        rows_padded = jnp.concatenate(
            [rows_sorted, jnp.zeros((max_chunk_rows,), jnp.int32)])

        dense_grp = None
        if n_elig > 0:
            db = max(1, cfg.dense_tiles_per_dispatch)
            n_full, tail = divmod(n_elig, db)
            k = n_full * db + (_pow2(tail) if tail else 0)
            boffs = [i * db for i in range(n_full + 1)]
            if tail:
                boffs.append(k)
            if k > t_r0.shape[0]:
                padn = k - t_r0.shape[0]
                t_r0 = jnp.concatenate(
                    [t_r0, jnp.full((padn,), m, jnp.int32)])
                t_kb = jnp.concatenate([t_kb, jnp.zeros((padn,), jnp.int32)])
                t_cb = jnp.concatenate([t_cb, jnp.zeros((padn,), jnp.int32)])
                t_valid = jnp.concatenate(
                    [t_valid, jnp.zeros((padn,), jnp.int32)])

            def _ceil128(v):
                return max(128, -(-int(v) // 128) * 128)

            dense_grp = DenseGroup(
                r0s=t_r0[:k], kbases=t_kb[:k], cbases=t_cb[:k],
                valids=t_valid[:k], boffs=boffs, tile_rows=tr,
                kw=_ceil128(kw_e), cw=_ceil128(cw_e),
                la=_pow2(max(8, la_e)), lb=_pow2(max(8, lb_e)),
                full_cover=(n_elig == -(-m // tr)),
            )

        # ---- per-row DIA split group (device gate passed: n_dia > 0) ----
        dia_grp: Optional[DiaRowGroup] = None
        if n_dia > 0:
            dr_sa = dr_dhi_a - dr_dlo_a + 1
            dr_sb = dr_dhi_b - dr_dlo_b + 1
            slot_a = dia_slots(A.indptr, A.indices, dia_mask,
                               dmin=dr_dlo_a, span=dr_sa, rows=m,
                               masked=True)
            b_in = dia_row_inband(B.indptr, B.indices, dmin=dr_dlo_b,
                                  dmax=dr_dhi_b)
            slot_b = dia_slots(B.indptr, B.indices, b_in, dmin=dr_dlo_b,
                               span=dr_sb, rows=B.shape[0], masked=True)
            dia_grp = DiaRowGroup(
                span_a=dr_sa, span_b=dr_sb, span_c=dr_sa + dr_sb - 1,
                dmin_a=dr_dlo_a, dmin_b=dr_dlo_b,
                slot_a=slot_a, slot_b=slot_b,
                present=jnp.zeros((0, 0), bool))

        pack_bits = int(n + 1).bit_length()
        if (W // cfg.stream_min_q) * (1 << pack_bits) >= 2**31:
            pack_bits = 0
        G = layout.G
        CP = G * W
        # O(nnz) A-slot records only when stream rows exist (pure dense /
        # direct matrices skip the whole build)
        if layout.total_q > 0:
            nl_eff = min(_pow2(max(n_live, 1)), A.nnz)
            # single-window regime: every record is visible to every
            # chunk, so the zero-product-slot compaction is skippable
            # (equal-p0 winner logic resolves them) — ~40% of this pass
            single_win = nl_eff <= G * W + 2
            p0, su, sa, src, pend = build_srec(
                A.indptr, A.indices, a32, B.indptr[:-1],
                B.indptr[1:] - B.indptr[:-1], rows_sorted, e, q_sorted,
                m=m, nl=_pow2(max(n_live, 1)), compact=not single_win,
                pack_gathers=nl_eff <= (1 << 23))
            cks = jnp.arange(max(layout.n_chunks, 1),
                             dtype=jnp.int32) * CP
            sid_bases = jnp.searchsorted(p0, cks).astype(jnp.int32)
            # rows with e < chunk start (accum rows' -1 sentinels are
            # counted, matching the decode convention)
            rid_bases = jnp.searchsorted(e, cks).astype(jnp.int32)
        else:
            p0 = jnp.zeros((1,), jnp.int32)
            su = jnp.zeros((1,), jnp.int32)
            sa = jnp.zeros((1,), jnp.int32)
            pend = jnp.zeros((1,), jnp.int32)
            src = jnp.zeros((1,), jnp.int32)
            sid_bases = jnp.zeros((1,), jnp.int32)
            rid_bases = jnp.zeros((1,), jnp.int32)
        # fused staging: 3 int32 planes per stream slot + the dense tiles
        staging = 3 * layout.total_q + (
            dense_grp.staging_slots if dense_grp else 0)
        fused = staging <= cfg.fused_staging_budget
        ss = StreamState(
            layout=layout, lplans=lplans, rows_sorted=rows_sorted,
            rows_padded=rows_padded, e=e, q_sorted=q_sorted, el=el,
            ops_sorted=ops_sorted, p0=p0, su=su, sa=sa, pend=pend, src=src,
            sid_bases=sid_bases, rid_bases=rid_bases,
            pack_bits=pack_bits, fused=fused,
            wide_rid_in=(jnp.asarray(
                n_accum + np.repeat(np.arange(layout.n_wide),
                                    layout.wide_segs),
                jnp.int32) if layout.n_wide
                else jnp.zeros((0,), jnp.int32)),
            n_accum=n_accum,
        )
        ss.rowend = jnp.where(q_sorted > 0, e + ops_sorted, -1)
        if n_accum and n_chunks2:
            p02, su2, sa2, src2, pend2 = build_srec(
                A.indptr, A.indices, a32, B.indptr[:-1],
                B.indptr[1:] - B.indptr[:-1], rows_sorted, e2, q2_sorted,
                m=m, nl=_pow2(max(n_live2, 1)))
            cks = jnp.arange(max(n_chunks2, 1), dtype=jnp.int32) * CP
            ss.e2, ss.p02, ss.src2 = e2, p02, src2
            ss.su2, ss.sa2, ss.pend2 = su2, sa2, pend2
            ss.rowend2 = jnp.where(q2_sorted > 0, e2 + q2_sorted, -1)
            ss.sid_bases2 = jnp.searchsorted(p02, cks).astype(jnp.int32)
            ss.rid_bases2 = jnp.searchsorted(e2, cks).astype(jnp.int32)
            ss.cmin_s = cmin_sorted
            ss.abase = jnp.asarray(abase_h)
            ss.accum = dict(n_chunks2=n_chunks2, parts=accum_parts,
                            G=G, W=W)

    with StageTimer(timings, "spGEMMCounting", track) as st:
        nnz_row = nnz_init
        dense_staged: Optional[List[tuple]] = None
        raw_chunks: List[int] = []
        if dia_grp is not None:
            dg = dia_grp
            c_val, c_cnt = dia_rows_conv_fused(
                dg.slot_a, A.data, dg.slot_b, B.data, sa=dg.span_a,
                sb=dg.span_b, m=m, k=A.shape[1], dmin_a=dg.dmin_a,
                with_hit=True)
            dg.present = c_cnt.T > 0.5   # exact: fp32 counts of 1.0 adds
            dg.cvT = c_val.T
            nnz_row = nnz_row + jnp.sum(
                dg.present, axis=1, dtype=jnp.int32)
        if dense_grp is not None:
            apk = None if f64 else pack_csr_arrays(A.indices, A.data)
            bpk = apk if (B.indices is A.indices and B.data is A.data) \
                else (None if f64 else pack_csr_arrays(B.indices, B.data))
            dense_staged = []
            for r0s, kbs, cbs, _ in dense_grp.batches():
                nnz_row, st_b = dense_tiles(
                    r0s, kbs, cbs,
                    A.indptr, A.indices, A.data,
                    B.indptr, B.indices, B.data, nnz_row, apk, bpk,
                    tile_rows=dense_grp.tile_rows, kw=dense_grp.kw,
                    cw=dense_grp.cw, la=dense_grp.la, lb=dense_grp.lb,
                    m=m, k_dim=A.shape[1], n_cols=n,
                    densify=cfg.dense_densify,
                )
                dense_staged.append(st_b)
        if layout.n_chunks > 0 and layout.total_q > 0:
            f64 = not packable(A.data)
            b_packed = (jnp.zeros((1, 2), jnp.int32) if f64 else
                        pack_csr_arrays(B.indices,
                                        B.data.astype(jnp.float32)))
            # per-chunk dispatches: enqueueing is asynchronous, only
            # host syncs stall, and a fused all-chunks mega-jit
            # segfaulted the XLA:CPU compiler, so one launch per chunk
            # stays
            staged = []
            for c in range(layout.n_chunks):
                has_wide = c * G < layout.r_wide
                # last chunk runs at its live rect-row count (g_last)
                Gc = (layout.g_last if c == layout.n_chunks - 1 else G)
                # fused contained-only chunks stage RAW (sorted,
                # uncompacted): when the plan turns out duplicate-free
                # the compact pass never runs (see below); wide chunks
                # compact here because the merge levels consume them
                # before the nnz readback
                stage_raw = fused and not has_wide
                if stage_raw:
                    raw_chunks.append(c)
                nnz_row, stg = stream_chunk(
                    rows_sorted, e, ss.rowend, q_sorted, el, ops_sorted,
                    p0, su, sa, pend, b_packed, B.indices, B.data, A.data,
                    src, nnz_row,
                    jnp.int32(c * CP), rid_bases[c], sid_bases[c],
                    G=Gc, W=W, n_cols=n, pack_bits=pack_bits,
                    stage=fused or has_wide, f64=f64,
                    compact_impl=cfg.stream_compact_impl,
                    stage_raw=stage_raw,
                    expand_impl=cfg.stream_expand_impl)
                staged.append(stg)
            nw_chunks = -(-layout.r_wide // G) if layout.r_wide else 0
            nnz_row, level_bufs = _run_wide(
                ss, staged[:nw_chunks], nnz_row, n, count=True,
                max_width=cfg.stream_max_width,
                compact_impl=cfg.stream_compact_impl)
            ss.staged = staged if fused else None
            ss.level_bufs = level_bufs
        if ss.accum:
            nnz_row, accum_bufs = _run_accum(
                ss, A, B, nnz_row, n, count=True,
                expand_impl=cfg.stream_expand_impl)
            ss.accum_bufs = accum_bufs
        st.stop(nnz_row)

    with StageTimer(timings, "allocC", track):
        row_offsets, meta = _offsets_from_counts(nnz_row)
        nnz, max_count = (int(x) for x in np.asarray(meta))  # ONE host sync
        # (Multiply.cu:572-575); max_count trims dense emit widths

        # no-duplicate fast path: nnz(C) == exact product total means
        # every live staged slot is a run-last, so the RAW chunks are
        # already element-identical to their compacted form. Otherwise
        # compact them now (device work rides the same sync window).
        if ss is not None and ss.staged is not None and raw_chunks \
                and nnz != sp_exact:
            for c in raw_chunks:
                rid_r, col_r, val_r, counts_r = ss.staged[c]
                ss.staged[c] = compact_staged(
                    rid_r, col_r, val_r, counts_r, n_cols=n,
                    compact_impl=cfg.stream_compact_impl)

    return SpgemmPlan(
        A=A, B=B, cfg=cfg,
        row_offsets=row_offsets, nnz=nnz,
        sum_products=stats.sum_products,
        stream=ss, groups=groups, dense=dense_grp,
        dense_staged=dense_staged, max_count=max_count,
        dia_rows=dia_grp,
    )


def spgemm(
    A: DeviceCSR,
    B: DeviceCSR,
    cfg: Optional[SpgemmConfig] = None,
    timings: Optional[Timings] = None,
) -> DeviceCSR:
    """C = A @ B on device: exact two-phase SpGEMM with sorted rows.

    Public entry point; parity with spECK::MultiplyspECK
    (/root/reference/include/Multiply.h:15-19)."""
    import time

    track_complete = timings is not None and timings.measure_complete
    t0 = time.perf_counter()
    try:
        plan = plan_spgemm(A, B, cfg, timings)
        C = plan.execute(timings=timings)
    except ProductOverflow:
        C = _spgemm_blocked(A, B, cfg or SpgemmConfig(), timings)
    if track_complete:
        jax.block_until_ready(C.data)
        timings.add("complete", (time.perf_counter() - t0) * 1e3)
    return C


def _spgemm_blocked(
    A: DeviceCSR,
    B: DeviceCSR,
    cfg: SpgemmConfig,
    timings: Optional[Timings] = None,
) -> DeviceCSR:
    """C = A @ B as a sequence of row-block multiplies when the total
    product count exceeds one plan's int32 stream budget.

    Rows are split greedily so each block carries at most
    ``block_products // 2`` products (half the trigger, so a block never
    re-triggers), each block runs the normal plan/execute, and the block
    results concatenate into one CSR. Two extra host fetches pay for the
    split (per-row ops and A's row offsets) — this path only runs on
    multi-billion-product calls where they are noise."""
    m, n = A.shape[0], B.shape[1]
    budget = max(1, cfg.block_products // 2)
    # split on wrap-immune per-row counts: exact int64 from the host
    # analysis when the HostCSR copies are attached, else the f32 twin
    # (rounding ~1e-7 relative, harmless for budget math)
    ah, bh = host_of(A), host_of(B)
    if (cfg.host_analysis and A.nnz <= cfg.host_analysis_max_nnz
            and ah is not None and (bh is not None or B is A)):
        row_ops = host_analyze(ah, ah if (B is A or bh is ah) else bh
                               ).row_ops
    else:
        row_ops = np.maximum(
            np.asarray(analyze(A, B).row_ops_f, np.float64), 0.0
        ).astype(np.int64)
    widest = int(row_ops.max(initial=0))
    if widest > budget:
        raise ProductOverflow(
            f"a single row has {widest} products, above the per-block "
            f"budget ({budget}); shard over a mesh or raise "
            "BlockProducts")
    indptr_h = np.asarray(A.indptr, np.int64)
    cum = np.cumsum(row_ops)
    blocks = []
    r0 = 0
    while r0 < m:
        base = int(cum[r0 - 1]) if r0 else 0
        r1 = int(np.searchsorted(cum, base + budget, side="right"))
        r1 = min(m, max(r1, r0 + 1))
        blocks.append((r0, r1))
        r0 = r1
    ip_parts, c_parts, v_parts = [], [], []
    off = 0
    for r0, r1 in blocks:
        s, t = int(indptr_h[r0]), int(indptr_h[r1])
        A_blk = DeviceCSR(
            indptr=A.indptr[r0: r1 + 1] - jnp.int32(s),
            indices=A.indices[s:t], data=A.data[s:t],
            shape=(r1 - r0, A.shape[1]), nnz=t - s,
            canonical=A.canonical,
        )
        plan = plan_spgemm(A_blk, B, cfg, timings)
        Cb = plan.execute(timings=timings)
        if off + Cb.nnz >= 2 ** 31:
            raise ProductOverflow(
                f"nnz(C) exceeds the int32 output ceiling at row {r1}")
        ip_parts.append(Cb.indptr[:-1] + jnp.int32(off))
        c_parts.append(Cb.indices[: Cb.nnz])
        v_parts.append(Cb.data[: Cb.nnz])
        off += Cb.nnz
    indptr = jnp.concatenate(
        ip_parts + [jnp.full((1,), off, jnp.int32)])
    return DeviceCSR(
        indptr=indptr,
        indices=jnp.concatenate(c_parts) if c_parts else
        jnp.zeros((0,), jnp.int32),
        data=jnp.concatenate(v_parts) if v_parts else
        jnp.zeros((0,), A.data.dtype),
        shape=(m, n), nnz=off, canonical=True,
    )
