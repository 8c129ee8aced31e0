"""Analysis pass: per-row operation counts and global totals.

A JAX re-expression of the readOperations kernel
(/root/reference/include/common.cuh:321-459): instead of a CUDA grid with
atomics, per-row FLOP counts are a gather of B row lengths at A's column ids
followed by a cumulative-sum difference at row boundaries (scatter-free,
fully vectorized, one XLA fusion). Outputs mirror the reference's:

  - row_ops[i]   = sum over A row i's nnz of len(B[a_col])   (ops per row)
  - a_len[i]     = nnz of A row i
  - work[i]      = max(row_ops, a_len) — the binning key; a row's true cost
    includes iterating its A nonzeros even when referenced B rows are empty
  - sum_products = total intermediate products (Multiply.cu:249-252),
    reported as float64 (f32 when x64 is disabled) since it is a metric /
    heuristic input, not an index
  - max_work     = maxComputationsPerRow analogue

Overflow note: the int32 cumulative sum may wrap when sum_products exceeds
2^31, but the per-row differences remain exact (two's-complement wraparound)
as long as each *row's* op count fits in int32 — the same per-row limit the
reference has (its row ops are uint32).

The reference's per-row B-column min/max (toRowColMinMax, common.cuh:303-319)
feeds its dense-mode heuristic; the dense-window path computes column
ranges the same way (see ops/dense.py) and is gated by SpgemmConfig.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .device_csr import DeviceCSR


@dataclasses.dataclass(frozen=True)
class AnalysisResult:
    row_ops: jax.Array       # (m,) int32  products per row of C
    a_len: jax.Array         # (m,) int32  nnz per row of A
    work: jax.Array          # (m,) int32  max(row_ops, a_len)
    sum_products: jax.Array  # () float    total intermediate products
    max_work: jax.Array      # () int32
    # float32 per-row product counts: exact until ~2^24, then within
    # ~1e-7 relative — the overflow detector for rows whose int32
    # row_ops would wrap (>= 2^31 products in ONE row), and the split
    # key for the auto row-blocking path (ops/spgemm._spgemm_blocked)
    row_ops_f: jax.Array     # (m,) float32


jax.tree_util.register_dataclass(
    AnalysisResult,
    data_fields=["row_ops", "a_len", "work", "sum_products", "max_work",
                 "row_ops_f"],
    meta_fields=[],
)


@dataclasses.dataclass(frozen=True)
class HostAnalysis:
    """Host-side (numpy) twin of the analysis pass PLUS the 7 routing/
    guard gate scalars (stream._gate_scalars semantics), computed from
    the HostCSR copies that device_put_csr keeps attached to uploaded
    matrices. Replaces one device dispatch (readOperations analogue) AND
    the early-gate readback with O(nnz) numpy — the planning decisions
    (DIA route, overflow guards, row blocking) then need ZERO device
    syncs. Exact int64 where the device
    twin saturates."""

    row_ops: "np.ndarray"     # (m,) int64 exact products per row
    a_len: "np.ndarray"       # (m,) int64 nnz per row of A
    sum_products: float       # exact
    max_row_products: int     # exact
    a_dmin: int               # min/max of (col - row) over A (canonical:
    a_dmax: int               # a row's first/last col id is its min/max)
    b_dmin: int
    b_dmax: int

    @property
    def sp_sat(self) -> int:
        return int(min(self.sum_products, 2.0 ** 31 - 2))

    @property
    def mxrow_sat(self) -> int:
        return int(min(self.max_row_products, 2 ** 31 - 2))

    def to_device(self) -> AnalysisResult:
        """Upload ONE per-row array (row_ops int32). a_len / row_ops_f /
        work are None — the consuming jits derive them on device
        (a_len from A's indptr, row_ops_f from row_ops, which is exact
        here because _check_limits already proved no row wrapped int32).
        One transfer instead of four."""
        work_max = int(np.maximum(self.row_ops, self.a_len)
                       .max(initial=0))
        return AnalysisResult(
            row_ops=jnp.asarray(self.row_ops.astype(np.int32)),
            a_len=None,
            work=None,
            sum_products=np.asarray(self.sum_products,
                                    jnp.result_type(float)),
            max_work=np.int32(min(work_max, 2 ** 31 - 1)),
            row_ops_f=None,
        )


def _host_band(ipx, cix, rows):
    """Exact (dmin, dmax) of (col - row) over a CANONICAL CSR: a row's
    diagonal extremes are its first/last column ids — O(rows), no
    per-nonzero work."""
    INT_MAX = np.iinfo(np.int32).max
    n_r = int(rows)
    nz = cix.shape[0]
    if nz == 0 or n_r == 0:
        return INT_MAX, -INT_MAX
    lenx = ipx[1:] - ipx[:-1]
    ne = lenx > 0
    if not ne.any():
        return INT_MAX, -INT_MAX
    ridx = np.arange(n_r, dtype=np.int64)
    first = cix[np.minimum(ipx[:-1], nz - 1)] - ridx
    last = cix[np.maximum(ipx[1:] - 1, 0)] - ridx
    return int(first[ne].min()), int(last[ne].max())


@dataclasses.dataclass(frozen=True)
class HostGateLite:
    """Whole-matrix gate scalars WITHOUT the per-row analysis: band
    extremes via first/last columns (O(m)) and exact sum_products via a
    column-count bincount dotted with B's row lengths (O(nnz),
    gather-free — numpy gathers at tens of millions of indices cost
    seconds on weak hosts, a bincount does not). Lets large banded /
    stencil inputs (nnz past host_analysis_max_nnz) still take the
    (s)DIA fast paths with zero device syncs; lacks row_ops, so a lite
    gate MISS falls through to the device analysis unchanged."""

    a_dmin: int
    a_dmax: int
    b_dmin: int
    b_dmax: int
    sum_products: float    # exact

    @property
    def sp_sat(self) -> int:
        return int(min(self.sum_products, 2.0 ** 31 - 2))


def host_band_extremes(ah, bh):
    """(a_dmin, a_dmax, b_dmin, b_dmax) — the O(rows) half of the lite
    gate, so hopeless (wide-band) inputs never pay the bincount.

    No dtype-converting asarray on the O(nnz) col_ids array (a 28.6M-nnz
    uint32->int64 copy per call); _host_band only GATHERS O(rows)
    elements from it (numpy upcasts the small gathered arrays)."""
    a_dmin, a_dmax = _host_band(
        np.asarray(ah.row_offsets, np.int64),
        np.asarray(ah.col_ids), ah.rows)
    if bh is ah:
        return a_dmin, a_dmax, a_dmin, a_dmax
    b_dmin, b_dmax = _host_band(
        np.asarray(bh.row_offsets, np.int64),
        np.asarray(bh.col_ids), bh.rows)
    return a_dmin, a_dmax, b_dmin, b_dmax


def host_gate_lite(ah, bh, extremes=None) -> HostGateLite:
    if extremes is None:
        extremes = host_band_extremes(ah, bh)
    a_dmin, a_dmax, b_dmin, b_dmax = extremes
    ci = np.asarray(ah.col_ids)       # no dtype copy (bincount upcasts)
    b_ip = np.asarray(bh.row_offsets, np.int64)
    cnt_a = np.bincount(ci, minlength=int(bh.rows)) if ci.size else \
        np.zeros(int(bh.rows), np.int64)
    b_len = b_ip[1:] - b_ip[:-1]
    sum_products = float(np.dot(cnt_a[: b_len.shape[0]].astype(np.int64),
                                b_len))
    return HostGateLite(a_dmin=a_dmin, a_dmax=a_dmax, b_dmin=b_dmin,
                        b_dmax=b_dmax, sum_products=sum_products)


def host_analyze(ah, bh) -> HostAnalysis:
    """Analysis + gate scalars on host numpy (see HostAnalysis). ``ah``/
    ``bh`` are HostCSR; mirrors _analyze_impl + stream._gate_scalars."""
    INT_MAX = np.iinfo(np.int32).max
    m = int(ah.rows)
    ip = np.asarray(ah.row_offsets, np.int64)
    # np.intp indices: uint32 fancy indexing pays a cast pass per gather
    ci = np.asarray(ah.col_ids, np.intp)
    b_ip = np.asarray(bh.row_offsets, np.int64)
    b_len = b_ip[1:] - b_ip[:-1]
    a_len = ip[1:] - ip[:-1]
    nnz = ci.shape[0]
    blen_a = b_len[ci]
    # segment sums via reduceat (~10x cheaper than a cumsum+diff over
    # nnz): reduceat yields garbage (g[ip[i]]) for EMPTY rows and needs
    # in-range indices, so clip and mask by a_len afterwards
    if nnz:
        # sentinel 0 keeps every start index in range (rows starting at
        # nnz are empty; reduceat returns g2[start] for them — masked)
        g2 = np.concatenate([blen_a, np.zeros(1, np.int64)])
        row_ops = np.add.reduceat(g2, ip[:-1])
        row_ops[a_len == 0] = 0
        sum_products = float(blen_a.sum(dtype=np.int64))
    else:
        row_ops = np.zeros(m, np.int64)
        sum_products = 0.0

    a_dmin, a_dmax = _host_band(ip, ci, m)
    if bh is ah:
        b_dmin, b_dmax = a_dmin, a_dmax
    else:
        b_dmin, b_dmax = _host_band(b_ip, np.asarray(bh.col_ids, np.intp),
                                    bh.rows)
    return HostAnalysis(
        row_ops=row_ops, a_len=a_len,
        sum_products=sum_products,
        max_row_products=int(row_ops.max(initial=0)),
        a_dmin=a_dmin, a_dmax=a_dmax, b_dmin=b_dmin, b_dmax=b_dmax,
    )


@partial(jax.jit, static_argnames=("m",))
def _analyze_impl(a_indptr, a_indices, b_indptr, m: int) -> AnalysisResult:
    a_len = a_indptr[1:] - a_indptr[:-1]
    # B row length per A nonzero (gather; analogue of common.cuh:380-392)
    blen = b_indptr[a_indices + 1] - b_indptr[a_indices]
    # Row totals via cumsum difference at row boundaries (no atomics needed).
    # int32 wraparound in cse is benign for the per-row differences.
    cse = jnp.concatenate([jnp.zeros((1,), jnp.int32), cumsum1d(blen)])
    row_ops = cse[a_indptr[1:]] - cse[a_indptr[:-1]]
    # f32 twin: immune to int32 wrap for giant rows (used for overflow
    # detection and row-block splitting; f32 cumsum rounding is ~1e-7
    # relative, harmless for thresholds)
    csef = jnp.concatenate(
        [jnp.zeros((1,), jnp.float32),
         cumsum1d(blen.astype(jnp.float32))])
    row_ops_f = csef[a_indptr[1:]] - csef[a_indptr[:-1]]
    sum_products = jnp.sum(row_ops_f, dtype=jnp.result_type(float))
    work = jnp.maximum(row_ops, a_len)
    max_work = jnp.max(work) if m > 0 else jnp.int32(0)
    return AnalysisResult(
        row_ops=row_ops,
        a_len=a_len,
        work=work,
        sum_products=sum_products,
        max_work=max_work,
        row_ops_f=row_ops_f,
    )


def analyze(A: DeviceCSR, B: DeviceCSR) -> AnalysisResult:
    """Run the analysis pass; one fused jitted dispatch."""
    return _analyze_impl(A.indptr, A.indices, B.indptr, A.shape[0])


def cumsum1d(x: jax.Array, block: int = 4096) -> jax.Array:
    """Inclusive cumsum of a 1-D array via a 2-level blocked scan.

    Reshaping to (n/block, block) turns a long 1-D scan into a batched
    row scan plus a tiny carry pass (chosen before the H100 port; not yet
    measured on the H100).
    """
    n = x.shape[0]
    if n <= block:
        return jnp.cumsum(x)
    nb = -(-n // block)
    xp = jnp.concatenate([x, jnp.zeros((nb * block - n,), x.dtype)])
    rows = xp.reshape(nb, block)
    inner = jnp.cumsum(rows, axis=1)
    carry = jnp.concatenate(
        [jnp.zeros((1,), x.dtype), jnp.cumsum(inner[:, -1])[:-1]]
    )
    return (inner + carry[:, None]).reshape(-1)[:n]
