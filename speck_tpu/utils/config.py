"""Runtime configuration.

Two pieces, mirroring the reference's two-level config (SURVEY.md §5.6):

1. ``Config`` — an INI-backed key/value store with the reference's 6 *live*
   keys (Config singleton, /root/reference/include/Config.h:173-177 and
   source/RunConfig.cpp:22, source/Executor.cpp:15-29):
   InputFile, IterationsWarmUp, IterationsExecution, TrackIndividualTimes,
   TrackCompleteTimes, CompareResult. The reference's INI files have no
   [section] headers (config.ini), so a default section is injected.

2. ``SpgemmConfig`` — the device pipeline's tuning knobs (the analogue of the
   compile-time shared-memory/threads constants in include/Multiply.h:10-11
   and the hard-coded heuristics in Multiply.cu).
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Optional


class ProductOverflow(ValueError):
    """Total intermediate products (or the quantized stream they pack
    into) exceed one plan's int32 budget. ``spgemm`` catches this and
    re-runs as row blocks; direct ``plan_spgemm`` callers must block
    rows themselves or shard (parallel/mesh_stream.py)."""


class Config:
    """INI config with defaults; section-less files accepted."""

    _instance: Optional["Config"] = None

    def __init__(self, path: Optional[str] = None):
        self._cp = configparser.ConfigParser()
        self._cp.optionxform = str  # keys are case-sensitive like INIReader's lookups
        if path:
            with open(path) as fh:
                text = fh.read()
            if not text.lstrip().startswith("["):
                text = "[default]\n" + text
            # the reference INI uses ';' comments; configparser handles both
            self._cp.read_string(text)

    @classmethod
    def init(cls, path: Optional[str] = None) -> "Config":
        cls._instance = Config(path)
        return cls._instance

    @classmethod
    def get(cls) -> "Config":
        if cls._instance is None:
            cls._instance = Config(None)
        return cls._instance

    def _raw(self, key: str, fallback=None):
        for section in self._cp.sections():
            if self._cp.has_option(section, key):
                return self._cp.get(section, key)
        return fallback

    def get_string(self, key: str, default: str = "") -> str:
        v = self._raw(key)
        return default if v is None else str(v)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._raw(key)
        try:
            return default if v is None else int(str(v).strip())
        except ValueError:
            return default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._raw(key)
        try:
            return default if v is None else float(str(v).strip())
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._raw(key)
        if v is None:
            return default
        return str(v).strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class SpgemmConfig:
    """Tuning knobs for the device SpGEMM pipeline.

    Values were set before the H100 port and are not yet measured on the
    H100 unless PERF.md says otherwise; memory budgets are sized for a
    16 GiB device (ROADMAP reach item 1).

    The flat product stream (ops/stream.py) replaces spECK's 6 kernel
    size classes (Multiply.cu:105-107, kernelCount=6): rows are
    tight-packed (fill ~0.96) into fixed (G, W) chunks.
    ``product_budget`` bounds the stream slots materialized per device
    dispatch (the analogue of spECK's shared-memory budgeting,
    Multiply.cu:110-134).
    """

    product_budget: int = 1 << 22  # max stream slots per dispatch (~4M)
    # mesh k-split (parallel/mesh_stream.py): rows with more products
    # than this are split by B-row-owner shard — each shard computes the
    # partial row over ITS OWN B rows (zero communication for the
    # partials' inputs), partials are all_gathered and merged on the
    # owner. Lifts the 2^30 per-row per-shard ceiling to D * 2^30 and
    # spreads one giant row's work across the mesh. Rows past
    # mesh_subrow_max_ops * D always split regardless of this knob.
    # 2^25 (32M products): past this the in-SPMD wide-row ladder's
    # transient buffers (~8 bytes * ops * ~2 live levels per shard)
    # start to crowd a 16 GiB device, and splitting also rebalances the
    # row's work across the mesh (2^28 let a 2^27-product row ride the
    # ladder and run the 8-shard CPU mesh host out of memory).
    mesh_split_min_ops: int = 1 << 25
    # per-shard ceiling on one k-split sub-row's products; sub-rows past
    # it are SECONDARY-split into multiple part-rows (each merged with
    # the rest of the row's partials on the owner), so oversize rows
    # degrade to more merge width instead of raising. 2^30 = the int32
    # stream-position ceiling; lower it only in tests.
    mesh_subrow_max_ops: int = 1 << 30
    # ops-balanced A row partitioning over the mesh (HostCSR inputs
    # only; pre-sharded RowShards keep their given ranges): contiguous
    # shard boundaries are chosen on the cumulative per-row product
    # counts instead of equal row counts, so a power-law matrix's heavy
    # rows don't concentrate the stream work (and the shared n_chunks)
    # on one shard — the mesh-axis generalization of the reference's
    # load-balanced row binning (spECK_HashLoadBalancer.cuh:205-305).
    mesh_balance_rows: bool = True
    # fall back to all_gather when the padded need-set plan would move
    # MORE bytes over the interconnect than full replication (round
    # padding can overshoot on scattered need patterns)
    mesh_exchange_auto: bool = True
    # pad each need-set exchange round to its EXACT largest (dst, src)
    # pair instead of the pow2 ceiling: the received-buffer
    # total is an operand shape of the compiled step either way, so pow2
    # buys no compile reuse across plans — it only inflates the bytes a
    # scattered need pattern moves (up to 2x per round). pow2 remains
    # available for cross-matrix plan-shape stability experiments.
    mesh_round_pad_exact: bool = True
    # need-set exchange planning on device (parallel/mesh_stream.py):
    # per-dst B-row need bitmaps + all exchange tables computed in two
    # jitted passes with ONE D^2 block-count readback, O(nnz/D + b_rows)
    # per shard — replaces the host numpy planner (np.unique over all A
    # columns + D^2 per-pair loops needing full A/B on every host).
    # Off = the host planner (kept for A/B comparison and debugging).
    mesh_device_planning: bool = True
    # run the analysis pass + routing gate on host numpy when the input
    # matrices still carry their HostCSR copies (device_put_csr attaches
    # them): saves one device dispatch and the early-gate readback per
    # plan — the planning decisions then cost zero device syncs. Off =
    # always the device analysis (required for device-born inputs, e.g.
    # chained spgemm outputs — those fall back automatically).
    host_analysis: bool = True
    # nnz ceiling for the host analysis: past this the O(nnz) numpy
    # gather was found to cost more than the device pass it replaces
    # (on the 50M-nnz giant-row bench; not yet measured on the H100) —
    # large inputs take the device analysis + early-gate readback
    # instead
    host_analysis_max_nnz: int = 8 << 20
    # stream ESC (ops/stream.py): rectangle-row width of the flat product
    # stream; rows with more products own whole rectangle rows and are
    # finished by merge levels growing the width by stream_level_factor
    # per level (capped at stream_max_width slots per sort row)
    stream_width: int = 8192
    # ceiling of the adaptive rectangle-width ladder (giant rows raise W
    # toward this so per-rectangle dedup is stronger)
    stream_width_cap: int = 65536
    # product-count ceiling for one planning pass: stream positions are
    # int32, so a single plan handles < 2^31 quantized slots. Calls whose
    # total products reach this are split into row blocks automatically
    # by spgemm() (each block re-planned under block_products // 2);
    # plan_spgemm alone raises ProductOverflow. The 2x headroom absorbs
    # quantization padding (tight fill ~0.96) and the f32 totals estimate.
    block_products: int = 1 << 30
    stream_min_q: int = 8        # smallest per-row product quantum (pow2)
    stream_level_factor: int = 4
    stream_max_width: int = 1 << 24
    # chunk expand: "fill" forward-fills per-slot A records (u, valA)
    # from boundary scatters at the A-slot starts — no sid decode, no
    # O(G*W) random srec gather (one b_packed record gather per live
    # product remains); "decode" is the older per-slot decode+gather
    # form, kept for A/B (not yet measured on the H100)
    stream_expand_impl: str = "fill"
    # staged-buffer compaction: "sort" (one rank sort moves run-lasts to
    # the rectangle-row front) or "scatter" (three flat scatters to
    # g*W + rank; write targets are dense in-order per-row prefixes).
    # Kept for A/B (not yet measured on the H100)
    stream_compact_impl: str = "sort"
    # dense-span accumulator for huge rows with bounded output-column
    # ranges (the reference's dense mode for single big rows,
    # spGEMMNumericLauncher spECK_HashSpGEMM.cuh:1761-1793): rows with
    # more than accum_min_ops products whose column span fits
    # accum_span_cap scatter-add into a dense window instead of sorting
    # every product. accum_budget bounds live accumulator slots per pass.
    # Default OFF: the scatter-add serializes under contention (5e7-
    # product row, 5000 duplicates per column bin) and lost to the sort
    # stream before the H100 port; not yet measured on the H100 (ROADMAP
    # speed item 4). Kept as a correct, tested option.
    enable_accum: bool = False
    accum_min_ops: int = 1 << 14
    accum_span_cap: int = 1 << 20
    accum_budget: int = 1 << 26
    # fused count+numeric staging: total staged int32 planes (3 per stream
    # slot: row, col, value) that may stay resident between the counting
    # and numeric phases; beyond this the stream runs the classic
    # two-phase path (re-expand for numeric). 2^28 planes = 1 GiB.
    fused_staging_budget: int = 1 << 28
    enable_direct: bool = True    # direct-copy bins for single-A-nnz rows
    # DIA fast path (ops/dia.py): when every nonzero of A and B lies
    # within a bounded diagonal band, the whole multiply runs as flat
    # diagonal-plane multiply-adds (no gathers, no sorts). Gates: both
    # spans <= dia_span_cap, dense-band work m*span_a*span_b within
    # dia_waste_cap of the true product count, plane working set within
    # dia_mem_budget bytes. Requires canonical A and B.
    enable_dia: bool = True
    # sparse DIA (ops/dia.py sdia_conv): diagonal planes indexed by the
    # explicit PRESENT-offset lists instead of a contiguous band — the
    # 3-D stencil class (nlpkkt: 27 diagonals spread over a ~2G^2 band)
    # that the contiguous gate rejects. Host-gated only (the offset
    # lists come from the attached HostCSR via one O(nnz + span)
    # bincount); work = m * nd_a * nd_b vector FMAs, gated by
    # dia_waste_cap against the true product count like contiguous DIA.
    enable_sdia: bool = True
    # max diagonal RANGE (dmax - dmin + 1) the sparse gate will scan
    sdia_span_cap: int = 1 << 22
    # max nd_a * nd_b offset pairs (bounds trace size + FMA work)
    sdia_pair_cap: int = 4096
    # decide the DIA route from a dedicated early readback of the 7 gate
    # scalars BEFORE dispatching the O(m log m) stream/dense planning:
    # a winning gate skips the discarded speculative planning; a losing
    # gate costs one extra small readback (not yet measured on the H100).
    # False restores the fused form (scalars ride the single planning
    # readback; speculative planning always dispatched).
    dia_gate_early: bool = True
    # uniform-rows fast emit: when a contiguous interior run of rows is
    # FULL (count == span_c, true for every interior row of a banded
    # matrix), their staged entries are already the final CSR payload at
    # a constant shift — emitted as ONE contiguous copy instead of a
    # per-element gather (not yet measured on the H100). Edge rows emit
    # via the gather. The run bounds ride the same
    # nnz readback. False forces the all-gather emit.
    dia_uniform_emit: bool = True
    dia_span_cap: int = 512
    dia_waste_cap: float = 8.0
    # plane working-set ceiling (contiguous AND sparse DIA). 4 GiB: a
    # stencil-class input (m ~1e6, nd_c ~125) stages ~3.3 GiB of planes,
    # comfortably resident on a 16 GiB device
    dia_mem_budget: int = 1 << 32
    # per-ROW DIA split (the reference's per-block method auto-select,
    # spECK_HashSpGEMM.cuh:1761-1793, hoisted to per-row routing): when
    # the WHOLE-matrix gate fails because a few rows break the band, a
    # robust band (5% outlier allowance per side on the per-row diagonal
    # extents) routes the banded bulk through diagonal planes and only
    # the outliers through the stream/dense/direct paths. A row rides
    # the planes iff its own extent fits the robust band AND every B row
    # it touches is in-band (so each C row is produced by exactly one
    # path — no cross-path merging). Same span/waste/memory gates as the
    # whole-matrix route, evaluated on device in the planning dispatch.
    dia_rows: bool = True
    # dense-window path (ops/dense.py): tiles of ``dense_tile_rows``
    # consecutive rows whose A-column span fits ``dense_kw``, output-column
    # span fits ``dense_cw``, and per-row lengths fit dense_la/dense_lb run
    # as dense matmuls (cuBLAS via XLA) instead of expand-sort-contract.
    # Requires canonical (sorted, deduplicated) A and B.
    enable_dense: bool = True
    dense_tile_rows: int = 256
    dense_kw: int = 512
    dense_cw: int = 512
    dense_la: int = 64
    dense_lb: int = 64
    # tiles per dense dispatch: bounds working memory at
    # ~tiles * (tile_rows*kw + kw*cw + 4*tile_rows*cw) * 4 bytes (~1 GiB at
    # the defaults); one flat batched kernel per dispatch
    dense_tiles_per_dispatch: int = 256
    # densification of CSR fragments into dense windows: "sort" (two
    # wide merge sorts) or "scatter" (one masked scatter per plane).
    # "sort" won before the H100 port; not yet measured on the H100
    # (ROADMAP speed item 4)
    dense_densify: str = "sort"

    def __post_init__(self):
        # the stream layout assumes power-of-two quanta and widths
        # (q-class ladder, merge-level widths, packed sort keys); these
        # are INI-settable, so normalize instead of corrupting layouts
        for f in ("stream_min_q", "stream_width", "stream_width_cap"):
            v = getattr(self, f)
            if v < 1 or v & (v - 1):
                object.__setattr__(
                    self, f, 1 << max(int(v) - 1, 0).bit_length())


# INI key -> SpgemmConfig field. The reference DECLARES dozens of kernel
# tuning keys but never reads them (heuristics hard-coded,
# Config.h:10-59 vs Multiply.cu); here the pipeline knobs are live.
_INI_TUNING_KEYS = {
    "ProductBudget": ("product_budget", int),
    "HostAnalysis": ("host_analysis", bool),
    "HostAnalysisMaxNnz": ("host_analysis_max_nnz", int),
    "MeshSplitMinOps": ("mesh_split_min_ops", int),
    "MeshSubrowMaxOps": ("mesh_subrow_max_ops", int),
    "MeshBalanceRows": ("mesh_balance_rows", bool),
    "MeshExchangeAuto": ("mesh_exchange_auto", bool),
    "MeshRoundPadExact": ("mesh_round_pad_exact", bool),
    "MeshDevicePlanning": ("mesh_device_planning", bool),
    "StreamWidth": ("stream_width", int),
    "StreamWidthCap": ("stream_width_cap", int),
    "BlockProducts": ("block_products", int),
    "StreamMinQ": ("stream_min_q", int),
    "StreamMaxWidth": ("stream_max_width", int),
    "FusedStagingBudget": ("fused_staging_budget", int),
    "EnableDense": ("enable_dense", bool),
    "EnableDirect": ("enable_direct", bool),
    "EnableDia": ("enable_dia", bool),
    "DiaGateEarly": ("dia_gate_early", bool),
    "DiaUniformEmit": ("dia_uniform_emit", bool),
    "DiaSpanCap": ("dia_span_cap", int),
    "DiaWasteCap": ("dia_waste_cap", float),
    "DiaMemBudget": ("dia_mem_budget", int),
    "DiaRows": ("dia_rows", bool),
    "EnableSdia": ("enable_sdia", bool),
    "SdiaSpanCap": ("sdia_span_cap", int),
    "SdiaPairCap": ("sdia_pair_cap", int),
    "EnableAccum": ("enable_accum", bool),
    "AccumMinOps": ("accum_min_ops", int),
    "AccumSpanCap": ("accum_span_cap", int),
    "DenseTileRows": ("dense_tile_rows", int),
    "DenseDensify": ("dense_densify", str),
    "StreamCompactImpl": ("stream_compact_impl", str),
    "StreamExpandImpl": ("stream_expand_impl", str),
}


def spgemm_config_from_ini(ini: "Config") -> SpgemmConfig:
    """SpgemmConfig with any tuning keys present in the INI applied."""
    overrides = {}
    for key, (field, typ) in _INI_TUNING_KEYS.items():
        if ini.get_string(key, "") == "":
            continue
        if typ is bool:
            overrides[field] = ini.get_bool(key)
        elif typ is int:
            overrides[field] = ini.get_int(key)
        elif typ is float:
            overrides[field] = ini.get_float(key)
        else:
            overrides[field] = ini.get_string(key)
    return SpgemmConfig(**overrides)

