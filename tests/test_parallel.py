"""Multi-device SpGEMM on the 8-virtual-device CPU mesh (SURVEY.md §4:
partition logic testable without a pod)."""

import jax
import numpy as np
import pytest

from conftest import random_host_csr
from speck_tpu.parallel import (
    distributed_spgemm,
    make_row_mesh,
    mesh_spgemm_fixed_cap,
    partition_rows,
)
from speck_tpu.parallel.dist import padded_to_host_csr, stack_row_shards
from speck_tpu.utils.compare import compare_csr
from speck_tpu.utils.config import SpgemmConfig
from speck_tpu.utils.oracle import oracle_spgemm


def test_virtual_mesh_has_8_devices():
    """Guard against silent single-device degradation: every mesh test
    below trivially passes on a 1-device mesh (self-need only, no
    exchange), so the suite must PROVE the 8-virtual-device CPU mesh is
    actually present (conftest XLA_FLAGS)."""
    assert len(jax.devices()) == 8, jax.devices()


def test_partition_rows():
    assert partition_rows(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert partition_rows(3, 8)[-1] == (3, 3)


def test_mesh_stream_presharded_inputs(rng):
    """RowShards inputs (the pre-sharded entry): identical results to
    the whole-matrix entry, including with a k-split row in play."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (RowShards, make_row_mesh,
                                    mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    lil = sp.random(60, 60, 0.08, format="csr",
                    random_state=np.random.RandomState(5)).tolil()
    lil[7, :] = np.asarray(rng.standard_normal(60))  # k-split trigger
    a = HostCSR.from_scipy(lil.tocsr())
    mesh = make_row_mesh(8)
    cfg = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                       mesh_split_min_ops=100)
    ref = oracle_spgemm(a, a)
    for inp in (a, RowShards.from_global(a, 8)):
        out = mesh_stream_spgemm(inp, inp if isinstance(inp, type(a))
                                 else RowShards.from_global(a, 8),
                                 mesh, cfg, exchange="needset")
        got = mesh_stream_to_host_csr(*out)
        assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok


def test_needset_device_plan_matches_host_plan(rng):
    """The device need-set planner (round-4: two jitted passes + one D^2
    block-count readback) must produce byte-identical exchange plans to
    the host numpy planner, on a matrix where every shard pair has
    off-diagonal need."""
    from speck_tpu.parallel import mesh_stream_spgemm, mesh_stream_to_host_csr

    a = random_host_csr(rng, 300, 300, 0.02)
    mesh = make_row_mesh(8)
    ref = oracle_spgemm(a, a)
    stats = {}
    for devplan in (True, False):
        cfg = SpgemmConfig(mesh_device_planning=devplan)
        out = mesh_stream_spgemm(a, a, mesh, cfg, exchange="needset")
        got = mesh_stream_to_host_csr(*out)
        assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok
        stats[devplan] = out[3]["stats"]
    assert np.array_equal(stats[True].pairs_nnz, stats[False].pairs_nnz)
    assert stats[True].needset_bytes == stats[False].needset_bytes
    # a random 300x300 over 8 shards needs remote rows from every pair
    offdiag = (stats[True].pairs_nnz.sum()
               - np.trace(stats[True].pairs_nnz))
    assert offdiag > 0 and stats[True].needset_bytes > 0


def test_needset_exact_round_padding(rng):
    """Round-5: each need-set exchange round pads to its EXACT largest
    (dst, src) pair by default (MeshRoundPadExact); pow2 padding remains
    as a knob. Exact must (a) stay oracle-exact, (b) never move more
    bytes than pow2, and (c) strictly win on a scattered need pattern
    whose pair maxima are not powers of two — the round-4 critique case
    where pow2 overshoot made needset lose to all_gather."""
    from speck_tpu.parallel import mesh_stream_spgemm, mesh_stream_to_host_csr

    a = random_host_csr(rng, 300, 300, 0.02)
    mesh = make_row_mesh(8)
    ref = oracle_spgemm(a, a)
    stats = {}
    for exact in (True, False):
        cfg = SpgemmConfig(mesh_round_pad_exact=exact,
                           mesh_exchange_auto=False)
        out = mesh_stream_spgemm(a, a, mesh, cfg, exchange="needset")
        got = mesh_stream_to_host_csr(*out)
        assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok
        stats[exact] = out[3]["stats"]
    assert np.array_equal(stats[True].pairs_nnz, stats[False].pairs_nnz)
    assert stats[True].needset_bytes <= stats[False].needset_bytes
    # the per-pair nnz of a random matrix are essentially never all
    # pow2-aligned, so exact must strictly reduce the moved bytes
    assert stats[True].needset_bytes < stats[False].needset_bytes


def test_stack_row_shards_identity_layout(rng):
    a = random_host_csr(rng, 13, 9, 0.3)
    indptr, indices, data, ranges = stack_row_shards(a, 4)
    m_loc = indptr.shape[1] - 1
    assert m_loc == 4  # ceil(13/4)
    # global row k at shard k//m_loc, slot k%m_loc
    for k in [0, 3, 4, 12]:
        d, s = divmod(k, m_loc)
        ln = indptr[d, s + 1] - indptr[d, s]
        assert ln == a.row_offsets[k + 1] - a.row_offsets[k]
    # pad rows empty
    assert indptr[3, 2] == indptr[3, 1]


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_spgemm_matches_oracle(rng, n_dev):
    a = random_host_csr(rng, 70, 70, 0.1)
    ref = oracle_spgemm(a, a)
    sharded = distributed_spgemm(
        a, a, devices=jax.devices()[:n_dev],
        cfg=SpgemmConfig(product_budget=1 << 14),
    )
    got = sharded.to_host()
    assert compare_csr(ref, got).ok
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok


def test_mesh_spgemm_fixed_cap_matches_oracle(rng):
    mesh = make_row_mesh(8)
    a = random_host_csr(rng, 50, 50, 0.12)
    b = random_host_csr(rng, 50, 40, 0.15)
    counts, cols, vals = mesh_spgemm_fixed_cap(a, b, mesh)
    got = padded_to_host_csr(counts, cols, vals, a.rows, b.cols)
    ref = oracle_spgemm(a, b)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_spgemm_uneven_rows(rng):
    mesh = make_row_mesh(8)
    a = random_host_csr(rng, 37, 41, 0.2)   # 37 rows over 8 devices
    b = random_host_csr(rng, 41, 23, 0.2)
    counts, cols, vals = mesh_spgemm_fixed_cap(a, b, mesh)
    got = padded_to_host_csr(counts, cols, vals, a.rows, b.cols)
    ref = oracle_spgemm(a, b)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_spgemm_empty_matrix():
    from speck_tpu.formats.csr import HostCSR

    mesh = make_row_mesh(4)
    a = HostCSR(6, 6, np.zeros(7, np.uint32), np.zeros(0, np.uint32), np.zeros(0))
    counts, cols, vals = mesh_spgemm_fixed_cap(a, a, mesh)
    got = padded_to_host_csr(counts, cols, vals, 6, 6)
    assert got.nnz == 0


def test_multihost_helpers_single_process():
    from speck_tpu.parallel import global_row_mesh, local_row_range

    mesh = global_row_mesh()
    assert mesh.devices.size >= 1
    r0, r1 = local_row_range(100)
    assert (r0, r1) == (0, 100)  # single-process CI owns everything


# ---------------------------------------------------------------------------
# Mesh stream path (ops/stream.py inside shard_map)
# ---------------------------------------------------------------------------

def _powerlaw_host(rng, m=512, avg=6):
    """Skewed row lengths: the shape class the fixed-cap path exploded on
    (one wide row inflated every row's rectangle)."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    lens = np.minimum(((rng.pareto(1.8, m) + 1) * avg * 0.5).astype(int),
                      m // 2)
    lens[0] = m // 2  # one hot row
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


@pytest.mark.parametrize("exchange", ["allgather", "needset", "needset_overlap"])
def test_mesh_stream_powerlaw(rng, exchange):
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    a = _powerlaw_host(rng)
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, exchange=exchange)
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message
    if exchange == "needset":
        st = meta["stats"]
        assert st is not None and st.reduction > 0
        # every pair's true need is below the full-B volume
        assert st.pairs_nnz.sum() <= a.nnz * 8


def test_mesh_stream_needset_reduction_on_block_structure(rng):
    """Block-diagonal A: each shard only needs its own B block, so the
    need-set exchange moves ~1/D of what all_gather replicates."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    D, blk = 8, 48
    m = D * blk
    blocks = []
    for d in range(D):
        bmat = sp.random(blk, blk, 0.2, format="csr",
                         random_state=np.random.RandomState(d + 1))
        bmat.data = rng.standard_normal(bmat.nnz) + 1.0
        blocks.append(bmat)
    a = HostCSR.from_scipy(sp.block_diag(blocks, format="csr"))
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, exchange="needset")
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok
    st = meta["stats"]
    # off-diagonal pairs exchange nothing
    offdiag = st.pairs_nnz.sum() - np.trace(st.pairs_nnz)
    assert offdiag == 0
    assert st.reduction > 2  # far less than full replication


def test_mesh_stream_rectangular(rng):
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    a = random_host_csr(rng, 70, 50, 0.15)
    b = random_host_csr(rng, 50, 90, 0.15)
    mesh = make_row_mesh(4)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, b, mesh, exchange="needset")
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, b)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok


def test_multihost_spgemm_single_process(rng):
    """multihost_spgemm degenerates to the global-mesh stream step under
    one process; validates vs the oracle on the 8-device virtual mesh."""
    from speck_tpu.parallel.multihost import (multihost_spgemm,
                                              scaling_efficiency)
    from speck_tpu.parallel import mesh_stream_to_host_csr

    a = random_host_csr(rng, 96, 96, 0.1)
    nnz_row, cols, vals, meta = multihost_spgemm(a, a)
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok
    assert scaling_efficiency(8.0, 1.25, 8) == 0.8


@pytest.mark.parametrize("exchange", ["allgather", "needset", "needset_overlap"])
def test_mesh_stream_wide_row_ladder(rng, exchange):
    """Skewed input: one row with ~40x more products than the chunk
    width. W stays at the configured width (no shard-wide inflation);
    the in-SPMD merge ladder finishes the wide row. Oracle-exact."""
    import dataclasses
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    m = 200
    rs = np.random.RandomState(31)
    base = sp.random(m, m, 0.05, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    lil[3, :] = rs.standard_normal(m)       # ~200 * avg-B-row products
    a = HostCSR.from_scipy(lil.tocsr())
    cfg = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                       mesh_split_min_ops=1 << 30)
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, cfg=cfg, exchange=exchange)
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


@pytest.mark.parametrize("exchange", ["allgather", "needset", "needset_overlap"])
def test_mesh_stream_ksplit_small(rng, exchange):
    """k-split smoke test: a row over the (lowered) split threshold is
    removed from its owner, computed as per-B-shard partials, merged by
    all_gather + one sort, and lands oracle-exact — in both exchange
    modes."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    m = 240
    rs = np.random.RandomState(33)
    base = sp.random(m, m, 0.08, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    lil[17, :] = rs.standard_normal(m)      # the row to split
    lil[100, ::2] = rs.standard_normal(m // 2)
    a = HostCSR.from_scipy(lil.tocsr())
    cfg = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                       mesh_split_min_ops=900)
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, cfg=cfg, exchange=exchange)
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def _skewed_host(rng, m=1024, heavy=64, heavy_len=96, avg=6):
    """Front-loaded skew: the first ``heavy`` rows are dense-ish, the
    rest sparse — equal-count sharding concentrates the products on
    shard 0."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    lens = np.full(m, avg, np.int64)
    lens[:heavy] = heavy_len
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, m, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


def test_mesh_balanced_row_partition(rng):
    """Ops-balanced A ranges (round-5, VERDICT item 3): on a skewed
    matrix the per-shard tight stream totals equalize to max/min <= 1.5
    where equal row counts leave >3x, and the result stays
    oracle-exact."""
    from speck_tpu.ops.stream import tight_total_host
    from speck_tpu.parallel import (balanced_row_ranges, make_row_mesh,
                                    mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)
    from speck_tpu.parallel.mesh_stream import _host_row_ops

    a = _skewed_host(rng)
    D, W, min_q = 8, 8192, 8
    b_len = np.diff(np.asarray(a.row_offsets, np.int64))
    ops = _host_row_ops(a, b_len)
    m_loc = -(-a.rows // D)
    eq_tot = [tight_total_host(ops[d * m_loc: (d + 1) * m_loc], W, min_q)
              for d in range(D)]
    bal = balanced_row_ranges(ops, D, min_q)
    bal_tot = [tight_total_host(ops[r0:r1], W, min_q) for r0, r1 in bal]
    assert max(eq_tot) / max(min(eq_tot), 1) > 3.0, eq_tot
    assert max(bal_tot) / max(min(bal_tot), 1) <= 1.5, bal_tot

    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, exchange="needset")
    # the executed plan used the balanced ranges (not equal counts)
    assert [tuple(r) for r in meta["ranges"]] == bal
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok


@pytest.mark.parametrize("exchange", ["allgather", "needset",
                                      "needset_overlap"])
def test_mesh_stream_fp64(rng, exchange):
    """Mesh fp64 (round-5, VERDICT item 7): double-precision payloads
    (12-byte records) through all three exchange modes, values checked
    at fp64 tolerance. Match: the reference's primary Executor<double>
    (source/runspECK.cpp:21)."""
    import jax as _jax
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)
    import jax.numpy as jnp
    import scipy.sparse as sp

    _jax.config.update("jax_enable_x64", True)
    try:
        m = 160
        rs = np.random.RandomState(44)
        base = sp.random(m, m, 0.06, format="csr", random_state=rs)
        base.data = rs.standard_normal(base.nnz)
        lil = base.tolil()
        lil[9, :] = rs.standard_normal(m)    # k-split trigger row
        a = HostCSR.from_scipy(lil.tocsr())
        cfg = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                           mesh_split_min_ops=300)
        mesh = make_row_mesh(8)
        out = mesh_stream_spgemm(a, a, mesh, cfg=cfg, exchange=exchange,
                                 dtype=jnp.float64)
        got = mesh_stream_to_host_csr(*out)
        assert out[3]["ksplit"] is not None  # the split row engaged
        ref = oracle_spgemm(a, a)
        r = compare_csr(ref, got, compare_data=True, rel_tol=1e-12)
        assert r.ok, r.message
        assert got.data.dtype == np.float64
    finally:
        _jax.config.update("jax_enable_x64", False)


def test_mesh_ksplit_caps_at_64_rows(rng):
    """Degrade, not refuse (round-5, VERDICT item 9): with >64 rows over
    the split threshold only the heaviest 64 take the k-split path; the
    rest ride the in-SPMD ladder. Completes oracle-exact (the round-4
    code raised here)."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    m = 240
    rs = np.random.RandomState(51)
    base = sp.random(m, m, 0.05, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    for r in range(0, 160, 2):              # 80 candidate rows
        lil[r, :] = rs.standard_normal(m)
    a = HostCSR.from_scipy(lil.tocsr())
    cfg = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                       mesh_split_min_ops=500)
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, cfg=cfg, exchange="needset")
    ksm = meta["ksplit"]
    assert ksm is not None and ksm["n_split"] == 64
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_ksplit_secondary_subrow_split(rng):
    """Degrade, not refuse (round-5, VERDICT item 9): a k-split sub-row
    past MeshSubrowMaxOps splits again into consecutive slot parts (the
    merge width grows by max_parts); the round-4 code raised 'use more
    shards'. Oracle-exact with a forced tiny ceiling."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    m = 240
    rs = np.random.RandomState(52)
    base = sp.random(m, m, 0.08, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    lil[17, :] = rs.standard_normal(m)      # the row to split
    a = HostCSR.from_scipy(lil.tocsr())
    # ceiling must exceed the largest single B row (240 nnz: one
    # (A-slot, B-row) product block is unsplittable) but sit below the
    # per-shard sub-row totals so parts engage
    cfg = SpgemmConfig(stream_width=64, product_budget=1 << 12,
                       mesh_split_min_ops=900, mesh_subrow_max_ops=300)
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, cfg=cfg, exchange="needset")
    ksm = meta["ksplit"]
    assert ksm is not None and ksm["max_parts"] > 1
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def _banded_host(n=4096, half_band=8, seed=3):
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    mat = sp.diags(
        [rs.standard_normal(n - abs(o)) for o in offs], offs,
        shape=(n, n), format="csr")
    return HostCSR.from_scipy(mat)


def _stencil27_host(g=16, seed=19):
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    n = g ** 3
    offs = sorted(dz * g * g + dy * g + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    mat = sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr")
    return HostCSR.from_scipy(mat)


@pytest.mark.parametrize("make,name", [(_banded_host, "banded"),
                                       (_stencil27_host, "stencil27")])
def test_mesh_dia_route(make, name):
    """Mesh (s)DIA route (round-5, VERDICT item 5): banded and 27-point
    stencil inputs on the 8-device mesh take the diagonal-plane
    convolution with the fixed halo exchange (meta['route'] == 'sdia',
    stats.mode == 'dia_halo') and land oracle-exact. The halo bytes are
    orders of magnitude below replication."""
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    a = make()
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, exchange="needset")
    assert meta["route"] == "sdia", meta["route"]
    st = meta["stats"]
    assert st.mode == "dia_halo"
    # the halo is O(span * planes) vs O(nnz) replication — a few x at
    # these toy grid sizes, orders of magnitude at bench scale
    assert st.needset_bytes < st.allgather_bytes // 4
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, f"{name}: {r.message}"


def test_mesh_dia_route_rejects_unbanded(rng):
    """Unstructured inputs must NOT take the DIA route (band/pair gates
    reject) — they run the stream as before. (Under needset the dense
    gate is never consulted, so the route is exactly the stream; a small
    random matrix under allgather is dense-ELIGIBLE and is covered by
    test_mesh_dense_route_* below.)"""
    from speck_tpu.parallel import make_row_mesh, mesh_stream_spgemm

    a = random_host_csr(rng, 128, 128, 0.05)
    mesh = make_row_mesh(8)
    out = mesh_stream_spgemm(a, a, mesh, exchange="needset")
    assert out[3]["route"] == "stream"


def _blockperm_host(m=512, blk=64, nnz_per_row=8, seed=23):
    """Block-PERMUTED structure: row block d's columns live in block
    p(d) = D-1-d (the reversal), so the diagonals spread across the
    whole matrix (the sdia halo gate rejects: halo would need non-ring
    shards) while every 64-row tile has A-span, output-span and row
    lengths inside the dense windows — the mesh dense route's home
    turf."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    nb = m // blk
    rows = np.repeat(np.arange(m), nnz_per_row)
    # distinct cols per row (argsort trick): nnz is exactly
    # m * nnz_per_row for every seed, so two seeds share one static
    # plan signature (test_mesh_compiled_step_reuse relies on this)
    pick = np.argsort(rs.random((m, blk)), axis=1)[:, :nnz_per_row]
    pd0 = (nb - 1 - (np.arange(m) // blk)) * blk   # target block base
    cols = (pd0[:, None] + pick).reshape(-1)
    vals = rs.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


@pytest.mark.parametrize("tile_rows", [256, 32])
def test_mesh_dense_route(rng, tile_rows):
    """Mesh dense route (round-5): block-permuted tile-bounded
    inputs under allgather run densify + batched matmuls per shard
    (meta['route'] == 'dense', stats.mode == 'dense_allgather'),
    oracle-exact — at one tile per shard and at K=2 tiles. The same
    input under needset keeps the stream (the dense route replicates B,
    so it never overrides a cheaper exchange plan), and
    EnableDense=false restores the stream under allgather too."""
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    a = _blockperm_host()
    mesh = make_row_mesh(8)
    ref = oracle_spgemm(a, a)
    cfg = SpgemmConfig(dense_tile_rows=tile_rows)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, cfg=cfg, exchange="allgather")
    assert meta["route"] == "dense", meta["route"]
    assert meta["stats"].mode == "dense_allgather"
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message
    if tile_rows != 256:
        return
    # needset: gate not consulted (replication would undo the plan)
    out = mesh_stream_spgemm(a, a, mesh, exchange="needset")
    assert out[3]["route"] == "stream"
    # disabled: stream under allgather as before
    out = mesh_stream_spgemm(
        a, a, mesh, cfg=SpgemmConfig(enable_dense=False),
        exchange="allgather")
    assert out[3]["route"] == "stream"
    got = mesh_stream_to_host_csr(*out)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok


def test_mesh_dense_route_fp64(rng):
    """Mesh dense route at fp64 (x64 payloads end-to-end, values at
    fp64 tolerance)."""
    import jax.numpy as jnp
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    jax.config.update("jax_enable_x64", True)
    try:
        a = _blockperm_host(m=256, blk=32, nnz_per_row=6, seed=29)
        mesh = make_row_mesh(8)
        out = mesh_stream_spgemm(a, a, mesh, exchange="allgather",
                                 dtype=jnp.float64)
        assert out[3]["route"] == "dense"
        got = mesh_stream_to_host_csr(*out)
        ref = oracle_spgemm(a, a)
        r = compare_csr(ref, got, compare_data=True, rel_tol=1e-12)
        assert r.ok, r.message
        assert got.data.dtype == np.float64
    finally:
        jax.config.update("jax_enable_x64", False)


def test_mesh_dense_route_rectangular(rng):
    """Rectangular A·B on the mesh dense route (the sDIA route is
    square-only; dense tiles aren't): any small random rect pair is
    tile-bounded, so allgather routes it dense. Oracle-exact."""
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    a = random_host_csr(rng, 128, 96, 0.1)
    b = random_host_csr(rng, 96, 160, 0.1)
    mesh = make_row_mesh(8)
    out = mesh_stream_spgemm(a, b, mesh, exchange="allgather")
    assert out[3]["route"] == "dense"
    got = mesh_stream_to_host_csr(*out)
    ref = oracle_spgemm(a, b)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_compiled_step_reuse(rng):
    """Mesh plan reuse (round-5): a multiply whose HOST plan has the
    same static signature as a previous one reuses the SAME jitted step
    object, so jax's jit cache hits — no retrace, no recompile. The
    mesh form of the single-chip plan_spgemm/execute split (AMG/GNN
    repeated numerics). Cache-safety property under test: every step is
    arg-complete (all structure rides the argument list), so even a
    DIFFERENT matrix with an identical signature must land oracle-exact
    on the reused step."""
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)
    from speck_tpu.parallel import mesh_stream as ms

    mesh = make_row_mesh(8)

    # stream route (needset): same structure, new values
    a = random_host_csr(rng, 200, 200, 0.05)
    out1 = mesh_stream_spgemm(a, a, mesh, exchange="needset")
    assert out1[3]["route"] == "stream"
    fn1 = ms.last_exec()[0]
    a2 = HostCSR(rows=a.rows, cols=a.cols, row_offsets=a.row_offsets,
                 col_ids=a.col_ids,
                 data=np.asarray(rng.standard_normal(a.nnz),
                                 np.float32))
    out2 = mesh_stream_spgemm(a2, a2, mesh, exchange="needset")
    assert out2[3]["compiled_reused"] is True
    assert ms.last_exec()[0] is fn1
    got = mesh_stream_to_host_csr(*out2)
    ref = oracle_spgemm(a2, a2)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok

    # dense route: two DIFFERENT block-permuted matrices share one
    # static signature (same shapes/windows); the second rides the
    # first's compiled step and must still be oracle-exact
    b1 = _blockperm_host(seed=101)
    b2 = _blockperm_host(seed=202)
    o1 = mesh_stream_spgemm(b1, b1, mesh, exchange="allgather")
    assert o1[3]["route"] == "dense"
    fnd = ms.last_exec()[0]
    o2 = mesh_stream_spgemm(b2, b2, mesh, exchange="allgather")
    assert o2[3]["route"] == "dense"
    assert o2[3]["compiled_reused"] is True
    assert ms.last_exec()[0] is fnd
    got2 = mesh_stream_to_host_csr(*o2)
    assert compare_csr(oracle_spgemm(b2, b2), got2,
                       compare_data=True, rel_tol=2e-3).ok


def test_mesh_dense_route_balanced_ragged_shards(rng):
    """Dense route with ops-balanced (ragged) A shards: a work-skewed
    but tile-bounded input triggers balanced_row_ranges, so shard row
    counts differ and shards pad to the max; tiles may straddle two
    source blocks (kspan = union, still inside the window).
    Oracle-exact with the executed ranges actually unbalanced."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    m, blk = 512, 64
    nb = m // blk
    rs = np.random.RandomState(77)
    lens = np.where(np.arange(m) < m // 4, 32, 4)   # 8x ops skew
    rows = np.repeat(np.arange(m), lens)
    pd = (nb - 1 - (rows // blk)) * blk
    cols = pd + rs.randint(0, blk, rows.shape[0])
    mat = sp.csr_matrix(
        (rs.standard_normal(rows.shape[0]), (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    a = HostCSR.from_scipy(mat)
    mesh = make_row_mesh(8)
    out = mesh_stream_spgemm(a, a, mesh, exchange="allgather")
    assert out[3]["route"] == "dense"
    sizes = {r1 - r0 for r0, r1 in out[3]["ranges"]}
    assert len(sizes) > 1, out[3]["ranges"]   # balanced ranges engaged
    got = mesh_stream_to_host_csr(*out)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_dense_route_rejects_wide_rows(rng):
    """A single row past dense_la sends the whole multiply to the
    stream (full cover only — the mesh has no per-tile mixed routing)."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import make_row_mesh, mesh_stream_spgemm

    a = _blockperm_host()
    lil = sp.csr_matrix(
        (a.data, a.col_ids, a.row_offsets), shape=a.shape).tolil()
    rs = np.random.RandomState(7)
    lil[5, :200] = rs.standard_normal(200)   # row length 200 > dense_la
    a2 = HostCSR.from_scipy(lil.tocsr())
    mesh = make_row_mesh(8)
    out = mesh_stream_spgemm(a2, a2, mesh, exchange="allgather")
    assert out[3]["route"] == "stream"


@pytest.mark.parametrize("exchange", ["allgather", "needset"])
def test_mesh_two_phase_staging_budget(rng, exchange):
    """FusedStagingBudget=0 forces the mesh two-phase path: contained
    chunks run count-only and re-expand straight into C in the emission
    pass (the bounded-retained-memory guarantee, round-5 VERDICT item
    1b). Includes a wide row so staged-for-ladder chunks and re-expanded
    chunks coexist. Oracle-exact."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    m = 200
    rs = np.random.RandomState(61)
    base = sp.random(m, m, 0.06, format="csr", random_state=rs)
    base.data = rs.standard_normal(base.nnz)
    lil = base.tolil()
    lil[7, :] = rs.standard_normal(m)       # wide row (> W)
    a = HostCSR.from_scipy(lil.tocsr())
    cfg = SpgemmConfig(stream_width=64, product_budget=1 << 10,
                       mesh_split_min_ops=1 << 30,
                       fused_staging_budget=0)
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, a, mesh, cfg=cfg, exchange=exchange)
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)
    ref = oracle_spgemm(a, a)
    r = compare_csr(ref, got, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_mesh_needset_autofallback_to_allgather(rng):
    """Auto-fallback gate (round-5 hygiene): when the padded need-set
    plan would move more bytes than all_gather replication, the step
    runs all_gather and says so in stats.mode; with the gate off the
    needset plan runs as asked. The overshoot case is constructed with
    pow2 round padding (MeshRoundPadExact=false) — with the exact
    default, the same dense-ish input no longer overshoots at all,
    which the last block pins."""
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    # dense-ish random: every shard needs nearly all of B, so per-round
    # pow2 padding overshoots replication
    a = random_host_csr(rng, 96, 96, 0.5)
    mesh = make_row_mesh(8)
    ref = oracle_spgemm(a, a)
    cfg_pow2 = SpgemmConfig(mesh_round_pad_exact=False)
    out = mesh_stream_spgemm(a, a, mesh, cfg=cfg_pow2, exchange="needset")
    st = out[3]["stats"]
    assert st.needset_bytes > st.allgather_bytes  # the overshoot case
    assert st.mode == "allgather(auto)"
    got = mesh_stream_to_host_csr(*out)
    assert compare_csr(ref, got, compare_data=True, rel_tol=2e-3).ok

    cfg = SpgemmConfig(mesh_exchange_auto=False,
                       mesh_round_pad_exact=False)
    out2 = mesh_stream_spgemm(a, a, mesh, cfg=cfg, exchange="needset")
    assert out2[3]["stats"].mode == "needset"
    got2 = mesh_stream_to_host_csr(*out2)
    assert compare_csr(ref, got2, compare_data=True, rel_tol=2e-3).ok

    # exact round padding (the default): the same input moves FEWER
    # bytes than replication, so the gate never fires and needset runs
    out3 = mesh_stream_spgemm(a, a, mesh, exchange="needset")
    st3 = out3[3]["stats"]
    assert st3.mode == "needset"
    assert st3.needset_bytes < st3.allgather_bytes
    got3 = mesh_stream_to_host_csr(*out3)
    assert compare_csr(ref, got3, compare_data=True, rel_tol=2e-3).ok


def test_mesh_stream_ksplit_giant_row_2e27():
    """THE single-row sharding capability test: a row with 2^27
    intermediate products — past what fits comfortably on one shard's
    ladder — runs oracle-exact on the 8-device CPU mesh via k-split
    (per-B-shard partials, zero-comm inputs, one all_gather merge).
    Asserts the k-split plan actually ENGAGED (2^27 > the 2^25 default
    MeshSplitMinOps; the round-4 form of this test sat below its own
    threshold and exercised the ladder instead, OOM-killing a 125 GB
    host) and that peak RSS stays bounded. Match:
    /root/reference/include/GPU/spECK_HashSpGEMM.cuh:106-126 (the
    reference's any-size-row guarantee via global-map flush/restart)."""
    import resource
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.parallel import (make_row_mesh, mesh_stream_spgemm,
                                    mesh_stream_to_host_csr)

    H, L = 16384, 8192         # 16384 heavy B rows x 8192 nnz = 2^27
    m = H + 16
    rs = np.random.RandomState(35)
    # A: row 0 references all heavy rows; one small sanity row
    a_ip = np.zeros(m + 1, np.int64)
    a_ip[1:] = H
    a_ip[6:] += 1              # row 5 has one extra nonzero
    a_cols = np.concatenate([np.arange(1, H + 1), [3]])
    a_vals = rs.standard_normal(a_cols.size)
    a = HostCSR(rows=m, cols=m, row_offsets=a_ip, col_ids=a_cols,
                data=a_vals)
    # B: rows 1..H full rows of width L (high duplication -> nnz(C row 0)
    # = L, the global-map dedup regime)
    b_ip = np.zeros(m + 1, np.int64)
    b_ip[2: H + 2] = np.arange(1, H + 1, dtype=np.int64) * L
    b_ip[H + 2:] = H * L
    b_cols = np.tile(np.arange(L, dtype=np.int64), H)
    b_vals = rs.standard_normal(b_cols.size).astype(np.float32)
    b = HostCSR(rows=m, cols=L, row_offsets=b_ip, col_ids=b_cols,
                data=b_vals)

    cfg = SpgemmConfig(stream_width=65536)
    assert H * L > cfg.mesh_split_min_ops, \
        "test row must exceed the split threshold or k-split never runs"
    mesh = make_row_mesh(8)
    nnz_row, cols, vals, meta = mesh_stream_spgemm(
        a, b, mesh, cfg=cfg, exchange="needset")
    # the capability claim hinges on the plan having engaged
    assert meta["ksplit"] is not None, "k-split plan did not engage"
    assert meta["ksplit"]["n_split"] >= 1
    assert 0 in meta["ksplit"]["split_ids"]
    got = mesh_stream_to_host_csr(nnz_row, cols, vals, meta)

    # oracle on the two nontrivial rows (full scipy product of a 134M-nnz
    # B is slow; row structure is exact by construction)
    As = sp.csr_matrix((a.data, a.col_ids, a.row_offsets), shape=(m, m))
    Bs = sp.csr_matrix((b.data, b.col_ids, b.row_offsets), shape=(m, L))
    ref_r0 = (As[[0]] @ Bs).toarray()[0]
    ref_r5 = (As[[5]] @ Bs).toarray()[0]
    gs = sp.csr_matrix((got.data, got.col_ids, got.row_offsets),
                       shape=(m, L))
    np.testing.assert_allclose(gs[[0]].toarray()[0], ref_r0,
                               rtol=2e-3, atol=1e-4 * np.abs(ref_r0).max())
    np.testing.assert_allclose(gs[[5]].toarray()[0], ref_r5, rtol=2e-3,
                               atol=1e-6)
    counts = np.diff(got.row_offsets)
    assert counts[0] == L and counts.sum() == counts[0] + counts[5]
    # bounded memory: the whole 8-shard run (one process on CPU) must
    # stay far under the 130 GB the round-4 ladder path consumed
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"\n[giant-2e27] peak RSS {peak_gb:.1f} GB")
    assert peak_gb < 60, f"peak RSS {peak_gb:.1f} GB — memory regressed"
