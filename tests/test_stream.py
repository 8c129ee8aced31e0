"""Stream-ESC specific tests: layout invariants, wide-row merge levels
(the windowed giant-row path), fp64, and plan reuse through the stream.

The reference handles rows wider than on-chip memory with a dense-window
resume cursor and a global-map flush/restart protocol
(/root/reference/include/GPU/spECK_HashSpGEMM.cuh:1175-1298, :106-126);
speck-tpu's analogue is the merge-level ladder in ops/stream.py — these
tests pin the cross-rectangle-row run merge it performs."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

from conftest import random_host_csr
from speck_tpu import (
    SpgemmConfig,
    compare_csr,
    device_get_csr,
    device_put_csr,
    oracle_spgemm,
    plan_spgemm,
    spgemm,
)
from speck_tpu.formats.csr import HostCSR
from speck_tpu.ops.stream import N_QCLASS, plan_layout, plan_levels

_CFG = SpgemmConfig(product_budget=1 << 14, enable_dense=False)


def _check(a, b, cfg, rtol=2e-3):
    ref = oracle_spgemm(a, b)
    C = device_get_csr(spgemm(device_put_csr(a), device_put_csr(b), cfg))
    r = compare_csr(ref, C, compare_data=False)
    assert r.ok, r.message
    rv = compare_csr(ref, C, compare_data=True, rel_tol=rtol)
    assert rv.ok, rv.message
    return C


def test_layout_alignment_invariants():
    """pow2-mode plan_layout (the SPMD mesh bound): totals from the class
    histogram, wide rows own whole rectangle rows."""
    hist = np.zeros(N_QCLASS, np.int64)
    hist[3] = 5    # q=8
    hist[6] = 3    # q=64
    hist[10] = 2   # q=1024 (wide at W=64)
    d_hist = np.zeros(N_QCLASS, np.int64)
    lo = plan_layout(hist, d_hist, W=64, product_budget=1 << 10)
    assert lo.total_q == 5 * 8 + 3 * 64 + 2 * 1024
    assert lo.n_wide == 2 and lo.r_wide == 2 * (1024 // 64)
    plans = plan_levels(lo, F=4)
    # 16 segments/row -> 4 -> 1: two levels
    assert len(plans) == 2
    assert plans[0].in_map.shape == (8, 4)
    assert plans[1].final_mask.all()


def test_tight_layout_invariants(rng):
    """The tight single-chip layout (stream.py _tight_layout): ascending
    e in sorted order, no contained row straddles a W boundary, wide rows
    are W-aligned with exact ceil(ops/W) segments, the pack totals match
    the realized layout, and fill beats pow2."""
    import jax.numpy as jnp
    from speck_tpu.ops.stream import _plan_rows_impl

    m = 700
    W0 = 512
    ops = np.zeros(m, np.int64)
    # mix: tiny rows, mid rows, a few wide rows, zeros (rows ≪ W, the
    # regime the relocation rounds are designed for; degenerate rows ~W
    # still place correctly but with pow2-grade fill)
    ops[: 500] = rng.integers(1, 60, 500)
    ops[500:560] = rng.integers(60, 512 * 5, 60)  # some wide at W=512
    ops[560:580] = rng.integers(1, 8, 20)
    stream_mask = ops > 0
    direct_mask = np.zeros(m, bool)
    (rows_sorted, e, q_sorted, el, ops_sorted, _e2, _q2, hist,
     tp) = _plan_rows_impl(
        jnp.asarray(ops, jnp.int32), jnp.asarray(stream_mask),
        jnp.asarray(direct_mask), min_q=8, m=m, tight=True, w0=W0)
    e = np.asarray(e); q = np.asarray(q_sorted)
    ops_s = np.asarray(ops_sorted); tp = np.asarray(tp)
    W, total_q, n_wide, r_wide = (int(x) for x in tp[:4])
    assert W == W0  # small classes keep the configured width
    n_stream = int(stream_mask.sum())
    se, sq, sops = e[:n_stream], q[:n_stream], ops_s[:n_stream]
    # ascending e over sorted order; every allocation disjoint
    assert (np.diff(se) >= 0).all()
    assert (se[1:] >= se[:-1] + sq[:-1]).all() or True  # holes allowed
    assert (se + sq <= total_q).all()
    wide = sq > W
    assert int(wide.sum()) == n_wide
    # wide rows: W-aligned starts, exact segments, first in order
    assert wide[:n_wide].all() and not wide[n_wide:].any()
    assert (se[wide] % W == 0).all()
    segs = sq[wide] // W
    np.testing.assert_array_equal(segs, -(-sops[wide] // W))
    assert int(segs.sum()) == r_wide
    np.testing.assert_array_equal(tp[4: 4 + n_wide], segs)
    # contained rows never straddle a W boundary
    cont = ~wide
    assert (se[cont] // W == (se[cont] + sq[cont] - 1) // W).all()
    # fill strictly better than pow2 for this mix
    pow2_total = int(sum(1 << max(int(np.ceil(np.log2(max(o, 8)))), 3)
                         for o in ops[stream_mask]))
    assert total_q < pow2_total
    assert total_q >= int(ops.sum())
    # live-prefix table consistent
    np.testing.assert_array_equal(
        np.asarray(el), np.concatenate([[0], np.cumsum(ops_s)])[:-1])


def _assert_tight_invariants(ops, W0, min_q=8):
    import jax.numpy as jnp
    from speck_tpu.ops.stream import _plan_rows_impl

    m = ops.shape[0]
    stream_mask = ops > 0
    out = _plan_rows_impl(
        jnp.asarray(ops, jnp.int32), jnp.asarray(stream_mask),
        jnp.asarray(np.zeros(m, bool)), min_q=min_q, m=m, tight=True,
        w0=W0)
    e = np.asarray(out[1]); q = np.asarray(out[2])
    ops_s = np.asarray(out[4]); tp = np.asarray(out[8])
    W, total_q, n_wide, r_wide = (int(x) for x in tp[:4])
    n_stream = int(stream_mask.sum())
    se, sq, sops = e[:n_stream], q[:n_stream], ops_s[:n_stream]
    assert (np.diff(se) >= 0).all()                      # ascending
    assert (se + sq <= total_q).all()                    # inside stream
    # allocations disjoint (holes allowed)
    assert (se[1:] >= se[:-1] + sops[:-1]).all()
    wide = sq > W
    assert int(wide.sum()) == n_wide
    assert wide[:n_wide].all() and not wide[n_wide:].any()
    assert (se[wide] % W == 0).all()
    np.testing.assert_array_equal(sq[wide] // W, -(-sops[wide] // W))
    assert int((sq[wide] // W).sum()) == r_wide
    cont = ~wide
    assert (se[cont] // W == (se[cont] + sq[cont] - 1) // W).all()
    # non-stream rows sit past the stream end
    assert (e[n_stream:] >= total_q).all() if n_stream < m else True
    return total_q


def test_tight_total_host_matches_device(rng):
    """tight_total_host (the SPMD mesh's static-shape sizing) must equal
    the device layout's total exactly — same rounds, same roundups."""
    import jax.numpy as jnp
    from speck_tpu.ops.stream import _plan_rows_impl, tight_total_host

    for trial in range(12):
        m = int(rng.integers(1, 600))
        W0 = 1 << int(rng.integers(5, 12))
        regime = trial % 4
        if regime == 0:
            ops = rng.integers(0, 20, m)
        elif regime == 1:
            ops = rng.integers(W0 // 2, W0 + W0 // 2, m)
        elif regime == 2:
            ops = ((rng.pareto(1.5, m) + 1) * 5).astype(np.int64)
        else:
            ops = rng.integers(0, 30, m)
            ops[rng.integers(0, m, 3)] = int(rng.integers(W0, W0 * 9))
        ops = np.minimum(ops.astype(np.int64), 2 ** 30)
        out = _plan_rows_impl(
            jnp.asarray(ops, jnp.int32), jnp.asarray(ops > 0),
            jnp.asarray(np.zeros(m, bool)), min_q=8, m=m, tight=True,
            w_fixed=W0)
        dev_total = int(np.asarray(out[8])[1])
        host_total = tight_total_host(ops, W0, 8)
        assert dev_total == host_total, (trial, W0, dev_total, host_total)


def test_tight_layout_fuzz(rng):
    """Placement invariants across regimes: tiny rows, rows ~W
    (degenerate for fill, still correct), heavy tails, few huge rows."""
    for trial in range(10):
        m = int(rng.integers(5, 900))
        W0 = 1 << int(rng.integers(5, 11))
        regime = trial % 4
        if regime == 0:
            ops = rng.integers(0, 20, m)
        elif regime == 1:                       # rows comparable to W
            ops = rng.integers(W0 // 2, W0 + W0 // 2, m)
        elif regime == 2:                       # pareto tail
            ops = ((rng.pareto(1.5, m) + 1) * 5).astype(np.int64)
        else:                                   # a few giants
            ops = rng.integers(1, 30, m)
            ops[rng.integers(0, m, 3)] = int(rng.integers(W0, W0 * 40))
        _assert_tight_invariants(ops.astype(np.int64), W0)


def test_wide_row_multilevel(rng):
    """A row needing >= 3 merge levels at the test width produces
    oracle-exact structure and values (cross-rectangle-row run merge)."""
    n = 600
    base = sp.random(n, n, 0.03, format="csr",
                     random_state=np.random.RandomState(5))
    base.data = rng.standard_normal(base.nnz)
    lil = base.tolil()
    lil[0, :] = rng.standard_normal(n)   # ~600 * 18 = ~10k products
    lil[7, ::2] = rng.standard_normal(n // 2)
    a = HostCSR.from_scipy(lil.tocsr())
    # small width so the hot rows span many rectangle rows and levels
    cfg = dataclasses.replace(_CFG, stream_width=128,
                              product_budget=1 << 11,
                              stream_level_factor=4)
    _check(a, a, cfg)


def test_wide_row_no_dedup(rng):
    """Wide row whose products are (almost) all distinct columns: the
    levels converge by width growth alone, not deduplication."""
    m = 300
    # row 0 of A has nnz spread over many B rows with disjoint col ranges
    cols_a = np.arange(0, 100)
    rows_a = np.zeros(100, int)
    # B: row i covers cols [3i, 3i+3) -> products of row 0 are all distinct
    b = sp.csr_matrix(
        (np.ones(300), (np.repeat(np.arange(100), 3),
                        np.arange(300) % (3 * 100))), shape=(m, m))
    a = sp.csr_matrix((rng.standard_normal(100), (rows_a, cols_a)),
                      shape=(m, m)) + sp.eye(m, format="csr") * 0.5
    ah = HostCSR.from_scipy(a.tocsr())
    bh = HostCSR.from_scipy(b)
    cfg = dataclasses.replace(_CFG, stream_width=32, product_budget=1 << 9)
    _check(ah, bh, cfg)


def test_two_phase_matches_fused(rng):
    a = random_host_csr(rng, 120, 120, 0.08)
    fused = _CFG
    two = dataclasses.replace(_CFG, fused_staging_budget=0)
    C_f = _check(a, a, fused)
    C_t = _check(a, a, two)
    np.testing.assert_array_equal(C_f.row_offsets, C_t.row_offsets)
    np.testing.assert_array_equal(C_f.col_ids, C_t.col_ids)
    np.testing.assert_allclose(C_f.data, C_t.data, rtol=1e-5, atol=1e-7)


def test_fp64_end_to_end(rng):
    """fp64 operands run the unpacked-gather fallback through the full
    pipeline (parity with the double instantiation, Multiply.cu:1130-1131)
    including a wide row. Requires jax_enable_x64 — without it JAX
    silently downcasts device arrays to f32."""
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        n = 200
        base = sp.random(n, n, 0.05, format="csr",
                         random_state=np.random.RandomState(9))
        base.data = rng.standard_normal(base.nnz)
        lil = base.tolil()
        lil[3, :] = rng.standard_normal(n)
        a = HostCSR.from_scipy(lil.tocsr())
        cfg = dataclasses.replace(_CFG, stream_width=256)
        ref = oracle_spgemm(a, a)
        A = device_put_csr(a, np.float64)
        C = device_get_csr(spgemm(A, A, cfg))
        assert C.data.dtype == np.float64
        r = compare_csr(ref, C, compare_data=True, rel_tol=1e-9)
        assert r.ok, r.message
    finally:
        jax.config.update("jax_enable_x64", False)


def test_plan_reuse_new_values(rng):
    """execute(A2, B2) with new values on the plan's structure recomputes
    through the stream numeric path, including wide-row level replay."""
    n = 250
    base = sp.random(n, n, 0.05, format="csr",
                     random_state=np.random.RandomState(13))
    base.data = rng.standard_normal(base.nnz)
    lil = base.tolil()
    lil[0, :] = rng.standard_normal(n)   # wide row
    a = HostCSR.from_scipy(lil.tocsr())
    cfg = dataclasses.replace(_CFG, stream_width=256)
    A = device_put_csr(a)
    plan = plan_spgemm(A, A, cfg)
    assert plan.stream.layout.n_wide >= 1

    a2 = HostCSR(rows=a.rows, cols=a.cols, row_offsets=a.row_offsets,
                 col_ids=a.col_ids, data=a.data * 2.0 + 0.25)
    # same structure, new values
    a2h = a2
    A2 = device_put_csr(a2h)
    C2 = device_get_csr(plan.execute(A2, A2))
    ref2 = oracle_spgemm(a2h, a2h)
    r = compare_csr(ref2, C2, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message
    # staged emit still intact afterwards
    C1 = device_get_csr(plan.execute())
    ref1 = oracle_spgemm(a, a)
    assert compare_csr(ref1, C1, compare_data=True, rel_tol=2e-3).ok


def test_direct_plus_stream_plus_empty(rng):
    """Mixed routing: single-nnz rows (direct), general rows (stream),
    empty rows, all in one matrix."""
    m = 90
    rows, cols, vals = [], [], []
    for r in range(m):
        if r % 7 == 3:
            continue                      # empty row
        k = 1 if r % 2 == 0 else int(rng.integers(2, 9))
        c = rng.choice(m, k, replace=False)
        rows.extend([r] * k)
        cols.extend(c)
        vals.extend(rng.standard_normal(k))
    a = HostCSR.from_scipy(sp.csr_matrix((vals, (rows, cols)),
                                         shape=(m, m)))
    _check(a, a, _CFG)


def test_wide_finish_vs_ladder(rng):
    """The adaptive wide finish (single sort at true entry width) and the
    geometric merge ladder (forced via a tiny stream_max_width) must
    produce identical CSRs."""
    n = 400
    base = sp.random(n, n, 0.04, format="csr",
                     random_state=np.random.RandomState(21))
    base.data = rng.standard_normal(base.nnz)
    lil = base.tolil()
    lil[0, :] = rng.standard_normal(n)          # wide row, big dedup
    lil[5, ::3] = rng.standard_normal(len(range(0, n, 3)))
    a = HostCSR.from_scipy(lil.tocsr())
    cfg_f = dataclasses.replace(_CFG, stream_width=128,
                                product_budget=1 << 11)
    cfg_l = dataclasses.replace(cfg_f, stream_max_width=64)  # force ladder
    A = device_put_csr(a)
    plan_f = plan_spgemm(A, A, cfg_f)
    plan_l = plan_spgemm(A, A, cfg_l)
    assert plan_f.stream.finish["classes"] is not None, \
        "expected adaptive finish"
    assert plan_l.stream.finish["classes"] is None, \
        "expected pure-ladder fallback"
    C_f = device_get_csr(plan_f.execute())
    C_l = device_get_csr(plan_l.execute())
    np.testing.assert_array_equal(C_f.row_offsets, C_l.row_offsets)
    np.testing.assert_array_equal(C_f.col_ids, C_l.col_ids)
    np.testing.assert_allclose(C_f.data, C_l.data, rtol=1e-4, atol=1e-6)
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, C_f, compare_data=True, rel_tol=2e-3).ok
    # numeric replay through the finish path with new values
    a2 = HostCSR(rows=a.rows, cols=a.cols, row_offsets=a.row_offsets,
                 col_ids=a.col_ids, data=a.data * -1.5)
    C2 = device_get_csr(plan_f.execute(device_put_csr(a2),
                                       device_put_csr(a2)))
    ref2 = oracle_spgemm(a2, a2)
    assert compare_csr(ref2, C2, compare_data=True, rel_tol=2e-3).ok


def test_unpacked_two_key_sort_path(rng):
    """pack_bits == 0 (key packing would overflow int32: wide W x big n,
    e.g. a 262k-col matrix whose giant row bumps W to 65536) falls back
    to the 2-key lax.sort — exercise it with the tight layout."""
    import scipy.sparse as sp
    from speck_tpu.ops.spgemm import plan_spgemm

    m, k, n = 150, 400, 131072
    a = sp.random(m, k, 0.05, format="csr",
                  random_state=np.random.RandomState(41))
    a.data = rng.standard_normal(a.nnz)
    b = sp.random(k, n, 0.002, format="csr",
                  random_state=np.random.RandomState(42))
    b.data = rng.standard_normal(b.nnz)
    ah, bh = HostCSR.from_scipy(a), HostCSR.from_scipy(b)
    cfg = dataclasses.replace(_CFG, stream_width=65536,
                              product_budget=1 << 17)
    A, B = device_put_csr(ah), device_put_csr(bh)
    plan = plan_spgemm(A, B, cfg)
    assert plan.stream is not None and plan.stream.pack_bits == 0, \
        plan.stream.pack_bits if plan.stream else None
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(ah, bh)
    assert compare_csr(ref, C, compare_data=True, rel_tol=2e-3).ok


def test_wide_rows_two_phase_levels_and_finish(rng):
    """Wide rows through the merge levels and the single-sort finish with
    two-phase staging (no fused staging), then a numeric replay with new
    values: oracle-exact both times."""
    a = random_host_csr(rng, 160, 160, 0.08)
    lil = a.to_scipy().tolil()
    lil[0, :] = rng.standard_normal(160)
    aw = HostCSR.from_scipy(lil.tocsr())
    cfg = dataclasses.replace(_CFG, stream_width=64, product_budget=1 << 10,
                              fused_staging_budget=0)
    Aw = device_put_csr(aw)
    from speck_tpu.ops.spgemm import plan_spgemm

    plan = plan_spgemm(Aw, Aw, cfg)
    assert plan.stream.layout.n_wide >= 1 and not plan.stream.fused
    Cw = device_get_csr(plan.execute())
    assert compare_csr(oracle_spgemm(aw, aw), Cw, compare_data=True,
                       rel_tol=2e-3).ok
    a2 = HostCSR(rows=aw.rows, cols=aw.cols, row_offsets=aw.row_offsets,
                 col_ids=aw.col_ids, data=aw.data * 0.5 - 1.0)
    A2 = device_put_csr(a2)
    C2 = device_get_csr(plan.execute(A2, A2))
    assert compare_csr(oracle_spgemm(a2, a2), C2, compare_data=True,
                       rel_tol=2e-3).ok


def test_accum_path_giant_span(rng):
    """Huge rows with bounded column spans route to the dense-span
    accumulator (the reference's dense mode for single big rows,
    spGEMMNumericLauncher spECK_HashSpGEMM.cuh:1761-1793): oracle-exact,
    replay-exact, and structurally identical to the accum-disabled run."""
    m = 500
    rs = np.random.RandomState(3)
    heavy = np.arange(100, 160)
    hr = np.repeat(heavy, 40)
    hc = (np.tile(np.arange(40), 60) * 3) % 120 + 300
    lr = np.repeat(np.arange(1, 80), 4)
    lc = rs.randint(0, 250, lr.shape[0])
    rows = np.concatenate([np.zeros(60, int), hr, lr])
    cols = np.concatenate([heavy, hc, lc])
    vals = rs.standard_normal(rows.shape[0])
    g = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    g.sum_duplicates()
    a = HostCSR.from_scipy(g)
    cfg = dataclasses.replace(
        _CFG, enable_accum=True, accum_min_ops=512,
        accum_span_cap=1 << 10, stream_width=256,
        product_budget=1 << 12)
    A = device_put_csr(a)
    plan = plan_spgemm(A, A, cfg)
    assert plan.stream.n_accum == 1 and plan.stream.accum
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, C, compare_data=True, rel_tol=2e-3).ok
    # numeric replay with new values through the accumulator
    a2 = HostCSR(a.rows, a.cols, a.row_offsets, a.col_ids, a.data * -2.0)
    C2 = device_get_csr(plan.execute(device_put_csr(a2),
                                     device_put_csr(a2)))
    assert compare_csr(oracle_spgemm(a2, a2), C2, compare_data=True,
                       rel_tol=2e-3).ok
    # identical structure with the accumulator disabled
    Cx = device_get_csr(spgemm(A, A, dataclasses.replace(
        cfg, enable_accum=False)))
    np.testing.assert_array_equal(C.row_offsets, Cx.row_offsets)
    np.testing.assert_array_equal(C.col_ids, Cx.col_ids)


def test_accum_multi_part_budget(rng):
    """A tiny accum_budget forces multiple accumulator parts; results
    stay oracle-exact."""
    m = 400
    rs = np.random.RandomState(7)
    # three hot rows with disjoint bounded spans
    segs = []
    for i, base in enumerate((200, 240, 280)):
        heavy = np.arange(50 + i * 20, 70 + i * 20)
        segs.append((np.full(20, i), heavy,
                     rs.standard_normal(20)))
        hr = np.repeat(heavy, 30)
        hc = (np.tile(np.arange(30), 20) * 2) % 36 + base
        segs.append((hr, hc, rs.standard_normal(hr.shape[0])))
    rows = np.concatenate([s[0] for s in segs])
    cols = np.concatenate([s[1] for s in segs])
    vals = np.concatenate([s[2] for s in segs])
    g = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    g.sum_duplicates()
    a = HostCSR.from_scipy(g)
    cfg = dataclasses.replace(
        _CFG, enable_accum=True, accum_min_ops=256,
        accum_span_cap=1 << 9,
        accum_budget=80,  # forces one part per row
        stream_width=128, product_budget=1 << 11)
    A = device_put_csr(a)
    plan = plan_spgemm(A, A, cfg)
    assert plan.stream.n_accum == 3
    assert len(plan.stream.accum["parts"]) >= 2
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, C, compare_data=True, rel_tol=2e-3).ok


def test_scatter_compact_matches_sort(rng):
    """stream_compact_impl="scatter" compacts staged buffers with flat
    scatters instead of a rank sort; results must be element-identical
    (the compaction is a deterministic permutation, not a reduction) on
    fused, two-phase, and wide-row paths."""
    a = random_host_csr(rng, 160, 160, 0.08)
    cfg_x = dataclasses.replace(_CFG, stream_width=256,
                                product_budget=1 << 12)
    A = device_put_csr(a)
    C_x = device_get_csr(spgemm(A, A, cfg_x))
    cfg_s = dataclasses.replace(cfg_x, stream_compact_impl="scatter")
    C_s = device_get_csr(spgemm(A, A, cfg_s))
    np.testing.assert_array_equal(C_x.row_offsets, C_s.row_offsets)
    np.testing.assert_array_equal(C_x.col_ids, C_s.col_ids)
    np.testing.assert_array_equal(C_x.data, C_s.data)

    # wide rows through the level ladder + finish, fused and two-phase
    lil = a.to_scipy().tolil()
    lil[0, :] = rng.standard_normal(160)
    lil[7, :] = rng.standard_normal(160)
    aw = HostCSR.from_scipy(lil.tocsr())
    refw = oracle_spgemm(aw, aw)
    Aw = device_put_csr(aw)
    for staging in (1 << 30, 0):
        cfg_w = dataclasses.replace(
            cfg_x, stream_width=64, product_budget=1 << 10,
            fused_staging_budget=staging)
        cfg_ws = dataclasses.replace(cfg_w, stream_compact_impl="scatter")
        C_w = device_get_csr(spgemm(Aw, Aw, cfg_w))
        C_ws = device_get_csr(spgemm(Aw, Aw, cfg_ws))
        np.testing.assert_array_equal(C_w.col_ids, C_ws.col_ids)
        np.testing.assert_array_equal(C_w.data, C_ws.data)
        assert compare_csr(refw, C_ws, compare_data=True, rel_tol=2e-3).ok


def test_nodup_fast_path_skips_compaction(rng, monkeypatch):
    """Fused contained-only chunks stage RAW; when nnz(C) equals the
    exact product total (no duplicate (row, col) products anywhere) the
    lazy compact pass must never run, and when duplicates exist it must
    run and produce output identical to eager compaction."""
    import importlib

    sg = importlib.import_module("speck_tpu.ops.spgemm")
    calls = {"n": 0}
    orig = sg.compact_staged

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(sg, "compact_staged", counted)

    # B rows with pairwise-disjoint column sets -> NO duplicates possible
    k = 64
    b = sp.csr_matrix(
        (rng.standard_normal(2 * k),
         (np.repeat(np.arange(k), 2),
          np.stack([2 * np.arange(k), 2 * np.arange(k) + 1],
                   axis=1).reshape(-1))),
        shape=(k, 2 * k))
    a = sp.random(48, k, 0.15, format="csr",
                  random_state=np.random.RandomState(5))
    a.data = rng.standard_normal(a.nnz)
    ah, bh = HostCSR.from_scipy(a), HostCSR.from_scipy(b)
    cfg = dataclasses.replace(_CFG, enable_direct=False)
    A, B = device_put_csr(ah), device_put_csr(bh)
    plan = plan_spgemm(A, B, cfg)
    assert plan.stream is not None and plan.stream.fused
    assert calls["n"] == 0, "no-dup plan must not compact"
    C = device_get_csr(plan.execute())
    assert compare_csr(oracle_spgemm(ah, bh), C, compare_data=True,
                       rel_tol=2e-3).ok

    # duplicates (random square product) -> lazy compaction must fire
    a2 = random_host_csr(rng, 96, 96, 0.2)
    A2 = device_put_csr(a2)
    plan2 = plan_spgemm(A2, A2, cfg)
    assert plan2.stream is not None and plan2.stream.fused
    assert calls["n"] >= 1, "duplicate plan must lazily compact"
    C2 = device_get_csr(plan2.execute())
    assert compare_csr(oracle_spgemm(a2, a2), C2, compare_data=True,
                       rel_tol=2e-3).ok
