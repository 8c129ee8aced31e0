"""DIA (diagonal-plane) fast path: routing gate + oracle parity.

The DIA path (speck_tpu/ops/dia.py) is the whole-matrix analogue of the
reference's dense-accumulator mode (spECK_HashSpGEMM.cuh:1175-1298): when
every nonzero of A and B lies in a bounded diagonal band, the multiply
runs as flat diagonal-plane multiply-adds. These tests pin the host
routing gate and the end-to-end result against the scipy oracle.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from speck_tpu import (SpgemmConfig, compare_csr, device_get_csr,
                       device_put_csr, oracle_spgemm)
from speck_tpu.formats.csr import HostCSR
from speck_tpu.ops.spgemm import plan_spgemm


def _run(a, b, cfg=None, dtype=np.float32, rel=2e-3):
    ah, bh = HostCSR.from_scipy(a), HostCSR.from_scipy(b)
    Ad = device_put_csr(ah, dtype)
    Bd = Ad if b is a else device_put_csr(bh, dtype)
    plan = plan_spgemm(Ad, Bd, cfg or SpgemmConfig())
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(ah, bh)
    r = compare_csr(ref, C, compare_data=True, rel_tol=rel)
    assert r.ok, r.message
    return plan


def _band(n, offs, rs):
    return sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                    shape=(n, n), format="csr")


def test_dia_banded_square(rng):
    rs = np.random.RandomState(0)
    a = _band(300, range(-3, 4), rs)
    plan = _run(a, a)
    assert plan.dia is not None
    assert plan.dia.span_a == 7 and plan.dia.span_c == 13


def test_dia_off_diagonal_band(rng):
    """dmin far from -dmax: the band need not straddle the diagonal."""
    rs = np.random.RandomState(1)
    a = _band(300, [10, 11, 12], rs)
    plan = _run(a, a)
    assert plan.dia is not None and plan.dia.dmin_a == 10


def test_dia_mixed_operands(rng):
    rs = np.random.RandomState(2)
    a = _band(300, range(-2, 3), rs)
    b = _band(300, range(1, 5), rs)
    plan = _run(a, b)
    assert plan.dia is not None
    assert plan.dia.span_a == 5 and plan.dia.span_b == 4


def test_dia_rectangular(rng):
    rs = np.random.RandomState(3)
    m, k, n = 200, 260, 240
    a = sp.diags([rs.standard_normal(min(m, k))] * 6, list(range(6)),
                 shape=(m, k), format="csr")
    b = sp.diags([rs.standard_normal(min(k, n))] * 5, list(range(-2, 3)),
                 shape=(k, n), format="csr")
    plan = _run(a, b)
    assert plan.dia is not None


def test_dia_explicit_zero_structure(rng):
    """Structural zeros survive (index-compare semantics,
    source/GPU/Compare.cu:38-47): a zero VALUE must not drop the entry."""
    rs = np.random.RandomState(4)
    a = _band(120, range(-2, 3), rs).tocsr()
    a.data[7] = 0.0
    plan = _run(a, a)
    assert plan.dia is not None


def test_dia_numeric_rerun(rng):
    """Plan reuse: execute() with new values against the stored
    structure (the symbolic result is data-independent)."""
    rs = np.random.RandomState(5)
    a = _band(200, range(-2, 3), rs)
    ah = HostCSR.from_scipy(a)
    Ad = device_put_csr(ah, np.float32)
    plan = plan_spgemm(Ad, Ad, SpgemmConfig())
    assert plan.dia is not None
    import dataclasses

    A2 = dataclasses.replace(Ad, data=Ad.data * -3.0)
    C2 = device_get_csr(plan.execute(A=A2, B=A2))
    ah2 = HostCSR(ah.rows, ah.cols, ah.row_offsets, ah.col_ids,
                  ah.data * -3.0)
    ref2 = oracle_spgemm(ah2, ah2)
    assert compare_csr(ref2, C2, compare_data=True, rel_tol=2e-3).ok


def test_dia_waste_gate_rejects_sparse_band(rng):
    """A wide span with few populated diagonals fails the CONTIGUOUS
    waste gate (m*span_a*span_b >> true products) — and is exactly what
    the sparse-DIA path exists for: with EnableSdia off it must stream;
    on (default) the offset-list planes take it."""
    rs = np.random.RandomState(6)
    a = _band(400, [0, 200], rs)          # span 201, two diagonals
    plan = _run(a, a, SpgemmConfig(enable_sdia=False))
    assert plan.dia is None
    plan2 = _run(a, a)
    assert plan2.dia is not None and plan2.dia.off_a is not None


def _stencil2d(g, offs_vals=None, seed=21):
    """2-D 5-point stencil on a g x g grid: offsets {-g, -1, 0, 1, g} —
    the (scaled-down) nlpkkt stencil class: few diagonals spread over a
    band the contiguous gate rejects."""
    rs = np.random.RandomState(seed)
    n = g * g
    offs = [-g, -1, 0, 1, g]
    return sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                    shape=(n, n), format="csr")


def test_sdia_stencil_square(rng):
    """A 5-point stencil A·A routes through sparse DIA and matches the
    oracle exactly in structure and values."""
    a = _stencil2d(24)
    plan = _run(a, a)
    assert plan.dia is not None and plan.dia.off_a is not None
    assert plan.dia.span_a == 5          # nd_a, not the band range


def test_sdia_mixed_offsets(rng):
    """A and B with DIFFERENT offset sets: off_c is the pairwise-sum
    set; values and structure match the oracle."""
    rs = np.random.RandomState(22)
    a = _band(500, [-7, 0, 3], rs)
    b = _band(500, [-40, 1, 90], rs)
    plan = _run(a, b)
    assert plan.dia is not None and plan.dia.off_a is not None
    assert plan.dia.span_c <= 9


def test_sdia_numeric_rerun(rng):
    """Plan reuse on the sparse-DIA route: new values against the
    stored structure."""
    import dataclasses

    a = _stencil2d(16, seed=23)
    ah = HostCSR.from_scipy(a)
    Ad = device_put_csr(ah, np.float32)
    plan = plan_spgemm(Ad, Ad, SpgemmConfig())
    assert plan.dia is not None and plan.dia.off_a is not None
    A2 = dataclasses.replace(Ad, data=Ad.data * 0.5)
    C2 = device_get_csr(plan.execute(A=A2, B=A2))
    ah2 = HostCSR(ah.rows, ah.cols, ah.row_offsets, ah.col_ids,
                  ah.data * 0.5)
    ref2 = oracle_spgemm(ah2, ah2)
    assert compare_csr(ref2, C2, compare_data=True, rel_tol=2e-3).ok


def test_sdia_pair_cap_rejects_random(rng):
    """An unstructured matrix has ~span distinct offsets: the pair cap
    rejects sparse DIA and the stream path still gets it right."""
    rs = np.random.RandomState(24)
    a = sp.random(300, 300, 0.03, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    plan = _run(a, a)
    assert plan.dia is None


def test_sdia_rectangular(rng):
    """Non-square sparse-DIA: A (m x k), B (k x n) with distinct offset
    sets."""
    rs = np.random.RandomState(25)

    def diag_mat(m, k, offs):
        rows, cols = [], []
        for o in offs:
            r = np.arange(max(0, -o), min(m, k - o))
            rows.append(r)
            cols.append(r + o)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        return sp.csr_matrix(
            (rs.standard_normal(rows.size), (rows, cols)), shape=(m, k))

    a = diag_mat(300, 280, [-30, 0, 17])
    b = diag_mat(280, 320, [0, 9, -55])
    plan = _run(a, b)
    assert plan.dia is not None and plan.dia.off_a is not None


def test_dia_span_cap_gate(rng):
    rs = np.random.RandomState(7)
    a = _band(300, range(-3, 4), rs)
    # contiguous gate rejected (span 7 > 4); sparse DIA picks it up
    plan = _run(a, a, SpgemmConfig(dia_span_cap=4))
    assert plan.dia is not None and plan.dia.off_a is not None
    # with sparse DIA off too, the whole family falls back
    plan = _run(a, a, SpgemmConfig(dia_span_cap=4, enable_sdia=False,
                                   sdia_span_cap=4))
    assert plan.dia is None


def test_dia_disabled_falls_back(rng):
    rs = np.random.RandomState(8)
    a = _band(300, range(-3, 4), rs)
    plan = _run(a, a, SpgemmConfig(enable_dia=False))
    assert plan.dia is None


def test_dia_noncanonical_falls_back(rng):
    """DIA needs canonical inputs (band stats read first/last column per
    row); unsorted columns must route to the general path and still be
    correct."""
    rs = np.random.RandomState(9)
    a = _band(150, range(-2, 3), rs).tocsr()
    ah = HostCSR.from_scipy(a)
    # reverse each row's column order -> non-canonical
    for i in range(ah.rows):
        s, e = ah.row_offsets[i], ah.row_offsets[i + 1]
        ah.col_ids[s:e] = ah.col_ids[s:e][::-1].copy()
        ah.data[s:e] = ah.data[s:e][::-1].copy()
    Ad = device_put_csr(ah, np.float32)
    assert not Ad.canonical
    plan = plan_spgemm(Ad, Ad, SpgemmConfig())
    assert plan.dia is None
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(ah, ah)
    assert compare_csr(ref, C, compare_data=True, rel_tol=2e-3).ok


def test_dia_fp64(rng):
    import jax

    if not jax.config.read("jax_enable_x64"):
        pytest.skip("x64 disabled in this session")
    rs = np.random.RandomState(10)
    a = _band(200, range(-2, 3), rs)
    plan = _run(a, a, dtype=np.float64, rel=1e-12)
    assert plan.dia is not None


def test_dia_identity(rng):
    a = sp.eye(64, format="csr")
    plan = _run(a, a)
    assert plan.dia is not None


@pytest.mark.parametrize("kind", ["banded", "random", "sparse_band"])
def test_dia_gate_early_routing_parity(rng, kind):
    """DiaGateEarly=True and False must pick the same route (DIA vs
    stream/dense) and produce the same nnz for identical inputs — a
    drift between the two gates' _dia_spans inputs would route the same
    matrix differently depending on a perf knob (ADVICE.md round 2)."""
    rs = np.random.RandomState(12)
    if kind == "banded":
        a = _band(300, range(-3, 4), rs)
    elif kind == "sparse_band":
        a = _band(400, [0, 200], rs)   # wide span, waste gate rejects
    else:
        a = sp.random(300, 300, 0.02, format="csr",
                      random_state=rs, dtype=np.float64)
    ah = HostCSR.from_scipy(a)
    A = device_put_csr(ah, np.float32)
    plans = [plan_spgemm(A, A, SpgemmConfig(dia_gate_early=g))
             for g in (True, False)]
    assert (plans[0].dia is None) == (plans[1].dia is None)
    assert plans[0].nnz == plans[1].nnz
    c0 = device_get_csr(plans[0].execute())
    c1 = device_get_csr(plans[1].execute())
    np.testing.assert_array_equal(c0.col_ids, c1.col_ids)


def test_dia_gate_early_overflow_parity(rng):
    """Both gate settings must raise ProductOverflow for the same
    too-many-products input (the guards run on either route)."""
    from speck_tpu.utils.config import ProductOverflow

    rs = np.random.RandomState(13)
    a = sp.random(400, 400, 0.2, format="csr", random_state=rs)
    A = device_put_csr(HostCSR.from_scipy(a), np.float32)
    for g in (True, False):
        cfg = SpgemmConfig(dia_gate_early=g, block_products=1 << 10)
        with pytest.raises(ProductOverflow):
            plan_spgemm(A, A, cfg)


def test_dia_scatter_compact_matches_sort(rng):
    """stream_compact_impl="scatter" routes the DIA staging compaction
    through flat scatters; results must be element-identical to the
    rank-sort form, including on numeric-only replays."""
    rs = np.random.RandomState(11)
    a = _band(300, range(-2, 3), rs)
    ah = HostCSR.from_scipy(a)
    A = device_put_csr(ah, np.float32)
    plans, outs = [], []
    for impl in ("sort", "scatter"):
        cfg = SpgemmConfig(stream_compact_impl=impl)
        plan = plan_spgemm(A, A, cfg)
        assert plan.dia is not None
        plans.append(plan)
        outs.append(device_get_csr(plan.execute()))
    np.testing.assert_array_equal(outs[0].row_offsets, outs[1].row_offsets)
    np.testing.assert_array_equal(outs[0].col_ids, outs[1].col_ids)
    np.testing.assert_array_equal(outs[0].data, outs[1].data)
    # numeric replay with new values (forces dia_numeric_stage)
    a2 = a.copy(); a2.data = rs.standard_normal(a2.nnz)
    A2 = device_put_csr(HostCSR.from_scipy(a2), np.float32)
    r0 = device_get_csr(plans[0].execute(A2, A2))
    r1 = device_get_csr(plans[1].execute(A2, A2))
    np.testing.assert_array_equal(r0.col_ids, r1.col_ids)
    np.testing.assert_array_equal(r0.data, r1.data)
    ref = oracle_spgemm(HostCSR.from_scipy(a2), HostCSR.from_scipy(a2))
    assert compare_csr(ref, r1, compare_data=True, rel_tol=2e-3).ok


def test_dia_uniform_emit_taken_and_exact(rng):
    """A banded matrix's interior rows are all full (count == span_c), so
    the uniform-rows fast emit must engage, and its split emission
    (edge gathers + one contiguous interior copy) must be element-
    identical to the all-gather form (DiaUniformEmit=false)."""
    rs = np.random.RandomState(21)
    a = _band(500, range(-3, 4), rs)
    plan = _run(a, a)
    assert plan.dia is not None and plan.dia.uniform is not None
    up, uq, u_offs = plan.dia.uniform
    # band half-width 3 in A -> 6 in C: rows 6..m-6 are full
    assert up == 6 and uq == 500 - 6 and u_offs == plan.row_offsets[6]
    plan_off = _run(a, a, SpgemmConfig(dia_uniform_emit=False))
    assert plan_off.dia.uniform is None
    c_on = device_get_csr(plan.execute())
    c_off = device_get_csr(plan_off.execute())
    np.testing.assert_array_equal(c_on.col_ids, c_off.col_ids)
    np.testing.assert_array_equal(c_on.data, c_off.data)


def test_dia_uniform_emit_broken_run_falls_back(rng):
    """An empty interior row splits the full run; run_ok must go false
    and the plan must fall back to the gather emit, still exact."""
    rs = np.random.RandomState(22)
    a = _band(400, range(-2, 3), rs).tolil()
    a[200, :] = 0          # C row 200 empty; rows 198..202 not full
    a = a.tocsr()
    a.eliminate_zeros()
    plan = _run(a, a)
    assert plan.dia is not None and plan.dia.uniform is None


def test_dia_uniform_emit_numeric_rerun(rng):
    """Uniform emit on a numeric replay with new values (the staged
    branch is bypassed; dia_numeric_stage feeds the same split)."""
    import dataclasses

    rs = np.random.RandomState(23)
    a = _band(300, range(-2, 3), rs)
    ah = HostCSR.from_scipy(a)
    Ad = device_put_csr(ah, np.float32)
    plan = plan_spgemm(Ad, Ad, SpgemmConfig())
    assert plan.dia is not None and plan.dia.uniform is not None
    A2 = dataclasses.replace(Ad, data=Ad.data * 0.5)
    C2 = device_get_csr(plan.execute(A=A2, B=A2))
    ah2 = HostCSR(ah.rows, ah.cols, ah.row_offsets, ah.col_ids,
                  ah.data * 0.5)
    ref2 = oracle_spgemm(ah2, ah2)
    assert compare_csr(ref2, C2, compare_data=True, rel_tol=2e-3).ok


# ---------------------------------------------------------------------------
# Per-row DIA split (cfg.dia_rows): banded bulk on planes, outliers on
# the stream — the per-row form of the reference's per-block method
# auto-select (spECK_HashSpGEMM.cuh:1761-1793)
# ---------------------------------------------------------------------------


def _mixed_band_outliers(n=2048, half=4, n_out=24, out_nnz=12, seed=3):
    rs = np.random.RandomState(seed)
    band = _band(n, range(-half, half + 1), rs)
    out_rows = np.repeat(np.arange(n_out), out_nnz)
    extra = sp.csr_matrix(
        (rs.standard_normal(out_rows.shape[0]),
         (out_rows, rs.randint(0, n, out_rows.shape[0]))), shape=(n, n))
    m = (band + extra).tocsr()
    m.sum_duplicates()
    return m


def test_dia_rows_mixed_routing(rng):
    """Whole-matrix gate fails (outliers span ~n); the banded bulk rides
    the per-row plane route, outliers ride the stream; oracle exact."""
    a = _mixed_band_outliers()
    plan = _run(a, a)
    assert plan.dia is None                      # whole-matrix gate lost
    assert plan.dia_rows is not None             # per-row split engaged
    assert plan.dia_rows.span_a <= 2 * 4 + 1
    # outliers (and banded rows touching outlier B rows) are stream rows
    assert plan.stream.layout.n_stream_rows > 0


def test_dia_rows_numeric_rerun(rng):
    """Plan reuse with new values re-convolves against the stored masked
    slots and the structural presence mask."""
    a = _mixed_band_outliers(seed=5)
    ah = HostCSR.from_scipy(a)
    Ad = device_put_csr(ah, np.float32)
    plan = plan_spgemm(Ad, Ad)
    assert plan.dia_rows is not None
    a2 = a.copy()
    a2.data = a2.data * -1.5 + 0.125
    ah2 = HostCSR.from_scipy(a2)
    Ad2 = device_put_csr(ah2, np.float32)
    C2 = device_get_csr(plan.execute(Ad2, Ad2))
    ref2 = oracle_spgemm(ah2, ah2)
    r = compare_csr(ref2, C2, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_dia_rows_disabled_parity(rng):
    """DiaRows=false routes everything through the classic paths with
    identical structure and values."""
    a = _mixed_band_outliers(seed=7)
    plan = _run(a, a, SpgemmConfig(dia_rows=False))
    assert plan.dia_rows is None


def test_dia_rows_fp64(rng):
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        a = _mixed_band_outliers(n=512, seed=9)
        plan = _run(a, a, dtype=np.float64, rel=1e-9)
        assert plan.dia_rows is not None
    finally:
        jax.config.update("jax_enable_x64", False)


def test_dia_rows_gate_rejects_unbanded(rng):
    """A random-structure matrix must not engage the per-row split (the
    robust band blows past the span cap / waste gate)."""
    rs = np.random.RandomState(11)
    a = sp.random(1024, 1024, 0.005, format="csr", random_state=rs)
    a.data = rs.standard_normal(a.nnz)
    plan = _run(a, a)
    assert plan.dia_rows is None


def test_dia_rows_rectangular(rng):
    """Rectangular banded A (m > k) with outlier rows: the split works on
    non-square operands (B = A^T-free product A @ P)."""
    rs = np.random.RandomState(13)
    m, k = 1024, 1024
    a = _mixed_band_outliers(n=m, seed=13)
    # P: banded prolongation-like k x k/2 (diagonal pairs)
    p = sp.csr_matrix((np.ones(k), (np.arange(k), np.arange(k) // 2)),
                      shape=(k, k // 2))
    ah, ph = HostCSR.from_scipy(a), HostCSR.from_scipy(p)
    Ad, Pd = device_put_csr(ah, np.float32), device_put_csr(ph, np.float32)
    plan = plan_spgemm(Ad, Pd)
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(ah, ph)
    r = compare_csr(ref, C, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_lite_gate_routes_large_stencil(rng):
    """Inputs past HostAnalysisMaxNnz must STILL take the (s)DIA routes
    via the lite host gate (band extremes O(rows) + one bincount dot):
    round-4 regression — the 28M-nnz stencil fell onto the stream and
    cost 146 s. Forced here by a tiny cap on a small stencil."""
    g = 10
    n = g ** 3
    offs = sorted(dz * g * g + dy * g + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    rs = np.random.RandomState(3)
    a = sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                 shape=(n, n), format="csr")
    plan = _run(a, a, SpgemmConfig(host_analysis_max_nnz=16))
    assert plan.dia is not None   # sparse-DIA route engaged

    # contiguous band past the cap: lite gate -> contiguous DIA
    band = sp.diags([rs.standard_normal(512 - abs(o))
                     for o in range(-3, 4)], range(-3, 4),
                    shape=(512, 512), format="csr")
    plan2 = _run(band, band, SpgemmConfig(host_analysis_max_nnz=16))
    assert plan2.dia is not None

    # non-banded input past the cap: lite gate must REJECT and fall
    # through to the device analysis unchanged
    r = sp.random(400, 400, 0.03, format="csr", random_state=rs)
    r.data = rs.standard_normal(r.nnz)
    plan3 = _run(r, r, SpgemmConfig(host_analysis_max_nnz=16))
    assert plan3.dia is None


def test_sdia_conv_blocked_matches_whole(rng):
    """The row-blocked sparse-DIA convolution (memory-bounded form that
    avoids the whole-matrix compile OOM at stencil scale) must produce
    the same planes as the one-shot form, including the padded tail
    block."""
    import jax.numpy as jnp
    from speck_tpu.ops.dia import sdia_conv, sdia_conv_blocked

    rs = np.random.RandomState(7)
    m = k = 300
    off_a = (-9, -1, 0, 2, 11)
    off_b = (-4, 0, 5)
    off_c = tuple(sorted({a + b for a in off_a for b in off_b}))
    av = jnp.asarray(rs.standard_normal((len(off_a), m)).astype(np.float32))
    ah = jnp.asarray((rs.rand(len(off_a), m) > 0.3).astype(np.float32))
    bv = jnp.asarray(rs.standard_normal((len(off_b), k)).astype(np.float32))
    bh = jnp.asarray((rs.rand(len(off_b), k) > 0.3).astype(np.float32))
    ref_v, ref_c = sdia_conv(av, ah, bv, bh, off_a=off_a, off_b=off_b,
                             off_c=off_c, m=m, k=k, with_hit=True)
    got_v, got_c = sdia_conv_blocked(av, ah, bv, bh, off_a=off_a,
                                     off_b=off_b, off_c=off_c, m=m, k=k,
                                     with_hit=True, row_block=128)
    assert np.allclose(np.asarray(ref_v), np.asarray(got_v), atol=1e-5)
    assert np.array_equal(np.asarray(ref_c), np.asarray(got_c))
    # no-hit flavor (the numeric rerun path)
    ref_v2, _ = sdia_conv(av, ah, bv, bh, off_a=off_a, off_b=off_b,
                          off_c=off_c, m=m, k=k, with_hit=False)
    got_v2, _ = sdia_conv_blocked(av, ah, bv, bh, off_a=off_a,
                                  off_b=off_b, off_c=off_c, m=m, k=k,
                                  with_hit=False, row_block=128)
    assert np.allclose(np.asarray(ref_v2), np.asarray(got_v2), atol=1e-5)
