"""Dense-window tile path (ops/dense.py): banded/low-colrange matrices
must route through dense tiles and match the oracle exactly (structure) and
within fp tolerance (values). The reference analogue is spECK's dense mode
(spECK_HashSpGEMM.cuh:1175-1711)."""

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

# tiny tiles so small test matrices exercise the dense path on CPU;
# DIA off — banded fixtures would otherwise route to the diagonal-plane
# path (ops/dia.py, tested in test_dia.py) before reaching dense tiles
_DENSE_CFG = SpgemmConfig(
    product_budget=1 << 14,
    dense_tile_rows=16, dense_kw=64, dense_cw=64, dense_la=16, dense_lb=16,
    enable_dia=False,
)


def _banded(n, half_band, rng):
    offs = list(range(-half_band, half_band + 1))
    mat = sp.diags(
        [rng.standard_normal(n - abs(o)) for o in offs], offs,
        shape=(n, n), format="csr",
    )
    return HostCSR.from_scipy(mat.tocsr())


def test_banded_routes_dense(rng):
    a = _banded(96, 3, rng)
    A = device_put_csr(a, np.float64)
    plan = plan_spgemm(A, A, _DENSE_CFG)
    assert plan.dense is not None, "banded matrix should take the dense path"
    assert int(np.sum(plan.dense.valids)) == 96, "all rows dense-covered"
    assert not plan.groups, "no ESC groups expected"
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, C, compare_data=True, rel_tol=2e-4).ok


def test_dense_mixed_with_esc(rng):
    # banded core plus a few dense-busting wide rows -> mixed routing
    a = _banded(64, 2, rng).to_scipy().tolil()
    a[5, :] = rng.standard_normal(64)    # full row in tile 0
    a[33, ::2] = rng.standard_normal(32) # wide row in tile 2
    a = HostCSR.from_scipy(a.tocsr())
    A = device_put_csr(a, np.float64)
    plan = plan_spgemm(A, A, _DENSE_CFG)
    assert plan.dense is not None
    assert plan.stream is not None and plan.stream.layout.n_stream_rows, \
        "wide-row tiles must fall back to the stream path"
    C = device_get_csr(plan.execute())
    ref = oracle_spgemm(a, a)
    # mixed routing: ESC rows carry cumsum-difference accumulation error
    assert compare_csr(ref, C, compare_data=True, rel_tol=1e-2).ok


def test_dense_exact_zero_structure(rng):
    # products that cancel to exact 0.0 must stay structurally present
    # (the int8 pattern matmul, not value != 0, decides presence)
    n = 32
    rows = np.array([0, 0, 1, 1], np.uint32)
    cols = np.array([0, 1, 0, 1], np.uint32)
    # A = [[1, -1], [1, 1]] block in top corner; A@A row 0 col 1: 1*(-1) + (-1)*1 = -2?
    # Use B so a product cancels: C[0,0] = 1*1 + (-1)*1 = 0 with B=[[1],[1]]
    a = HostCSR.from_scipy(sp.csr_matrix(
        (np.array([1.0, -1.0, 1.0, 1.0]), (rows, cols)), shape=(n, n)))
    b = HostCSR.from_scipy(sp.csr_matrix(
        (np.array([1.0, 1.0]), (np.array([0, 1], np.uint32),
                                np.array([0, 0], np.uint32))), shape=(n, n)))
    A = device_put_csr(a, np.float64)
    B = device_put_csr(b, np.float64)
    C = device_get_csr(spgemm(A, B, _DENSE_CFG))
    ref = oracle_spgemm(a, b)  # scipy keeps the explicit zero
    assert C.nnz == ref.nnz
    assert compare_csr(ref, C, compare_data=True, rel_tol=1e-5).ok


def test_dense_rectangular(rng):
    # rectangular A (m x k) @ B (k x n) with banded-ish structure
    m, k, n = 48, 64, 40
    a = sp.random(m, k, 0.1, format="csr",
                  random_state=np.random.RandomState(7))
    a.data = rng.standard_normal(a.nnz)
    b = sp.random(k, n, 0.15, format="csr",
                  random_state=np.random.RandomState(8))
    b.data = rng.standard_normal(b.nnz)
    ah, bh = HostCSR.from_scipy(a), HostCSR.from_scipy(b)
    A, B = device_put_csr(ah, np.float64), device_put_csr(bh, np.float64)
    C = device_get_csr(spgemm(A, B, _DENSE_CFG))
    ref = oracle_spgemm(ah, bh)
    assert compare_csr(ref, C, compare_data=True, rel_tol=2e-4).ok


def test_dense_plan_reexecute_new_values(rng):
    a = _banded(64, 2, rng)
    A = device_put_csr(a, np.float64)
    plan = plan_spgemm(A, A, _DENSE_CFG)
    assert plan.dense is not None
    C1 = device_get_csr(plan.execute())
    a2 = HostCSR(a.rows, a.cols, a.row_offsets, a.col_ids, a.data * -3.0)
    A2 = device_put_csr(a2, np.float64)
    C2 = device_get_csr(plan.execute(A2, A2))
    ref2 = oracle_spgemm(a2, a2)
    assert compare_csr(ref2, C2, compare_data=True, rel_tol=2e-4).ok
    np.testing.assert_array_equal(C1.col_ids, C2.col_ids)


def test_dense_disabled_matches(rng):
    a = _banded(80, 2, rng)
    A = device_put_csr(a, np.float64)
    C_d = device_get_csr(spgemm(A, A, _DENSE_CFG))
    C_e = device_get_csr(
        spgemm(A, A, dataclasses.replace(_DENSE_CFG, enable_dense=False)))
    np.testing.assert_array_equal(C_d.row_offsets, C_e.row_offsets)
    np.testing.assert_array_equal(C_d.col_ids, C_e.col_ids)
    np.testing.assert_allclose(C_d.data, C_e.data, rtol=1e-4, atol=1e-6)

def test_pure_dense_gather_emit(rng, monkeypatch):
    """The pure-dense single-batch plan must take the gather-based emit
    (dense_gather_emit) and produce the identical CSR the masked-scatter
    emit produces; both must match the oracle. Empty rows included."""
    import importlib

    sg = importlib.import_module("speck_tpu.ops.spgemm")
    calls = {"n": 0}
    orig = sg.dense_gather_emit

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(sg, "dense_gather_emit", counted)

    a = _banded(96, 3, rng).to_scipy().tolil()
    a[17, :] = 0  # empty row inside a tile
    a[95, :] = 0  # empty trailing row
    a = HostCSR.from_scipy(a.tocsr())
    A = device_put_csr(a, np.float64)
    plan = plan_spgemm(A, A, _DENSE_CFG)
    assert plan.dense is not None and not plan.groups
    assert len(plan.dense.boffs) == 2, "expected a single dense batch"
    C_g = device_get_csr(plan.execute())          # gather path (staged)
    assert calls["n"] == 1, "gather emit not taken"
    C_s = device_get_csr(plan.execute(A, A))      # scatter path (recompute)
    np.testing.assert_array_equal(C_g.row_offsets, C_s.row_offsets)
    np.testing.assert_array_equal(C_g.col_ids, C_s.col_ids)
    np.testing.assert_allclose(C_g.data, C_s.data, rtol=1e-6)
    assert compare_csr(oracle_spgemm(a, a), C_g, compare_data=True,
                       rel_tol=2e-4).ok

def test_ineligible_groupless_tile_not_pure(rng, monkeypatch):
    """An INeligible tile whose rows all have zero products (long A rows
    referencing only empty B rows) creates no ESC groups either; the
    gather emit must NOT fire (staged row index would not equal matrix row
    index) and the scatter emit must stay correct. (A fully-EMPTY tile, by
    contrast, is eligible — spans bottom out at 1 — and keeps the tile
    sequence intact.)"""
    import importlib

    sg = importlib.import_module("speck_tpu.ops.spgemm")
    calls = {"n": 0}
    orig = sg.dense_gather_emit

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(sg, "dense_gather_emit", counted)

    a = _banded(96, 3, rng).to_scipy().tolil()
    b = _banded(96, 3, rng).to_scipy().tolil()
    b[40:60, :] = 0              # empty B rows
    for r in range(32, 48):      # tile 2: 20 nnz/row (> dense_la=16)
        a[r, :] = 0              # -> tile ineligible, yet every row's
        for c in range(40, 60):  # products hit only empty B rows (ops=0)
            a[r, c] = 1.0
    a = HostCSR.from_scipy(a.tocsr())
    b = HostCSR.from_scipy(b.tocsr())
    A = device_put_csr(a, np.float64)
    B = device_put_csr(b, np.float64)
    plan = plan_spgemm(A, B, _DENSE_CFG)
    assert plan.dense is not None
    assert not plan.dense.full_cover
    # the ineligible tile's rows (alen > 0, ops == 0) produce no stream
    # content (zero products -> count 0 for free); full_cover alone must
    # veto the gather emit
    C = device_get_csr(plan.execute())
    assert calls["n"] == 0, "gather emit must not fire without full cover"
    assert compare_csr(oracle_spgemm(a, b), C, compare_data=True,
                       rel_tol=2e-4).ok


def test_pure_dense_gather_emit_multibatch(rng, monkeypatch):
    """full_cover with several dense dispatch batches: the gather emit
    concatenates the staged batches and must match the oracle."""
    import importlib

    sg = importlib.import_module("speck_tpu.ops.spgemm")
    calls = {"n": 0}
    orig = sg.dense_gather_emit

    def counted(*args, **kwargs):
        calls["n"] += 1
        return orig(*args, **kwargs)

    monkeypatch.setattr(sg, "dense_gather_emit", counted)

    cfg = dataclasses.replace(_DENSE_CFG, dense_tiles_per_dispatch=2)
    a = _banded(96, 3, rng)
    A = device_put_csr(a, np.float64)
    plan = plan_spgemm(A, A, cfg)
    assert plan.dense is not None and not plan.groups
    assert plan.dense.full_cover and len(plan.dense.boffs) > 2
    C = device_get_csr(plan.execute())
    assert calls["n"] == 1, "gather emit not taken"
    assert compare_csr(oracle_spgemm(a, a), C, compare_data=True,
                       rel_tol=2e-4).ok


def test_outlier_locality_controls_tile_eligibility(rng):
    """Tile eligibility gates on the REFERENCED B rows (bmax), so outlier
    rows poison exactly the tiles whose k-range touches them: clustered
    outliers leave distant tiles dense-eligible; the same outliers
    scattered everywhere push every tile to the stream (bench.py
    make_mixed relies on the clustered form)."""
    n, hb = 1024, 3

    def build(out_rows):
        a = _banded(n, hb, rng).to_scipy().tolil()
        for r in out_rows:
            cols = rng.integers(0, n, 16)
            a[r, cols] = rng.standard_normal(len(cols))
        return HostCSR.from_scipy(a.tocsr())

    cfg = dataclasses.replace(
        _DENSE_CFG, dense_tile_rows=64, dense_kw=128, dense_cw=128,
        dense_la=16, dense_lb=16)

    clustered = build(range(0, 32))
    A = device_put_csr(clustered, np.float64)
    plan = plan_spgemm(A, A, cfg)
    assert plan.dense is not None
    n_real = int(np.sum(np.asarray(plan.dense.valids) > 0))
    assert n_real >= 12, f"distant tiles should stay eligible, got {n_real}"
    C = device_get_csr(plan.execute())
    assert compare_csr(oracle_spgemm(clustered, clustered), C,
                       compare_data=True, rel_tol=1e-2).ok

    scattered = build(range(0, n, 64))   # one outlier inside every tile
    A2 = device_put_csr(scattered, np.float64)
    plan2 = plan_spgemm(A2, A2, cfg)
    n_real2 = (int(np.sum(np.asarray(plan2.dense.valids) > 0))
               if plan2.dense is not None else 0)
    assert n_real2 == 0, f"every tile is poisoned, got {n_real2}"
    C2 = device_get_csr(plan2.execute())
    assert compare_csr(oracle_spgemm(scattered, scattered), C2,
                       compare_data=True, rel_tol=1e-2).ok
