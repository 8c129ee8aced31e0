"""SpGEMM differential validation against the scipy oracle (SURVEY.md §4):
structure must match exactly (row lengths + sorted column indices), values
within floating tolerance — the same bar as the reference's cuSPARSE compare
(/root/reference/source/GPU/Compare.cu:27-58)."""

import numpy as np
import pytest

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


# Small chunk budget keeps CPU compile times low; the bin-capacity ladder
# (the correctness-relevant part) is identical to the default config.
_TEST_CFG = SpgemmConfig(product_budget=1 << 14)

# Value tolerance: run sums use a segmented Hillis-Steele scan (numerically
# local, no cross-run cancellation) and the dense path's matmuls run at
# HIGHEST precision, so fp32 error is ~sqrt(run_len)*eps — well under
# 1e-3 relative. The reference's own value-compare bar is 1% and disabled by
# default ("spECK is not bit stable", config.ini:7-9, readme.md:37); ours is
# 5x tighter and always on.
def _check(a, b, cfg=_TEST_CFG, rtol=2e-3):
    ref = oracle_spgemm(a, b)
    A = device_put_csr(a)
    B = device_put_csr(b)
    C = device_get_csr(spgemm(A, B, cfg))
    r = compare_csr(ref, C, compare_data=False)
    assert r.ok, r.message
    rv = compare_csr(ref, C, compare_data=True, rel_tol=rtol)
    assert rv.ok, rv.message
    return C


def test_identity():
    n = 16
    eye = HostCSR(
        rows=n, cols=n,
        row_offsets=np.arange(n + 1, dtype=np.uint32),
        col_ids=np.arange(n, dtype=np.uint32),
        data=np.ones(n),
    )
    C = _check(eye, eye)
    assert C.nnz == n


def test_small_dense_block(rng):
    a = random_host_csr(rng, 8, 8, 0.9)
    _check(a, a)


@pytest.mark.parametrize("density", [0.01, 0.1, 0.4])
@pytest.mark.parametrize("shape", [(64, 64, 64), (50, 70, 30), (128, 32, 200)])
def test_random_rect(rng, density, shape):
    m, k, n = shape
    a = random_host_csr(rng, m, k, density)
    b = random_host_csr(rng, k, n, density)
    _check(a, b)


def test_default_config(rng):
    """One run through the production default SpgemmConfig."""
    a = random_host_csr(rng, 64, 64, 0.1)
    _check(a, a, cfg=None)


def test_empty_rows_and_cols(rng):
    a = random_host_csr(rng, 60, 40, 0.1, empty_row_frac=0.5)
    b = random_host_csr(rng, 40, 50, 0.1, empty_row_frac=0.5)
    _check(a, b)


def test_all_empty():
    a = HostCSR(
        rows=5, cols=5,
        row_offsets=np.zeros(6, np.uint32),
        col_ids=np.zeros(0, np.uint32),
        data=np.zeros(0),
    )
    C = _check(a, a)
    assert C.nnz == 0


def test_single_entry():
    a = HostCSR(
        rows=3, cols=3,
        row_offsets=np.array([0, 0, 1, 1], np.uint32),
        col_ids=np.array([2], np.uint32),
        data=np.array([2.0]),
    )
    b = HostCSR(
        rows=3, cols=4,
        row_offsets=np.array([0, 1, 1, 3], np.uint32),
        col_ids=np.array([1, 0, 3], np.uint32),
        data=np.array([5.0, 1.0, -1.0]),
    )
    C = _check(a, b)
    assert C.nnz == 2  # row 1 = 2.0 * B row 2


def test_duplicate_entries_summed(rng):
    # CSR inputs may carry duplicate column ids (the loader keeps them);
    # products at the same output column must merge.
    a = HostCSR(
        rows=2, cols=2,
        row_offsets=np.array([0, 3, 4], np.uint32),
        col_ids=np.array([0, 0, 1, 1], np.uint32),
        data=np.array([1.0, 2.0, 3.0, 4.0]),
    )
    b = HostCSR(
        rows=2, cols=2,
        row_offsets=np.array([0, 2, 3], np.uint32),
        col_ids=np.array([0, 1, 1], np.uint32),
        data=np.array([1.0, 1.0, 1.0]),
    )
    _check(a, b)


def test_skewed_rows(rng):
    """One giant row among tiny rows (spECK's raison d'être, SURVEY §7.4)."""
    import scipy.sparse as sp

    m = 200
    rows = [np.full(150, 7)] + [np.array([i]) for i in range(40)]
    r = np.concatenate(rows)
    c = np.concatenate([rng.choice(200, 150, replace=False)] + [
        rng.integers(0, 200, 1) for _ in range(40)
    ])
    d = rng.standard_normal(r.shape[0])
    a = HostCSR.from_scipy(sp.csr_matrix((d, (r, c)), shape=(m, 200)))
    _check(a, a)


def test_bin_ladder_spread(rng):
    """Rows spanning several bins including the huge path (tiny config)."""
    cfg = SpgemmConfig(product_budget=1 << 12, stream_width=256)
    a = random_host_csr(rng, 96, 96, 0.15)
    b = random_host_csr(rng, 96, 96, 0.4)
    _check(a, b, cfg)


def test_float32_values(rng):
    a = random_host_csr(rng, 40, 40, 0.2, dtype=np.float32)
    ref = oracle_spgemm(a, a)
    C = device_get_csr(
        spgemm(device_put_csr(a, np.float32), device_put_csr(a, np.float32), _TEST_CFG)
    )
    assert compare_csr(ref, C).ok
    assert compare_csr(ref, C, compare_data=True, rel_tol=1e-3).ok


def test_plan_reuse_new_values(rng):
    """Symbolic structure reuse: same pattern, new values (beyond-reference
    feature; validates the plan/execute split)."""
    a = random_host_csr(rng, 50, 50, 0.15)
    A = device_put_csr(a)
    plan = plan_spgemm(A, A, _TEST_CFG)
    C1 = device_get_csr(plan.execute())

    a2 = HostCSR(a.rows, a.cols, a.row_offsets, a.col_ids, a.data * 2.0 + 0.25)
    A2 = device_put_csr(a2)
    C2 = device_get_csr(plan.execute(A2, A2))
    ref2 = oracle_spgemm(a2, a2)
    assert compare_csr(ref2, C2, compare_data=True, rel_tol=1e-4).ok
    np.testing.assert_array_equal(C1.col_ids, C2.col_ids)


def test_dimension_mismatch_raises(rng):
    a = random_host_csr(rng, 4, 5, 0.5)
    b = random_host_csr(rng, 6, 4, 0.5)
    with pytest.raises(ValueError):
        spgemm(device_put_csr(a), device_put_csr(b))


def test_output_sorted_and_offsets_monotone(rng):
    a = random_host_csr(rng, 80, 80, 0.2)
    C = device_get_csr(spgemm(device_put_csr(a), device_put_csr(a), _TEST_CFG))
    offs = C.row_offsets
    assert (np.diff(offs) >= 0).all()
    for r in range(C.rows):
        cols = C.col_ids[offs[r]:offs[r + 1]]
        assert (np.diff(cols) > 0).all(), f"row {r} not strictly sorted"


def test_two_phase_fallback_matches_fused(rng):
    """fused_staging_budget=0 forces the classic count->numeric path; it must
    produce the identical CSR the fused (staged) path does."""
    import dataclasses

    a = random_host_csr(rng, 60, 60, 0.2)
    fused_cfg = _TEST_CFG
    two_phase_cfg = dataclasses.replace(_TEST_CFG, fused_staging_budget=0)
    A = device_put_csr(a)
    C_f = device_get_csr(spgemm(A, A, fused_cfg))
    C_t = device_get_csr(spgemm(A, A, two_phase_cfg))
    np.testing.assert_array_equal(C_f.row_offsets, C_t.row_offsets)
    np.testing.assert_array_equal(C_f.col_ids, C_t.col_ids)
    # fused cfg may route rows through the dense path (different f32
    # accumulation order than the ESC run sums) -> small value drift
    np.testing.assert_allclose(C_f.data, C_t.data, rtol=1e-3, atol=1e-5)
    assert compare_csr(oracle_spgemm(a, a), C_t, compare_data=True,
                       rel_tol=1e-2).ok


def test_staged_plan_reexecute_consistent(rng):
    """execute() twice on the planning operands (staged emit) and once with
    explicitly passed identical operands (recompute) all agree."""
    import dataclasses
    a = random_host_csr(rng, 40, 40, 0.15)
    A = device_put_csr(a)
    # dense disabled: this test targets the ESC fused-staging path
    cfg = dataclasses.replace(_TEST_CFG, enable_dense=False)
    plan = plan_spgemm(A, A, cfg)
    assert plan.stream is not None and plan.stream.fused and \
        plan.stream.staged, "expected fused staging under the default budget"
    C1 = device_get_csr(plan.execute())
    C2 = device_get_csr(plan.execute())
    C3 = device_get_csr(plan.execute(A, A))  # bypasses staging
    np.testing.assert_array_equal(C1.col_ids, C2.col_ids)
    np.testing.assert_array_equal(C1.col_ids, C3.col_ids)
    np.testing.assert_allclose(C1.data, C3.data, rtol=1e-6)


def test_giant_row_million_products(rng):
    """One row with ~1M intermediate products exercises the huge-cap bin
    ladder (the analogue of spECK's global-memory-map fallback for rows
    exceeding shared memory, spECK_HashSpGEMM.cuh:106-126)."""
    import scipy.sparse as sp

    n = 2000
    base = sp.random(n, n, 0.02, format="csr",
                     random_state=np.random.RandomState(11))
    base.data = rng.standard_normal(base.nnz)
    lil = base.tolil()
    # a dense-ish giant row referencing ~1000 B rows (~40 nnz each on
    # average after the base density) -> ~I million products via A@A when
    # the giant row also appears as B content
    lil[0, :1000] = rng.standard_normal(1000)
    a = HostCSR.from_scipy(lil.tocsr())
    A = device_put_csr(a)
    # generous staging budget so the giant chunk still fuses
    cfg = SpgemmConfig(product_budget=1 << 14, fused_staging_budget=1 << 23)
    C = device_get_csr(spgemm(A, A, cfg))
    ref = oracle_spgemm(a, a)
    assert compare_csr(ref, C).ok
    assert compare_csr(ref, C, compare_data=True, rel_tol=1e-2).ok


def test_rap_galerkin_chain(rng):
    """AMG-style Galerkin triple product R@A@P via two chained spgemms
    (BASELINE config 4): rectangular operands, plan-reuse friendly."""
    import scipy.sparse as sp

    n_f, n_c = 120, 40
    A = sp.random(n_f, n_f, 0.08, format="csr",
                  random_state=np.random.RandomState(3))
    A.data = rng.standard_normal(A.nnz)
    # piecewise-constant prolongation: each fine row -> one coarse column
    P = sp.csr_matrix(
        (np.ones(n_f), (np.arange(n_f), rng.integers(0, n_c, n_f))),
        shape=(n_f, n_c),
    )
    R = P.T.tocsr()
    ah, ph, rh = (HostCSR.from_scipy(x) for x in (A, P, R))
    Ad, Pd, Rd = (device_put_csr(x) for x in (ah, ph, rh))
    AP = spgemm(Ad, Pd, _TEST_CFG)
    RAP = device_get_csr(spgemm(Rd, AP, _TEST_CFG))
    ref = oracle_spgemm(rh, device_get_csr(AP))
    assert compare_csr(ref, RAP, compare_data=True, rel_tol=1e-2).ok
    # sanity against scipy's full chain structure-wise
    full = (R @ A @ P).tocsr()
    assert RAP.shape == full.shape


def test_spgemm_scipy_convenience(rng):
    """spgemm_scipy: scipy in, scipy out, structure + values match the
    host product."""
    import scipy.sparse as sp
    import speck_tpu as st

    a = sp.random(200, 150, 0.06, format="csr",
                  random_state=np.random.RandomState(31))
    a.data = rng.standard_normal(a.nnz)
    b = sp.random(150, 180, 0.06, format="csr",
                  random_state=np.random.RandomState(32))
    b.data = rng.standard_normal(b.nnz)
    c = st.spgemm_scipy(a, b)
    ref = (a @ b).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(c.indptr, ref.indptr)
    np.testing.assert_array_equal(c.indices, ref.indices)
    np.testing.assert_allclose(c.data, ref.data, rtol=1e-4, atol=1e-6)


def test_auto_row_blocking_overflow(rng):
    """Calls whose product total exceeds block_products split into row
    blocks transparently inside spgemm(); plan_spgemm alone raises
    ProductOverflow (the int32 stream-position ceiling, which replaces
    the reference's hard 2^27 dimension limit, Multiply.cu:57-66)."""
    from speck_tpu import ProductOverflow

    a = random_host_csr(rng, 300, 300, 0.03)
    ref = oracle_spgemm(a, a)
    A = device_put_csr(a)
    # ~19k products; a tiny budget forces several blocks
    cfg = SpgemmConfig(product_budget=1 << 14, block_products=3000)
    with pytest.raises(ProductOverflow):
        plan_spgemm(A, A, cfg)
    C = device_get_csr(spgemm(A, A, cfg))
    r = compare_csr(ref, C, compare_data=True, rel_tol=2e-3)
    assert r.ok, r.message


def test_auto_row_blocking_single_wide_row(rng):
    """A single row wider than the per-block budget cannot be split by
    rows: the blocked path reports it instead of looping."""
    from speck_tpu import ProductOverflow

    a = random_host_csr(rng, 64, 64, 0.1)
    A = device_put_csr(a)
    cfg = SpgemmConfig(product_budget=1 << 14, block_products=16)
    with pytest.raises(ProductOverflow):
        spgemm(A, A, cfg)
