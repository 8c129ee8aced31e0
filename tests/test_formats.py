"""Formats layer: .mtx parsing, .hicsr cache, COO->CSR, transpose."""

import os
import struct

import numpy as np
import pytest

from speck_tpu.formats.csr import HostCOO, HostCSR, coo_to_csr, csr_transpose
from speck_tpu.formats.hicsr import load_hicsr, store_hicsr, MAGIC
from speck_tpu.formats.loader import DataLoader, load_matrix
from speck_tpu.formats.mtx import load_mtx, store_mtx


GENERAL_MTX = """%%MatrixMarket matrix coordinate real general
% a comment
3 4 5
1 1 1.5
1 3 -2.0
2 2 4.0
3 4 0.5
3 1 3.0
"""

SYMMETRIC_MTX = """%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 2.0
2 1 -1.0
3 2 5.0
3 3 1.0
"""

PATTERN_MTX = """%%MatrixMarket matrix coordinate pattern symmetric
3 3 3
1 1
2 1
3 2
"""

COMPLEX_MTX = """%%MatrixMarket matrix coordinate complex general
2 2 2
1 1 3.0 4.0
2 2 -1.0 0.5
"""


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("use_native", [False, True])
def test_general_mtx(tmp_path, use_native):
    path = _write(tmp_path, "g.mtx", GENERAL_MTX)
    coo = load_mtx(path, use_native=use_native)
    assert (coo.rows, coo.cols, coo.nnz) == (3, 4, 5)
    csr = coo_to_csr(coo)
    dense = csr.to_scipy().toarray()
    expect = np.zeros((3, 4))
    expect[0, 0], expect[0, 2], expect[1, 1], expect[2, 3], expect[2, 0] = (
        1.5, -2.0, 4.0, 0.5, 3.0,
    )
    np.testing.assert_array_equal(dense, expect)


@pytest.mark.parametrize("use_native", [False, True])
def test_symmetric_expansion(tmp_path, use_native):
    path = _write(tmp_path, "s.mtx", SYMMETRIC_MTX)
    coo = load_mtx(path, use_native=use_native)
    # 4 entries, 2 off-diagonal -> 6 after mirroring (COO.cpp:148-159)
    assert coo.nnz == 6
    dense = coo_to_csr(coo).to_scipy().toarray()
    np.testing.assert_array_equal(dense, dense.T)
    assert dense[0, 1] == -1.0 and dense[1, 0] == -1.0


@pytest.mark.parametrize("use_native", [False, True])
def test_pattern_mtx(tmp_path, use_native):
    path = _write(tmp_path, "p.mtx", PATTERN_MTX)
    coo = load_mtx(path, use_native=use_native)
    assert coo.nnz == 5  # 3 entries, 2 off-diag mirrored
    assert (coo.data == 1.0).all()


@pytest.mark.parametrize("use_native", [False, True])
def test_complex_mtx_keeps_real_part(tmp_path, use_native):
    path = _write(tmp_path, "c.mtx", COMPLEX_MTX)
    coo = load_mtx(path, use_native=use_native)
    np.testing.assert_array_equal(np.sort(coo.data), [-1.0, 3.0])


def test_mtx_rejects_bad_headers(tmp_path):
    bad1 = _write(tmp_path, "b1.mtx", "%%MatrixMarket matrix array real general\n1 1\n1.0\n")
    with pytest.raises(ValueError):
        load_mtx(bad1, use_native=False)
    bad2 = _write(
        tmp_path, "b2.mtx",
        "%%MatrixMarket matrix coordinate real skew-symmetric\n1 1 1\n1 1 1.0\n",
    )
    with pytest.raises(ValueError):
        load_mtx(bad2, use_native=False)


def test_mtx_out_of_range(tmp_path):
    bad = _write(
        tmp_path, "oob.mtx",
        "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
    )
    with pytest.raises(ValueError):
        load_mtx(bad, use_native=False)


def test_duplicates_kept(tmp_path):
    text = "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n1 1 2.0\n2 2 3.0\n"
    coo = load_mtx(_write(tmp_path, "d.mtx", text), use_native=False)
    assert coo.nnz == 3  # convert() keeps duplicates (CSR.cpp:173-212)
    csr = coo_to_csr(coo)
    assert csr.nnz == 3
    assert list(csr.col_ids[:2]) == [0, 0]


def test_hicsr_roundtrip(tmp_path, rng):
    from conftest import random_host_csr

    for dtype in (np.float64, np.float32):
        m = random_host_csr(rng, 17, 23, 0.2, dtype=dtype)
        p = str(tmp_path / f"m_{np.dtype(dtype).name}.hicsr")
        store_hicsr(p, m)
        back = load_hicsr(p, dtype=dtype)
        assert (back.rows, back.cols, back.nnz) == (m.rows, m.cols, m.nnz)
        np.testing.assert_array_equal(back.row_offsets, m.row_offsets)
        np.testing.assert_array_equal(back.col_ids, m.col_ids)
        np.testing.assert_array_equal(back.data, m.data)


def test_hicsr_binary_layout(tmp_path):
    """Byte-level compatibility with CSRIOHeader (CSR.cpp:27-73)."""
    m = HostCSR(
        rows=2, cols=3,
        row_offsets=np.array([0, 1, 2], np.uint32),
        col_ids=np.array([2, 0], np.uint32),
        data=np.array([1.25, -2.5], np.float64),
    )
    p = str(tmp_path / "layout.hicsr")
    store_hicsr(p, m)
    raw = open(p, "rb").read()
    assert raw[:9] == MAGIC
    ts, cdir, isz, foff, osz, nr, nc, nnz = struct.unpack("<8Q", raw[16:80])
    assert (ts, cdir, isz, foff, osz) == (8, 0, 4, 0, 4)
    assert (nr, nc, nnz) == (2, 3, 2)
    # State<double> = 16 bytes: scaling=1.0 then transpose=false
    assert struct.unpack("<d", raw[80:88])[0] == 1.0
    data = np.frombuffer(raw[96:112], dtype=np.float64)
    np.testing.assert_array_equal(data, [1.25, -2.5])
    cols = np.frombuffer(raw[112:120], dtype=np.uint32)
    np.testing.assert_array_equal(cols, [2, 0])
    offs = np.frombuffer(raw[120:132], dtype=np.uint32)
    np.testing.assert_array_equal(offs, [0, 1, 2])


def test_hicsr_type_mismatch(tmp_path, rng):
    from conftest import random_host_csr

    m = random_host_csr(rng, 5, 5, 0.3, dtype=np.float64)
    p = str(tmp_path / "t.hicsr")
    store_hicsr(p, m)
    with pytest.raises(ValueError):
        load_hicsr(p, dtype=np.float32)


def test_loader_cache_and_transpose_rule(tmp_path, rng):
    # square: B = A; cache written next to the file with the d_ extension
    path = _write(tmp_path, "sq.mtx", SYMMETRIC_MTX)
    dl = DataLoader(path, dtype=np.float64)
    assert dl.cpuB is dl.cpuA
    assert (tmp_path / "sq.mtxd_.hicsr").exists()
    # cache hit path returns the same matrix
    again = load_matrix(path, dtype=np.float64)
    np.testing.assert_array_equal(again.col_ids, dl.cpuA.col_ids)

    # rectangular: B = A^T (DataLoader.cpp:65-74)
    rect = _write(tmp_path, "r.mtx", GENERAL_MTX)
    dlr = DataLoader(rect, dtype=np.float64)
    assert dlr.cpuB.shape == (4, 3)
    np.testing.assert_array_equal(
        dlr.cpuB.to_scipy().toarray(), dlr.cpuA.to_scipy().toarray().T
    )


def test_loader_stale_cache_rejected(tmp_path):
    """A rewritten .mtx must not serve yesterday's cache (stale-cache
    guard on mtimes; the reference trusts any existing cache,
    DataLoader.cpp:26-59 — this is a deliberate improvement)."""
    import os

    path = _write(tmp_path, "sq.mtx", SYMMETRIC_MTX)
    first = load_matrix(path, dtype=np.float64)
    cache = str(tmp_path / "sq.mtxd_.hicsr")
    assert os.path.exists(cache)
    # rewrite the source with different content, newer than the cache
    _write(
        tmp_path, "sq.mtx",
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 2\n1 1 7.0\n2 2 8.0\n",
    )
    os.utime(path, (os.path.getmtime(cache) + 10,) * 2)
    again = load_matrix(path, dtype=np.float64)
    assert again.nnz == 2 and first.nnz != 2
    np.testing.assert_array_equal(again.data, [7.0, 8.0])
    # and the refreshed cache now serves the new matrix
    os.utime(cache, (os.path.getmtime(path) + 10,) * 2)
    cached = load_matrix(path, dtype=np.float64)
    np.testing.assert_array_equal(cached.data, [7.0, 8.0])


def test_transpose_roundtrip(rng):
    from conftest import random_host_csr

    a = random_host_csr(rng, 31, 17, 0.15)
    at = csr_transpose(a)
    np.testing.assert_allclose(at.to_scipy().toarray(), a.to_scipy().toarray().T)
    # transpose output has sorted columns within rows
    att = csr_transpose(at)
    np.testing.assert_allclose(att.to_scipy().toarray(), a.to_scipy().toarray())


def test_row_statistics(rng):
    a = HostCSR(
        rows=3, cols=5,
        row_offsets=np.array([0, 2, 2, 5], np.uint32),
        col_ids=np.array([0, 1, 0, 2, 4], np.uint32),
        data=np.ones(5),
    )
    st = a.row_statistics()
    assert st["max"] == 3 and st["min"] == 0
    np.testing.assert_allclose(st["mean"], 5 / 3)


def test_spmv(rng):
    from conftest import random_host_csr

    a = random_host_csr(rng, 12, 9, 0.3)
    v = rng.standard_normal(9)
    np.testing.assert_allclose(a.spmv(v), a.to_scipy() @ v, rtol=1e-12)
    w = rng.standard_normal(12)
    np.testing.assert_allclose(
        a.spmv(w, transpose=True), a.to_scipy().T @ w, rtol=1e-12
    )


def test_store_mtx_roundtrip(tmp_path, rng):
    from conftest import random_host_csr

    a = random_host_csr(rng, 8, 6, 0.3)
    coo = a.to_scipy().tocoo()
    h = HostCOO(8, 6, coo.row.astype(np.uint32), coo.col.astype(np.uint32), coo.data)
    p = str(tmp_path / "rt.mtx")
    store_mtx(p, h)
    back = coo_to_csr(load_mtx(p, use_native=False))
    np.testing.assert_allclose(back.to_scipy().toarray(), a.to_scipy().toarray())


def test_device_transpose(rng):
    from conftest import random_host_csr
    from speck_tpu.ops.device_csr import device_get_csr, device_put_csr
    from speck_tpu.ops.transpose import transpose

    a = random_host_csr(rng, 37, 53, 0.15)
    A = device_put_csr(a, dtype="float32")
    T = device_get_csr(transpose(A))
    ref = a.to_scipy().T.tocsr()
    ref.sort_indices()
    import numpy as np
    np.testing.assert_array_equal(T.row_offsets, ref.indptr)
    np.testing.assert_array_equal(T.col_ids, ref.indices)
    np.testing.assert_allclose(T.data, ref.data, rtol=1e-6)
    assert transpose(A).canonical


def test_device_transpose_empty():
    import numpy as np
    from speck_tpu.formats.csr import HostCSR
    from speck_tpu.ops.device_csr import device_get_csr, device_put_csr
    from speck_tpu.ops.transpose import transpose

    a = HostCSR(rows=4, cols=6, row_offsets=np.zeros(5, np.int64),
                col_ids=np.zeros(0, np.int64), data=np.zeros(0))
    T = device_get_csr(transpose(device_put_csr(a)))
    assert T.shape == (6, 4) and T.nnz == 0


def test_device_info():
    from speck_tpu.utils.device import device_info

    info = device_info()
    assert info.num_devices >= 1
    assert isinstance(info.summary(), str)


def test_native_coo_to_csr_matches_lexsort(rng):
    """The native counting-sort converter (speck_native.cpp
    speck_coo_to_csr) must be element-identical to the numpy lexsort
    fallback: stable within (row, col) so duplicates keep file order."""
    from speck_tpu.native import coo_to_csr_native

    m, n, nnz = 50, 40, 600
    rows = rng.integers(0, m, nnz).astype(np.uint32)
    cols = rng.integers(0, n, nnz).astype(np.uint32)  # duplicates likely
    for dtype in (np.float64, np.float32):
        vals = rng.standard_normal(nnz).astype(dtype)
        native = coo_to_csr_native(rows, cols, vals, m)
        if native is None:
            pytest.skip("native library unavailable")
        # fallback: the numpy path coo_to_csr would take
        order = np.lexsort((cols, rows))
        counts = np.bincount(rows, minlength=m)
        exp_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
        offsets, c_out, v_out = native
        np.testing.assert_array_equal(offsets, exp_off)
        np.testing.assert_array_equal(c_out, cols[order])
        np.testing.assert_array_equal(v_out, vals[order])
        assert v_out.dtype == dtype


def test_native_coo_to_csr_rejects_bad_row():
    from speck_tpu.native import coo_to_csr_native

    rows = np.array([0, 5], np.uint32)   # row 5 out of bounds for m=3
    cols = np.array([0, 1], np.uint32)
    vals = np.ones(2, np.float64)
    try:
        got = coo_to_csr_native(rows, cols, vals, 3)
    except ValueError:
        return
    if got is None:
        pytest.skip("native library unavailable")
    raise AssertionError("out-of-bounds row id must raise")


def test_native_mtx_writer_chunked(tmp_path, rng):
    """mtx_write_native streams the body through one reused buffer; a
    chunk smaller than nnz must produce the identical file."""
    from speck_tpu.native import mtx_write_native

    nnz = 37
    rows = rng.integers(0, 9, nnz).astype(np.uint32)
    cols = rng.integers(0, 7, nnz).astype(np.uint32)
    vals = rng.standard_normal(nnz)
    p1, p2 = str(tmp_path / "one.mtx"), str(tmp_path / "many.mtx")
    with open(p1, "wb") as fh:
        ok1 = mtx_write_native(fh, rows, cols, vals, "real")
    with open(p2, "wb") as fh:
        ok2 = mtx_write_native(fh, rows, cols, vals, "real", chunk=8)
    if not (ok1 and ok2):
        pytest.skip("native library unavailable")
    assert open(p1, "rb").read() == open(p2, "rb").read()
    # and the body round-trips exactly (%.17g)
    h = HostCOO(9, 7, rows, cols, vals)
    p3 = str(tmp_path / "full.mtx")
    store_mtx(p3, h)
    back = load_mtx(p3, use_native=False)
    order = np.lexsort((back.col_ids, back.row_ids))
    oin = np.lexsort((cols, rows))
    np.testing.assert_array_equal(back.row_ids[order], rows[oin])
    np.testing.assert_array_equal(back.data[order], vals[oin])


def test_native_lib_built_into_ignored_dir(tmp_path, rng):
    """The native library is built from source into native/_build (which
    .gitignore lists), named by a hash of the source, and its parser
    agrees with the numpy fallback on a random general matrix."""
    import subprocess

    from speck_tpu import native
    from speck_tpu.formats.csr import HostCOO
    from speck_tpu.formats.mtx import store_mtx

    assert native.get_lib() is not None, "g++ build of speck_native failed"
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.exists(path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", path], cwd=repo).returncode
    assert ignored == 0, f"{path} is not git-ignored"

    m, n, nnz = 300, 200, 4000
    coo = HostCOO(m, n, rng.integers(0, m, nnz).astype(np.uint32),
                  rng.integers(0, n, nnz).astype(np.uint32),
                  rng.standard_normal(nnz))
    p = str(tmp_path / "r.mtx")
    store_mtx(p, coo)
    fast = load_mtx(p, use_native=True)
    slow = load_mtx(p, use_native=False)
    for f in ("row_ids", "col_ids"):
        np.testing.assert_array_equal(getattr(fast, f), getattr(slow, f))
    np.testing.assert_array_equal(fast.data, slow.data)
