"""Native (C++) host-side fast paths.

The reference's performance-critical host code is C++ (the .mtx parser,
COO->CSR convert; SURVEY.md §2 #6-7). Here the hot loader path is a small
C++ shared library built from ``speck_native.cpp`` with g++ at first use
and bound via ctypes (no pybind11 needed). The binary is never shipped:
it is built into ``_build/`` (git-ignored) under a name carrying a hash
of the source, so a checkout never loads a library built from other
source, whatever the file times say. Everything has a numpy fallback, so
the native library is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "speck_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
_lock = threading.Lock()
_lib = None
_build_failed = False


def lib_path() -> str:
    """Where the library for the current source lives (built or not)."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libspeck_native-{tag}.so")


def _build(path: str) -> bool:
    # portable code (no -march=native): the build directory may travel
    # with a copied checkout to another host
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        # atomic publish: concurrent test workers may build at once
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not os.path.exists(_SRC):
            return None
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.speck_mtx_parse.restype = ctypes.c_longlong
        lib.speck_mtx_parse.argtypes = [
            ctypes.c_char_p,   # body text
            ctypes.c_longlong, # body length
            ctypes.c_longlong, # expected entries
            ctypes.c_int,      # values per entry (2/3/4)
            ctypes.POINTER(ctypes.c_uint),    # out rows
            ctypes.POINTER(ctypes.c_uint),    # out cols
            ctypes.POINTER(ctypes.c_double),  # out vals
        ]
        if hasattr(lib, "speck_mtx_format"):
            lib.speck_mtx_format.restype = ctypes.c_longlong
            lib.speck_mtx_format.argtypes = [
                ctypes.POINTER(ctypes.c_uint),    # rows (0-based)
                ctypes.POINTER(ctypes.c_uint),    # cols (0-based)
                ctypes.POINTER(ctypes.c_double),  # vals
                ctypes.c_longlong,                # count
                ctypes.c_int,                     # ncol (2/3)
                ctypes.c_char_p,                  # out buffer
                ctypes.c_longlong,                # out capacity
            ]
        if hasattr(lib, "speck_coo_to_csr"):
            lib.speck_coo_to_csr.restype = ctypes.c_longlong
            lib.speck_coo_to_csr.argtypes = [
                ctypes.POINTER(ctypes.c_uint),    # row ids
                ctypes.POINTER(ctypes.c_uint),    # col ids
                ctypes.c_char_p,                  # vals (opaque bytes)
                ctypes.c_longlong,                # nnz
                ctypes.c_longlong,                # rows
                ctypes.c_int,                     # value itemsize
                ctypes.POINTER(ctypes.c_uint),    # out row offsets
                ctypes.POINTER(ctypes.c_uint),    # out col ids
                ctypes.c_char_p,                  # out vals
            ]
        _lib = lib
        return _lib


def coo_to_csr_native(row_ids, col_ids, data, m: int):
    """Counting-sort COO->CSR via the native converter; returns
    (row_offsets, cols, vals) or None (caller falls back to numpy
    lexsort). O(nnz) by row + threaded within-row column sorts, vs the
    fallback's O(nnz log nnz) global lexsort."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "speck_coo_to_csr"):
        return None
    n = int(row_ids.shape[0])
    if n >= 2**32 - 1 or m >= 2**32 - 1:
        return None
    r = np.ascontiguousarray(row_ids, np.uint32)
    c = np.ascontiguousarray(col_ids, np.uint32)
    d = np.ascontiguousarray(data)
    if d.dtype.itemsize not in (4, 8) or d.dtype.hasobject:
        return None
    offsets = np.empty(m + 1, np.uint32)
    cols = np.empty(n, np.uint32)
    vals = np.empty(n, d.dtype)
    rc = lib.speck_coo_to_csr(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        d.ctypes.data_as(ctypes.c_char_p),
        n, m, int(d.dtype.itemsize),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        vals.ctypes.data_as(ctypes.c_char_p),
    )
    if rc != 0:
        raise ValueError(
            f"row index out of bounds in COO->CSR convert (rows={m})")
    return offsets, cols, vals


def mtx_write_native(fh, row_ids, col_ids, data, field: str,
                     chunk: int = 1 << 20) -> bool:
    """Write a COO body as MatrixMarket text to ``fh`` via the native
    formatter, ``chunk`` entries at a time through ONE reused buffer —
    peak transient memory is ~64 bytes * chunk (~64 MB), not 64 bytes
    per nonzero (~6 GB at the 1e8-nnz scale this path exists for).
    Returns False when the native library is unavailable (caller falls
    back to numpy formatting)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "speck_mtx_format"):
        return False
    n = int(row_ids.shape[0])
    ncol = 2 if field == "pattern" else 3
    cap = min(n, chunk) * 64 + 64
    buf = ctypes.create_string_buffer(cap)
    start = fh.tell()
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        r = np.ascontiguousarray(row_ids[lo:hi], np.uint32)
        c = np.ascontiguousarray(col_ids[lo:hi], np.uint32)
        d = np.ascontiguousarray(data[lo:hi], np.float64)
        wrote = lib.speck_mtx_format(
            r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            hi - lo, ncol, buf, cap)
        if wrote < 0:
            # leave no partial body behind the fallback formatter
            fh.seek(start)
            fh.truncate()
            return False
        # string_at copies only the written bytes (.raw would materialize
        # the whole over-allocation first)
        fh.write(ctypes.string_at(buf, int(wrote)))
    return True


def mtx_parse_native(path: str, dtype):
    """Fast .mtx parse via the native tokenizer; returns HostCOO or None."""
    from ..formats.mtx import _parse_header
    from ..formats.csr import HostCOO

    lib = get_lib()
    if lib is None:
        return None

    with open(path, "rb") as fh:
        header = fh.readline().decode("ascii", "replace")
        field, symmetry = _parse_header(header)
        # size line
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"Failed to read matrix market header from {path!r}")
            s = line.strip()
            if not s or s.startswith(b"%"):
                continue
            parts = s.split()
            num_rows, num_cols, num_nnz = int(parts[0]), int(parts[1]), int(parts[2])
            break
        body = fh.read()

    ncol = {"pattern": 2, "complex": 4}.get(field, 3)
    r = np.empty(num_nnz, dtype=np.uint32)
    c = np.empty(num_nnz, dtype=np.uint32)
    d = np.empty(num_nnz, dtype=np.float64)
    got = lib.speck_mtx_parse(
        body, len(body), num_nnz, ncol,
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != num_nnz:
        return None  # malformed body; fall back to the python parser
    if (r < 1).any() or (r > num_rows).any():
        raise ValueError(f"Row index out of bounds in matrix market file {path!r}")
    if (c < 1).any() or (c > num_cols).any():
        raise ValueError(f"Column index out of bounds in matrix market file {path!r}")
    r -= 1
    c -= 1
    if field == "pattern":
        d[:] = 1.0
    dd = d.astype(dtype) if np.dtype(dtype) != np.float64 else d
    if symmetry in ("symmetric", "hermitian"):
        off = r != c
        r, c, dd = (
            np.concatenate([r, c[off]]),
            np.concatenate([c, r[off]]),
            np.concatenate([dd, dd[off]]),
        )
    return HostCOO(rows=num_rows, cols=num_cols, row_ids=r, col_ids=c, data=dd)
