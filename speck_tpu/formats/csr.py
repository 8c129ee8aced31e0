"""Host-side sparse containers: COO and CSR over numpy arrays.

Parity with the reference's host containers:
  - COO container + alloc: /root/reference/source/COO.cpp:40-50
  - CSR container + alloc: /root/reference/source/CSR.cpp:76-87
  - sort-based COO->CSR convert: /root/reference/source/CSR.cpp:173-212
  - Welford row statistics: /root/reference/include/CSR.h:25-56
  - host spmv: /root/reference/source/CSR.cpp:139-171

Design notes: these are plain numpy structs used on the host for
IO, validation, and as the source for device uploads. Duplicate (row, col)
entries are *kept*, matching the reference convert() which sorts but does not
deduplicate; SpGEMM sums duplicate contributions, as does the scipy oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class HostCOO:
    """Coordinate-format sparse matrix (host). Mirrors COO<T> (include/COO.h)."""

    rows: int
    cols: int
    row_ids: np.ndarray  # uint32/int64 (nnz,)
    col_ids: np.ndarray  # (nnz,)
    data: np.ndarray     # (nnz,) float32/float64

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass
class HostCSR:
    """Compressed-sparse-row matrix (host). Mirrors CSR<T> (include/CSR.h:15-91)."""

    rows: int
    cols: int
    row_offsets: np.ndarray  # (rows+1,) monotone, row_offsets[-1] == nnz
    col_ids: np.ndarray      # (nnz,)
    data: np.ndarray         # (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_offsets)

    def row_statistics(self):
        """Row-length statistics. Mirrors CSR<T>::computeStatistics
        (/root/reference/include/CSR.h:25-56, Welford variance)."""
        lengths = self.row_lengths().astype(np.float64)
        count = lengths.shape[0]
        mean = float(lengths.mean()) if count else 0.0
        if count < 2:
            std_dev = 0.0
        else:
            std_dev = float(lengths.std(ddof=1))
        mx = int(lengths.max()) if count else 0
        mn = int(lengths.min()) if count else self.cols
        return {"mean": mean, "std_dev": std_dev, "max": mx, "min": mn}

    def spmv(self, v: np.ndarray, transpose: bool = False) -> np.ndarray:
        """Host sparse matrix-vector product. Mirrors spmv
        (/root/reference/source/CSR.cpp:139-171)."""
        if transpose:
            out = np.zeros(self.cols, dtype=self.data.dtype)
            # y[col] += data * v[row]
            rows = np.repeat(np.arange(self.rows), self.row_lengths())
            np.add.at(out, self.col_ids, self.data * v[rows])
            return out
        rows = np.repeat(np.arange(self.rows), self.row_lengths())
        out = np.zeros(self.rows, dtype=self.data.dtype)
        np.add.at(out, rows, self.data * v[self.col_ids])
        return out

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.col_ids, self.row_offsets), shape=self.shape
        )

    @staticmethod
    def from_scipy(m) -> "HostCSR":
        m = m.tocsr()
        return HostCSR(
            rows=int(m.shape[0]),
            cols=int(m.shape[1]),
            row_offsets=np.asarray(m.indptr, dtype=np.uint32),
            col_ids=np.asarray(m.indices, dtype=np.uint32),
            data=np.asarray(m.data),
        )

    def sorted_within_rows(self) -> "HostCSR":
        """Return a copy with column ids sorted ascending within each row
        (duplicates kept, stable)."""
        order = np.lexsort(
            (self.col_ids, np.repeat(np.arange(self.rows), self.row_lengths()))
        )
        return HostCSR(
            rows=self.rows,
            cols=self.cols,
            row_offsets=self.row_offsets.copy(),
            col_ids=self.col_ids[order],
            data=self.data[order],
        )


def coo_to_csr(coo: HostCOO) -> HostCSR:
    """Sort-based COO->CSR conversion, duplicates kept.

    Mirrors convert(CSR&, const COO&) /root/reference/source/CSR.cpp:173-212
    (std::sort by (row, col), then counting row offsets). The hot path is
    the native C++ counting-sort converter (O(nnz) by row + threaded
    within-row column sorts); numpy lexsort is the fallback."""
    from ..native import coo_to_csr_native

    native = coo_to_csr_native(coo.row_ids, coo.col_ids, coo.data, coo.rows)
    if native is not None:
        offsets, cols, vals = native
        return HostCSR(rows=coo.rows, cols=coo.cols, row_offsets=offsets,
                       col_ids=cols, data=vals)
    order = np.lexsort((coo.col_ids, coo.row_ids))
    row_ids = coo.row_ids[order]
    counts = np.bincount(row_ids, minlength=coo.rows).astype(np.uint32)
    row_offsets = np.zeros(coo.rows + 1, dtype=np.uint32)
    np.cumsum(counts, out=row_offsets[1:])
    return HostCSR(
        rows=coo.rows,
        cols=coo.cols,
        row_offsets=row_offsets,
        col_ids=coo.col_ids[order].astype(np.uint32),
        data=coo.data[order],
    )


def csr_transpose(a: HostCSR) -> HostCSR:
    """Host CSR transpose (counting sort by column).

    Replaces the reference's cuSPARSE csr2csc transpose used by DataLoader
    (/root/reference/source/DataLoader.cpp:65-74) and the standalone 3-kernel
    Transpose (/root/reference/source/GPU/Transpose.cu:10-118)."""
    counts = np.bincount(a.col_ids, minlength=a.cols).astype(np.int64)
    out_offsets = np.zeros(a.cols + 1, dtype=np.int64)
    np.cumsum(counts, out=out_offsets[1:])
    rows = np.repeat(np.arange(a.rows, dtype=np.int64), a.row_lengths())
    # stable counting-sort placement: order by (col, then original position)
    order = np.argsort(a.col_ids, kind="stable")
    return HostCSR(
        rows=a.cols,
        cols=a.rows,
        row_offsets=out_offsets.astype(np.uint32),
        col_ids=rows[order].astype(np.uint32),
        data=a.data[order],
    )
