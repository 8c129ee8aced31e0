"""Device CSR transpose.

Parity with the reference's standalone 3-kernel CSR transpose
(/root/reference/source/GPU/Transpose.cu:10-118 — count, position, write):
here the same job is one sort by (column, row) plus a column histogram.
The count kernel becomes a scatter-add histogram, the position scan a
blocked cumsum, and the write pass falls out of the sort order directly.

Used by rectangular A·Aᵀ setups when the operand already lives on device
(the host loader uses formats.csr.csr_transpose, matching DataLoader's
cuSPARSE-transpose branch, source/DataLoader.cpp:65-74).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .analysis import cumsum1d
from .device_csr import DeviceCSR


@partial(jax.jit, static_argnames=("m", "n"))
def _transpose_impl(indptr, indices, data, m: int, n: int):
    nnz = indices.shape[0]
    # run-length decode row ids from indptr (marker scatter + blocked cumsum)
    rowids = jnp.zeros((nnz,), jnp.int32).at[indptr[1:-1]].add(
        1, mode="drop"
    )
    rowids = cumsum1d(rowids)
    # global order of A^T = ascending (col, row); two-key sort carries data
    cols_s, rows_s, data_s = jax.lax.sort(
        (indices, rowids, data), dimension=0, num_keys=2
    )
    counts = jnp.zeros((n,), jnp.int32).at[indices].add(1)
    t_indptr = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), cumsum1d(counts)]
    )
    return t_indptr, rows_s, data_s


def transpose(A: DeviceCSR) -> DeviceCSR:
    """Aᵀ as a device CSR. Canonical input yields canonical output.

    Note: the global two-key sort runs over the flat nnz axis — fine
    for setup-time use (the reference likewise transposes once at load,
    DataLoader.cpp:65-74), not for inner loops.
    """
    if A.shape[0] == 0 or A.nnz == 0:
        m, n = A.shape
        return DeviceCSR(
            indptr=jnp.zeros((n + 1,), jnp.int32),
            indices=jnp.zeros((0,), jnp.int32),
            data=jnp.zeros((0,), A.data.dtype),
            shape=(n, m), nnz=0, canonical=True,
        )
    m, n = A.shape
    t_indptr, t_indices, t_data = _transpose_impl(
        A.indptr, A.indices, A.data, m, n
    )
    return DeviceCSR(
        indptr=t_indptr, indices=t_indices, data=t_data,
        shape=(n, m), nnz=A.nnz, canonical=A.canonical,
    )
