"""Device-resident CSR container (JAX arrays).

Parity with dCSR (/root/reference/include/dCSR.h:9-22,
source/dCSR.cpp:25-95): raw device buffers (row_offsets, col_ids, data) plus
host<->device converters. The device representation uses int32 indices
and jnp arrays; ``shape``/``nnz`` are static pytree metadata so DeviceCSR can
flow through jit.

Index dtype is int32 (nnz < 2^31 per shard); the reference is limited to
2^27 rows/cols by its packed hash entries (Multiply.cu:57-66) — we lift that
to 2^31 - 1.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import HostCSR


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    indptr: jax.Array   # (rows+1,) int32
    indices: jax.Array  # (nnz,)   int32
    data: jax.Array     # (nnz,)   float
    shape: Tuple[int, int]
    nnz: int
    canonical: bool = False  # columns strictly ascending within each row

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype


jax.tree_util.register_dataclass(
    DeviceCSR,
    data_fields=["indptr", "indices", "data"],
    meta_fields=["shape", "nnz", "canonical"],
)


# Host-structure side table: device_put_csr keeps the source HostCSR
# reachable from its DeviceCSR so planning can run the analysis pass and
# the routing gate on host numpy with ZERO device syncs
# (ops/analysis.host_analyze). A side table (not a dataclass field) keeps
# DeviceCSR a clean pytree — numpy payloads in meta fields would poison
# jit cache keys. Entries evict when the DeviceCSR is collected.
_HOST_SIDE: dict = {}


def attach_host(d: DeviceCSR, h: HostCSR) -> None:
    _HOST_SIDE[id(d)] = h
    weakref.finalize(d, _HOST_SIDE.pop, id(d), None)


def host_of(d: DeviceCSR) -> Optional[HostCSR]:
    """The HostCSR ``d`` was uploaded from, if it is still attached
    (device-born matrices — e.g. a previous spgemm's output — have
    none)."""
    return _HOST_SIDE.get(id(d))


def is_canonical_host(row_offsets, col_ids) -> bool:
    """True if columns are strictly ascending within every row (sorted and
    duplicate-free). Enables the direct-copy fast path."""
    col_ids = np.asarray(col_ids, np.int64)
    if col_ids.shape[0] < 2:
        return True
    nondesc = col_ids[1:] > col_ids[:-1]
    # positions where a new row starts are allowed to descend
    starts = np.asarray(row_offsets[1:-1], np.int64)
    nondesc[starts[(starts > 0) & (starts < col_ids.shape[0])] - 1] = True
    return bool(nondesc.all())


def device_put_csr(m: HostCSR, dtype=jnp.float32, device=None,
                   check_canonical: bool = True) -> DeviceCSR:
    """Upload a HostCSR to device (convert(dCSR&, CSR&), dCSR.cpp:50-65)."""
    put = lambda x: jax.device_put(x, device) if device is not None else jnp.asarray(x)
    d = DeviceCSR(
        indptr=put(np.asarray(m.row_offsets, dtype=np.int32)),
        indices=put(np.asarray(m.col_ids, dtype=np.int32)),
        data=put(np.asarray(m.data, dtype=dtype)),
        shape=(int(m.rows), int(m.cols)),
        nnz=int(m.nnz),
        canonical=is_canonical_host(m.row_offsets, m.col_ids) if check_canonical else False,
    )
    attach_host(d, m)
    return d


def device_get_csr(m: DeviceCSR) -> HostCSR:
    """Download a DeviceCSR to host (convert(CSR&, dCSR&), dCSR.cpp:68-77)."""
    return HostCSR(
        rows=m.shape[0],
        cols=m.shape[1],
        row_offsets=np.asarray(m.indptr),
        col_ids=np.asarray(m.indices)[: m.nnz],
        data=np.asarray(m.data)[: m.nnz],
    )
