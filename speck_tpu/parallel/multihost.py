"""Multi-host (multi-controller) SpGEMM.

The reference is single-GPU/single-process (SURVEY.md section 2.2);
scaling across hosts is new design per BASELINE.json. On one host, one
process drives all of its cards through ``mesh_stream_spgemm`` over the
local mesh; this module is for several processes. Each process calls
``initialize()`` once, then every process calls ``multihost_spgemm``
with the SAME host matrices: the global mesh spans all processes'
devices, each process device_puts only the shards its local devices own
(addressable-shard assembly), and the SPMD stream step
(parallel/mesh_stream.py) runs as one jitted ``shard_map`` whose
collectives XLA schedules (NCCL between GPUs).

With one process this degenerates exactly to ``mesh_stream_spgemm`` over
the local mesh — which is how the path is exercised in CI (virtual
8-device CPU mesh) and by ``dryrun_multichip``; tests/test_multihost_mp.py
runs two CPU processes.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from ..formats.csr import HostCSR


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize JAX's distributed runtime (idempotent).

    Pass ``coordinator_address`` (e.g. ``localhost:<port>``),
    ``num_processes`` and ``process_id``: with no arguments JAX relies on
    a cluster environment's auto-detection, which a plain GPU host lacks.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized -> keep going
        if "already" not in str(e).lower():
            raise


def global_row_mesh():
    """One-axis mesh over every device in the job (all hosts)."""
    from .dist import make_row_mesh

    return make_row_mesh(devices=jax.devices())


def local_row_range(m: int):
    """The contiguous row range this host owns under an even row partition
    of an m-row matrix across processes."""
    from .dist import partition_rows

    ranges = partition_rows(m, jax.process_count())
    return ranges[jax.process_index()]


def multihost_spgemm(
    a: HostCSR,
    b: HostCSR,
    cfg=None,
    exchange: str = "needset",
):
    """C = A @ B across every device of every host in the job.

    Every process passes the same full host matrices (or identically
    sharded copies); the stream SPMD step runs over the global mesh. With
    ``jax.process_count() == 1`` this is exactly ``mesh_stream_spgemm``.

    Returns (nnz_row, cols, vals, meta) — per-shard padded outputs;
    assemble with ``mesh_stream_to_host_csr`` (each process sees the
    global logical arrays; fetching them on one process gathers the
    remote shards).
    """
    from .mesh_stream import mesh_stream_spgemm

    mesh = global_row_mesh()
    return mesh_stream_spgemm(a, b, mesh, cfg=cfg, exchange=exchange)


def scaling_efficiency(t1: float, tn: float, n_hosts: int) -> float:
    """T(1) / (T(N) * N) — the BASELINE.json multi-host metric."""
    return t1 / (tn * n_hosts) if tn > 0 and n_hosts > 0 else 0.0
