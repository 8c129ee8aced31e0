"""True multi-process (multi-controller) execution of multihost_spgemm.

The reference is single-GPU/single-process (SURVEY.md §2.2); the
multi-host layer is new design per BASELINE.json. Everything else in the
suite exercises the SPMD path under ONE controller (8 virtual devices);
this test spawns TWO real OS processes that each initialize
jax.distributed, form a global 4-device CPU mesh (2 local devices per
process), and run the full multihost_spgemm flow — addressable-shard
assembly on the way in, cross-host all-gather on the way out — against
the scipy oracle.
"""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
from speck_tpu.parallel.multihost import initialize, multihost_spgemm
initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

import numpy as np, scipy.sparse as sp
from speck_tpu.formats.csr import HostCSR
from speck_tpu.parallel.mesh_stream import mesh_stream_to_host_csr
from speck_tpu.utils.oracle import oracle_spgemm
from speck_tpu.utils.compare import compare_csr

rs = np.random.RandomState(42)
m = 96
lens = np.minimum((rs.pareto(1.5, m) + 1) * 3, 24).astype(np.int64)
rows = np.repeat(np.arange(m), lens)
cols = rs.randint(0, m, rows.shape[0])
A = sp.csr_matrix((rs.standard_normal(rows.shape[0]), (rows, cols)),
                  shape=(m, m))
A.sum_duplicates()
a = HostCSR.from_scipy(A)

ref = oracle_spgemm(a, a)
for exchange in ("needset", "allgather"):
    out = multihost_spgemm(a, a, exchange=exchange)
    # the tile-bounded 96x96 input routes dense under allgather (the
    # mesh dense route, multi-controller), stream under needset
    want = "dense" if exchange == "allgather" else "stream"
    assert out[3]["route"] == want, (exchange, out[3]["route"])
    got = mesh_stream_to_host_csr(*out)
    r = compare_csr(ref, got, compare_data=True, rel_tol=1e-2)
    assert r.ok, f"p{pid} {exchange}: {r.message}"
    print(f"p{pid} {exchange} OK", flush=True)

# pre-sharded inputs: each process passes ONLY the row shards its own
# devices hold (round-4: no process needs the full A/B payloads; the
# need-set plan is computed on device, host metadata via allgather)
from speck_tpu.parallel.mesh_stream import RowShards
from speck_tpu.parallel.multihost import global_row_mesh
mesh = global_row_mesh()
D = mesh.devices.size
full = RowShards.from_global(a, D)
owned = {i for i, dev in enumerate(mesh.devices.flat)
         if dev.process_index == jax.process_index()}
assert len(owned) == 2, owned
ash = RowShards.from_local(a.rows, a.cols, D,
                           {d: full.local[d] for d in owned})
out = multihost_spgemm(ash, ash, exchange="needset")
got = mesh_stream_to_host_csr(*out)
r = compare_csr(ref, got, compare_data=True, rel_tol=1e-2)
assert r.ok, f"p{pid} presharded: {r.message}"
print(f"p{pid} presharded OK", flush=True)
print(f"p{pid} DONE", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_multihost_spgemm(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", str(worker), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=840)
            outs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"p{pid} needset OK" in out, out
        assert f"p{pid} allgather OK" in out, out
        assert f"p{pid} presharded OK" in out, out
        assert f"p{pid} DONE" in out, out
