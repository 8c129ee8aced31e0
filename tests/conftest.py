"""Test configuration: run everything on CPU with 8 virtual devices so
multi-device sharding logic is testable without several GPUs (SURVEY.md
§4)."""

import os

# Must be decided before the first backend initialization; jax resolves
# platforms lazily at first use.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent compile cache: DISABLED for tests. XLA:CPU executable
# deserialization segfaulted reproducibly in cache READ: the AOT entries
# embed the compiling machine's CPU features, and test hosts differ
# between runs. Opt back in with SPECK_TEST_CACHE=/path.
_cache_dir = os.environ.get("SPECK_TEST_CACHE", "")
if _cache_dir:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound compile-cache growth across the suite: the XLA:CPU compiler
    has been observed to segfault late in a full run (backend_compile on
    the ~119th test) once ~a hundred tests' executables accumulate;
    per-module clearing keeps the process footprint flat. Recompiles
    within a module are unaffected."""
    yield
    jax.clear_caches()


@pytest.fixture()
def rng(request):
    # per-test deterministic stream: order-independent, reproducible
    import zlib

    seed = zlib.crc32(request.node.nodeid.encode())
    return np.random.default_rng([20260816, seed])


def random_host_csr(rng, m, n, density, dtype=np.float64, empty_row_frac=0.0):
    """Random CSR with optional forced-empty rows and duplicate tolerance."""
    import scipy.sparse as sp

    mat = sp.random(m, n, density, format="csr", random_state=np.random.RandomState(int(rng.integers(1 << 31))), dtype=np.float64)
    mat.data = (rng.standard_normal(mat.nnz) + 0.5).astype(np.float64)
    if empty_row_frac > 0 and m > 0:
        kill = rng.random(m) < empty_row_frac
        keep_mask = ~np.repeat(kill, np.diff(mat.indptr))
        coo = mat.tocoo()
        mat = sp.csr_matrix(
            (coo.data[keep_mask], (coo.row[keep_mask], coo.col[keep_mask])),
            shape=(m, n),
        )
    from speck_tpu.formats.csr import HostCSR

    out = HostCSR.from_scipy(mat)
    out.data = out.data.astype(dtype)
    return out
