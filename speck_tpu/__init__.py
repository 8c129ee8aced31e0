"""speck_tpu — a JAX SpGEMM (sparse general matrix-matrix multiply) library.

Computes C = A @ B for CSR sparse matrices on a GPU via JAX/XLA, with the
capabilities of the reference CUDA library GPUPeople/spECK (PPoPP'20):
a lightweight analysis pass routes rows between diagonal-plane paths, a
dense-window matmul path, a
direct-copy path, and a tightly packed flat product stream (sort-based
expand/contract with merge levels for giant rows), producing exact symbolic
counts and numeric accumulation into exactly-sized, per-row-sorted CSR output.

Reference entry point parity: ``spECK::MultiplyspECK`` at
/root/reference/include/Multiply.h:15-19 -> :func:`speck_tpu.spgemm`.
"""

from .formats.csr import HostCSR, HostCOO, coo_to_csr, csr_transpose
from .formats.mtx import load_mtx
from .formats.hicsr import load_hicsr, store_hicsr
from .formats.loader import DataLoader, load_matrix
from .ops.device_csr import DeviceCSR, device_put_csr, device_get_csr
from .ops.spgemm import (ProductOverflow, spgemm, SpgemmPlan,
                         plan_spgemm)
from .ops.transpose import transpose
from .utils.config import Config, SpgemmConfig
from .utils.timings import Timings
from .utils.compare import compare_csr
from .utils.device import DeviceInfo, device_info
from .utils.oracle import oracle_spgemm

__version__ = "0.1.0"


def spgemm_scipy(a, b, dtype=None, cfg=None):
    """One-call convenience: scipy.sparse in, scipy.sparse csr out.

    Runs the full device pipeline (analysis -> routing -> count ->
    numeric) and returns ``(a @ b)`` as a ``scipy.sparse.csr_matrix``
    with sorted, deduplicated rows. ``dtype`` defaults to float32 (packed
    8-byte B records); pass numpy.float64 with jax_enable_x64 for the
    double path."""
    import numpy as _np

    dtype = dtype or _np.float32
    ah = HostCSR.from_scipy(a.tocsr())
    bh = HostCSR.from_scipy(b.tocsr())
    A = device_put_csr(ah, dtype)
    B = device_put_csr(bh, dtype)
    return device_get_csr(spgemm(A, B, cfg)).to_scipy()

__all__ = [
    "HostCSR", "HostCOO", "coo_to_csr", "csr_transpose",
    "load_mtx", "load_hicsr", "store_hicsr", "DataLoader", "load_matrix",
    "DeviceCSR", "device_put_csr", "device_get_csr",
    "spgemm", "spgemm_scipy", "SpgemmPlan", "plan_spgemm",
    "ProductOverflow", "transpose",
    "Config", "SpgemmConfig", "Timings", "compare_csr", "oracle_spgemm",
    "DeviceInfo", "device_info",
]
