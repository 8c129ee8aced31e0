"""Benchmark executor: load, validate, warm up, measure.

Parity with Executor<T>::run (/root/reference/source/Executor.cpp:12-84):
  - config keys: IterationsWarmUp, IterationsExecution,
    TrackIndividualTimes, TrackCompleteTimes, CompareResult
    (Executor.cpp:15-29);
  - optional oracle product computed once (cuSPARSE there, scipy here,
    Executor.cpp:29-40);
  - warmup loop then measured loop, each optionally compared
    (Executor.cpp:43-72); timings averaged over the measured iterations;
  - prints matrix info, nnz(C) and mean total ms (Executor.cpp:19,77-78).

Additional derived metrics (BASELINE.md): GFLOPS = 2*sum_products/time and
nnz(C)/s.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import numpy as np

from .formats.loader import DataLoader
from .ops.device_csr import device_get_csr, device_put_csr
from .ops.spgemm import spgemm
from .utils.compare import compare_csr
from .utils.config import Config, SpgemmConfig
from .utils.oracle import oracle_spgemm
from .utils.timings import Timings


@dataclasses.dataclass
class RunResult:
    nnz: int
    mean_total_ms: float
    timings: Timings
    sum_products: float
    gflops: float
    nnz_per_s: float
    compared_ok: Optional[bool]


class Executor:
    def __init__(
        self,
        path: str,
        config: Optional[Config] = None,
        spgemm_cfg: Optional[SpgemmConfig] = None,
        dtype=np.float32,
        verbose: bool = True,
    ):
        self.path = path
        self.config = config or Config.get()
        # pipeline knobs from the INI when not given explicitly (the
        # reference declares tuning keys it never reads; ours are live)
        from .utils.config import spgemm_config_from_ini

        self.spgemm_cfg = spgemm_cfg or spgemm_config_from_ini(self.config)
        self.dtype = dtype
        self.verbose = verbose

    def run(self) -> RunResult:
        cfg = self.config
        iterations_warmup = cfg.get_int("IterationsWarmUp", 10)
        iterations = cfg.get_int("IterationsExecution", 10)
        track_individual = cfg.get_bool("TrackIndividualTimes", False)
        track_complete = cfg.get_bool("TrackCompleteTimes", True)
        compare_result = cfg.get_bool("CompareResult", False)

        dl = DataLoader(self.path, dtype=np.float64, verbose=self.verbose)
        a, b = dl.cpuA, dl.cpuB
        if self.verbose:
            st = a.row_statistics()
            print(
                f"Matrix: {self.path}: {a.rows}x{a.cols}: {a.nnz} nonzeros"
                f" (row mean {st['mean']:.2f}, max {st['max']})"
            )
        A = device_put_csr(a, dtype=self.dtype)
        B = device_put_csr(b, dtype=self.dtype) if b is not a else A

        reference = oracle_spgemm(a, b) if compare_result else None
        compared_ok: Optional[bool] = None

        def one_iteration(timings: Timings):
            nonlocal compared_ok
            t0 = time.perf_counter()
            C = spgemm(A, B, self.spgemm_cfg, timings)
            jax.block_until_ready(C.data)
            total_ms = (time.perf_counter() - t0) * 1e3
            if reference is not None:
                res = compare_csr(reference, device_get_csr(C))
                compared_ok = bool(res) and (compared_ok is not False)
                if not res and self.verbose:
                    print(f"COMPARE FAILED: {res.message}")
            return C, total_ms

        # warmup (first iteration compiles; Executor.cpp:43-56)
        for _ in range(max(iterations_warmup, 1)):
            warm_t = Timings()
            C, _ = one_iteration(warm_t)

        timings = Timings()
        timings.measure_all = track_individual
        timings.measure_complete = track_complete
        total_ms_acc = 0.0
        for _ in range(max(iterations, 1)):
            C, total_ms = one_iteration(timings)
            total_ms_acc += total_ms
        n_iter = max(iterations, 1)
        timings /= n_iter
        mean_total_ms = total_ms_acc / n_iter

        from .ops.analysis import analyze

        sum_products = float(analyze(A, B).sum_products)
        gflops = 2.0 * sum_products / (mean_total_ms * 1e6) if mean_total_ms else 0.0
        nnz_per_s = C.nnz / (mean_total_ms * 1e-3) if mean_total_ms else 0.0

        if self.verbose:
            print(f"speck        nnz: {C.nnz}, mean total time: {mean_total_ms:.3f} ms")
            print(f"             GFLOPS: {gflops:.2f}, nnz(C)/s: {nnz_per_s:.3e}")
            if track_individual:
                print(timings.report())
            if compared_ok is not None:
                print(f"compare vs oracle: {'OK' if compared_ok else 'FAILED'}")

        return RunResult(
            nnz=C.nnz,
            mean_total_ms=mean_total_ms,
            timings=timings,
            sum_products=sum_products,
            gflops=gflops,
            nnz_per_s=nnz_per_s,
            compared_ok=compared_ok,
        )
