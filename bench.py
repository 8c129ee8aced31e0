#!/usr/bin/env python
"""Benchmark harness covering the BASELINE.md target configs on the
default device, in one process; every timing ends in
``jax.block_until_ready``.

Prints per-config results as '#'-prefixed lines and ONE final JSON line
{"metric", "value", "unit", "vs_baseline"} for the driver: config 1
(banded A·A GFLOPS, vs scipy.sparse csr_matmat on this host — the oracle
backend standing in for the reference's cuSPARSE compare path; the repo
publishes no GPU numbers, BASELINE.json "published": {}).

Protocol parity: warmup + measured iterations, mean complete-call time
(/root/reference/source/Executor.cpp:43-78).
"""

import json
import sys
import time

import numpy as np


def make_banded(n=65536, half_band=16, seed=3):
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    mat = sp.diags(
        [rs.standard_normal(n - abs(o)) for o in offs], offs,
        shape=(n, n), format="csr",
    )
    return HostCSR.from_scipy(mat)


def make_powerlaw(m=131072, avg=12, alpha=2.2, seed=5):
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    lens = np.minimum((rs.pareto(alpha, m) + 1) * avg * 0.5, m // 4
                      ).astype(np.int64)
    rows = np.repeat(np.arange(m), lens)
    cols = rs.randint(0, m, rows.shape[0])
    vals = rs.standard_normal(rows.shape[0])
    mat = sp.csr_matrix((vals, (rows, cols)), shape=(m, m))
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


def make_mixed(n=65536, half_band=16, n_out=1024, out_nnz=64, seed=13):
    """Banded matrix with a clustered block of outlier rows holding
    far-flung random columns: breaks the whole-matrix DIA gate (span ~n),
    so the per-row DIA split routes the banded bulk through diagonal
    planes and the outlier region through the product stream — the
    heterogeneous-routing workload (the reference's per-block method
    auto-select, spECK_HashSpGEMM.cuh:1761-1793, exercised across
    paths)."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    offs = list(range(-half_band, half_band + 1))
    band = sp.diags(
        [rs.standard_normal(n - abs(o)) for o in offs], offs,
        shape=(n, n), format="csr")
    out_rows = np.repeat(np.arange(n_out), out_nnz)
    extra = sp.csr_matrix(
        (rs.standard_normal(out_rows.shape[0]),
         (out_rows, rs.randint(0, n, out_rows.shape[0]))), shape=(n, n))
    mat = (band + extra).tocsr()
    mat.sum_duplicates()
    return HostCSR.from_scipy(mat)


def make_stencil27(g=102, seed=19):
    """3-D 27-point stencil on a g^3 grid (the nlpkkt/BASELINE stencil
    input class): exactly 27 present diagonals spread over a ~2g^2-wide
    band — contiguous-DIA ineligible, sparse-DIA native (ops/dia.py
    sdia_conv). g=102 -> 1,061,208 rows, ~28.6M nnz, ~7.7e8 products."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    n = g ** 3
    offs = sorted(dz * g * g + dy * g + dx
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1))
    mat = sp.diags([rs.standard_normal(n - abs(o)) for o in offs], offs,
                   shape=(n, n), format="csr")
    return HostCSR.from_scipy(mat)


def make_giant_row(mg=40000, n_hub=5000, hub_len=10000, seed=17):
    """One row holding n_hub * hub_len products (5e7 at the defaults):
    row 0 references n_hub hub rows of hub_len nonzeros each, whose
    shifted column windows overlap inside hub_len output columns; plus
    mg // 8 light rows of 16 random columns. The windowed giant-row /
    global-map case of the reference (spECK_HashSpGEMM.cuh:106-126,
    1175-1298)."""
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    h0, c0, n_light = mg // 4, mg * 5 // 8, mg // 8
    hrow = np.repeat(np.arange(h0, h0 + n_hub), hub_len)
    hcol = ((np.tile(np.arange(hub_len), n_hub)
             + np.repeat(np.arange(n_hub) * 37, hub_len)) % hub_len) + c0
    lr = np.repeat(np.arange(1, n_light), 16)
    lc = rs.randint(1, n_light, lr.shape[0])
    gm = sp.csr_matrix(
        (rs.standard_normal(n_hub + hrow.shape[0] + lr.shape[0]),
         (np.concatenate([np.zeros(n_hub, int), hrow, lr]),
          np.concatenate([np.arange(h0, h0 + n_hub), hcol, lc]))),
        shape=(mg, mg))
    gm.sum_duplicates()
    return HostCSR.from_scipy(gm)


def make_prolongation(m, mc, seed=11):
    import scipy.sparse as sp
    from speck_tpu.formats.csr import HostCSR

    rs = np.random.RandomState(seed)
    return HostCSR.from_scipy(sp.csr_matrix(
        (np.ones(m), (np.arange(m), rs.randint(0, mc, m))), shape=(m, mc)))


def bench_pair(name, a, b, dtype=np.float32, iters=3, warm=1):
    import jax
    from speck_tpu import device_put_csr, spgemm
    from speck_tpu.ops.analysis import analyze

    A = device_put_csr(a, dtype)
    B = A if (b is a or b is None) else device_put_csr(b, dtype)
    sum_products = float(analyze(A, B).sum_products)

    def run():
        C = spgemm(A, B)
        jax.block_until_ready(C.data)
        return C

    for _ in range(warm):
        C = run()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        C = run()
        ts.append(time.perf_counter() - t0)
    mean_s = sum(ts) / len(ts)
    best_s = min(ts)
    print(f"# {name}: mean {mean_s*1e3:.1f} ms (best {best_s*1e3:.1f}), "
          f"nnz(C)={C.nnz}, products={sum_products:.3e}, "
          f"GFLOPS={2*sum_products/mean_s/1e9:.3f}, "
          f"nnz(C)/s={C.nnz/mean_s:.3e}", flush=True)
    return mean_s, best_s, C, sum_products


def main():
    import jax

    from speck_tpu.utils.device import (device_info, enable_compile_cache,
                                        gpu_card_line)

    # persistent compile cache: the bench is compile-heavy on a cold
    # process; measured iterations are warm either way (warmup runs eat
    # the compiles)
    enable_compile_cache()
    print(f"# jax {jax.__version__}; device: {device_info().summary()}",
          flush=True)
    card = gpu_card_line()
    if card:
        print(f"# card: {card}", flush=True)

    # ---- config 1 (headline): banded A·A, fp32 ----
    a1 = make_banded()
    S = a1.to_scipy()
    # host baseline: best of 3 (host-side timing is noisy)
    scipy_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        C_ref = S @ S
        scipy_s = min(scipy_s, time.perf_counter() - t0)
    # headline config: extra iterations (its vs_baseline is the
    # recorded headline)
    mean_s, best_s, C1, sum_products = bench_pair(
        "config1_banded_65k_AxA", a1, a1, iters=5)
    assert C1.nnz == C_ref.nnz, f"nnz mismatch: {C1.nnz} vs {C_ref.nnz}"

    # Every further config runs guarded: one failing config must not cost
    # the round its headline artifact (round 2 lost its entire BENCH json
    # to an OOM in the giant-row config; the driver records rc + tail).
    failures = []

    def guarded(tag, fn):
        import gc

        try:
            fn()
        except Exception as e:
            failures.append(tag)
            msg = str(e).replace("\n", " ")[:300]
            print(f"# {tag} FAILED: {type(e).__name__}: {msg}", flush=True)
        finally:
            # drop every device buffer the config held before the next
            # one runs: leftover plan staging pressures the device
            # allocator for the configs that follow
            gc.collect()

    # ---- config 1b: banded + clustered outlier rows (per-row DIA split:
    # diagonal planes for the banded bulk, stream for the outliers; the
    # whole-matrix DIA gate rejects this input) ----
    guarded("config1b", lambda: bench_pair(
        "config1b_mixed_banded_outliers_AxA", make_mixed(), None, iters=2))

    # ---- config 2: skewed power-law A·A ----
    guarded("config2", lambda: bench_pair(
        "config2_powerlaw_131k_AxA", make_powerlaw(131072), None, iters=2))

    # ---- config 3: larger skewed A·A (long rows) ----
    guarded("config3", lambda: bench_pair(
        "config3_powerlaw_262k_AxA", make_powerlaw(262144, seed=7), None,
        iters=2))

    # ---- config 4: rectangular A·P (Galerkin leg) ----
    guarded("config4", lambda: bench_pair(
        "config4_rect_AxP_65kx16k", a1, make_prolongation(65536, 16384),
        iters=2))

    # ---- stencil: 3-D 27-point, 1.06M rows (the nlpkkt stencil class;
    # sparse-DIA route: 27x27 offset-pair vector FMAs, no gathers) ----
    guarded("stencil27", lambda: bench_pair(
        "stencil27_3d_1M_AxA", make_stencil27(), None, iters=2))

    # ---- giant row: 5e7 products in ONE row (the windowed giant-row /
    # global-map analogue, spECK_HashSpGEMM.cuh:106-126, 1175-1298) ----
    def run_giant():
        gh = make_giant_row()
        bench_pair("giant_row_5e7_products_AxA", gh, gh, iters=1, warm=1)

    guarded("giant_row", run_giant)

    # ---- fp64 path (double instantiation parity, Multiply.cu:1130-31) ----
    def run_fp64():
        jax.config.update("jax_enable_x64", True)
        try:
            a5 = make_banded(16384, 8, seed=9)
            bench_pair("fp64_banded_16k_AxA", a5, a5, dtype=np.float64,
                       iters=2)
        finally:
            jax.config.update("jax_enable_x64", False)

    guarded("fp64", run_fp64)

    if failures:
        print(f"# FAILED configs: {', '.join(failures)}", flush=True)
    gflops = 2.0 * sum_products / mean_s / 1e9
    # vs_baseline is best-vs-best: the scipy side takes its best of 3
    # (host timing is noisy), so the device side compares its best too.
    print(json.dumps({
        "metric": "spgemm_banded_65k_AxA_gflops",
        "value": round(gflops, 3),
        "unit": "GFLOPS",
        "vs_baseline": round(scipy_s / best_s, 3),
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
