#!/usr/bin/env python
"""Chip smoke test: drive every single-card SpGEMM route once on a GPU,
through the entry points a user calls, at sizes users of a SpGEMM
library call real, and check each result against the scipy oracle.

    python chip_smoke.py            # one card: every single-card route
    python chip_smoke.py --mesh4    # four cards: the mesh path only

One process drives the card(s). Each phase prints one line: the route
read from the plan and asserted, nnz(C), the product count, the oracle
compare, the wall time of the first call (compile + run) and of one warm
call (a smoke time, not a benchmark), and the device's peak bytes in
use. The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a GPU the script exits non-zero and prints no result; it never
falls back to the CPU.

Inputs are generated from seeds by bench.py's generators; the weights
of a model are, for a SpGEMM library, the matrices' values.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import numpy as np

# Phase input sizes. "full" is what the chip runs; "tiny" keeps every
# phase on the same route at CPU-test sizes. Each size table maps an
# input name to the keyword arguments of its bench.py generator.
SIZES = {
    "full": dict(
        cli=dict(m=131072),
        # ~10M nnz, ~1.2e8 products, C ~1 GB
        stream=dict(m=1 << 20, seed=5),
        # 1.06M rows, 28.6M nnz, 7.7e8 products, C 131M nnz: above
        # host_analysis_max_nnz, so it takes the lite host gate
        sdia=dict(g=102),
        dia_split=dict(n=1 << 20, half_band=8),
        # 2^19 rows: at 2^20 the 1.1e9 products pass one plan's 2^30
        # budget, spgemm row-blocks the call, and the dense staging cap
        # (2048 tiles of 256 rows) covers only half the matrix
        dense=dict(n=1 << 19, half_band=16),
        giant_row=dict(),
        fp64=dict(n=1 << 20, half_band=8),
        # widest wide-row finish the giant row must reach
        giant_min_finish_w=1 << 20,
    ),
    "tiny": dict(
        cli=dict(m=2048),
        stream=dict(m=4096, seed=5),
        sdia=dict(g=8),
        dia_split=dict(n=4096, half_band=8, n_out=64),
        dense=dict(n=2048, half_band=16),
        giant_row=dict(mg=16000, n_hub=64, hub_len=400),
        fp64=dict(n=4096, half_band=8),
        giant_min_finish_w=1 << 10,
    ),
}

F32_REL_TOL = 1e-3   # f32 sums in another order than the f64 oracle's
F64_REL_TOL = 1e-9


class SmokeFailure(AssertionError):
    pass


@dataclasses.dataclass
class PhaseResult:
    name: str
    route: Tuple[str, ...]
    nnz: int
    products: float
    compare: str
    first_s: float
    warm_s: float
    peak_bytes: Optional[int]
    note: str = ""

    def line(self) -> str:
        peak = "n/a" if self.peak_bytes is None else str(self.peak_bytes)
        note = f" {self.note}" if self.note else ""
        return (f"phase {self.name}: route={'+'.join(self.route) or '-'}"
                f" nnz(C)={self.nnz} products={self.products:.6e}"
                f" compare={self.compare}"
                f" first_call(compile+run)={self.first_s:.3f}s"
                f" warm_call(smoke, not a benchmark)={self.warm_s:.3f}s"
                f" peak_bytes_in_use={peak}{note}")


def _peak_bytes(devices=None) -> Optional[int]:
    import jax

    peaks = []
    for d in devices or jax.devices()[:1]:
        try:
            ms = d.memory_stats()
        except Exception:
            ms = None
        if ms and "peak_bytes_in_use" in ms:
            peaks.append(int(ms["peak_bytes_in_use"]))
    return max(peaks) if peaks else None


def _expect(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def _check_route(name: str, got: Tuple[str, ...], want: Tuple[str, ...]):
    _expect(tuple(sorted(got)) == tuple(sorted(want)),
            f"{name}: route {got}, expected {want}")


def _compare(name: str, ref, got, rel_tol: float) -> str:
    from speck_tpu.utils.compare import compare_csr

    res = compare_csr(ref, got, compare_data=True, rel_tol=rel_tol)
    _expect(res.ok, f"{name}: oracle compare failed: {res.message}")
    return f"structure exact, values rel {rel_tol:g}"


def _timed(fn, ready=lambda out: out):
    """(fn(), wall seconds), with the clock stopped only once the
    device arrays ``ready(out)`` are complete."""
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(ready(out))
    return out, time.perf_counter() - t0


def _plan_and_execute(A, cfg):
    from speck_tpu import plan_spgemm

    plan = plan_spgemm(A, A, cfg)
    return plan, plan.execute()


# ---------------------------------------------------------------------------
# Single-card phases
# ---------------------------------------------------------------------------


def _spgemm_phase(name: str, a, want: Tuple[str, ...], *, dtype=np.float32,
                  cfg=None, rel_tol: float = F32_REL_TOL,
                  check: Optional[Callable] = None) -> PhaseResult:
    """A·A through plan_spgemm + execute (first call, whose plan gives
    the route) and then spgemm (warm call), compared with the oracle."""
    from speck_tpu import (device_get_csr, device_put_csr, oracle_spgemm,
                           spgemm)

    A = device_put_csr(a, dtype)
    (plan, C), first_s = _timed(lambda: _plan_and_execute(A, cfg),
                                ready=lambda out: out[1].data)
    _check_route(name, plan.routes, want)
    note = check(plan) if check else ""
    products = float(plan.sum_products)
    del C, plan
    C, warm_s = _timed(lambda: spgemm(A, A, cfg), ready=lambda C: C.data)
    peak = _peak_bytes()
    got = device_get_csr(C)
    del C, A
    cmp = _compare(name, oracle_spgemm(a, a), got, rel_tol)
    _expect(got.data.dtype == np.dtype(dtype),
            f"{name}: result dtype {got.data.dtype}, expected {dtype}")
    return PhaseResult(name, want, got.nnz, products, cmp, first_s, warm_s,
                       peak, note)


def phase_cli(sizes: dict) -> PhaseResult:
    """The runspeck CLI in-process on a power-law .mtx with
    CompareResult=true (the Executor's structure compare), then the
    route and value check on the matrix the CLI loaded."""
    from bench import make_powerlaw
    from speck_tpu import (DataLoader, HostCOO, device_get_csr,
                           device_put_csr, oracle_spgemm, plan_spgemm,
                           spgemm)
    from speck_tpu.cli import main as cli_main
    from speck_tpu.formats.mtx import store_mtx

    h = make_powerlaw(**sizes["cli"])
    coo = h.to_scipy().tocoo()
    with tempfile.TemporaryDirectory() as tmp:
        mtx = os.path.join(tmp, "powerlaw.mtx")
        ini = os.path.join(tmp, "smoke.ini")
        store_mtx(mtx, HostCOO(h.rows, h.cols, coo.row.astype(np.uint32),
                               coo.col.astype(np.uint32), coo.data))
        with open(ini, "w") as fh:
            fh.write("IterationsWarmUp = 1\nIterationsExecution = 1\n"
                     "CompareResult = true\n")
        t0 = time.perf_counter()
        rc = cli_main(["runspeck", mtx, ini])
        first_s = time.perf_counter() - t0
        _expect(rc == 0, f"cli: runspeck returned {rc}")
        a = DataLoader(mtx, dtype=np.float64).cpuA
    A = device_put_csr(a, np.float32)
    plan = plan_spgemm(A, A)
    _check_route("cli", plan.routes, ("stream",))
    products = float(plan.sum_products)
    del plan
    C, warm_s = _timed(lambda: spgemm(A, A), ready=lambda C: C.data)
    peak = _peak_bytes()
    got = device_get_csr(C)
    cmp = _compare("cli", oracle_spgemm(a, a), got, F32_REL_TOL)
    return PhaseResult("cli", ("stream",), got.nnz, products,
                       "runspeck compare OK; " + cmp, first_s, warm_s, peak)


def _stream_note(plan) -> str:
    ss = plan.stream
    lo = ss.layout
    return (f"[W={lo.W} chunks={lo.n_chunks} wide_rows={lo.n_wide} "
            f"staging={'fused' if ss.fused else 'two-phase'}]")


def phase_stream(sizes: dict) -> PhaseResult:
    from bench import make_powerlaw

    return _spgemm_phase("stream", make_powerlaw(**sizes["stream"]),
                         ("stream",), check=_stream_note)


def phase_plan_reuse(sizes: dict) -> PhaseResult:
    """plan_spgemm once, then plan.execute with new values on the same
    structure (AMG re-setup, GNN aggregation)."""
    from bench import make_powerlaw
    from speck_tpu import (device_get_csr, device_put_csr, oracle_spgemm,
                           plan_spgemm)

    a = make_powerlaw(**sizes["stream"])
    A = device_put_csr(a, np.float32)
    plan = plan_spgemm(A, A)
    _check_route("plan_reuse", plan.routes, ("stream",))
    a2 = dataclasses.replace(
        a, data=np.random.RandomState(23).standard_normal(a.nnz))
    A2 = device_put_csr(a2, np.float32)
    _, first_s = _timed(lambda: plan.execute(A2, A2).data)
    C, warm_s = _timed(lambda: plan.execute(A2, A2), ready=lambda C: C.data)
    peak = _peak_bytes()
    got = device_get_csr(C)
    products = float(plan.sum_products)
    note = _stream_note(plan)
    del C, plan, A, A2
    cmp = _compare("plan_reuse", oracle_spgemm(a2, a2), got, F32_REL_TOL)
    return PhaseResult("plan_reuse", ("stream",), got.nnz, products, cmp,
                       first_s, warm_s, peak, note)


def phase_sdia(sizes: dict) -> PhaseResult:
    from bench import make_stencil27
    from speck_tpu import SpgemmConfig

    a = make_stencil27(**sizes["sdia"])
    # the full-size stencil is past host_analysis_max_nnz; the tiny one
    # lowers the ceiling so both take the lite host gate
    cfg = SpgemmConfig(host_analysis_max_nnz=min(
        SpgemmConfig().host_analysis_max_nnz, a.nnz - 1))
    return _spgemm_phase(
        "sdia", a, ("sdia",), cfg=cfg,
        check=lambda p: f"[diagonals a={p.dia.span_a} c={p.dia.span_c}]")


def phase_dia_split(sizes: dict) -> PhaseResult:
    from bench import make_mixed

    return _spgemm_phase(
        "dia_split", make_mixed(**sizes["dia_split"]),
        ("dia_rows", "stream"),
        check=lambda p: f"[band a={p.dia_rows.span_a} c={p.dia_rows.span_c}]")


def phase_dense(sizes: dict) -> PhaseResult:
    from bench import make_banded
    from speck_tpu import SpgemmConfig

    cfg = SpgemmConfig(enable_dia=False, dia_rows=False, enable_sdia=False)
    return _spgemm_phase(
        "dense", make_banded(**sizes["dense"]), ("dense",), cfg=cfg,
        check=lambda p: (f"[tiles={len(p.dense.r0s)} kw={p.dense.kw} "
                         f"cw={p.dense.cw}]"))


def phase_giant_row(sizes: dict) -> PhaseResult:
    from bench import make_giant_row

    min_w = sizes["giant_min_finish_w"]

    def check(plan):
        ss = plan.stream
        _expect(ss.layout.n_wide > 0, "giant_row: no wide rows")
        classes = (ss.finish or {}).get("classes") or []
        w2 = max((f["W2"] for f in classes), default=0)
        _expect(w2 >= min_w,
                f"giant_row: widest finish {w2} < {min_w}")
        return (f"[wide_rows={ss.layout.n_wide} "
                f"ladder_levels={ss.finish['ladder_levels']} "
                f"finish_width={w2}]")

    return _spgemm_phase("giant_row", make_giant_row(**sizes["giant_row"]),
                         ("stream",), check=check)


def phase_fp64(sizes: dict) -> PhaseResult:
    import jax
    from bench import make_banded

    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return _spgemm_phase("fp64", make_banded(**sizes["fp64"], seed=9),
                             ("dia",), dtype=np.float64,
                             rel_tol=F64_REL_TOL)
    finally:
        jax.config.update("jax_enable_x64", prev)


SINGLE_PHASES: Dict[str, Callable[[dict], PhaseResult]] = {
    "cli": phase_cli,
    "stream": phase_stream,
    "plan_reuse": phase_plan_reuse,
    "sdia": phase_sdia,
    "dia_split": phase_dia_split,
    "dense": phase_dense,
    "giant_row": phase_giant_row,
    "fp64": phase_fp64,
}


# ---------------------------------------------------------------------------
# Four-card mesh phases
# ---------------------------------------------------------------------------


def _one_card(a):
    from speck_tpu import device_get_csr, device_put_csr, spgemm

    A = device_put_csr(a, np.float32)
    return device_get_csr(spgemm(A, A))


def _mesh_phase(name: str, mesh, a, ref, one, *, exchange: str,
                want_route: str, cfg=None,
                check: Optional[Callable] = None) -> PhaseResult:
    """A·A through mesh_stream_spgemm, compared with the oracle and the
    one-card spgemm result."""
    from speck_tpu.ops.analysis import host_analyze
    from speck_tpu.parallel import mesh_stream_spgemm, mesh_stream_to_host_csr

    def call():
        return mesh_stream_spgemm(a, a, mesh, cfg=cfg, exchange=exchange)

    out, first_s = _timed(call, ready=lambda out: out[:3])
    meta = out[3]
    _expect(meta["route"] == want_route,
            f"{name}: mesh route {meta['route']}, expected {want_route}")
    note = check(meta) if check else ""
    out, warm_s = _timed(call, ready=lambda out: out[:3])
    peak = _peak_bytes(list(mesh.devices.flat))
    got = mesh_stream_to_host_csr(*out)
    del out
    cmp = _compare(name, ref, got, F32_REL_TOL)
    _compare(name + " vs one card", one, got, F32_REL_TOL)
    st = meta["stats"]
    comm = (f"[exchange={st.mode} needset_bytes={st.needset_bytes} "
            f"allgather_bytes={st.allgather_bytes}]" if st is not None
            else f"[exchange={exchange}: B replicated, no need-set plan]")
    note = comm + (f" {note}" if note else "")
    return PhaseResult(name, (want_route,), got.nnz,
                       host_analyze(a, a).sum_products,
                       cmp + "; matches one card", first_s, warm_s, peak,
                       note)


def _ksplit_note(meta) -> str:
    ks = meta["ksplit"]
    _expect(ks is not None and ks["n_split"] >= 1,
            f"giant_row mesh: k-split did not engage: {ks}")
    return f"[ksplit rows={ks['n_split']}]"


# mesh phase -> (input, exchange, expected route, k-split check)
MESH_PHASES = {
    "mesh_stream_needset": ("stream", "needset", "stream", False),
    "mesh_stream_allgather": ("stream", "allgather", "stream", False),
    "mesh_stream_needset_overlap": ("stream", "needset_overlap", "stream",
                                    False),
    "mesh_sdia": ("sdia", "needset", "sdia", False),
    "mesh_giant_row_ksplit": ("giant_row", "needset", "stream", True),
}


def mesh_phase(name: str, sizes: dict, mesh,
               inputs: Optional[dict] = None) -> PhaseResult:
    """One mesh phase over a 4-device row mesh. ``inputs`` caches each
    input with its oracle and one-card results across phases."""
    from bench import make_giant_row, make_powerlaw, make_stencil27
    from speck_tpu import oracle_spgemm

    gens = {"stream": make_powerlaw, "sdia": make_stencil27,
            "giant_row": make_giant_row}
    key, exchange, route, ksplit = MESH_PHASES[name]
    inputs = {} if inputs is None else inputs
    if key not in inputs:
        inputs.clear()   # phases run grouped by input: free the last one
        gc.collect()
        a = gens[key](**sizes[key])
        inputs[key] = (a, oracle_spgemm(a, a), _one_card(a))
    a, ref, one = inputs[key]
    return _mesh_phase(name, mesh, a, ref, one, exchange=exchange,
                       want_route=route,
                       cfg=_ksplit_cfg(a) if ksplit else None,
                       check=_ksplit_note if ksplit else None)


def _ksplit_cfg(a):
    """Split threshold under the giant row's product count, so k-split
    engages at every size (the default 2^25 already does at full size)."""
    from speck_tpu import SpgemmConfig
    from speck_tpu.ops.analysis import host_analyze

    cfg = SpgemmConfig()
    widest = host_analyze(a, a).max_row_products
    return dataclasses.replace(
        cfg, mesh_split_min_ops=min(cfg.mesh_split_min_ops, widest - 1))


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _run(fn) -> PhaseResult:
    """Run one phase; print its line, or its failure. A failing phase
    does not stop the others, but the script then exits non-zero."""
    try:
        res = fn()
    except Exception as e:  # reported, then counted as a failure
        traceback.print_exc()
        print(f"phase FAILED: {type(e).__name__}: {e}", flush=True)
        gc.collect()
        return None
    print(res.line(), flush=True)
    gc.collect()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-card mesh phases")
    args = ap.parse_args(argv)

    try:
        import jax
        from speck_tpu.utils.device import enable_compile_cache, gpu_card_line
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r});"
              " refusing to fall back", file=sys.stderr)
        return 1
    n_cards = 4 if args.mesh4 else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    card = gpu_card_line()
    if card is None:
        print("chip_smoke: nvidia-smi did not report the card",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    for line in card.splitlines()[:n_cards]:
        print(f"card: {line}")
    print(f"jax {jax.__version__}; devices: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    sizes = SIZES["full"]

    if args.mesh4:
        from speck_tpu.parallel import make_row_mesh

        mesh, inputs = make_row_mesh(4), {}
        results = [_run(lambda n=n: mesh_phase(n, sizes, mesh, inputs))
                   for n in MESH_PHASES]
    else:
        results = [_run(lambda f=f: f(sizes)) for f in SINGLE_PHASES.values()]
    if any(r is None for r in results):
        print(f"chip_smoke: {sum(r is None for r in results)} of "
              f"{len(results)} phases failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
