"""chip_smoke.py on the CPU: every single-card phase at tiny sizes on its
route, the refusal to run without a GPU, and the compile-cache helper
the program's entry points share."""

import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture()
def no_code_cache(monkeypatch):
    """Keep entry points (the CLI phase calls runspeck in-process) from
    turning on a persistent cache in the test process: with the
    variable set, the helper sets nothing, and JAX read its environment
    at import, long before."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused-in-tests")
    before = jax.config.jax_compilation_cache_dir
    yield
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("phase", sorted(chip_smoke.SINGLE_PHASES))
def test_single_card_phase_tiny(phase, no_code_cache):
    """Each phase asserts its own route, oracle compare and dtype."""
    res = chip_smoke.SINGLE_PHASES[phase](chip_smoke.SIZES["tiny"])
    assert res.name == phase
    assert res.nnz > 0 and res.products >= res.nnz
    assert "structure exact" in res.compare
    line = res.line()
    assert line.startswith(f"phase {phase}: route=")
    assert "compile+run" in line and "not a benchmark" in line


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_main_alone_in_a_directory(tmp_path):
    """Copied alone, the script finds no program: non-zero, no result."""
    import shutil
    import subprocess

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env-var-set", "env-var-unset"])
def test_compile_cache_helper(env_set, monkeypatch):
    from speck_tpu.utils import device

    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = device.enable_compile_cache()
        if env_set:
            # JAX reads the variable itself: nothing is set in code
            assert got is None
            assert jax.config.jax_compilation_cache_dir == before[0]
        else:
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            # a fixed path: the same on every call
            assert device.enable_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])


def test_plan_routes_empty_product():
    import numpy as np
    from speck_tpu import HostCSR, device_put_csr, plan_spgemm

    a = HostCSR(rows=4, cols=4, row_offsets=np.zeros(5, np.int64),
                col_ids=np.zeros(0, np.int64), data=np.zeros(0))
    A = device_put_csr(a)
    assert plan_spgemm(A, A).routes == ()
