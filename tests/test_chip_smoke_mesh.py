"""chip_smoke.py --mesh4 phases on 4 of conftest's 8 virtual CPU
devices, at tiny sizes: each asserts its mesh route, compares with the
oracle and with the one-card result."""

import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("phase", list(chip_smoke.MESH_PHASES))
def test_mesh4_phase_tiny(phase):
    from speck_tpu.parallel import make_row_mesh

    res = chip_smoke.mesh_phase(phase, chip_smoke.SIZES["tiny"],
                                make_row_mesh(4))
    assert res.name == phase
    assert "matches one card" in res.compare
    assert "exchange=" in res.note
    if phase.endswith("ksplit"):
        assert "ksplit rows=" in res.note
