"""On the card (the ``cuda`` marker; each test skips where there is
none): the command runs a cell end to end with ``correct`` true, and the
control fails the check at the 256^2 cell's own grid."""

from __future__ import annotations

import json

import pytest

from lbmbench import harness, spec
from lbmbench.tests.helpers import REPO, run_module, tiny


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(cuda):
    p = run_module(["-m", "lbmbench", "--workload", "ref256.scene",
                    "--seed", str(2**31 + 77), "--seconds", "2",
                    "--trace", "0"], cwd=REPO)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.splitlines()[-1])
    assert result["correct"], p.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"glups", "scene_s.p90", "setup_s"}


@pytest.mark.cuda
def test_the_control_fails_on_the_card(cuda):
    cell = tiny(spec.resolve("ref256.scene"), nx=256, ny=256, iters=8000)
    cell.config["mask"] = spec.resolve("ref256.scene").config["mask"]
    control = harness.Control(cuda)
    result, notes, _ = harness.run_cell(cell, 2**31 + 78, 0.0, False, cuda,
                                        control, warm=False)
    assert not result["correct"], notes
