"""The check decides ``correct`` by the comparison with the reference: a
sound run at a CPU size passes it, and the control and each fault a cell
can have, planted underneath the timed path, fail it. One chip: no
exchange between chips to leave out."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lbmbench import compare, harness, spec
from lbmbench.tests.helpers import tiny

SEED = 2**31 + 12345
WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def test_a_sound_run_is_correct(tiny_cell):
    result, notes, bad = harness.run_cell(tiny_cell, SEED, 0.2, False, "cpu")
    assert result["correct"], notes
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {m["name"] for m in tiny_cell.end_to_end}
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(compare.NUMBERS)
    assert notes[-3:] == [f"check {n} {float(result['checks'][n]['value'])!r}"
                          f" limit {result['checks'][n]['limit']!r}"
                          for n in compare.NUMBERS]
    assert bad == []


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails(workload):
    """The reference with its state in bfloat16 in the program's place,
    under each cell's own limits."""
    control = harness.Control("cpu")
    result, notes, _ = harness.run_cell(tiny(spec.resolve(workload)), SEED,
                                        0.0, False, "cpu", control,
                                        warm=False)
    assert not result["correct"], notes


def _unchanged(orig):
    def step(cells, *args, **kw):
        _, tot = orig(cells, *args, **kw)
        return cells, tot
    return step


def _half(orig):
    def step(cells, *args, **kw):
        new, tot = orig(cells, *args, **kw)
        new = new.clone()
        h = new.shape[1] // 2
        new[:, h:] = cells[:, h:]
        return new, tot
    return step


def _reynolds(orig):
    return lambda *args: orig(*args) * 2


def _lattice(orig):
    """The final lattice with the fastest cell's speeds reversed."""
    def result(self):
        cells, av = orig(self)
        cells = cells.clone()
        rho = cells.sum(0)
        ux = (cells[1] + cells[5] + cells[8] - cells[3] - cells[6]
              - cells[7]) / rho
        j, i = np.unravel_index(int(torch.argmax(ux.abs())), ux.shape)
        cells[:, j, i] = cells[[0, 3, 4, 1, 2, 7, 8, 5, 6], j, i]
        return cells, av
    return result


FAULTS = {
    "step_returns_state_unchanged": ("lbm_tpu_torch.ops.reference",
                                     "fused_step", _unchanged),
    "half_the_lattice_left_out": ("lbm_tpu_torch.ops.reference",
                                  "fused_step", _half),
    "reynolds_altered": ("lbm_tpu_torch.runner", "calc_reynolds", _reynolds),
    "final_lattice_altered": ("lbm_tpu_torch.runner._Simulation", "result",
                              _lattice),
}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails(workload, fault, monkeypatch):
    """Each fault under each cell's own limits."""
    import importlib

    cell = tiny(spec.resolve(workload))
    where, name, plant = FAULTS[fault]
    module, _, cls = where.partition("._")
    target = importlib.import_module(module)
    if cls:
        target = getattr(target, "_" + cls)
    monkeypatch.setattr(target, name, plant(getattr(target, name)))
    result, notes, _ = harness.run_cell(cell, SEED, 0.0, False, "cpu")
    assert not result["correct"], notes


def test_a_traced_run_reports_the_per_layer_metrics(tiny_cell):
    result, notes, _ = harness.run_cell(tiny_cell, SEED, 0.0, True, "cpu")
    assert result["correct"], notes
    # The runner's spans and the counter read on the CPU; the device's
    # metrics find nothing to read there and are left out.
    assert set(result["metrics"]) == {"runner.init_ms", "runner.collate_ms",
                                      "planner.launches_per_kstep"}
    assert result["device"]["platform"] == "cpu"
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
