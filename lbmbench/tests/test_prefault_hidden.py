"""``runner.prefault_hidden`` from synthetic records: the share of the
scenes whose counter reads 1, and silent where no scene records it."""

from __future__ import annotations

import pytest

from lbmbench import spec


def _record(counters):
    timings = [{"compute": 0.4, "collate": 0.01}
               if c is None else {"compute": 0.4, "collate": 0.01,
                                  "compute.prefault": 0.012,
                                  "compute.prefault.hidden": c}
               for c in counters]
    return {"cell": "x", "scenes": [{"nx": 8, "ny": 8, "iters": 10,
                                     "wall_s": 1.0, "timings": t}
                                    for t in timings],
            "launches": None, "trace": None}


@pytest.mark.parametrize("counters, share", [
    ([1, 1, 1], 100.0), ([1, 0], 50.0), ([1, 0, None, None], 50.0),
    ([0, 0], 0.0), ([None, None], None), ([], None)])
def test_the_share_of_scenes_whose_preparation_hid(counters, share):
    got = spec.reader("runner.prefault_hidden")(_record(counters))
    assert got == (None if share is None else pytest.approx(share))


def test_listed_for_both_cells():
    metric, = [m for m in spec.load_benchmark()["per_layer"]
               if m["name"] == "runner.prefault_hidden"]
    assert metric["workloads"] == ["ref1024.scene", "ref256.scene"]
    assert (metric["unit"], metric["better"], metric["source"],
            metric["layer"], metric["moves"]) == (
        "%", "higher", "program_counter", "runner", "glups")
