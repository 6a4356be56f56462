"""``kernels.depth_wait_pct`` from synthetic records: the waits over the
flowing tiles of the scenes that record them, and silent where none
does (a program without the flow form)."""

from __future__ import annotations

import pytest

from lbmbench import spec


def _record(counts):
    timings = [{"compute": 0.4, "collate": 0.01}
               if c is None else {"compute": 0.4, "collate": 0.01,
                                  "compute.depth.waits": c[0],
                                  "compute.depth.flow_tiles": c[1]}
               for c in counts]
    return {"cell": "x", "scenes": [{"nx": 8, "ny": 8, "iters": 10,
                                     "wall_s": 1.0, "timings": t}
                                    for t in timings],
            "launches": None, "trace": None}


@pytest.mark.parametrize("counts, share", [
    ([(0, 1000), (0, 1000)], 0.0), ([(10, 1000), (30, 1000)], 2.0),
    ([(5, 100), None], 5.0), ([(0, 0)], None), ([None, None], None),
    ([], None)])
def test_the_share_of_flowing_tiles_that_waited(counts, share):
    got = spec.reader("kernels.depth_wait_pct")(_record(counts))
    assert got == (None if share is None else pytest.approx(share))


def test_listed_for_the_headline_cell():
    metric, = [m for m in spec.load_benchmark()["per_layer"]
               if m["name"] == "kernels.depth_wait_pct"]
    assert metric["workloads"] == ["ref1024.scene"]
    assert (metric["unit"], metric["better"], metric["source"],
            metric["layer"], metric["moves"]) == (
        "%", "lower", "program_counter", "kernels", "glups")
