"""``BENCHMARK.json`` keeps the contract's shape, and every cell, metric
and configuration it names resolves to the benchmark's files by name."""

from __future__ import annotations

import json
import re

import pytest

from lbmbench import spec
from lbmbench.tests.helpers import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.resolve(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert set(cell.check["limits"]) == {"cells", "av_vels", "reynolds"}
    assert cell.check["scenes"] >= 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len({m["layer"] for m in cell.per_layer}) >= 4
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        # The end-to-end metric it moves is reported in this cell.
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for m in cell.end_to_end:
        assert m["name"] in ("glups", "scene_s.p90", "setup_s")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["lbmbench"]
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("lbmbench/")
        data = json.loads((REPO / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in BENCH["workloads"]}
        if m["name"].endswith("roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_an_empty_record(metric):
    empty = {"cell": "x", "scenes": [], "launches": None, "trace": None}
    assert spec.reader(metric)(empty) is None
