"""The per-layer metrics that read the program's own spans and counters
(``runner.copy_ms``, ``runner.copy_faults``, ``wrappers.self_us``,
``runner.idle_pct``): each from a synthetic record, each silent on a
record of a program without them, and each loaded from a directory
that holds only the benchmark's files."""

from __future__ import annotations

import json

import pytest

from lbmbench import spec
from lbmbench.tests.helpers import REPO, run_module

NEW = ("runner.copy_ms", "runner.copy_faults", "wrappers.self_us",
       "runner.idle_pct")


def _record(timings, launches=None, trace=None):
    return {"cell": "x", "scenes": [{"nx": 8, "ny": 8, "iters": 10,
                                     "wall_s": 1.0, "timings": t}
                                    for t in timings],
            "launches": launches, "trace": trace}


# The timings of a scene as the program records them, and as a program
# without the spans (the parent of this change) does.
NOW = [{"init": 3e-3, "init.plan": 1e-3, "compute": 0.4,
        "compute.wrappers": 0.01, "collate": 0.023, "collate.copy": 0.018,
        "collate.copy.minflt": 9000, "total": 0.43},
       {"init": 3e-3, "init.plan": 1e-3, "compute": 0.4,
        "compute.wrappers": 0.03, "collate": 0.021, "collate.copy": 0.02,
        "collate.copy.minflt": 9400, "total": 0.43}]
BEFORE = [{k: v for k, v in t.items()
           if k in ("init", "compute", "collate", "total")} for t in NOW]
TRACE = {"window_s": 2.0, "busy_s": 1.9, "kernel_s": 1.8,
         "device_ops": [], "device_events": 10,
         "idle_gaps": [["lbm.segment.depth", 0.02], ["cudaLaunchKernel", 0.05],
                       ["lbm.init", 0.004], ["lbmbench.scene", 0.01],
                       ["lbm.collate", 0.006], ["host", 0.01]]}


def test_copy_ms_is_the_mean_copy():
    read = spec.reader("runner.copy_ms")
    assert read(_record(NOW)) == pytest.approx(19.0)


def test_copy_faults_is_the_mean_count():
    read = spec.reader("runner.copy_faults")
    assert read(_record(NOW)) == pytest.approx(9200)


def test_wrappers_self_us_is_their_time_over_the_launches():
    read = spec.reader("wrappers.self_us")
    assert read(_record(NOW, launches=10000)) == pytest.approx(4.0)
    assert read(_record(NOW, launches=0)) is None


def test_runner_idle_pct_sums_only_the_program_spans():
    read = spec.reader("runner.idle_pct")
    # lbm.segment.depth, lbm.init and lbm.collate: 0.03 s of 2 s.
    assert read(_record(NOW, trace=TRACE)) == pytest.approx(1.5)
    quiet = dict(TRACE, idle_gaps=[["cudaLaunchKernel", 0.05]])
    assert read(_record(NOW, trace=quiet)) == 0


@pytest.mark.parametrize("metric", NEW)
def test_silent_on_a_program_without_the_spans(metric):
    read = spec.reader(metric)
    assert read(_record(BEFORE, launches=10000, trace=TRACE)) is None
    assert read(_record([], launches=None, trace=None)) is None


def test_idle_pct_is_silent_without_a_device_trace():
    read = spec.reader("runner.idle_pct")
    assert read(_record(NOW, 10000)) is None
    assert read(_record(NOW, 10000, dict(TRACE, device_events=0))) is None


def test_a_copy_of_the_benchmark_loads_and_reads_them(bench_copy):
    """From a directory holding only the benchmark's files: the four
    entries resolve to their readers, and a traced run of a small scene
    cell on the CPU reports the two the CPU path can read (no launches,
    no device trace there)."""
    code = ("import json; from lbmbench import spec, harness\n"
            "from lbmbench.tests.helpers import tiny\n"
            f"new = {list(NEW)!r}\n"
            "cell = tiny(spec.resolve('ref256.scene'))\n"
            "assert set(new) <= {m['name'] for m in cell.per_layer}\n"
            "assert all(callable(spec.reader(m)) for m in new)\n"
            "r, notes, bad = harness.run_cell(cell, 2**31 + 7, 0.0, True,"
            " 'cpu')\n"
            "print(json.dumps(r))\n")
    p = run_module(["-c", code], cwd=bench_copy,
                   env_extra={"PYTHONPATH": str(REPO)})
    assert p.returncode == 0, p.stderr
    result = json.loads(p.stdout.splitlines()[-1])
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["runner.copy_ms"]["value"] > 0
    assert metrics["runner.copy_faults"]["value"] >= 0
    assert "wrappers.self_us" not in metrics
    assert "runner.idle_pct" not in metrics
