"""A later PR adds a configuration, a traffic mix, a cell and a per-layer
metric as new files and new entries in ``BENCHMARK.json``, and edits no
file the benchmark has; and the command refuses to run without a card or
without the program."""

from __future__ import annotations

import hashlib
import json

from lbmbench.tests.helpers import REPO, run_module


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_entries(bench_copy):
    bench = bench_copy / "lbmbench"
    before = _digests(bench)
    (bench / "configs" / "tiny_40x24.json").write_text(json.dumps({
        "name": "tiny_40x24", "source": "a test's own deployment",
        "params": {"nx": 40, "ny": 24, "max_iters": 300, "reynolds_dim": 10,
                   "density": 0.1, "accel": 0.005, "omega": 1.7},
        "mask": {"walls": True, "interior": [
            {"x": [5, 30], "y": [3, 15], "w": [1, 3], "h": [2, 6]}]},
        "reduced": []}))
    (bench / "traffic" / "again.json").write_text(json.dumps({
        "name": "again", "about": "a test's own mix"}))
    (bench / "cells" / "tiny.again.json").write_text(json.dumps({
        "scenes": 2, "limits": {"cells": 0.01, "av_vels": 0.01,
                                "reynolds": 0.01}}))
    (bench / "metrics" / "runner.total_ms.py").write_text(
        "def read(record):\n"
        "    t = [r['timings']['total'] for r in record['scenes']]\n"
        "    return 1e3 * sum(t) / len(t) if t else None\n")
    doc = json.loads((bench_copy / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_40x24", "source": "a test's own",
                           "file": "lbmbench/configs/tiny_40x24.json",
                           "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "tiny.again", "config": "tiny_40x24",
                             "traffic": "again", "chips": 1, "why": "a test"})
    doc["per_layer"].append(
        {"name": "runner.total_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "runner", "moves": "glups",
         "workloads": ["tiny.again"]})
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(doc))
    after = _digests(bench)
    assert all(after[p] == d for p, d in before.items())

    code = ("import json; from lbmbench import spec, harness\n"
            "cell = spec.resolve('tiny.again')\n"
            "for trace in (False, True):\n"
            "    r, notes, bad = harness.run_cell(cell, 99, 0.0, trace, 'cpu')\n"
            "    print(json.dumps(r))\n")
    p = run_module(["-c", code], cwd=bench_copy,
                   env_extra={"PYTHONPATH": str(REPO)})
    assert p.returncode == 0, p.stderr
    plain, traced = map(json.loads, p.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    # Every cell reports the end-to-end metrics, which name no cells.
    assert set(plain["metrics"]) == {"glups", "scene_s.p90", "setup_s"}
    assert set(traced["metrics"]) == {"runner.total_ms"}


def _no_result(p):
    return not any(line.startswith("{") for line in p.stdout.splitlines())


def test_without_a_card_the_command_exits_with_no_result():
    p = run_module(["-m", "lbmbench", "--workload", "ref256.scene",
                    "--seed", "1", "--seconds", "1", "--trace", "0"],
                   cwd=REPO, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 2 and _no_result(p), p.stderr


def test_with_only_the_benchmark_files_the_command_exits_with_no_result(
        bench_copy):
    p = run_module(["-m", "lbmbench", "--workload", "ref256.scene",
                    "--seed", "1", "--seconds", "1", "--trace", "0"],
                   cwd=bench_copy)
    assert p.returncode != 0 and _no_result(p), p.stderr
