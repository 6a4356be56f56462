"""CPU smoke tests of the port's harness scripts (``scripts/*_torch.py``)
on a 64x64 scene with ``--device cpu``, as tests/test_tools.py has for
the JAX package's scripts, and the fail-closed rule of the two drift
gates: a row whose drift metric is missing fails the script."""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
if str(SCRIPTS) not in sys.path:
    sys.path.insert(0, str(SCRIPTS))

import full_scenes_torch  # noqa: E402
import sweep_torch  # noqa: E402
import validate_scenes_torch  # noqa: E402


def _script(name, *args):
    return subprocess.run([sys.executable, str(SCRIPTS / name), *args],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=600)


def test_validate_scenes_generated(tmp_path):
    out = tmp_path / "v.json"
    res = _script("validate_scenes_torch.py", "--scenes", "64x64", "--device",
                  "cpu", "--kernel", "reference", "-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    data = json.loads(out.read_text())
    assert data["ok"] is True and data["drift_budget_pct"] == 0.3
    assert [r["association"] for r in data["scenes"]] == \
        ["fast", "reference_assoc"]
    for r in data["scenes"]:
        assert r["pass"] is True and r["scene_source"] == "generated"
        assert r["truth"] == "port plain float64 on cpu"
        assert 0 <= r["margin_vs_budget"] < 1
        assert r["plan"] == "kernel: reference on cpu (float32)"


def test_validate_scenes_from_a_scene_dir(tmp_path):
    from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles

    scenes = tmp_path / "scenes"
    scenes.mkdir()
    (scenes / "input_64x64.params").write_text(
        "64\n64\n40\n10\n0.1\n0.005\n1.85\n")
    write_obstacles(scenes / "obstacles_64x64.dat", generate_obstacles(64, 64))
    out = tmp_path / "v.json"
    rc = validate_scenes_torch.main(
        ["--scenes", "64x64", "--scene-dir", str(scenes), "--device", "cpu",
         "--kernel", "reference", "-o", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())["scenes"]
    assert {r["scene_source"] for r in rows} == {str(scenes)}


def test_validate_scenes_fails_closed_on_a_missing_metric(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(validate_scenes_torch, "max_pct",
                        lambda ref, sim: None)
    out = tmp_path / "v.json"
    rc = validate_scenes_torch.main(
        ["--scenes", "64x64", "--device", "cpu", "--kernel", "reference",
         "-o", str(out)])
    assert rc == 1
    data = json.loads(out.read_text())
    assert data["ok"] is False
    for r in data["scenes"]:
        assert r["pass"] is False and "missing drift metric" in r["error"]


def test_full_scenes_smoke_and_fail_closed(tmp_path, monkeypatch):
    out = tmp_path / "f.json"
    res = _script("full_scenes_torch.py", "--scenes", "64x64", "--iters", "30",
                  "--device", "cpu", "-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    (row,) = json.loads(out.read_text())["scenes"]
    assert row["pass"] is True and row["iters"] == 30
    for k in full_scenes_torch.METRICS:
        assert row[k] == 0.0  # the same plain path on the CPU
    for leg in ("auto", "plain"):
        assert {"reynolds", "compute_seconds", "wall_seconds", "glups",
                "plan"} <= set(row[leg])
    monkeypatch.setattr(full_scenes_torch, "max_pct",
                        lambda ref, sim: float("nan"))
    assert full_scenes_torch.main(
        ["--scenes", "64x64", "--iters", "30", "--device", "cpu", "-o",
         str(out)]) == 1
    (row,) = json.loads(out.read_text())["scenes"]
    assert row["pass"] is False and "missing drift metric" in row["error"]


@pytest.mark.parametrize("row,ok", [
    ({"a": 0.1, "b": 0.29}, True),
    ({"a": 0.1, "b": 0.31}, False),
    ({"a": 0.1}, False),
    ({"a": 0.1, "b": None}, False),
    ({"a": float("nan"), "b": 0.0}, False),
    ({"a": float("inf"), "b": 0.0}, False),
])
def test_the_gate_judges_every_metric(row, ok):
    got = validate_scenes_torch.judge(dict(row), ("a", "b"), 0.3)
    assert got["pass"] is ok
    if "margin_vs_budget" in got:
        assert got["margin_vs_budget"] == pytest.approx(
            max(row.values()) / 0.3)
    else:
        assert not ok


def test_sweep_rows_feed_the_scaling_script(tmp_path):
    out = tmp_path / "s.json"
    res = _script("sweep_torch.py", "--grids", "64x64", "--kernels", "auto",
                  "reference", "--shards", "1", "2", "--iters", "10",
                  "--repeats", "1", "--device", "cpu", "-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    rows = json.loads(out.read_text())
    assert len(rows) == 4
    for r in rows:
        assert {"grid", "kernel", "devices", "iters", "seconds", "glups",
                "backend"} <= set(r)
        assert r["backend"] == "cpu" and r["mode"] == "functional-not-hardware"
    res = subprocess.run([sys.executable, str(SCRIPTS / "scaling.py"),
                          str(out)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert "64x64 [auto@cpu, functional-not-hardware]" in res.stdout
    assert "(2, " in res.stdout


def test_sweep_records_a_failed_cell_and_exits_non_zero(tmp_path):
    out = tmp_path / "s.json"
    res = _script("sweep_torch.py", "--grids", "64x64", "--kernels", "cuda",
                  "--iters", "10", "--repeats", "1", "--device", "cpu",
                  "-o", str(out))
    assert res.returncode == 1
    (row,) = json.loads(out.read_text())
    assert "needs a CUDA device" in row["error"]


def test_measure_restores_the_knobs(monkeypatch):
    monkeypatch.setenv("LBM_PAIRED_EQ", "0")
    monkeypatch.delenv("LBM_OMEGA_EQ", raising=False)
    m = sweep_torch.measure(64, 64, 8, "reference", {"LBM_OMEGA_EQ": "1"},
                            repeats=1, device="cpu")
    assert m["backend"] == "cpu" and m["repeats"] == 1 and m["seconds"] > 0
    import os

    assert os.environ["LBM_PAIRED_EQ"] == "0"
    assert "LBM_OMEGA_EQ" not in os.environ
    with pytest.raises(ValueError, match="not a knob"):
        sweep_torch.measure(64, 64, 8, "reference", {"LBM_FOO": "1"},
                            repeats=1, device="cpu")


def test_sharded_overhead_smoke(tmp_path):
    out = tmp_path / "o.json"
    res = _script("sharded_overhead_torch.py", "--grids", "64x64", "--iters",
                  "10", "--repeats", "1", "--device", "cpu", "-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    (row,) = json.loads(out.read_text())["cases"]
    assert row["sharded_1"]["plan"].startswith("1 shards of 64 rows")
    assert np.isfinite(row["overhead_pct"])


def test_ab_kernel_lines_and_its_knobs():
    res = _script("ab_kernel_torch.py", "--device", "cpu", "--kernel",
                  "reference", "--repeats", "1", "--turns", "2",
                  "a:64:64:10", "b:64:64:10:LBM_OMEGA_EQ=1")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(line) for line in res.stdout.splitlines()]
    assert [(r["name"], r["turn"]) for r in lines] == \
        [("a", 1), ("b", 1), ("b", 2), ("a", 2)]
    assert lines[1]["env"] == {"LBM_OMEGA_EQ": "1"}
    assert all(r["ms_per_step"] > 0 for r in lines)
    res = _script("ab_kernel_torch.py", "--device", "cpu",
                  "x:64:64:10:LBM_PALLAS_SLOT_BYTES=1")
    assert res.returncode != 0 and "not a knob of the port" in res.stderr


def test_writer_ab_smoke(tmp_path):
    out = tmp_path / "w.json"
    res = _script("writer_ab_torch.py", "--grids", "64x64", "-o", str(out))
    assert res.returncode == 0, res.stdout + res.stderr
    (row,) = json.loads(out.read_text())["rows"]
    assert row["equal_bytes"] and row["lines"] == 64 * 64
    assert len(row["exact_s"]) == len(row["printf_s"]) == 2
    assert row["best_printf_s"] > 0 and row["best_exact_s"] > 0


def test_plot_roofline_plots_card_rows_only(tmp_path):
    rows = [{"grid": "1024x1024", "kernel": "auto", "devices": 1,
             "iters": 100, "seconds": 0.01, "glups": 50.0, "backend": "cuda",
             "steps_per_pass": 4},
            {"grid": "64x64", "kernel": "auto", "devices": 1, "iters": 100,
             "seconds": 0.01, "glups": 0.001, "backend": "cpu",
             "mode": "functional-not-hardware"}]
    f = tmp_path / "sweep.json"
    f.write_text(json.dumps(rows))
    out = tmp_path / "roofline.png"
    res = _script("plot_roofline_torch.py", str(f), "-o", str(out))
    assert res.returncode == 0, res.stderr
    assert out.stat().st_size > 0 and "1 points, 1 rows left out" in res.stdout
    f.write_text(json.dumps(rows[1:]))
    res = _script("plot_roofline_torch.py", str(f), "-o", str(out))
    assert res.returncode == 1


def test_validate_scenes_fails_a_row_whose_cli_failed(tmp_path):
    """``--repo`` at a directory without the package: every CLI run
    fails, and so does every row and the script."""
    out = tmp_path / "v.json"
    rc = validate_scenes_torch.main(
        ["--scenes", "256x256", "--device", "cpu", "--repo", str(tmp_path),
         "-o", str(out)])
    assert rc == 1
    rows = json.loads(out.read_text())["scenes"]
    assert len(rows) == 2
    for r in rows:
        assert r["pass"] is False and r["repo"] == str(tmp_path)
        assert "No module named lbm_tpu_torch" in r["error"]


def test_u_is_held_by_its_largest_difference_over_its_peak():
    """check.py's per-cell ratio is infinite where one leg's |u| is 0 and
    the other's is its last bit; the share of the peak is not."""
    ref = np.array([0.0, 0.02, 0.04, 1e-45])
    sim = np.array([1e-45, 0.02, 0.04002, 0.0])
    assert validate_scenes_torch.max_pct(ref, sim) == np.inf
    assert full_scenes_torch.pct_of_peak(ref, sim) == pytest.approx(0.05)
    assert full_scenes_torch.pct_of_peak(np.zeros(3), np.zeros(3)) is None
    assert full_scenes_torch.pct_of_peak(ref, sim[:2]) is None


@pytest.mark.parametrize("bufs, schedule", [
    (1, "one split barrier a wave, tagged words"), (2, "tagged words")])
def test_onchip_clocks_patches_hold_on_the_strip_step(bufs, schedule):
    """scripts/onchip_clocks_torch.py instruments the strip step that
    lbm_onchip.cuh holds in ``bufs`` buffers: it names one schedule of
    them, and every patch of it (the shared ones and the schedule's)
    occurs there exactly once, so a change to the strip step breaks this
    test and not the instrument; its marks cover every category but the
    whole step."""
    import onchip_clocks_torch as clocks

    text = (REPO / "lbm_tpu_torch" / "csrc" / "lbm_onchip.cuh").read_text()
    name = clocks.schedule_of(text, bufs)
    assert name == schedule
    for old, _ in clocks.patches(name):
        assert text.count(old) == 1, old
    _, patched = clocks.instrument(text, bufs)
    marks = {int(q) for q in re.findall(r"CKW?\((\d+)\)", patched)}
    n = len(clocks.SCHEDULES[name]["categories"])
    assert marks == set(range(n - 1))
    assert f"kBufs == {bufs} && threadIdx.x == 0" in patched


def test_shift_clocks_patches_hold_on_the_shift_step():
    """scripts/shift_clocks_torch.py instruments the shift mode's step that
    lbm_rounds.cuh holds: it names one schedule, every patch of it occurs
    there exactly once, and its marks cover every category of the clocked
    thread's step."""
    import shift_clocks_torch as clocks

    text = (REPO / "lbm_tpu_torch" / "csrc" / "lbm_rounds.cuh").read_text()
    name = clocks.schedule_of(text)
    assert name == ("owned tiles, neighbour counters, a rim group (shared "
                    "residence)")
    for old, _ in clocks._HEAD + clocks.SCHEDULES[name]["patches"]:
        assert text.count(old) == 1, old
    _, patched = clocks.instrument(text)
    marks = {int(q) for q in re.findall(r"CK\((\d+)\)", patched)}
    categories = clocks.SCHEDULES[name]["categories"]
    assert marks == {i for i, c in enumerate(categories)
                     if c != "step" and not c.startswith("thread 0")
                     and not c.endswith("(ns)")}


def test_coherence_mutant_applies_to_the_shift_mode():
    """scripts/coherence_mutant_torch.py's mutations each occur exactly
    once in lbm_rounds.cuh (the shift mode's neighbour loads)."""
    import coherence_mutant_torch as mutant

    text = (REPO / "lbm_tpu_torch" / "csrc" / "lbm_rounds.cuh").read_text()
    for old, new in mutant.MUTATIONS:
        assert text.count(old) == 1, old
        assert "__ldg" in new


def test_coherence_mutant_applies_to_the_halo_poll():
    """scripts/coherence_mutant_torch.py's weak-poll mutations each occur
    exactly once in lbm_onchip.cuh (the strip step's halo word loads, one
    a scope), and each turns a relaxed strong load into a weak one."""
    import coherence_mutant_torch as mutant

    source, mutations = mutant.MUTANTS["weak_poll"]
    text = (REPO / "lbm_tpu_torch" / "csrc" / source).read_text()
    assert len(mutations) == 2
    for old, new in mutations:
        assert text.count(old) == 1, old
        assert "relaxed" in old and "relaxed" not in new


def test_trace_drops_matches_launches_to_kernels(tmp_path):
    """scripts/trace_drops_torch.py pairs each host launch with its kernel
    by correlation id: the launches left without one are listed by launch
    order, and the skew is the first kernel's start less the first
    launch's."""
    import trace_drops_torch

    def ev(name, cat, ts, corr):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": 5.0,
                "pid": 0, "tid": 1, "args": {"correlation": corr}}

    events = [ev("cudaLaunchKernel", "cuda_runtime", 100.0 + 10 * i, i)
              for i in range(5)]
    # The first two kernels fell before the window and are not in it.
    events += [ev("fused_depth_kernel", "kernel", 80.0 + 10 * i, i)
               for i in range(2, 5)]
    events.append(ev("cudaMemcpyAsync", "cuda_runtime", 50.0, 99))
    d = tmp_path / "t"
    d.mkdir()
    (d / "x.trace.json").write_text(json.dumps({"traceEvents": events}))
    got = trace_drops_torch.drops(str(d))
    assert got == {"launches": 5, "kernels": 3, "dropped": [0, 1],
                   "skew_us": 0.0}
    res = _script("trace_drops_torch.py", "--reps", "1")
    assert res.returncode != 0 and "needs a CUDA device" in res.stderr


def test_mxu_ab_variants_apply_to_the_tree():
    """scripts/mxu_ab_torch.py's variants of the tensor-core kernel: each
    replacement occurs exactly once in its source, and the 3xTF32 ones
    replace the f64 product with tf32 products."""
    import mxu_ab_torch as ab

    assert set(ab.VARIANTS) == {"tf32x3", "tf32x3-2"}
    for name, replacements in ab.VARIANTS.items():
        for source, old, new in replacements:
            text = (REPO / "lbm_tpu_torch" / "csrc" / source).read_text()
            assert text.count(old) == 1, (name, source)
            if source == "lbm_depth.cuh":
                assert "f64" in old and "f64" not in new
                assert new.count(".tf32.tf32.f32") == 1
