"""The coursework's 16384x1024 stress scene as the benchmark runs it
(``lbmbench`` cell ``stress16384.scene``), on the CPU: its configuration's
scenes, the plan its ``why`` names, the runner's rest state built in the
transposed layout, the layout's spans and counters, the cell's per-layer
readers, and a cut-down scene of the same recipe against the benchmark's
float64 reference under the cell's own limits."""

import numpy as np
import pytest
import torch

from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.state import initial_state, transpose_state
from lbmbench import compare, reference, scenes, spec

torch.set_num_threads(2)

CELL = "stress16384.scene"
SEED = 2**31 + 24


def _cell():
    return spec.resolve(CELL)


def _small(nx=256, ny=16, iters=400):
    """The cell's configuration at a CPU size: the same parameters and
    mask recipe, the column drawn from [nx/8, 7nx/8]."""
    config = _cell().config
    config["params"].update(nx=nx, ny=ny, max_iters=iters)
    config["mask"]["interior"] = [{"x": [nx // 8, 7 * nx // 8], "y": [0, 0],
                                   "w": [1, 1], "h": [ny, ny]}]
    return config


def _params(scene):
    return Params(nx=scene.nx, ny=scene.ny, max_iters=scene.iters,
                  reynolds_dim=scene.reynolds_dim,
                  density=np.float32(scene.density),
                  accel=np.float32(scene.accel),
                  omega=np.float32(scene.omega))


def _on_cpu_transposed(monkeypatch):
    """The planned ``cuda`` path on CPU tensors, every wrapper's plain
    version, with the wide-grid layout below the card's size rule."""
    monkeypatch.setattr(trunner, "_resolve_kernel", lambda k, p, d: k)
    monkeypatch.setattr(plan, "transposed_layout",
                        lambda ny, nx: nx >= 2 * ny and nx % 8 == 0)


def test_the_configuration_is_the_published_scene():
    cell = _cell()
    assert cell.workload["chips"] == 1
    assert cell.config["params"] == {
        "nx": 16384, "ny": 1024, "max_iters": 20000, "reynolds_dim": 10,
        "density": 0.1, "accel": 0.01, "omega": 1.85}
    assert cell.config["precision"] == "float32"
    assert cell.config["reduced"] == []
    assert cell.check["scenes"] == 1


def test_the_pool_is_walls_and_one_seeded_full_height_column():
    config = _cell().config
    nx, ny = 16384, 1024
    xs = set()
    for i in range(3):
        scene = scenes.make_scene(config, SEED, i)
        mask = scene.mask
        assert mask.shape == (ny, nx)
        assert mask[0].all() and mask[-1].all()
        assert mask[:, 0].all() and mask[:, -1].all()
        inner = mask[1:-1, 1:-1]
        cols = np.flatnonzero(inner.any(axis=0)) + 1
        assert len(cols) == 1 and inner[:, cols[0] - 1].all()
        assert 2048 <= cols[0] <= 14336
        # 34812 wall cells and 1022 of the column: 0.2136 % of the grid.
        assert mask.sum() == 35834
        assert mask.sum() / mask.size == pytest.approx(0.0021359, rel=1e-4)
        np.testing.assert_array_equal(
            scenes.make_scene(config, SEED, i).mask, mask)
        xs.add(int(cols[0]))
    assert len(xs) > 1
    assert not np.array_equal(scenes.make_scene(config, SEED + 1, 0).mask,
                              scenes.make_scene(config, SEED, 0).mask)


def test_the_cell_plans_the_transposed_depth_kernel():
    p = _params(scenes.make_scene(_small(16384, 1024, 20000), SEED, 0))
    assert plan.layout(p) == (True, 16384, 1024)
    segs = trunner.plan_run(p, "cuda", 20000)
    assert segs == [plan.Segment("depth", 4, 20000)]
    assert segs[0].launches == 5000


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_the_rest_state_in_the_transposed_layout_is_bit_identical(dtype):
    p = Params(nx=48, ny=16, max_iters=10, reynolds_dim=10, density=0.1,
               accel=0.01, omega=1.85, dtype=dtype)
    want = transpose_state(initial_state(p))
    got = initial_state(p, transposed=True)
    assert got.shape == (9, 48, 16) and got.dtype == want.dtype
    assert got.is_contiguous() and torch.equal(got, want)


def test_a_run_from_rest_transposes_only_at_collate(monkeypatch, tmp_path):
    """From rest, the run builds its lattice transposed and transposes
    once, at collate; resumed from a lattice, at init too; both give the
    bits of the physical rest state handed to ``simulate``."""
    _on_cpu_transposed(monkeypatch)
    scene = scenes.make_scene(_small(64, 16, 24), SEED, 0)
    p, mask = _params(scene), scene.mask
    rest = trunner.run_simulation(p, mask, kernel="cuda", device="cpu")
    t = rest.timings
    assert "collate.transpose" in t and "init.transpose" not in t
    assert 0 < t["collate.transpose"] <= t["collate"]
    assert "transpose.device" not in t
    cells, av = trunner.simulate(p, initial_state(p), torch.from_numpy(mask),
                                 kernel="cuda")
    assert torch.equal(torch.from_numpy(rest.cells), cells)
    assert torch.equal(torch.from_numpy(rest.av_vels), av)

    path = tmp_path / "rest.npz"
    trunner.save_checkpoint(path, 0, initial_state(p).numpy(),
                            np.zeros(0, np.float32))
    resumed = trunner.run_simulation(p, mask, kernel="cuda", device="cpu",
                                     resume_from=path)
    t = resumed.timings
    assert 0 < t["init.transpose"] <= t["init"]
    assert 0 < t["collate.transpose"] <= t["collate"]
    np.testing.assert_array_equal(resumed.cells, rest.cells)


@pytest.mark.parametrize("kernel", ["auto", "cuda"])
def test_the_copy_bytes_and_no_device_transpose_on_the_cpu(kernel,
                                                           monkeypatch):
    if kernel == "cuda":
        _on_cpu_transposed(monkeypatch)
    scene = scenes.make_scene(_small(64, 16, 12), SEED, 1)
    r = trunner.run_simulation(_params(scene), scene.mask, kernel=kernel,
                               device="cpu")
    t = r.timings
    assert t["collate.copy.bytes"] == 9 * 16 * 64 * 4 == r.cells.nbytes
    assert type(t["collate.copy.bytes"]) is int
    assert t["compute.launches.cols"] == 0
    assert "transpose.device" not in t
    # auto on the CPU is the plain path, which never transposes.
    assert ("collate.transpose" in t) == (kernel == "cuda")


@pytest.mark.parametrize("kernel", ["auto", "cuda"])
def test_a_cut_down_scene_is_inside_the_cells_limits(kernel, monkeypatch):
    """256x16, 400 steps of the cell's recipe against the benchmark's
    float64 reference, under ``stress16384.scene``'s limits: the plain
    path (``auto`` on the CPU), and the planned path's plain versions in
    column mode on the transposed lattice."""
    scene = scenes.make_scene(_small(), SEED, 2)
    p = _params(scene)
    if kernel == "cuda":
        _on_cpu_transposed(monkeypatch)
        assert plan.layout(p)[0]
    r = trunner.run_simulation(p, scene.mask, kernel=kernel, device="cpu")
    ref = reference.run([scene], torch.float64, "cpu")[0]
    gaps = compare.gaps(scene, r.cells, r.av_vels, r.reynolds, ref)
    limits = _cell().check["limits"]
    assert compare.verdict(gaps, limits), (gaps, limits)


def _record(timings, iters=20000, trace=None):
    return {"cell": CELL, "scenes": [
        {"nx": 16384, "ny": 1024, "iters": iters, "wall_s": 6.0,
         "timings": t} for t in timings], "launches": None, "trace": trace}


SCENES = [{"collate.copy": 0.1, "collate.copy.bytes": 603979776,
           "transpose.device": 0.002, "compute.launches.cols": 5000},
          {"collate.copy": 0.08, "collate.copy.bytes": 603979776,
           "transpose.device": 0.004, "compute.launches.cols": 5000}]
TRACE = {"window_s": 20.0, "busy_s": 19.5, "kernel_s": 19.4,
         "device_events": 100,
         "device_ops": [["fused_depth_kernel", 12.0],
                        ["Memcpy DtoH (Device -> Pageable)", 0.3]],
         "idle_gaps": [["lbm.collate", 0.2]]}


def test_the_five_readers_on_a_synthetic_record():
    read = {m: spec.reader(m) for m in (
        "runner.transpose_ms", "runner.copy_gbps",
        "planner.cols_launches_per_kstep", "kernels.depth_cols_roofline",
        "device.wide_idle_pct")}
    rec = _record(SCENES, trace=TRACE)
    assert read["runner.transpose_ms"](rec) == pytest.approx(3.0)
    assert read["runner.copy_gbps"](rec) == pytest.approx(
        2 * 603979776 / 0.18 / 1e9)
    assert read["planner.cols_launches_per_kstep"](rec) == pytest.approx(250)
    # 90 x 16.8 M x 20000 / 67e12 a scene, over 12 s for two.
    least = 2 * 90 * 16384 * 1024 * 20000 / 67e12
    assert read["kernels.depth_cols_roofline"](rec) == pytest.approx(
        100 * least / 12.0)
    assert read["device.wide_idle_pct"](rec) == pytest.approx(2.5)
    assert read["device.wide_idle_pct"](rec) == spec.reader(
        "device.idle_pct")(rec)
    # A program without the counters (the parent of this change): the
    # three that read them find nothing; no trace, none of the five.
    bare = _record([{"collate.copy": 0.1}], trace=TRACE)
    for m in ("runner.transpose_ms", "runner.copy_gbps",
              "planner.cols_launches_per_kstep"):
        assert read[m](bare) is None
    no_depth = dict(TRACE, device_ops=[["resident_onchip_kernel", 12.0]])
    assert read["kernels.depth_cols_roofline"](
        _record(SCENES, trace=no_depth)) is None
    for m in ("kernels.depth_cols_roofline", "device.wide_idle_pct"):
        assert read[m](_record(SCENES)) is None
    for r in read.values():
        assert r({"cell": CELL, "scenes": [], "launches": None,
                  "trace": None}) is None


def test_the_cell_reads_four_layers_and_its_metrics():
    cell = _cell()
    names = {m["name"] for m in cell.per_layer}
    assert names == {"runner.transpose_ms", "runner.copy_gbps",
                     "planner.cols_launches_per_kstep",
                     "kernels.depth_cols_roofline", "device.wide_idle_pct"}
    assert {m["layer"] for m in cell.per_layer} == {
        "runner", "planner", "kernels", "device"}
    for other in ("ref1024.scene", "ref256.scene"):
        assert "runner.copy_gbps" in {
            m["name"] for m in spec.resolve(other).per_layer}
