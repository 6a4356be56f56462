"""The port's profiling module: the cost model and bounds, the roofline
report, ``--trace`` on the CPU, and the trace summary on a synthetic
Chrome trace (the twin of tests/test_tools.py's self-time accounting
check for the JAX script)."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch import profiling
from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.runner import run_simulation

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def test_cost_model_constants_are_the_documented_ones():
    """PERF.md section 3 states the cost model in words; the constants
    are its numbers, and the bounds it quotes follow from them."""
    assert profiling.BYTES_PER_CELL_PASS == 73
    assert profiling.OPS_PER_CELL_STEP == 90
    h100 = profiling.CHIP_PEAKS["h100"]
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["f32_ops_per_s"] == 67e12
    assert "data sheet" in h100["source"]
    text = re.sub(r"\s+", " ", (REPO / "PERF.md").read_text())
    assert "73 B per cell" in text and "90 operations" in text
    assert "3.35 TB/s" in text and "67 TFLOP/s" in text
    cells = 1024 * 1024
    ms, by = profiling.bound(cells, 1)
    assert by == "bytes" and round(ms * 1e3, 2) == 22.85  # us, as PERF.md
    ms, by = profiling.bound(cells, 4)
    assert by == "bytes" and round(ms * 1e3, 2) == 5.71
    ms, by = profiling.bound(cells, 100)
    assert by == "operations" and round(ms * 1e3, 2) == 1.41
    # Halo bytes add to the launch's traffic; a launch that reads no mask
    # moves 72 B a cell, and one that adds once a cell is bound by bytes.
    assert profiling.bound(cells, 1, extra_bytes=10**6)[0] > \
        profiling.bound(cells, 1)[0]
    ms, by = profiling.bound(cells, 100, bytes_per_cell=72, ops_per_cell=1)
    assert by == "bytes" and np.isclose(ms, 72 * cells / 3.35e12 / 100 * 1e3)


@pytest.mark.parametrize("kind,kwargs", [
    ("resident", {}),
    ("probe stream", {"bytes_per_cell": 72, "ops_per_cell": 1}),
])
def test_design_ceiling_of_a_kernel_resident_in_device_memory(kind, kwargs):
    """A kernel that keeps the lattice in device memory between the steps
    of a launch (resident, ring, probe) moves it once per step once both
    buffers and the mask outgrow the 50 MB L2, and once per launch while
    they fit. That is its design's ceiling; the function's bound stays
    once per launch."""
    l2 = profiling.CHIP_PEAKS["h100"]["l2_bytes"]
    assert l2 == 50e6
    b = kwargs.get("bytes_per_cell", 73)
    big, small = 1024 * 1024, 512 * 512
    assert b * big > l2 > b * small
    ms, by = profiling.design_ceiling(big, 100, **kwargs)
    assert by == "bytes" and np.isclose(ms, b * big / 3.35e12 * 1e3)
    if kind == "resident":
        assert round(ms, 5) == 0.02285  # one pass a step, as PERF.md
        assert round(profiling.bound(big, 100)[0], 5) == 0.00141
    assert profiling.bound(big, 100, **kwargs)[0] < ms
    # In L2: the bound, the launch's bytes over its steps or the operations.
    assert profiling.design_ceiling(small, 100, **kwargs) == \
        profiling.bound(small, 100, **kwargs)
    # Just either side of the L2 size.
    under, over = int(l2 // b), int(l2 // b) + 1
    assert profiling.design_ceiling(under, 100, **kwargs) == \
        profiling.bound(under, 100, **kwargs)
    ms, by = profiling.design_ceiling(over, 100, **kwargs)
    assert by == "bytes" and np.isclose(ms, b * over / 3.35e12 * 1e3)


def test_bound_of_the_depth_kernel_is_once_per_launch():
    """The depth kernel holds its D steps in shared memory: its lattice
    moves once per launch whatever the size, below the ceiling of the
    kernels that stream it every step."""
    for cells in (512 * 512, 1024 * 1024, 131072 * 128):
        for d in (2, 4, 8):
            ms, by = profiling.bound(cells, d)
            assert by == "bytes" and np.isclose(ms, 73 * cells / 3.35e12 / d * 1e3)
    assert round(profiling.bound(1024 * 1024, 4)[0], 5) == 0.00571
    assert profiling.bound(1024 * 1024, 4)[0] < \
        profiling.design_ceiling(1024 * 1024, 100)[0]


@pytest.mark.parametrize("d", [2, 4])
def test_design_ceiling_of_the_ring_counts_one_pass_per_round(d):
    """The ring steps D at a time in shared memory: above L2 its lattice
    crosses device memory once per D steps (the depth kernel's bound at
    D), in L2 once per launch; one step a pass is the default."""
    big, small = 1024 * 1024, 512 * 512
    assert profiling.design_ceiling(big, 100, steps_per_pass=d) == \
        profiling.bound(big, d)
    assert round(profiling.design_ceiling(big, 100, steps_per_pass=4)[0],
                 5) == 0.00571
    assert profiling.design_ceiling(small, 100, steps_per_pass=d) == \
        profiling.bound(small, 100)
    assert profiling.design_ceiling(big, 100, steps_per_pass=1) == \
        profiling.design_ceiling(big, 100)


@pytest.mark.parametrize("cells", [768 * 768, 1024 * 1024])
def test_design_ceiling_of_an_on_chip_form_is_its_bound(cells):
    """The on-chip forms (the resident kernel's and the ring's) hold the
    lattice in shared memory for the whole launch: the bytes move once a
    launch at any size, so the ceiling is the bound."""
    assert profiling.design_ceiling(cells, 100, on_chip=True) == \
        profiling.bound(cells, 100)
    assert profiling.design_ceiling(cells, 100, steps_per_pass=4,
                                    on_chip=True) == profiling.bound(cells, 100)


def test_kernel_names_cover_every_launch_count():
    """Each launch count (without the column modes' "_cols") has its
    kernel's name in a trace."""
    from lbm_tpu_torch.ops import fused

    names = {k.removesuffix("_cols") for k in fused.LAUNCHES}
    assert set(profiling.KERNEL_NAMES) == names
    assert profiling.KERNEL_NAMES["ring_onchip_inplace"] == "ring_onchip_kernel"


def test_roofline_report_of_a_resident_run():
    """The report holds a run against the function's bound whichever
    kernel ran it."""
    r = profiling.roofline_report(1024, 1024, 20000, 0.62, steps_per_pass=100)
    assert r["bound_by"] == "operations" and r["bound"] == "compute"
    assert np.isclose(r["ceiling_glups"], 1024 * 1024 / 0.00141e-3 / 1e9,
                      rtol=2e-3)
    assert np.isclose(r["effective_gbps"],
                      1024 * 1024 * 20000 * 73 / 100 / 0.62 / 1e9)


def test_roofline_report():
    r = profiling.roofline_report(1024, 1024, 20000, 0.45, chip="h100",
                                  steps_per_pass=4)
    cells = 1024 * 1024 * 20000
    assert np.isclose(r["glups"], cells / 0.45 / 1e9)
    assert np.isclose(r["effective_gbps"], cells * 73 / 4 / 0.45 / 1e9)
    assert np.isclose(r["hbm_utilisation"], r["effective_gbps"] * 1e9 / 3.35e12)
    assert np.isclose(r["flops_utilisation"], cells * 90 / 0.45 / 67e12)
    assert np.isclose(r["arithmetic_intensity"], 90 / (73 / 4))
    assert r["bound"] == "memory" and r["bound_by"] == "bytes"
    # The ceiling is the bound's: 1 Mcell per 5.71 us.
    assert np.isclose(r["ceiling_glups"],
                      1024 * 1024 / (profiling.bound(1024 * 1024, 4)[0] * 1e-3)
                      / 1e9)
    assert 0 < r["hbm_utilisation"] < 1
    # At G=100 the operations bound it.
    r100 = profiling.roofline_report(1024, 1024, 20000, 0.6,
                                     steps_per_pass=100)
    assert r100["bound"] == "compute" and r100["bound_by"] == "operations"
    with pytest.raises(ValueError, match="unknown chip 'v5e'; known"):
        profiling.roofline_report(1024, 1024, 10, 1.0, chip="v5e")
    with pytest.raises(ValueError, match="unknown chip"):
        profiling.bound(10, chip="a100")
    assert set(profiling.CHIP_PEAKS) == {"h100"}  # no TPU entry carried over


def test_short_kernel_names():
    short = profiling.short_kernel_name
    assert short("void (anonymous namespace)::fused_depth_kernel<4, false, "
                 "true>(float const*, float*, int)") == "fused_depth_kernel"
    assert short("(anonymous namespace)::reduce_tot_kernel(float const*, int, "
                 "float, float*)") == "reduce_tot_kernel"
    assert short("void at::native::vectorized_elementwise_kernel<4, at::"
                 "native::FillFunctor<float>>(int)") == \
        "vectorized_elementwise_kernel"
    assert short("Memcpy DtoD (Device -> Device)") == \
        "Memcpy DtoD (Device -> Device)"


def _event(name, ts, dur, cat="kernel", tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
            "ts": ts, "dur": dur}


def test_summarise_a_synthetic_trace(tmp_path):
    """Two kernels on two streams with an overlap and two gaps: launches,
    total and mean time, the busy share of the window (overlap counted
    once) and the longest gap with its neighbours."""
    depth = "void (anonymous namespace)::fused_depth_kernel<4, false, false>(float const*)"
    seam = "void (anonymous namespace)::fused_depth_kernel<4, true, false>(float const*)"
    reduce_ = "(anonymous namespace)::reduce_tot_kernel(float const*, int)"
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
        _event("aten::roll", 0.0, 500.0, cat="cpu_op", tid=1),
        _event("cudaLaunchKernel", 90.0, 5.0, cat="cuda_runtime", tid=1),
        _event(depth, 100.0, 80.0),
        _event(reduce_, 180.0, 4.0),            # back to back: no gap
        _event(seam, 200.0, 80.0),              # gap of 16 us before it
        _event(reduce_, 250.0, 10.0, tid=8),    # inside the seam kernel
        _event("Memcpy DtoD (Device -> Device)", 270.0, 20.0,
               cat="gpu_memcpy", tid=8),        # overlaps its end by 10
        _event(reduce_, 390.0, 6.0),            # gap of 100 us before it
        {"ph": "i", "name": "marker", "ts": 5.0, "pid": 0, "tid": 1},
    ]
    d = tmp_path / "trace"
    d.mkdir()
    (d / "a.trace.json").write_text(json.dumps({"traceEvents": events}))
    s = profiling.summarise(str(d))
    assert s["trace_file"].endswith("a.trace.json")
    assert profiling.launches(s) == {"fused_depth_kernel": 2,
                                     "reduce_tot_kernel": 3,
                                     "Memcpy DtoD (Device -> Device)": 1}
    by_name = {r["name"]: r for r in s["kernels"]}
    assert by_name["fused_depth_kernel"]["total_us"] == 160.0
    assert by_name["fused_depth_kernel"]["mean_us"] == 80.0
    assert by_name["fused_depth_kernel"]["variants"] == sorted([depth, seam])
    assert by_name["reduce_tot_kernel"]["total_us"] == 20.0
    assert s["kernels"][0]["name"] == "fused_depth_kernel"  # longest first
    assert s["device_events"] == 6
    assert s["window_us"] == 296.0                          # 100 .. 396
    assert s["busy_us"] == 84.0 + 90.0 + 6.0                # overlaps once
    assert np.isclose(s["busy_share"], 180.0 / 296.0)
    assert s["idle_us"] == 116.0 and s["n_idle_gaps"] == 2
    gap = s["idle_gaps"][0]
    assert gap["gap_us"] == 100.0 and gap["at_us"] == 190.0
    assert gap["after"] == "Memcpy DtoD (Device -> Device)"
    assert gap["before"] == "reduce_tot_kernel"
    assert s["idle_gaps"][1]["gap_us"] == 16.0
    assert np.isclose(by_name["reduce_tot_kernel"]["pct_busy"], 100 * 20 / 180)
    assert s["host_ops"][0] == {"name": "aten::roll", "total_us": 500.0,
                                "count": 1}
    table = profiling.format_summary(s)
    assert "fused_depth_kernel" in table and "60.81 %" in table
    assert "gap 100.0 us" in table

    # The newest trace under the directory is the one read, gzipped or not.
    import gzip
    import os

    newer = d / "sub" / "b.trace.json.gz"
    newer.parent.mkdir()
    with gzip.open(newer, "wt") as f:
        json.dump({"traceEvents": [_event(depth, 0.0, 10.0)]}, f)
    os.utime(newer, (2e9, 2e9))
    s2 = profiling.summarise(str(d))
    assert s2["trace_file"].endswith("b.trace.json.gz")
    assert s2["busy_share"] == 1.0 and s2["idle_gaps"] == []
    with pytest.raises(FileNotFoundError, match="no trace.json"):
        profiling.summarise(str(tmp_path / "empty"))


def test_trace_flag_on_the_cpu_writes_a_trace_that_summarise_reads(tmp_path,
                                                                   capsys):
    params = tmp_path / "s.params"
    params.write_text("32\n16\n6\n10\n0.1\n0.005\n1.85\n")
    write_obstacles(tmp_path / "o.dat", generate_obstacles(32, 16))
    tdir = tmp_path / "trace"
    rc = tcli.main([str(params), str(tmp_path / "o.dat"), "--device", "cpu",
                    "--trace", str(tdir), "--av-vels-file",
                    str(tmp_path / "av.dat"), "--final-state-file",
                    str(tmp_path / "fs.dat")])
    assert rc == 0
    files = list(tdir.glob("*.trace.json"))
    assert len(files) == 1
    s = profiling.summarise(str(tdir))
    # No card: no device rows, and the host rows show the plain steps.
    assert s["kernels"] == [] and s["busy_share"] is None
    assert s["device_events"] == 0
    rolls = [r for r in s["host_ops"] if r["name"] == "aten::roll"]
    # Every step rolls its moving speeds (a two-axis roll shows as nested
    # aten::roll events, so only the per-step multiple is fixed).
    assert rolls and rolls[0]["count"] >= 6 * 8
    assert rolls[0]["count"] % 6 == 0
    assert "no device events" in profiling.format_summary(s)
    # Tracing changes nothing the run computes.
    p = Params(nx=32, ny=16, max_iters=6, reynolds_dim=10, density=0.1,
               accel=0.005, omega=1.85)
    mask = generate_obstacles(32, 16)
    a = run_simulation(p, mask, device="cpu")
    b = run_simulation(p, mask, device="cpu", trace_dir=tmp_path / "t2",
                       chunk_iters=4)
    np.testing.assert_array_equal(a.cells, b.cells)
    np.testing.assert_array_equal(a.av_vels, b.av_vels)
    assert len(list((tmp_path / "t2").glob("*.trace.json"))) == 1


def test_trace_report_script(tmp_path, capsys):
    """scripts/trace_report_torch.py summarises a directory and writes the
    JSON report; --capture without a card fails as the run does."""
    spec = importlib.util.spec_from_file_location(
        "trace_report_torch", REPO / "scripts" / "trace_report_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    d = tmp_path / "trace"
    d.mkdir()
    (d / "a.trace.json").write_text(json.dumps({"traceEvents": [
        _event("void (anonymous namespace)::ring_kernel<false>(int)", 0, 50.0),
        _event("void (anonymous namespace)::ring_kernel<false>(int)", 60, 50.0),
    ]}))
    out = tmp_path / "report" / "r.json"
    assert script.main([str(d), "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "ring_kernel" in text and "busy 100.0 us" in text
    report = json.loads(out.read_text())
    assert report["kernels"][0]["launches"] == 2
    assert np.isclose(report["busy_share"], 100 / 110)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            script.main([str(tmp_path / "t"), "--capture", "--iters", "2"])
