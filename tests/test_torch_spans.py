"""The runner's spans and counters: each phase of ``run_simulation`` a
``torch.profiler`` span ``lbm.<phase>`` while a profiler records, each
planned segment's launch loop a span ``lbm.segment.<kernel>`` with the
plan in its args, the phases' seconds and the collate copy's page faults
in ``timings``, and every kernel launch through the one launch helper
(``ops.fused.launch``). On the CPU: the ``cuda`` path runs every wrapper's
plain version, so it plans and loops as on the card and launches
nothing."""

import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lbm_tpu_torch import profiling
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import _build, fused
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

PACKAGE = Path(trunner.__file__).resolve().parent
ITERS = 30
PHASES = {"lbm.init": "lbm.init.plan", "lbm.collate": "lbm.collate.copy"}


def _scene(iters=ITERS):
    p = Params(nx=64, ny=32, max_iters=iters, reynolds_dim=10,
               density=0.1, accel=0.005, omega=1.85)
    return p, generate_obstacles(p.nx, p.ny)


def _on_cpu(monkeypatch):
    """The planned ``cuda`` path on CPU tensors."""
    monkeypatch.setattr(trunner, "_resolve_kernel", lambda k, p, d: k)


def _traced(tmp_path, *runs):
    """Each ``runs`` callable under one CPU profiler; returns the calls'
    results, the trace's ``lbm.*`` events in time order and its metadata
    of span args (``lbm.span.<k>``) in the order the spans opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        results = [run() for run in runs]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = sorted((e for e in data["traceEvents"] if e.get("ph") == "X"
                     and e.get("name", "").startswith("lbm.")),
                    key=lambda e: (e["ts"], -e["dur"]))
    args = [data[k] for k in sorted(
        (k for k in data if k.startswith("lbm.span.")),
        key=lambda k: int(k.rsplit(".", 1)[1]))]
    return results, events, args


def _inside(child, parent) -> bool:
    return (parent["ts"] <= child["ts"] and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"])


@pytest.fixture
def two_runs(tmp_path, monkeypatch):
    """Two planned runs on the CPU under one profiler: whole, then in
    7-step chunks."""
    _on_cpu(monkeypatch)
    p, mask = _scene()
    return _traced(
        tmp_path,
        lambda: trunner.run_simulation(p, mask, kernel="cuda", device="cpu"),
        lambda: trunner.run_simulation(p, mask, kernel="cuda", device="cpu",
                                       chunk_iters=7))


def _runs(events, args):
    """The spans of each run as ``{n: [(event, args string), ...]}``: the
    trace's ``lbm.*`` events in the order they open, each beside the args
    its span wrote, joined by that order and checked by name."""
    assert len(events) == len(args)
    by_run = {}
    for e, a in zip(events, args):
        name, rest = a.split(" ", 1)
        assert name == e["name"] and rest.startswith("run=")
        n = int(rest.split()[0].removeprefix("run="))
        by_run.setdefault(n, []).append((e, rest))
    return by_run


def test_every_phase_is_a_user_annotation_inside_its_parent(two_runs):
    (whole, _), events, args = two_runs
    runs = _runs(events, args)
    assert len(runs) == 2
    for spans in runs.values():
        assert all(e["cat"] == "user_annotation" for e, _ in spans)
        named = {}
        for e, _ in spans:
            named.setdefault(e["name"], []).append(e)
        assert set(named) >= {"lbm.init", "lbm.init.plan", "lbm.compute",
                              "lbm.collate", "lbm.collate.copy"}
        for parent, child in PHASES.items():
            assert len(named[parent]) == len(named[child]) == 1
            assert _inside(named[child][0], named[parent][0])
        segs = [e for name, es in named.items()
                if name.startswith("lbm.segment.") for e in es]
        assert segs and all(_inside(e, named["lbm.compute"][0])
                            for e in segs)
        # Every span of the run lies in order: init, compute, collate.
        order = [named[k][0]["ts"] for k in
                 ("lbm.init", "lbm.compute", "lbm.collate")]
        assert order == sorted(order)
    assert whole.timings["compute.wrappers"] > 0


def test_one_segment_span_a_planned_segment_with_its_plan(two_runs):
    _, events, args = two_runs
    first = _runs(events, args)[min(_runs(events, args))]
    segs = [(e["name"], a) for e, a in first
            if e["name"].startswith("lbm.segment.")]
    p, _ = _scene()
    plan = trunner.plan_run(p, "cuda", ITERS, device=torch.device("cpu"))
    assert len(segs) == len(plan) >= 2
    for (name, a), seg in zip(segs, plan):
        assert name == f"lbm.segment.{seg.kernel}"
        assert a.split(" ", 1)[1] == (
            f"kernel={seg.kernel} steps_per_call={seg.steps_per_call} "
            f"form={seg.form or '-'} steps={seg.steps}")


def test_a_chunked_run_has_one_segment_span_a_chunk_and_segment(two_runs):
    _, events, args = two_runs
    runs = _runs(events, args)
    chunked = runs[max(runs)]
    p, _ = _scene()
    want = []
    for n in [7, 7, 7, 7, 2]:
        for seg in trunner.plan_run(p, "cuda", n, device=torch.device("cpu")):
            want.append(f"lbm.segment.{seg.kernel} steps={seg.steps}")
    got = [f"{e['name']} {a.split()[-1]}" for e, a in chunked
           if e["name"].startswith("lbm.segment.")]
    assert got == want
    assert [e["name"] for e, _ in chunked].count("lbm.compute") == 1


def test_each_run_has_its_own_number(two_runs):
    _, events, args = two_runs
    runs = _runs(events, args)
    assert len(runs) == 2
    a, b = sorted(runs)
    assert b > a > 0


def test_without_a_profiler_no_span_is_entered(monkeypatch):
    _on_cpu(monkeypatch)
    entered = []

    class Counted:
        def __init__(self, *args):
            entered.append(args)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    monkeypatch.setattr(torch.autograd, "_add_metadata_json",
                        lambda *a: entered.append(a))
    p, mask = _scene()
    r = trunner.run_simulation(p, mask, kernel="cuda", device="cpu",
                               chunk_iters=7)
    assert not entered
    assert {"init.plan", "compute.wrappers", "collate.copy"} <= set(r.timings)


def test_the_wrapper_path_records_every_key(monkeypatch):
    _on_cpu(monkeypatch)
    p, mask = _scene()
    r = trunner.run_simulation(p, mask, kernel="cuda", device="cpu")
    assert set(r.timings) == {"init", "init.plan", "compute",
                              "compute.wrappers", "collate", "collate.copy",
                              "collate.copy.minflt", "collate.copy.bytes",
                              "compute.launches.cols", "total"}
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(r.cells, base.cells)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_children_never_exceed_their_parents(kernel, monkeypatch):
    _on_cpu(monkeypatch)
    p, mask = _scene()
    t = trunner.run_simulation(p, mask, kernel=kernel, device="cpu",
                               chunk_iters=11).timings
    assert 0 < t["init.plan"] <= t["init"]
    assert 0 < t["collate.copy"] <= t["collate"]
    assert t["init"] + t["compute"] + t["collate"] <= t["total"]
    if kernel == "cuda":
        assert 0 <= t["compute.wrappers"] <= t["compute"]
    else:
        assert "compute.wrappers" not in t


def test_the_copy_counts_its_minor_page_faults(monkeypatch):
    p, mask = _scene()
    faults = iter([1000, 1300])
    monkeypatch.setattr(trunner, "_minor_faults", lambda: next(faults))
    t = trunner.run_simulation(p, mask, kernel="reference",
                               device="cpu").timings
    assert t["collate.copy.minflt"] == 300
    monkeypatch.undo()
    t = trunner.run_simulation(p, mask, kernel="reference",
                               device="cpu").timings
    assert type(t["collate.copy.minflt"]) is int
    assert t["collate.copy.minflt"] >= 0


def test_wrappers_time_leaves_out_the_launch_calls():
    """A wrapper whose launch call takes 2 ms: ``compute.wrappers`` is the
    calls' host time less the launch helper's, so at most the wrappers'
    own time plus the loop's."""
    p, mask = _scene()
    timers = profiling.PhaseTimers()
    sim = trunner._Simulation(p, initial_state(p), torch.from_numpy(mask),
                              "cuda", ITERS, timers=timers)
    run_ns, entry_ns = [], []

    def entry():
        t0 = time.perf_counter_ns()
        time.sleep(0.002)
        entry_ns.append(time.perf_counter_ns() - t0)
        return 0

    for impl in sim._kernels.values():
        def run(*args, _run=impl.run):
            t0 = time.perf_counter_ns()
            fused.launch(None, "depth", "a test's launch", entry)
            out = _run(*args)
            run_ns.append(time.perf_counter_ns() - t0)
            return out
        impl.run = run
    launches = fused.LAUNCHES["depth"]
    sim.run_chunk(0, ITERS)
    assert fused.LAUNCHES["depth"] - launches == len(run_ns) == sum(
        seg.launches for seg in sim.segments) == 8
    own = timers.elapsed["compute.wrappers"]
    assert 0 <= own <= (sum(run_ns) - 0.5 * sum(entry_ns)) * 1e-9


def test_spans_close_where_the_run_raises(tmp_path, monkeypatch):
    _on_cpu(monkeypatch)
    p, mask = _scene()

    # The errors are kept, and with them their tracebacks' frames, so a
    # span that closed only when its last reference went would outlast
    # the next run.
    kept = []

    def bad_init():
        with pytest.raises(ValueError, match="chunk_iters") as err:
            trunner.run_simulation(p, mask, kernel="cuda", device="cpu",
                                   chunk_iters=0)
        kept.append(err)

    calls = []

    def fail(self, *args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("launch failed")
        return orig(self, *args)

    from lbm_tpu_torch.ops import fused_depth
    orig = fused_depth.FusedDepth.run
    monkeypatch.setattr(fused_depth.FusedDepth, "run", fail)

    def bad_compute():
        with pytest.raises(RuntimeError, match="launch failed") as err:
            trunner.run_simulation(p, mask, kernel="cuda", device="cpu")
        kept.append(err)

    _, events, args = _traced(tmp_path, bad_init, bad_compute)
    runs = list(_runs(events, args).values())
    assert [e["name"] for e, _ in runs[0]] == ["lbm.init"]
    names = [e["name"] for e, _ in runs[1]]
    assert names == ["lbm.init", "lbm.init.plan", "lbm.compute",
                     "lbm.segment.depth"]
    assert _inside(runs[1][3][0], runs[1][2][0])
    first = runs[0][0][0]
    assert first["ts"] + first["dur"] <= runs[1][0][0]["ts"]
    init, compute = runs[1][0][0], runs[1][2][0]
    assert init["ts"] + init["dur"] <= compute["ts"]
    assert not torch.autograd._profiler_enabled()


def test_the_mesh_path_has_the_same_spans(tmp_path):
    """A sharded run on CPU devices: its planning under ``lbm.init.plan``,
    one segment span a planned segment, the plain shard step's with no
    wrapper time."""
    p, mask = _scene()
    mesh = decomp.make_mesh(2, devices=[torch.device("cpu")] * 2)
    (r,), events, args = _traced(tmp_path, lambda: trunner.run_simulation(
        p, mask, kernel="reference", mesh=mesh))
    names = [e["name"] for e in events]
    assert names == ["lbm.init", "lbm.init.plan", "lbm.compute",
                     "lbm.segment.reference", "lbm.collate",
                     "lbm.collate.copy"]
    assert "compute.wrappers" not in r.timings
    assert args[3].endswith("kernel=reference steps_per_call=1 form=- "
                            f"steps={ITERS}")


# The library's entry points that launch a kernel; every other entry point
# answers a query or sets the card up.
LAUNCH_ENTRIES = {
    "lbm_fused_step", "lbm_reduce_tot", "lbm_fused_depth",
    "lbm_fused_depth_seam", "lbm_fused_step_seam", "lbm_resident",
    "lbm_resident_shift", "lbm_resident_onchip", "lbm_ring",
    "lbm_ring_onchip", "lbm_probe", "lbm_mxu_resident",
}
NOT_LAUNCHES = {
    "lbm_num_partials", "lbm_max_rows", "lbm_depth_num_partials",
    "lbm_depth_max_rows", "lbm_shift_owners", "lbm_shift_smem_bytes",
    "lbm_shift_edge_floats", "lbm_resident_blocks", "lbm_sm_count",
    "lbm_smem_optin", "lbm_onchip_smem_bytes", "lbm_onchip_prepare",
    "lbm_seam_num_partials", "lbm_seam_max_rows", "lbm_ring_blocks",
    "lbm_enable_peer_access", "lbm_ring_onchip_prepare", "lbm_probe_blocks",
    "lbm_mxu_blocks", "lbm_error_string",
}


def _modules():
    return [(p, ast.parse(p.read_text())) for p in sorted(PACKAGE.rglob("*.py"))
            if "__pycache__" not in p.parts]


def _functions(tree):
    """``(enclosing function's name or None, node)`` for every node."""
    out = []

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            out.append((name, child))
            walk(child, name)

    walk(tree, None)
    return out


def test_every_launch_goes_through_the_launch_helper():
    """Every library entry point is classed as a launch or not; a
    launch's entry point is only ever passed to ``launch`` (or the
    wrappers' ``_launch``, which hands it on), never called."""
    kernel_lib = {k for k in _build._SIGNATURES
                  if k not in ("lbm_write_final_state", "lbm_write_av_vels",
                               "lbm_read_obstacles")}
    assert LAUNCH_ENTRIES | NOT_LAUNCHES == kernel_lib
    assert not LAUNCH_ENTRIES & NOT_LAUNCHES
    passed = set()
    for path, tree in _modules():
        for fn, node in _functions(tree):
            if isinstance(node, ast.Call):
                f = node.func
                assert not (isinstance(f, ast.Attribute)
                            and f.attr in LAUNCH_ENTRIES), (path, node.lineno)
                helper = (f.attr if isinstance(f, ast.Attribute)
                          else getattr(f, "id", None))
                for arg in node.args:
                    if isinstance(arg, ast.Attribute) \
                            and arg.attr in LAUNCH_ENTRIES:
                        assert helper in ("launch", "_launch"), \
                            (path, node.lineno)
                        passed.add(arg.attr)
    assert passed == LAUNCH_ENTRIES


def test_launches_is_written_only_in_the_launch_helper():
    """``LAUNCHES`` is incremented in ``fused.launch`` and zeroed in
    ``fused.reset_launches``, nowhere else in the package."""
    writers = []
    for path, tree in _modules():
        for fn, node in _functions(tree):
            targets = []
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.value, (ast.Name, ast.Attribute)) and (
                        getattr(t.value, "id", None) == "LAUNCHES"
                        or getattr(t.value, "attr", None) == "LAUNCHES"):
                    writers.append((path.name, fn, type(node).__name__))
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and isinstance(
                    node.func.value, (ast.Name, ast.Attribute)) and (
                    getattr(node.func.value, "id", None) == "LAUNCHES"
                    or getattr(node.func.value, "attr", None) == "LAUNCHES"):
                writers.append((path.name, fn, node.func.attr))
    assert sorted(writers) == [("fused.py", "launch", "AugAssign"),
                               ("fused.py", "reset_launches", "Assign")]
