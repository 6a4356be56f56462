"""Profiling and roofline reporting, the twin of :mod:`lbm_tpu.profiling`
(copied in part because that module imports jax):

- :class:`PhaseTimers`: the init/compute/collate/total wall-clock
  breakdown, each phase also a span ``lbm.<phase>`` on the profiler's
  clock while a profiler records, and the launch loop of a planned
  segment (:meth:`PhaseTimers.segment`). A phase that ends on device work
  must synchronise the device before it stops.
- :func:`trace`: a ``torch.profiler`` trace of a region, exported as a
  Chrome trace (``--trace DIR``; summarise with :func:`summarise` or
  ``scripts/trace_report_torch.py``).
- the port's cost model (:data:`BYTES_PER_CELL_PASS`,
  :data:`OPS_PER_CELL_STEP`), :func:`bound` (the least time a card could
  take for a kernel's work), :func:`design_ceiling` (the least a kernel
  that streams the lattice every step could take; an on-chip form's is
  its bound) and :func:`roofline_report` (a measured run against the
  card's data-sheet peaks).
- :func:`summarise`: per kernel name the launches and device time of a
  trace, the card's busy share and its longest idle gaps;
  :data:`KERNEL_NAMES`, each launch count's kernel name in a trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import gzip
import itertools
import json
import os
import re
import time
from collections import defaultdict
from pathlib import Path

# Per-cell cost model of one lattice pass: a step of one cell reads its 9
# f32 speeds and its mask byte and writes 9 f32 speeds, each input read
# once and each output written once, 73 B; a kernel that runs n steps per
# launch moves them once per n steps. Operations per cell and step: 90,
# counted from csrc/lbm_cell.cuh's paired association (density 8, velocity
# 12 with two divisions, u^2 3, equilibrium 36, relaxation 27, |u| and its
# sum 4), the forcing branch aside.
BYTES_PER_CELL_PASS = (9 + 9) * 4 + 1
OPS_PER_CELL_STEP = 90

# Peaks per card, from the vendor's data sheet (not measured here): HBM
# bytes per second, float32 operations per second outside the tensor
# cores, and the L2 cache's size. H100 SXM at its full 700 W power limit;
# a card set below that limit runs slower under load. The float32 peak
# counts a fused multiply-add as two operations; the port builds with
# -fmad=false (no fusion, so every kernel rounds as the plain version
# does), which leaves half of that peak reachable.
CHIP_PEAKS = {
    "h100": {"hbm_bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12,
             "l2_bytes": 50e6,
             "source": "NVIDIA H100 SXM data sheet, 700 W"},
}


def _peaks(chip: str) -> dict:
    try:
        return CHIP_PEAKS[chip]
    except KeyError:
        # A silent default would misstate utilisation for another card by
        # the ratio of their bandwidths.
        raise ValueError(
            f"unknown chip {chip!r}; known: {sorted(CHIP_PEAKS)}"
        ) from None


# Numbers the spans of the process in the order they open: the key of
# each span's args in the trace's metadata.
_SPANS = itertools.count()


@dataclasses.dataclass
class PhaseTimers:
    """The wall-clock phases of one run, ``elapsed[name]`` in seconds on
    the host's ``perf_counter``.

    While a profiler records (``torch.autograd._profiler_enabled()``),
    each :meth:`phase`, and each segment's launch loop
    (:meth:`segment`), is also a span on the profiler's host clock: a
    ``torch.profiler.record_function`` named ``lbm.<name>`` whose args
    string starts ``run=<run>``. The Chrome trace keeps a span's name and
    times but not its args string, so the string, after the span's name,
    also goes into the trace's metadata under ``lbm.span.<k>``, ``k``
    counting the process's spans in the order they open. Without a
    profiler a phase costs one flag check and two ``perf_counter`` calls.
    :meth:`start` and :meth:`stop` time a phase without a span."""

    run: int = 0
    elapsed: dict = dataclasses.field(default_factory=dict)
    _marks: dict = dataclasses.field(default_factory=dict)

    def start(self, phase: str) -> None:
        self._marks[phase] = time.perf_counter()

    def stop(self, phase: str) -> None:
        self.elapsed[phase] = time.perf_counter() - self._marks.pop(phase)

    def _open(self, name: str, detail: str = ""):
        """The entered span ``lbm.<name>``, or None where no profiler
        records."""
        import torch

        if not torch.autograd._profiler_enabled():
            return None
        name = f"lbm.{name}"
        args = f"run={self.run} {detail}".rstrip()
        span = torch.profiler.record_function(name, args)
        span.__enter__()
        torch.autograd._add_metadata_json(f"lbm.span.{next(_SPANS)}",
                                          json.dumps(f"{name} {args}"))
        return span

    @contextlib.contextmanager
    def phase(self, name: str):
        """``elapsed[name]``: the block's seconds, under the span
        ``lbm.<name>``; both end where the block raises too."""
        span = self._open(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed[name] = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)

    def segment(self, seg, t: int, call) -> int:
        """The launch loop of the planned segment ``seg``
        (:class:`.ops.plan.Segment`) from step ``t``: ``call(t)`` once a
        launch, each ``seg.steps_per_call`` steps on. Returns the step
        after the segment. The loop is the span ``lbm.segment.<kernel>``,
        its args the plan: ``kernel``, ``steps_per_call`` (D or G),
        ``form`` (``-`` for none) and ``steps``. Outside the plain path it
        adds to ``elapsed["compute.wrappers"]`` the host seconds of the
        calls less those spent in the library's launch entry points
        (:data:`.ops.fused.LAUNCH_NS`): the wrappers' own Python."""
        from lbm_tpu_torch.ops import fused

        span = self._open(
            f"segment.{seg.kernel}",
            f"kernel={seg.kernel} steps_per_call={seg.steps_per_call} "
            f"form={seg.form or '-'} steps={seg.steps}")
        spc, clock = seg.steps_per_call, time.perf_counter_ns
        try:
            ns, launch_ns = 0, fused.LAUNCH_NS
            for _ in range(seg.launches):
                t0 = clock()
                call(t)
                ns += clock() - t0
                t += spc
            if seg.kernel != "reference":
                self.elapsed["compute.wrappers"] = self.elapsed.get(
                    "compute.wrappers", 0.0) + (
                        ns - (fused.LAUNCH_NS - launch_ns)) * 1e-9
            return t
        finally:
            if span is not None:
                span.__exit__(None, None, None)


# Idle time on the host's clock left between the profiler's start and the
# region, and between the region's last device work and the profiler's
# stop. The profiler keeps only device events inside its host-clock
# window, and a kernel's converted device timestamps can sit up to about
# a millisecond before or after the host's (H100, CUDA 12.8): without the
# margin, a trace now and then lost the region's first launches
# (scripts/trace_drops_torch.py counts them).
TRACE_MARGIN_S = 0.02


def _settle(torch, margin_s: float) -> None:
    torch.cuda.synchronize()
    time.sleep(margin_s)


@contextlib.contextmanager
def trace(logdir: str, cuda: bool = False,
          margin_s: float = TRACE_MARGIN_S):
    """``torch.profiler`` trace around a region: CPU activities and, with
    ``cuda``, the card's (kernels, copies), the region's device work held
    ``margin_s`` inside the profiler's window on either side. On exit the
    Chrome trace goes to ``logdir/lbm_tpu_torch.<pid>.<ns>.trace.json``
    (view in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            _settle(torch, margin_s)
        yield prof
        if cuda:
            _settle(torch, margin_s)
    prof.export_chrome_trace(str(
        Path(logdir) / f"lbm_tpu_torch.{os.getpid()}.{time.time_ns()}.trace.json"
    ))


def bound(cells: int, steps_per_launch: int = 1, extra_bytes: int = 0,
          chip: str = "h100", bytes_per_cell: int = BYTES_PER_CELL_PASS,
          ops_per_cell: int = OPS_PER_CELL_STEP):
    """``(ms per step, "bytes" or "operations")``: the least time ``chip``
    could take per step for ``cells`` cells stepped ``steps_per_launch``
    steps per launch, the larger of the launch's bytes (``bytes_per_cell``
    a cell plus ``extra_bytes``, each input read once and each output
    written once per launch) over the memory rate and a step's operations
    over the float32 rate. It bounds the function, n steps of the lattice,
    whatever the kernel's design: :func:`design_ceiling` has what a design
    that streams the lattice every step can reach."""
    peaks = _peaks(chip)
    t_bytes = (bytes_per_cell * cells + extra_bytes) \
        / peaks["hbm_bytes_per_s"] / steps_per_launch
    t_ops = ops_per_cell * cells / peaks["f32_ops_per_s"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def design_ceiling(cells: int, steps_per_launch: int = 1, chip: str = "h100",
                   bytes_per_cell: int = BYTES_PER_CELL_PASS,
                   ops_per_cell: int = OPS_PER_CELL_STEP,
                   steps_per_pass: int = 1, on_chip: bool = False):
    """``(ms per step, "bytes" or "operations")``: the least time per step
    of a kernel that keeps the lattice in device memory between the passes
    of a launch, a pass covering ``steps_per_pass`` steps (1: the probe;
    D: the device-memory ring and the resident kernel's device-memory
    form, which step D at a time in shared memory, as
    ``roofline_report``'s ``steps_per_pass``).
    Such a kernel passes over device memory once per pass whenever its
    working set, ``bytes_per_cell * cells`` (both buffers and the mask),
    exceeds the card's L2 cache; while it fits, the launch's bytes move
    once and this is :func:`bound`. ``on_chip``: a kernel that holds the
    lattice in shared memory for the whole launch (the on-chip forms of
    the resident kernel and of the ring), whose bytes move once a launch
    at any size: :func:`bound`. Not a bound of the function: the depth
    kernel, which holds its steps in shared memory, runs below it. It says
    how much of a kernel's distance from :func:`bound` its design accounts
    for."""
    peaks = _peaks(chip)
    if not on_chip and bytes_per_cell * cells > peaks["l2_bytes"]:
        steps_per_launch = min(steps_per_launch, steps_per_pass)
    return bound(cells, steps_per_launch, chip=chip,
                 bytes_per_cell=bytes_per_cell, ops_per_cell=ops_per_cell)


def roofline_report(nx: int, ny: int, iters: int, seconds: float,
                    chip: str = "h100", steps_per_pass: int = 1) -> dict:
    """Throughput of a measured run against ``chip``'s data-sheet roofs.

    ``steps_per_pass``: steps the measured kernel advances per pass over
    device memory (1 for the one-step kernel, D for the depth kernel, G
    for the resident kernel and the ring); pass the value the run used
    (the plan line on stderr names it). ``seconds`` must be device time
    of a run on that card: this function only divides."""
    peaks = _peaks(chip)
    cells = nx * ny * iters
    bytes_per_step = BYTES_PER_CELL_PASS / steps_per_pass
    bytes_per_s = cells * bytes_per_step / seconds
    ops_per_s = cells * OPS_PER_CELL_STEP / seconds
    ai = OPS_PER_CELL_STEP / bytes_per_step
    ridge = peaks["f32_ops_per_s"] / peaks["hbm_bytes_per_s"]
    ms, by = bound(nx * ny, steps_per_pass, chip=chip)
    return {
        "glups": cells / seconds / 1e9,
        "effective_gbps": bytes_per_s / 1e9,
        "effective_gflops": ops_per_s / 1e9,
        "hbm_utilisation": bytes_per_s / peaks["hbm_bytes_per_s"],
        "flops_utilisation": ops_per_s / peaks["f32_ops_per_s"],
        "arithmetic_intensity": ai,
        "ceiling_glups": nx * ny / (ms * 1e-3) / 1e9,
        "bound": "memory" if ai < ridge else "compute",
        "bound_by": by,
        "peaks": peaks["source"],
    }


# --------------------------------------------------------------------------
# Trace summary.
# --------------------------------------------------------------------------

# Chrome-trace categories torch.profiler gives to work on the card.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The kernels' names in a trace (:func:`short_kernel_name`) by their
# launch counts' names in ``ops.fused.LAUNCHES`` (without the column
# modes' "_cols", which run the same kernel functions).
KERNEL_NAMES = {"step": "fused_step_kernel", "reduce": "reduce_tot_kernel",
                "depth": "fused_depth_kernel",
                "depth_flow": "fused_depth_flow_kernel",
                "resident": "resident_kernel",
                "resident_shift": "resident_shift_kernel",
                "resident_onchip": "resident_onchip_kernel",
                "resident_onchip_inplace": "resident_onchip_kernel",
                "step_seam": "fused_step_seam_kernel",
                "depth_seam": "fused_depth_kernel", "ring": "ring_kernel",
                "ring_onchip": "ring_onchip_kernel",
                "ring_onchip_inplace": "ring_onchip_kernel",
                **{f"probe_{m}": "probe_kernel"
                   for m in ("full", "collide", "stream")},
                "mxu": "mxu_resident_kernel"}


def short_kernel_name(name: str) -> str:
    """``fused_depth_kernel`` from ``void (anonymous namespace)::
    fused_depth_kernel<4, false, false>(float const*, ...)``: the
    function's own name, without return type, namespaces, template and
    call arguments. Names without that form (``Memcpy DtoD (Device ->
    Device)``) come back unchanged."""
    part = r"(?:\(anonymous namespace\)|\w+)"
    m = re.match(rf"^(?:void\s+)?({part}(?:::{part})*)\s*[<(]", name)
    return m.group(1).split("::")[-1] if m else name


def load_trace(tracedir: str) -> tuple[str, list]:
    """``(path, events)`` of the newest Chrome trace under ``tracedir``
    (``*.trace.json`` or ``*.trace.json.gz``, at any depth)."""
    paths = [p for ext in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(tracedir, "**", ext),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace.json(.gz) under {tracedir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return path, events


def summarise(tracedir: str, top: int = 25, gaps: int = 5) -> dict:
    """Where the card's time went in the newest trace under ``tracedir``.

    ``kernels``: per short kernel name (:func:`short_kernel_name`; copies
    and memsets by their trace names) the launches, total and mean device
    microseconds and the share of the busy time, longest total first.
    ``window_us``: from the first device event's start to the last one's
    end; ``busy_us``: the union of the device events' intervals inside it
    (streams that overlap count once); ``busy_share`` their ratio;
    ``idle_gaps``: the ``gaps`` longest intervals with nothing on the
    card, each with the event that ended before it and the one that
    started after. ``host_ops``: the ``top`` CPU-side events by total
    time, the only rows of a trace taken without a card."""
    path, events = load_trace(tracedir)
    dev, host = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in _DEVICE_CATS:
            dev.append(e)
        else:
            row = host[e.get("name", "?")]
            row[0] += e["dur"]
            row[1] += 1

    agg = defaultdict(lambda: {"launches": 0, "total_us": 0.0,
                               "variants": set()})
    for e in dev:
        name = e.get("name", "?")
        row = agg[short_kernel_name(name) if e["cat"] == "kernel" else name]
        row["launches"] += 1
        row["total_us"] += e["dur"]
        row["variants"].add(name)

    # The union of the device intervals, and the gaps between its pieces.
    dev.sort(key=lambda e: e["ts"])
    busy, idle, end, last = 0.0, [], None, None
    for e in dev:
        s, t = e["ts"], e["ts"] + e["dur"]
        if end is None:
            end, last = s, e
        if s > end:
            idle.append({"gap_us": s - end, "at_us": end - dev[0]["ts"],
                         "after": short_kernel_name(last.get("name", "?")),
                         "before": short_kernel_name(e.get("name", "?"))})
            busy += t - s
        elif t > end:
            busy += t - end
        if t > end:
            end, last = t, e
    window = (end - dev[0]["ts"]) if dev else 0.0
    idle.sort(key=lambda g: -g["gap_us"])

    kernels = sorted(
        ({"name": n, "launches": r["launches"], "total_us": r["total_us"],
          "mean_us": r["total_us"] / r["launches"],
          "pct_busy": 100 * r["total_us"] / busy if busy else None,
          "variants": sorted(r["variants"])}
         for n, r in agg.items()),
        key=lambda r: -r["total_us"])
    host_ops = sorted(
        ({"name": n, "total_us": t, "count": c} for n, (t, c) in host.items()),
        key=lambda r: -r["total_us"])[:top]
    return {"trace_file": path, "kernels": kernels[:top],
            "device_events": len(dev), "window_us": window, "busy_us": busy,
            "busy_share": busy / window if window else None,
            "idle_us": window - busy, "n_idle_gaps": len(idle),
            "idle_gaps": idle[:gaps], "host_ops": host_ops}


def launches(summary: dict) -> dict:
    """``{kernel name: launches}`` of a :func:`summarise` result."""
    return {r["name"]: r["launches"] for r in summary["kernels"]}


def format_summary(summary: dict) -> str:
    """The table ``scripts/trace_report_torch.py`` prints."""
    lines = [f"{'kernel':<44} {'launches':>9} {'total_us':>12} "
             f"{'mean_us':>10} {'pct':>6}"]
    for r in summary["kernels"]:
        lines.append(f"{r['name'][:43]:<44} {r['launches']:>9} "
                     f"{r['total_us']:>12.1f} {r['mean_us']:>10.2f} "
                     f"{(r['pct_busy'] or 0):>6.2f}")
    if summary["busy_share"] is None:
        lines.append("no device events in this trace (taken without a card)")
        for r in summary["host_ops"][:10]:
            lines.append(f"host {r['name'][:38]:<39} {r['count']:>9} "
                         f"{r['total_us']:>12.1f}")
    else:
        lines.append(f"window {summary['window_us']:.1f} us, busy "
                     f"{summary['busy_us']:.1f} us "
                     f"({100 * summary['busy_share']:.2f} %), "
                     f"{summary['n_idle_gaps']} idle gaps")
        for g in summary["idle_gaps"]:
            lines.append(f"  gap {g['gap_us']:.1f} us at {g['at_us']:.1f} us, "
                         f"after {g['after']}, before {g['before']}")
    return "\n".join(lines)
