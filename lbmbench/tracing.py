"""The traced run's reading of the device: a ``torch.profiler`` trace of the
measured window, reduced to what the per-layer metrics and the result's
``breakdown`` need.

The window is the benchmark's own: its ``lbmbench.window`` span on the
host, not the stretch from the first device event to the last. Every
device event (kernels, copies, memsets) is cut to that span; ``busy_s``
is the union of what is left (streams that overlap count once),
``window_s`` the span's length. Each idle gap inside the window is put
down to what the host was doing at its middle: the innermost event on
the window's thread that covers it (a span of the harness, an ATen
operation or a CUDA runtime call), or ``host`` where none does.

The trace is written as a Chrome trace under the run's temporary
directory, read once and deleted. The kernels' short names follow
``lbm_tpu_torch.profiling.short_kernel_name`` (copied, not imported).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict

WINDOW_SPAN = "lbmbench.window"
SCENE_SPAN = "lbmbench.scene"
HARNESS_SPAN = "lbmbench.harness"
# Device work stays this far inside the profiler's host-clock window on
# either side: the profiler keeps only device events inside it, and the
# device's converted timestamps can sit about a millisecond off the
# host's.
MARGIN_S = 0.02
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def short_kernel_name(name: str) -> str:
    """``fused_depth_kernel`` from ``void (anonymous namespace)::
    fused_depth_kernel<4, false, false>(float const*, ...)``; names
    without that form (``Memcpy DtoH (Device -> Pageable)``) unchanged."""
    part = r"(?:\(anonymous namespace\)|\w+)"
    m = re.match(rf"^(?:void\s+)?({part}(?:::{part})*)\s*[<(]", name)
    return m.group(1).split("::")[-1] if m else name


@contextlib.contextmanager
def profiled(cuda: bool):
    """A profiler around the block, its device work held
    :data:`MARGIN_S` inside; yields a dict that holds the trace's events
    once the block has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        yield out
        if cuda:
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    out["events"] = [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Sorted disjoint pieces of the union of ``(start, end)`` pairs."""
    pieces = []
    for s, e in sorted(intervals):
        if pieces and s <= pieces[-1][1]:
            pieces[-1][1] = max(pieces[-1][1], e)
        else:
            pieces.append([s, e])
    return pieces


def _innermost(host, points):
    """For each sorted time in ``points``, the name of the shortest event
    of ``host`` (``(start, end, name)`` sorted by start, properly nested)
    that covers it, or None."""
    names, stack, i = [], [], 0
    for q in points:
        while i < len(host) and host[i][0] <= q:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= q:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def reduce(events: list) -> dict | None:
    """The window's device reading from a trace's complete events, or
    None where the trace holds no window span."""
    # The host's span: CUPTI writes a ``gpu_user_annotation`` of the same
    # name on the device's clock, from its first event to its last.
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    win = spans[0]
    w0, w1, tid = win["ts"], win["ts"] + win["dur"], win.get("tid")
    per_op = defaultdict(float)
    pieces, kernel_us = [], 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        name = e.get("name", "?")
        if e["cat"] == "kernel":
            name = short_kernel_name(name)
            kernel_us += t - s
        per_op[name] += (t - s) * 1e-6
        pieces.append((s, t))
    busy = _union(pieces)
    busy_us = sum(t - s for s, t in busy)
    edges = [w0] + [x for piece in busy for x in piece] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    # By start, and the longer first where two start together, so that a
    # parent is pushed before its child.
    host = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", "?"))
                   for e in events
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != WINDOW_SPAN),
                  key=lambda h: (h[0], -h[1]))
    idle = defaultdict(float)
    mids = [(s + t) / 2 for s, t in gaps]
    for (s, t), who in zip(gaps, _innermost(host, mids)):
        idle[who or "host"] += (t - s) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "kernel_s": kernel_us * 1e-6, "device_ops": top(per_op),
            "idle_gaps": top(idle), "device_events": len(pieces)}
