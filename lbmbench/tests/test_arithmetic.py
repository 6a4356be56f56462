"""The yardstick's arithmetic on synthetic readings: the trace's busy and
idle time over the benchmark's own window, the kernels' roofline, the
launches a kilostep and the scene times' 90th percentile."""

from __future__ import annotations

import random

import pytest

from lbmbench import harness, roofline, spec, tracing


def ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "ph": "X"}


KERNEL = "void (anonymous namespace)::fused_depth_kernel<4, false, false>(float const*)"
EVENTS = [
    ev(tracing.WINDOW_SPAN, "user_annotation", 100, 1000),
    ev(tracing.SCENE_SPAN, "user_annotation", 100, 1000),
    ev("aten::copy_", "cpu_op", 520, 70),
    ev("cudaLaunchKernel", "cuda_runtime", 900, 5, tid=2),  # another thread
    ev(KERNEL, "kernel", 50, 100, tid=7),                 # cut to 100-150
    ev(KERNEL, "kernel", 200, 200, tid=7),
    ev(KERNEL, "kernel", 300, 200, tid=8),                # overlaps: 200-500
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 100, tid=7),
    ev(KERNEL, "kernel", 1050, 150, tid=7),               # cut to 1050-1100
    ev(KERNEL, "kernel", 1200, 10, tid=7),                # outside
    ev("gpu annotation", "gpu_user_annotation", 100, 1000, tid=7),
]


def test_reduce_cuts_device_events_to_the_window():
    r = tracing.reduce(EVENTS)
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(500e-6)       # 50 + 300 + 100 + 50
    assert r["kernel_s"] == pytest.approx(500e-6)     # 50 + 200 + 200 + 50
    assert dict(r["device_ops"]) == pytest.approx(
        {"fused_depth_kernel": 500e-6,
         "Memcpy DtoH (Device -> Pageable)": 100e-6})
    # Gaps 150-200 and 700-1050 under the scene span, 500-600 under the
    # copy (at its middle, 550).
    assert dict(r["idle_gaps"]) == pytest.approx(
        {tracing.SCENE_SPAN: 400e-6, "aten::copy_": 100e-6})
    rec = {"scenes": [], "launches": None, "trace": r}
    assert spec.reader("device.idle_pct")(rec) == pytest.approx(50.0)


def test_reduce_takes_the_hosts_window_span():
    """The device's copy of the window span, listed first, from its first
    device event to its last and on a stream's id, is not the window."""
    device_copy = ev(tracing.WINDOW_SPAN, "gpu_user_annotation", 200, 800,
                     tid=7)
    assert tracing.reduce([device_copy] + EVENTS) == tracing.reduce(EVENTS)
    assert tracing.reduce([device_copy]) is None


def test_reduce_without_a_window_reads_nothing():
    assert tracing.reduce([e for e in EVENTS
                           if e["name"] != tracing.WINDOW_SPAN]) is None


def test_innermost_prefers_the_child_of_a_common_start():
    host = sorted([(0, 10, "child"), (0, 100, "parent")],
                  key=lambda h: (h[0], -h[1]))
    assert tracing._innermost(host, [5, 50, 150]) == ["child", "parent", None]


def test_roofline_counts_work_per_scene():
    least = roofline.least_seconds(1024, 1024, 20000)
    assert least == pytest.approx(90 * 1024 * 1024 * 20000 / 67e12)
    # One step of a scene is bound by its bytes, moved once a scene.
    assert roofline.least_seconds(1024, 1024, 1) == pytest.approx(
        73 * 1024 * 1024 / 3.35e12)
    scene = {"nx": 1024, "ny": 1024, "iters": 20000}
    rec = {"scenes": [scene, scene], "launches": 10000,
           "trace": {"kernel_s": 0.8, "busy_s": 0.8, "window_s": 1.0,
                     "device_events": 1}}
    assert spec.reader("kernels_roofline")(rec) == pytest.approx(
        100 * 2 * least / 0.8)
    assert spec.reader("planner.launches_per_kstep")(rec) == 250.0


def test_runner_phase_readers_average_the_scenes():
    rec = {"scenes": [{"timings": {"init": 0.001, "collate": 0.010}},
                      {"timings": {"init": 0.003, "collate": 0.020}}],
           "launches": None, "trace": None}
    assert spec.reader("runner.init_ms")(rec) == pytest.approx(2.0)
    assert spec.reader("runner.collate_ms")(rec) == pytest.approx(15.0)


def test_p90_is_the_exclusive_quantile():
    assert harness.p90(list(range(1, 101))) == pytest.approx(90.9)
    assert harness.p90([0.4]) == 0.4
    times = [0.40] * 95 + [0.50] * 5
    random.Random(1).shuffle(times)
    assert harness.p90(times) == pytest.approx(0.40)


def test_reservoir_keeps_k_of_the_offered():
    res = harness._Reservoir(3, random.Random(5))
    for i in range(100):
        res.offer(i)
    assert len(res.items) == 3 and len(set(res.items)) == 3
    assert all(0 <= i < 100 for i in res.items) and res.seen == 100


@pytest.mark.parametrize("name,short", [
    (KERNEL, "fused_depth_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Fn>(int)",
     "vectorized_elementwise_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pageable)"),
])
def test_short_kernel_name(name, short):
    assert tracing.short_kernel_name(name) == short
