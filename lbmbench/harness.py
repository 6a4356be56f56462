"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's scenes from the seed, hands each to the program
to prepare, and runs one warm scene of the cell's own shape, which
builds or loads every kernel the window will launch. ``setup_s`` runs
from the process's start to the first timed scene.

The window is a closed loop with one caller: scenes back to back, each
timed on the host from the call to its return, until ``seconds`` have
passed and at least as many scenes as the cell checks have finished. It
closes when the scene that was running at the deadline returns, so it
holds all the work and all the time of the scenes in it. A scene that
raises counts as failed.

The check draws its scenes from those the window finished (a reservoir
sample seeded from the seed), after the window has closed, the device
memory peak has been read and the program's state has been let go, and
works each out again with the plain reference in float64
(:mod:`lbmbench.compare`).

The end-to-end quantities are ``glups`` (the lattice updates of every
scene in the window over its seconds), ``scene_s.p90`` (the 90th
percentile of the scenes' wall times) and ``setup_s``.

With ``trace`` the window runs under the profiler, for at most
:data:`TRACE_SECONDS`, and the run reports the cell's per-layer metrics,
each read by its own reader from :func:`record`, instead of its
end-to-end ones.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import statistics
import sys
import time

import numpy as np
import torch

from lbmbench import compare, reference, scenes, tracing
from lbmbench.spec import Cell, reader

# The traced window's cap: a minute of the 1024^2 scene holds about
# 7 x 10^5 launches, more than the trace needs to be read.
TRACE_SECONDS = 15.0
# Top-level modules that may not be loaded in a run's process: the JAX
# package the port was made from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "lbm_tpu")


@dataclasses.dataclass
class Outcome:
    cells: np.ndarray
    av_vels: np.ndarray
    reynolds: float
    timings: dict


class Port:
    """The system under test: ``lbm_tpu_torch.runner.run_simulation`` under
    ``kernel="auto"``, one call a scene, its result on the host."""

    def __init__(self, device):
        from lbm_tpu_torch.params import Params
        from lbm_tpu_torch.runner import run_simulation

        self.device = device
        self._params, self._run = Params, run_simulation

    def prepare(self, scene):
        p = self._params(nx=scene.nx, ny=scene.ny, max_iters=scene.iters,
                         reynolds_dim=scene.reynolds_dim,
                         density=np.float32(scene.density),
                         accel=np.float32(scene.accel),
                         omega=np.float32(scene.omega))
        return p, scene.mask

    def __call__(self, prepared) -> Outcome:
        params, mask = prepared
        r = self._run(params, mask, kernel="auto", device=self.device)
        return Outcome(r.cells, r.av_vels, r.reynolds, r.timings)

    @staticmethod
    def launches():
        """The wrappers' launch count so far (``ops.fused.LAUNCHES``), or
        None where the program keeps none."""
        fused = sys.modules.get("lbm_tpu_torch.ops.fused")
        counts = getattr(fused, "LAUNCHES", None)
        return None if counts is None else sum(counts.values())


class Control:
    """The control of the check: the plain reference put in the program's
    place, its state kept in bfloat16, the precision below the float32
    the coursework states: each step computed in float32 and its result
    rounded to bfloat16 (``store``; None keeps ``dtype`` throughout)."""

    def __init__(self, device, dtype=torch.float32, store=torch.bfloat16):
        self.device, self.dtype, self.store = device, dtype, store

    def prepare(self, scene):
        return scene

    def __call__(self, scene) -> Outcome:
        cells, av, re = reference.run([scene], self.dtype, self.device,
                                      store=self.store)[0]
        return Outcome(cells, av, re, {})

    @staticmethod
    def launches():
        return None


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn by ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def p90(values) -> float:
    """The 90th percentile by ``statistics.quantiles`` (exclusive)."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=10)[-1]


def forbidden_modules() -> list[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def _window(program, prepared, pool, seconds, min_scenes, sample):
    """The closed loop. Returns ``(window seconds, scene rows, failures,
    launches over the window or None)``."""
    rows, failed, k = [], [], 0
    before = program.launches()
    span = torch.profiler.record_function
    t_start = time.perf_counter()
    with span(tracing.WINDOW_SPAN):
        while True:
            i = k % len(pool)
            t0 = time.perf_counter()
            try:
                with span(tracing.SCENE_SPAN):
                    out = program(prepared[i])
            except Exception as exc:  # a scene that fails is counted
                out = None
                failed.append(f"scene {k}: {type(exc).__name__}: {exc}")
            t1 = time.perf_counter()
            with span(tracing.HARNESS_SPAN):
                if out is not None:
                    rows.append({"index": i, "wall_s": t1 - t0,
                                 "nx": pool[i].nx, "ny": pool[i].ny,
                                 "iters": pool[i].iters,
                                 "timings": dict(out.timings)})
                    sample.offer((pool[i], out))
                k += 1
            if t1 - t_start >= seconds and len(rows) + len(failed) >= min_scenes:
                break
    after = program.launches()
    launches = None if before is None or after is None else after - before
    return t1 - t_start, rows, failed, launches


def record(cell: Cell, rows: list, launches, trace_reading) -> dict:
    """What a per-layer metric's reader reads: the window's scenes (each
    with its program phase times), the launches counted over them, and
    the trace's reading (:func:`.tracing.reduce`), None without a card."""
    return {"cell": cell.name, "scenes": rows, "launches": launches,
            "trace": trace_reading}


def check(cell: Cell, sampled, device) -> dict:
    """The compared numbers, each the worst over the sampled scenes."""
    rows = []
    by_shape = {}
    for scene, out in sampled:
        by_shape.setdefault((scene.nx, scene.ny, scene.iters), []).append(
            (scene, out))
    for group in by_shape.values():
        refs = reference.run([s for s, _ in group], torch.float64, device)
        for (scene, out), ref in zip(group, refs):
            rows.append(compare.gaps(scene, out.cells, out.av_vels,
                                     out.reynolds, ref))
    return compare.worst(rows)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", program=None, t0: float | None = None,
             warm: bool = True):
    """One run. Returns ``(result, notes, forbidden)``: the result object
    of the benchmark's last line, the lines for standard error (the
    compared numbers last), and the forbidden modules that were loaded
    when the window closed. ``warm``: run the warm scene (a
    calibration's control skips it)."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [time.perf_counter()]
    on_card = torch.device(device).type == "cuda"
    program = Port(device) if program is None else program
    k = int(cell.check["scenes"])
    pool = scenes.make_pool(cell.config, seed)
    prepared = [program.prepare(s) for s in pool]
    marks.append(time.perf_counter())
    if warm:
        program(prepared[0])
    _sync(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t0

    sample = _Reservoir(k, random.Random(scenes.seed_entropy(seed)))
    reading = None
    if trace:
        window = min(seconds, TRACE_SECONDS)
        with tracing.profiled(cuda=on_card) as traced:
            window_s, rows, failed, launches = _window(
                program, prepared, pool, window, k, sample)
        reading = tracing.reduce(traced["events"])
    else:
        window_s, rows, failed, launches = _window(
            program, prepared, pool, seconds, k, sample)
    phases = {ph: [r["timings"][ph] for r in rows if ph in r["timings"]]
              for ph in ("init", "compute", "collate")}
    notes = [f"setup {setup_s:.3f} s: start to harness "
             f"{marks[0] - t0:.3f} s, scenes {marks[1] - marks[0]:.3f} s, "
             f"warm scene {marks[2] - marks[1]:.3f} s",
             f"window {window_s:.6f} s, {len(rows)} scenes, "
             f"{len(failed)} failed; scene seconds min "
             f"{min((r['wall_s'] for r in rows), default=0):.6f} max "
             f"{max((r['wall_s'] for r in rows), default=0):.6f} sd "
             f"{statistics.pstdev([r['wall_s'] for r in rows] or [0]):.6f}",
             "runner phases, mean ms: " + ", ".join(
                 f"{ph} {1e3 * sum(v) / len(v):.4f}"
                 for ph, v in phases.items() if v)] + failed[:5]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad_after_window = forbidden_modules()
    sampled = sample.items
    del prepared, program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    try:
        readings = check(cell, sampled, device) if sampled else \
            dict.fromkeys(compare.NUMBERS, float("inf"))
    except Exception as exc:  # a check that cannot run fails the run
        notes.append(f"check failed: {type(exc).__name__}: {exc}")
        readings = dict.fromkeys(compare.NUMBERS, float("inf"))
    notes.append(f"check of {len(sampled)} scene(s) took "
                 f"{time.perf_counter() - t_check:.3f} s")
    limits = cell.check["limits"]
    correct = not failed and compare.verdict(readings, limits)

    if trace:
        rec = record(cell, rows, launches, reading)
        values = {m["name"]: reader(m["name"])(rec) for m in cell.per_layer}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if values[m["name"]] is not None}
    else:
        updates = sum(r["nx"] * r["ny"] * r["iters"] for r in rows)
        values = {"glups": updates / window_s / 1e9,
                  "scene_s.p90": p90([r["wall_s"] for r in rows]) if rows
                  else None,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if values.get(m["name"]) is not None}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(peak)}
    if trace and reading is not None:
        dev["busy_s"] = reading["busy_s"]
        dev["window_s"] = reading["window_s"]
    result = {"correct": bool(correct), "attempted": len(rows) + len(failed),
              "failed": len(failed), "metrics": metrics, "device": dev}
    if trace and reading is not None:
        result["breakdown"] = {"device_ops": reading["device_ops"],
                               "idle_gaps": reading["idle_gaps"]}
    # Each compared number beside its limit, under the last key of the
    # result's line as well as on standard error: the record of a run
    # that is not correct keeps the end of both.
    checks = {n: {"value": _finite(readings[n]), "limit": limits[n]}
              for n in compare.NUMBERS}
    result["checks"] = checks
    notes += [f"check {n} {float(readings[n])!r} limit {limits[n]!r}"
              for n in compare.NUMBERS]
    return result, notes, bad_after_window


def _finite(x: float):
    """``x``, or None where it is not finite (JSON has no infinity)."""
    return x if np.isfinite(x) else None
