#!/usr/bin/env python3
"""Sweep of the PyTorch/CUDA port: grids x kernels x shards on one card,
one JSON row each, in ``scripts/sweep.py``'s row shape (``grid``,
``kernel``, ``devices``, ``iters``, ``seconds``, ``glups``, ``backend``),
so ``scripts/scaling.py`` reads the file unchanged. ``devices`` counts
the shards; on the card they all share it (``"cards": 1``).

Also the shared timing rule of the port's harness scripts,
:func:`measure`: the run's state made on the device, one untimed run,
then the best of ``repeats`` timed runs, each fenced by a synchronize
and, on a card, timed by CUDA events on the current stream after it has
waited for every shard's stream; a trajectory that is not finite raises.
On the CPU the rows are functional, not hardware
(``"mode": "functional-not-hardware"``).

Kernels: ``auto``, ``cuda``, ``reference`` (the plain version) and
``ring`` (``cuda`` with ``LBM_SHARD_RESIDENT=1``, on a mesh even of one
shard).

Usage: python scripts/sweep_torch.py [--grids 128x128 1024x1024 ...]
           [--kernels auto reference] [--shards 1 4] [--iters N]
           [--repeats R] [--device cuda|cpu] [-o sweep_results_torch.json]
           [--append]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

GRID_SCENES = {
    # nx, ny, iters, accel: the shipped input_*.params files
    # (scripts/sweep.py's table).
    "128x128": (128, 128, 40000, 0.005),
    "128x256": (128, 256, 40000, 0.005),
    "256x256": (256, 256, 80000, 0.005),
    "1024x1024": (1024, 1024, 20000, 0.01),
    "2048x1024": (2048, 1024, 20000, 0.01),
    "4096x1024": (4096, 1024, 20000, 0.01),
    "8192x1024": (8192, 1024, 20000, 0.01),
    "16384x1024": (16384, 1024, 20000, 0.01),
    # The reference's hybrid-report stress grid; no .params file, the
    # parameters of the 1024-wide scenes.
    "131072x128": (131072, 128, 20000, 0.01),
    "64x64": (64, 64, 100, 0.005),
}
# The knobs a measurement may set; every other value of them is cleared
# while it runs, so a caller's exports do not leak into a cell.
KNOBS = ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_RESIDENT_FORM",
         "LBM_PALLAS_DEPTH", "LBM_PAIRED_EQ", "LBM_OMEGA_EQ",
         "LBM_SHARD_RESIDENT")


def grid_params(name: str, iters: int | None = None):
    """The scene parameters of grid ``name`` (NXxNY; accel 0.01 from
    1024 columns up, 0.005 below, for a grid not in the table)."""
    from lbm_tpu_torch.params import Params

    if name in GRID_SCENES:
        nx, ny, default_iters, accel = GRID_SCENES[name]
    else:
        nx, ny = (int(v) for v in name.split("x"))
        default_iters, accel = 2000, (0.01 if nx >= 1024 else 0.005)
    return Params(nx=nx, ny=ny, max_iters=iters or default_iters,
                  reynolds_dim=10, density=0.1, accel=accel, omega=1.85)


@contextlib.contextmanager
def knobs(env: dict):
    """Set ``env`` and clear every other knob of :data:`KNOBS` for the
    duration; restore all of them after."""
    unknown = set(env) - set(KNOBS)
    if unknown:
        raise ValueError(f"not a knob of the port: {sorted(unknown)}")
    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def card() -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _make(params, kernel: str, shards: int, dev):
    """A fresh run of ``params.max_iters`` steps: ``(sim, plan, streams,
    steps_per_pass)``. ``shards`` 0: the single-device runner; n >= 1: a
    mesh of n shards of ``dev``."""
    import torch

    from lbm_tpu_torch import runner
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.parallel import decomp, halo
    from lbm_tpu_torch.state import initial_state

    iters = params.max_iters
    mask = generate_obstacles(params.nx, params.ny)
    if shards:
        mesh = decomp.make_mesh(shards, devices=[dev] * shards)
        runner._check_mesh(mesh, kernel)
        sp = halo.plan_run(params, mask, mesh, kernel, iters)
        sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, dev),
                                     sp.obstacles, mesh, sp.kernel, iters,
                                     sp.wrap_pad)
        streams = [sh.stream for sh in sim.ss.shards if sh.stream is not None]
        return sim, halo.describe(sp, mesh), streams, \
            sp.segments[0].steps_per_call
    k = runner._resolve_kernel(kernel, params, dev)
    sim = runner._Simulation(params, initial_state(params, dev),
                             torch.from_numpy(mask).to(dev), k, iters)
    segs = sim.segments
    layout = "transposed: " if sim.transposed else ""
    return sim, f"{k}, {layout}{plan.describe(segs)}", [], \
        segs[0].steps_per_call


def measure(nx: int, ny: int, iters: int, kernel: str = "auto",
            env: dict | None = None, repeats: int = 3, device="cuda",
            shards: int = 0) -> dict:
    """The best of ``repeats`` timed runs of ``iters`` steps of the
    walled ``nx`` x ``ny`` grid under ``kernel`` and the knobs ``env``
    (read when the run is built, as the runner reads them), after one
    untimed run; ``shards`` as :func:`_make`. Returns ``seconds`` (device
    time by CUDA events on a card; the host's clock on the CPU),
    ``host_seconds`` (the host's clock of the same run), ``glups``, the
    ``plan``, ``steps_per_pass``, ``backend`` and ``repeats``."""
    import torch

    from lbm_tpu_torch.runner import _resolve_device

    dev = _resolve_device(device)
    name = f"{nx}x{ny}"
    params = grid_params(name, iters)
    cuda = dev.type == "cuda"
    best = host_best = float("inf")
    with knobs(env or {}):
        for rep in range(repeats + 1):
            sim, plan_line, streams, spp = _make(params, kernel, shards, dev)
            sim.synchronize()
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            sim.run_chunk(0, iters)
            if cuda:
                now = torch.cuda.current_stream(dev)
                for s in streams:
                    now.wait_stream(s)
                end.record()
                end.synchronize()
            sim.synchronize()
            host = time.perf_counter() - t0
            av = sim.result()[1].cpu().numpy()
            if not np.isfinite(av).all():
                raise AssertionError(f"{name} under {kernel} {env}: the "
                                     "trajectory is not finite")
            if rep == 0:
                continue  # the untimed run
            host_best = min(host_best, host)
            best = min(best, start.elapsed_time(end) / 1e3 if cuda else host)
    return {"seconds": best, "host_seconds": host_best,
            "glups": nx * ny * iters / best / 1e9, "plan": plan_line,
            "steps_per_pass": spp, "backend": dev.type, "repeats": repeats,
            "timing": "best of repeats after one untimed run; "
                      + ("CUDA events" if cuda else "host clock")}


def run_config(grid, kernel, shards, iters, repeats, device):
    params = grid_params(grid, iters)
    ring = kernel == "ring"
    m = measure(params.nx, params.ny, params.max_iters,
                "cuda" if ring else kernel,
                {"LBM_SHARD_RESIDENT": "1"} if ring else {}, repeats, device,
                shards if shards > 1 or ring else 0)
    if ring and "ring" not in m["plan"]:
        raise RuntimeError(f"{grid} over {shards} did not plan the ring: "
                           f"{m['plan']}")
    row = {"grid": grid, "kernel": kernel, "devices": shards,
           "iters": params.max_iters, **m}
    if m["backend"] == "cuda":
        row["cards"] = 1
    else:
        row["mode"] = "functional-not-hardware"
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grids", nargs="+",
                   default=["128x128", "256x256", "1024x1024"])
    p.add_argument("--kernels", nargs="+", default=["auto"],
                   choices=["auto", "cuda", "reference", "ring"])
    p.add_argument("--shards", nargs="+", type=int, default=[1])
    p.add_argument("--iters", type=int, default=None,
                   help="steps a run (default: the scene's, at most 2000)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("-o", "--output", default="sweep_results_torch.json")
    p.add_argument("--append", action="store_true",
                   help="merge into the output file: rows of the same grid, "
                        "kernel, shards and backend are replaced")
    args = p.parse_args(argv)

    def key(r):
        return (r.get("grid"), r.get("kernel"), r.get("devices"),
                r.get("backend"))

    out = Path(args.output)
    results, failed = [], False
    for grid, kernel, n in itertools.product(args.grids, args.kernels,
                                             args.shards):
        iters = args.iters or min(grid_params(grid).max_iters, 2000)
        try:
            r = run_config(grid, kernel, n, iters, args.repeats, args.device)
        except Exception as exc:  # record the failure, keep sweeping
            failed = True
            r = {"grid": grid, "kernel": kernel, "devices": n,
                 "backend": args.device.split(":")[0],
                 "error": f"{type(exc).__name__}: {exc}"[:500]}
        print(json.dumps(r), flush=True)
        results.append(r)
        rows = results
        if args.append and out.exists():
            merged = {key(r): r for r in json.loads(out.read_text())}
            merged.update({key(r): r for r in results})
            rows = list(merged.values())
        out.write_text(json.dumps(rows, indent=2) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
