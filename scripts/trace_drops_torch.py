#!/usr/bin/env python3
"""How many of a traced run's kernel launches the trace misses, with and
without the trace's margin (``lbm_tpu_torch.profiling.TRACE_MARGIN_S``).

Runs the 1024x1024 scene (the generator's walls plus one full-height
column at x = nx // 3, as ``chip_smoke.py``) for ``--iters`` steps under
the planner's ``auto`` path, ``--reps`` times traced with no margin and
with the default one, in turns. In each trace every ``cudaLaunchKernel``
on the host is matched by its correlation id to a kernel on the card; the
launches left without a kernel are the trace's drops, listed by their
index in launch order. ``skew_us`` is the first kernel's start less its
launch's start (host clock): negative where the device timestamps run
ahead of the host's.

Usage: python scripts/trace_drops_torch.py [--reps 15] [--iters 2000]
           [-o drops.json]
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def drops(tracedir: str) -> dict:
    from lbm_tpu_torch import profiling

    _, events = profiling.load_trace(tracedir)
    kernels, launches = {}, []
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "kernel":
            kernels[corr] = e
        elif (e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "LaunchKernel" in e.get("name", "")):
            launches.append((e["ts"], corr))
    launches.sort()
    first = min(kernels.values(), key=lambda e: e["ts"], default=None)
    return {"launches": len(launches), "kernels": len(kernels),
            "dropped": [i for i, (_, c) in enumerate(launches)
                        if c not in kernels],
            "skew_us": (first["ts"] - launches[0][0]
                        if first is not None and launches else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("-o", "--out", help="write the runs as JSON here")
    args = ap.parse_args(argv)

    import torch

    from lbm_tpu_torch import profiling, runner
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.params import Params

    if not torch.cuda.is_available():
        print("trace_drops_torch: needs a CUDA device", file=sys.stderr)
        return 2
    nx = ny = 1024
    p = Params(nx=nx, ny=ny, max_iters=args.iters, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    mask = generate_obstacles(nx, ny)
    mask[:, nx // 3] = True
    runner.run_simulation(p, mask)  # builds and warms every kernel
    margins = {"none": 0.0, "default": profiling.TRACE_MARGIN_S}
    runs, root = [], Path(tempfile.mkdtemp(prefix="trace_drops_"))
    try:
        for rep in range(args.reps):
            for label, margin in margins.items():
                runner._trace = functools.partial(profiling.trace,
                                                  margin_s=margin)
                tdir = root / f"{label}_{rep}"
                runner.run_simulation(p, mask, trace_dir=tdir)
                row = {"margin": label, "margin_s": margin, "rep": rep,
                       **drops(str(tdir))}
                shutil.rmtree(tdir)
                print(json.dumps(row), flush=True)
                runs.append(row)
    finally:
        runner._trace = profiling.trace
        shutil.rmtree(root, ignore_errors=True)
    summary = {label: {"runs": sum(r["margin"] == label for r in runs),
                       "runs_with_drops": sum(r["margin"] == label
                                              and bool(r["dropped"])
                                              for r in runs),
                       "most_dropped": max(len(r["dropped"]) for r in runs
                                           if r["margin"] == label),
                       "skew_us": [min(r["skew_us"] for r in runs
                                       if r["margin"] == label),
                                   max(r["skew_us"] for r in runs
                                       if r["margin"] == label)]}
               for label in margins}
    summary.update(device=torch.cuda.get_device_name(0), iters=args.iters,
                   grid=f"{nx}x{ny}")
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"summary": summary,
                                              "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
