#!/usr/bin/env python3
"""Per-kernel time table from a torch.profiler trace of the PyTorch/CUDA
port: the twin of scripts/trace_report.py for ``lbm_tpu_torch``.

Two modes:

- ``--capture``: run a short 1024x1024 scene through
  ``lbm_tpu_torch.runner.run_simulation(..., trace_dir=)`` (the hook behind
  ``python -m lbm_tpu_torch ... --trace DIR``) after one untraced run, then
  summarise the capture. Needs a CUDA device unless ``--device cpu``.
- ``TRACEDIR`` positional: summarise an existing trace directory.

The profiler writes Chrome-trace JSON. Per kernel name the summary gives
launches, total and mean device time, and beside them the card's busy
share of the traced window and its longest idle gaps
(``lbm_tpu_torch.profiling.summarise``).

Usage: python scripts/trace_report_torch.py [TRACEDIR] [--capture]
           [--iters 2000] [--device cuda] [-o report.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def capture(tracedir: str, iters: int, device: str) -> None:
    import numpy as np

    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.runner import run_simulation

    params = Params(nx=1024, ny=1024, max_iters=iters, reynolds_dim=10,
                    density=np.float32(0.1), accel=np.float32(0.01),
                    omega=np.float32(1.85))
    obstacles = generate_obstacles(params.nx, params.ny)
    # One untraced run first: the traced region should hold steady-state
    # execution, not the kernels' build and first launches.
    run_simulation(params, obstacles, kernel="auto", device=device)
    res = run_simulation(params, obstacles, kernel="auto", device=device,
                         trace_dir=tracedir)
    cells = params.nx * params.ny * iters
    print(f"captured: compute={res.timings['compute']:.3f}s "
          f"({cells / res.timings['compute'] / 1e9:.2f} GLUPS, traced)")


def main(argv=None) -> int:
    from lbm_tpu_torch import profiling

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tracedir", nargs="?", default="build/lbm_tpu_torch/trace")
    ap.add_argument("--capture", action="store_true",
                    help="run a traced 1024x1024 simulation first")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-o", "--output", default=None,
                    help="also write the summary as JSON")
    args = ap.parse_args(argv)

    if args.capture:
        capture(args.tracedir, args.iters, args.device)
    report = profiling.summarise(args.tracedir)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps(report, indent=2) + "\n")
    print(profiling.format_summary(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
