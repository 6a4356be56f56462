#!/usr/bin/env python3
"""Measure the streaming share of a lattice step on the card: the twin of
scripts/stream_cost_probe.py for the PyTorch/CUDA port.

Three variants of one persistent cooperative launch of G steps
(``lbm_tpu_torch/csrc/probe.cu``): the device-memory resident form's
structure (``csrc/resident.cu``), rounds of 4, 2 and 1 steps on the depth
kernel's tiles with one grid barrier a round, without forcing. The
variants differ only in the tile's stage body (``csrc/lbm_depth.cuh``'s
``kStage``); the window load, the stages, their barriers, the partials
and the store are the same in all three:

- ``full``     pull streaming + BGK collision (the production operation mix),
- ``collide``  BGK collision of each cell's own speeds (streaming elided),
- ``stream``   pull streaming + copy-back (collision elided; the total is a
               plain plane sum, so a dependent scalar still forces
               completion).

``collide`` and ``stream`` are wrong physics by construction (values stay
bounded); they exist only to split the stage loop's time between a
step's two halves under one memory and loop structure. Each mode is
timed with CUDA events over ``--repeats`` launches of ``--gsteps`` steps
after one untimed launch, the modes in turns (forward, then reverse). Two
estimates of the streaming share come out: subtractive, (full - collide)
/ full, and direct, stream / full. They bracket the truth where the
halves overlap. The summary names the card (``nvidia-smi`` name and power
limit), the launch's blocks and its rounds.

Usage: python scripts/stream_cost_probe_torch.py [--grid 1024x1024]
           [--gsteps 2000] [--repeats 3] [-o artifact.json]
       (A CUDA device is required: a CPU run times PyTorch's CPU ops, not
        the card, so without one the script refuses rather than mislabel.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def measure(nx: int, ny: int, gsteps: int, repeats: int):
    """``(seconds, kernels)``: device seconds per launch of each mode (the
    median over ``repeats`` in each of two turns), on the equilibrium
    state with the generator's obstacle walls, and the mode's kernel."""
    import numpy as np
    import torch

    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import probe
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    params = Params(nx=nx, ny=ny, max_iters=gsteps, reynolds_dim=10,
                    density=np.float32(0.1), accel=np.float32(0.01),
                    omega=np.float32(1.85))
    dev = torch.device("cuda")
    mask = torch.from_numpy(generate_obstacles(nx, ny)).to(dev)
    a, b = initial_state(params, dev), torch.empty(9, ny, nx, device=dev)
    tots = torch.empty(gsteps, device=dev)
    kernels = {m: probe.Probe(mask, params.omega, gsteps, m)
               for m in probe.MODES}
    for k in kernels.values():
        k.run(a, b, tots)  # untimed first launch
    torch.cuda.synchronize()
    times = {m: [] for m in probe.MODES}
    for mode in list(probe.MODES) + list(reversed(probe.MODES)):
        for _ in range(repeats):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            kernels[mode].run(a, b, tots)
            t1.record()
            t1.synchronize()
            times[mode].append(t0.elapsed_time(t1) / 1e3)
    return {m: statistics.median(v) for m, v in times.items()}, kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grid", default="1024x1024")
    p.add_argument("--gsteps", type=int, default=2000,
                   help="steps per timed launch (even: buffer parity)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("-o", "--output", default=None,
                   help="also write the rows and the derived shares as JSON")
    args = p.parse_args(argv)
    nx, ny = (int(v) for v in args.grid.split("x"))
    if args.gsteps < 2 or args.gsteps % 2:
        raise SystemExit("--gsteps must be even (buffer parity)")

    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"grid": args.grid, "error":
                          "requires a CUDA device, got none "
                          "(torch.cuda.is_available() is False)"}))
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    seconds, kernels = measure(nx, ny, args.gsteps, args.repeats)
    rows = [{"mode": m, "nx": nx, "ny": ny, "gsteps": args.gsteps,
             "seconds": s, "ms_per_step": s / args.gsteps * 1e3,
             "glups": nx * ny * args.gsteps / s / 1e9, "backend": "cuda"}
            for m, s in seconds.items()]
    for r in rows:
        print(json.dumps(r), flush=True)
    t_full = seconds["full"]
    summary = {
        "grid": args.grid, "gsteps": args.gsteps, "rows": rows,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        # The launch geometry, the same in every mode.
        "blocks": kernels["full"].blocks,
        "rounds": "+".join(f"{kernels['full'].rounds.count(d)}x{d}"
                           for d in (4, 2, 1)
                           if d in kernels["full"].rounds),
        # Two independent estimates of the streaming share: they bracket
        # the truth where the halves overlap.
        "stream_share_subtractive": (t_full - seconds["collide"]) / t_full,
        "stream_share_direct": seconds["stream"] / t_full,
    }
    print(json.dumps(summary), flush=True)
    if args.output:
        Path(args.output).write_text(json.dumps(summary, indent=2) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
