#!/usr/bin/env python3
"""A/B of the port's knobs on the card: ``sweep_torch.measure`` (the
shared timing rule: one untimed run, then the best of N, CUDA events)
per ``(grid, env)`` cell, one JSON line a cell. Only the port's knobs
are taken (``sweep_torch.KNOBS``: LBM_RESIDENT, LBM_RESIDENT_STEPS,
LBM_RESIDENT_FORM, LBM_PALLAS_DEPTH, LBM_PAIRED_EQ, LBM_OMEGA_EQ,
LBM_SHARD_RESIDENT); every other one is cleared while a cell runs.
The defaults time the three f32 associations of the BGK update (the
paired equilibrium, the default; the reference's term order,
LBM_PAIRED_EQ=0; the omega-absorbed relaxation, LBM_OMEGA_EQ=1) at
1024x1024 and 131072x128 under ``auto``. ``--turns 2`` runs the list
forward, then backward, so each cell's neighbours differ.

Usage: python scripts/ab_kernel_torch.py [config ...] [--turns N]
           [--repeats R] [--device cuda|cpu]
  config = name:nx:ny:iters[:ENV=V,ENV=V]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import sweep_torch  # noqa: E402

DEFAULTS = [
    ("1024sq-paired", 1024, 1024, 2000, {}),
    ("1024sq-refassoc", 1024, 1024, 2000, {"LBM_PAIRED_EQ": "0"}),
    ("1024sq-omega", 1024, 1024, 2000, {"LBM_OMEGA_EQ": "1"}),
    ("131k-paired", 131072, 128, 2000, {}),
    ("131k-refassoc", 131072, 128, 2000, {"LBM_PAIRED_EQ": "0"}),
    ("131k-omega", 131072, 128, 2000, {"LBM_OMEGA_EQ": "1"}),
]


def parse(arg: str):
    parts = arg.split(":")
    if not 4 <= len(parts) <= 5:
        raise SystemExit(
            f"config {arg!r}: expected name:nx:ny:iters[:ENV=V,ENV=V]")
    name, nx, ny, iters, envs = (parts + [""])[:5]
    env = dict(kv.split("=", 1) for kv in envs.split(",") if kv)
    unknown = set(env) - set(sweep_torch.KNOBS)
    if unknown:
        raise SystemExit(f"config {arg!r}: not a knob of the port: "
                         f"{sorted(unknown)}")
    return name, int(nx), int(ny), int(iters), env


def run_one(name, nx, ny, iters, env, repeats=3, device="cuda",
            kernel="auto"):
    t0 = time.perf_counter()
    try:
        m = sweep_torch.measure(nx, ny, iters, kernel, env, repeats, device)
    except Exception as exc:  # record the failure, keep going
        return {"name": name, "env": env,
                "error": f"{type(exc).__name__}: {exc}"[:500]}
    return {"name": name, "nx": nx, "ny": ny, "iters": iters, "env": env,
            "kernel": kernel, **m, "ms_per_step": m["seconds"] / iters * 1e3,
            "wall_s": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("configs", nargs="*")
    p.add_argument("--turns", type=int, default=1)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "cuda", "reference"])
    args = p.parse_args(argv)
    cases = [parse(a) for a in args.configs] or DEFAULTS
    smi = sweep_torch.card() if args.device.startswith("cuda") else None
    failed = False
    for turn in range(args.turns):
        for case in (cases if turn % 2 == 0 else cases[::-1]):
            row = {**run_one(*case, repeats=args.repeats, device=args.device,
                             kernel=args.kernel), "turn": turn + 1}
            if smi:
                row["nvidia_smi"] = smi
            failed |= "error" in row
            print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
