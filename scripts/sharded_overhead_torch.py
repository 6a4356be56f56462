#!/usr/bin/env python3
"""The sharded path's structure cost on one card: a mesh of one shard
against the unsharded run, both with ``LBM_RESIDENT=0`` (the depth
kernel, so the resident kernel, which never runs under a mesh, does not
count as sharding overhead), as ``scripts/sharded_overhead.py`` measures
the JAX package's. One shard exchanges its halos with itself, so the
difference is what the seam kernels, the halo plan and the per-shard
streams cost before any neighbour traffic. In process, by
``sweep_torch.measure``: one untimed run, then the best of N, CUDA events.

Usage: python scripts/sharded_overhead_torch.py [--grids 1024x1024 ...]
           [--iters 2000] [--repeats 3] [--device cuda|cpu]
           [-o docs/artifacts/sharded_overhead_torch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import sweep_torch  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grids", nargs="+", default=["1024x1024", "16384x1024"])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("-o", "--output",
                   default="docs/artifacts/sharded_overhead_torch.json")
    args = p.parse_args(argv)
    env = {"LBM_RESIDENT": "0"}
    results = {"iters": args.iters, "repeats": args.repeats,
               "nvidia_smi": sweep_torch.card()
               if args.device.startswith("cuda") else None,
               "method": "1-shard mesh vs unsharded, both LBM_RESIDENT=0, "
                         "sweep_torch.measure (best of repeats after one "
                         "untimed run)", "cases": []}
    failed = False
    for g in args.grids:
        nx, ny = (int(v) for v in g.split("x"))
        row = {"grid": g}
        try:
            solo = sweep_torch.measure(nx, ny, args.iters, "auto", env,
                                       args.repeats, args.device)
            shard = sweep_torch.measure(nx, ny, args.iters, "auto", env,
                                        args.repeats, args.device, shards=1)
            row.update({
                "unsharded": solo, "sharded_1": shard,
                "overhead_pct": 100.0 * (shard["seconds"] - solo["seconds"])
                / solo["seconds"]})
        except Exception as exc:  # record the failure, keep going
            failed = True
            row["error"] = f"{type(exc).__name__}: {exc}"[:500]
        print(json.dumps(row), flush=True)
        results["cases"].append(row)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
