#!/usr/bin/env python3
"""Time the ring (``lbm_tpu_torch/parallel/resident_ring.py``,
``csrc/ring.cu``) over 4 shards on one card at the shapes its rows in
PERF.md rest on, beside the seam depth kernel: the A/B behind the ring's
rows.

Loop and device ms per step (``chip_smoke.py``'s ``time_turns``: CUDA
events, the median of 6 batches of 100 steps after a warm-up batch,
configurations in turns, forward then reverse; device: the queue
pre-filled behind a device sleep) of the seam depth kernel at D = 4 (the
plan ``auto`` takes under a mesh) and the ring at G = 100 at

- 1024x1024 (the scene's mask) over 4 shards, row plan;
- 16384x1024 over 4 shards, row plan;
- 131072x128 over 4 shards, the x-plan (column mode).

To compare two checkouts on one card (the parent of the commit that gave
the ring its D-step rounds holds the step-a-round form), run this script
once per checkout in one job, in turns (parent, change, change, parent):
``--repo DIR`` imports ``lbm_tpu_torch`` from DIR (a copy of another
commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) instead of from this checkout; the timing helpers
come from this checkout's ``chip_smoke.py``.

Usage: python scripts/ring_ab_torch.py [--repo DIR] [-o artifact.json]
       (A CUDA device is required.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# (grid NXxNY, axis): axis 1 is the x-plan, the kernels in column mode.
SHAPES = (("1024x1024", 0), ("16384x1024", 0), ("131072x128", 1))
SHARDS, G, D = 4, 100, 4


def load_smoke():
    """chip_smoke.py's helpers (seeded states, event timing in turns)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_shapes(torch, cs) -> dict:
    from lbm_tpu_torch.parallel import halo, resident_ring

    out = {}
    for name, axis in SHAPES:
        p = cs.scene_params(name)
        cells, mask = cs.random_case(
            torch, name, p, seed=98, state="perturbed",
            mask_kind="scene" if name == cs.SCENE else "walls")
        ss = halo.ShardSet(p, cells, mask.cpu().numpy(),
                           cs.shard_mesh(torch, SHARDS), G, axis)
        with cs.env():
            impls = {f"seam D={D}": halo.SeamShardImpl(ss, D),
                     f"ring G={G}": resident_ring.RingShardImpl(ss, G)}
        loop, dev = cs.time_turns(torch, {
            k: (lambda impl=impl: impl.run(0), impl.steps_per_call, ss)
            for k, impl in impls.items()}, steps=G)
        out[f"{name}/{SHARDS}" + (" x-plan" if axis else "")] = {
            "ring_depth": getattr(impls[f"ring G={G}"], "depth", 1),
            "loop_ms_per_step": {k: statistics.median(v)
                                 for k, v in loop.items()},
            "device_ms_per_step": {k: statistics.median(v)
                                   for k, v in dev.items()}}
        del ss, impls, cells
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="import lbm_tpu_torch from this checkout")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("ring_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    from lbm_tpu_torch.ops import _build

    cs = load_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    path, seconds = _build.build()
    log = path.with_suffix(".log")
    result = {"repo": args.repo, "card": smi, "build_s": seconds,
              "ptxas": {k: v for k, v in cs.ptxas_table(
                  log.read_text() if log.exists() else "").items()
                  if "ring" in k},
              "shapes": time_shapes(torch, cs)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
