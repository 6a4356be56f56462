#!/usr/bin/env python3
"""Time the one-step seam kernel (``csrc/fused_step.cu``'s
``fused_step_seam_kernel`` through ``parallel/halo.py``'s
``SeamShardImpl``, depth 1) over 4 shards on one card at the shapes its
rows in PERF.md rest on: the A/B behind rows 1s and 1sc.

Loop and device ms per step (``chip_smoke.py``'s ``time_turns``: CUDA
events, the median of 6 batches of 200 steps after a warm-up batch,
configurations in turns, forward then reverse; device: the queue
pre-filled behind a device sleep) of a one-step call at

- 1024x1024 (the scene's mask) over 4 shards, row plan;
- 16384x1024 over 4 shards, row plan;
- 131072x128 over 4 shards, the x-plan (column mode);
- 1024x1022 wall-less over 4 shards, the wrap discipline (pad 2), the
  plan ``auto`` takes there.

Where the checkout can (``SeamShardImpl``'s ``reach``), it also times the
same call with every halo copied (the form kept for cards without peer
access) and, at the wrap shape, with shard 0's pad row refreshed by a
copy a step (as before the kernel read it from its south halo). Each call
is held to the plain shard steps (max abs error of the cells after 4
steps; 0 expected).

To compare two checkouts on one card (the parent of the commit that
redesigned the kernel holds the copy-and-reduce form), run this script
once per checkout in one job, in turns (parent, change, change, parent):
``--repo DIR`` imports ``lbm_tpu_torch`` from DIR (a copy of another
commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) instead of from this checkout; the timing helpers
come from this checkout's ``chip_smoke.py``.

Usage: python scripts/seam_step_ab_torch.py [--repo DIR] [-o artifact.json]
       (A CUDA device is required.)
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# (grid NXxNY, mask kind, axis): axis 1 is the x-plan, the kernels in
# column mode; the wall-less mask makes the planner wrap-pad.
SHAPES = (("1024x1024", "scene", 0), ("16384x1024", "walls", 0),
          ("131072x128", "walls", 1), ("1024x1022", "random", 0))
SHARDS, STEPS, CHECK_STEPS = 4, 200, 4


def load_smoke():
    """chip_smoke.py's helpers (seeded states, event timing in turns)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def refresh_by_copy(torch, ss, impl):
    """``impl``'s call with shard 0's kernel reading its own pad row and
    that row refreshed from the last shard's top row by a copy on shard
    0's stream before the call, after the last shard's last launch."""
    from lbm_tpu_torch.ops import fused

    k0, w = impl.kernels[0], impl.wrap_pad
    impl.kernels[0] = fused.SeamStep(k0.mask, k0.hmask_s, k0.hmask_n, k0.w1,
                                     k0.w2, k0.omega, k0.row0, k0.ny,
                                     axis=k0.axis)
    first, last = ss.shards[0], ss.shards[-1]

    def fn():
        first.stream.wait_event(ss.record(last))
        with torch.cuda.stream(first.stream):
            first.cells[:, w - 1].copy_(last.cells[:, ss.h - 1])
        impl.run(0)
    return fn


def time_shapes(torch, cs, names=None, alternatives=True) -> dict:
    from lbm_tpu_torch.parallel import halo

    has_reach = alternatives and \
        "reach" in inspect.signature(halo.SeamShardImpl).parameters
    out = {}
    for i, (name, kind, axis) in enumerate(SHAPES):
        if names and name not in names:
            continue
        sp, cells, mesh = cs.shard_case(torch, name, kind, SHARDS,
                                        seed=98 + i, axis=axis)
        w = sp.wrap_pad
        sets = {}

        def make(label, **kw):
            ss = sets[label] = halo.ShardSet(sp.params, cells, sp.obstacles,
                                             mesh, STEPS + CHECK_STEPS, axis)
            return ss, halo.SeamShardImpl(ss, 1, w, **kw)

        calls = {}
        with cs.env():
            ss, impl = make("seam D=1")
            calls["seam D=1"] = (lambda impl=impl: impl.run(0), 1, ss)
            if has_reach:
                ss, impl = make("seam D=1, halos copied",
                                reach=lambda a, b: False)
                calls["seam D=1, halos copied"] = (
                    lambda impl=impl: impl.run(0), 1, ss)
                if w:
                    ss, impl = make("seam D=1, pad row refreshed by a copy")
                    calls["seam D=1, pad row refreshed by a copy"] = (
                        refresh_by_copy(torch, ss, impl), 1, ss)
        # Each configuration's cells after CHECK_STEPS calls from the
        # same state, against the plain shard steps.
        errors = {}
        plain = halo.ShardSet(sp.params, cells, sp.obstacles, mesh,
                              CHECK_STEPS, axis)
        cs.plain_shard_steps(plain, CHECK_STEPS, w)
        want = plain.gather()[:, sp.pad:]
        for label, (fn, _, ss) in calls.items():
            for _ in range(CHECK_STEPS):
                fn()
            ss.synchronize()
            errors[label] = float(
                (ss.gather()[:, sp.pad:] - want).abs().max())
        loop, dev = cs.time_turns(torch, calls, steps=STEPS)
        out[f"{name}/{SHARDS}" + (" x-plan" if axis else "")
            + (f" wrap pad {w}" if w else "")] = {
            "max_abs_err_vs_plain": errors,
            "loop_ms_per_step": {k: statistics.median(v)
                                 for k, v in loop.items()},
            "device_ms_per_step": {k: statistics.median(v)
                                   for k, v in dev.items()}}
        del sets, calls, plain, cells
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="import lbm_tpu_torch from this checkout")
    ap.add_argument("-o", "--output")
    ap.add_argument("--shapes", help="comma-separated grids of SHAPES to "
                    "time (default: all)")
    ap.add_argument("--kept-only", action="store_true",
                    help="time the checkout's own form alone, not the "
                    "copied halos and the copied pad row beside it")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("seam_step_ab_torch: no CUDA device", file=sys.stderr)
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
                  if "fused_step" in k},
              "shapes": time_shapes(
                  torch, cs, args.shapes.split(",") if args.shapes else None,
                  not args.kept_only)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
