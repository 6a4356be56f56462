#!/usr/bin/env python3
"""Time the on-chip form's strip step (``csrc/lbm_onchip.cuh``) in one
buffer (``resident_onchip_kernel<., ., 1>``, ``ring_onchip_kernel<., .,
1>``) and in two (``<., ., 2>``), where they fit, beside D = 4 or the
device-memory ring, at G = 100: the A/B behind rows 3o, 3i, 3ic, 4o, 4oc,
4i and 4ic in PERF.md, and the planner's choice between the two modes.

Loop and device ms per step (``chip_smoke.py``'s ``time_turns``: CUDA
events, the median of 10 batches after a warm-up batch, configurations in
turns, forward then reverse; device: the queue pre-filled behind a device
sleep) at

- the 1024x512 scene's lattice transposed (column mode, ``auto``'s path,
  row 3ic) and the physical 400x1024 (row mode, ``auto``'s, row 3i);
- the physical 1024x640 (rows of 1024 lanes) and 768x768, where only one
  buffer fits;
- 128x128, 256x256, 512x512, 640x512 and 792x528, where both fit (one
  buffer's tots the two buffers' bits: checked);
- the physical 1600x264 and 1200x396, strips of 2 and 3 rows wider than a
  wave (``auto`` runs both transposed);
- over 4 shards on one card: 768x768 (row plan, row 4i), the 1024x512
  x-plan (row 4ic), 256x256, 512x512 (row 4o) and the 1024x384 x-plan (row
  4oc; both fit in all three), with the device-memory ring (rounds of D =
  4) beside them.

To compare two checkouts on one card, run this script once per checkout
in one job, in turns (parent, change, change, parent): ``--repo DIR``
imports ``lbm_tpu_torch`` from DIR (a copy of another commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) instead
of from this checkout; the timing helpers come from this checkout's
``chip_smoke.py``.

Usage: python scripts/onchip_ab_torch.py [--repo DIR] [--shapes A,B]
       [-o artifact.json]
       (A CUDA device is required.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
G = 100
# grid NXxNY: (axis of the single-device lattice, or None: not timed
# there; axis of the 4-shard ring, or None).
SHAPES = {"128x128": (0, None), "256x256": (0, 0),
          "1024x512": (1, 1), "400x1024": (0, None), "1024x640": (0, None),
          "768x768": (0, 0), "512x512": (0, 0), "640x512": (0, None),
          "792x528": (0, None), "1024x384": (None, 1),
          "1600x264": (0, None), "1200x396": (0, None)}
SHARDS = 4


def load_smoke():
    """chip_smoke.py's helpers (seeded states, event timing in turns)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_single(torch, cs, name, axis) -> dict:
    from lbm_tpu_torch.ops import fused_depth, resident

    p = cs.scene_params(name)
    cells, mask = cs.random_case(torch, name, p, seed=91, state="perturbed")
    if axis:
        cells, mask = cs.transposed(cells, mask)
    rows, lanes = mask.shape
    w = (mask, p.accel_w1, p.accel_w2, p.omega)
    impls = {"one buffer": resident.Resident(*w, G, axis, form="inplace")}
    sms, smem = resident.device_limits("cuda")
    from lbm_tpu_torch.ops import plan

    if plan.onchip_fits(rows, lanes, sms, smem, 2):
        impls["two buffers"] = resident.Resident(*w, G, axis, form="onchip")
    impls["depth D=4"] = fused_depth.FusedDepth(*w, 4, axis)
    out = {"execution": [rows, lanes], "layout": "transposed" if axis
           else "physical", "strip_rows": -(-rows // impls[
               "one buffer"].blocks)}
    if "two buffers" in impls:
        tots = {}
        for label in ("one buffer", "two buffers"):
            t = torch.zeros(G, device="cuda")
            impls[label].run(cells.clone(), torch.empty_like(cells), t, 0,
                             1.0)
            tots[label] = t
        torch.cuda.synchronize()
        out["one_buffer_tots_are_two_buffer_bits"] = bool(
            torch.equal(tots["one buffer"], tots["two buffers"]))
    bufs = [cells, torch.empty_like(cells)]
    av = torch.zeros(G, device="cuda")
    loop, dev = cs.time_turns(torch, {
        label: (cs.runner_call(impl, bufs, av), impl.steps_per_call, None)
        for label, impl in impls.items()})
    out["loop_ms_per_step"], out["device_ms_per_step"] = loop, dev
    out["state_finite"] = bool(torch.isfinite(bufs[0]).all())
    return out


def time_ring(torch, cs, name, axis) -> dict:
    from lbm_tpu_torch.ops import plan, resident
    from lbm_tpu_torch.parallel import halo, resident_ring

    p = cs.scene_params(name)
    cells, mask = cs.random_case(torch, name, p, seed=95, state="perturbed")
    mesh = cs.shard_mesh(torch, SHARDS)
    ss = halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, G, axis)
    sms, smem = resident.device_limits("cuda")
    bps = resident_ring.ring_blocks(ss.h, SHARDS, sms)
    impls = {}
    for form, bufs in (("inplace", 1), ("onchip", 2)):
        if plan.onchip_smem_bytes(ss.h, ss.nx, bps, bufs) <= smem:
            impls[{"inplace": "one buffer", "onchip": "two buffers"}[
                form]] = resident_ring.RingOnchipImpl(ss, G, form)
    impls["device ring D=4"] = resident_ring.RingShardImpl(ss, G)
    loop, dev = cs.time_turns(torch, {
        label: (lambda impl=impl: impl.run(0), impl.steps_per_call, ss)
        for label, impl in impls.items()})
    return {"shards": SHARDS, "plan": "x-plan (column mode)" if axis
            else "row plan", "local_shape": [ss.h, ss.nx],
            "strip_rows": -(-ss.h // bps), "loop_ms_per_step": loop,
            "device_ms_per_step": dev,
            "state_finite": bool(torch.isfinite(ss.gather()).all())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="import lbm_tpu_torch from this checkout")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("onchip_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = load_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {"repo": os.path.relpath(args.repo, REPO), "card": smi, "G": G,
              "single": {},
              "ring": {}}
    for name in args.shapes.split(","):
        single, ring = SHAPES[name]
        with cs.env():
            if single is not None:
                result["single"][name] = time_single(torch, cs, name, single)
            if ring is not None:
                result["ring"][name] = time_ring(torch, cs, name, ring)
        torch.cuda.empty_cache()
    for part in ("single", "ring"):
        for name, r in result[part].items():
            r["median_ms"] = {k: statistics.median(v) for k, v in
                              r["device_ms_per_step"].items()}
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
