#!/usr/bin/env python3
"""Time the resident kernel's device-memory form
(``lbm_tpu_torch/ops/resident.py``, ``csrc/resident.cu``) at G = 100
beside the depth kernel at D = 4: the A/B behind its rows in PERF.md and
the numbers ``ops/plan.py``'s ``RESIDENT_AUTO_MAX_CELLS`` is set from.

Loop and device ms per step (``chip_smoke.py``'s ``time_turns``: CUDA
events, the median of 10 batches after a warm-up batch, configurations in
turns, forward then reverse; device: the queue pre-filled behind a device
sleep) at

- 1024x1024 (the scene's mask), physical, the form pinned to device;
- 16384x1024 and 131072x128, transposed (column mode);
- 512x512, physical, the form pinned (the lattice in L2);
- 4096x64 and 8192x32 as ``--kernel auto`` plans them (narrow channels
  in row mode):
  the script asserts that each plan is the device-memory form, in its
  shift mode where the checkout has one (``resident G=100 device-memory
  shift``);
- 1024x400 transposed (a tall box, column mode), the form pinned: auto
  takes the on-chip form's single-buffer mode there;
- the crossover grids of ``chip_smoke.py`` (640x512 to 1024x768,
  physical), the form pinned.

In row mode the device form's shift mode (``LBM_RESIDENT_SHIFT``) is timed
beside them where the checkout has it, and, where the checkout's shift mode
has two residences, also in the one its rule does not pick, where that
one's block fits. At each shape one call of each
configuration is also held against the plain version
(``ops.reference.multi_step``): the cells' max abs error, and whether the
form's (and the shift mode's) per-step tots are the bits of 25 D = 4
calls'.

To compare two checkouts on one card, run this script once per checkout
in one job, in turns (parent, change, change, parent): ``--repo DIR``
imports ``lbm_tpu_torch`` from DIR (a copy of another commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) instead
of from this checkout; the timing helpers come from this checkout's
``chip_smoke.py``.

Usage: python scripts/resident_ab_torch.py [--repo DIR] [--shapes A,B]
       [-o artifact.json [--append LABEL]]
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
G, D = 100, 4
# grid NXxNY: "device" (physical, the form pinned), "transposed" (column
# mode, the form pinned) or "auto" (the layout and form the planner takes).
SHAPES = {"1024x1024": "device", "16384x1024": "transposed",
          "131072x128": "transposed", "512x512": "device",
          "4096x64": "auto", "8192x32": "auto", "1024x400": "transposed"}


def load_smoke():
    """chip_smoke.py's helpers (seeded states, event timing in turns)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup(torch, cs, name, how):
    """The state, mask, axis and plan line of one shape."""
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.ops import plan

    p = cs.scene_params(name)
    cells, mask = cs.random_case(
        torch, name, p, seed=96, state="perturbed",
        mask_kind="scene" if name == cs.SCENE else "walls")
    planned = None
    if how == "auto":
        with cs.env():
            axis = int(runner.plan_layout(p, "cuda"))
            planned = plan.describe(runner.plan_run(p, "cuda", G, None,
                                                    "cuda"))
        cs.check(planned in (f"resident G={G} device-memory x1",
                             f"resident G={G} device-memory shift x1"),
                 f"{name} under auto plans {planned}")
    else:
        axis = int(how == "transposed")
    if axis:
        cells, mask = cs.transposed(cells, mask)
    return p, cells, mask, axis, planned


def check_shape(torch, p, cells, mask, axis, impls):
    """One call of the device form and G / D calls of the depth kernel
    against G plain steps: each one's cells' max abs error, and whether
    the form's tots are the depth calls' bits."""
    from lbm_tpu_torch.ops import reference as ref_ops

    want, _ = ref_ops.multi_step(cells, mask, p.accel_w1, p.accel_w2,
                                 p.omega, G, axis)
    dep = impls[f"depth D={D}"]
    c, spare = cells.clone(), torch.empty_like(cells)
    dtots = torch.zeros(G, device="cuda")
    for t in range(0, G, D):
        c, spare = dep.run(c, spare, dtots, t)
    out = {"depth_max_abs_err": float((c - want).abs().max())}
    for label, key in (("device", "device G=100"), ("shift", "shift G=100"),
                       ("shift_device_residence",
                        "shift G=100 device residence"),
                       ("shift_shared_residence",
                        "shift G=100 shared residence")):
        res = impls.get(key)
        if res is None:
            continue
        bufs = [cells.clone(), torch.empty_like(cells)]
        tots = torch.zeros(G, device="cuda")
        got, _ = res.run(bufs[0], bufs[1], tots)
        torch.cuda.synchronize()
        out[f"{label}_max_abs_err"] = float((got - want).abs().max())
        out[f"{label}_tots_equal_depth"] = bool(torch.equal(tots, dtots))
    return out


def time_shapes(torch, cs, shapes) -> dict:
    from lbm_tpu_torch.ops import fused_depth, plan, resident

    out = {}
    for name, how in shapes.items():
        p, cells, mask, axis, planned = setup(torch, cs, name, how)
        w = (mask, p.accel_w1, p.accel_w2, p.omega)
        with cs.env():
            impls = {"device G=100": resident.Resident(*w, G, axis,
                                                       form="device"),
                     f"depth D={D}": fused_depth.FusedDepth(*w, D, axis)}
            if not axis and "shift" in plan.RESIDENT_FORMS:
                impls["shift G=100"] = resident.Resident(*w, G, form="shift")
                # The other residence where the checkout has two and the
                # other's block fits.
                mine = getattr(impls["shift G=100"], "residence", None)
                other = {"shared": "device", "device": "shared"}.get(mine)
                sms, smem = resident.device_limits("cuda")
                if other == "device" or (other == "shared" and plan.shift_fits(
                        *mask.shape, sms, smem)):
                    impls[f"shift G=100 {other} residence"] = \
                        resident.Resident(*w, G, form="shift",
                                          residence=other)
        res = check_shape(torch, p, cells, mask, axis, impls)
        cs.check(all(v == 0.0 for k, v in res.items()
                     if k.endswith("max_abs_err")),
                 f"{name}: cells != plain {res}")
        bufs = [cells, torch.empty_like(cells)]
        av = torch.zeros(G, device="cuda")
        loop, dev = cs.time_turns(torch, {
            k: (cs.runner_call(impl, bufs, av), impl.steps_per_call, None)
            for k, impl in impls.items()}, steps=2 * G)
        med = {k: statistics.median(v) for k, v in dev.items()}
        out[name] = {"how": how, "axis": axis, "plan": planned,
                     "blocks": impls["device G=100"].blocks, **res,
                     "loop_ms_per_step": loop, "device_ms_per_step": dev,
                     "device_over_depth4": med["device G=100"]
                     / med[f"depth D={D}"]}
        if "shift G=100" in med:
            out[name]["shift_over_device"] = (med["shift G=100"]
                                              / med["device G=100"])
        print(json.dumps({name: out[name]}), file=sys.stderr, flush=True)
        del cells, mask, bufs, impls
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="import lbm_tpu_torch from this checkout")
    ap.add_argument("--shapes", help="comma-separated grids (default: the "
                    "six shapes and the crossover grids)")
    ap.add_argument("-o", "--output")
    ap.add_argument("--append", metavar="LABEL",
                    help="add this run, labelled, to the runs the output "
                    "file holds (parent, change, change, parent in turns)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("resident_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    from lbm_tpu_torch.ops import _build

    cs = load_smoke()
    shapes = {**SHAPES, **dict.fromkeys(cs.CROSSOVER_GRIDS, "device")}
    if args.shapes:
        shapes = {s: shapes.get(s, "device") for s in args.shapes.split(",")}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    path, seconds = _build.build()
    log = path.with_suffix(".log")
    result = {"repo": args.repo, "card": smi, "build_s": seconds,
              "ptxas": {k: v for k, v in cs.ptxas_table(
                  log.read_text() if log.exists() else "").items()
                  if "resident" in k and "onchip" not in k},
              "shapes": time_shapes(torch, cs, shapes)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        if args.append:
            runs = (json.loads(out.read_text())["runs"] if out.exists()
                    else [])
            text = json.dumps({"runs": runs + [{"label": args.append,
                                                **result}]})
        out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
