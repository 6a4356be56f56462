#!/usr/bin/env python3
"""Time the depth kernel (``lbm_tpu_torch/csrc/fused_depth.cu``) on the
card at the shapes its rules rest on, and hold it against its plain
version: the measurement behind the depth kernel's rows in PERF.md.

Device ms per step (CUDA events, the queue pre-filled behind a device
sleep, median of 10 batches of ~200 steps, configurations in turns) of

- D = 2, 4, 8 at 1024x1024 (the scene's mask) and 16384x1024, physical;
- D = 2, 4, 8 at 131072x128 on the transposed lattice (column mode);
- the seam mode at D = 4 over 4 shards of 1024x1024 on one card, and the
  halo-free resident kernel at 512x512 beside D = 4 (the ``auto`` rule);

With ``--flow``, only the depth kernel's flow form (D = 4, K rounds a
launch, ``FusedDepth(..., rounds=K)``) beside one round a launch, device
ms per step over batches of 1000 steps, at the shapes its rule
(``ops/plan.py``'s ``FLOW_MAX_WAVES``) rests on: in row mode 1024x1024
(5.2 waves of an H100's 264 slots; K = 5, 10, 25, 50) and the tall
1024x1152, 1024x1280, 1024x1536, 1024x2048 and 1024x4096 (5.8, 6.5, 7.8,
10.4 and 20.7 waves; K = 25),
in column mode the transposed 2048x1024, 4096x1024, 8192x1024 and
16384x1024 (10.4 to 82.8 waves; K = 25), each
with its waves, its flow launches' wait share and, with ``--check``, the
flow form's cells and tots against as many one-round launches (bits).

and, with ``--check``, one call of every depth and mode against
``ops.reference.multi_step`` (cells: max abs error; totals: relative
error) and a step's total at the first and at the last stage of a launch
(``stage_bits_equal``). ``--sass`` adds the opcode counts of the row-mode
D = 4 kernel, the device-memory resident form's row-mode kernel and the
stream-cost probe's three modes (paired association) as ``cuobjdump
-sass`` prints them (static counts: how many loads, stores, shuffles,
barriers and arithmetic instructions the compiler emitted, and whether it
spilled to local memory; the probe's modes differ only in the stage body,
so their shared loads, ``LDS``, say what each body reads).

To compare two checkouts on one card, run this script once per checkout
in one job, in turns (parent, change, change, parent): ``--repo DIR``
imports ``lbm_tpu_torch`` from DIR (a copy of another commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists) instead
of from this checkout.

Usage: python scripts/depth_ab_torch.py [--repo DIR] [--check] [--sass]
           [--depths 2,4,8] [--flow] [-o artifact.json]
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
GRIDS = (("1024x1024", 0), ("16384x1024", 0), ("131072x128", 1))


def load_smoke():
    """chip_smoke.py's helpers (seeded states, event timing in turns)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_grids(torch, cs, depths) -> dict:
    from lbm_tpu_torch.ops import fused_depth, resident

    out = {}
    for name, axis in GRIDS + (("512x512", 0),):
        p = cs.scene_params(name)
        cells, mask = cs.random_case(
            torch, name, p, seed=99, state="perturbed",
            mask_kind="scene" if name == cs.SCENE else "walls")
        if axis:
            cells, mask = cs.transposed(cells, mask)
        w = (mask, p.accel_w1, p.accel_w2, p.omega)
        bufs = [cells, torch.empty_like(cells)]
        av = torch.zeros(100, device="cuda")
        with cs.env():
            impls = {f"D={d}": fused_depth.FusedDepth(*w, d, axis)
                     for d in depths}
            if name == "512x512":
                impls["resident G=100"] = resident.Resident(*w, 100)
        _, dev = cs.time_turns(torch, {
            k: (cs.runner_call(impl, bufs, av), impl.steps_per_call, None)
            for k, impl in impls.items()})
        out[name + (" transposed" if axis else "")] = {
            k: statistics.median(v) for k, v in dev.items()}
        del cells, bufs, impls
        torch.cuda.empty_cache()
    return out


def time_seam(torch, cs) -> dict:
    from lbm_tpu_torch.parallel import halo

    p = cs.scene_params(cs.SCENE)
    cells, mask = cs.random_case(torch, cs.SCENE, p, seed=98,
                                 state="perturbed", mask_kind="scene")
    mesh = cs.shard_mesh(torch, cs.N_SHARDS)
    ss = halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, 100)
    with cs.env():
        impl = halo.SeamShardImpl(ss, 4)
    _, dev = cs.time_turns(torch, {"seam D=4": (lambda: impl.run(0), 4, ss)})
    return {"1024x1024 over 4 shards": {
        k: statistics.median(v) for k, v in dev.items()}}


def check_kernel(torch, cs, depths) -> dict:
    """One call per depth and axis against the plain version, and a
    step's total at the first and at the last stage of a launch."""
    from lbm_tpu_torch.ops import fused_depth
    from lbm_tpu_torch.ops import reference as ref_ops

    out = {}
    for name, kind in (("1024x1024", "scene"), ("100x130", "random"),
                       ("264x100", "random"), ("36x20", "random")):
        for axis in (0, 1):
            p = cs.scene_params(name, iters=200)
            cells, mask = cs.random_case(torch, name, p, 7, kind, "perturbed")
            if axis:
                cells, mask = cs.transposed(cells, mask)
            w = (mask, p.accel_w1, p.accel_w2, p.omega)
            for d in depths:
                with cs.env():
                    got, tots = fused_depth.fused_depth(cells, *w, d, axis)
                    want, want_tots = ref_ops.multi_step(cells, *w, d, axis)
                    # Step d - 1 (0-based) is the last stage of the launch
                    # above and the first of one that starts there.
                    prev, _ = ref_ops.multi_step(cells, *w, d - 1, axis)
                    _, later = fused_depth.fused_depth(prev, *w, d, axis)
                torch.cuda.synchronize()
                out[f"{name} axis {axis} D={d}"] = {
                    "max_abs_err": float((got - want).abs().max()),
                    "tot_rel_err": float(((tots - want_tots).abs()
                                          / want_tots.abs()).max()),
                    "stage_bits_equal": bool(tots[d - 1] == later[0])}
    return out


# --flow's grids (physical NXxNY, layout axis) and rounds a launch.
FLOW_GRIDS = (("1024x1024", 0, (5, 10, 25, 50)), ("1024x1152", 0, (25,)),
              ("1024x1280", 0, (25,)), ("1024x1536", 0, (25,)),
              ("1024x2048", 0, (25,)), ("1024x4096", 0, (25,)),
              ("2048x1024", 1, (25,)), ("4096x1024", 1, (25,)),
              ("8192x1024", 1, (25,)), ("16384x1024", 1, (25,)))


def time_flow(torch, cs, check: bool) -> dict:
    """Device ms a step of one round a launch and of the flow form at
    FLOW_GRIDS, in turns; each grid's tiles, waves of the card's slots,
    and each K's waits over its flowing tiles in the timed launches."""
    from lbm_tpu_torch.ops import fused_depth

    out = {}
    for name, axis, ks in FLOW_GRIDS:
        p = cs.scene_params(name)
        cells, mask = cs.random_case(
            torch, name, p, seed=97, state="perturbed",
            mask_kind="scene" if name == cs.SCENE else "walls")
        if axis:
            cells, mask = cs.transposed(cells, mask)
        w = (mask, p.accel_w1, p.accel_w2, p.omega)
        bufs = [cells.clone(), torch.empty_like(cells)]
        av = torch.zeros(4 * max(ks), device="cuda")
        with cs.env():
            impls = {"K=1": fused_depth.FusedDepth(*w, 4, axis),
                     **{f"K={k}": fused_depth.FusedDepth(*w, 4, axis, k)
                        for k in ks}}
        _, dev = cs.time_turns(torch, {
            k: (cs.runner_call(impl, bufs, av), impl.steps_per_call, None)
            for k, impl in impls.items()}, steps=1000)
        torch.cuda.synchronize()
        slots = fused_depth.block_slots("cuda", axis)
        row = {"tiles": impls["K=1"].n_tiles, "slots": slots,
               "waves": impls["K=1"].n_tiles / slots,
               "device_ms_per_step": {k: statistics.median(v)
                                      for k, v in dev.items()},
               "wait_pct": {k: 100 * impl.waits() / impl.flow_tiles
                            for k, impl in impls.items() if impl.flow_tiles}}
        if check:
            k = ks[-1]
            a = [cells.clone(), torch.empty_like(cells)]
            b = [cells.clone(), torch.empty_like(cells)]
            tots_a = torch.zeros(4 * k, device="cuda")
            tots_b = torch.zeros(4 * k, device="cuda")
            a[:] = impls[f"K={k}"].run(a[0], a[1], tots_a, 0, 1.0)
            for r in range(k):
                b[:] = impls["K=1"].run(b[0], b[1], tots_b, 4 * r, 1.0)
            torch.cuda.synchronize()
            row["bits_equal"] = bool(torch.equal(a[0], b[0])
                                     and torch.equal(tots_a, tots_b))
        out[name + (" transposed" if axis else "")] = row
        del cells, bufs, impls
        torch.cuda.empty_cache()
    return out


# The kernels --sass counts, by a part of their mangled names.
SASS_KERNELS = {"fused_depth_kernel<4,0,0>": "fused_depth_kernelILi4ELb0ELb0",
                "resident_kernel<0,0>": "resident_kernelILb0ELi0E",
                "probe full": "probe_kernelILi0ELi0E",
                "probe collide": "probe_kernelILi1ELi0E",
                "probe stream": "probe_kernelILi2ELi0E"}


def kernel_name(mangled: str) -> str:
    """A kernel's short name with its template arguments
    (``resident_onchip_kernel<1,0,2>``), as chip_smoke.py's ptxas table
    names it."""
    import re

    k = re.search(r"\d+([a-z_]+_(?:kernel|tile))(?:I((?:L[ib]\d+E)+)E)?",
                  mangled)
    if k is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", k.group(2) or "")
    return k.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_opcodes(library: Path, kernels=SASS_KERNELS,
                 modifiers: bool = False) -> dict:
    """``{kernel: {opcode: count}}`` of each of ``kernels`` (label: a part
    of its mangled name; None: every function, under :func:`kernel_name`)
    in the built library (a kernel the library lacks: none), most frequent
    first; memory opcodes keep their width (``LDS.64``), the others only
    their name, or, ``modifiers``, every opcode all its modifiers
    (``LDG.E.CONSTANT``: a load through the non-coherent path)."""
    import collections
    import re

    out = subprocess.run(["cuobjdump", "-sass", str(library)],
                         capture_output=True, text=True, check=True).stdout
    counts, inside = collections.defaultdict(collections.Counter), None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            inside = (kernel_name(m.group(1)) if kernels is None else
                      next((k for k, part in kernels.items()
                            if part in m.group(1)), None))
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)", ln)
        if m and inside:
            parts = m.group(1).split(".")
            memory = parts[0] in ("LDS", "STS", "LDG", "STG", "LDL", "STL")
            op = (m.group(1) if modifiers else
                  ".".join(parts[:2]) if memory else parts[0])
            counts[inside][op] += 1
    return {k: dict(c.most_common()) for k, c in counts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="import lbm_tpu_torch from this checkout")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--depths", default="2,4,8")
    ap.add_argument("--flow", action="store_true",
                    help="time the flow form alone (see above)")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("depth_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    from lbm_tpu_torch.ops import _build

    cs = load_smoke()
    depths = tuple(int(d) for d in args.depths.split(","))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    path, seconds = _build.build()
    log = path.with_suffix(".log")
    result = {"repo": args.repo, "card": smi, "build_s": seconds,
              "ptxas": {k: v for k, v in cs.ptxas_table(
                  log.read_text() if log.exists() else "").items()
                  if "depth" in k or "resident_kernel" in k or "probe" in k}}
    if args.flow:
        result["flow"] = time_flow(torch, cs, args.check)
        args.check = False
    elif args.sass:
        result["sass_opcodes"] = sass_opcodes(path)
    if args.check:
        result["check"] = check_kernel(torch, cs, depths)
    if not args.flow:
        result["device_ms_per_step"] = {**time_grids(torch, cs, depths),
                                        **time_seam(torch, cs)}
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
