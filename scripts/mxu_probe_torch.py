#!/usr/bin/env python3
"""Measure the tensor-core equilibrium against the elementwise step on the
card: the twin of scripts/mxu_probe.py for the PyTorch/CUDA port.

Times ``iters`` steps (default 2000) of the 1024x1024 lattice with the
scenes' params (density 0.1, accel 0.01, omega 1.85) on the generator's
obstacle mask, from rest, as one launch of each compiled step:

- ``device_elementwise``: the device-memory resident form
  (``csrc/resident.cu``'s ``resident_kernel``), the port's compiled step,
  its equilibrium elementwise on the CUDA cores;
- ``device_mxu``: ``csrc/mxu_eq.cu``'s ``mxu_resident_kernel``, the same
  rounds of depth tiles with the equilibrium as a (9, 6) x (6, N) product
  on the tensor cores, in f64 (``lbm_tpu_torch/ops/mxu_eq.py``);
- ``plain_elementwise`` and ``plain_mxu``: the eager twins
  (``ops.reference.multi_step``, ``ops.mxu_eq.mxu_multi_step``), at
  ``--plain-iters`` steps (default 200), for the record.

The timing follows scripts/sweep_torch.py's rule: an untimed first run,
CUDA events, best of N. The device variants go in turns (elementwise,
mxu, mxu, elementwise), ``--repeats`` runs each turn, each from rest. Each
variant reports ``glups``, ``best_s`` and ``us_per_iter``. In place of the
JAX probe's ``has_dot`` (the compiled program's HLO holds a dot),
``mma_in_sass`` counts the HMMA and DMMA instructions in the built
kernel's SASS (``cuobjdump``): the contraction reached the tensor cores.
The two device variants' final states are compared (their largest
difference: the two equilibria's associations apart).

Writes the summary, with the card's ``nvidia-smi`` name and power limit,
to ``docs/artifacts/mxu_probe_torch.json`` (``-o`` for another path) and
prints it.

Usage: python scripts/mxu_probe_torch.py [iters] [--repeats 3]
           [--plain-iters 200] [-o FILE]
       (A CUDA device and the CUDA toolkit's cuobjdump are required: a CPU
        run would time PyTorch's CPU ops, so without a card the script
        refuses rather than mislabel.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
OUTPUT = REPO / "docs" / "artifacts" / "mxu_probe_torch.json"
GRID = (1024, 1024)


def mma_in_sass(library: Path) -> dict:
    """``{kernel: HMMA + DMMA instructions}`` of the two device variants'
    kernels in the built library's SASS."""
    spec = importlib.util.spec_from_file_location(
        "depth_ab_torch", REPO / "scripts" / "depth_ab_torch.py")
    dab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dab)
    ops = dab.sass_opcodes(library, {"mxu_resident_kernel": "mxu_resident_kernel",
                                     "resident_kernel": "15resident_kernel"},
                           modifiers=True)
    return {k: sum(n for op, n in c.items()
                   if op.startswith(("HMMA", "DMMA")))
            for k, c in ops.items()}


def ptxas_line(log: Path, kernel: str) -> str:
    """The build log's ``-Xptxas -v`` registers and spills of ``kernel``."""
    out, name = [], None
    for ln in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = m.group(1)
        elif name and kernel in name and ("spill" in ln or "registers" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(dict.fromkeys(out))


def time_device(torch, kernels, state, iters, repeats):
    """Best seconds of each ``label: kernel`` over ``repeats`` launches of
    ``iters`` steps from ``state`` in each of its turns, the labels in
    turns (forward, then reverse), after one untimed launch each; and
    each one's final state."""
    a = torch.empty_like(state)
    b = torch.empty_like(state)
    out = torch.empty(iters, device=state.device)
    finals = {}
    for label, k in kernels.items():
        a.copy_(state)
        finals[label] = k.run(a, b, out)[0].clone()
    torch.cuda.synchronize()
    best = dict.fromkeys(kernels, float("inf"))
    for label in list(kernels) + list(reversed(kernels)):
        for _ in range(repeats):
            a.copy_(state)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            kernels[label].run(a, b, out)
            t1.record()
            t1.synchronize()
            best[label] = min(best[label], t0.elapsed_time(t1) / 1e3)
    assert all(bool(torch.isfinite(f).all()) for f in finals.values())
    return best, finals, GRID[0] * GRID[1]


def time_plain(torch, fn, iters):
    """Seconds of ``fn(iters)`` after an untimed ``fn(2)``, CUDA events."""
    fn(2)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn(iters)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / 1e3


def row(seconds, cells, iters):
    return {"glups": cells * iters / seconds / 1e9, "best_s": seconds,
            "us_per_iter": seconds / iters * 1e6, "iters": iters}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--plain-iters", type=int, default=200)
    ap.add_argument("-o", "--output", default=str(OUTPUT))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "requires a CUDA device, got none "
                                   "(torch.cuda.is_available() is False)"}))
        return 2
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import _build, mxu_eq, resident
    from lbm_tpu_torch.ops import reference as ref_ops
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    nx, ny = GRID
    p = Params(nx=nx, ny=ny, max_iters=args.iters, reynolds_dim=10,
               density=np.float32(0.1), accel=np.float32(0.01),
               omega=np.float32(1.85))
    dev = torch.device("cuda")
    mask = torch.from_numpy(generate_obstacles(nx, ny)).to(dev)
    state = initial_state(p, dev)
    w = (p.accel_w1, p.accel_w2, p.omega)
    kernels = {
        "device_elementwise": resident.Resident(mask, *w, args.iters,
                                                form="device"),
        "device_mxu": mxu_eq.MxuStep(mask, *w, args.iters),
    }
    best, finals, cells = time_device(torch, kernels, state, args.iters,
                                      args.repeats)
    out = {"grid": f"{nx}x{ny}", "iters": args.iters, "nvidia_smi": smi,
           "device": torch.cuda.get_device_name(0)}
    for label, s in best.items():
        out[label] = row(s, cells, args.iters)
        print(label, json.dumps(out[label]), flush=True)
    plain = {"plain_elementwise": lambda n: ref_ops.multi_step(
                 state, mask, *w, n),
             "plain_mxu": lambda n: mxu_eq.mxu_multi_step(state, mask, *w, n)}
    for label, fn in plain.items():
        out[label] = row(time_plain(torch, fn, args.plain_iters), cells,
                         args.plain_iters)
        print(label, json.dumps(out[label]), flush=True)
    library, _ = _build.build()
    mma = mma_in_sass(library)
    out["mma_in_sass"] = mma.get("mxu_resident_kernel", 0)
    out["mma_in_sass_elementwise"] = mma.get("resident_kernel", 0)
    out["ptxas"] = {"device_mxu": ptxas_line(library.with_suffix(".log"),
                                             "mxu_resident_kernel"),
                    "device_elementwise": ptxas_line(
                        library.with_suffix(".log"), "resident_kernelILb0ELi0E")}
    out["mxu_over_elementwise"] = (best["device_mxu"]
                                   / best["device_elementwise"])
    out["final_state_max_abs_diff"] = float(
        (finals["device_mxu"] - finals["device_elementwise"]).abs().max())
    out["blocks"] = {k: v.blocks for k, v in kernels.items()}
    out["rounds"] = "+".join(f"{kernels['device_mxu'].rounds.count(d)}x{d}"
                             for d in (4, 2, 1)
                             if d in kernels["device_mxu"].rounds)
    out["method"] = ("CUDA events; an untimed first launch each; best of "
                     f"{args.repeats} launches of {args.iters} steps from rest "
                     "in each turn, elementwise, mxu, mxu, elementwise; the "
                     "plain variants one timed run after an untimed one")
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
