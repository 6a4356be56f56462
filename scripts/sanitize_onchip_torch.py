#!/usr/bin/env python3
"""The on-chip kernels under ``compute-sanitizer``: one small call of
``resident_onchip_kernel`` and of ``ring_onchip_kernel`` in each buffer
count and each layout (row mode, column mode), under ``--tool racecheck``
(shared-memory hazards between the threads of a block: a wave that pulls
a cell another thread's deferred store overwrites, a carry slot read and
filled in one barrier phase) and ``--tool synccheck`` (barriers and
mbarriers used where not every thread reaches them). The single-buffer
calls run lattices whose rows are a wave wide (1024 lanes: stores deferred
one wave) and wider (1100: three waves).

Each call is small (8 strips of up to 4 rows; the ring: 2 shards of 2
strips on one card) and checked against the plain version (cells max abs
error 0). ``--calls`` runs the calls in this process (what the sanitizer
runs); without it, the script runs itself under each tool and reads the
sanitizer's ``ERROR SUMMARY``. Prints one JSON line per tool and a last
one, ``ok``: every call ran, matched its plain version, and no tool
reported an error. Exit code 0 when ``ok``.

Usage: python scripts/sanitize_onchip_torch.py [--calls] [-o artifact.json]
       (A CUDA device and the CUDA toolkit's compute-sanitizer.)
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TOOLS = ("racecheck", "synccheck")
G = 2
# (kernel, form, axis, rows, lanes, strips): "resident" runs the
# single-device kernel on a rows x lanes lattice over ``strips`` blocks;
# "ring" 2 shards of rows / 2 rows (row plan) or of lanes x rows / 2 (the
# x-plan's physical columns) at ``strips`` strips a shard.
CALLS = (("resident", "inplace", 0, 32, 1024, 8),
         ("resident", "inplace", 1, 32, 1024, 8),
         ("resident", "inplace", 0, 16, 1100, 8),
         ("resident", "onchip", 0, 32, 256, 8),
         ("resident", "onchip", 1, 32, 256, 8),
         ("ring", "inplace", 0, 16, 1024, 2),
         ("ring", "inplace", 1, 16, 1024, 2),
         ("ring", "onchip", 0, 16, 256, 2),
         ("ring", "onchip", 1, 16, 256, 2))


def sanitizer() -> str | None:
    """The toolkit's compute-sanitizer, or None."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    path = Path("/usr/local/cuda/bin/compute-sanitizer")
    return str(path) if path.exists() else None


def _state(torch, rows, lanes, seed):
    """A perturbed state of a rows x lanes lattice (its forced row failing
    the guard in places) and the generator's walls, on the card."""
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    p = Params(nx=lanes, ny=rows, max_iters=G, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cells = initial_state(p, "cuda") * (
        1.0 + 0.2 * (torch.rand((9, rows, lanes), generator=g,
                                device="cuda") - 0.5))
    cells[6, rows - 2][torch.rand(lanes, generator=g, device="cuda")
                       < 0.3] = float(p.accel_w2)
    mask = torch.from_numpy(generate_obstacles(lanes, rows)).cuda()
    return p, cells.contiguous(), mask


def run_calls(torch) -> list[dict]:
    from lbm_tpu_torch.ops import reference as ref_ops
    from lbm_tpu_torch.ops import resident
    from lbm_tpu_torch.parallel import decomp, halo, resident_ring

    out = []
    for i, (kernel, form, axis, rows, lanes, strips) in enumerate(CALLS):
        if kernel == "resident":
            p, cells, mask = _state(torch, rows, lanes, seed=70 + i)
            w = (mask, p.accel_w1, p.accel_w2, p.omega)
            got, _ = resident.resident(cells, *w, G, axis, form, strips)
            want, _ = ref_ops.multi_step(cells, *w, G, axis)
        else:
            # Physical ny x nx: the row plan cuts rows, the x-plan columns.
            ny, nx = (rows, lanes) if axis == 0 else (lanes, rows)
            p, cells, mask = _state(torch, ny, nx, seed=70 + i)
            mesh = decomp.make_mesh(2, devices=[torch.device("cuda")] * 2)
            sets = [halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, G,
                                  axis) for _ in range(2)]
            blocks = resident_ring.ring_blocks
            resident_ring.ring_blocks = lambda *a: strips
            try:
                resident_ring.RingOnchipImpl(sets[0], G, form).run(0)
            finally:
                resident_ring.ring_blocks = blocks
            ref = halo.ReferenceShardImpl(sets[1])
            for t in range(G):
                ref.run(t)
            for ss in sets:
                ss.synchronize()
            got, want = sets[0].gather(), sets[1].gather()
        torch.cuda.synchronize()
        out.append({"call": f"{kernel} {form} axis {axis} {rows}x{lanes} "
                            f"over {strips}",
                    "max_abs_err": float((got - want).abs().max())})
    return out


def under_tool(tool: str) -> dict:
    proc = subprocess.run(
        [sanitizer(), "--tool", tool, "--error-exitcode", "9",
         sys.executable, str(Path(__file__).resolve()), "--calls"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    summary = re.findall(r"ERROR SUMMARY: (\d+) error", proc.stdout
                         + proc.stderr)
    calls = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith('{"call"')]
    hazards = [ln for ln in (proc.stdout + proc.stderr).splitlines()
               if "Error" in ln or "Race" in ln or "Hazard" in ln][:20]
    return {"tool": tool, "rc": proc.returncode,
            "errors": int(summary[-1]) if summary else None,
            "calls": calls, "first_reports": hazards,
            "tail": (proc.stdout + proc.stderr).strip().splitlines()[-5:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", action="store_true")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("sanitize_onchip_torch: no CUDA device", file=sys.stderr)
        return 2
    if args.calls:
        for r in run_calls(torch):
            print(json.dumps(r), flush=True)
        return 0
    if sanitizer() is None:
        print(json.dumps({"ok": False, "sanitizer": None}))
        return 1
    # Build the library first, outside the sanitizer.
    from lbm_tpu_torch.ops import _build

    _build.build()
    results = [under_tool(tool) for tool in TOOLS]
    for r in results:
        print(json.dumps(r), flush=True)
    ok = all(r["rc"] == 0 and r["errors"] == 0 and len(r["calls"]) ==
             len(CALLS) and all(c["max_abs_err"] == 0.0 for c in r["calls"])
             for r in results)
    summary = {"ok": ok, "sanitizer": sanitizer(), "tools": list(TOOLS),
               "calls": len(CALLS)}
    print(json.dumps(summary), flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(json.dumps({"runs": results,
                                                 **summary}) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
