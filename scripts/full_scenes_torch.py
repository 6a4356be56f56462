#!/usr/bin/env python3
"""Cross-kernel gate of the PyTorch/CUDA port over the production-size
scenes that have no golden: 2048x1024, 4096x1024, 8192x1024 and
16384x1024, at their full 20000 steps, each run end to end twice through
the port's CLI on the card, under ``auto`` (the CUDA kernels the planner
picks) and on the plain float32 path (``--kernel reference``), the twin
of ``scripts/full_scenes.py``. The two trajectories (av_vels) and final
pressure (check.py's column, the one ``full_scenes.py`` compares) must
agree by check.py's max-%-diff within 0.3 %, and so must the final |u|
by its largest difference as a share of the largest |u|: check.py's
per-cell ratio is ill-posed for |u|, whose cells come as close to 0 as
float32 allows (one leg's exact 0 against the other's last bit is an
infinite ratio). The legs need not agree bit for bit: ``auto`` steps a
wide grid's transposed lattice, whose permuted speeds are summed in
another order. A row with a metric missing fails, and so does the
script.

Masks are generated (the generator's walls), params from
``sweep_torch.GRID_SCENES``; ``--scene-dir DIR`` runs the files there.
``--iters N`` shortens both legs alike. Each row carries the Reynolds
number, each leg's Compute and wall seconds (the wall includes the
output files' writing) and plan, and ``auto``'s GLUPS.

Usage: python scripts/full_scenes_torch.py [--scenes 2048x1024 ...]
           [--iters N] [--scene-dir DIR] [--device cuda|cpu]
           [--gate-pct 0.3] [-o docs/artifacts/full_scenes_torch.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import sweep_torch  # noqa: E402
from validate_scenes_torch import (  # noqa: E402
    judge, load_columns, max_pct, run_cli, write_scene,
)

REPO = sweep_torch.REPO
SCENES = ["2048x1024", "4096x1024", "8192x1024", "16384x1024"]
GATE_PCT = 0.3
METRICS = ("max_av_vels_pct", "max_u_pct", "max_pressure_pct")
LEGS = {"auto": "auto", "plain": "reference"}


def pct_of_peak(ref, sim) -> float | None:
    """100 * max |sim - ref| / max |ref|, or None when the two do not
    line up or ``ref`` is all 0."""
    import numpy as np

    if ref.size != sim.size or not ref.size:
        return None
    peak = float(np.max(np.abs(ref)))
    return 100.0 * float(np.max(np.abs(sim - ref))) / peak if peak else None


def run_scene(scene: str, files, iters: int | None, device: str,
              workdir: Path, gate_pct: float) -> dict:
    from lbm_tpu_torch.io import load_av_vels
    from lbm_tpu_torch.params import load_params

    params, obstacles, source = files
    p = load_params(params)
    steps = iters or p.max_iters
    row = {"scene": scene, "scene_source": source, "iters": steps,
           "gate_pct": gate_pct}
    legs = {}
    for leg, kernel in LEGS.items():
        args = ["--kernel", kernel, "--device", device]
        if iters:
            args += ["--iters", str(iters)]
        got = run_cli(params, obstacles, workdir / f"{scene}.{leg}", *args)
        if "error" in got:
            row["error"] = f"{leg} leg: {got['error']}"
            return judge(row, METRICS, gate_pct)
        legs[leg] = got
        row[leg] = {k: got[k] for k in ("reynolds", "compute_seconds",
                                        "wall_seconds", "plan")}
        row[leg]["glups"] = p.nx * p.ny * steps / got["compute_seconds"] / 1e9
    row["reynolds"] = row["auto"]["reynolds"]
    auto_fs, plain_fs = (load_columns(legs[k]["final_state_file"], [4, 5])
                         for k in ("auto", "plain"))
    row["max_av_vels_pct"] = max_pct(
        load_av_vels(legs["plain"]["av_vels_file"]),
        load_av_vels(legs["auto"]["av_vels_file"]))
    row["max_u_pct"] = pct_of_peak(plain_fs[:, 0], auto_fs[:, 0])
    row["max_pressure_pct"] = max_pct(plain_fs[:, 1], auto_fs[:, 1])
    for leg in legs.values():
        leg["av_vels_file"].unlink()
        leg["final_state_file"].unlink()
    return judge(row, METRICS, gate_pct)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", nargs="+", default=SCENES)
    p.add_argument("--iters", type=int, default=None,
                   help="steps of both legs (default: the scene's)")
    p.add_argument("--scene-dir", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--gate-pct", type=float, default=GATE_PCT)
    p.add_argument("-o", "--output",
                   default="docs/artifacts/full_scenes_torch.json")
    args = p.parse_args(argv)
    scene_dir = Path(args.scene_dir).resolve() if args.scene_dir else None
    results = {"device": args.device, "gate_pct": args.gate_pct,
               "nvidia_smi": sweep_torch.card()
               if args.device.startswith("cuda") else None,
               "gate": "auto against the plain float32 path: check.py's max "
                       "%diff of av_vels and of final pressure, and the "
                       "largest difference of final |u| in % of the largest "
                       "|u|; a missing metric fails",
               "scenes": []}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as td:
        for scene in args.scenes:
            try:
                files = write_scene(scene, Path(td), scene_dir=scene_dir)
                r = run_scene(scene, files, args.iters, args.device, Path(td),
                              args.gate_pct)
            except Exception as exc:  # record, keep going
                r = judge({"scene": scene,
                           "error": f"{type(exc).__name__}: {exc}"[:500]},
                          METRICS, args.gate_pct)
            print(json.dumps(r), flush=True)
            results["scenes"].append(r)
    results["ok"] = bool(results["scenes"]) and all(
        s["pass"] for s in results["scenes"])
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")
    print(f"{'PASS' if results['ok'] else 'FAIL'} -> {out}")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
