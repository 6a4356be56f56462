#!/usr/bin/env python3
"""Drift gate of the PyTorch/CUDA port over the official scenes, fail
closed: each scene runs end to end through the port's CLI on the card
under ``auto`` in both float32 associations of ``scripts/
validate_scenes.py`` (the default paired equilibrium, and the reference's
term order, ``LBM_PAIRED_EQ=0``), and its av_vels and final pressure are
held to a float64 truth by check.py's max-%-diff (``io._diff``) within
the repo's 0.3 % drift budget. The truth is ``goldens/<scene>.final_state
.f64.npz`` where it exists (256x256, 1024x1024), else the port's plain
float64 run on the same device (``--precision float64 --kernel
reference``). A row passes only with both metrics present, finite and
within the budget; any other row fails the script.

Scenes: 128x128, 128x256, 256x256 and 1024x1024 with the shipped params
(``sweep_torch.GRID_SCENES``). Their masks are generated, never read from
elsewhere: the generator's walls, plus the full-height column at x =
nx // 3 for 1024x1024 (the reference's 1024x1024 obstacles, as
``chip_smoke.py`` builds them); ``--scene-dir DIR`` runs
``DIR/input_<scene>.params`` and ``DIR/obstacles_<scene>.dat`` instead.
Each row records where its scene came from. ``--repo DIR`` runs the CLI
of another checkout (to hold two commits' drift and wall seconds side by
side); the truth stays this checkout's.

Usage: python scripts/validate_scenes_torch.py [--scenes 256x256 ...]
           [--scene-dir DIR] [--kernel auto] [--device cuda|cpu]
           [--repo DIR] [-o docs/artifacts/validate_scenes_torch.json]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import sweep_torch  # noqa: E402

REPO = sweep_torch.REPO
SCENES = ["128x128", "128x256", "256x256", "1024x1024"]
DRIFT_BUDGET_PCT = 0.3
# The two float32 associations; the omega-absorbed one stays opt-in.
ASSOCIATIONS = {"fast": {}, "reference_assoc": {"LBM_PAIRED_EQ": "0"}}
# A CLI run takes the caller's environment but these, which the
# association in force sets.
ASSOC_KNOBS = ("LBM_PAIRED_EQ", "LBM_OMEGA_EQ")
COLUMN_SCENES = {"1024x1024"}


def write_scene(scene: str, workdir: Path, iters: int | None = None,
                scene_dir: Path | None = None) -> tuple[Path, Path, str]:
    """``(params file, obstacles file, source)`` of ``scene``: from
    ``scene_dir``, or generated into ``workdir`` with ``iters`` steps
    (default: the scene's)."""
    if scene_dir is not None:
        return (scene_dir / f"input_{scene}.params",
                scene_dir / f"obstacles_{scene}.dat", str(scene_dir))
    from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles

    p = sweep_torch.grid_params(scene, iters)
    params = workdir / f"input_{scene}.params"
    params.write_text(f"{p.nx}\n{p.ny}\n{p.max_iters}\n{p.reynolds_dim}\n"
                      f"{p.density}\n{p.accel}\n{p.omega}\n")
    mask = generate_obstacles(p.nx, p.ny)
    if scene in COLUMN_SCENES:
        mask[:, p.nx // 3] = True
    obstacles = workdir / f"obstacles_{scene}.dat"
    write_obstacles(obstacles, mask)
    return params, obstacles, "generated"


def run_cli(params: Path, obstacles: Path, out: Path, *args: str,
            env: dict | None = None, timeout: float = 3600.0,
            repo: Path = REPO) -> dict:
    """One run of ``python -m lbm_tpu_torch`` of the checkout ``repo``;
    its Reynolds number, Compute and wall seconds, plan line and output
    files, or ``error``."""
    av, fs = Path(f"{out}.av_vels.dat"), Path(f"{out}.final_state.dat")
    cmd = [sys.executable, "-m", "lbm_tpu_torch", str(params), str(obstacles),
           "--av-vels-file", str(av), "--final-state-file", str(fs), *args]
    child = {k: v for k, v in os.environ.items() if k not in ASSOC_KNOBS}
    child.update(env or {})
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                             env=child, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"timed out after {timeout:.0f} s"}
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        return {"error": res.stderr[-1000:], "wall_seconds": wall}
    rey = re.search(r"Reynolds number:\s+(\S+)", res.stdout)
    comp = re.search(r"Compute time:\s+(\S+)", res.stdout)
    plan = re.search(r"^kernel: .*$", res.stderr, re.M)
    if rey is None or comp is None:
        return {"error": f"unexpected CLI stdout: {res.stdout[-500:]!r}",
                "wall_seconds": wall}
    return {"reynolds": float(rey.group(1)),
            "compute_seconds": float(comp.group(1)), "wall_seconds": wall,
            "plan": plan.group(0) if plan else None,
            "av_vels_file": av, "final_state_file": fs}


def max_pct(ref, sim) -> float | None:
    """|check.py's max %diff| of ``sim`` against ``ref`` (``io._diff``),
    or None when the two do not line up."""
    from lbm_tpu_torch.io import _diff

    if ref is None or sim is None or ref.size != sim.size or not ref.size:
        return None
    return abs(float(_diff(ref, sim).max_diff_pcnt))


def judge(row: dict, metrics: tuple[str, ...], budget: float) -> dict:
    """``pass`` and ``margin_vs_budget`` (worst metric / budget): a row
    passes only when every metric is present, finite and within budget."""
    vals = [row.get(k) for k in metrics]
    ok = all(v is not None and math.isfinite(v) for v in vals)
    if ok:
        row["margin_vs_budget"] = max(vals) / budget
    row["pass"] = ok and max(vals) <= budget
    if not ok:
        row.setdefault("error", "missing drift metric: " + ", ".join(
            k for k, v in zip(metrics, vals)
            if v is None or not math.isfinite(v)))
    return row


def load_columns(path, cols):
    """Columns ``cols`` of a ``final_state.dat``, one row a cell."""
    import numpy as np

    return np.loadtxt(path, usecols=cols, ndmin=2)


def truth(scene: str, params: Path, obstacles: Path, workdir: Path,
          device: str) -> dict:
    """``{"source", "av_vels", "pressure"}``: the float64 golden of the
    scene where one exists for its size and length, else the port's
    plain float64 run on ``device``."""
    import numpy as np

    from lbm_tpu_torch.io import load_av_vels
    from lbm_tpu_torch.params import load_params

    p = load_params(params)
    golden = REPO / "goldens" / f"{scene}.final_state.f64.npz"
    if golden.exists():
        with np.load(golden) as z:
            if (int(z["nx"]), int(z["ny"]), int(z["iters"])) == \
                    (p.nx, p.ny, p.max_iters):
                return {"source": str(golden.relative_to(REPO)),
                        "av_vels": z["av_vels"], "pressure": z["pressure"]}
    leg = run_cli(params, obstacles, workdir / f"{scene}.f64", "--precision",
                  "float64", "--kernel", "reference", "--device", device)
    if "error" in leg:
        return {"source": "port plain float64", "error": leg["error"]}
    return {"source": f"port plain float64 on {device}",
            "av_vels": load_av_vels(leg["av_vels_file"]),
            "pressure": load_columns(leg["final_state_file"], [5])[:, 0],
            "compute_seconds": leg["compute_seconds"]}


def run_scene(scene, assoc, kernel, device, workdir, files, ref,
              repo: Path = REPO) -> dict:
    from lbm_tpu_torch.io import load_av_vels

    params, obstacles, source = files
    row = {"scene": scene, "association": assoc, "kernel": kernel,
           "scene_source": source, "truth": ref["source"]}
    if repo != REPO:
        row["repo"] = str(repo)
    if "error" in ref:
        row["error"] = "truth: " + ref["error"]
        return judge(row, ("max_av_vels_pct", "max_final_state_pct"),
                     DRIFT_BUDGET_PCT)
    leg = run_cli(params, obstacles, workdir / f"{scene}.{assoc}",
                  "--kernel", kernel, "--device", device,
                  env=ASSOCIATIONS[assoc], repo=repo)
    if "error" in leg:
        row["error"] = leg["error"]
    else:
        row.update({k: leg[k] for k in ("reynolds", "compute_seconds",
                                        "wall_seconds", "plan")})
        row["runs"] = 1
        row["max_av_vels_pct"] = max_pct(ref["av_vels"],
                                         load_av_vels(leg["av_vels_file"]))
        row["max_final_state_pct"] = max_pct(
            ref["pressure"], load_columns(leg["final_state_file"], [5])[:, 0])
    return judge(row, ("max_av_vels_pct", "max_final_state_pct"),
                 DRIFT_BUDGET_PCT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", nargs="+", default=SCENES)
    p.add_argument("--scene-dir", default=None,
                   help="run DIR/input_<scene>.params and "
                        "DIR/obstacles_<scene>.dat, not generated scenes")
    p.add_argument("--kernel", default="auto")
    p.add_argument("--device", default="cuda")
    p.add_argument("--repo", default=str(REPO),
                   help="the checkout whose CLI runs (default: this one)")
    p.add_argument("-o", "--output",
                   default="docs/artifacts/validate_scenes_torch.json")
    args = p.parse_args(argv)
    scene_dir = Path(args.scene_dir).resolve() if args.scene_dir else None
    repo = Path(args.repo).resolve()
    results = {"kernel": args.kernel, "device": args.device,
               "nvidia_smi": sweep_torch.card()
               if args.device.startswith("cuda") else None,
               "drift_budget_pct": DRIFT_BUDGET_PCT,
               "gate": "check.py's max %diff of av_vels and of final pressure "
                       "against the float64 truth; a missing metric fails",
               "scenes": []}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as td:
        work = Path(td)
        for scene in args.scenes:
            try:
                files = write_scene(scene, work, scene_dir=scene_dir)
                ref = truth(scene, *files[:2], work, args.device)
            except Exception as exc:  # record, keep validating
                files, ref = None, {
                    "source": None,
                    "error": f"{type(exc).__name__}: {exc}"[:500]}
            for assoc in ASSOCIATIONS:
                try:
                    r = run_scene(scene, assoc, args.kernel, args.device,
                                  work, files, ref, repo)
                except Exception as exc:  # record, keep validating
                    r = judge({"scene": scene, "association": assoc,
                               "error": f"{type(exc).__name__}: {exc}"[:500]},
                              ("max_av_vels_pct", "max_final_state_pct"),
                              DRIFT_BUDGET_PCT)
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
