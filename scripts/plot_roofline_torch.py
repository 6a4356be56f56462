#!/usr/bin/env python3
"""Roofline plot of the port's sweep rows (``scripts/sweep_torch.py``)
on one NVIDIA H100's data-sheet roofs (``profiling.CHIP_PEAKS["h100"]``:
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores, at a
700 W power limit). Each point's arithmetic intensity counts the lattice
pass its plan makes every ``steps_per_pass`` steps (the row's main
segment: D for the depth kernel, G for the resident kernel and the
ring), as ``profiling.roofline_report`` does. Only single-shard rows
measured on a card are plotted; the CPU's functional rows and the
sharded rows are left out.

Usage: python scripts/plot_roofline_torch.py [sweep_results_torch.json]
           [-o roofline_torch.png]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lbm_tpu_torch.profiling import (  # noqa: E402
    BYTES_PER_CELL_PASS,
    CHIP_PEAKS,
    OPS_PER_CELL_STEP,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sweep", nargs="?", default="sweep_results_torch.json")
    p.add_argument("-o", "--output", default="roofline_torch.png")
    args = p.parse_args(argv)

    rows = json.loads(Path(args.sweep).read_text())
    points = [r for r in rows
              if "error" not in r and r.get("devices", 1) == 1
              and r.get("backend") == "cuda"]
    if not points:
        print("no single-shard rows measured on a card to plot",
              file=sys.stderr)
        return 1

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    peaks = CHIP_PEAKS["h100"]
    fig, ax = plt.subplots(figsize=(8, 6))
    xs = np.logspace(-1, 4, 256)
    roof = np.minimum(xs * peaks["hbm_bytes_per_s"], peaks["f32_ops_per_s"])
    ax.plot(xs, roof / 1e9, "k-", lw=2, label="H100 roofline (data sheet)")
    ax.plot(xs, roof / 2e9, "k:", lw=1,
            label="half the float32 peak (-fmad=false)")
    for idx, r in enumerate(points):
        spp = r.get("steps_per_pass", 1)
        ai = OPS_PER_CELL_STEP / (BYTES_PER_CELL_PASS / spp)
        gflops = r["glups"] * OPS_PER_CELL_STEP
        ax.plot([ai], [gflops], "o", ms=7)
        ax.annotate(f"{r['grid']} {r['kernel']} ({r['glups']:.1f} GLUPS, "
                    f"{spp} steps a pass)", (ai, gflops),
                    textcoords="offset points",
                    xytext=(8, -4 - 9 * (idx % 4)), fontsize=8)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("arithmetic intensity (operations / byte)")
    ax.set_ylabel("GFLOP/s")
    ax.set_title("lbm_tpu_torch against the H100 roofline")
    ax.legend(loc="upper left", fontsize=8)
    ax.grid(True, which="both", alpha=0.25)
    fig.savefig(args.output, dpi=150, bbox_inches="tight")
    print(f"wrote {args.output} ({len(points)} points, "
          f"{len(rows) - len(points)} rows left out)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
