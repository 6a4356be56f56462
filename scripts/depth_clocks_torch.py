#!/usr/bin/env python3
"""Where a tile of the depth kernel spends its cycles: ``clock64`` around
the window load and the stages of ``lbm_tpu_torch/csrc/fused_depth.cu``.

No profiler on the card reports stalls inside a kernel, so this script
instruments a copy. It copies the package into ``build/depth_clocks/``
(a directory ``.gitignore`` lists), inserts ``clock64()`` reads into the
copy's D = 4 kernel (block start, after the window's barrier, after each
stage's barrier), lets each tile write its four intervals where its tot_u
partials go, so that the kernel's own epilogue sums them over the tiles,
builds the copy and runs it. The cells it computes are the kernel's; the
totals it returns are cycle counts. Printed per grid: mean cycles per
tile of the load, stage 1, stages 2 + 3 and stage 4 (which also stores
the tile), and the tiles. Two blocks share an SM, so an SM finishes two
tiles in about the sum of these.

Usage: python scripts/depth_clocks_torch.py [-o artifact.json]
       (A CUDA device is required.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
COPY = REPO / "build" / "depth_clocks"
GRIDS = (("1024x1024", 0), ("131072x128", 1))

# (text of the kernel, instrumented text): each must occur exactly once.
PATCHES = (
    ("    const int tid = threadIdx.x;\n    const int tile = blockIdx.x;\n",
     "    const int tid = threadIdx.x;\n    const int tile = blockIdx.x;\n"
     "    const long long c_start = clock64();\n    long long c_st[D];\n"),
    ("    __syncthreads();\n\n    const float w1 = a.w1",
     "    __syncthreads();\n    const long long c_load = clock64();\n\n"
     "    const float w1 = a.w1"),
    ("        __syncthreads();  // the stage's one barrier: orders nxt's "
     "writes\n",
     "        __syncthreads();  // the stage's one barrier: orders nxt's "
     "writes\n        c_st[s - 1] = clock64();\n"),
    ("        lbm_publish_partial(a.partials + (size_t)tid * a.n_tiles + "
     "tile, tot);\n",
     "        if constexpr (D == 4) {\n"
     "            const long long v[4] = {c_load - c_start, c_st[0] - c_load,\n"
     "                                    c_st[2] - c_st[0], c_st[3] - c_st[2]};\n"
     "            tot = (float)v[tid];\n"
     "        }\n"
     "        lbm_publish_partial(a.partials + (size_t)tid * a.n_tiles + "
     "tile, tot);\n"),
)


def instrumented_copy() -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(REPO / "lbm_tpu_torch", COPY / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = COPY / "lbm_tpu_torch" / "csrc" / "fused_depth.cu"
    text = src.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"depth_clocks_torch: {src.name} no longer holds "
                             f"exactly one {old!r}; bring PATCHES up to date")
        text = text.replace(old, new)
    src.write_text(text)
    return COPY


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(instrumented_copy()))
    import torch

    if not torch.cuda.is_available():
        print("depth_clocks_torch: no CUDA device", file=sys.stderr)
        return 2
    from lbm_tpu_torch.ops import fused_depth

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {"card": smi, "depth": 4, "cycles_per_tile": {}}
    for name, axis in GRIDS:
        p = cs.scene_params(name)
        cells, mask = cs.random_case(
            torch, name, p, seed=99, state="perturbed",
            mask_kind="scene" if name == cs.SCENE else "walls")
        if axis:
            cells, mask = cs.transposed(cells, mask)
        with cs.env():
            kernel = fused_depth.FusedDepth(mask, p.accel_w1, p.accel_w2,
                                            p.omega, 4, axis)
        a, b = cells, torch.empty_like(cells)
        av = torch.zeros(4, device="cuda")
        for _ in range(5):
            a, b = kernel.run(a, b, av, 0, 1.0)
        torch.cuda.synchronize()
        tiles = kernel._partials.shape[1]
        load, s1, s23, s4 = (av / tiles).tolist()
        result["cycles_per_tile"][name + (" transposed" if axis else "")] = {
            "load": load, "stage 1": s1, "stages 2 + 3": s23, "stage 4": s4,
            "tiles": tiles}
        del cells, a, b, kernel
        torch.cuda.empty_cache()
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
