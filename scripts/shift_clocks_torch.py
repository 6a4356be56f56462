#!/usr/bin/env python3
"""Where a step of the device form's shift mode spends its cycles:
``clock64`` around the parts of the shift kernel's step
(``lbm_tpu_torch/csrc/lbm_rounds.cuh``, ``resident_shift_kernel`` in
``csrc/resident.cu``).

No profiler on the card reports stalls inside a kernel, so this script
instruments a copy, as ``scripts/onchip_clocks_torch.py`` does. It copies a
checkout's package (``--repo``, this one by default) into
``build/shift_clocks/`` (a directory ``.gitignore`` lists), inserts
``clock64()`` reads into the copy's shift-mode step, builds the copy and
runs it. One thread of each block (the schedule's: thread 0 in the parent,
in the change the rim group's first thread, which computes a rim cell and
releases the step) adds the cycles since its last mark to one of the
schedule's categories, over all G steps. After the last step every
block writes its category q into the partial slots of step q (its own
slot, the others of its stride zeroed), and a grid barrier later the
kernel's own sum adds each category over the blocks. The cells the copy
computes are the kernel's; the totals it returns are cycle counts.

The categories are the schedule's own (``SCHEDULES``): the checkout's
``lbm_rounds.cuh`` names which one it runs, and every patch of that
schedule must occur there exactly once (tests/test_torch_tools.py holds
this checkout to it). The parent's "loads" end where every loaded value
has arrived: thread 0 adds them up and branches on the sum before its
mark. Printed per
lattice: each category's mean cycles a block and a step, their sum, the
blocks, and the SM clock ``nvidia-smi`` reads.

Usage: python scripts/shift_clocks_torch.py [--repo CHECKOUT]
       [--shapes 4096x64,8192x32] [-o artifact.json [--append LABEL]]
       (A CUDA device is required.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
COPIES = REPO / "build" / "shift_clocks"
G = 100
# The narrow channels auto runs in the shift mode.
SHAPES = ("4096x64", "8192x32")

# Declarations shared by the schedules: thread 0's cycles since its last
# mark go to category q at CK(q).
_HEAD = (
    ("#include \"lbm_depth.cuh\"\n",
     "#include \"lbm_depth.cuh\"\n"
     "__shared__ long long ck_acc[16];\n"
     "__shared__ long long ck_t_sh;\n"
     "#define CK(q) if (threadIdx.x == CK_THREAD) { "
     "const long long n_ = clock64(); ck_acc[q] += n_ - ck_t_sh; "
     "ck_t_sh = n_; }\n"
     "__device__ __forceinline__ unsigned long long ck_ns() { "
     "unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
     ": \"=l\"(t_)); return t_; }\n"
     "#define CK_START() if (threadIdx.x < 16) ck_acc[threadIdx.x] = 0; "
     "if (threadIdx.x == CK_THREAD) ck_t_sh = clock64();\n"
     "// Category q of every block into step q's partials: this block's\n"
     "// slot, the others of its stride zeroed; a grid barrier after.\n"
     "#define CK_PUBLISH(partials, n, cats) "
     "for (int q_ = 0; q_ < (cats); ++q_) { "
     "for (int t_ = blockIdx.x + (int)threadIdx.x * (int)gridDim.x; "
     "t_ < (n); t_ += (int)(blockDim.x * gridDim.x)) "
     "(partials)[(size_t)q_ * (n) + t_] = "
     "t_ == (int)blockIdx.x ? (float)ck_acc[q_] : 0.0f; } "
     "__syncthreads(); cooperative_groups::this_grid().sync();\n"),
)

# Per schedule: the text that names it in lbm_rounds.cuh, its categories
# (the last the whole step) and its patches (each (text, instrumented
# text), each occurring exactly once).
SCHEDULES = {
    # The parent: tiles by block stride, a grid barrier after each step.
    "tiles by stride, a grid barrier a step": {
        "marker": "    for (int tile = blockIdx.x; tile < a.n_tiles; "
                  "tile += gridDim.x) {\n",
        "thread": "0",
        "categories": (
            "grid barrier", "tile: loads", "tile: arithmetic",
            "tile: stores", "tile: partial's two barriers + sum", "step"),
        "patches": (
            # Thread 0's loads all arrived: a branch on their sum.
            ("    float acc = 0.0f;\n    float o[9][kV];\n",
             "    if (threadIdx.x == 0) {\n"
             "        float d_ = e1 + e5 + e8 + e3 + e6 + e7 + m[0] + m[1];\n"
             "        for (int k = 0; k < 9; ++k) d_ += q[k][0] + q[k][1];\n"
             "        for (int j = 0; j < 4; ++j) d_ += g[0][j] + g[1][j] + g[2][j] "
             "+ gs[j];\n"
             "        if (d_ == -1.0f) ck_acc[15] += 1;\n"
             "    }\n"
             "    CK(1)\n"
             "    float acc = 0.0f;\n    float o[9][kV];\n"),
            ("    float* to = dst + rc;\n",
             "    CK(2)\n    float* to = dst + rc;\n"),
            ("    return acc;\n}\n\n// One step of the lattice",
             "    CK(3)\n    return acc;\n}\n\n// One step of the lattice"),
            ("            lbm_publish_partial(part + tile, tot);\n"
             "        }\n    }\n}\n",
             "            lbm_publish_partial(part + tile, tot);\n"
             "        }\n        CK(4)\n    }\n}\n"),
            ("    const int n = a.n_tiles;\n"
             "    for (int k = 0; k < r.gsteps; ++k) {\n",
             "    const int n = a.n_tiles;\n    CK_START()\n"
             "    for (int k = 0; k < r.gsteps; ++k) {\n"
             "        const long long ck_s = ck_t_sh;\n"),
            ("        cooperative_groups::this_grid().sync();\n    }\n"
             "    for (int s = blockIdx.x; s < r.gsteps; s += gridDim.x) {\n"
             "        lbm_sum_rows<1>(r.partials + (size_t)s * n, nullptr, "
             "n, r.scale,\n                        r.out + s, threadIdx.x);\n",
             "        cooperative_groups::this_grid().sync();\n"
             "        CK(0)\n"
             "        if (threadIdx.x == CK_THREAD) ck_acc[5] += ck_t_sh - ck_s;\n"
             "    }\n    CK_PUBLISH(r.partials, n, 6)\n"
             "    for (int s = blockIdx.x; s < r.gsteps; s += gridDim.x) {\n"
             "        lbm_sum_rows<1>(r.partials + (size_t)s * n, nullptr, "
             "n, r.scale,\n                        r.out + s, threadIdx.x);\n"),
        ),
    },
    # The change: each block owns its tiles for the launch and waits on
    # its neighbours' step counters; the shared residence (the narrow
    # channels' path) by the rim group's first thread, which computes a rim
    # cell and releases the step, and thread 0's interior cells beside it.
    "owned tiles, neighbour counters, a rim group (shared residence)": {
        "marker": "// The shared residence's step loop: blocks of kSlabThreads "
                  "threads, smem\n",
        "defines": "#define CK_REL_NS(s) reinterpret_cast<unsigned long long*>("
                   "(s).edges + 6LL * (s).ncg * (s).r.args[0].ny)\n",
        "thread": "(kSlabThreads / 32 - kRimWarps) * 32",
        "categories": (
            "its ring segment", "rim group barrier: the ring's wait and loads",
            "rim cells + edge stores", "rim group barrier: the edge stores",
            "release", "block barrier: the interior", "warp sums", "step",
            "thread 0: interior cells",
            "west poll: start to counter seen (ns)",
            "west poll: neighbour's release to counter seen (ns)"),
        "patches": (
            ("    for (int k = 0; k < G; ++k) {\n"
             "        float* const cur = (k & 1) ? buf1 : buf0;\n",
             "    CK_START()\n"
             "    for (int k = 0; k < G; ++k) {\n"
             "        const long long ck_s = ck_t_sh;\n"
             "        float* const cur = (k & 1) ? buf1 : buf0;\n"),
            ("            slab_ring(s, v, segs[kWarps - 1 - warp], cur, k, lane);\n"
             "            rim_barrier();\n",
             "            slab_ring(s, v, segs[kWarps - 1 - warp], cur, k, lane);\n"
             "            CK(0)\n            rim_barrier();\n            CK(1)\n"),
            ("            // The group's edge stores, then one release for all "
             "of them.\n            rim_barrier();\n",
             "            CK(2)\n"
             "            // The group's edge stores, then one release for all "
             "of them.\n            rim_barrier();\n            CK(3)\n"),
            ("                release_steps(s.done, blockIdx.x);\n"
             "            }\n        } else {\n",
             "                release_steps(s.done, blockIdx.x);\n"
             "            }\n            CK(4)\n        } else {\n"
             "            const long long i_ = clock64();\n"),
            # The release's time on the card's global timer, where a slab's
            # row-group sides leave the edge buffer room (one row group).
            ("            if (tid == kInner && k + 1 < G) {\n",
             "            if (tid == kInner && k + 1 < G) {\n"
             "                if (s.nrg == 1) CK_REL_NS(s)[blockIdx.x] = ck_ns();\n"),
            ("        if (lane == 0) wait_steps(s.done, g.owner, k);\n",
             "        if (lane == 0) {\n"
             "            const unsigned long long p_ = ck_ns();\n"
             "            wait_steps(s.done, g.owner, k);\n"
             "            if (g.c0 < 0 && g.dr == 1 && s.nrg == 1) {\n"
             "                const unsigned long long n_ = ck_ns();\n"
             "                ck_acc[9] += (long long)(n_ - p_);\n"
             "                ck_acc[10] += (long long)(n_ - CK_REL_NS(s)[g.owner]);\n"
             "            }\n        }\n"),
            ("                slab_cell<kMode, false>(s, v, 1 + q / iw, 1 + q % iw, "
             "-1);\n            }\n",
             "                slab_cell<kMode, false>(s, v, 1 + q / iw, 1 + q % iw, "
             "-1);\n            }\n"
             "            if (tid == 0) ck_acc[8] += clock64() - i_;\n"),
            ("        __syncthreads();\n        if (k > 0) add_tiles(k - 1);\n",
             "        __syncthreads();\n        CK(5)\n"
             "        if (k > 0) add_tiles(k - 1);\n"),
            ("            if (lane == 0) sums[i] = sum;\n        }\n    }\n",
             "            if (lane == 0) sums[i] = sum;\n        }\n"
             "        CK(6)\n"
             "        if (threadIdx.x == CK_THREAD) ck_acc[7] += ck_t_sh - ck_s;\n"
             "    }\n"),
            ("    if ((int)blockIdx.x < s.ncg * s.nrg) {\n",
             "    CK_START()\n    if ((int)blockIdx.x < s.ncg * s.nrg) {\n"),
            ("    cooperative_groups::this_grid().sync();\n"
             "    for (int st = blockIdx.x; st < r.gsteps; st += gridDim.x) {\n",
             "    cooperative_groups::this_grid().sync();\n"
             "    CK_PUBLISH(r.partials, n, 11)\n"
             "    for (int st = blockIdx.x; st < r.gsteps; st += gridDim.x) {\n"),
        ),
    },
}


def schedule_of(text: str) -> str:
    """The schedule whose marker the shift mode's source holds."""
    found = [k for k, s in SCHEDULES.items() if s["marker"] in text]
    if len(found) != 1:
        raise SystemExit("shift_clocks_torch: lbm_rounds.cuh names "
                         f"{len(found)} known schedules; bring SCHEDULES up "
                         "to date")
    return found[0]


def instrument(text: str) -> tuple[str, str]:
    """``(schedule, instrumented text)`` of an ``lbm_rounds.cuh``."""
    name = schedule_of(text)
    head = tuple((old, new.replace(
        "__shared__ long long ck_acc",
        f"#define CK_THREAD ({SCHEDULES[name]['thread']})\n"
        + SCHEDULES[name].get("defines", "")
        + "__shared__ long long ck_acc")) for old, new in _HEAD)
    for old, new in head + SCHEDULES[name]["patches"]:
        if text.count(old) != 1:
            raise SystemExit(f"shift_clocks_torch: lbm_rounds.cuh no longer "
                             f"holds exactly one {old!r}; bring the "
                             f"{name!r} patches up to date")
        text = text.replace(old, new)
    return name, text


def instrumented_copy(repo: Path) -> tuple[str, Path]:
    copy = COPIES / repo.resolve().name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(repo / "lbm_tpu_torch", copy / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = copy / "lbm_tpu_torch" / "csrc" / "lbm_rounds.cuh"
    name, text = instrument(src.read_text())
    src.write_text(text)
    return name, copy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="instrument this checkout's package")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("-o", "--output")
    ap.add_argument("--append", metavar="LABEL",
                    help="add this run, labelled, to the runs the output "
                    "file holds (parent, change, change, parent in turns)")
    args = ap.parse_args(argv)
    schedule, copy = instrumented_copy(Path(args.repo))
    sys.path.insert(0, str(copy))
    import torch

    if not torch.cuda.is_available():
        print("shift_clocks_torch: no CUDA device", file=sys.stderr)
        return 2
    from lbm_tpu_torch.ops import resident

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    categories = SCHEDULES[schedule]["categories"]
    result = {"card": smi, "repo": os.path.relpath(args.repo, REPO),
              "schedule": schedule, "G": G, "cycles_per_block_step": {}}
    for name in args.shapes.split(","):
        p = cs.scene_params(name)
        cells, mask = cs.random_case(torch, name, p, seed=97,
                                     state="perturbed")
        with cs.env():
            kernel = resident.Resident(mask, p.accel_w1, p.accel_w2, p.omega,
                                       G, form="shift")
        bufs = [cells, torch.empty_like(cells)]
        out = torch.zeros(G, device="cuda")
        for _ in range(3):
            bufs[:] = kernel.run(bufs[0], bufs[1], out, 0, 1.0)
        torch.cuda.synchronize()
        sm_clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        per = (out[:len(categories)] / (kernel.blocks * G)).tolist()
        split = dict(zip(categories, per))
        # The step's parts: every category of the clocked thread's own
        # step (not another thread's, nor a global-timer span in ns).
        parts = sum(v for k, v in split.items()
                    if k != "step" and not k.startswith("thread 0")
                    and not k.endswith("(ns)"))
        result["cycles_per_block_step"][name] = {
            **split, "sum of the parts": parts,
            "blocks": kernel.blocks,
            "residence": getattr(kernel, "residence", "device"),
            "sm_clock_after": sm_clock,
            "state_finite": bool(torch.isfinite(bufs[0]).all())}
        del cells, bufs, kernel
        torch.cuda.empty_cache()
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
