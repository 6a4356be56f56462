#!/usr/bin/env python3
"""Where a step of the on-chip form's single-buffer mode spends its
cycles: ``clock64`` around the parts of ``strip_steps<..., 1, ...>`` in
``lbm_tpu_torch/csrc/lbm_onchip.cuh``.

No profiler on the card reports stalls inside a kernel, so this script
instruments a copy, as ``scripts/depth_clocks_torch.py`` does. It copies a
checkout's package (``--repo``, this one by default) into
``build/onchip_clocks/`` (a directory ``.gitignore`` lists), inserts
``clock64()`` reads into the copy's single-buffer strip step, builds the
copy and runs it. Thread 0 of each block (warp 0: the one that also runs
the exchange's release fence and flags) adds the cycles since its last
mark to one of the categories below, over all G steps; after the last
step it writes category q where step q's tot_u partial goes, so that the
kernel's own last block sums each category over the blocks. The cells the
copy computes are the kernel's; the totals it returns are cycle counts.

The categories are the schedule's own (``SCHEDULES``): the checkout's
``lbm_onchip.cuh`` names which one it runs, and every patch of that
schedule must occur there exactly once (tests/test_torch_tools.py holds
this checkout to it). Printed per lattice: each category's mean cycles a
block and a step, their sum, the blocks, the waves a step, and the SM
clock ``nvidia-smi`` reads.

Usage: python scripts/onchip_clocks_torch.py [--repo CHECKOUT] [-o artifact.json]
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
COPIES = REPO / "build" / "onchip_clocks"
G = 100
# (label, physical NXxNY, axis, blocks or None for the planned count):
# the 1024x512 scene's transposed lattice (column mode, auto's path), the
# physical 400x1024 (row mode, auto's path) and the 768x768 lattice's
# shard over 4 (192 rows of 768 over 33 strips, the ring's strips a shard
# on a card of 132 SMs) as one lattice of 33 strips; the physical 1600x264,
# strips of two rows wider than a wave (auto runs it transposed).
CASES = (("1024x512 columns", "1024x512", 1, None),
         ("400x1024 rows", "400x1024", 0, None),
         ("768x192 over 33 strips", "768x192", 0, 33),
         ("1600x264 rows", "1600x264", 0, None))

# Declarations and the step's start and end, shared by the schedules:
# thread 0's cycles since its last mark go to category q at CK(q) (in
# strip_steps, one buffer only) and at CKW(q) (in the wave loop, while
# ck_on: the interior only).
_HEAD = (
    ("namespace onchip {\n",
     "namespace onchip {\n"
     "__shared__ long long ck_acc[16];\n"
     "__shared__ long long ck_t_sh, ck_s_sh;\n"
     "__shared__ int ck_on;\n"
     "#define CK(q) if (kBufs == 1 && threadIdx.x == 0) { "
     "const long long n_ = clock64(); ck_acc[q] += n_ - ck_t_sh; "
     "ck_t_sh = n_; }\n"
     "#define CKW(q) if (ck_on && threadIdx.x == 0) { "
     "const long long n_ = clock64(); ck_acc[q] += n_ - ck_t_sh; "
     "ck_t_sh = n_; }\n"),
    ("    using Flag = typename Scope::Flag;\n"
     "    extern __shared__ float smem[];\n",
     "    using Flag = typename Scope::Flag;\n"
     "    extern __shared__ float smem[];\n"
     "    if (threadIdx.x < 16) ck_acc[threadIdx.x] = 0;\n"
     "    if (threadIdx.x == 0) ck_on = 0;\n"),
    ("        const int slot = (int)(step & 1u);\n",
     "        const int slot = (int)(step & 1u);\n"
     "        if (kBufs == 1 && threadIdx.x == 0) ck_t_sh = ck_s_sh = "
     "clock64();\n"),
    ("            __syncthreads();\n            if (tid == 0) {\n"
     "                // One release fence",
     "            __syncthreads();\n            CK(1)\n"
     "            if (tid == 0) {\n                // One release fence"),
    ("                Flag(st.flag_s[slot]).store(tag, "
     "cuda::memory_order_relaxed);\n            }\n",
     "                Flag(st.flag_s[slot]).store(tag, "
     "cuda::memory_order_relaxed);\n            }\n            CK(2)\n"),
    ("        __syncthreads();\n\n        // Edge rows 0 and h-1",
     "        __syncthreads();\n        CK(7)\n\n        // Edge rows 0 and h-1"),
    ("\n        // The block's sum of this step",
     "\n        CK(8)\n        // The block's sum of this step"),
    ("            if (lane == 0) partials[(size_t)s * pstride] = v;\n        }\n",
     "            if (lane == 0) partials[(size_t)s * pstride] = v;\n        }\n"
     "        CK(9)\n"
     "        if (kBufs == 1 && threadIdx.x == 0) ck_acc[10] += "
     "ck_t_sh - ck_s_sh;\n"),
    ("    const float* fin = (kBufs == 2 && (gsteps & 1)) ? buf1 : buf0;\n",
     "    if (kBufs == 1 && threadIdx.x == 0) {\n"
     "        for (int q = 0; q < 11; ++q) partials[(size_t)q * pstride] = "
     "(float)ck_acc[q];\n    }\n"
     "    const float* fin = (kBufs == 2 && (gsteps & 1)) ? buf1 : buf0;\n"),
    # The copy's static shared memory comes out of the card's limit.
    ("    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                               optin);\n",
     "    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                               optin - 1024);\n"),
)

# Per schedule: the text that names it in lbm_onchip.cuh, the categories
# 0..10 and the patches of its interior waves (each (text, instrumented
# text), each occurring exactly once).
SCHEDULES = {
    # Two barriers a wave: each wave gathers and computes, passes a
    # barrier, stores and carries, passes a second barrier.
    "two barriers a wave": {
        "marker": "            // In waves: interior position p = (j - 1) nx + i, wave\n",
        "categories": (
            "force in place + barrier", "sends + barrier",
            "warp 0: fence + flags", "interior: gather + compute",
            "interior: first barrier", "interior: stores + carry",
            "interior: second barrier", "receive wait + barrier",
            "edge waves", "block sum", "step"),
        "patches": (
            ("            __syncthreads();\n        }\n\n        // Send:",
             "            __syncthreads();\n            CK(0)\n        }\n\n"
             "        // Send:"),
            ("                }\n                __syncthreads();\n"
             "                if (act) {\n"
             "                    if (p + nx >= wend) {",
             "                }\n                CK(3)\n                __syncthreads();\n"
             "                CK(4)\n                if (act) {\n"
             "                    if (p + nx >= wend) {"),
            ("                    for (int k = 0; k < 9; ++k) buf[k * plane + o] "
             "= cell[k];\n                }\n                __syncthreads();\n"
             "            }\n        }\n\n        // Receive",
             "                    for (int k = 0; k < 9; ++k) buf[k * plane + o] "
             "= cell[k];\n                }\n                CK(5)\n"
             "                __syncthreads();\n                CK(6)\n"
             "            }\n        }\n\n        // Receive"),
        ),
    },
    # The deferred stores: each wave gathers, arrives, computes, waits on
    # the phase, stores the wave before; the forced line's edge cells are
    # forced by their senders, with no barrier of their own.
    "one split barrier a wave": {
        "marker": "            // In place, in waves over interior position p = r nx + i (row\n",
        "categories": (
            "force in place (column mode: + barrier)", "row mode: force edge "
            "rows; sends + barrier", "warp 0: fence + flags", "interior: gather",
            "interior: arrive + compute", "interior: wait",
            "interior: deferred stores", "receive wait + barrier",
            "edge waves", "block sum", "step"),
        "patches": (
            ("                                          w1, w2);\n"
             "                }\n            }\n        }\n\n        // Send:",
             "                                          w1, w2);\n"
             "                }\n            }\n            CK(0)\n        }\n\n"
             "        // Send:"),
            ("        const int o = p < n ? gather(k, p, sp, solid) : -1;\n",
             "        const int o = p < n ? gather(k, p, sp, solid) : -1;\n"
             "        CKW(3)\n"),
            ("        mbar_wait(bar, phase & 1u);\n",
             "        CKW(4)\n        mbar_wait(bar, phase & 1u);\n"
             "        CKW(5)\n"),
            ("            for (int v = 0; v < 9; ++v) held[v] = cell[v];\n"
             "        }\n    }\n",
             "            for (int v = 0; v < 9; ++v) held[v] = cell[v];\n"
             "        }\n        CKW(6)\n    }\n"),
            ("            if (waves - 2 - s >= 0) put(late_o[s], late[s], kLate);\n"
             "        }\n    }\n",
             "            if (waves - 2 - s >= 0) put(late_o[s], late[s], kLate);\n"
             "        }\n    }\n    CKW(6)\n"),
            ("            if (inplace_delay(h, nx) == 1) {\n"
             "                interior(Delay<1>{});\n            } else {\n"
             "                interior(Delay<3>{});\n            }\n",
             "            if (tid == 0) ck_on = 1;\n"
             "            if (inplace_delay(h, nx) == 1) {\n"
             "                interior(Delay<1>{});\n            } else {\n"
             "                interior(Delay<3>{});\n            }\n"
             "            if (tid == 0) ck_on = 0;\n"),
        ),
    },
}


def schedule_of(text: str) -> str:
    """The schedule whose marker the strip step's source holds."""
    found = [k for k, s in SCHEDULES.items() if s["marker"] in text]
    if len(found) != 1:
        raise SystemExit("onchip_clocks_torch: lbm_onchip.cuh names "
                         f"{len(found)} known schedules; bring SCHEDULES up "
                         "to date")
    return found[0]


def instrument(text: str) -> tuple[str, str]:
    """``(schedule, instrumented text)`` of an ``lbm_onchip.cuh``."""
    name = schedule_of(text)
    for old, new in _HEAD + SCHEDULES[name]["patches"]:
        if text.count(old) != 1:
            raise SystemExit(f"onchip_clocks_torch: lbm_onchip.cuh no longer "
                             f"holds exactly one {old!r}; bring the "
                             f"{name!r} patches up to date")
        text = text.replace(old, new)
    return name, text


def instrumented_copy(repo: Path) -> tuple[str, Path]:
    copy = COPIES / repo.resolve().name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(repo / "lbm_tpu_torch", copy / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = copy / "lbm_tpu_torch" / "csrc" / "lbm_onchip.cuh"
    name, text = instrument(src.read_text())
    src.write_text(text)
    return name, copy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="instrument this checkout's package")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    schedule, copy = instrumented_copy(Path(args.repo))
    sys.path.insert(0, str(copy))
    import torch

    if not torch.cuda.is_available():
        print("onchip_clocks_torch: no CUDA device", file=sys.stderr)
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
              "schedule": schedule, "G": G,
              "cycles_per_block_step": {}}
    for label, name, axis, blocks in CASES:
        p = cs.scene_params(name)
        cells, mask = cs.random_case(torch, name, p, seed=97,
                                     state="perturbed")
        if axis:
            cells, mask = cs.transposed(cells, mask)
        with cs.env():
            kernel = resident.Resident(mask, p.accel_w1, p.accel_w2, p.omega,
                                       G, axis, form="inplace", blocks=blocks)
        bufs = [cells, torch.empty_like(cells)]
        out = torch.zeros(G, device="cuda")
        for _ in range(3):
            bufs[:] = kernel.run(bufs[0], bufs[1], out, 0, 1.0)
        torch.cuda.synchronize()
        sm_clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        per = (out[:len(categories)] / (kernel.blocks * G)).tolist()
        rows, lanes = mask.shape
        h = -(-rows // kernel.blocks)
        split = dict(zip(categories, per))
        parts = sum(per[:-1])
        result["cycles_per_block_step"][label] = {
            **split, "sum of the parts": parts,
            "blocks": kernel.blocks, "strip_rows": h, "lanes": lanes,
            "interior_waves": -(-(h - 2) * lanes // resident.THREADS),
            "edge_waves": -(-min(h, 2) * lanes // resident.THREADS),
            "sm_clock_after": sm_clock,
            "state_finite": bool(torch.isfinite(bufs[0]).all())}
        del cells, bufs, kernel
        torch.cuda.empty_cache()
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
