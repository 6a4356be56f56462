#!/usr/bin/env python3
"""Where a step of the on-chip form's strip step spends its cycles:
``clock64`` around the parts of ``strip_steps`` in
``lbm_tpu_torch/csrc/lbm_onchip.cuh``, in one buffer (``--bufs 1``) or
two (``--bufs 2``).

No profiler on the card reports stalls inside a kernel, so this script
instruments a copy, as ``scripts/depth_clocks_torch.py`` does. It copies a
checkout's package (``--repo``, this one by default) into
``build/onchip_clocks/`` (a directory ``.gitignore`` lists), inserts
``clock64()`` reads into the copy's strip step for the chosen buffer
count, builds the copy and runs it. Thread 0 of each block (warp 0: the
one that also runs the exchange's release fence and flags where the
schedule has them, and the block's sum) adds the cycles since its last
mark to one of the categories below, over all G steps; after the last
step it writes category q where step q's tot_u partial goes, so that the
kernel's own last block sums each category over the blocks. The cells the
copy computes are the kernel's; the totals it returns are cycle counts.

The categories are the schedule's own (``SCHEDULES``): the checkout's
``lbm_onchip.cuh`` names one schedule for each buffer count (each is
matched by all of its markers), and every patch of that schedule must
occur there exactly once (tests/test_torch_tools.py holds this checkout to
it). Printed per lattice: each category's mean cycles a block and a step,
their sum, the blocks, the strip rows, and the SM clock ``nvidia-smi``
reads.

The lattices (``CASES``): in one buffer, those of ``auto``'s single-buffer
paths; in two, 128x128, 256x256 and 512x512 (``auto``'s on-chip path) and
two shards of the on-chip ring over 4 on a card of 132 SMs, each as one
lattice over the ring's 33 strips a shard: 512x512's (128 rows of 512) and
the 1024x384 x-plan's (256 rows of 384 lanes, column mode).

Usage: python scripts/onchip_clocks_torch.py [--bufs 1|2] [--repo CHECKOUT]
       [-o artifact.json]
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
# Per buffer count, (label, physical NXxNY, axis, blocks or None for the
# planned count). One buffer: the 1024x512 scene's transposed lattice
# (column mode, auto's path), the physical 400x1024 (row mode, auto's
# path) and the 768x768 lattice's shard over 4 (192 rows of 768 over 33
# strips, the ring's strips a shard on a card of 132 SMs) as one lattice
# of 33 strips; the physical 1600x264, strips of two rows wider than a
# wave (auto runs it transposed). Two buffers: see the module's text.
CASES = {
    1: (("1024x512 columns", "1024x512", 1, None),
        ("400x1024 rows", "400x1024", 0, None),
        ("768x192 over 33 strips", "768x192", 0, 33),
        ("1600x264 rows", "1600x264", 0, None)),
    2: (("128x128", "128x128", 0, None),
        ("256x256", "256x256", 0, None),
        ("512x512", "512x512", 0, None),
        ("512x128 over 33 strips (512x512/4 ring shard)", "512x128", 0, 33),
        ("256x384 columns over 33 strips (1024x384 x-plan/4 ring shard)",
         "256x384", 1, 33)),
}


def _head(bufs: int, n: int) -> tuple:
    """Declarations and the step's start and end, shared by every
    schedule of ``n`` categories: thread 0's cycles since its last mark go
    to category q at CK(q) (in strip_steps, for ``bufs`` buffers only) and
    at CKW(q) (in the single-buffer wave loop, while ck_on: the interior
    only); the block's sum is category n - 2, the whole step n - 1."""
    return (
        ("namespace onchip {\n",
         "namespace onchip {\n"
         "__shared__ long long ck_acc[16];\n"
         "__shared__ long long ck_t_sh, ck_s_sh;\n"
         "__shared__ int ck_on;\n"
         f"#define CK(q) if (kBufs == {bufs} && threadIdx.x == 0) {{ "
         "const long long n_ = clock64(); ck_acc[q] += n_ - ck_t_sh; "
         "ck_t_sh = n_; }\n"
         "#define CKW(q) if (ck_on && threadIdx.x == 0) { "
         "const long long n_ = clock64(); ck_acc[q] += n_ - ck_t_sh; "
         "ck_t_sh = n_; }\n"),
        ("    const int h = st.h, r0 = st.row0, ny = st.ny;\n",
         "    const int h = st.h, r0 = st.row0, ny = st.ny;\n"
         "    if (threadIdx.x < 16) ck_acc[threadIdx.x] = 0;\n"
         "    if (threadIdx.x == 0) ck_on = 0;\n"),
        ("        const int slot = (int)(step & 1u);\n",
         "        const int slot = (int)(step & 1u);\n"
         f"        if (kBufs == {bufs} && threadIdx.x == 0) ck_t_sh = ck_s_sh "
         "= clock64();\n"),
        ("            if (lane == 0) partials[(size_t)s * pstride] = v;\n"
         "        }\n",
         "            if (lane == 0) partials[(size_t)s * pstride] = v;\n"
         f"        }}\n        CK({n - 2})\n"
         f"        if (kBufs == {bufs} && threadIdx.x == 0) ck_acc[{n - 1}] += "
         "ck_t_sh - ck_s_sh;\n"),
        ("    const float* fin = (kBufs == 2 && (gsteps & 1)) ? buf1 : buf0;\n",
         f"    if (kBufs == {bufs} && threadIdx.x == 0) {{\n"
         f"        for (int q = 0; q < {n}; ++q) partials[(size_t)q * pstride] "
         "= (float)ck_acc[q];\n    }\n"
         "    const float* fin = (kBufs == 2 && (gsteps & 1)) ? buf1 : buf0;\n"),
        # The copy's static shared memory comes out of the card's limit.
        ("    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                               optin);\n",
         "    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                               optin - 1024);\n"),
    )


# The exchange of the fence-and-flags schedules in one buffer: the sends'
# barrier, warp 0's fence and flags, the receive wait and its barrier.
_FLAGS_ONE_BUFFER = (
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
)


def _split_waves(q: int) -> tuple:
    """The deferred-store wave loop's marks, its gather at category q:
    gather, arrive + compute, wait, deferred stores."""
    return (
        ("        const int o = p < n ? gather(k, p, sp, solid) : -1;\n",
         "        const int o = p < n ? gather(k, p, sp, solid) : -1;\n"
         f"        CKW({q})\n"),
        ("        mbar_wait(bar, phase & 1u);\n",
         f"        CKW({q + 1})\n        mbar_wait(bar, phase & 1u);\n"
         f"        CKW({q + 2})\n"),
        ("            for (int v = 0; v < 9; ++v) held[v] = cell[v];\n"
         "        }\n    }\n",
         "            for (int v = 0; v < 9; ++v) held[v] = cell[v];\n"
         f"        }}\n        CKW({q + 3})\n    }}\n"),
        ("            if (waves - 2 - s >= 0) put(late_o[s], late[s], kLate);\n"
         "        }\n    }\n",
         "            if (waves - 2 - s >= 0) put(late_o[s], late[s], kLate);\n"
         f"        }}\n    }}\n    CKW({q + 3})\n"),
        ("            if (inplace_delay(h, nx) == 1) {\n"
         "                interior(Delay<1>{});\n            } else {\n"
         "                interior(Delay<3>{});\n            }\n",
         "            if (tid == 0) ck_on = 1;\n"
         "            if (inplace_delay(h, nx) == 1) {\n"
         "                interior(Delay<1>{});\n            } else {\n"
         "                interior(Delay<3>{});\n            }\n"
         "            if (tid == 0) ck_on = 0;\n"),
    )


# The two-buffer interior's end, the same text in every schedule.
_TWO_BUFFER_INTERIOR_END = (
    "                for (int k = 0; k < 9; ++k) dst[k * plane + rj + i] = "
    "cell[k];\n            }\n        } else {\n"
    "            // In place, in waves over interior position")

# Per schedule: the buffer count, the texts that all name it in
# lbm_onchip.cuh (markers), the categories (the last two the block's sum
# and the whole step) and its patches (each (text, instrumented text),
# each occurring exactly once), beside the shared ones of _head.
SCHEDULES = {
    # One buffer, two barriers a wave: each wave gathers and computes,
    # passes a barrier, stores and carries, passes a second barrier; the
    # exchange by a release fence and flags.
    "two barriers a wave": {
        "bufs": 1,
        "markers": (
            "            // In waves: interior position p = (j - 1) nx + i, wave\n",
            "Scope::release(cross);"),
        "categories": (
            "force in place + barrier", "sends + barrier",
            "warp 0: fence + flags", "interior: gather + compute",
            "interior: first barrier", "interior: stores + carry",
            "interior: second barrier", "receive wait + barrier",
            "edge waves", "block sum", "step"),
        "patches": _FLAGS_ONE_BUFFER + (
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
    # One buffer, the deferred stores: each wave gathers, arrives,
    # computes, waits on the phase, stores the wave before; the forced
    # line's edge cells are forced by their senders, with no barrier of
    # their own; the exchange by a release fence and flags.
    "one split barrier a wave": {
        "bufs": 1,
        "markers": (
            "            // In place, in waves over interior position p = r nx + i (row\n",
            "Scope::release(cross);"),
        "categories": (
            "force in place (column mode: + barrier)", "row mode: force edge "
            "rows; sends + barrier", "warp 0: fence + flags", "interior: gather",
            "interior: arrive + compute", "interior: wait",
            "interior: deferred stores", "receive wait + barrier",
            "edge waves", "block sum", "step"),
        "patches": _FLAGS_ONE_BUFFER + (
            ("                                          w1, w2);\n"
             "                }\n            }\n        }\n\n        // Send:",
             "                                          w1, w2);\n"
             "                }\n            }\n            CK(0)\n        }\n\n"
             "        // Send:"),
        ) + _split_waves(3),
    },
    # One buffer, the deferred stores, the halo values as words that carry
    # their step's tag: the sends at the step's start, a barrier after
    # them only in the strip that forced a row in place, no fence or flag;
    # a barrier after the interior; each edge gather waits on its own
    # words.
    "one split barrier a wave, tagged words": {
        "bufs": 1,
        "markers": (
            "            // In place, in waves over interior position p = r nx + i (row\n",
            "                    hw.settle(tag, sys);\n"),
        "categories": (
            "force in place (column mode: + barrier)",
            "row mode: force edge rows; sends (+ barrier in the forcing "
            "strip)", "interior: gather", "interior: arrive + compute",
            "interior: wait", "interior: deferred stores",
            "barrier after the interior",
            "edge waves (each gather waits on its words)", "block sum",
            "step"),
        "patches": (
            ("                                          w1, w2);\n"
             "                }\n            }\n        }\n\n        // Send",
             "                                          w1, w2);\n"
             "                }\n            }\n            CK(0)\n        }\n\n"
             "        // Send"),
            ("                __syncthreads();\n            }\n        }\n\n"
             "        float acc = 0.0f;\n",
             "                __syncthreads();\n            }\n        }\n"
             "        CK(1)\n\n        float acc = 0.0f;\n"),
            ("        if constexpr (kBufs == 1) __syncthreads();\n",
             "        if constexpr (kBufs == 1) __syncthreads();\n        CK(6)\n"),
            ("\n        // The block's sum of this step",
             "\n        CK(7)\n        // The block's sum of this step"),
        ) + _split_waves(2),
    },
    # Two buffers, the exchange by a release fence and flags: every step
    # sends its edge rows, meets the block at a barrier, warp 0 fences and
    # stores both flags; the interior; two threads poll the flags, a
    # barrier; the edge rows load their halo through L2; the warp sums'
    # barrier.
    "fence and flags": {
        "bufs": 2,
        "markers": ("Scope::release(cross);",),
        "categories": (
            "sends", "barrier after the sends", "warp 0: fence + flags",
            "interior", "flag poll", "barrier after the poll",
            "halo loads + edge update", "warp sums + barrier",
            "block sum", "step"),
        "patches": (
            ("                                        send_accel, w1, w2, "
             "to_s);\n            }\n            __syncthreads();\n",
             "                                        send_accel, w1, w2, "
             "to_s);\n            }\n            CK(0)\n"
             "            __syncthreads();\n            CK(1)\n"),
            ("                Flag(st.flag_s[slot]).store(tag, "
             "cuda::memory_order_relaxed);\n            }\n",
             "                Flag(st.flag_s[slot]).store(tag, "
             "cuda::memory_order_relaxed);\n            }\n            CK(2)\n"),
            (_TWO_BUFFER_INTERIOR_END,
             _TWO_BUFFER_INTERIOR_END.replace(
                 "        } else {\n", "            CK(3)\n        } else {\n",
                 1)),
            ("            while (from.load(cuda::memory_order_acquire) < tag) "
             "{\n            }\n        }\n        __syncthreads();\n",
             "            while (from.load(cuda::memory_order_acquire) < tag) "
             "{\n            }\n        }\n        CK(4)\n"
             "        __syncthreads();\n        CK(5)\n"),
            ("\n        // The block's sum of this step",
             "\n        CK(6)\n        // The block's sum of this step"),
            ("        if (lane == 0) wsum[warp] = acc;\n        __syncthreads();\n",
             "        if (lane == 0) wsum[warp] = acc;\n        __syncthreads();\n"
             "        CK(7)\n"),
        ),
    },
    # Two buffers, the halo values as words that carry their step's tag:
    # step 0 sends the loaded strip's edge rows; the interior; each edge
    # cell waits on its own words, updates, and sends the next step's
    # words from its registers; one barrier, before the block's sum.
    "tagged words": {
        "bufs": 2,
        "markers": ("pull_halo(hs, hn, south, north, nx, i, iw, ie, tag, "
                    "sys, hv);",),
        "categories": (
            "step 0: sends from the strip", "interior",
            "halo poll (thread 0's words)", "edge update",
            "sends from the update", "warp sums + barrier", "block sum",
            "step"),
        "patches": (
            ("            if (kBufs == 1 && !kCols && r0 <= accel && accel < "
             "r0 + h) {\n                __syncthreads();\n            }\n"
             "        }\n",
             "            if (kBufs == 1 && !kCols && r0 <= accel && accel < "
             "r0 + h) {\n                __syncthreads();\n            }\n"
             "        }\n        CK(0)\n"),
            (_TWO_BUFFER_INTERIOR_END,
             _TWO_BUFFER_INTERIOR_END.replace(
                 "        } else {\n", "            CK(1)\n        } else {\n",
                 1)),
            ("                pull_halo(hs, hn, south, north, nx, i, iw, ie, "
             "tag, sys, hv);\n",
             "                pull_halo(hs, hn, south, north, nx, i, iw, ie, "
             "tag, sys, hv);\n                CK(2)\n"),
            ("= cell[k];\n                if (send) {\n",
             "= cell[k];\n                CK(3)\n                if (send) {\n"),
            ("                            to_s, i, nx, tag + 1u, sys);\n"
             "                    }\n                }\n",
             "                            to_s, i, nx, tag + 1u, sys);\n"
             "                    }\n                }\n                CK(4)\n"),
            ("        if (lane == 0) wsum[warp] = acc;\n        __syncthreads();\n",
             "        if (lane == 0) wsum[warp] = acc;\n        __syncthreads();\n"
             "        CK(5)\n"),
        ),
    },
}


def schedule_of(text: str, bufs: int) -> str:
    """The schedule of ``bufs`` buffers whose markers the strip step's
    source all holds."""
    found = [k for k, s in SCHEDULES.items() if s["bufs"] == bufs
             and all(m in text for m in s["markers"])]
    if len(found) != 1:
        raise SystemExit(f"onchip_clocks_torch: lbm_onchip.cuh names "
                         f"{len(found)} known schedules of {bufs} buffers; "
                         "bring SCHEDULES up to date")
    return found[0]


def patches(name: str) -> tuple:
    """Every patch of schedule ``name``: the shared ones, then its own."""
    s = SCHEDULES[name]
    return _head(s["bufs"], len(s["categories"])) + s["patches"]


def instrument(text: str, bufs: int) -> tuple[str, str]:
    """``(schedule, instrumented text)`` of an ``lbm_onchip.cuh``."""
    name = schedule_of(text, bufs)
    for old, new in patches(name):
        if text.count(old) != 1:
            raise SystemExit(f"onchip_clocks_torch: lbm_onchip.cuh no longer "
                             f"holds exactly one {old!r}; bring the "
                             f"{name!r} patches up to date")
        text = text.replace(old, new)
    return name, text


def instrumented_copy(repo: Path, bufs: int) -> tuple[str, Path]:
    copy = COPIES / f"{repo.resolve().name}-{bufs}"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(repo / "lbm_tpu_torch", copy / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = copy / "lbm_tpu_torch" / "csrc" / "lbm_onchip.cuh"
    name, text = instrument(src.read_text(), bufs)
    src.write_text(text)
    return name, copy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=str(REPO),
                    help="instrument this checkout's package")
    ap.add_argument("--bufs", type=int, choices=(1, 2), default=1)
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    schedule, copy = instrumented_copy(Path(args.repo), args.bufs)
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
              "schedule": schedule, "bufs": args.bufs, "G": G,
              "cycles_per_block_step": {}}
    form = "inplace" if args.bufs == 1 else "onchip"
    for label, name, axis, blocks in CASES[args.bufs]:
        p = cs.scene_params(name)
        cells, mask = cs.random_case(torch, name, p, seed=97,
                                     state="perturbed")
        if axis:
            cells, mask = cs.transposed(cells, mask)
        with cs.env():
            kernel = resident.Resident(mask, p.accel_w1, p.accel_w2, p.omega,
                                       G, axis, form=form, blocks=blocks)
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
