#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (lbm_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Grids are named NXxNY, as the repository names them (``Params(nx=...,
ny=...)``): 131072x128 is 131072 columns by 128 rows. A wide grid (nx >=
2 ny, nx a multiple of 8: ``ops.plan.transposed_layout``) runs under
``auto`` on the transposed lattice (9, nx, ny), every kernel in column
mode, and its mesh plan shards physical x (the x-plan). Phases, each
printing JSON lines (any failure raises and exits non-zero):

1. device  - the card (nvidia-smi name and power limit), torch, CUDA;
2. build   - nvcc builds lbm_tpu_torch/csrc/*.cu (one nvcc per source,
             in parallel) into build/lbm_tpu_torch/;
3. kernel  - every kernel in row mode against its plain PyTorch version
             on the card, one line per grid: the one-step kernel for one
             step, the depth kernel for one call at D = 2, 4, 8 (cells max
             abs error 0; a step's tot_u the same bits at the first and at
             the last stage of a launch, and under D = 2 and D = 4), its
             flow form wherever the planner takes it (one launch of K
             rounds: cells max abs error 0, cells and tots those of K
             one-round launches bit for bit) and the
             resident kernel for one call at G = 16 in both forms (the
             on-chip form wherever a strip fits; cells max abs error 0) and
             the device form's shift mode (cells max abs error 0, each
             step's tot the device form's bits),
             against n steps of the plain version, at 1024x1024 (scene
             mask), 128x128 (and an odd G = 5 there), a ragged 100x130
             wall-less mask, 16384x1024, 131072x128, 128x131072, 512x512
             and 1024x256, physical layout; all three BGK associations at
             256x256; the on-chip form's single-buffer mode wherever its
             strips fit (cells max abs error 0, tots the two-buffer
             mode's bits where both fit), and alone at 4096x64, 768x768,
             1024x400 and 1024x512 (the last two transposed, column mode)
             for one call at G = 1, 2, 99 and 100; then 204 steps at
             1024x1024 of every plan through the runner (auto: two flow
             launches and a one-round tail) against the one-step kernel,
             with bit-identical repeats and the plan's launch counts, the
             depth and resident plans' cells (D = 2's and the device
             form's tots too) auto's bits;
4. wide_kernel - the same calls in column mode on the transposed lattice
             at 131072x128, 16384x1024, 1024x256 and a ragged wall-less
             264x100, and all three associations at 512x128: max abs
             error 0 against the plain version (the on-chip form at
             1024x256, 264x100 and 512x128);
4b. onchip_scene - the reference coursework's 256x256 scene, 80000
             steps, through the CLI under auto (the plan line says
             "resident G=100 on-chip x800") and with LBM_RESIDENT_FORM=
             device, in turns: launch counts equal the plan's, drift
             within 0.3 % of goldens/256x256.final_state.f64.npz, the two
             forms' final states the same bytes, Compute seconds;
4b2. shift_scene - the device form's shift mode (LBM_RESIDENT_SHIFT):
             the 256x256 scene, 80000 steps, through the CLI under the pin
             ("resident G=100 device-memory shift x800") and with
             LBM_RESIDENT_FORM=device, in turns: drift within 0.3 % of its
             golden, final states and av_vels files the same bytes, cells
             and av_vels through the runner the same bits; then 4096x64
             and 8192x32 (the wide scenes' params, the generator's walls),
             20000 steps each under auto (the shift mode) and
             LBM_RESIDENT_SHIFT=0, in turns, the same checks, and 500 steps
             under auto within 0.3 % of the port's plain float64 run on
             the card;
4c. inplace_scene - the single-buffer mode's path: 1024x512 with the
             wide scenes' parameters (accel 0.01, omega 1.85) and the
             generator's walls, 20000 steps through the CLI under auto
             (transposed: "resident G=100 on-chip 1-buf x200") and with
             LBM_RESIDENT=0 (D=4), in turns: launch counts equal the
             plan's, the final states the same bytes, av_vels within
             1e-4, the cells through the runner bit for bit; 500 steps
             under auto within 0.3 % of the port's plain float64 run on
             the card; the planned kernel beside D=4, in turns;
5. scene   - the reference's 1024x1024 scene (20000 steps) through the
             port's CLI, once per plan: --kernel auto, the one-step
             kernel pinned (LBM_RESIDENT=0 LBM_PALLAS_DEPTH=1), the
             resident kernel's device-memory form forced (LBM_RESIDENT=1
             LBM_RESIDENT_FORM=device: its output files the same bytes as
             auto's, D=4, whose per-step tots it shares bit for bit) and a
             depth pinned (LBM_RESIDENT=0 LBM_PALLAS_DEPTH=...). Launch
             counts equal the plan's, and each run is within the 0.3 %
             drift budget of goldens/1024x1024.final_state.f64.npz;
6. wide_gate - 131072x128 with the generator's walls and the scene's
             forcing, 500 steps, through the CLI under auto (the plan line
             says "transposed"), the one-step plan, the resident plan and
             the physical layout through the runner; 1024x256 (the
             resident kernel's size, which the rule keeps physical) through
             the CLI. Each within the 0.3 % budget of the port's plain
             float64 run on the card (check.py's max %-diff of av_vels and
             final pressure), its margin printed, launch counts equal the
             plan's;
7. stress  - 16384x1024 (transposed under auto) with generated walls
             and the scene's forcing, 1000 steps through the runner:
             every depth and the resident kernel against the one-step
             kernel;
8. timing  - per-step time of every kernel configuration (the depth
             kernel's flow form, 25 rounds a launch, among them) at 128x128,
             256x256, 512x512, 1024x1024 and 16384x1024 (physical layout;
             the resident kernel in both forms where a strip fits) with
             CUDA events, as the runner drives them and as device time
             alone; the plain version at 256x256 and 1024x1024; there also
             the tot_u
             sum as the one-step kernel launches it and as the depth
             kernel's epilogue runs it, each against torch.sum of the same
             partials (relative error at most 1e-6);
9. wide_timing - the same, in both layouts (row mode on the physical
             lattice, column mode on the transposed one): one-step,
             D = 2, 4, 8 and resident G=100 at 131072x128 and 16384x1024,
             D=4 and resident G=100 in both forms at 1024x256 and 1024x384;
             the plain version on the transposed lattice (the numbers the
             layout rule and the wide depth rule are set from);
9b. onchip_timing - the on-chip resident form at 32, 64, 128 blocks and
             one an SM at 128x128, 256x256, 512x512 and 1024x256 (the
             small-grid floor), and both forms beside D=4 at 640x512,
             768x512, 1024x384, 600x600, 792x528 (the largest lattice whose
             two-buffer strips fit), 1024x512, 768x768 and 1024x768 (the
             numbers RESIDENT_AUTO_MAX_CELLS is set from), and at 1600x264
             and 1200x396 (one-buffer strips of 2 and 3 rows), with the
             single-buffer mode wherever its strips fit, and the device
             form's shift mode everywhere; then 4096x64, 8192x32 and
             400x1024 (narrow channels, row mode), 1024x400 and 3200x128
             (tall boxes, transposed, column mode) as auto plans them, the
             plan asserted to be the form resident.planned_form gives (the
             single-buffer mode; the shift mode for the one-row strips of
             4096x64 and 8192x32): 200 steps through the runner with the
             plan's launches, and the single-buffer mode, the device-memory
             form, its shift mode (row mode) and D=4 timed in turns;
10. shard_kernel - the sharded path's kernels, one call on every shard
             against the plain shard step (halo.ReferenceShardImpl) on
             the same inputs: the one-step kernel's seam mode, the depth
             kernel's seam mode at each D every shard can hold, and the
             ring kernel (rounds of D steps) at G = 16 (D = 4 where a
             shard has 4 rows) and G = 18 (D = 2), its per-step tots also
             the bits of the seam depth kernel's at the same D; the ring
             with max abs error 0 in both modes. Row plan: 1024x1024
             (scene mask), 16384x1024 and a walled 1024x1022 (wall pad 2)
             over 4 shards on one card, a wall-less 100x130 over 4 (wrap
             pad 2, one-step only) and 16x16 over 8 (the forced row on a
             shard edge).
             x-plan (column mode): 131072x128, 16384x1024 and a wall-less
             264x100 over 4, 64x16 over 8; max abs error 0;
10b. ring_onchip_kernel - the on-chip ring (csrc/ring_onchip.cu) for one
             call on every shard at G = 16 and 100 against the plain shard
             steps, in each mode whose strips fit (two buffers; one buffer,
             in place): 256x256, 512x512, 640x512, 768x768 (one buffer
             only) over 4 shards (row plan), the x-plans of 1024x512 (one
             buffer only) and 1024x384, strips of one row (128x128 over 4)
             and the forced row on a shard edge (16x16 over 8): cells max
             abs error 0, one buffer's tots the two buffers' bits;
11. shard_scene - the 1024x1024 scene through run_simulation(mesh=) over
             4 shards on one card, once per plan (auto: seam depth D=4;
             ring: LBM_SHARD_RESIDENT=1; step: LBM_PALLAS_DEPTH=1), each
             within the drift budget, bit-identical to the unsharded auto
             run, with the plan's launch counts; the CLI with --devices 4
             (its clamp note on a one-card machine); then a cross_card
             line: the auto and ring runs across min(4, cards) cards, or
             ``"run": false`` on one card;
11b. ring_onchip_scene - the on-chip ring's path: under auto with
             LBM_SHARD_RESIDENT=1 over 4 shards through run_simulation(mesh=)
             (the wide scenes' params, the generator's walls), 768x768 (row
             mode, one buffer) and the 1024x512 x-plan (column mode, one
             buffer) at 20000 steps, 512x512 (two buffers) at 20000 and the
             1024x384 x-plan (two buffers) at 2000: the plan names the form
             ("ring G=100 on-chip 1-buf x200"), launch counts equal the
             plan's, cells bit-identical to the unsharded auto run, and 500
             steps within the 0.3 % budget of the port's plain float64 run
             on the card;
12. wide_shard - 131072x128 over 4 shards on one card (the x-plan), 200
             steps under the same three plans, each bit-identical to the
             unsharded (transposed) auto run, with the plan's launch
             counts;
13. shard_timing - per-step time, loop and device, of the seam kernels
             (D = 1, 2, 4, 8) and the ring (G = 16, 100; its D in
             ring_depths) over 4 shards on one card at 1024x1024 and
             16384x1024 (row plan), beside the unsharded best; the halo
             exchange alone (events, and copies where the plan copies:
             none for D = 1 on one card); the plain shard step at
             1024x1024; then the wrap path, a wall-less 1024x1022 over 4
             shards (wrap pad 2, the one-step seam kernel on every step):
             200 calls against 200 plain shard steps (cells max abs error
             0, launches: the seam kernel's alone), loop and device ms a
             step (the forms each kernel replaced: scripts/ring_ab_torch.py
             and scripts/seam_step_ab_torch.py run on the parent commit);
             then the on-chip ring at G=100 in each mode that fits beside
             the device-memory ring and seam D=4, in turns, at 256x256,
             512x512, 640x512, 768x768 and the x-plans of 1024x512 and
             1024x384 over 4 shards, with the planned form, its ratios to
             the other two and the plain shard step (the numbers the ring's
             form rule is held to);
14. wide_shard_timing - over 4 shards on one card, the x-plan against
             the row plan at 131072x128 and 16384x1024 (seam D=1, D=4,
             ring G=100), halo copies per call; the plain shard step of
             the x-plan at 131072x128.

15. probe_kernel - the stream-cost probe (csrc/probe.cu: the
             device-memory resident form's rounds with the probe's stage
             bodies) in its three modes for one call at G = 16 against its
             plain version (ops.reference.probe_multi_step) at 1024x1024,
             128x128, a ragged wall-less 100x130 and 16384x1024: cells max
             abs error 0; full mode's cells also equal the resident
             kernel's with the forcing set to 0, and its totals are the
             bits of the device-memory form's with the forcing set to 0;
16. probe_path - the probe's own path, scripts/stream_cost_probe_torch.py
             at 1024x1024 (its launches are the probe kernels' counts in
             the kernels line);
17. probe_timing - device ms per step of the three modes and of the
             resident kernel's device-memory form at G = 100, in turns, at
             1024x1024 (two 37.7 MB buffers, above the 50 MB L2), 512x512
             (in L2) and 16384x1024; the two streaming shares,
             (full - collide) / full and stream / full; each mode's blocks
             and rounds; the plain version;
17b. mxu_kernel - the tensor-core equilibrium (csrc/mxu_eq.cu: the
             device-memory form's rounds, the equilibria a (9, 6) x (6, N)
             product in f64, DMMA) for one call at G = 100 against its plain
             version (ops.mxu_eq.mxu_multi_step) at 1024x1024 (the scene's
             mask, its column obstacle), a ragged wall-less 100x130 and
             264x100: cells within mxu_eq.cells_atol, totals within 1e-4;
             against the elementwise device form at the drift level
             (check.py's formula on the totals and the pressure, 0.3 %);
             the DMMA (or HMMA) instructions in its SASS;
17c. mxu_scene - the 1024x1024 scene, all 20000 steps, through
             ops.mxu_eq.MxuStep (G = 100): its final state against
             goldens/1024x1024.final_state.f64.npz within the 0.3 %
             budget, the margin printed; the launches are the kernels
             line's;
17d. mxu_timing - device ms per step of the kernel and of the
             device-memory form at G = 100 at 1024x1024, in turns, and the
             plain version; then scripts/mxu_probe_torch.py's main at 200
             steps (its file under build/);
18. resume   - the 1024x1024 scene, 20000 steps, through the CLI in
             subprocesses: --chunk-iters 3002 (even, no multiple of D = 4;
             a 1988-step tail);
             --iters 10000 --checkpoint-every 5000, then --resume;
             --checkpoint-every 2000 with a SIGTERM once the first
             checkpoint exists (exit code 75, the stderr line, no output
             files), then --resume: the output files byte-identical to
             the single-shot auto run's. Through run_simulation: the same
             over 4 shards on one card, resumed over 4 shards and
             unsharded; 131072x128 (transposed), 500 steps, checkpointed
             at 248 and at 250 and resumed, and in chunks of 100 and of
             150, unsharded and over 4 shards (the x-plan). Cells always
             equal the single-shot run's bit for bit, and so do av_vels
             (those of the single-shot run under the same mesh: the
             sharded sum has its own order), where every launch stays at
             its place (248, 100: multiples of D) and where the launches
             shift by two steps (250, 150): the depth kernel sums a step
             the same way at every stage. Seconds per save, checkpoint
             size;
19. debug    - --debug --iters 20 at 128x128 through the CLI and over 4
             shards: 60 lines in the reference's format, the av values
             equal to the av_vels of the non-debug one-step plan;
20. trace    - --trace DIR --iters 2000 on the 1024x1024 scene under auto
             through the CLI, and run_simulation(mesh=, trace_dir=) over 4
             shards under the seam plan and under the ring: the trace
             summary (profiling.summarise) finds each path's kernels by
             name with exactly the plan's launches and, on these depth
             plans, no launch of the tot_u sum, and gives the card's
             busy share and the longest idle gaps; traced against untraced
             compute seconds;
21. harness  - the host module and the harness scripts: the 1024x1024
             and 16384x1024 final states through the C writer
             (csrc_host/lbm_io.c) and the plain numpy writer, the same
             bytes, both times; scripts/validate_scenes_torch.py on the
             256x256 scene (both associations within 0.3 % of its float64
             golden); scripts/full_scenes_torch.py on 2048x1024 for 2000
             steps (auto against the plain float32 path); dryrun_torch's
             dryrun_multichip(4) as four shards on the card; one cell of
             scripts/ab_kernel_torch.py. Any row that is not ok fails.

Then the kernels line (every kernel, row and column modes, the
device-memory form's shift mode (4096x64's scene under auto; times from
onchip_timing's row), the on-chip resident form in two buffers and in one
(row mode: 400x1024 through the runner; column mode: the 1024x512 scene), the on-chip ring in two buffers
and in one (ring_onchip_scene's 512x512, 1024x384, 768x768 and 1024x512
over 4 shards; times from shard_timing's rows), the probe's three, the
tensor-core kernel (the mxu_scene's launches; its error the largest
against its plain version, within its stated tolerance), with its
launches on its path,
error against its plain version, time, plain time and bound; the
ring's rows also its D, its loop time and a design ceiling of one pass
over the lattice per round, the resident and probe rows that ceiling too
(the probe's also its blocks); the seam one-step rows their loop time and,
in row mode, the wrap path's device time), the nvidia-smi line, and a last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 before
printing anything. ``--phases a,b`` (for development) runs only the named
phases after device and build, and then prints no kernels line and no ok
line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SCENE = "1024x1024"
ITERS = 20000
GOLDEN = REPO / "goldens" / "1024x1024.final_state.f64.npz"
SCENE_DIR = REPO / "build" / "lbm_tpu_torch" / "smoke_scene"
# The repo's kernel-vs-reference bounds (tests/test_pallas.py) and its
# f32 drift budget against the f64 golden (scripts/validate_scenes.py).
RTOL, ATOL, TOT_RTOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4, 1e-4
DRIFT_BUDGET_PCT = 0.3
MODES = {
    "paired": {},
    "reference_order": {"LBM_PAIRED_EQ": "0"},
    "omega_absorbed": {"LBM_OMEGA_EQ": "1"},
}
PLAN_ENV = ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_SHARD_RESIDENT", "LBM_RESIDENT_FORM", "LBM_RESIDENT_INPLACE",
            "LBM_RESIDENT_SHIFT")
DEPTHS = (2, 4, 8)
KERNEL_G = 16
# Kernel-phase grids (NXxNY) and their masks: the scene's, the
# generator's walls, or random and wall-less (periodic in both axes).
KERNEL_CASES = [("1024x1024", "scene"), ("128x128", "walls"),
                ("100x130", "random"), ("16384x1024", "walls"),
                ("131072x128", "walls"), ("128x131072", "walls"),
                ("512x512", "walls"), ("1024x256", "walls")]
STRESS, STRESS_ITERS = "16384x1024", 1000
# Not a multiple of the flow form's 100 steps a launch: auto runs 1024x1024
# as two launches of 25 rounds and a one-round D=4 tail.
TRAJ_STEPS = 204
# The flow form as the planner runs it (plan.FLOW_STEPS steps a launch).
FLOW_ROUNDS = 25
FLOW_LABEL = f"depth D=4 K={FLOW_ROUNDS}"
TIMING_GRIDS = ("128x128", "256x256", "512x512", "1024x1024", "16384x1024")
# Plans driven through the CLI on the scene; the depth pin is the depth
# auto does not take at 1024x1024, so the scene runs every kernel.
SCENE_PLANS = {
    "auto": {},
    "step": {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "1"},
    "resident": {"LBM_RESIDENT": "1", "LBM_RESIDENT_FORM": "device"},
    "depth": {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "8"},
}
# The wide-grid path: the JAX package's wide stress grids (131072x128 and
# 16384x1024, BENCH_r05.json), 1024x256 (a wide grid of the resident
# kernel's size, where the layout rule keeps the physical layout) and a
# ragged wall-less 264x100.
WIDE, WIDE_RESIDENT = "131072x128", "1024x256"
WIDE_KERNEL_CASES = [(WIDE, "walls"), ("16384x1024", "walls"),
                     (WIDE_RESIDENT, "walls"), ("264x100", "random")]
WIDE_MODES_GRID = "512x128"
WIDE_GATE_ITERS = 500
# 1024x384: a wide grid above the layout rule's 512x512 cells and under
# the resident kernel's limit (its transposed lattice fits on chip).
WIDE_LIMIT = "1024x384"
WIDE_TIMING_GRIDS = (WIDE, "16384x1024", WIDE_RESIDENT, WIDE_LIMIT)
# The on-chip resident form's path: the reference coursework's 256x256
# scene (the generator's walls, no column; accel 0.005), all 80000 steps,
# against its float64 golden.
ONCHIP_SCENE, ONCHIP_ITERS, ONCHIP_ACCEL = "256x256", 80000, 0.005
ONCHIP_GOLDEN = REPO / "goldens" / "256x256.final_state.f64.npz"
ONCHIP_SCENE_PLANS = {"auto": {}, "device": {"LBM_RESIDENT_FORM": "device"}}
# The small-grid floor: the on-chip form at these block counts (and the
# SM count) beside the device-memory form and D=4; the crossover grids:
# both forms and D=4 from 512x512 to the largest lattice whose strips fit
# (792x528) and above it.
ONCHIP_BLOCK_GRIDS = ("128x128", "256x256", "512x512", "1024x256")
ONCHIP_BLOCKS = (32, 64, 128)
CROSSOVER_GRIDS = ("640x512", "768x512", "1024x384", "600x600", "792x528",
                   "1024x512", "768x768", "1024x640", "1024x768")
# Physical lattices whose two-buffer strips do not fit and whose
# one-buffer strips are 2 and 3 rows (264 and 396 rows over 132 blocks):
# the strip heights between a one-row strip (4096x64) and the crossover
# grids' 4 to 6 rows, the numbers plan.INPLACE_MIN_ROWS is set from.
STRIP_GRIDS = ("1600x264", "1200x396")
# Lattices under RESIDENT_AUTO_MAX_CELLS whose two-buffer strips do not fit
# on chip, as auto runs them: narrow channels in row mode (4096x64 and
# 8192x32, strips of one row, on the device-memory form's shift mode;
# 400x1024) and tall boxes transposed, in column mode (1024x400,
# 3200x128), on the single-buffer mode.
AUTO_GRIDS = ("4096x64", "8192x32", "1024x400", "400x1024", "3200x128")
# The single-buffer mode's path: 1024x512 with the parameters of the
# scenes 1024 and more wide (scripts/sweep.py: accel 0.01, omega 1.85) and
# the generator's walls; auto runs it transposed, on the single-buffer
# mode, above RESIDENT_AUTO_MAX_CELLS. And the mode against the plain
# version at its shapes (4096x64 pinned: auto leaves its one-row strips
# to the device form; 1024x640, rows of 1024 lanes, a wave each, whose
# stores wait one wave; 2001x200, rows wider than a wave, three).
INPLACE_SCENE, INPLACE_ITERS, INPLACE_GATE_ITERS = "1024x512", 20000, 500
INPLACE_ACCEL = 0.01
INPLACE_KERNEL_CASES = [("4096x64", 0), ("768x768", 0), ("1024x400", 1),
                        (INPLACE_SCENE, 1), ("1024x640", 0),
                        ("2001x200", 0)]
INPLACE_GS = (1, 2, 99, 100)
# The row-mode path of the kernels line: AUTO_GRIDS' 400x1024.
INPLACE_ROW_GRID = "400x1024"
# The device-memory form's shift mode (LBM_RESIDENT_SHIFT): the 256x256
# reference scene under the pin beside the device form's default mode, and
# its path under auto, a narrow channel with the wide scenes' parameters
# and the generator's walls (the kernels line's path), beside
# LBM_RESIDENT_SHIFT=0.
SHIFT_SCENE_PLANS = {"shift": {"LBM_RESIDENT_SHIFT": "1"},
                     "device": {"LBM_RESIDENT_FORM": "device"}}
SHIFT_AUTO_SCENE, SHIFT_AUTO_ITERS, SHIFT_GATE_ITERS = "4096x64", 20000, 500
# Both narrow channels auto runs in the shift mode; the first is the
# kernels line's path.
SHIFT_AUTO_SCENES = (SHIFT_AUTO_SCENE, "8192x32")
SHIFT_AUTO_PLANS = {"auto": {}, "off": {"LBM_RESIDENT_SHIFT": "0"}}


def grid(name: str) -> tuple[int, int]:
    """``(nx, ny)`` of a grid named NXxNY."""
    nx, ny = name.split("x")
    return int(nx), int(ny)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def env(**values):
    """Set the given environment variables and clear the other plan and
    association pins for the duration; restore everything after."""
    keys = set(PLAN_ENV) | {"LBM_PAIRED_EQ", "LBM_OMEGA_EQ"} | set(values)
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def scene_params(name=SCENE, iters=ITERS, dtype=None):
    from lbm_tpu_torch.params import Params

    nx, ny = grid(name)
    extra = {} if dtype is None else {"dtype": dtype}
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.01, omega=1.85, **extra)


def scene_mask():
    """The reference's 1024x1024 obstacles: the generator's boundary
    walls plus one full-height column at x = nx // 3."""
    from lbm_tpu_torch.obstacles import generate_obstacles

    nx, ny = grid(SCENE)
    mask = generate_obstacles(nx, ny)
    mask[:, nx // 3] = True
    return mask


def random_case(torch, name, p, seed, mask_kind="walls", state="uniform"):
    """Seeded device state whose forced row fails the guard in places,
    and its mask. ``state``: "uniform", each value in [0.01, 0.2] (far
    from equilibrium; at omega 1.85 such a state is unstable, so it is
    held for one step only), or "perturbed", the scene's equilibrium at
    rest with each value moved by up to +-10 % (stable, for many-step
    comparisons)."""
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.state import initial_state

    nx, ny = grid(name)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((9, ny, nx), generator=g, device="cuda")
    if state == "uniform":
        cells = noise * 0.19 + 0.01
    else:
        cells = initial_state(p, "cuda") * (1.0 + 0.2 * (noise - 0.5))
    fail = torch.rand(nx, generator=g, device="cuda") < 0.3
    cells[6, ny - 2][fail] = float(p.accel_w2)
    if mask_kind == "walls":
        mask = torch.from_numpy(generate_obstacles(nx, ny)).cuda()
    elif mask_kind == "scene":
        mask = torch.from_numpy(scene_mask()).cuda()
    else:
        mask = torch.rand((ny, nx), generator=g, device="cuda") < 0.15
    return cells.contiguous(), mask


def compare(torch, got, got_tots, want, want_tots):
    """Errors of a kernel's cells and tots against the plain version's,
    and whether cells meet rtol/atol and every tot its rtol."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    err = (got - want).abs()
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    tot_rel = float(((got_tots - want_tots).abs() / want_tots.abs()).max())
    return {"max_abs_err": float(err.max()), "cells_ok": ok,
            "tot_rel_err": tot_rel, "tot_ok": tot_rel <= TOT_RTOL}


def check_depth(r, name, where):
    """What only the depth kernel's results hold: cells equal to the plain
    version's bit for bit, and a step's total independent of its stage
    and of which of D = 2 and D = 4 ran it. Both resident forms' cells
    too are the plain version's bit for bit."""
    if name.startswith("resident"):
        check(r["max_abs_err"] == 0.0, f"{name} cells != plain at {where}")
        # One buffer updates and sums each cell as two do; the shift mode
        # each cell as the device form's rounds (the depth plan's bits).
        check(r.get("tots_equal_two_buffer", True),
              f"{name}: tots differ from the two-buffer mode's at {where}")
        check(r.get("tots_equal_device_form", True),
              f"{name}: tots differ from the device form's at {where}")
    if not name.startswith("depth"):
        return
    check(r["max_abs_err"] == 0.0, f"{name} cells != plain at {where}")
    if name.startswith("depth_flow"):
        # One launch of K rounds: the cells and every tot of K one-round
        # launches, and its wait count within its flowing tiles.
        check(r["equals_one_round_launches"], f"{name}: cells or tots "
              f"differ from one-round launches at {where}")
        check(0 <= r["waits"] <= r["flow_tiles"],
              f"{name}: {r['waits']} waits of {r['flow_tiles']} at {where}")
        return
    check(r["stage_bits_equal"], f"{name}: a step's tot_u depends on its "
          f"stage at {where}")
    check(r.get("equals_first_stages_of_D4", True),
          f"D=2 and D=4 sum a step differently at {where}")


def transposed(cells, mask):
    """The transposed lattice and mask of a physical state: the execution
    layout of a wide grid, for the kernels' column mode."""
    from lbm_tpu_torch.state import transpose_state

    return transpose_state(cells), mask.T.contiguous()


def compare_kernels(torch, name, kind, p, seed, odd_g=False, axis=0):
    """Every kernel against n plain steps: the one-step kernel for one
    step of a uniform state, the many-step kernels for one call on a
    perturbed one (same seed, same mask). ``axis`` 1: on the transposed
    lattice, the kernels and the plain version in column mode. Where the
    planner gives the depth kernel K rounds a launch (plan.flow_rounds),
    one flow launch of K rounds too, against 4 K plain steps and against
    K one-round launches (cells and tots, bit for bit)."""
    from lbm_tpu_torch.ops import fused, fused_depth, plan, resident
    from lbm_tpu_torch.ops import reference as ref_ops

    cells, mask = random_case(torch, name, p, seed, kind, "uniform")
    if axis:
        cells, mask = transposed(cells, mask)
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    res = {}
    got, tot = fused.fused_step(cells, *args, axis=axis)
    want, want_tot = ref_ops.fused_step(cells, *args, axis=axis)
    res["fused_step"] = compare(torch, got, tot[None], want, want_tot[None])
    del cells, got, want

    cells, pmask = random_case(torch, name, p, seed, kind, "perturbed")
    if axis:
        cells = transposed(cells, pmask)[0]
    # Plain states to keep: after each kernel's steps, and a step before
    # each depth's last (where a second depth launch starts).
    before = {d - 1 for d in DEPTHS}
    rounds = plan.flow_rounds(cells.shape[1], cells.shape[2],
                              fused_depth.block_slots("cuda", axis), axis)
    flow_steps = fused_depth.FLOW_DEPTH * rounds
    gs = {KERNEL_G} | ({5} if odd_g else set())
    keep = {*DEPTHS} | gs | before | ({flow_steps} if rounds > 1 else set())
    plain, tots, c = {}, [], cells
    for n in range(1, max(keep) + 1):
        c, tot = ref_ops.fused_step(c, *args, axis=axis)
        tots.append(tot)
        if n in keep:
            plain[n] = c
    tots = torch.stack(tots)
    depth_tots = {}
    for d in DEPTHS:
        got, t = fused_depth.fused_depth(cells, *args, d, axis=axis)
        r = res[f"depth D={d}"] = compare(torch, got, t, plain[d], tots[:d])
        # Step d is the last stage of that launch and the first of one
        # that starts a step before it: the same bits.
        _, later = fused_depth.fused_depth(plain[d - 1], *args, d, axis=axis)
        r["stage_bits_equal"] = bool(t[d - 1] == later[0])
        depth_tots[d] = t
    # The two depths auto plans share tile and map: D = 2 sums as D = 4.
    res["depth D=2"]["equals_first_stages_of_D4"] = bool(
        torch.equal(depth_tots[2], depth_tots[4][:2]))
    if rounds > 1:
        d = fused_depth.FLOW_DEPTH
        flow = fused_depth.FusedDepth(*args, d, axis, rounds)
        t = torch.empty(flow_steps, device="cuda")
        got, _ = flow.run(cells.clone(), torch.empty_like(cells), t)
        r = res[f"depth_flow D={d} K={rounds}"] = compare(
            torch, got, t, plain[flow_steps], tots[:flow_steps])
        one = fused_depth.FusedDepth(*args, d, axis)
        c = [cells.clone(), torch.empty_like(cells)]
        t1 = torch.empty(flow_steps, device="cuda")
        for k in range(rounds):
            c[:] = one.run(c[0], c[1], t1, d * k)
        torch.cuda.synchronize()
        r["equals_one_round_launches"] = bool(torch.equal(got, c[0])
                                              and torch.equal(t, t1))
        r["waits"], r["flow_tiles"] = flow.waits(), flow.flow_tiles
        del flow, got, c
    onchip = onchip_fits(cells.shape[1], cells.shape[2])
    inplace = onchip_fits(cells.shape[1], cells.shape[2], buffers=1)
    for g in sorted(gs):
        got, dev = resident.resident(cells, *args, g, axis=axis,
                                     form="device")
        res[f"resident G={g}"] = compare(torch, got, dev, plain[g], tots[:g])
        if not axis:
            # The shift mode (row mode only): the device form's tot bits.
            got, t = resident.resident(cells, *args, g, form="shift")
            r = res[f"resident_shift G={g}"] = compare(torch, got, t,
                                                       plain[g], tots[:g])
            r["tots_equal_device_form"] = bool(torch.equal(t, dev))
        if onchip:
            got, two = resident.resident(cells, *args, g, axis=axis,
                                         form="onchip")
            res[f"resident_onchip G={g}"] = compare(torch, got, two, plain[g],
                                                    tots[:g])
        if inplace:
            got, t = resident.resident(cells, *args, g, axis=axis,
                                       form="inplace")
            r = res[f"resident_onchip_inplace G={g}"] = compare(
                torch, got, t, plain[g], tots[:g])
            if onchip:
                r["tots_equal_two_buffer"] = bool(torch.equal(t, two))
    return res


def onchip_fits(rows, lanes, buffers=2):
    """Whether the on-chip resident form's strips of a rows x lanes
    lattice fit this card in ``buffers`` buffers."""
    from lbm_tpu_torch.ops import plan, resident

    return plan.onchip_fits(rows, lanes, *resident.device_limits("cuda"),
                            buffers)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def ptxas_table(log_text):
    """``{kernel<template arguments>: "N registers[, S / L B spilled]"}``
    from the build log's ``-Xptxas -v`` lines; a device function that is
    a call of its own (not inlined: the ring's ``ring_tile``) has its
    spills alone."""
    import re

    def short(mangled):
        k = re.search(r"\d+([a-z_]+_(?:kernel|tile))(?:I((?:L[ib]\d+E)+)E)?",
                      mangled)
        if k is None:
            return mangled
        args = re.findall(r"L[ib](\d+)E", k.group(2) or "")
        return k.group(1) + (f"<{','.join(args)}>" if args else "")

    regs, spills, name = {}, {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = short(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name and m.groups() != ("0", "0"):
            spills[name] = m.groups()
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs[name] = m.group(1)
    table = {}
    for k in dict.fromkeys([*regs, *spills]):
        parts = [f"{regs[k]} registers"] if k in regs else []
        if k in spills:
            parts.append("{} / {} B spilled".format(*spills[k]))
        table[k] = ", ".join(parts)
    return table


def phase_build():
    from lbm_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load()
    t0 = time.perf_counter()
    host = _build.build_host()
    _build.load_host()
    log = path.with_suffix(".log")
    emit({"phase": "build", "seconds": seconds, "library": str(path.name),
          "host_library": host.name,
          "host_seconds": time.perf_counter() - t0,
          "sources": [s.name for s in _build.sources()],
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "ptxas": ptxas_table(log.read_text()) if log.exists() else {}})


def phase_kernel(torch):
    from lbm_tpu_torch.ops import fused, resident
    from lbm_tpu_torch.runner import simulate
    from lbm_tpu_torch.state import initial_state

    worst = {}

    def record(res, where):
        for name, r in res.items():
            kernel = name.split()[0]
            worst[kernel] = max(worst.get(kernel, 0.0), r["max_abs_err"])
            check(r["cells_ok"] and r["tot_ok"], f"{name} != plain at {where}")
            check_depth(r, name, where)

    for i, (name, kind) in enumerate(KERNEL_CASES):
        p = scene_params(name, iters=200)
        with env():
            res = compare_kernels(torch, name, kind, p, seed=i,
                                  odd_g=name == "128x128")
        nx, ny = grid(name)
        emit({"phase": "kernel", "grid": name, "nx": nx, "ny": ny,
              "mask": kind, **res})
        record(res, name)
        torch.cuda.empty_cache()

    for i, (mode, mode_env) in enumerate(MODES.items()):
        p = scene_params("256x256", iters=200)
        with env(**mode_env):
            res = compare_kernels(torch, "256x256", "walls", p, seed=10 + i)
        emit({"phase": "kernel", "grid": "256x256", "mode": mode, **res})
        record(res, f"256x256 {mode}")

    # The single-buffer mode at its own shapes (two buffers do not fit),
    # column mode kept apart for the kernels line.
    for i, (name, axis) in enumerate(INPLACE_KERNEL_CASES):
        with env():
            res = inplace_against_plain(torch, name, axis, seed=60 + i)
        emit({"phase": "kernel", "grid": name, "single_buffer": True,
              "layout": "transposed" if axis else "physical", **res})
        key = "resident_onchip_inplace" + ("_cols" if axis else "")
        for label, r in res.items():
            worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
            check(r["max_abs_err"] == 0.0 and r["tot_ok"],
                  f"single-buffer {label} != plain at {name}")
        torch.cuda.empty_cache()

    # TRAJ_STEPS steps of each plan through the runner, twice, against
    # the one-step kernel and the plain version; auto's launches.
    n = TRAJ_STEPS
    p = scene_params(iters=n)
    nx, ny = grid(SCENE)
    mask = torch.from_numpy(scene_mask()).cuda()
    c0 = initial_state(p, "cuda")
    with env():
        cr, ar = simulate(p, c0, mask, kernel="reference", n_iters=n)
    runs = {}
    plans = {"auto": {}, "step": SCENE_PLANS["step"],
             "resident": SCENE_PLANS["resident"],
             **{f"depth D={d}": {"LBM_RESIDENT": "0",
                                 "LBM_PALLAS_DEPTH": str(d)} for d in DEPTHS}}
    for label, plan_env in plans.items():
        with env(**plan_env):
            want = expected_launches(resident.segments(ny, nx, n, "cuda"))
            fused.reset_launches()
            ck, ak = simulate(p, c0, mask, kernel="cuda", n_iters=n)
            got = dict(fused.LAUNCHES)
            ck2, ak2 = simulate(p, c0, mask, kernel="cuda", n_iters=n)
        check(got == want, f"{n} steps {label}: launches {got}, plan {want}")
        if label == "auto":
            auto_launches = got
        runs[label] = (ck, ak, bool(torch.equal(ck, ck2)
                                    and torch.equal(ak, ak2)))
    k1c, k1a, _ = runs["step"]
    for label, (ck, ak, same) in runs.items():
        out = {"phase": "kernel", "case": f"{n} steps {SCENE} {label}",
               "av_vels_max_rel_err_vs_step": float(
                   ((ak - k1a).abs() / k1a.abs()).max()),
               "av_vels_max_rel_err_vs_plain": float(
                   ((ak - ar).abs() / ar.abs()).max()),
               "cells_max_abs_err_vs_plain": float((ck - cr).abs().max()),
               "cells_bit_identical_to_step": bool(torch.equal(ck, k1c)),
               "bit_identical_repeat": same}
        emit(out)
        check(out["av_vels_max_rel_err_vs_step"] <= TRAJ_RTOL,
              f"{n}-step av_vels of {label} disagree with the step kernel")
        check(out["av_vels_max_rel_err_vs_plain"] <= TRAJ_RTOL,
              f"{n}-step av_vels of {label} disagree with the plain version")
        check(same, f"two runs of {label} differ")
    # Every depth and resident plan's cells are the plain version's bits
    # (max abs error 0 a call), so each other's; auto (the flow form, then
    # a one-round tail), D = 2 and the device form sum a step as D = 4.
    ca, aa, _ = runs["auto"]
    same_cells = {label: bool(torch.equal(runs[label][0], ca))
                  for label in runs if label != "step"}
    same_tots = {label: bool(torch.equal(runs[label][1], aa))
                 for label in ("depth D=2", "depth D=4", "resident")}
    emit({"phase": "kernel", "case": f"{n} steps {SCENE}, auto against the "
          "depth and resident plans", "auto_launches":
          {k: v for k, v in auto_launches.items() if v},
          "cells_bit_identical_to_auto": same_cells,
          "av_vels_bit_identical_to_auto": same_tots})
    check(auto_launches["depth_flow"] > 0 and auto_launches["depth"] > 0,
          f"{n} steps under auto: launches {auto_launches}")
    check(all(same_cells.values()) and all(same_tots.values()),
          f"{n} steps: plans differ from auto's bits: {same_cells} "
          f"{same_tots}")
    return worst, auto_launches


def inplace_against_plain(torch, name, axis, seed):
    """The single-buffer mode for one call at each G of INPLACE_GS from a
    perturbed state against as many plain steps (``axis`` 1: on the
    transposed lattice, column mode)."""
    from lbm_tpu_torch.ops import resident
    from lbm_tpu_torch.ops import reference as ref_ops

    p = scene_params(name)
    cells, mask = random_case(torch, name, p, seed, "walls", "perturbed")
    if axis:
        cells, mask = transposed(cells, mask)
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    plain, tots, c = {}, [], cells
    for n in range(1, max(INPLACE_GS) + 1):
        c, tot = ref_ops.fused_step(c, *args, axis=axis)
        tots.append(tot)
        if n in INPLACE_GS:
            plain[n] = c
    tots = torch.stack(tots)
    res = {}
    for g in INPLACE_GS:
        got, t = resident.resident(cells, *args, g, axis=axis, form="inplace")
        res[f"resident_onchip_inplace G={g}"] = compare(torch, got, t,
                                                        plain[g], tots[:g])
    return res


def phase_wide_kernel(torch):
    """Every kernel's column mode against its plain version on the
    transposed lattice: max abs error 0 (``-fmad=false``)."""
    worst = {}

    def record(res, where):
        for name, r in res.items():
            kernel = name.split()[0]
            worst[kernel] = max(worst.get(kernel, 0.0), r["max_abs_err"])
            check(r["max_abs_err"] == 0.0 and r["tot_ok"],
                  f"column mode {name} != plain at {where}")
            check_depth(r, name, where)

    for i, (name, kind) in enumerate(WIDE_KERNEL_CASES):
        p = scene_params(name, iters=200)
        with env():
            res = compare_kernels(torch, name, kind, p, seed=40 + i, axis=1)
        emit({"phase": "wide_kernel", "grid": name, "layout": "transposed",
              "mask": kind, **res})
        record(res, name)
        torch.cuda.empty_cache()

    for i, (mode, mode_env) in enumerate(MODES.items()):
        p = scene_params(WIDE_MODES_GRID, iters=200)
        with env(**mode_env):
            res = compare_kernels(torch, WIDE_MODES_GRID, "walls", p,
                                  seed=50 + i, axis=1)
        emit({"phase": "wide_kernel", "grid": WIDE_MODES_GRID,
              "layout": "transposed", "mode": mode, **res})
        record(res, f"{WIDE_MODES_GRID} {mode}")
    return worst


def expected_launches(parts, cols=False):
    """Launch counts a planned run must show, per kernel (``cols``: in
    column mode, the transposed lattice of a wide grid). The one-step
    kernel's tot_u is summed by a launch of its own; the depth kernel sums
    in its epilogue, so a depth segment adds nothing to ``reduce``."""
    from lbm_tpu_torch.ops import fused

    n = dict.fromkeys(fused.LAUNCHES, 0)
    suffix = "_cols" if cols else ""
    for seg in parts:
        n[seg.launch_key + suffix] += seg.launches
        if seg.kernel == "step":
            n["reduce"] += seg.launches
    return n


def scene_files():
    """The scene's params and obstacle files under SCENE_DIR, written on
    first use: ``(params, obstacles)`` paths."""
    from lbm_tpu_torch.obstacles import write_obstacles

    nx, ny = grid(SCENE)
    params = SCENE_DIR / "input_1024x1024.params"
    obs = SCENE_DIR / "obstacles.dat"
    if not (params.exists() and obs.exists()):
        SCENE_DIR.mkdir(parents=True, exist_ok=True)
        params.write_text(f"{nx}\n{ny}\n{ITERS}\n10\n0.1\n0.01\n1.85\n")
        write_obstacles(obs, scene_mask())
    return params, obs


def phase_scene(torch, np):
    from lbm_tpu_torch import cli
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.ops import fused, plan, resident

    golden = np.load(GOLDEN)
    nx, ny = grid(SCENE)
    mask = scene_mask()
    check(np.array_equal(mask, golden["u"].reshape(ny, nx) == 0),
          "scene mask differs from the golden's zero-velocity cells")
    params, obs = scene_files()
    av_file, fs_file = SCENE_DIR / "av_vels.dat", SCENE_DIR / "final_state.dat"

    per_plan = {}
    for label, plan_env in SCENE_PLANS.items():
        with env(**plan_env):
            parts = resident.segments(ny, nx, ITERS, "cuda")
            want = expected_launches(parts)
            fused.reset_launches()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main([str(params), str(obs), "--kernel", "auto",
                               "--device", "cuda", "--av-vels-file",
                               str(av_file), "--final-state-file",
                               str(fs_file)])
            launches = dict(fused.LAUNCHES)
        lines = out.getvalue().splitlines()
        print("\n".join(lines), flush=True)
        check(rc == 0, f"CLI exit {rc} ({label})")
        check(launches == want,
              f"{label}: launches {launches} differ from the plan's {want}")
        for seg in parts:
            check(launches[seg.launch_key] > 0,
                  f"{label}: {seg.launch_key} idle")
        per_plan[label] = launches
        check(lines[0] == "==done==", "stdout contract")
        if label == "auto":
            # The single-shot run the resume phase holds its runs to.
            shutil.copy(av_file, SCENE_DIR / "auto_av_vels.dat")
            shutil.copy(fs_file, SCENE_DIR / "auto_final_state.dat")
        elif label == "resident":
            # The device-memory form's tots are the depth plan's bits.
            check(av_file.read_bytes()
                  == (SCENE_DIR / "auto_av_vels.dat").read_bytes()
                  and fs_file.read_bytes()
                  == (SCENE_DIR / "auto_final_state.dat").read_bytes(),
                  "the resident plan's output files differ from auto's")
        reynolds = float(lines[1].split()[-1])
        compute = float(lines[3].split()[-2])

        av = lio.load_av_vels(av_file)
        fs = lio.load_final_state(fs_file)
        d_av = lio._diff(golden["av_vels"], av, DRIFT_BUDGET_PCT)
        d_p = lio._diff(golden["pressure"], fs[:, 2], DRIFT_BUDGET_PCT)
        re_rel = abs(reynolds - float(golden["reynolds"])) / float(golden["reynolds"])
        emit({"phase": "scene", "plan": label, "env": plan_env,
              "segments": plan.describe(parts), "launches": launches,
              "reynolds": reynolds, "reynolds_rel_err": re_rel,
              "av_vels_max_pct": d_av.max_diff_pcnt,
              "pressure_max_pct": d_p.max_diff_pcnt,
              "drift_budget_pct": DRIFT_BUDGET_PCT,
              "compute_s": compute, "glups": nx * ny * ITERS / compute / 1e9,
              "timings_s": {ln.split()[1].lower(): float(ln.split()[-2])
                            for ln in lines[2:6]}})
        check(not d_av.failed and not d_p.failed,
              f"{label}: outside the drift budget")
        check(re_rel <= 1e-3, f"{label}: Reynolds number off")
    return per_plan


def drift(np, ref_av, ref_pressure, av, pressure):
    """check.py's max %-diff of av_vels and of final pressure against a
    reference run, the 0.3 % budget and the margin left under it."""
    from lbm_tpu_torch import io as lio

    d_av = lio._diff(ref_av, np.asarray(av), DRIFT_BUDGET_PCT)
    d_p = lio._diff(ref_pressure, np.asarray(pressure), DRIFT_BUDGET_PCT)
    worst = max(abs(d_av.max_diff_pcnt), abs(d_p.max_diff_pcnt))
    return ({"av_vels_max_pct": d_av.max_diff_pcnt,
             "pressure_max_pct": d_p.max_diff_pcnt,
             "drift_budget_pct": DRIFT_BUDGET_PCT,
             "margin_pct": DRIFT_BUDGET_PCT - worst},
            not (d_av.failed or d_p.failed))


def phase_wide_gate(torch, np):
    """Wide grids against the port's plain float64 run on the card (the
    reference order), WIDE_GATE_ITERS steps from rest with the
    generator's walls and the scene's forcing: 131072x128 through the CLI
    under auto (transposed), the one-step and resident plans and the
    physical layout through the runner; 1024x256 through the CLI (the
    layout rule keeps it physical). Returns the launch counts of each
    run."""
    from lbm_tpu_torch import cli
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles
    from lbm_tpu_torch.ops import fused, plan
    from lbm_tpu_torch.state import initial_state

    iters = WIDE_GATE_ITERS
    runs = {}
    for name in (WIDE, WIDE_RESIDENT):
        nx, ny = grid(name)
        p = scene_params(name, iters)
        mask = generate_obstacles(nx, ny)
        t0 = time.perf_counter()
        with env():
            ref = runner.run_simulation(scene_params(name, iters, np.float64),
                                        mask, kernel="reference")
        ref_s = time.perf_counter() - t0
        ref_p = lio.final_state_fields(p, ref.cells, mask)[3].ravel()

        out_dir = SCENE_DIR.parent / f"wide_{name}"
        out_dir.mkdir(parents=True, exist_ok=True)
        params_f, obs_f = out_dir / "scene.params", out_dir / "obstacles.dat"
        av_f, fs_f = out_dir / "av_vels.dat", out_dir / "final_state.dat"
        params_f.write_text(f"{nx}\n{ny}\n{iters}\n10\n0.1\n0.01\n1.85\n")
        write_obstacles(obs_f, mask)
        with env():
            cols = runner.plan_layout(p, "cuda")
            parts = runner.plan_run(p, "cuda", iters, device="cuda")
            want = expected_launches(parts, cols=cols)
            fused.reset_launches()
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main([str(params_f), str(obs_f), "--av-vels-file",
                               str(av_f), "--final-state-file", str(fs_f)])
            launches = dict(fused.LAUNCHES)
        lines, plan_line = out.getvalue().splitlines(), err.getvalue().strip()
        check(rc == 0, f"wide CLI exit {rc} ({name}): {plan_line}")
        check(cols == (name == WIDE), f"{name}: layout transposed={cols}")
        check(plan_line == "kernel: cuda on cuda (float32)"
              + (", transposed: " if cols else ": ") + plan.describe(parts),
              f"{name} plan line: {plan_line}")
        check(launches == want,
              f"{name} auto: launches {launches} differ from the plan's {want}")
        compute = float(lines[3].split()[-2])
        d, ok = drift(np, ref.av_vels, ref_p, lio.load_av_vels(av_f),
                      lio.load_final_state(fs_f)[:, 2])
        emit({"phase": "wide_gate", "grid": name, "run": "CLI, auto",
              "plan_line": plan_line, "steps": iters, "launches": launches,
              **d, "compute_s": compute,
              "glups": nx * ny * iters / compute / 1e9,
              "reference": "plain float64 on the card", "reference_s": ref_s})
        check(ok, f"{name} auto: outside the drift budget")
        runs[(name, "auto")] = launches
        if name != WIDE:
            continue

        # The one-step and resident plans and the physical layout, through
        # the runner.
        mask_d = torch.from_numpy(mask).cuda()
        for label, plan_env, layout in (
                ("step", {"LBM_PALLAS_DEPTH": "1"}, None),
                ("resident", {"LBM_RESIDENT": "1"}, None),
                ("physical", {}, False)):
            with env(**plan_env):
                parts = runner.plan_run(p, "cuda", iters, layout, "cuda")
                want = expected_launches(parts, cols=layout is None)
                fused.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cells, av = runner.simulate(p, initial_state(p, "cuda"),
                                            mask_d, kernel="cuda",
                                            transposed=layout)
                seconds = time.perf_counter() - t0
                launches = dict(fused.LAUNCHES)
            check(launches == want, f"{name} {label}: launches {launches} "
                  f"differ from the plan's {want}")
            pressure = lio.final_state_fields(p, cells.cpu().numpy(), mask)[3]
            d, ok = drift(np, ref.av_vels, ref_p, av.cpu().numpy(),
                          pressure.ravel())
            emit({"phase": "wide_gate", "grid": name,
                  "run": f"runner, {label}", "env": plan_env,
                  "layout": "physical" if layout is False else "transposed",
                  "segments": plan.describe(parts), "launches": launches,
                  **d, "seconds": seconds})
            check(ok, f"{name} {label}: outside the drift budget")
            runs[(name, label)] = launches
            del cells, av
        del ref, ref_p
        torch.cuda.empty_cache()
    return runs


def phase_stress(torch):
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import plan_layout, plan_run, simulate
    from lbm_tpu_torch.state import initial_state

    p = scene_params(STRESS, iters=STRESS_ITERS)
    nx, ny = grid(STRESS)
    mask = torch.from_numpy(generate_obstacles(nx, ny)).cuda()
    c0 = initial_state(p, "cuda")
    plans = {"step": SCENE_PLANS["step"], "resident": SCENE_PLANS["resident"],
             **{f"depth D={d}": {"LBM_RESIDENT": "0",
                                 "LBM_PALLAS_DEPTH": str(d)} for d in DEPTHS}}
    base = None
    for label, plan_env in plans.items():
        with env(**plan_env):
            parts = plan_run(p, "cuda", STRESS_ITERS, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cells, av = simulate(p, c0, mask, kernel="cuda")
            seconds = time.perf_counter() - t0
        check(bool(torch.isfinite(cells).all()), f"stress {label} not finite")
        out = {"phase": "stress", "grid": STRESS, "plan": label,
               "layout": "transposed" if plan_layout(p, "cuda")
               else "physical",
               "segments": plan.describe(parts), "seconds": seconds,
               "glups": nx * ny * STRESS_ITERS / seconds / 1e9}
        if base is None:
            base = (cells, av)
        else:
            err = (cells - base[0]).abs()
            out.update(
                av_vels_max_rel_err=float(((av - base[1]).abs()
                                           / base[1].abs()).max()),
                cells_max_abs_err=float(err.max()),
                cells_ok=bool((err <= ATOL + RTOL * base[0].abs()).all()),
                cells_bit_identical_to_step=bool(torch.equal(cells, base[0])))
            check(out["av_vels_max_rel_err"] <= TRAJ_RTOL and out["cells_ok"],
                  f"stress {label} disagrees with the step kernel")
        emit(out)
        del cells, av
    del base
    torch.cuda.empty_cache()


# ~50 ms of device sleep (at H100 clocks) ahead of a batch: the host
# queues the whole batch while the device waits, so the events then time
# device work alone, without host launch overhead.
SLEEP_CYCLES = 100_000_000


def _median_ms(torch, fn, spc, device_only, steps=200, batches=10):
    """Median over batches of (CUDA-event time of one batch)/steps, with
    min and max, where ``fn`` runs ``spc`` steps and a batch is
    ``max(1, steps // spc)`` calls, after one warm-up batch.
    ``device_only``: pre-fill the queue first."""
    calls = max(1, steps // spc)
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (calls * spc))
    return statistics.median(times), min(times), max(times)


def time_turns(torch, calls, steps=200):
    """Loop and device ms per step of each ``label: (fn, steps_per_call,
    shard_set_or_None)``, measured in turns (every configuration forward,
    then in reverse): ``(loop, device)``, each label to its two medians."""
    order = list(calls) + list(reversed(calls))
    loop, dev = {}, {}
    for table, device_only in ((loop, False), (dev, True)):
        for label in order:
            fn, spc, ss = calls[label]
            if ss is None:
                ms = _median_ms(torch, fn, spc, device_only, steps)
            else:
                ms = _median_ms_shards(torch, ss, fn, spc, device_only, steps)
            table.setdefault(label, []).append(ms[0])
    return loop, dev


def runner_call(impl, bufs, av):
    """One call of a lattice kernel as the runner drives it: the result
    becomes the input."""
    def fn():
        bufs[:] = impl.run(bufs[0], bufs[1], av, 0, 1.0)
    return fn


def phase_timing(torch):
    from lbm_tpu_torch.ops import fused, fused_depth, resident
    from lbm_tpu_torch.ops import reference as ref_ops

    results = []
    for name in TIMING_GRIDS:
        p = scene_params(name)
        cells, mask = random_case(
            torch, name, p, seed=99, state="perturbed",
            mask_kind="scene" if name == SCENE else "walls")
        w = (mask, p.accel_w1, p.accel_w2, p.omega)
        bufs = [cells, torch.empty_like(cells)]
        av = torch.zeros(100, device="cuda")  # room for G=100
        with env():
            impls = {"step": fused.FusedStep(*w),
                     **{f"depth D={d}": fused_depth.FusedDepth(*w, d)
                        for d in DEPTHS},
                     # The flow form beside one round a launch, at every
                     # grid (the planner takes it under FLOW_MAX_WAVES).
                     FLOW_LABEL: fused_depth.FusedDepth(
                         *w, fused_depth.FLOW_DEPTH, 0, FLOW_ROUNDS),
                     **{f"resident G={g}": resident.Resident(
                         *w, g, form="device") for g in (16, 100)}}
            if onchip_fits(*mask.shape):
                impls["resident G=100 on-chip"] = resident.Resident(
                    *w, 100, form="onchip")

        loop, dev = time_turns(torch, {
            label: (runner_call(impl, bufs, av), impl.steps_per_call, None)
            for label, impl in impls.items()})
        out = {"phase": "timing", "grid": name,
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "method": "CUDA events; median over 10 batches of ~200 steps "
                         "after one warm-up batch, configurations in turns "
                         "(forward, then reverse); device: queue pre-filled "
                         "behind a device sleep"}
        if name in (SCENE, ONCHIP_SCENE):
            def plain_step():
                new, tot = ref_ops.fused_step(bufs[0], *w)
                av[0] = tot

            out["plain_loop_ms_per_step"] = [
                _median_ms(torch, plain_step, 1, False, steps=20)[0]]
            out["plain_device_ms_per_step"] = [
                _median_ms(torch, plain_step, 1, True, steps=20)[0]]
        if name == SCENE:
            st = impls["step"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                st.run(bufs[0], bufs[1], av, 0, 1.0)
            out["host_enqueue_us_per_step"] = (time.perf_counter() - t0) / 200 * 1e6

            # The fixed-order sum as the one-step kernel launches it,
            # against torch.sum of the same partials.
            def reduce_only():
                st._reduce(st._partials, av, 0, 1.0)

            def reduce_plain():
                av[0] = st._partials.sum()

            out["reduce_device_ms"] = _median_ms(torch, reduce_only, 1, True)[0]
            out["reduce_plain_device_ms"] = _median_ms(
                torch, reduce_plain, 1, True)[0]
            torch.cuda.synchronize()
            st._reduce(st._partials, av, 0, 1.0)
            out["reduce_abs_err"] = abs(float(av[0]) - float(st._partials.sum()))
            # The same sum as the depth kernel's epilogue, in place: what
            # a D=4 launch leaves in av against torch.sum of its partials.
            d4 = impls["depth D=4"]
            d4.run(bufs[0], bufs[1], av, 0, 1.0)
            torch.cuda.synchronize()
            want = d4._partials.sum(1)
            out["epilogue_abs_err"] = float((av[:4] - want).abs().max())
            out["epilogue_rel_err"] = float(
                ((av[:4] - want).abs() / want.abs()).max())
            check(out["reduce_abs_err"] <= 1e-6 * float(av[0])
                  and out["epilogue_rel_err"] <= 1e-6,
                  f"a tot_u sum is off: {out}")
        emit(out)
        results.append(out)
        del cells, bufs, impls
        torch.cuda.empty_cache()
    return {r["grid"]: r for r in results}


def phase_wide_timing(torch):
    """Per-step time of each kernel configuration on the wide grids in
    both layouts (row mode on the physical lattice, column mode on the
    transposed one), in turns within one call; the plain version on the
    transposed lattice."""
    from lbm_tpu_torch.ops import fused, fused_depth, resident
    from lbm_tpu_torch.ops import reference as ref_ops

    results = {}
    for name in WIDE_TIMING_GRIDS:
        p = scene_params(name)
        cells, mask = random_case(torch, name, p, seed=97, state="perturbed")
        av = torch.zeros(100, device="cuda")  # room for G=100
        calls = {}
        for layout, axis in (("physical", 0), ("transposed", 1)):
            c, m = transposed(cells, mask) if axis else (cells, mask)
            w = (m, p.accel_w1, p.accel_w2, p.omega)
            bufs = [c.clone(), torch.empty_like(c)]
            with env():
                if name in (WIDE_RESIDENT, WIDE_LIMIT):
                    impls = {"depth D=4": fused_depth.FusedDepth(*w, 4, axis)}
                else:
                    impls = {"step": fused.FusedStep(*w, axis),
                             **{f"depth D={d}": fused_depth.FusedDepth(
                                 *w, d, axis) for d in DEPTHS}}
                impls["resident G=100"] = resident.Resident(
                    *w, 100, axis, form="device")
                if onchip_fits(*m.shape):
                    impls["resident G=100 on-chip"] = resident.Resident(
                        *w, 100, axis, form="onchip")
            for label, impl in impls.items():
                calls[f"{layout} {label}"] = (runner_call(impl, bufs, av),
                                              impl.steps_per_call, None)
        loop, dev = time_turns(
            torch, calls,
            steps=200 if name in (WIDE_RESIDENT, WIDE_LIMIT) else 100)
        ct, mt = transposed(cells, mask)

        def plain_step():
            new, tot = ref_ops.fused_step(ct, mt, p.accel_w1, p.accel_w2,
                                          p.omega, axis=1)
            av[0] = tot

        med = {k: statistics.median(v) for k, v in dev.items()}
        out = {"phase": "wide_timing", "grid": name,
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "transposed_over_physical_device": {
                   k.split(" ", 1)[1]: med[k] / med["physical " + k.split(" ", 1)[1]]
                   for k in med if k.startswith("transposed ")
                   and "physical " + k.split(" ", 1)[1] in med},
               "plain_transposed_device_ms_per_step": _median_ms(
                   torch, plain_step, 1, True, steps=4, batches=3)[0],
               "method": "CUDA events; median over 10 batches of 100-200 "
                         "steps after one warm-up batch, both layouts' "
                         "configurations in turns (forward, then reverse); "
                         "device: queue pre-filled behind a device sleep"}
        emit(out)
        results[name] = out
        del cells, mask, calls, ct, mt
        torch.cuda.empty_cache()
    return results


def walls_scene_files(name, iters, accel):
    """The scene of grid ``name`` with the generator's walls, density 0.1
    and omega 1.85, for ``iters`` steps at ``accel``: ``(params,
    obstacles)`` paths, written on first use."""
    from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles

    nx, ny = grid(name)
    d = SCENE_DIR.parent / f"scene_{name}"
    params, obs = d / f"input_{name}_{iters}.params", d / "obstacles.dat"
    d.mkdir(parents=True, exist_ok=True)
    if not params.exists():
        params.write_text(f"{nx}\n{ny}\n{iters}\n10\n0.1\n{accel}\n1.85\n")
    if not obs.exists():
        write_obstacles(obs, generate_obstacles(nx, ny))
    return params, obs


def phase_onchip_scene(torch, np):
    """The reference coursework's 256x256 scene, all 80000 steps, through
    the port's CLI under auto (the on-chip resident form) and with the
    device-memory form pinned, in turns (auto, device, device, auto):
    plan line, launch counts, drift against its float64 golden within
    the 0.3 % budget, Compute seconds and GLUPS. The two forms' final
    states are the same bytes (both give the plain version's cells).
    Returns each run's launch counts."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import plan, resident

    golden = np.load(ONCHIP_GOLDEN)
    nx, ny = grid(ONCHIP_SCENE)
    check(np.array_equal(generate_obstacles(nx, ny),
                         golden["u"].reshape(ny, nx) == 0),
          "256x256 mask differs from the golden's zero-velocity cells")
    params, obs = walls_scene_files(ONCHIP_SCENE, ONCHIP_ITERS, ONCHIP_ACCEL)
    runs, finals = {}, {}
    for i, label in enumerate(("auto", "device", "device", "auto")):
        plan_env = ONCHIP_SCENE_PLANS[label]
        with env(**plan_env):
            form = resident.planned_form(ny, nx, "cuda")
            parts = resident.segments(ny, nx, ONCHIP_ITERS, "cuda")
        want = expected_launches(parts)
        lines, plan_line, launches, av_f, fs_f = _cli_run(
            params, obs, params.parent, label, plan_env)
        check(form == ("onchip" if label == "auto" else "device"),
              f"256x256 {label}: form {form}")
        check(plan_line == "kernel: cuda on cuda (float32): "
              + plan.describe(parts), f"256x256 plan line: {plan_line}")
        check(launches == want, f"256x256 {label}: launches {launches} "
              f"differ from the plan's {want}")
        check(lines[0] == "==done==", "stdout contract")
        reynolds = float(lines[1].split()[-1])
        compute = float(lines[3].split()[-2])
        fs = lio.load_final_state(fs_f)
        d, ok = drift(np, golden["av_vels"], golden["pressure"],
                      lio.load_av_vels(av_f), fs[:, 2])
        re_rel = abs(reynolds - float(golden["reynolds"])) \
            / float(golden["reynolds"])
        emit({"phase": "onchip_scene", "grid": ONCHIP_SCENE, "turn": i,
              "plan": label, "env": plan_env, "plan_line": plan_line,
              "steps": ONCHIP_ITERS, "launches": {
                  k: v for k, v in launches.items() if v},
              **d, "reynolds": reynolds, "reynolds_rel_err": re_rel,
              "compute_s": compute,
              "glups": nx * ny * ONCHIP_ITERS / compute / 1e9,
              "reference": str(ONCHIP_GOLDEN.relative_to(REPO))})
        check(ok, f"256x256 {label}: outside the drift budget")
        # The Reynolds number is the last av_vels times a constant: held
        # to the same budget.
        check(re_rel <= DRIFT_BUDGET_PCT / 100,
              f"256x256 {label}: Reynolds number off")
        finals.setdefault(label, fs_f.read_bytes())
        runs.setdefault(label, launches)
    check(finals["auto"] == finals["device"],
          "the two resident forms' final states differ")
    return runs


def phase_onchip_timing(torch):
    """Device ms per step of the on-chip resident form at several block
    counts (the small-grid floor) and of both forms beside D=4 at the
    crossover grids, with the single-buffer mode wherever its strips fit,
    in turns, at G = 100; then the lattices of AUTO_GRIDS as auto runs
    them."""
    from lbm_tpu_torch.ops import fused_depth, plan, resident

    sms, smem = resident.device_limits("cuda")
    results = {}
    for name in ONCHIP_BLOCK_GRIDS + CROSSOVER_GRIDS + STRIP_GRIDS:
        nx, ny = grid(name)
        p = scene_params(name)
        cells, mask = random_case(torch, name, p, seed=93, state="perturbed")
        w = (mask, p.accel_w1, p.accel_w2, p.omega)
        bufs = [cells, torch.empty_like(cells)]
        av = torch.zeros(100, device="cuda")
        with env():
            impls = {}
            if onchip_fits(ny, nx):
                counts = ONCHIP_BLOCKS + (sms,) \
                    if name in ONCHIP_BLOCK_GRIDS else (sms,)
                for b in sorted({min(c, ny) for c in counts}):
                    if plan.onchip_smem_bytes(ny, nx, b) <= smem:
                        impls[f"on-chip B={b}"] = resident.Resident(
                            *w, 100, form="onchip", blocks=b)
            if onchip_fits(ny, nx, buffers=1):
                impls["on-chip 1-buf"] = resident.Resident(*w, 100,
                                                           form="inplace")
            impls["device"] = resident.Resident(*w, 100, form="device")
            impls["device shift"] = resident.Resident(*w, 100, form="shift")
            impls["depth D=4"] = fused_depth.FusedDepth(*w, 4)
            planned = resident.planned_form(ny, nx, "cuda")
        calls = {label: (runner_call(impl, bufs, av), impl.steps_per_call,
                         None) for label, impl in impls.items()}
        loop, dev = time_turns(torch, calls)
        med = {k: statistics.median(v) for k, v in dev.items()}
        onchip = {k: v for k, v in med.items() if k.startswith("on-chip B")}
        best = min(onchip, key=onchip.get) if onchip else None
        out = {"phase": "onchip_timing", "grid": name, "cells": nx * ny,
               "form": plan.resident_form(ny, nx, sms, smem),
               "planned": planned,
               "shift_over_device": med["device shift"] / med["device"],
               "planned_blocks": plan.onchip_blocks(ny, nx, sms),
               "strip_rows": -(-ny // plan.onchip_blocks(ny, nx, sms)),
               "fastest_blocks": best,
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "resident_over_depth4": {
                   k: v / med["depth D=4"] for k, v in med.items()
                   if k != "depth D=4"},
               "state_finite_after_timing": bool(
                   torch.isfinite(bufs[0]).all()),
               "method": "CUDA events; median over 10 batches of 200 steps "
                         "after one warm-up batch, configurations in turns "
                         "(forward, then reverse); device: queue pre-filled "
                         "behind a device sleep"}
        check(out["state_finite_after_timing"], f"{name}: state not finite")
        emit(out)
        results[name] = out
        del cells, bufs, impls, calls
        torch.cuda.empty_cache()
    for name in AUTO_GRIDS:
        results[name] = auto_timing(torch, name)
    return results


def auto_timing(torch, name):
    """A lattice whose two-buffer strips do not fit on chip, as auto runs
    it: its plan (the form resident.planned_form gives, asserted: the size
    rule's, or the shift mode where plan.shift_auto takes it), 200 steps
    through the runner with the plan's launches (counted from zero just
    before) and the plain version's cells, then the single-buffer mode
    (where its strips fit), the device-memory form, its shift mode (row
    layout) and D=4 timed in the run's layout, in turns, and the plain
    version's step."""
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.ops import fused, fused_depth, plan, resident
    from lbm_tpu_torch.ops import reference as ref_ops
    from lbm_tpu_torch.state import initial_state

    p = scene_params(name)
    cells, mask = random_case(torch, name, p, seed=92, state="perturbed")
    n = 2 * plan.G_PREF[0]
    with env():
        parts = runner.plan_run(p, "cuda", n, device="cuda")
        axis = int(runner.plan_layout(p, "cuda"))
        rows, lanes = (p.nx, p.ny) if axis else (p.ny, p.nx)
        form = resident.planned_form(rows, lanes, "cuda", axis)
        check(form != "onchip" and plan.describe(parts) == plan.describe(
            [plan.Segment("resident", 100, n, form)]),
            f"{name} under auto plans {plan.describe(parts)}")
        fused.reset_launches()
        c, _ = runner.simulate(p, initial_state(p, "cuda"), mask,
                               kernel="cuda", n_iters=n)
        launches = dict(fused.LAUNCHES)
        # The plain version in the run's layout (column mode on the
        # transposed lattice rounds as the kernels there do).
        c0, m0 = initial_state(p, "cuda"), mask
        if axis:
            c0, m0 = transposed(c0, mask)
        want, _ = ref_ops.multi_step(c0, m0, p.accel_w1, p.accel_w2, p.omega,
                                     n, axis)
        if axis:
            want = transposed(want, m0)[0]
        err = float((c - want).abs().max())
        check(launches == expected_launches(parts, cols=bool(axis)),
              f"{name}: launches {launches}")
        check(err == 0.0, f"{name}: cells != plain ({err})")
        if axis:
            cells, mask = transposed(cells, mask)
        w = (mask, p.accel_w1, p.accel_w2, p.omega)
        impls = {}
        if onchip_fits(rows, lanes, buffers=1):
            impls["on-chip 1-buf"] = resident.Resident(*w, 100, axis,
                                                       form="inplace")
        impls["device"] = resident.Resident(*w, 100, axis, form="device")
        if not axis:
            impls["device shift"] = resident.Resident(*w, 100, form="shift")
        impls["depth D=4"] = fused_depth.FusedDepth(*w, 4, axis)
    bufs = [cells, torch.empty_like(cells)]
    av = torch.zeros(100, device="cuda")
    loop, dev = time_turns(torch, {
        label: (runner_call(impl, bufs, av), impl.steps_per_call, None)
        for label, impl in impls.items()})
    med = {k: statistics.median(v) for k, v in dev.items()}

    def plain_step():
        new, tot = ref_ops.fused_step(bufs[0], *w, axis=axis)
        av[0] = tot

    planned = {"inplace": "on-chip 1-buf", "shift": "device shift"}.get(
        form, "device")
    out = {"phase": "onchip_timing", "grid": name, "plan":
           plan.describe(parts), "layout": "transposed" if axis else
           "physical", "execution": [rows, lanes],
           "launches": {k: v for k, v in launches.items() if v},
           "max_abs_err_vs_plain": err, "loop_ms_per_step": loop,
           "device_ms_per_step": dev, "planned": planned,
           "over_depth4": {k: v / med["depth D=4"] for k, v in med.items()},
           "over_device": {k: v / med["device"] for k, v in med.items()},
           "plain_device_ms_per_step": _median_ms(torch, plain_step, 1, True,
                                                  steps=4, batches=3)[0]}
    if "device shift" in impls:
        out["shift_residence"] = impls["device shift"].residence
    emit(out)
    return out


def _cli_run(params, obs, out_dir, label, plan_env):
    """One in-process CLI run under ``plan_env``: ``(stdout lines, plan
    line, launch counts from zero, av_vels file, final state file)``."""
    from lbm_tpu_torch import cli
    from lbm_tpu_torch.ops import fused

    av_f, fs_f = out_dir / f"av_{label}.dat", out_dir / f"fs_{label}.dat"
    with env(**plan_env):
        fused.reset_launches()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([str(params), str(obs), "--av-vels-file", str(av_f),
                           "--final-state-file", str(fs_f)])
        launches = dict(fused.LAUNCHES)
    plan_line = err.getvalue().strip()
    check(rc == 0, f"CLI exit {rc} ({label}): {plan_line}")
    return out.getvalue().splitlines(), plan_line, launches, av_f, fs_f


def phase_inplace_scene(torch, np):
    """The single-buffer mode's path: the 1024x512 scene, INPLACE_ITERS
    steps through the CLI under auto (transposed, ``resident G=100 on-chip
    1-buf x200``) and with LBM_RESIDENT=0 (D=4), in turns (auto, off,
    off, auto): plan lines and launch counts equal the plans', the final
    states the same bytes, av_vels within TRAJ_RTOL, Compute seconds; the
    two plans' cells through the runner, bit for bit; INPLACE_GATE_ITERS
    steps under auto through the CLI against the port's plain float64 run
    on the card within the 0.3 % budget; the planned kernel beside D=4 in
    turns, and the plain version's step. Returns each plan's launches and
    the timings."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import fused_depth, plan
    from lbm_tpu_torch.ops import reference as ref_ops
    from lbm_tpu_torch.state import initial_state

    nx, ny = grid(INPLACE_SCENE)
    p = scene_params(INPLACE_SCENE, INPLACE_ITERS)
    plans = {"auto": {}, "off": {"LBM_RESIDENT": "0"}}
    want_plan = {"auto": f"resident G=100 on-chip 1-buf x{INPLACE_ITERS // 100}",
                 # The 1024x512 scene's transposed tiles are 2.6 waves:
                 # the depth kernel's flow form.
                 "off": f"depth D=4 K=25 x{INPLACE_ITERS // 100}"}
    params, obs = walls_scene_files(INPLACE_SCENE, INPLACE_ITERS,
                                    INPLACE_ACCEL)
    runs, files, avs = {}, {}, {}
    for i, label in enumerate(("auto", "off", "off", "auto")):
        with env(**plans[label]):
            cols = runner.plan_layout(p, "cuda")
            parts = runner.plan_run(p, "cuda", INPLACE_ITERS, device="cuda")
        lines, plan_line, launches, av_f, fs_f = _cli_run(
            params, obs, params.parent, label, plans[label])
        check(cols and plan.describe(parts) == want_plan[label],
              f"{INPLACE_SCENE} {label} plans {plan.describe(parts)}")
        check(plan_line == "kernel: cuda on cuda (float32), transposed: "
              + plan.describe(parts), f"{INPLACE_SCENE} plan line: {plan_line}")
        check(launches == expected_launches(parts, cols=True),
              f"{INPLACE_SCENE} {label}: launches {launches}")
        compute = float(lines[3].split()[-2])
        emit({"phase": "inplace_scene", "grid": INPLACE_SCENE, "turn": i,
              "plan": label, "env": plans[label], "plan_line": plan_line,
              "steps": INPLACE_ITERS,
              "launches": {k: v for k, v in launches.items() if v},
              "compute_s": compute,
              "glups": nx * ny * INPLACE_ITERS / compute / 1e9})
        runs.setdefault(label, launches)
        files.setdefault(label, fs_f.read_bytes())
        avs.setdefault(label, lio.load_av_vels(av_f))
    av_rel = float(np.max(np.abs(avs["auto"] - avs["off"])
                          / np.abs(avs["off"])))
    same = files["auto"] == files["off"]

    # The cells themselves, through the runner.
    mask = torch.from_numpy(generate_obstacles(nx, ny)).cuda()
    cells = {}
    for label, plan_env in plans.items():
        with env(**plan_env):
            cells[label], _ = runner.simulate(p, initial_state(p, "cuda"),
                                              mask, kernel="cuda")
    cells_equal = bool(torch.equal(cells["auto"], cells["off"]))
    del cells

    # Against the plain float64 run.
    gate = scene_params(INPLACE_SCENE, INPLACE_GATE_ITERS)
    mask_np = mask.cpu().numpy()
    with env():
        ref = runner.run_simulation(
            scene_params(INPLACE_SCENE, INPLACE_GATE_ITERS, np.float64),
            mask_np, kernel="reference")
    ref_p = lio.final_state_fields(gate, ref.cells, mask_np)[3].ravel()
    g_params, _ = walls_scene_files(INPLACE_SCENE, INPLACE_GATE_ITERS,
                                    INPLACE_ACCEL)
    _, g_line, g_launches, g_av, g_fs = _cli_run(g_params, obs,
                                                 params.parent, "gate", {})
    d, ok = drift(np, ref.av_vels, ref_p, lio.load_av_vels(g_av),
                  lio.load_final_state(g_fs)[:, 2])

    # The planned kernel beside D=4 on the transposed lattice, in turns.
    c0, m0 = random_case(torch, INPLACE_SCENE, p, seed=91, state="perturbed")
    c0, m0 = transposed(c0, m0)
    w = (m0, p.accel_w1, p.accel_w2, p.omega)
    with env():
        impls = {"planned": runner._make_impl(
            plan.Segment("resident", 100, 100, "inplace"), *w, 1),
            "depth D=4": fused_depth.FusedDepth(*w, 4, 1)}
    bufs, av = [c0, torch.empty_like(c0)], torch.zeros(100, device="cuda")
    loop, dev = time_turns(torch, {
        label: (runner_call(impl, bufs, av), impl.steps_per_call, None)
        for label, impl in impls.items()})

    def plain_step():
        new, tot = ref_ops.fused_step(bufs[0], *w, axis=1)
        av[0] = tot

    plain_ms = _median_ms(torch, plain_step, 1, True, steps=4, batches=3)[0]
    med = {k: statistics.median(v) for k, v in dev.items()}
    out = {"phase": "inplace_scene", "grid": INPLACE_SCENE,
           "final_states_same_bytes": same, "cells_bit_identical": cells_equal,
           "av_vels_max_rel_err": av_rel, "gate_steps": INPLACE_GATE_ITERS,
           "gate_plan_line": g_line, **d,
           "reference": "plain float64 on the card",
           "loop_ms_per_step": loop, "device_ms_per_step": dev,
           "planned_over_depth4": med["planned"] / med["depth D=4"],
           "plain_device_ms_per_step": plain_ms}
    emit(out)
    check(same and cells_equal, f"{INPLACE_SCENE}: auto and LBM_RESIDENT=0 "
          "cells differ")
    check(av_rel <= TRAJ_RTOL, f"{INPLACE_SCENE}: av_vels differ by {av_rel}")
    check(ok, f"{INPLACE_SCENE}: outside the drift budget")
    check(g_launches["resident_onchip_inplace_cols"] > 0,
          f"{INPLACE_SCENE} gate: no single-buffer launch")
    return {"launches": runs, "device_ms": med["planned"],
            "plain_ms": plain_ms}


def _scene_turns(phase, name, params, obs, iters, plans, want_plan, labels):
    """CLI runs of the scene ``name`` (physical layout) under each plan of
    ``plans``, in the order of ``labels``: each plan line equal to
    ``want_plan``'s and to the planner's, launch counts equal to the
    plan's, Compute seconds. Returns, by plan, the first run's launches,
    final state bytes, av_vels bytes, (final state, av_vels) files and
    stdout lines (every run of a plan writes the same files)."""
    from lbm_tpu_torch.ops import plan, resident

    nx, ny = grid(name)
    runs, finals, avs, files, outs = {}, {}, {}, {}, {}
    for i, label in enumerate(labels):
        with env(**plans[label]):
            parts = resident.segments(ny, nx, iters, "cuda")
        lines, plan_line, launches, av_f, fs_f = _cli_run(
            params, obs, params.parent, f"{phase}_{label}", plans[label])
        check(plan.describe(parts) == want_plan[label],
              f"{name} {label} plans {plan.describe(parts)}")
        check(plan_line == "kernel: cuda on cuda (float32): "
              + want_plan[label], f"{name} {label} plan line: {plan_line}")
        check(launches == expected_launches(parts),
              f"{name} {label}: launches {launches} differ from the plan's")
        check(lines[0] == "==done==", "stdout contract")
        compute = float(lines[3].split()[-2])
        emit({"phase": phase, "grid": name, "turn": i, "plan": label,
              "env": plans[label], "plan_line": plan_line, "steps": iters,
              "launches": {k: v for k, v in launches.items() if v},
              "compute_s": compute,
              "glups": nx * ny * iters / compute / 1e9})
        runs.setdefault(label, launches)
        finals.setdefault(label, fs_f.read_bytes())
        avs.setdefault(label, av_f.read_bytes())
        files.setdefault(label, (fs_f, av_f))
        outs.setdefault(label, lines)
    return runs, finals, avs, files, outs


def phase_shift_scene(torch, np):
    """The device-memory form's shift mode (LBM_RESIDENT_SHIFT). The
    256x256 reference scene, all 80000 steps, through the CLI under the
    pin (``resident G=100 device-memory shift x800``) and with the device
    form's default mode pinned (LBM_RESIDENT_FORM=device), in turns: plan
    lines, launch counts, drift against goldens/256x256.final_state.f64.npz
    within the 0.3 % budget, the final states and av_vels files the same
    bytes, and through the runner the cells and av_vels the same bits. Then
    the mode's path under auto at each of SHIFT_AUTO_SCENES
    (_shift_auto_scene). Returns each run's launches (``auto``: the first
    narrow channel's, the kernels line's path)."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    # The reference scene under the pin.
    golden = np.load(ONCHIP_GOLDEN)
    nx, ny = grid(ONCHIP_SCENE)
    params, obs = walls_scene_files(ONCHIP_SCENE, ONCHIP_ITERS, ONCHIP_ACCEL)
    calls = ONCHIP_ITERS // 100
    want = {"shift": f"resident G=100 device-memory shift x{calls}",
            "device": f"resident G=100 device-memory x{calls}"}
    runs, finals, avs, files, outs = _scene_turns(
        "shift_scene", ONCHIP_SCENE, params, obs, ONCHIP_ITERS,
        SHIFT_SCENE_PLANS, want, ("shift", "device", "device", "shift"))
    out = {"phase": "shift_scene", "grid": ONCHIP_SCENE}
    for label in ("shift", "device"):
        fs_f, av_f = files[label]
        d, ok = drift(np, golden["av_vels"], golden["pressure"],
                      lio.load_av_vels(av_f),
                      lio.load_final_state(fs_f)[:, 2])
        out[label] = {**d, "reynolds": float(outs[label][1].split()[-1])}
        check(ok, f"{ONCHIP_SCENE} {label}: outside the drift budget")
    out["final_states_same_bytes"] = finals["shift"] == finals["device"]
    out["av_vels_same_bytes"] = avs["shift"] == avs["device"]
    p = Params(nx=nx, ny=ny, max_iters=ONCHIP_ITERS, reynolds_dim=10,
               density=0.1, accel=ONCHIP_ACCEL, omega=1.85)
    mask = torch.from_numpy(generate_obstacles(nx, ny)).cuda()
    bits = {}
    for label, plan_env in SHIFT_SCENE_PLANS.items():
        with env(**plan_env):
            bits[label] = runner.simulate(p, initial_state(p, "cuda"), mask,
                                          kernel="cuda")
    out["cells_bit_identical"] = bool(torch.equal(bits["shift"][0],
                                                  bits["device"][0]))
    out["av_vels_bit_identical"] = bool(torch.equal(bits["shift"][1],
                                                    bits["device"][1]))
    out["reference"] = str(ONCHIP_GOLDEN.relative_to(REPO))
    emit(out)
    for key in ("final_states_same_bytes", "av_vels_same_bytes",
                "cells_bit_identical", "av_vels_bit_identical"):
        check(out[key], f"{ONCHIP_SCENE}: the shift mode and the device "
              f"form differ ({key})")
    del bits

    # The mode's path under auto: each narrow channel.
    auto_runs = {}
    for name in SHIFT_AUTO_SCENES:
        auto_runs[name] = _shift_auto_scene(torch, np, name)
    return {"pin": runs, "auto": auto_runs[SHIFT_AUTO_SCENE],
            "auto_scenes": auto_runs}


def _shift_auto_scene(torch, np, name):
    """A narrow channel ``name`` (the wide scenes' params, the generator's
    walls) SHIFT_AUTO_ITERS steps through the CLI under auto (the shift
    mode) and LBM_RESIDENT_SHIFT=0 (the default mode), in turns: the final
    states and av_vels the same bytes, through the runner the same bits,
    and 500 steps under auto within the budget of the port's plain float64
    run on the card. Returns each plan's launches."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.state import initial_state

    iters = SHIFT_AUTO_ITERS
    nx, ny = grid(name)
    p = scene_params(name, iters)
    with env():
        check(not runner.plan_layout(p, "cuda"), f"{name} is transposed")
    params, obs = walls_scene_files(name, iters, INPLACE_ACCEL)
    want = {"auto": f"resident G=100 device-memory shift x{iters // 100}",
            "off": f"resident G=100 device-memory x{iters // 100}"}
    a_runs, a_finals, a_avs, _, _ = _scene_turns(
        "shift_scene", name, params, obs, iters, SHIFT_AUTO_PLANS,
        want, ("auto", "off", "off", "auto"))
    mask = torch.from_numpy(generate_obstacles(nx, ny)).cuda()
    bits = {}
    for label, plan_env in SHIFT_AUTO_PLANS.items():
        with env(**plan_env):
            bits[label] = runner.simulate(p, initial_state(p, "cuda"), mask,
                                          kernel="cuda")
    mask_np = mask.cpu().numpy()
    gate = scene_params(name, SHIFT_GATE_ITERS)
    with env():
        ref = runner.run_simulation(
            scene_params(name, SHIFT_GATE_ITERS, np.float64), mask_np,
            kernel="reference")
    ref_p = lio.final_state_fields(gate, ref.cells, mask_np)[3].ravel()
    g_params, _ = walls_scene_files(name, SHIFT_GATE_ITERS, INPLACE_ACCEL)
    _, g_line, g_launches, g_av, g_fs = _cli_run(g_params, obs,
                                                 params.parent, "gate", {})
    d, ok = drift(np, ref.av_vels, ref_p, lio.load_av_vels(g_av),
                  lio.load_final_state(g_fs)[:, 2])
    a_out = {"phase": "shift_scene", "grid": name,
             "final_states_same_bytes": a_finals["auto"] == a_finals["off"],
             "av_vels_same_bytes": a_avs["auto"] == a_avs["off"],
             "cells_bit_identical": bool(torch.equal(bits["auto"][0],
                                                     bits["off"][0])),
             "av_vels_bit_identical": bool(torch.equal(bits["auto"][1],
                                                       bits["off"][1])),
             "gate_steps": SHIFT_GATE_ITERS, "gate_plan_line": g_line, **d,
             "reference": "plain float64 on the card"}
    emit(a_out)
    for key in ("final_states_same_bytes", "av_vels_same_bytes",
                "cells_bit_identical", "av_vels_bit_identical"):
        check(a_out[key], f"{name}: auto (the shift mode) and "
              f"LBM_RESIDENT_SHIFT=0 differ ({key})")
    check(ok, f"{name}: outside the drift budget")
    check(g_launches["resident_shift"] > 0, f"{name} gate: no shift launch")
    return a_runs


# The sharded path: P shards on one card (a mesh that repeats the device),
# or across cards where the machine has more than one.
SHARD_G = 16
# The ring also at a G that forces D = 2 (18 is no multiple of 4).
SHARD_G_D2 = 18
# (grid, mask, shards, axis): the row plan (axis 0, the kernels in row
# mode), then the x-plan of wide grids (axis 1, column mode).
SHARD_CASES = [("1024x1024", "scene", 4, 0), ("16384x1024", "walls", 4, 0),
               ("100x130", "random", 4, 0), ("1024x1022", "walls", 4, 0),
               ("16x16", "walls", 8, 0), (WIDE, "walls", 4, 1),
               ("16384x1024", "walls", 4, 1), ("264x100", "random", 4, 1),
               ("64x16", "walls", 8, 1)]
WIDE_SHARD_ITERS = 200
SHARD_SCENE_PLANS = {
    "auto": {},
    "ring": {"LBM_SHARD_RESIDENT": "1"},
    "step": {"LBM_PALLAS_DEPTH": "1"},
}
SHARD_TIMING_GRIDS = ("1024x1024", "16384x1024")
N_SHARDS = 4
# The wrap path's timing case: wall-less, ny = 1022 no multiple of 4.
WRAP_GRID, WRAP_STEPS = "1024x1022", 200


def shard_mesh(torch, n, cards=1):
    from lbm_tpu_torch.parallel import decomp

    devices = [torch.device("cuda", i % cards) for i in range(n)]
    return decomp.make_mesh(n, devices=devices)


def shard_case(torch, name, kind, n, seed, axis=0):
    """The perturbed kernel-phase state of grid ``name`` over ``n``
    shards on one card: ``(plan, cells, mesh)``. The row plan (``axis``
    0) pads as the planner pads it. The x-plan (``axis`` 1) pads nothing;
    the planner takes it for wide grids above the resident kernel's size
    (``ops.plan.transposed_layout``) and it is built on request for the
    smaller ones."""
    import dataclasses

    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.state import initial_state

    p = scene_params(name, iters=200)
    cells, mask = random_case(torch, name, p, seed, kind, "perturbed")
    mesh = shard_mesh(torch, n)
    sp = halo.plan_run(p, mask.cpu().numpy(), mesh, "cuda", SHARD_G)
    if axis:
        check(sp.transposed == plan.transposed_layout(p.ny, p.nx),
              f"{name}/{n}: the planner's x-plan disagrees with the rule")
        sp = dataclasses.replace(sp, params=p, obstacles=mask.cpu().numpy(),
                                 mode="none", pad=0, wrap_pad=0,
                                 transposed=True)
    if sp.pad:
        full = initial_state(sp.params, "cuda")
        full[:, sp.pad:] = cells
        cells = full
    return sp, cells, mesh


def plain_shard_steps(ss, n, wrap_pad=0):
    """The plain version of every shard kernel: ``n`` plain shard steps
    (halo.ReferenceShardImpl) on the card."""
    from lbm_tpu_torch.parallel import halo

    ref = halo.ReferenceShardImpl(ss, wrap_pad)
    for t in range(n):
        ref.run(t)


def phase_shard_kernel(torch):
    """Each shard kernel for one call on every shard against the plain
    shard steps on the same inputs, in row mode (the row plan) and in
    column mode (the x-plan: error 0)."""
    from lbm_tpu_torch.parallel import halo, resident_ring

    worst = {}
    steps = max(SHARD_G, SHARD_G_D2)
    for i, (name, kind, n, axis) in enumerate(SHARD_CASES):
        sp, cells, mesh = shard_case(torch, name, kind, n, seed=20 + i,
                                     axis=axis)
        h = (sp.params.nx if axis else sp.params.ny) // n
        suffix = "_cols" if axis else ""
        kinds = [("step_seam", 1)]
        if not sp.wrap_pad:
            kinds += [("depth_seam", d) for d in DEPTHS if d <= h]
            kinds += [("ring", SHARD_G), ("ring", SHARD_G_D2)]
        res = {}
        with env():
            for key, size in kinds:
                ss, plain = (halo.ShardSet(sp.params, cells, sp.obstacles,
                                           mesh, steps, axis)
                             for _ in range(2))
                if key == "ring":
                    impl = resident_ring.RingShardImpl(ss, size)
                else:
                    impl = halo.SeamShardImpl(ss, size, sp.wrap_pad)
                impl.run(0)
                ss.synchronize()
                plain_shard_steps(plain, size, sp.wrap_pad)
                torch.cuda.synchronize()
                got, want = ss.gather()[:, sp.pad:], plain.gather()[:, sp.pad:]
                check(bool(torch.isfinite(got).all()), f"{key} not finite")
                err = (got - want).abs()
                gt, wt = ss.av_vels(1.0)[:size], plain.av_vels(1.0)[:size]
                tot_rel = float(((gt - wt).abs() / wt.abs()).max())
                r = {"max_abs_err": float(err.max()),
                     "cells_ok": bool((err <= ATOL + RTOL * want.abs()).all()),
                     "tot_rel_err": tot_rel, "tot_ok": tot_rel <= TOT_RTOL}
                label = {"step_seam": "step",
                         "depth_seam": f"depth D={size}"}.get(
                             key) or f"ring G={size} D={impl.depth}"
                if key == "ring":
                    # The rounds' per-step tots: the seam depth kernel's
                    # bits at the same D, shard by shard.
                    seam = halo.ShardSet(sp.params, cells, sp.obstacles, mesh,
                                         steps, axis)
                    depth = halo.SeamShardImpl(seam, impl.depth)
                    for t in range(0, size, impl.depth):
                        depth.run(t)
                    seam.synchronize()
                    r["tots_equal_seam_depth"] = all(
                        torch.equal(a.tots[:size], b.tots[:size])
                        for a, b in zip(ss.shards, seam.shards))
                    check(r["max_abs_err"] == 0.0
                          and r["tots_equal_seam_depth"],
                          f"{label}: the ring at {name} over {n}: {r}")
                    del seam, depth
                if key == "depth_seam":
                    # Step `size` at the last stage of the launch above and
                    # at the first of one that starts a step before it.
                    prev = halo.ShardSet(sp.params, cells, sp.obstacles, mesh,
                                         SHARD_G, axis)
                    plain_shard_steps(prev, size - 1, sp.wrap_pad)
                    halo.SeamShardImpl(prev, size, sp.wrap_pad).run(size - 1)
                    prev.synchronize()
                    r["stage_bits_equal"] = bool(
                        prev.av_vels(1.0)[size - 1] == gt[size - 1])
                    check(r["max_abs_err"] == 0.0 and r["stage_bits_equal"],
                          f"{label}: seam mode at {name} over {n}: {r}")
                    del prev
                res[label] = r
                worst[key + suffix] = max(worst.get(key + suffix, 0.0),
                                          r["max_abs_err"])
                check(r["cells_ok"] and r["tot_ok"]
                      and (not axis or r["max_abs_err"] == 0.0),
                      f"{label} != plain at {name} over {n}, axis {axis}")
                del ss, plain, impl, got, want, err
        emit({"phase": "shard_kernel", "grid": name, "shards": n,
              "plan": "x-plan (column mode)" if axis else "row plan",
              "rows_per_shard": h, "pad": f"{sp.mode} {sp.pad}", "mask": kind,
              **res})
        del cells
        torch.cuda.empty_cache()
    return worst


def expected_shard_launches(parts, shards, cards=1, cols=False):
    """Launch counts a planned sharded run must show, per kernel (``cols``:
    the x-plan, in column mode)."""
    n = expected_launches([])
    suffix = "_cols" if cols else ""
    for seg in parts:
        if seg.kernel == "ring":
            n[seg.launch_key + suffix] += seg.launches * cards
        else:
            # The seam kernels sum tot_u in the launch: no reduce.
            n[f"{seg.kernel}_seam{suffix}"] += seg.launches * shards
    return n


def phase_shard_scene(torch, np):
    """The 1024x1024 scene over 4 shards on one card through
    run_simulation(mesh=), once per plan; each within the drift budget and
    bit-identical to the unsharded auto run. Then the CLI's --devices 4,
    and the same runs across cards where there are several."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.ops import fused, plan
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.runner import run_simulation

    golden = np.load(GOLDEN)
    nx, ny = grid(SCENE)
    p, mask = scene_params(), scene_mask()
    with env():
        base = run_simulation(p, mask)

    def drive(label, plan_env, mesh):
        with env(**plan_env):
            sp = halo.plan_run(p, mask, mesh, "auto", ITERS)
            want = expected_shard_launches(sp.segments, mesh.size,
                                           len(set(mesh.devices)))
            fused.reset_launches()
            res = run_simulation(p, mask, mesh=mesh)
            launches = dict(fused.LAUNCHES)
        check(launches == want,
              f"shard {label}: launches {launches} differ from the plan's {want}")
        _, _, _, pressure = lio.final_state_fields(p, res.cells, mask)
        d_av = lio._diff(golden["av_vels"], res.av_vels, DRIFT_BUDGET_PCT)
        d_p = lio._diff(golden["pressure"], pressure.ravel(), DRIFT_BUDGET_PCT)
        same = bool(np.array_equal(res.cells, base.cells))
        out = {"plan": label, "env": plan_env, "shards": mesh.size,
               "devices": halo.describe_mesh(mesh),
               "segments": plan.describe(sp.segments) + " per shard",
               "launches": launches, "av_vels_max_pct": d_av.max_diff_pcnt,
               "pressure_max_pct": d_p.max_diff_pcnt,
               "drift_budget_pct": DRIFT_BUDGET_PCT,
               "cells_bit_identical_to_unsharded_auto": same,
               "av_vels_max_rel_err_vs_unsharded": float(np.max(
                   np.abs(res.av_vels - base.av_vels) / np.abs(base.av_vels))),
               "reynolds": res.reynolds,
               "compute_s": res.timings["compute"],
               "glups": nx * ny * ITERS / res.timings["compute"] / 1e9,
               "timings_s": res.timings}
        check(not d_av.failed and not d_p.failed,
              f"shard {label}: outside the drift budget")
        check(same, f"shard {label}: cells differ from the unsharded run")
        return out, launches

    per_plan = {}
    for label, plan_env in SHARD_SCENE_PLANS.items():
        out, per_plan[label] = drive(label, plan_env, shard_mesh(torch, N_SHARDS))
        emit({"phase": "shard_scene", "grid": SCENE, **out})

    params, obs = scene_files()
    cmd = [sys.executable, "-m", "lbm_tpu_torch", str(params), str(obs),
           "--devices", str(N_SHARDS), "--iters", "200",
           "--av-vels-file", str(SCENE_DIR / "av_devices.dat"),
           "--final-state-file", str(SCENE_DIR / "fs_devices.dat")]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    notes = [ln for ln in proc.stderr.splitlines() if ln.startswith("note:")]
    emit({"phase": "shard_scene", "cli": " ".join(cmd[1:]),
          "rc": proc.returncode, "stderr": proc.stderr.splitlines()[-4:],
          "notes": notes})
    check(proc.returncode == 0, f"CLI --devices exit {proc.returncode}")
    cards = torch.cuda.device_count()
    if cards == 1:
        check(notes == [f"note: using 1 devices (1 visible)"],
              f"CLI --devices on one card: notes {notes}")

    if cards > 1:
        k = min(N_SHARDS, cards)
        for label in ("auto", "ring"):
            out, _ = drive(label, SHARD_SCENE_PLANS[label],
                           shard_mesh(torch, k, cards=k))
            emit({"phase": "cross_card", "cards": k, "run": True, **out})
    else:
        emit({"phase": "cross_card", "cards": 1, "run": False})
    return per_plan


def phase_wide_shard(torch, np):
    """131072x128 over 4 shards on one card (the x-plan) through
    run_simulation(mesh=), once per plan, each bit-identical to the
    unsharded auto run (transposed), with the plan's launch counts."""
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import fused, plan
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.runner import run_simulation

    nx, ny = grid(WIDE)
    iters = WIDE_SHARD_ITERS
    p, mask = scene_params(WIDE, iters), generate_obstacles(nx, ny)
    with env():
        base = run_simulation(p, mask)
    per_plan = {}
    for label, plan_env in SHARD_SCENE_PLANS.items():
        mesh = shard_mesh(torch, N_SHARDS)
        with env(**plan_env):
            sp = halo.plan_run(p, mask, mesh, "auto", iters)
            want = expected_shard_launches(sp.segments, mesh.size,
                                           cols=sp.transposed)
            fused.reset_launches()
            res = run_simulation(p, mask, mesh=mesh)
            launches = dict(fused.LAUNCHES)
        same = bool(np.array_equal(res.cells, base.cells))
        emit({"phase": "wide_shard", "grid": WIDE, "plan": label,
              "env": plan_env, "shards": mesh.size,
              "describe": halo.describe(sp, mesh), "launches": launches,
              "cells_bit_identical_to_unsharded_auto": same,
              "av_vels_max_rel_err_vs_unsharded": float(np.max(
                  np.abs(res.av_vels - base.av_vels) / np.abs(base.av_vels))),
              "compute_s": res.timings["compute"],
              "glups": nx * ny * iters / res.timings["compute"] / 1e9})
        check(sp.transposed, f"wide shard {label}: not the x-plan")
        check(launches == want, f"wide shard {label}: launches {launches} "
              f"differ from the plan's {want}")
        check(same, f"wide shard {label}: cells differ from the unsharded run")
        check(float(np.max(np.abs(res.av_vels - base.av_vels)
                           / np.abs(base.av_vels))) <= TRAJ_RTOL,
              f"wide shard {label}: av_vels off the unsharded run")
        per_plan[label] = launches
        del res
    return per_plan


def _median_ms_shards(torch, ss, fn, spc, device_only, steps=200, batches=6):
    """:func:`_median_ms` for work on the shards' streams: the events sit
    on the current stream, every shard stream starts after the first and
    the second waits for every shard stream."""
    calls = max(1, steps // spc)
    for _ in range(calls):
        fn()
    ss.synchronize()
    cur = torch.cuda.current_stream()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            # ~200 ms: a call of the one-step seam path over 4 shards
            # enqueues 28 operations, and 200 calls outlast a 50 ms sleep.
            torch.cuda._sleep(4 * SLEEP_CYCLES)
        a.record(cur)
        for sh in ss.shards:
            sh.stream.wait_event(a)
        for _ in range(calls):
            fn()
        for sh in ss.shards:
            cur.wait_event(ss.record(sh))
        b.record(cur)
        b.synchronize()
        times.append(a.elapsed_time(b) / (calls * spc))
    return statistics.median(times), min(times), max(times)


def phase_shard_timing(torch, timing):
    """Per-step time of each shard kernel configuration over 4 shards on
    one card, beside the unsharded best (where the timing phase ran); the
    halo copies alone; the plain shard step at 1024x1024; the wrap path;
    the on-chip ring's rows (:func:`shard_timing_onchip`)."""
    from lbm_tpu_torch.parallel import halo, resident_ring

    results = {}
    for name in SHARD_TIMING_GRIDS:
        p = scene_params(name)
        cells, mask = random_case(
            torch, name, p, seed=98, state="perturbed",
            mask_kind="scene" if name == SCENE else "walls")
        mesh = shard_mesh(torch, N_SHARDS)
        ss = halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, 100)
        with env():
            impls = {"seam D=1": halo.SeamShardImpl(ss, 1),
                     **{f"seam D={d}": halo.SeamShardImpl(ss, d) for d in DEPTHS},
                     **{f"ring G={g}": resident_ring.RingShardImpl(ss, g)
                        for g in (16, 100)}}
        loop, dev = time_turns(torch, {
            label: (lambda impl=impl: impl.run(0), impl.steps_per_call, ss)
            for label, impl in impls.items()})
        copies = {}
        for label in ("seam D=1", "seam D=4"):
            impl = impls[label]
            copies[label] = _median_ms_shards(
                torch, ss, lambda: ss.exchange(impl.sources, impl.halos,
                                               impl.k), 1, True)[0]
        out = {"phase": "shard_timing", "grid": name, "shards": N_SHARDS,
               "devices": halo.describe_mesh(mesh),
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "halo_copy_device_ms_per_call": copies,
               "halo_copies_per_call": {
                   label: sum(not src.in_place for pair in
                              impls[label].sources for src in pair)
                   for label in copies},
               "ring_depths": {k: v.depth for k, v in impls.items()
                               if k.startswith("ring")},
               "method": "CUDA events on the current stream, every shard "
                         "stream joined; median over 6 batches of ~200 "
                         "steps after one warm-up batch, configurations in "
                         "turns (forward, then reverse); device: queue "
                         "pre-filled behind a device sleep"}
        if timing:
            unsharded = timing[name]["device_ms_per_step"]
            best = min(unsharded,
                       key=lambda k: statistics.median(unsharded[k]))
            out["unsharded_best"] = {best: statistics.median(unsharded[best])}
        if name == SCENE:
            plain = halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, 100)
            ref = halo.ReferenceShardImpl(plain)
            out["plain_device_ms_per_step"] = _median_ms(
                torch, lambda: ref.run(0), 1, True, steps=20)[0]
            del plain, ref
        emit(out)
        results[name] = out
        del ss, impls, cells
        torch.cuda.empty_cache()
    results[WRAP_GRID] = shard_timing_wrap(torch)
    results["ring_onchip"] = shard_timing_onchip(torch)
    return results


def shard_timing_wrap(torch):
    """The wrap discipline's path: a wall-less WRAP_GRID over 4 shards,
    whose ny does not divide the mesh, so ``auto`` pads 2 rows inside
    shard 0 and runs the one-step seam kernel on every step. WRAP_STEPS
    calls held to as many plain shard steps (cells max abs error 0, tots
    at TOT_RTOL), then loop and device ms a step."""
    from lbm_tpu_torch.ops import fused, plan
    from lbm_tpu_torch.parallel import halo

    sp, cells, mesh = shard_case(torch, WRAP_GRID, "random", N_SHARDS, 97)
    check(sp.mode == "wrap" and plan.describe(sp.segments) == "step x16",
          f"{WRAP_GRID}: not the wrap plan: {sp.mode} {sp.segments}")
    ss, plain = (halo.ShardSet(sp.params, cells, sp.obstacles, mesh,
                               WRAP_STEPS) for _ in range(2))
    impl = halo.SeamShardImpl(ss, 1, sp.wrap_pad)
    fused.reset_launches()
    for t in range(WRAP_STEPS):
        impl.run(t)
    ss.synchronize()
    launches = dict(fused.LAUNCHES)
    plain_shard_steps(plain, WRAP_STEPS, sp.wrap_pad)
    got, want = ss.gather()[:, sp.pad:], plain.gather()[:, sp.pad:]
    gt, wt = ss.av_vels(1.0), plain.av_vels(1.0)
    out = {"phase": "shard_timing", "grid": WRAP_GRID, "shards": N_SHARDS,
           "mask": "random, wall-less", "pad": f"{sp.mode} {sp.pad}",
           "steps_checked": WRAP_STEPS,
           "max_abs_err": float((got - want).abs().max()),
           "tot_rel_err": float(((gt - wt).abs() / wt.abs()).max()),
           "launches": {k: v for k, v in launches.items() if v}}
    check(out["max_abs_err"] == 0.0 and out["tot_rel_err"] <= TOT_RTOL
          and launches["step_seam"] == WRAP_STEPS * N_SHARDS
          and sum(launches.values()) == launches["step_seam"],
          f"the wrap path at {WRAP_GRID}: {out}")
    del plain, got, want
    loop, dev = time_turns(torch, {
        "seam D=1": (lambda: impl.run(0), 1, ss)})
    out.update({"loop_ms_per_step": loop, "device_ms_per_step": dev,
                "method": "as the other shard_timing lines, one "
                          "configuration"})
    emit(out)
    del ss, impl, cells
    torch.cuda.empty_cache()
    return out


def wide_auto_depth(name, shards=1):
    """The depth ``auto`` plans on the transposed lattice of grid ``name``
    (over ``shards`` shards of the x-plan: rows a shard)."""
    from lbm_tpu_torch.ops import plan

    nx, ny = grid(name)
    with env():
        return plan.depth_preference(nx // shards, ny)[0]


def phase_wide_shard_timing(torch):
    """Over 4 shards on one card, the x-plan (shards of physical columns,
    column mode) against the row plan at the wide timing grids, in turns
    within one call: seam D=1 and D=4 and the ring at G=100, the halo
    copies per call; the plain shard step of the x-plan at 131072x128."""
    from lbm_tpu_torch.parallel import halo, resident_ring

    results = {}
    for name in WIDE_TIMING_GRIDS[:2]:
        p = scene_params(name)
        cells, mask = random_case(torch, name, p, seed=96, state="perturbed")
        mesh = shard_mesh(torch, N_SHARDS)
        mask_np = mask.cpu().numpy()
        calls, copies, sets, ring_depths = {}, {}, {}, {}
        for plan_name, axis in (("x-plan", 1), ("row plan", 0)):
            ss = sets[plan_name] = halo.ShardSet(p, cells, mask_np, mesh, 100,
                                                 axis)
            depths = sorted({1, 4, wide_auto_depth(name, N_SHARDS)})
            with env():
                impls = {**{f"seam D={d}": halo.SeamShardImpl(ss, d)
                            for d in depths},
                         "ring G=100": resident_ring.RingShardImpl(ss, 100)}
            for label, impl in impls.items():
                calls[f"{plan_name} {label}"] = (
                    lambda impl=impl: impl.run(0), impl.steps_per_call, ss)
                if label.startswith("ring"):
                    ring_depths[f"{plan_name} {label}"] = impl.depth
            for label in ("seam D=1", "seam D=4"):
                impl = impls[label]
                copies[f"{plan_name} {label}"] = _median_ms_shards(
                    torch, ss, lambda impl=impl, ss=ss: ss.exchange(
                        impl.sources, impl.halos, impl.k), 1, True)[0]
        loop, dev = time_turns(torch, calls, steps=100)
        out = {"phase": "wide_shard_timing", "grid": name,
               "shards": N_SHARDS, "devices": halo.describe_mesh(mesh),
               "local_shape": {k: [ss.h, ss.nx] for k, ss in sets.items()},
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "halo_copy_device_ms_per_call": copies,
               "ring_depths": ring_depths,
               "method": "CUDA events on the current stream, every shard "
                         "stream joined; median over 6 batches of 100 "
                         "steps after one warm-up batch, both plans' "
                         "configurations in turns (forward, then reverse); "
                         "device: queue pre-filled behind a device sleep"}
        if name == WIDE:
            ref = halo.ReferenceShardImpl(sets["x-plan"])
            out["plain_x_plan_device_ms_per_step"] = _median_ms(
                torch, lambda: ref.run(0), 1, True, steps=3, batches=3)[0]
            del ref
        emit(out)
        results[name] = out
        del sets, calls, cells
        torch.cuda.empty_cache()
    return results


# The on-chip ring (csrc/ring_onchip.cu) over N_SHARDS on one card: the
# shard shapes of its timing rows (256x256 and 512x512: both modes fit;
# 640x512; 768x768: one buffer only; the x-plan of 1024x512: one buffer
# only; and of 1024x384: both), strips of one row (128x128/4) and the
# forced row on a shard edge (16x16 over 8: 2 rows a shard), each for one
# call at G = 16 and 100 against the plain shard steps.
RING_ONCHIP_GRIDS = ("256x256", "512x512", "640x512", "768x768",
                     INPLACE_SCENE, WIDE_LIMIT)
RING_ONCHIP_EDGES = (("128x128", 4), ("16x16", 8))
RING_ONCHIP_GS = (16, 100)
# The path's scenes under auto with LBM_SHARD_RESIDENT=1 (the wide scenes'
# params, the generator's walls), all cells bit-identical to the
# unsharded auto run: 768x768 (row mode, one buffer) and 1024x512 (the
# x-plan, column mode, one buffer) at the scenes' 20000 steps, not cut;
# 512x512 (two buffers), 20000 steps; 1024x384 (the x-plan in two
# buffers), 2000 steps. Each also RING_GATE_ITERS steps against the plain
# float64 run.
RING_ONCHIP_SCENES = {"768x768": (20000, "on-chip 1-buf"),
                      INPLACE_SCENE: (20000, "on-chip 1-buf"),
                      "512x512": (20000, "on-chip"),
                      WIDE_LIMIT: (2000, "on-chip")}
RING_GATE_ITERS = 500


def onchip_ring_forms(torch, h, lanes, shards):
    """The on-chip ring's forms whose strips of ``h`` x ``lanes`` shards,
    ``shards`` on this card, fit its shared memory."""
    from lbm_tpu_torch.ops import plan, resident
    from lbm_tpu_torch.parallel import resident_ring

    sms, smem = resident.device_limits("cuda")
    blocks = resident_ring.ring_blocks(h, shards, sms)
    return [form for form, bufs in (("onchip", 2), ("inplace", 1))
            if plan.onchip_smem_bytes(h, lanes, blocks, bufs) <= smem]


def phase_ring_onchip_kernel(torch):
    """The on-chip ring for one call on every shard against the plain
    shard steps on the same inputs, in each mode whose strips fit, at G =
    16 and 100: cells max abs error 0, tots within TOT_RTOL; one buffer's
    tots the two buffers' bits where both fit."""
    from lbm_tpu_torch.ops import fused, plan
    from lbm_tpu_torch.parallel import halo, resident_ring

    worst = {}
    cases = [(name, N_SHARDS, int(name in (INPLACE_SCENE, WIDE_LIMIT)))
             for name in RING_ONCHIP_GRIDS] + [(name, n, 0) for name, n
                                                in RING_ONCHIP_EDGES]
    for i, (name, n, axis) in enumerate(cases):
        sp, cells, mesh = shard_case(torch, name, "walls", n, seed=60 + i,
                                     axis=axis)
        ss0 = halo.ShardSet(sp.params, cells, sp.obstacles, mesh, 1, axis)
        h, lanes = ss0.h, ss0.nx
        del ss0
        forms = onchip_ring_forms(torch, h, lanes, n)
        check(forms, f"{name} over {n}: no on-chip mode fits")
        res, tots = {}, {}
        for form in forms:
            for g in RING_ONCHIP_GS:
                ss, plain = (halo.ShardSet(sp.params, cells, sp.obstacles,
                                           mesh, g, axis) for _ in range(2))
                with env():
                    impl = resident_ring.RingOnchipImpl(ss, g, form)
                key = plan.Segment("ring", g, g, form).launch_key + (
                    "_cols" if axis else "")
                before = fused.LAUNCHES[key]
                impl.run(0)
                ss.synchronize()
                launched = fused.LAUNCHES[key] - before
                plain_shard_steps(plain, g)
                torch.cuda.synchronize()
                got, want = ss.gather(), plain.gather()
                check(bool(torch.isfinite(got).all()), f"{key} not finite")
                gt, wt = ss.av_vels(1.0), plain.av_vels(1.0)
                r = {"max_abs_err": float((got - want).abs().max()),
                     "tot_rel_err": float(((gt - wt).abs() / wt.abs()).max()),
                     "strips_a_shard": impl._bps[ss.shards[0].device],
                     "launches": launched}
                check(r["max_abs_err"] == 0.0 and r["tot_rel_err"] <= TOT_RTOL
                      and launched == 1,
                      f"on-chip ring {form} G={g} at {name} over {n}: {r}")
                if g == max(RING_ONCHIP_GS):
                    tots[form] = [sh.tots.clone() for sh in ss.shards]
                res[f"{form} G={g}"] = r
                worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
                del ss, plain, impl, got, want
        out = {"phase": "ring_onchip_kernel", "grid": name, "shards": n,
               "plan": "x-plan (column mode)" if axis else "row plan",
               "rows_per_shard": h, "lanes": lanes, "modes_that_fit": forms,
               **res}
        if len(tots) == 2:
            out["one_buffer_tots_are_two_buffer_bits"] = all(
                torch.equal(a, b) for a, b in zip(tots["onchip"],
                                                  tots["inplace"]))
            check(out["one_buffer_tots_are_two_buffer_bits"],
                  f"{name} over {n}: one buffer's tots differ from two's")
        emit(out)
        del cells, tots
        torch.cuda.empty_cache()
    return worst


def phase_ring_onchip_scene(torch, np):
    """The on-chip ring's path: RING_ONCHIP_SCENES through
    run_simulation(mesh=) over N_SHARDS on one card under auto with
    LBM_SHARD_RESIDENT=1: the plan names the form, launch counts equal
    the plan's, cells bit-identical to the unsharded auto run, and
    RING_GATE_ITERS steps within the drift budget of the port's plain
    float64 run on the card. Returns each scene's launches and seconds."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import fused, plan
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.runner import run_simulation

    results = {}
    for name, (iters, form) in RING_ONCHIP_SCENES.items():
        nx, ny = grid(name)
        p, mask = scene_params(name, iters), generate_obstacles(nx, ny)
        mesh = shard_mesh(torch, N_SHARDS)
        with env():
            base = run_simulation(p, mask)
        with env(LBM_SHARD_RESIDENT="1"):
            sp = halo.plan_run(p, mask, mesh, "auto", iters)
            want = expected_shard_launches(sp.segments, mesh.size,
                                           cols=sp.transposed)
            fused.reset_launches()
            res = run_simulation(p, mask, mesh=mesh)
            launches = dict(fused.LAUNCHES)
            gate = run_simulation(p, mask, n_iters=RING_GATE_ITERS, mesh=mesh)
        describe = plan.describe(sp.segments)
        with env():
            ref = run_simulation(scene_params(name, RING_GATE_ITERS,
                                              np.float64), mask,
                                 kernel="reference")
        gp = scene_params(name, RING_GATE_ITERS)
        d, ok = drift(np, ref.av_vels,
                      lio.final_state_fields(gp, ref.cells, mask)[3].ravel(),
                      gate.av_vels,
                      lio.final_state_fields(gp, gate.cells, mask)[3].ravel())
        same = bool(np.array_equal(res.cells, base.cells))
        out = {"phase": "ring_onchip_scene", "grid": name, "steps": iters,
               "shards": mesh.size, "describe": halo.describe(sp, mesh),
               "launches": {k: v for k, v in launches.items() if v},
               "cells_bit_identical_to_unsharded_auto": same,
               "av_vels_max_rel_err_vs_unsharded": float(np.max(
                   np.abs(res.av_vels - base.av_vels) / np.abs(base.av_vels))),
               "gate_steps": RING_GATE_ITERS, **d,
               "reference": "plain float64 on the card",
               "compute_s": res.timings["compute"],
               "glups": nx * ny * iters / res.timings["compute"] / 1e9,
               "unsharded_compute_s": base.timings["compute"]}
        emit(out)
        check(describe == f"ring G=100 {form} x{iters // 100}",
              f"{name}: the sharded plan is {describe}")
        check(launches == want,
              f"{name}: launches {launches} differ from the plan's {want}")
        check(same, f"{name}: sharded cells differ from the unsharded run")
        check(ok, f"{name}: outside the drift budget")
        results[name] = out
        del base, res, gate, ref
        torch.cuda.empty_cache()
    return results


def shard_timing_onchip(torch):
    """The on-chip ring beside the device-memory ring and seam D=4 over
    N_SHARDS on one card, at RING_ONCHIP_GRIDS (the x-plan for the wide
    ones), G=100: the planned mode and the other where it fits, loop and
    device ms a step in turns, the planned form and its ratios (the
    numbers the ring's form rule is held to); the plain shard step."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.parallel import halo, resident_ring

    results = {}
    for name in RING_ONCHIP_GRIDS:
        nx, ny = grid(name)
        axis = int(plan.transposed_layout(ny, nx))
        p = scene_params(name)
        cells, mask = random_case(torch, name, p, seed=95, state="perturbed")
        mesh = shard_mesh(torch, N_SHARDS)
        ss = halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, 100, axis)
        with env(LBM_SHARD_RESIDENT="1"):
            planned = resident_ring.planned_ring_form(ss.h, ss.nx, mesh)
        with env():
            impls = {f"ring G=100 {form}": resident_ring.RingOnchipImpl(
                         ss, 100, form)
                     for form in onchip_ring_forms(torch, ss.h, ss.nx,
                                                   N_SHARDS)}
            impls["ring G=100 device"] = resident_ring.RingShardImpl(ss, 100)
            impls["seam D=4"] = halo.SeamShardImpl(ss, 4)
        loop, dev = time_turns(torch, {
            label: (lambda impl=impl: impl.run(0), impl.steps_per_call, ss)
            for label, impl in impls.items()})
        plain = halo.ShardSet(p, cells, mask.cpu().numpy(), mesh, 100, axis)
        ref = halo.ReferenceShardImpl(plain)
        plain_ms = _median_ms(torch, lambda: ref.run(0), 1, True, steps=4,
                              batches=3)[0]
        med = {k: statistics.median(v) for k, v in dev.items()}
        key = f"ring G=100 {planned}"
        out = {"phase": "shard_timing", "grid": name, "shards": N_SHARDS,
               "plan": "x-plan (column mode)" if axis else "row plan",
               "local_shape": [ss.h, ss.nx], "planned_form": planned,
               "strips_a_shard": {k: v._bps[ss.shards[0].device]
                                  for k, v in impls.items()
                                  if isinstance(v,
                                                resident_ring.RingOnchipImpl)},
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "planned_over_device_ring": med[key] / med["ring G=100 device"],
               "planned_over_seam_d4": med[key] / med["seam D=4"],
               "plain_device_ms_per_step": plain_ms,
               "method": "CUDA events on the current stream, every shard "
                         "stream joined; median over 6 batches of ~200 "
                         "steps after one warm-up batch, configurations in "
                         "turns (forward, then reverse); device: queue "
                         "pre-filled behind a device sleep"}
        emit(out)
        results[name] = out
        del ss, plain, ref, impls, cells
        torch.cuda.empty_cache()
    return results


# The stream-cost probe: its kernel-phase grids, the G of one checked call
# and of the timed launches, and the timing grids (1024x1024: two 37.7 MB
# buffers, above the 50 MB L2; 512x512: both in L2).
PROBE_CASES = [("1024x1024", "scene"), ("128x128", "walls"),
               ("100x130", "random"), ("16384x1024", "walls")]
PROBE_G, PROBE_TIMING_G = 16, 100
PROBE_TIMING_GRIDS = ("1024x1024", "512x512", "16384x1024")


def phase_probe_kernel(torch):
    """The probe's three modes for one call against the plain version:
    cells max abs error 0, totals within the tot bound; full mode against
    the resident kernel with the forcing set to 0."""
    from lbm_tpu_torch.ops import probe, resident
    from lbm_tpu_torch.ops import reference as ref_ops

    worst = {}
    for i, (name, kind) in enumerate(PROBE_CASES):
        p = scene_params(name, iters=200)
        cells, mask = random_case(torch, name, p, 60 + i, kind, "perturbed")
        res = {}
        with env():
            for mode in probe.MODES:
                got, tots = probe.probe(cells, mask, p.omega, PROBE_G, mode)
                want, want_tots = ref_ops.probe_multi_step(
                    cells, mask, p.omega, PROBE_G, mode)
                r = res[mode] = compare(torch, got, tots, want, want_tots)
                worst[mode] = max(worst.get(mode, 0.0), r["max_abs_err"])
                check(r["max_abs_err"] == 0.0 and r["tot_ok"],
                      f"probe {mode} != plain at {name}")
                if mode == "full":
                    # Against whichever form the plan picks here.
                    res["resident_form"] = resident.planned_form(
                        *mask.shape, "cuda")
                    same, _ = resident.resident(cells, mask, 0.0, 0.0,
                                                p.omega, PROBE_G)
                    res["full_equals_resident_without_forcing"] = bool(
                        torch.equal(got, same))
                    check(res["full_equals_resident_without_forcing"],
                          f"probe full != resident with accel 0 at {name}")
                    # The device-memory form, whose code full runs with no
                    # forced line: the same bits in every step's total.
                    _, dev_tots = resident.resident(
                        cells, mask, 0.0, 0.0, p.omega, PROBE_G,
                        form="device")
                    res["full_tots_equal_device_form"] = bool(
                        torch.equal(tots, dev_tots))
                    check(res["full_tots_equal_device_form"],
                          f"probe full tots != device form's at {name}")
                del got, want
        emit({"phase": "probe_kernel", "grid": name, "mask": kind,
              "gsteps": PROBE_G, **res})
        del cells, mask
        torch.cuda.empty_cache()
    return worst


def phase_probe_path(torch):
    """The probe's path as a user drives it: the script's ``main`` at its
    default grid. Returns the launch counts of that run."""
    from lbm_tpu_torch.ops import fused

    spec = importlib.util.spec_from_file_location(
        "stream_cost_probe_torch",
        REPO / "scripts" / "stream_cost_probe_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = io.StringIO()
    with env():
        fused.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = script.main(["--grid", SCENE, "--gsteps", "200",
                              "--repeats", "3"])
        launches = dict(fused.LAUNCHES)
    check(rc == 0, f"stream_cost_probe_torch.py exit {rc}")
    summary = json.loads(out.getvalue().splitlines()[-1])
    check(0.0 < summary["stream_share_direct"] < 1.5
          and -0.5 < summary["stream_share_subtractive"] < 1.0,
          f"probe shares out of range: {summary}")
    emit({"phase": "probe_path", "script": "scripts/stream_cost_probe_torch.py",
          "launches": {k: v for k, v in launches.items() if v}, **summary})
    return launches


def phase_probe_timing(torch):
    """Device ms per step of the probe's modes and of the resident kernel's
    device-memory form (rounds of depth tiles: the ratio to full is no
    longer forcing alone) at G = PROBE_TIMING_G, in turns; the two
    streaming shares; the plain version at 1024x1024."""
    from lbm_tpu_torch.ops import probe, resident
    from lbm_tpu_torch.ops import reference as ref_ops

    g = PROBE_TIMING_G
    results = {}
    for name in PROBE_TIMING_GRIDS:
        p = scene_params(name)
        cells, mask = random_case(
            torch, name, p, seed=95, state="perturbed",
            mask_kind="scene" if name == SCENE else "walls")
        bufs = [cells, torch.empty_like(cells)]
        av = torch.zeros(g, device="cuda")
        with env():
            kernels = {m: probe.Probe(mask, p.omega, g, m) for m in probe.MODES}
            res = resident.Resident(mask, p.accel_w1, p.accel_w2, p.omega, g,
                                    form="device")
        calls = {f"probe {m}": (lambda k=k: k.run(bufs[0], bufs[1], av), g, None)
                 for m, k in kernels.items()}
        calls[f"resident G={g}"] = (runner_call(res, bufs, av), g, None)
        loop, dev = time_turns(torch, calls)
        med = {k: statistics.median(v) for k, v in dev.items()}
        full = med["probe full"]
        geometry = {m: {"blocks": k.blocks, "rounds": k.rounds}
                    for m, k in kernels.items()}
        check(all(v == geometry["full"] for v in geometry.values()),
              f"probe modes launch different geometries at {name}")
        out = {"phase": "probe_timing", "grid": name, "gsteps": g,
               "buffer_mb": cells.numel() * 4 / 1e6,
               "blocks": {m: v["blocks"] for m, v in geometry.items()},
               "rounds": {m: "+".join(f"{v['rounds'].count(d)}x{d}"
                                      for d in (4, 2, 1)
                                      if d in v["rounds"])
                          for m, v in geometry.items()},
               "resident_blocks": res.blocks,
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "stream_share_subtractive": (full - med["probe collide"]) / full,
               "stream_share_direct": med["probe stream"] / full,
               "resident_over_full": med[f"resident G={g}"] / full,
               "method": "CUDA events; median over 10 batches of 200 steps "
                         "after one warm-up batch, configurations in turns "
                         "(forward, then reverse); device: queue pre-filled "
                         "behind a device sleep"}
        out["state_finite_after_timing"] = bool(torch.isfinite(bufs[0]).all())
        if name == SCENE:
            plain = {}
            for m in probe.MODES:
                def plain_steps(m=m):
                    ref_ops.probe_multi_step(bufs[0], mask, p.omega, 2, m)
                plain[m] = _median_ms(torch, plain_steps, 2, True, steps=8,
                                      batches=3)[0]
            out["plain_device_ms_per_step"] = plain
        emit(out)
        results[name] = out
        del cells, bufs, kernels, res, calls
        torch.cuda.empty_cache()
    return results


# The tensor-core equilibrium's checks: a launch of MXU_G steps against
# its plain version on these grids (the scene's mask with its column, a
# ragged wall-less one, the generator's walls); its timing grid.
MXU_CASES = [("1024x1024", "scene"), ("100x130", "random"),
             ("264x100", "walls")]
MXU_G = 100
MXU_PROBE_OUT = REPO / "build" / "lbm_tpu_torch" / "mxu_probe_torch.json"


def mxu_mma():
    """HMMA and DMMA instructions in the built mxu_resident_kernel's
    SASS."""
    from lbm_tpu_torch.ops import _build

    return harness_script("mxu_probe_torch").mma_in_sass(
        _build.build()[0]).get("mxu_resident_kernel", 0)


def phase_mxu_kernel(torch, np):
    """The tensor-core kernel for one call of MXU_G steps against its
    plain version (cells within mxu_eq.cells_atol, totals within
    mxu_eq.TOT_RTOL) and against the elementwise device form at the drift
    level; the tensor-core instructions. Returns the largest cell error."""
    from lbm_tpu_torch.obstacles import num_non_obstacles_r
    from lbm_tpu_torch.ops import mxu_eq, resident
    from lbm_tpu_torch import io as lio

    mma = mxu_mma()
    check(mma > 0, "no DMMA or HMMA instruction in mxu_resident_kernel's "
          "SASS")
    worst = 0.0
    for i, (name, kind) in enumerate(MXU_CASES):
        p = scene_params(name, iters=200)
        cells, mask = random_case(torch, name, p, 70 + i, kind, "perturbed")
        w = (p.accel_w1, p.accel_w2, p.omega)
        with env():
            got, tots = mxu_eq.mxu_resident(cells, mask, *w, MXU_G)
            want, want_tots = mxu_eq.mxu_multi_step(cells, mask, *w, MXU_G)
            dev, dev_tots = resident.resident(cells, mask, *w, MXU_G,
                                              form="device")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"mxu output not finite at "
              f"{name}")
        err = float((got - want).abs().max())
        atol = mxu_eq.cells_atol(MXU_G, p.omega)
        tot_rel = float(((tots - want_tots).abs() / want_tots.abs()).max())
        worst = max(worst, err)
        # Against the elementwise step: av_vels and pressure by check.py's
        # formula, as the drift gate compares a run with its golden.
        m_np = mask.cpu().numpy()
        inv = float(num_non_obstacles_r(m_np))
        pressure = [lio.final_state_fields(p, c.cpu().numpy(), m_np)[3].ravel()
                    for c in (got, dev)]
        d, ok = drift(np, (dev_tots * inv).cpu().numpy(), pressure[1],
                      (tots * inv).cpu().numpy(), pressure[0])
        emit({"phase": "mxu_kernel", "grid": name, "mask": kind,
              "gsteps": MXU_G, "max_abs_err": err, "cells_atol": atol,
              "tot_rel_err": tot_rel, "tot_rtol": mxu_eq.TOT_RTOL,
              "max_abs_vs_device_form": float((got - dev).abs().max()),
              "vs_device_form": d, "mma_in_sass": mma})
        check(err <= atol and tot_rel <= mxu_eq.TOT_RTOL,
              f"mxu != plain at {name}: {err} (atol {atol}), tots {tot_rel}")
        check(ok, f"mxu against the device form at {name}: {d}")
        del cells, mask, got, want, dev
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "mma_in_sass": mma,
            "cells_atol": mxu_eq.cells_atol(MXU_G, 1.85)}


def phase_mxu_scene(torch, np):
    """The 1024x1024 scene, ITERS steps, through MxuStep at G = MXU_G: its
    final state against the float64 golden within the drift budget.
    Returns the launch counts of the run."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import num_non_obstacles_r
    from lbm_tpu_torch.ops import fused, mxu_eq
    from lbm_tpu_torch.state import initial_state

    golden = np.load(GOLDEN)
    p = scene_params()
    mask = scene_mask()
    inv = float(num_non_obstacles_r(mask))
    mask_d = torch.from_numpy(mask).cuda()
    cells = initial_state(p, "cuda")
    spare = torch.empty_like(cells)
    av = torch.zeros(ITERS, device="cuda")
    with env():
        kernel = mxu_eq.MxuStep(mask_d, p.accel_w1, p.accel_w2, p.omega,
                                MXU_G)
        fused.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(0, ITERS, MXU_G):
            cells, spare = kernel.run(cells, spare, av, t, inv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fused.LAUNCHES)
    check(launches["mxu"] == ITERS // MXU_G
          and sum(launches.values()) == launches["mxu"],
          f"mxu scene launches {launches}")
    check(bool(torch.isfinite(cells).all()), "mxu scene not finite")
    pressure = lio.final_state_fields(p, cells.cpu().numpy(), mask)[3]
    d, ok = drift(np, golden["av_vels"], golden["pressure"], av.cpu().numpy(),
                  pressure.ravel())
    emit({"phase": "mxu_scene", "grid": SCENE, "steps": ITERS,
          "gsteps": MXU_G, "launches": {k: v for k, v in launches.items()
                                        if v},
          **d, "seconds": seconds,
          "glups": grid(SCENE)[0] * grid(SCENE)[1] * ITERS / seconds / 1e9,
          "reference": str(GOLDEN.relative_to(REPO))})
    check(ok, f"mxu scene outside the drift budget: {d}")
    return launches


def phase_mxu_timing(torch):
    """Device ms per step of the tensor-core kernel and of the
    device-memory form at G = MXU_G, in turns, at 1024x1024; the plain
    version's; then the probe script's main at 200 steps."""
    from lbm_tpu_torch.ops import mxu_eq, resident

    p = scene_params(SCENE)
    cells, mask = random_case(torch, SCENE, p, seed=96, state="perturbed",
                              mask_kind="scene")
    bufs = [cells, torch.empty_like(cells)]
    av = torch.zeros(MXU_G, device="cuda")
    w = (p.accel_w1, p.accel_w2, p.omega)
    with env():
        mxu = mxu_eq.MxuStep(mask, *w, MXU_G)
        dev = resident.Resident(mask, *w, MXU_G, form="device")
        calls = {f"device form G={MXU_G}": (runner_call(dev, bufs, av), MXU_G,
                                            None),
                 f"mxu G={MXU_G}": (runner_call(mxu, bufs, av), MXU_G, None)}
        loop, devms = time_turns(torch, calls)

        def plain_steps():
            mxu_eq.mxu_multi_step(bufs[0], mask, *w, 2)
        plain = _median_ms(torch, plain_steps, 2, True, steps=8, batches=3)[0]
    med = {k: statistics.median(v) for k, v in devms.items()}
    out = {"phase": "mxu_timing", "grid": SCENE, "gsteps": MXU_G,
           "blocks": {"mxu": mxu.blocks, "device form": dev.blocks},
           "rounds": "+".join(f"{mxu.rounds.count(d)}x{d}" for d in (4, 2, 1)
                              if d in mxu.rounds),
           "loop_ms_per_step": loop, "device_ms_per_step": devms,
           "mxu_over_device_form": med[f"mxu G={MXU_G}"]
           / med[f"device form G={MXU_G}"],
           "plain_device_ms_per_step": plain,
           "state_finite_after_timing": bool(torch.isfinite(bufs[0]).all()),
           "method": "CUDA events; median over 10 batches of 200 steps "
                     "after one warm-up batch, configurations in turns "
                     "(forward, then reverse); device: queue pre-filled "
                     "behind a device sleep"}
    emit(out)
    check(out["state_finite_after_timing"], "mxu timing state not finite")
    del cells, bufs, mxu, dev, calls
    torch.cuda.empty_cache()
    script = harness_script("mxu_probe_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = script.main(["200", "--repeats", "2", "--plain-iters", "20",
                          "-o", str(MXU_PROBE_OUT)])
    check(rc == 0, f"mxu_probe_torch.py exit {rc}")
    summary = json.loads(buf.getvalue().splitlines()[-1])
    check(summary["mma_in_sass"] > 0 and summary["device_mxu"]["glups"] > 0,
          f"mxu probe: {summary}")
    emit({"phase": "mxu_timing", "script": "scripts/mxu_probe_torch.py",
          **{k: summary[k] for k in ("iters", "device_elementwise",
                                     "device_mxu", "mma_in_sass",
                                     "mxu_over_elementwise")}})
    out["device_ms"] = med[f"mxu G={MXU_G}"]
    out["device_form_ms"] = med[f"device form G={MXU_G}"]
    return out


def _cli(args, timeout=600, background=False):
    """``python -m lbm_tpu_torch`` in a subprocess of its own, the plan
    pins cleared: the finished run, or with ``background`` the running
    process."""
    clean = {k: v for k, v in os.environ.items()
             if k not in PLAN_ENV and k not in ("LBM_PAIRED_EQ", "LBM_OMEGA_EQ")}
    cmd = [sys.executable, "-m", "lbm_tpu_torch", *map(str, args)]
    if background:
        return subprocess.Popen(cmd, cwd=REPO, env=clean, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return subprocess.run(cmd, cwd=REPO, env=clean, text=True,
                          capture_output=True, timeout=timeout)


def _compute_s(stdout):
    return float(stdout.splitlines()[3].split()[-2])


def phase_resume(torch, np):
    """Chunked, checkpointed-and-resumed and preempted runs against the
    single-shot run of the same scene: byte-identical output files through
    the CLI, bit-identical arrays through run_simulation."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch import runner
    from lbm_tpu_torch.obstacles import generate_obstacles

    d = SCENE_DIR.parent / "resume"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    params, obs = scene_files()
    base_av = (SCENE_DIR / "auto_av_vels.dat").read_bytes()
    base_fs = (SCENE_DIR / "auto_final_state.dat").read_bytes()

    def outputs(tag):
        return d / f"av_{tag}.dat", d / f"fs_{tag}.dat"

    def run_cli(tag, *flags):
        av, fs = outputs(tag)
        t0 = time.perf_counter()
        res = _cli([params, obs, "--av-vels-file", av, "--final-state-file",
                    fs, *flags])
        check(res.returncode == 0, f"resume {tag}: CLI exit {res.returncode}: "
              f"{res.stderr[-400:]}")
        return res, time.perf_counter() - t0

    def same_files(tag):
        av, fs = outputs(tag)
        ok = av.read_bytes() == base_av and fs.read_bytes() == base_fs
        check(ok, f"resume {tag}: output files differ from the single-shot "
              "auto run's")
        return ok

    # (a) chunks of 3002 steps (even, no multiple of the plan's D = 4: each
    # chunk ends in a D = 2 launch, and every later launch sits two steps
    # off the single-shot run's) and a 1988-step tail.
    res, wall = run_cli("chunk", "--chunk-iters", "3002")
    emit({"phase": "resume", "case": "--chunk-iters 3002", "grid": SCENE,
          "steps": ITERS, "plan_line": res.stderr.strip().splitlines()[-1],
          "compute_s": _compute_s(res.stdout), "wall_s": wall,
          "files_byte_identical_to_single_shot": same_files("chunk")})

    # (b) half the run with two checkpoints, then the rest from the file.
    ck = d / "ck_b.npz"
    first, wall1 = run_cli("half", "--iters", "10000", "--checkpoint-every",
                           "5000", "--checkpoint-file", ck)
    second, wall2 = run_cli("resumed", "--resume", ck)
    step, ck_cells, _ = runner.load_checkpoint(ck)
    check(step == 10000 and ck_cells.shape == (9, *reversed(grid(SCENE))),
          f"checkpoint holds step {step}, cells {ck_cells.shape}")
    emit({"phase": "resume", "case": "--checkpoint-every 5000 to 10000, "
          "then --resume", "grid": SCENE, "steps": ITERS,
          "plan_lines": [first.stderr.strip().splitlines()[-1],
                         second.stderr.strip().splitlines()[-1]],
          "compute_s": [_compute_s(first.stdout), _compute_s(second.stdout)],
          "wall_s": [wall1, wall2], "checkpoint_bytes": ck.stat().st_size,
          "files_byte_identical_to_single_shot": same_files("resumed")})

    # (c) SIGTERM once the first checkpoint file exists.
    ck = d / "ck_c.npz"
    av, fs = outputs("preempted")
    proc = _cli([params, obs, "--av-vels-file", av, "--final-state-file", fs,
                 "--checkpoint-every", "2000", "--checkpoint-file", ck],
                background=True)
    t0 = time.perf_counter()
    while not ck.exists() and proc.poll() is None \
            and time.perf_counter() - t0 < 300:
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("the preempted CLI run did not stop")
    line = [ln for ln in stderr.splitlines() if ln.startswith("preempted")]
    check(proc.returncode == 75, f"preempted CLI exit {proc.returncode}: "
          f"{stderr[-400:]}")
    check(len(line) == 1 and f"resume with --resume {ck}" in line[0],
          f"preempted CLI stderr: {stderr[-400:]}")
    check("==done==" not in stdout and not av.exists() and not fs.exists(),
          "the preempted CLI run wrote final outputs")
    at = runner.load_checkpoint(ck)[0]
    check(f"preempted at step {at}/{ITERS}" in line[0] and 0 < at < ITERS,
          f"checkpoint at step {at}, stderr {line[0]}")
    _, wall = run_cli("after_sigterm", "--resume", ck)
    emit({"phase": "resume", "case": "--checkpoint-every 2000, SIGTERM, "
          "then --resume", "grid": SCENE, "steps": ITERS, "rc": 75,
          "stderr": line[0], "preempted_at": at, "resume_wall_s": wall,
          "files_byte_identical_to_single_shot": same_files("after_sigterm")})

    # Through run_simulation: the unsharded and the 4-shard single-shot
    # runs, then (d) the checkpointed half over 4 shards resumed both ways.
    p, mask = scene_params(), scene_mask()
    mesh = shard_mesh(torch, N_SHARDS)
    with env():
        base = runner.run_simulation(p, mask)
        av, fs = outputs("inproc")
        lio.write_av_vels(av, base.av_vels)
        lio.write_final_state(fs, p, base.cells, mask)
        same_files("inproc")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.save_checkpoint(d / "ck_time.npz", ITERS, base.cells,
                               base.av_vels)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner.load_checkpoint(d / "ck_time.npz")
        load_s = time.perf_counter() - t0
        base_x = runner.run_simulation(p, mask, mesh=mesh)
        ck = d / "ck_d.npz"
        half = runner.run_simulation(p, mask, mesh=mesh, n_iters=10000,
                                     checkpoint_every=5000, checkpoint_file=ck)
        again_x = runner.run_simulation(p, mask, mesh=mesh, resume_from=ck)
        again_1 = runner.run_simulation(p, mask, resume_from=ck)
    out = {
        "half_completed_steps": half.completed_steps,
        "sharded_resume_cells_equal_unsharded_single_shot":
            bool(np.array_equal(again_x.cells, base.cells)),
        "sharded_resume_av_vels_equal_sharded_single_shot":
            bool(np.array_equal(again_x.av_vels, base_x.av_vels)),
        "unsharded_resume_cells_equal_unsharded_single_shot":
            bool(np.array_equal(again_1.cells, base.cells)),
        "unsharded_resume_av_vels_equal_sharded_then_unsharded":
            bool(np.array_equal(again_1.av_vels[:10000], base_x.av_vels[:10000])
                 and np.array_equal(again_1.av_vels[10000:],
                                    base.av_vels[10000:])),
        "sharded_av_vels_bit_identical_to_unsharded":
            bool(np.array_equal(base_x.av_vels, base.av_vels)),
    }
    emit({"phase": "resume", "case": "4 shards on one card, checkpoint at "
          "10000, resumed over 4 shards and unsharded", "grid": SCENE,
          "steps": ITERS, **out, "save_s": save_s, "load_s": load_s,
          "checkpoint_bytes": (d / "ck_time.npz").stat().st_size,
          "half_compute_s_with_2_saves": half.timings["compute"]})
    check(half.completed_steps == 10000 and not half.preempted
          and all(v for k, v in out.items() if k.endswith("single_shot")
                  or k.endswith("then_unsharded")),
          f"sharded resume: {out}")
    del base, base_x, half, again_x, again_1

    # (e) the wide grid (transposed), unsharded and over 4 shards (x-plan).
    # A checkpoint at 248 and chunks of 100 keep every step at the same
    # stage of the same launch as in the single-shot run. A checkpoint at
    # 250 and chunks of 150 shift the launches by two steps and end chunks
    # in a D = 2 tail. Either way every bit of cells and av_vels is the
    # single-shot run's: the depth kernel sums a step's total over the
    # owned cells at a fixed place of the tile, the same at every stage
    # and under D = 2 and D = 4.
    from lbm_tpu_torch.parallel import halo

    nx, ny = grid(WIDE)
    iters = WIDE_GATE_ITERS
    p, mask = scene_params(WIDE, iters), generate_obstacles(nx, ny)
    out, av_diff = {}, {}
    with env():
        for tag, m in (("unsharded", None), ("x-plan", mesh)):
            segs = (runner.plan_run(p, "cuda", iters, device="cuda")
                    if m is None
                    else halo.plan_run(p, mask, m, "auto", iters).segments)
            depth = segs[0].steps_per_call
            check(len(segs) == 1 and depth > 1, f"wide plan {segs}")
            base = runner.run_simulation(p, mask, mesh=m)
            if m is None:
                base_cells = base.cells
            runs = {}
            for at, stride in ((248, 100), (250, 150)):
                ck = d / f"ck_wide_{tag}_{at}.npz"
                runner.run_simulation(p, mask, mesh=m, n_iters=at,
                                      checkpoint_every=at, checkpoint_file=ck)
                check(runner.load_checkpoint(ck)[1].shape == (9, ny, nx),
                      "a transposed run's checkpoint is not physical")
                runs[f"resumed from {at}"] = (at % depth == 0,
                    runner.run_simulation(p, mask, mesh=m, resume_from=ck))
                runs[f"chunks of {stride}"] = (stride % depth == 0,
                    runner.run_simulation(p, mask, mesh=m, chunk_iters=stride))
                if m is not None and at == 248:
                    # The x-plan's checkpoint resumed unsharded.
                    crossed = runner.run_simulation(p, mask, resume_from=ck)
                    out["x-plan crossed: cells"] = bool(
                        np.array_equal(crossed.cells, base_cells))
            for kind, (aligned, r) in runs.items():
                out[f"{tag} {kind}: cells"] = bool(
                    np.array_equal(r.cells, base_cells))
                rel = (np.abs(r.av_vels - base.av_vels)
                       / np.maximum(np.abs(base.av_vels), 1e-30))
                av_diff[f"{tag} {kind}"] = {
                    "launches_aligned": aligned,
                    "steps_that_differ": int(np.count_nonzero(rel)),
                    "max_rel_diff": float(rel.max())}
                out[f"{tag} {kind}: av_vels"] = bool(
                    np.array_equal(r.av_vels, base.av_vels))
    emit({"phase": "resume", "case": "checkpoint at 248 and at 250 of 500 and "
          "resume, chunks of 100 and of 150; unsharded (transposed) and over "
          "4 shards (x-plan)", "grid": WIDE, "steps": iters,
          "equal_to_single_shot": out, "av_vels": av_diff})
    check(all(out.values()), f"wide resume: {out} {av_diff}")
    del base, runs, base_cells
    torch.cuda.empty_cache()


DEBUG_GRID, DEBUG_ITERS = "128x128", 20


def _debug_block(np, text, iters):
    """The av values of a debug run's stdout, after checking that it is
    ``iters`` blocks of three lines in the reference's format."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("==timestep", "av velocity", "tot density"))]
    check(len(lines) == 3 * iters, f"{len(lines)} debug lines, not {3 * iters}")
    av = []
    for t in range(iters):
        a, b, c = lines[3 * t:3 * t + 3]
        check(a == "==timestep: %d==" % t, f"debug line {a!r}")
        check(b.startswith("av velocity: ") and c.startswith("tot density: "),
              f"debug lines {b!r}, {c!r}")
        for ln in (b, c):
            value = ln.split(": ")[1]
            check("%.12E" % float(value) == value, f"debug format {ln!r}")
        av.append(np.float32(float(b.split(": ")[1])))
        check(abs(float(c.split(": ")[1]) / (0.1 * 128 * 128) - 1) < 1e-3,
              f"debug density {c!r}")
    return np.array(av, np.float32)


def phase_debug(torch, np):
    """--debug through the CLI on the card and run_simulation(debug=True)
    over 4 shards: the reference's three lines per step, the av values
    those of the non-debug one-step plan (the kernel the debug loop
    steps)."""
    from lbm_tpu_torch import cli, runner
    from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles

    nx, ny = grid(DEBUG_GRID)
    iters = DEBUG_ITERS
    p, mask = scene_params(DEBUG_GRID, iters), generate_obstacles(nx, ny)
    d = SCENE_DIR.parent / "debug"
    d.mkdir(parents=True, exist_ok=True)
    (d / "s.params").write_text(f"{nx}\n{ny}\n{iters}\n10\n0.1\n0.01\n1.85\n")
    write_obstacles(d / "o.dat", mask)
    mesh = shard_mesh(torch, N_SHARDS)
    with env(LBM_PALLAS_DEPTH="1", LBM_RESIDENT="0"):
        plain = runner.run_simulation(p, mask)
        plain_x = runner.run_simulation(p, mask, mesh=mesh)
    for label, want, run in (
            ("CLI --debug", plain, lambda: cli.main(
                [str(d / "s.params"), str(d / "o.dat"), "--debug",
                 "--av-vels-file", str(d / "av.dat"),
                 "--final-state-file", str(d / "fs.dat")])),
            (f"run_simulation(debug=True) over {N_SHARDS} shards", plain_x,
             lambda: runner.run_simulation(p, mask, mesh=mesh, debug=True))):
        out, err = io.StringIO(), io.StringIO()
        with env(), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            got = run()
        av = _debug_block(np, out.getvalue(), iters)
        same = bool(np.array_equal(av, want.av_vels))
        cells = True
        if not isinstance(got, int):
            cells = bool(np.array_equal(got.cells, plain.cells))
            same = same and bool(np.array_equal(got.av_vels, want.av_vels))
        emit({"phase": "debug", "run": label, "grid": DEBUG_GRID,
              "steps": iters, "lines": 3 * iters,
              "plan_line": err.getvalue().strip(),
              "av_equal_to_the_one_step_plan": same,
              "cells_equal_to_the_unsharded_run": cells,
              "last_block": out.getvalue().splitlines()[3 * iters - 3:3 * iters]})
        check(got == 0 or not isinstance(got, int), f"{label}: exit {got}")
        check(same and cells, f"{label}: differs from the non-debug run")


TRACE_ITERS = 2000


def phase_trace(torch, np):
    """Traces of the 1024x1024 scene, TRACE_ITERS steps: under auto
    through the CLI's --trace, and over 4 shards under the seam plan and
    the ring through run_simulation(trace_dir=). Each summary holds the
    path's kernels by name with the plan's launches; the busy share and
    the idle gaps are printed."""
    from lbm_tpu_torch import cli, profiling, runner
    from lbm_tpu_torch.ops import resident
    from lbm_tpu_torch.parallel import halo

    nx, ny = grid(SCENE)
    iters = TRACE_ITERS
    p, mask = scene_params(iters=iters), scene_mask()
    params, obs = scene_files()
    root = SCENE_DIR.parent / "trace"
    shutil.rmtree(root, ignore_errors=True)
    mesh = shard_mesh(torch, N_SHARDS)
    results = {}
    for label, plan_env, m in (("auto", {}, None),
                               ("4 shards, seam", {}, mesh),
                               ("4 shards, ring", {"LBM_SHARD_RESIDENT": "1"},
                                mesh)):
        tdir = root / label.replace(" ", "_").replace(",", "")
        with env(**plan_env):
            if m is None:
                want = expected_launches(resident.segments(ny, nx, iters,
                                                           "cuda"))
                untraced = runner.run_simulation(p, mask)
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli.main([str(params), str(obs), "--iters", str(iters),
                                   "--trace", str(tdir), "--av-vels-file",
                                   str(root / "av.dat"), "--final-state-file",
                                   str(root / "fs.dat")])
                check(rc == 0, f"CLI --trace exit {rc}")
                traced_s = _compute_s(out.getvalue())
            else:
                sp = halo.plan_run(p, mask, m, "auto", iters)
                want = expected_shard_launches(sp.segments, m.size)
                untraced = runner.run_simulation(p, mask, mesh=m)
                traced = runner.run_simulation(p, mask, mesh=m, trace_dir=tdir)
                traced_s = traced.timings["compute"]
                check(np.array_equal(traced.cells, untraced.cells),
                      f"trace {label}: the traced run's cells differ")
        summary = profiling.summarise(str(tdir))
        got = profiling.launches(summary)
        expect = {}
        for key, n in want.items():
            if n:
                name = profiling.KERNEL_NAMES[key]
                expect[name] = expect.get(name, 0) + n
        print(profiling.format_summary(summary), flush=True)
        emit({"phase": "trace", "path": label, "grid": SCENE, "steps": iters,
              "env": plan_env, "expected_launches": expect,
              "traced_launches": {k: got.get(k, 0) for k in expect},
              "kernels": [{k: r[k] for k in ("name", "launches", "total_us",
                                             "mean_us", "pct_busy")}
                          for r in summary["kernels"][:8]],
              "device_events": summary["device_events"],
              "window_us": summary["window_us"], "busy_us": summary["busy_us"],
              "busy_share": summary["busy_share"],
              "idle_gaps": summary["idle_gaps"],
              "n_idle_gaps": summary["n_idle_gaps"],
              "compute_s_untraced": untraced.timings["compute"],
              "compute_s_traced": traced_s,
              "trace_bytes": Path(summary["trace_file"]).stat().st_size})
        for name, n in expect.items():
            check(got.get(name, 0) == n, f"trace {label}: {name} launched "
                  f"{got.get(name, 0)} times in the trace, the plan says {n}")
        check("reduce_tot_kernel" not in got or want["reduce"],
              f"trace {label}: a launch of the tot_u sum on a depth plan")
        check(summary["busy_share"] is not None
              and 0.0 < summary["busy_share"] <= 1.0,
              f"trace {label}: busy share {summary['busy_share']}")
        results[label] = summary["busy_share"]
    shutil.rmtree(root, ignore_errors=True)
    return results


HARNESS_DIR = REPO / "build" / "lbm_tpu_torch" / "harness"
WRITER_GRIDS = (SCENE, "16384x1024")


def same_bytes(a: Path, b: Path, chunk: int = 1 << 24) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def harness_script(name):
    """A module of ``scripts/`` (the port's harness scripts)."""
    import importlib

    if str(REPO / "scripts") not in sys.path:
        sys.path.insert(0, str(REPO / "scripts"))
    return importlib.import_module(name)


def phase_harness(torch, np):
    """The host writers at 1024x1024 and 16384x1024, and the harness
    scripts' paths on the card (see the module docstring, 21)."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.state import initial_state_np

    import dryrun_torch

    HARNESS_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(12)
    out = {}
    for name in WRITER_GRIDS:
        p = scene_params(name)
        nx, ny = grid(name)
        cells = initial_state_np(p) * (
            np.float32(0.9) + rng.random((9, ny, nx), dtype=np.float32)
            * np.float32(0.2))
        mask = scene_mask() if name == SCENE else generate_obstacles(nx, ny)
        files = HARNESS_DIR / "c.dat", HARNESS_DIR / "plain.dat"
        times = {}
        for label, writer, path in (("c", lio.write_final_state, files[0]),
                                    ("plain", lio.write_final_state_plain,
                                     files[1])):
            t0 = time.perf_counter()
            writer(path, p, cells, mask)
            times[label] = time.perf_counter() - t0
        size = files[0].stat().st_size
        equal = same_bytes(*files)
        for f in files:
            f.unlink()
        row = {"phase": "harness", "writer": "final_state.dat", "grid": name,
               "lines": nx * ny, "bytes": size, "equal_bytes": equal,
               "c_s": times["c"], "plain_s": times["plain"],
               "plain_over_c": times["plain"] / times["c"]}
        emit(row)
        check(equal, f"the C writer's {name} final_state.dat differs from "
              "the numpy writer's")
        out[name] = row
        del cells

    validate = harness_script("validate_scenes_torch")
    full = harness_script("full_scenes_torch")
    ab = harness_script("ab_kernel_torch")
    for label, mod, args in (
            ("validate_scenes_torch", validate, ["--scenes", "256x256"]),
            ("full_scenes_torch", full,
             ["--scenes", "2048x1024", "--iters", "2000"])):
        path = HARNESS_DIR / f"{label}.json"
        rc = mod.main([*args, "-o", str(path)])
        rows = json.loads(path.read_text())["scenes"]
        emit({"phase": "harness", "script": f"scripts/{label}.py",
              "rc": rc, "rows": rows})
        check(rc == 0 and rows and all(r["pass"] for r in rows),
              f"{label}: a row failed")
        out[label] = rows

    lines = dryrun_torch.dryrun_multichip(4, device="cuda")
    cases = dryrun_torch._dryrun_cases(4)
    emit({"phase": "harness", "script": "dryrun_torch.dryrun_multichip(4, "
          "device='cuda')", "ok": len(lines), "cases": len(cases)})
    check(len(lines) == len(cases), "dryrun: a case did not finish")

    cell = ab.run_one("1024sq-omega", 1024, 1024, 2000, {"LBM_OMEGA_EQ": "1"},
                      repeats=2)
    emit({"phase": "harness", "script": "scripts/ab_kernel_torch.py",
          **cell})
    check("error" not in cell and cell["glups"] > 0, "ab_kernel cell failed")
    shutil.rmtree(HARNESS_DIR, ignore_errors=True)
    return out


def reduce_bound(partials):
    """The reduce launch's bound: ``partials`` floats in, one out, one
    addition each (lbm_tpu_torch.profiling's data-sheet peaks)."""
    from lbm_tpu_torch.profiling import CHIP_PEAKS

    peaks = CHIP_PEAKS["h100"]
    t_bytes = 4 * (partials + 1) / peaks["hbm_bytes_per_s"]
    t_ops = partials / peaks["f32_ops_per_s"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_entry(name, source, replaces, launches, path, err, ms, plain_ms,
                 bnd, library_ms=None, ceiling=None, **more):
    """One kernel of the ``kernels`` line. ``bnd``: the function's bound
    (profiling.bound: the launch's bytes once, or its operations).
    ``ceiling``: for a kernel that keeps the lattice in device memory
    between its steps, what that design can reach
    (profiling.design_ceiling); ``bound_ms`` does not use it."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "path": path,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}
    if ceiling is not None:
        entry["design_ceiling_ms"] = ceiling[0]
    entry.update(more)
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    # Fails here, before any output, when the package is not beside this
    # script.
    from lbm_tpu_torch.ops import resident
    from lbm_tpu_torch.profiling import bound, design_ceiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    only = None
    if len(sys.argv) > 1:
        check(len(sys.argv) == 3 and sys.argv[1] == "--phases",
              "usage: chip_smoke.py [--phases name,name,...]")
        only = sys.argv[2].split(",")
    smi = phase_device(torch)
    phase_build()
    done = {}

    def run(name, fn, *args):
        """Phase ``name``, unless --phases leaves it out; its seconds."""
        if only is not None and name not in only:
            return None
        t0 = time.perf_counter()
        done[name] = fn(*args)
        torch.cuda.synchronize()
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t0})
        return done[name]

    worst, traj_launches = run("kernel", phase_kernel, torch) or (None, None)
    wide_worst = run("wide_kernel", phase_wide_kernel, torch)
    launches = run("scene", phase_scene, torch, np)
    onchip_runs = run("onchip_scene", phase_onchip_scene, torch, np)
    shift_runs = run("shift_scene", phase_shift_scene, torch, np)
    inplace = run("inplace_scene", phase_inplace_scene, torch, np)
    wide_runs = run("wide_gate", phase_wide_gate, torch, np)
    run("stress", phase_stress, torch)
    timing = run("timing", phase_timing, torch)
    wide_timing = run("wide_timing", phase_wide_timing, torch)
    onchip_timing = run("onchip_timing", phase_onchip_timing, torch)
    shard_worst = run("shard_kernel", phase_shard_kernel, torch)
    ring_worst = run("ring_onchip_kernel", phase_ring_onchip_kernel, torch)
    shard_launches = run("shard_scene", phase_shard_scene, torch, np)
    ring_scenes = run("ring_onchip_scene", phase_ring_onchip_scene, torch, np)
    wide_shard_launches = run("wide_shard", phase_wide_shard, torch, np)
    shard_timing = run("shard_timing", phase_shard_timing, torch, timing)
    wide_shard_timing = run("wide_shard_timing", phase_wide_shard_timing, torch)
    probe_worst = run("probe_kernel", phase_probe_kernel, torch)
    probe_launches = run("probe_path", phase_probe_path, torch)
    probe_timing = run("probe_timing", phase_probe_timing, torch)
    mxu_check = run("mxu_kernel", phase_mxu_kernel, torch, np)
    mxu_launches = run("mxu_scene", phase_mxu_scene, torch, np)
    mxu_timing = run("mxu_timing", phase_mxu_timing, torch)
    if launches is not None:
        run("resume", phase_resume, torch, np)
    run("debug", phase_debug, torch, np)
    run("trace", phase_trace, torch, np)
    run("harness", phase_harness, torch, np)
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "lbm_tpu" or m.startswith("lbm_tpu.")
                  for m in sys.modules), "the port imported lbm_tpu")

    if only is not None:
        print(smi, flush=True)
        emit({"partial": True, "phases": sorted(done)})
        return 0

    # Every kernel of the card's paths launched in the run of its path.
    runs = {"probe_full": probe_launches["probe_full"],
            "probe_collide": probe_launches["probe_collide"],
            "probe_stream": probe_launches["probe_stream"],
            "fused_step": launches["step"]["step"],
            # The tot_u sum: a launch of its own behind every one-step
            # launch (and the epilogue of every depth launch).
            "reduce_tot": launches["step"]["reduce"],
            # The one-round kernel's row-mode path under auto: the
            # 1024x1024 run's tail (TRAJ_STEPS steps through the runner);
            # the flow form's, the scene.
            "fused_depth": traj_launches["depth"],
            "fused_depth_flow": launches["auto"]["depth_flow"],
            "resident": launches["resident"]["resident"],
            # The shift mode's path under auto: the narrow channel's scene.
            "resident_shift": shift_runs["auto"]["auto"]["resident_shift"],
            "resident_onchip": onchip_runs["auto"]["resident_onchip"],
            # 200 steps of 400x1024 through the runner under auto (row
            # mode), and the 1024x512 scene (transposed, column mode).
            "resident_onchip_inplace": onchip_timing[INPLACE_ROW_GRID][
                "launches"].get("resident_onchip_inplace", 0),
            "resident_onchip_inplace_cols": inplace["launches"]["auto"][
                "resident_onchip_inplace_cols"],
            "fused_step_seam": shard_launches["step"]["step_seam"],
            "fused_depth_seam": shard_launches["auto"]["depth_seam"],
            "ring": shard_launches["ring"]["ring"],
            "fused_step_cols": wide_runs[(WIDE, "step")]["step_cols"],
            "fused_depth_cols": wide_runs[(WIDE, "auto")]["depth_cols"],
            "resident_cols": wide_runs[(WIDE, "resident")]["resident_cols"],
            "fused_step_seam_cols": wide_shard_launches["step"]["step_seam_cols"],
            "fused_depth_seam_cols":
                wide_shard_launches["auto"]["depth_seam_cols"],
            "ring_cols": wide_shard_launches["ring"]["ring_cols"],
            # The on-chip ring's scenes under auto (LBM_SHARD_RESIDENT=1).
            "ring_onchip": ring_scenes["512x512"]["launches"].get(
                "ring_onchip", 0),
            "ring_onchip_cols": ring_scenes[WIDE_LIMIT]["launches"].get(
                "ring_onchip_cols", 0),
            "ring_onchip_inplace": ring_scenes["768x768"]["launches"].get(
                "ring_onchip_inplace", 0),
            "ring_onchip_inplace_cols": ring_scenes[INPLACE_SCENE][
                "launches"].get("ring_onchip_inplace_cols", 0),
            # The 1024x1024 scene through MxuStep.
            "mxu": mxu_launches["mxu"]}
    for kname, n in runs.items():
        check(n > 0, f"{kname} was not launched on its path")
    t = timing[SCENE]
    dev = {k: statistics.median(v) for k, v in t["device_ms_per_step"].items()}
    plain = statistics.median(t["plain_device_ms_per_step"])
    # The on-chip resident form: its scene and its timing grid.
    ot = timing[ONCHIP_SCENE]
    onx, ony = grid(ONCHIP_SCENE)
    ocells = onx * ony
    oworst = max(worst["resident_onchip"], wide_worst["resident_onchip"])
    # The shift mode: its timing as auto runs its scene's lattice.
    sh = onchip_timing[SHIFT_AUTO_SCENE]
    shx, shy = grid(SHIFT_AUTO_SCENE)
    shmed = {k: statistics.median(v)
             for k, v in sh["device_ms_per_step"].items()}
    # The single-buffer mode: its row and column paths.
    irow = onchip_timing[INPLACE_ROW_GRID]
    inx, iny = grid(INPLACE_ROW_GRID)
    snx, sny = grid(INPLACE_SCENE)
    st = shard_timing[SCENE]
    sdev = {k: statistics.median(v) for k, v in st["device_ms_per_step"].items()}
    sloop = {k: statistics.median(v) for k, v in st["loop_ms_per_step"].items()}
    sd = st["ring_depths"]["ring G=100"]
    splain = st["plain_device_ms_per_step"]
    nx, ny = grid(SCENE)
    cells = nx * ny
    partials = (nx // 32) * (ny // 8)
    # Halo rows in per call over 4 shards: k rows each side, 37 B a cell.
    halo_bytes = lambda k: N_SHARDS * 2 * k * nx * 37
    on_scene = f"{SCENE} scene"
    sharded = f"{SCENE} scene over {N_SHARDS} shards on one card"
    # The column modes: times on the transposed lattice of 131072x128,
    # bounds on the same cells.
    wnx, wny = grid(WIDE)
    wcells = wnx * wny
    wt = wide_timing[WIDE]
    wdev = {k: statistics.median(v) for k, v in wt["device_ms_per_step"].items()}
    wst = wide_shard_timing[WIDE]
    wsdev = {k: statistics.median(v)
             for k, v in wst["device_ms_per_step"].items()}
    wsloop = {k: statistics.median(v)
              for k, v in wst["loop_ms_per_step"].items()}
    wsr = wst["ring_depths"]["x-plan ring G=100"]
    wsplain = wst["plain_x_plan_device_ms_per_step"]
    wd = wide_auto_depth(WIDE)
    wsd = wide_auto_depth(WIDE, N_SHARDS)
    # x-plan halo rows: k rows each side of every shard, wny cells each.
    whalo_bytes = lambda k: N_SHARDS * 2 * k * wny * 37
    on_wide = f"{WIDE} (transposed)"
    wide_sharded = f"{WIDE} over {N_SHARDS} shards on one card (x-plan)"
    # The device-memory form's rounds at G=100: one pass over the lattice
    # a round is its design's ceiling.
    g_rounds = resident.device_rounds(100)
    per_pass = 100 / len(g_rounds)
    rounds = "+".join(f"{g_rounds.count(d)}x{d}" for d in (4, 2, 1)
                      if d in g_rounds)
    # The on-chip ring: its scenes' launches, its timing rows' times (the
    # planned form at each scene's grid) and plain shard steps; its strips
    # never leave the chip, so its ceiling is its bound.
    ro = shard_timing["ring_onchip"]

    def ring_onchip_entry(name, key, replaces, grid_name, form):
        row = ro[grid_name]
        label = f"ring G=100 {form}"
        gx, gy = grid(grid_name)
        sc = ring_scenes[grid_name]
        return kernel_entry(
            name, "lbm_tpu_torch/csrc/ring_onchip.cu", replaces, runs[key],
            f"{grid_name} over {N_SHARDS} shards on one card, "
            f"LBM_SHARD_RESIDENT=1 ({sc['describe']}), {sc['steps']} steps",
            ring_worst[key], statistics.median(row["device_ms_per_step"][label]),
            row["plain_device_ms_per_step"], bound(gx * gy, 100),
            ceiling=design_ceiling(gx * gy, 100, on_chip=True),
            loop_ms=statistics.median(row["loop_ms_per_step"][label]),
            device_ring_ms=statistics.median(
                row["device_ms_per_step"]["ring G=100 device"]),
            seam_d4_ms=statistics.median(
                row["device_ms_per_step"]["seam D=4"]))

    pt = probe_timing[SCENE]
    pdev = {k: statistics.median(v) for k, v in pt["device_ms_per_step"].items()}
    # Every mode's window loads the mask (73 B a cell); the stream mode
    # adds once a cell (its total).
    probe_cost = {"full": {}, "collide": {}, "stream": {"ops_per_cell": 1}}
    emit({"kernels": [
        kernel_entry("fused_step", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:205", runs["fused_step"],
                     f"{on_scene}, one-step plan", worst["fused_step"],
                     dev["step"], plain, bound(cells, 1)),
        kernel_entry("reduce_tot", "lbm_tpu_torch/csrc/lbm_reduce.cuh",
                     "lbm_tpu/ops/pallas_fused.py:396", runs["reduce_tot"],
                     f"{on_scene}, one-step plan (a launch of its own)",
                     t["reduce_abs_err"],
                     t["reduce_device_ms"], t["reduce_plain_device_ms"],
                     reduce_bound(partials),
                     library_ms=t["reduce_plain_device_ms"]),
        # Its tot_u sum is its own epilogue, held against torch.sum of the
        # launch's partials.
        kernel_entry("fused_depth", "lbm_tpu_torch/csrc/fused_depth.cu",
                     "lbm_tpu/ops/pallas_fused.py:653", runs["fused_depth"],
                     f"{SCENE}, auto, {TRAJ_STEPS} steps through the runner "
                     "(the one-round D=4 tail)", worst["depth"],
                     dev["depth D=4"], plain, bound(cells, 4),
                     epilogue_sum_abs_err=t["epilogue_abs_err"]),
        # One launch of FLOW_ROUNDS rounds of D=4, a pass over the lattice
        # a round; each round summed by its last block.
        kernel_entry("fused_depth_flow",
                     "lbm_tpu_torch/csrc/fused_depth_flow.cu",
                     "lbm_tpu/ops/pallas_fused.py:653",
                     runs["fused_depth_flow"],
                     f"{on_scene}, auto (D=4 K={FLOW_ROUNDS})",
                     max(worst["depth_flow"], wide_worst["depth_flow"]),
                     dev[FLOW_LABEL], plain, bound(cells, 4 * FLOW_ROUNDS),
                     ceiling=design_ceiling(cells, 4 * FLOW_ROUNDS,
                                            steps_per_pass=4),
                     one_round_ms=dev["depth D=4"]),
        kernel_entry("resident", "lbm_tpu_torch/csrc/resident.cu",
                     "lbm_tpu/ops/pallas_resident.py:74", runs["resident"],
                     f"{on_scene}, LBM_RESIDENT=1 LBM_RESIDENT_FORM=device "
                     f"(G=100, rounds {rounds})", worst["resident"],
                     dev["resident G=100"], plain,
                     bound(cells, 100),
                     ceiling=design_ceiling(cells, 100,
                                            steps_per_pass=per_pass)),
        # The device form's shift mode: its cells in shared memory at this
        # size (its ceiling is its bound); in device memory a pass over
        # the lattice a step.
        kernel_entry("resident_shift", "lbm_tpu_torch/csrc/resident.cu",
                     "lbm_tpu/ops/pallas_resident.py:142",
                     runs["resident_shift"],
                     f"{SHIFT_AUTO_SCENE} scene, auto (G=100 device-memory "
                     f"shift), {SHIFT_AUTO_ITERS} steps",
                     max(worst["resident_shift"], sh["max_abs_err_vs_plain"]),
                     shmed["device shift"], sh["plain_device_ms_per_step"],
                     bound(shx * shy, 100),
                     ceiling=design_ceiling(
                         shx * shy, 100, steps_per_pass=1,
                         on_chip=sh["shift_residence"] == "shared"),
                     residence=sh["shift_residence"],
                     device_form_ms=shmed["device"],
                     depth4_ms=shmed["depth D=4"]),
        kernel_entry("resident_onchip", "lbm_tpu_torch/csrc/resident_onchip.cu",
                     "lbm_tpu/ops/pallas_resident.py:74",
                     runs["resident_onchip"],
                     f"{ONCHIP_SCENE} reference scene, auto (G=100 on-chip)",
                     oworst,
                     statistics.median(
                         ot["device_ms_per_step"]["resident G=100 on-chip"]),
                     statistics.median(ot["plain_device_ms_per_step"]),
                     bound(ocells, 100),
                     ceiling=design_ceiling(ocells, 100, on_chip=True)),
        # The on-chip form's single-buffer mode; its strips never leave
        # the chip either.
        kernel_entry("resident_onchip_inplace",
                     "lbm_tpu_torch/csrc/resident_onchip.cu",
                     "lbm_tpu/ops/pallas_resident.py:217",
                     runs["resident_onchip_inplace"],
                     f"{INPLACE_ROW_GRID}, auto, {2 * 100} steps through the "
                     "runner (G=100 on-chip 1-buf)",
                     max(worst["resident_onchip_inplace"],
                         irow["max_abs_err_vs_plain"]),
                     statistics.median(
                         irow["device_ms_per_step"]["on-chip 1-buf"]),
                     irow["plain_device_ms_per_step"],
                     bound(inx * iny, 100),
                     ceiling=design_ceiling(inx * iny, 100, on_chip=True)),
        kernel_entry("resident_onchip_inplace_cols",
                     "lbm_tpu_torch/csrc/resident_onchip.cu",
                     "lbm_tpu/ops/pallas_resident.py:217",
                     runs["resident_onchip_inplace_cols"],
                     f"{INPLACE_SCENE} scene (transposed), auto (G=100 "
                     "on-chip 1-buf)",
                     max(worst["resident_onchip_inplace_cols"],
                         wide_worst["resident_onchip_inplace"]),
                     inplace["device_ms"], inplace["plain_ms"],
                     bound(snx * sny, 100),
                     ceiling=design_ceiling(snx * sny, 100, on_chip=True)),
        kernel_entry("fused_step_seam", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:205", runs["fused_step_seam"],
                     f"{sharded}, one-step plan", shard_worst["step_seam"],
                     sdev["seam D=1"], splain,
                     bound(cells, 1, halo_bytes(1)), loop_ms=sloop["seam D=1"],
                     wrap_path_ms=statistics.median(
                         shard_timing[WRAP_GRID]["device_ms_per_step"][
                             "seam D=1"])),
        kernel_entry("fused_depth_seam", "lbm_tpu_torch/csrc/fused_depth.cu",
                     "lbm_tpu/ops/pallas_fused.py:653",
                     runs["fused_depth_seam"], f"{sharded}, auto (D=4)",
                     shard_worst["depth_seam"], sdev["seam D=4"], splain,
                     bound(cells, 4, halo_bytes(4))),
        # The ring steps D at a time in shared memory: one pass over the
        # lattice per round is its design's ceiling.
        kernel_entry("ring", "lbm_tpu_torch/csrc/ring.cu",
                     "lbm_tpu/parallel/resident_ring.py:241", runs["ring"],
                     f"{sharded}, LBM_SHARD_RESIDENT=1 (G=100, D={sd})",
                     shard_worst["ring"], sdev["ring G=100"], splain,
                     bound(cells, 100),
                     ceiling=design_ceiling(cells, 100, steps_per_pass=sd),
                     depth=sd, loop_ms=sloop["ring G=100"]),
        kernel_entry("fused_step_cols", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:358", runs["fused_step_cols"],
                     f"{on_wide}, one-step plan", wide_worst["fused_step"],
                     wdev["transposed step"],
                     wt["plain_transposed_device_ms_per_step"],
                     bound(wcells, 1)),
        kernel_entry("fused_depth_cols", "lbm_tpu_torch/csrc/fused_depth.cu",
                     "lbm_tpu/ops/pallas_fused.py:804",
                     runs["fused_depth_cols"], f"{on_wide}, auto (D={wd})",
                     wide_worst["depth"], wdev[f"transposed depth D={wd}"],
                     wt["plain_transposed_device_ms_per_step"],
                     bound(wcells, wd)),
        kernel_entry("resident_cols", "lbm_tpu_torch/csrc/resident.cu",
                     "lbm_tpu/ops/pallas_resident.py:123",
                     runs["resident_cols"],
                     f"{on_wide}, LBM_RESIDENT=1 (G=100)",
                     wide_worst["resident"], wdev["transposed resident G=100"],
                     wt["plain_transposed_device_ms_per_step"],
                     bound(wcells, 100),
                     ceiling=design_ceiling(wcells, 100,
                                            steps_per_pass=per_pass)),
        kernel_entry("fused_step_seam_cols", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:358",
                     runs["fused_step_seam_cols"], f"{wide_sharded}, one-step "
                     "plan", shard_worst["step_seam_cols"],
                     wsdev["x-plan seam D=1"], wsplain,
                     bound(wcells, 1, whalo_bytes(1)),
                     loop_ms=wsloop["x-plan seam D=1"]),
        kernel_entry("fused_depth_seam_cols",
                     "lbm_tpu_torch/csrc/fused_depth.cu",
                     "lbm_tpu/ops/pallas_fused.py:804",
                     runs["fused_depth_seam_cols"],
                     f"{wide_sharded}, auto (D={wsd})",
                     shard_worst["depth_seam_cols"],
                     wsdev[f"x-plan seam D={wsd}"], wsplain,
                     bound(wcells, wsd, whalo_bytes(wsd))),
        kernel_entry("ring_cols", "lbm_tpu_torch/csrc/ring.cu",
                     "lbm_tpu/parallel/resident_ring.py:280", runs["ring_cols"],
                     f"{wide_sharded}, LBM_SHARD_RESIDENT=1 (G=100, D={wsr})",
                     shard_worst["ring_cols"], wsdev["x-plan ring G=100"],
                     wsplain, bound(wcells, 100),
                     ceiling=design_ceiling(wcells, 100, steps_per_pass=wsr),
                     depth=wsr, loop_ms=wsloop["x-plan ring G=100"]),
        ring_onchip_entry("ring_onchip", "ring_onchip",
                          "lbm_tpu/parallel/resident_ring.py:241", "512x512",
                          "onchip"),
        ring_onchip_entry("ring_onchip_cols", "ring_onchip_cols",
                          "lbm_tpu/parallel/resident_ring.py:280", WIDE_LIMIT,
                          "onchip"),
        ring_onchip_entry("ring_onchip_inplace", "ring_onchip_inplace",
                          "lbm_tpu/parallel/resident_ring.py:404", "768x768",
                          "inplace"),
        ring_onchip_entry("ring_onchip_inplace_cols",
                          "ring_onchip_inplace_cols",
                          "lbm_tpu/parallel/resident_ring.py:404",
                          INPLACE_SCENE, "inplace"),
        # The probe: its launches are the probe script's run; a launch
        # moves the lattice once for its G steps. It runs the device-memory
        # resident form's rounds, so one pass over the lattice a round is
        # its design's ceiling, as that form's.
        *(kernel_entry(f"probe_{m}", "lbm_tpu_torch/csrc/probe.cu",
                       "scripts/stream_cost_probe.py:53", runs[f"probe_{m}"],
                       f"scripts/stream_cost_probe_torch.py at {SCENE} "
                       f"(times: G={PROBE_TIMING_G}, rounds {rounds})",
                       probe_worst[m], pdev[f"probe {m}"],
                       pt["plain_device_ms_per_step"][m],
                       bound(cells, PROBE_TIMING_G, **probe_cost[m]),
                       ceiling=design_ceiling(cells, PROBE_TIMING_G,
                                              steps_per_pass=per_pass,
                                              **probe_cost[m]),
                       blocks=pt["blocks"][m])
          for m in ("full", "collide", "stream")),
        # The tensor-core equilibrium: the device form's rounds and work
        # (its bound and ceiling are that form's: a bound reads the work,
        # not the unit that does it); its error against the plain version
        # is within mxu_eq.cells_atol, not 0 (the tensor cores' sums).
        kernel_entry("mxu_resident_kernel", "lbm_tpu_torch/csrc/mxu_eq.cu",
                     "scripts/mxu_probe.py:80", runs["mxu"],
                     f"{SCENE} scene through ops.mxu_eq.MxuStep (G={MXU_G}, "
                     f"rounds {rounds}), {ITERS} steps",
                     mxu_check["max_abs_err"], mxu_timing["device_ms"],
                     mxu_timing["plain_device_ms_per_step"],
                     bound(cells, MXU_G),
                     ceiling=design_ceiling(cells, MXU_G,
                                            steps_per_pass=per_pass),
                     cells_atol=mxu_check["cells_atol"],
                     mma_in_sass=mxu_check["mma_in_sass"],
                     device_form_ms=mxu_timing["device_form_ms"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
