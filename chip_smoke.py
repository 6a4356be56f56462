#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (lbm_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Grids are named NXxNY, as the repository names them (``Params(nx=...,
ny=...)``): 131072x128 is 131072 columns by 128 rows. Phases, each
printing JSON lines (any failure raises and exits non-zero):

1. device  - the card (nvidia-smi name and power limit), torch, CUDA;
2. build   - nvcc builds lbm_tpu_torch/csrc/*.cu (one nvcc per source,
             in parallel) into build/lbm_tpu_torch/;
3. kernel  - every kernel against its plain PyTorch version on the card,
             one line per grid: the one-step kernel for one step, the
             depth kernel for one call at D = 2, 4, 8 and the resident
             kernel for one call at G = 16, against n steps of the plain
             version, at 1024x1024 (scene mask), 128x128 (and an odd
             G = 5 there), a ragged 100x130 wall-less mask, 16384x1024,
             131072x128 (the stress scene's orientation) and 128x131072
             (transposed); all three BGK associations at 256x256; then
             200 steps at 1024x1024 of every kernel through the runner
             against the one-step kernel, with bit-identical repeats;
4. scene   - the reference's 1024x1024 scene (20000 steps) through the
             port's CLI, once per plan: --kernel auto, the one-step
             kernel pinned (LBM_RESIDENT=0 LBM_PALLAS_DEPTH=1), the
             resident kernel forced (LBM_RESIDENT=1) and a depth pinned
             (LBM_RESIDENT=0 LBM_PALLAS_DEPTH=...). Launch counts equal
             the plan's, and each run is within the 0.3 % drift budget
             of goldens/1024x1024.final_state.f64.npz;
5. stress  - 16384x1024 with generated walls and the scene's forcing,
             2000 steps through the runner: every depth and the resident
             kernel against the one-step kernel;
6. timing  - per-step time of every kernel configuration at 128x128,
             256x256, 512x512, 1024x1024 and 16384x1024 with CUDA
             events, as the runner drives them and as device time alone
             (the numbers the planner's automatic choice is set from);
             the plain version at 1024x1024;
7. shard_kernel - the row-sharded path's kernels, one call on every
             shard against the plain shard step (halo.ReferenceShardImpl)
             on the same inputs: the one-step kernel's seam mode, the
             depth kernel's seam mode at each D every shard can hold, and
             the ring kernel at G = 16, at 1024x1024 (scene mask),
             16384x1024 and a walled 1024x1022 (wall pad 2) over 4 shards
             on one card, a wall-less 100x130 over 4 (wrap pad 2, one-step
             only) and 16x16 over 8 (the forced row on a shard edge);
8. shard_scene - the 1024x1024 scene through run_simulation(mesh=) over
             4 shards on one card, once per plan (auto: seam depth D=4;
             ring: LBM_SHARD_RESIDENT=1; step: LBM_PALLAS_DEPTH=1), each
             within the drift budget, bit-identical to the unsharded auto
             run, with the plan's launch counts; the CLI with --devices 4
             (its clamp note on a one-card machine); then a cross_card
             line: the auto and ring runs across min(4, cards) cards, or
             ``"run": false`` on one card;
9. shard_timing - per-step time of the seam kernels (D = 1, 2, 4, 8) and
             the ring (G = 16, 100) over 4 shards on one card at 1024x1024
             and 16384x1024, beside the unsharded best; the halo copies
             alone; the plain shard step at 1024x1024.

Then the kernels line (every kernel with its launches on its path, error
against its plain version, time, plain time and bound), the nvidia-smi
line, and a last line ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits 2 before printing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
            "LBM_SHARD_RESIDENT")
DEPTHS = (2, 4, 8)
KERNEL_G = 16
# Kernel-phase grids (NXxNY) and their masks: the scene's, the
# generator's walls, or random and wall-less (periodic in both axes).
KERNEL_CASES = [("1024x1024", "scene"), ("128x128", "walls"),
                ("100x130", "random"), ("16384x1024", "walls"),
                ("131072x128", "walls"), ("128x131072", "walls")]
STRESS, STRESS_ITERS = "16384x1024", 2000
TRAJ_STEPS = 200
TIMING_GRIDS = ("128x128", "256x256", "512x512", "1024x1024", "16384x1024")
# Plans driven through the CLI on the scene; the depth pin is the depth
# auto does not take at 1024x1024, so the scene runs every kernel.
SCENE_PLANS = {
    "auto": {},
    "step": {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "1"},
    "resident": {"LBM_RESIDENT": "1"},
    "depth": {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "8"},
}


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


def scene_params(name=SCENE, iters=ITERS):
    from lbm_tpu_torch.params import Params

    nx, ny = grid(name)
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.01, omega=1.85)


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


def compare_kernels(torch, name, kind, p, seed, odd_g=False):
    """Every kernel against n plain steps: the one-step kernel for one
    step of a uniform state, the many-step kernels for one call on a
    perturbed one (same seed, same mask)."""
    from lbm_tpu_torch.ops import fused, fused_depth, resident
    from lbm_tpu_torch.ops import reference as ref_ops

    cells, mask = random_case(torch, name, p, seed, kind, "uniform")
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    res = {}
    got, tot = fused.fused_step(cells, *args)
    want, want_tot = ref_ops.fused_step(cells, *args)
    res["fused_step"] = compare(torch, got, tot[None], want, want_tot[None])
    del cells, got, want

    cells, _ = random_case(torch, name, p, seed, kind, "perturbed")
    keep = {*DEPTHS, KERNEL_G} | ({5} if odd_g else set())
    plain, tots, c = {}, [], cells
    for n in range(1, max(keep) + 1):
        c, tot = ref_ops.fused_step(c, *args)
        tots.append(tot)
        if n in keep:
            plain[n] = c
    tots = torch.stack(tots)
    for d in DEPTHS:
        got, t = fused_depth.fused_depth(cells, *args, d)
        res[f"depth D={d}"] = compare(torch, got, t, plain[d], tots[:d])
    for g in sorted(keep - set(DEPTHS)):
        got, t = resident.resident(cells, *args, g)
        res[f"resident G={g}"] = compare(torch, got, t, plain[g], tots[:g])
    return res


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


def phase_build():
    from lbm_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load()
    log = path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln
             ] if log.exists() else []
    emit({"phase": "build", "seconds": seconds, "library": str(path.name),
          "sources": [s.name for s in _build.sources()],
          "nvcc_flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas})


def phase_kernel(torch):
    from lbm_tpu_torch.runner import simulate
    from lbm_tpu_torch.state import initial_state

    worst = {}

    def record(res, where):
        for name, r in res.items():
            kernel = name.split()[0]
            worst[kernel] = max(worst.get(kernel, 0.0), r["max_abs_err"])
            check(r["cells_ok"] and r["tot_ok"], f"{name} != plain at {where}")

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

    # TRAJ_STEPS steps of each plan through the runner, twice, against
    # the one-step kernel and the plain version.
    n = TRAJ_STEPS
    p = scene_params(iters=n)
    mask = torch.from_numpy(scene_mask()).cuda()
    c0 = initial_state(p, "cuda")
    with env():
        cr, ar = simulate(p, c0, mask, kernel="reference", n_iters=n)
    runs = {}
    plans = {"step": SCENE_PLANS["step"], "resident": SCENE_PLANS["resident"],
             **{f"depth D={d}": {"LBM_RESIDENT": "0",
                                 "LBM_PALLAS_DEPTH": str(d)} for d in DEPTHS}}
    for label, plan_env in plans.items():
        with env(**plan_env):
            ck, ak = simulate(p, c0, mask, kernel="cuda", n_iters=n)
            ck2, ak2 = simulate(p, c0, mask, kernel="cuda", n_iters=n)
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
    return worst


def expected_launches(parts):
    """Launch counts a planned run must show, per kernel."""
    n = {"step": 0, "reduce": 0, "depth": 0, "resident": 0, "step_seam": 0,
         "depth_seam": 0, "ring": 0}
    for seg in parts:
        n[seg.kernel] += seg.launches
        if seg.kernel in ("step", "depth"):
            n["reduce"] += seg.launches
    return n


def phase_scene(torch, np):
    from lbm_tpu_torch import cli
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import write_obstacles
    from lbm_tpu_torch.ops import fused, plan

    golden = np.load(GOLDEN)
    nx, ny = grid(SCENE)
    mask = scene_mask()
    check(np.array_equal(mask, golden["u"].reshape(ny, nx) == 0),
          "scene mask differs from the golden's zero-velocity cells")
    SCENE_DIR.mkdir(parents=True, exist_ok=True)
    params, obs = SCENE_DIR / "input_1024x1024.params", SCENE_DIR / "obstacles.dat"
    av_file, fs_file = SCENE_DIR / "av_vels.dat", SCENE_DIR / "final_state.dat"
    params.write_text(f"{nx}\n{ny}\n{ITERS}\n10\n0.1\n0.01\n1.85\n")
    write_obstacles(obs, mask)

    per_plan = {}
    for label, plan_env in SCENE_PLANS.items():
        with env(**plan_env):
            parts = plan.segments(ny, nx, ITERS)
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
            check(launches[seg.kernel] > 0, f"{label}: {seg.kernel} idle")
        per_plan[label] = launches
        check(lines[0] == "==done==", "stdout contract")
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


def phase_stress(torch):
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import simulate
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
            parts = plan.segments(ny, nx, STRESS_ITERS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cells, av = simulate(p, c0, mask, kernel="cuda")
            seconds = time.perf_counter() - t0
        check(bool(torch.isfinite(cells).all()), f"stress {label} not finite")
        out = {"phase": "stress", "grid": STRESS, "plan": label,
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
                     **{f"resident G={g}": resident.Resident(*w, g)
                        for g in (16, 100)}}

        def caller(impl):
            def fn():
                # As the runner drives it: the result becomes the input.
                bufs[:] = impl.run(bufs[0], bufs[1], av, 0, 1.0)
            return fn

        order = list(impls) + list(reversed(impls))
        loop, dev = {}, {}
        for label in order:
            impl = impls[label]
            loop.setdefault(label, []).append(
                _median_ms(torch, caller(impl), impl.steps_per_call, False)[0])
        for label in order:
            impl = impls[label]
            dev.setdefault(label, []).append(
                _median_ms(torch, caller(impl), impl.steps_per_call, True)[0])
        out = {"phase": "timing", "grid": name,
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "method": "CUDA events; median over 10 batches of ~200 steps "
                         "after one warm-up batch, configurations in turns "
                         "(forward, then reverse); device: queue pre-filled "
                         "behind a device sleep"}
        if name == SCENE:
            st = impls["step"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                st.run(bufs[0], bufs[1], av, 0, 1.0)
            out["host_enqueue_us_per_step"] = (time.perf_counter() - t0) / 200 * 1e6

            def plain_step():
                new, tot = ref_ops.fused_step(bufs[0], *w)
                av[0] = tot

            def reduce_only():
                st._reduce(st._partials, 1, av, 0, 1.0)

            def reduce_plain():
                av[0] = st._partials.sum()

            out["plain_loop_ms_per_step"] = [
                _median_ms(torch, plain_step, 1, False, steps=20)[0]]
            out["plain_device_ms_per_step"] = [
                _median_ms(torch, plain_step, 1, True, steps=20)[0]]
            out["reduce_device_ms"] = _median_ms(torch, reduce_only, 1, True)[0]
            out["reduce_plain_device_ms"] = _median_ms(
                torch, reduce_plain, 1, True)[0]
            torch.cuda.synchronize()
            st._reduce(st._partials, 1, av, 0, 1.0)
            out["reduce_abs_err"] = abs(float(av[0]) - float(st._partials.sum()))
        emit(out)
        results.append(out)
        del cells, bufs, impls
        torch.cuda.empty_cache()
    return {r["grid"]: r for r in results}


# The sharded path: P shards on one card (a mesh that repeats the device),
# or across cards where the machine has more than one.
SHARD_G = 16
SHARD_CASES = [("1024x1024", "scene", 4), ("16384x1024", "walls", 4),
               ("100x130", "random", 4), ("1024x1022", "walls", 4),
               ("16x16", "walls", 8)]
SHARD_SCENE_PLANS = {
    "auto": {},
    "ring": {"LBM_SHARD_RESIDENT": "1"},
    "step": {"LBM_PALLAS_DEPTH": "1"},
}
SHARD_TIMING_GRIDS = ("1024x1024", "16384x1024")
N_SHARDS = 4


def shard_mesh(torch, n, cards=1):
    from lbm_tpu_torch.parallel import decomp

    devices = [torch.device("cuda", i % cards) for i in range(n)]
    return decomp.make_mesh(n, devices=devices)


def shard_case(torch, name, kind, n, seed):
    """The perturbed kernel-phase state of grid ``name`` over ``n``
    shards on one card, padded as the planner pads it: ``(plan, cells,
    mesh)``."""
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.state import initial_state

    p = scene_params(name, iters=200)
    cells, mask = random_case(torch, name, p, seed, kind, "perturbed")
    mesh = shard_mesh(torch, n)
    sp = halo.plan_run(p, mask.cpu().numpy(), mesh, "cuda", SHARD_G)
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
    shard steps on the same inputs."""
    from lbm_tpu_torch.parallel import halo, resident_ring

    worst = {}
    for i, (name, kind, n) in enumerate(SHARD_CASES):
        sp, cells, mesh = shard_case(torch, name, kind, n, seed=20 + i)
        h = sp.decomp.local_ny
        kinds = [("step_seam", 1)]
        if not sp.wrap_pad:
            kinds += [("depth_seam", d) for d in DEPTHS if d <= h]
            kinds += [("ring", SHARD_G)]
        res = {}
        with env():
            for key, size in kinds:
                ss = halo.ShardSet(sp.params, cells, sp.obstacles, mesh, SHARD_G)
                plain = halo.ShardSet(sp.params, cells, sp.obstacles, mesh,
                                      SHARD_G)
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
                label = {"step_seam": "step", "depth_seam": f"depth D={size}",
                         "ring": f"ring G={size}"}[key]
                res[label] = r
                worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
                check(r["cells_ok"] and r["tot_ok"],
                      f"{label} != plain at {name} over {n}")
                del ss, plain, impl, got, want, err
        emit({"phase": "shard_kernel", "grid": name, "shards": n,
              "rows_per_shard": h, "pad": f"{sp.mode} {sp.pad}", "mask": kind,
              **res})
        del cells
        torch.cuda.empty_cache()
    return worst


def expected_shard_launches(parts, shards, cards=1):
    """Launch counts a planned sharded run must show, per kernel."""
    n = dict.fromkeys(expected_launches([]), 0)
    for seg in parts:
        if seg.kernel == "ring":
            n["ring"] += seg.launches * cards
        else:
            n[f"{seg.kernel}_seam"] += seg.launches * shards
            n["reduce"] += seg.launches * shards
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

    params, obs = SCENE_DIR / "input_1024x1024.params", SCENE_DIR / "obstacles.dat"
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


def _median_ms_shards(torch, ss, fn, spc, device_only, steps=200, batches=10):
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
    one card, beside the unsharded best; the halo copies alone; the plain
    shard step at 1024x1024."""
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
        order = list(impls) + list(reversed(impls))
        loop, dev = {}, {}
        for table, device_only in ((loop, False), (dev, True)):
            for label in order:
                impl = impls[label]
                table.setdefault(label, []).append(_median_ms_shards(
                    torch, ss, lambda: impl.run(0), impl.steps_per_call,
                    device_only)[0])
        copies = {}
        for label in ("seam D=1", "seam D=4"):
            impl = impls[label]
            copies[label] = _median_ms_shards(
                torch, ss, lambda: ss.exchange(impl.halos, impl.k), 1, True)[0]
        unsharded = timing[name]["device_ms_per_step"]
        best = min(unsharded, key=lambda k: statistics.median(unsharded[k]))
        out = {"phase": "shard_timing", "grid": name, "shards": N_SHARDS,
               "devices": halo.describe_mesh(mesh),
               "loop_ms_per_step": loop, "device_ms_per_step": dev,
               "halo_copy_device_ms_per_call": copies,
               "unsharded_best": {best: statistics.median(unsharded[best])},
               "method": "CUDA events on the current stream, every shard "
                         "stream joined; median over 10 batches of ~200 "
                         "steps after one warm-up batch, configurations in "
                         "turns (forward, then reverse); device: queue "
                         "pre-filled behind a device sleep"}
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
    return results


# Bounds: the least time the card could take for a kernel's work, the
# larger of its bytes over the HBM rate and its operations over the
# float32 rate (NVIDIA's data sheet, H100 SXM at 700 W). A step of one
# cell moves its 9 f32 speeds in and out and its mask byte, 73 B, each
# input read once and each output written once; a kernel that runs n
# steps per launch moves them once per n steps. Operations per cell-step:
# 90, counted from lbm_cell.cuh's paired association (density 8, velocity
# 12 with two divisions, u^2 3, equilibrium 36, relaxation 27, |u| and its
# sum 4), the forcing branch aside.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_CELL_STEP = 90
BYTES_PER_CELL_PASS = 73


def bound(cells, steps_per_launch, extra_bytes=0):
    """``(ms per step, "bytes" or "operations")`` for ``cells`` cells
    stepped ``steps_per_launch`` steps per launch."""
    t_bytes = (BYTES_PER_CELL_PASS * cells + extra_bytes) / HBM_BYTES_PER_S \
        / steps_per_launch
    t_ops = OPS_PER_CELL_STEP * cells / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_entry(name, source, replaces, launches, path, err, ms, plain_ms,
                 bnd, library_ms=None):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "path": path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    import lbm_tpu_torch  # noqa: F401  (fails here, before any output,
    # when the package is not beside this script)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(torch)
    phase_build()
    worst = phase_kernel(torch)
    launches = phase_scene(torch, np)
    phase_stress(torch)
    timing = phase_timing(torch)
    shard_worst = phase_shard_kernel(torch)
    shard_launches = phase_shard_scene(torch, np)
    shard_timing = phase_shard_timing(torch, timing)
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "lbm_tpu" or m.startswith("lbm_tpu.")
                  for m in sys.modules), "the port imported lbm_tpu")

    # Every kernel of the card's paths launched in the run of its path.
    runs = {"fused_step": launches["step"]["step"],
            "reduce_tot": launches["auto"]["reduce"],
            "fused_depth": launches["auto"]["depth"],
            "resident": launches["resident"]["resident"],
            "fused_step_seam": shard_launches["step"]["step_seam"],
            "fused_depth_seam": shard_launches["auto"]["depth_seam"],
            "ring": shard_launches["ring"]["ring"]}
    for kname, n in runs.items():
        check(n > 0, f"{kname} was not launched on its path")
    t = timing[SCENE]
    dev = {k: statistics.median(v) for k, v in t["device_ms_per_step"].items()}
    plain = statistics.median(t["plain_device_ms_per_step"])
    st = shard_timing[SCENE]
    sdev = {k: statistics.median(v) for k, v in st["device_ms_per_step"].items()}
    splain = st["plain_device_ms_per_step"]
    nx, ny = grid(SCENE)
    cells = nx * ny
    partials = (nx // 32) * (ny // 8)
    # Halo rows in per call over 4 shards: k rows each side, 37 B a cell.
    halo_bytes = lambda k: N_SHARDS * 2 * k * nx * 37
    on_scene = f"{SCENE} scene"
    sharded = f"{SCENE} scene over {N_SHARDS} shards on one card"
    emit({"kernels": [
        kernel_entry("fused_step", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:205", runs["fused_step"],
                     f"{on_scene}, one-step plan", worst["fused_step"],
                     dev["step"], plain, bound(cells, 1)),
        kernel_entry("reduce_tot", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:396", runs["reduce_tot"],
                     f"{on_scene}, auto", t["reduce_abs_err"],
                     t["reduce_device_ms"], t["reduce_plain_device_ms"],
                     (max(4 * (partials + 1) / HBM_BYTES_PER_S,
                          partials / F32_OPS_PER_S) * 1e3,
                      "bytes" if 4 * (partials + 1) / HBM_BYTES_PER_S
                      >= partials / F32_OPS_PER_S else "operations"),
                     library_ms=t["reduce_plain_device_ms"]),
        kernel_entry("fused_depth", "lbm_tpu_torch/csrc/fused_depth.cu",
                     "lbm_tpu/ops/pallas_fused.py:653", runs["fused_depth"],
                     f"{on_scene}, auto (D=4)", worst["depth"],
                     dev["depth D=4"], plain, bound(cells, 4)),
        kernel_entry("resident", "lbm_tpu_torch/csrc/resident.cu",
                     "lbm_tpu/ops/pallas_resident.py:74", runs["resident"],
                     f"{on_scene}, resident plan (G=100)", worst["resident"],
                     dev["resident G=100"], plain, bound(cells, 100)),
        kernel_entry("fused_step_seam", "lbm_tpu_torch/csrc/fused_step.cu",
                     "lbm_tpu/ops/pallas_fused.py:205", runs["fused_step_seam"],
                     f"{sharded}, one-step plan", shard_worst["step_seam"],
                     sdev["seam D=1"], splain,
                     bound(cells, 1, halo_bytes(1))),
        kernel_entry("fused_depth_seam", "lbm_tpu_torch/csrc/fused_depth.cu",
                     "lbm_tpu/ops/pallas_fused.py:653",
                     runs["fused_depth_seam"], f"{sharded}, auto (D=4)",
                     shard_worst["depth_seam"], sdev["seam D=4"], splain,
                     bound(cells, 4, halo_bytes(4))),
        kernel_entry("ring", "lbm_tpu_torch/csrc/ring.cu",
                     "lbm_tpu/parallel/resident_ring.py:241", runs["ring"],
                     f"{sharded}, LBM_SHARD_RESIDENT=1 (G=100)",
                     shard_worst["ring"], sdev["ring G=100"], splain,
                     bound(cells, 100)),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
