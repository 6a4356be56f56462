#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (lbm_tpu_torch).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits
non-zero):

1. device  - the card (nvidia-smi name and power limit), torch, CUDA;
2. build   - nvcc builds lbm_tpu_torch/csrc/*.cu into build/lbm_tpu_torch/;
3. kernel  - the kernel against its plain PyTorch version on the card:
             one step at 1024x1024 (scene mask), 128x128, a ragged
             100x130 wall-less mask and the 131072x128 stress shape;
             all three BGK associations at 256x256; 200 steps at
             1024x1024; bit-identical repeat runs;
4. scene   - the reference's 1024x1024 scene (20000 steps) through the
             port's CLI with --kernel auto on cuda: exactly one step and
             one reduce launch per step, and within the 0.3 % drift
             budget of goldens/1024x1024.final_state.f64.npz;
5. timing  - median per-step time of the kernel and of the plain version
             at 1024x1024, with CUDA events: as the runner's loop drives
             them, and device time alone.

Then the kernels line, the nvidia-smi line, and a last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2
before printing anything.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
NX = NY = 1024
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def scene_params(iters=ITERS):
    from lbm_tpu_torch.params import Params

    return Params(nx=NX, ny=NY, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.01, omega=1.85)


def scene_mask():
    """The reference's 1024x1024 obstacles: the generator's boundary
    walls plus one full-height column at x = nx // 3."""
    from lbm_tpu_torch.obstacles import generate_obstacles

    mask = generate_obstacles(NX, NY)
    mask[:, NX // 3] = True
    return mask


def random_case(torch, ny, nx, p, seed, mask_kind="walls"):
    """Seeded device state whose forced row fails the guard in places,
    and its mask: the generator's walls, the 1024x1024 scene's, or
    random and wall-less (periodic in both axes)."""
    from lbm_tpu_torch.obstacles import generate_obstacles

    g = torch.Generator(device="cuda").manual_seed(seed)
    cells = torch.rand((9, ny, nx), generator=g, device="cuda") * 0.19 + 0.01
    fail = torch.rand(nx, generator=g, device="cuda") < 0.3
    cells[6, ny - 2][fail] = float(p.accel_w2)
    if mask_kind == "walls":
        mask = torch.from_numpy(generate_obstacles(nx, ny)).cuda()
    elif mask_kind == "scene":
        mask = torch.from_numpy(scene_mask()).cuda()
    else:
        mask = torch.rand((ny, nx), generator=g, device="cuda") < 0.15
    return cells.contiguous(), mask


def compare_step(torch, fused, cells, mask, p):
    """One kernel step against the plain version: errors, and whether
    cells meet rtol/atol and tot_u meets its rtol."""
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    got, got_tot = fused.fused_step(cells, *args)
    want, want_tot = fused.fused_step_plain(cells, *args)
    torch.cuda.synchronize()
    err = (got - want).abs()
    ok = bool((err <= ATOL + RTOL * want.abs()).all())
    tot_rel = abs(float(got_tot) - float(want_tot)) / abs(float(want_tot))
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    return {"max_abs_err": float(err.max()), "cells_ok": ok,
            "tot_rel_err": tot_rel, "tot_ok": tot_rel <= TOT_RTOL}


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
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": seconds, "library": str(path.name),
          "nvcc_flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas})


def phase_kernel(torch):
    import os

    from lbm_tpu_torch.ops import fused
    from lbm_tpu_torch.runner import simulate
    from lbm_tpu_torch.state import initial_state

    p = scene_params(iters=200)
    worst = 0.0
    cases = [("1024x1024-scene", NY, NX, "scene"),
             ("128x128", 128, 128, "walls"),
             ("100x130-wall-less", 100, 130, "random"),
             ("131072x128", 131072, 128, "walls")]
    for i, (name, ny, nx, kind) in enumerate(cases):
        cells, mask = random_case(torch, ny, nx, p, seed=i, mask_kind=kind)
        res = compare_step(torch, fused, cells, mask, p)
        emit({"phase": "kernel", "case": f"step {name}", **res})
        check(res["cells_ok"] and res["tot_ok"], f"kernel != plain at {name}")
        worst = max(worst, res["max_abs_err"])
        del cells, mask
        torch.cuda.empty_cache()

    saved = {k: os.environ.pop(k, None) for k in ("LBM_PAIRED_EQ", "LBM_OMEGA_EQ")}
    try:
        for i, (mode, env) in enumerate(MODES.items()):
            os.environ.pop("LBM_PAIRED_EQ", None)
            os.environ.pop("LBM_OMEGA_EQ", None)
            os.environ.update(env)
            cells, mask = random_case(torch, 256, 256, p, seed=10 + i)
            res = compare_step(torch, fused, cells, mask, p)
            emit({"phase": "kernel", "case": f"step 256x256 {mode}", **res})
            check(res["cells_ok"] and res["tot_ok"], f"kernel != plain, {mode}")
            worst = max(worst, res["max_abs_err"])
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v

    mask = torch.from_numpy(scene_mask()).cuda()
    c0 = initial_state(p, "cuda")
    ck, ak = simulate(p, c0, mask, kernel="cuda", n_iters=200)
    ck2, ak2 = simulate(p, c0, mask, kernel="cuda", n_iters=200)
    cr, ar = simulate(p, c0, mask, kernel="reference", n_iters=200)
    av_rel = float(((ak - ar).abs() / ar.abs()).max())
    same = bool(torch.equal(ck, ck2) and torch.equal(ak, ak2))
    emit({"phase": "kernel", "case": "200 steps 1024x1024",
          "av_vels_max_rel_err": av_rel,
          "cells_max_abs_err": float((ck - cr).abs().max()),
          "bit_identical_repeat": same})
    check(av_rel <= TRAJ_RTOL, "200-step av_vels disagree")
    check(same, "two kernel runs differ")
    return worst


def phase_scene(torch, np):
    from lbm_tpu_torch import cli
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import write_obstacles
    from lbm_tpu_torch.ops import fused

    golden = np.load(GOLDEN)
    mask = scene_mask()
    check(np.array_equal(mask, golden["u"].reshape(NY, NX) == 0),
          "scene mask differs from the golden's zero-velocity cells")
    SCENE_DIR.mkdir(parents=True, exist_ok=True)
    params, obs = SCENE_DIR / "input_1024x1024.params", SCENE_DIR / "obstacles.dat"
    av_file, fs_file = SCENE_DIR / "av_vels.dat", SCENE_DIR / "final_state.dat"
    params.write_text(f"{NX}\n{NY}\n{ITERS}\n10\n0.1\n0.01\n1.85\n")
    write_obstacles(obs, mask)

    fused.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(params), str(obs), "--kernel", "auto",
                       "--device", "cuda", "--av-vels-file", str(av_file),
                       "--final-state-file", str(fs_file)])
    launches = dict(fused.LAUNCHES)
    lines = out.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    check(rc == 0, f"CLI exit {rc}")
    check(launches == {"step": ITERS, "reduce": ITERS},
          f"expected {ITERS} launches of each kernel, got {launches}")
    check(lines[0] == "==done==", "stdout contract")
    reynolds = float(lines[1].split()[-1])
    compute = float(lines[3].split()[-2])

    av = lio.load_av_vels(av_file)
    fs = lio.load_final_state(fs_file)
    d_av = lio._diff(golden["av_vels"], av, DRIFT_BUDGET_PCT)
    d_p = lio._diff(golden["pressure"], fs[:, 2], DRIFT_BUDGET_PCT)
    re_rel = abs(reynolds - float(golden["reynolds"])) / float(golden["reynolds"])
    emit({"phase": "scene", "launches": launches, "reynolds": reynolds,
          "reynolds_rel_err": re_rel,
          "av_vels_max_pct": d_av.max_diff_pcnt,
          "pressure_max_pct": d_p.max_diff_pcnt,
          "drift_budget_pct": DRIFT_BUDGET_PCT,
          "compute_s": compute, "glups": NX * NY * ITERS / compute / 1e9,
          "timings_s": {ln.split()[1].lower(): float(ln.split()[-2])
                        for ln in lines[2:6]}})
    check(not d_av.failed and not d_p.failed, "outside the drift budget")
    check(re_rel <= 1e-3, "Reynolds number off")
    return launches


# ~50 ms of device sleep (at H100 clocks) ahead of a batch: the host
# queues the whole batch while the device waits, so the events then time
# device work alone, without host launch overhead.
SLEEP_CYCLES = 100_000_000


def _median_ms(torch, fn, device_only, steps=20, batches=25, warmup=20):
    """Median over batches of (CUDA-event time of ``steps`` calls)/steps,
    with min and max. ``device_only``: pre-fill the queue first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / steps)
    return statistics.median(times), min(times), max(times)


def phase_timing(torch, np):
    from lbm_tpu_torch.ops import _build, fused
    from lbm_tpu_torch.ops import reference as ref_ops

    p = scene_params()
    cells, mask = random_case(torch, NY, NX, p, seed=99, mask_kind="scene")
    spare = torch.empty_like(cells)
    av = torch.empty(1, device="cuda")
    st = fused.FusedStep(mask, p.accel_w1, p.accel_w2, p.omega)
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    w1, w2, om = st.w1, st.w2, st.omega

    def kernel_step():  # the wrapper, as the runner calls it: both launches
        st.step(cells, spare, av, 0, 1.0)

    def plain_step():
        new, tot = ref_ops.fused_step(cells, mask, w1, w2, om)
        av[0] = tot

    def step_only():
        lib.lbm_fused_step(cells.data_ptr(), spare.data_ptr(),
                           st._mask_u8.data_ptr(), st._partials.data_ptr(),
                           NY, NX, NY - 2, w1, w2, om, st.mode, st._index,
                           stream)

    def reduce_only():
        lib.lbm_reduce_tot(st._partials.data_ptr(), st._partials.numel(),
                           np.float32(1.0), av.data_ptr(), st._index, stream)

    def reduce_plain():
        av[0] = st._partials.sum()

    # In turns on one card: plain / kernel / kernel / plain, first as the
    # runner's loop drives them (host launches included), then device
    # time alone.
    loop, dev = {}, {}
    for name, fn in [("plain", plain_step), ("kernel", kernel_step),
                     ("kernel", kernel_step), ("plain", plain_step)]:
        loop.setdefault(name, []).append(_median_ms(torch, fn, False))
    for name, fn in [("plain", plain_step), ("kernel", kernel_step),
                     ("kernel", kernel_step), ("plain", plain_step),
                     ("step_kernel", step_only), ("reduce_kernel", reduce_only),
                     ("reduce_plain", reduce_plain)]:
        dev.setdefault(name, []).append(_median_ms(torch, fn, True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kernel_step()
    enqueue_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    step_only()
    reduce_only()
    reduce_err = abs(float(av[0]) - float(st._partials.sum()))
    out = {
        "phase": "timing", "shape": f"{NY}x{NX}",
        "loop_ms_per_step": {k: [r[0] for r in v] for k, v in loop.items()},
        "device_ms_per_step": {k: [r[0] for r in v] for k, v in dev.items()},
        "kernel_loop_min_max_ms": [list(r[1:]) for r in loop["kernel"]],
        "host_enqueue_us_per_step": enqueue_us,
        "method": "CUDA events; median over 25 batches of 20 calls after "
                  "20 warm-up calls; device: queue pre-filled behind a "
                  "device sleep",
    }
    emit(out)
    return out, reduce_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(torch)
    phase_build()
    worst = phase_kernel(torch)
    launches = phase_scene(torch, np)
    timing, reduce_err = phase_timing(torch, np)
    check("jax" not in sys.modules, "the port imported jax")
    dev = timing["device_ms_per_step"]
    emit({"kernels": [
        {"name": "fused_step", "route": "cuda",
         "source": "lbm_tpu_torch/csrc/fused_step.cu",
         "replaces": "lbm_tpu/ops/pallas_fused.py:205",
         "launches": launches["step"], "max_abs_err": worst,
         "ms": statistics.median(dev["kernel"]),
         "plain_ms": statistics.median(dev["plain"])},
        {"name": "reduce_tot", "route": "cuda",
         "source": "lbm_tpu_torch/csrc/fused_step.cu",
         "replaces": "lbm_tpu/ops/pallas_fused.py:396",
         "launches": launches["reduce"], "max_abs_err": reduce_err,
         "ms": dev["reduce_kernel"][0], "plain_ms": dev["reduce_plain"][0]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
