#!/usr/bin/env python3
"""Time the tensor-core equilibrium's kernel (``csrc/mxu_eq.cu``) beside the
device-memory resident form, or run the 1024x1024 scene through either, for
a checkout (``--repo``) or for a variant of this tree's kernel.

A variant (``--variant``) is this tree's package copied under
``build/mxu_variants/NAME`` with :data:`VARIANTS`' text replacements (each
must occur exactly once), its kernels built there:

- ``tf32x3``: the products in 3xTF32 on the f32 tensor path, the first form
  of the kernel: x = tf32(x) + tf32(x - tf32(x)) by ``cvt.rna``, A B ~ A_lo
  B_hi + A_hi B_lo + A_hi B_hi accumulated in f32 by three m16n8k8 tf32
  products (W's parts split on the card from the same f64 table);
- ``tf32x3-2``: the same at the device form's two blocks an SM (48
  registers), the occupancy the first form had.

Timing (the default): G=100 launches at 1024x1024 (the scene's mask, with
its column; a perturbed state), the device form and the kernel in turns
(device, kernel, kernel, device), 5 batches of 200 steps a turn after a
queue-filling device sleep, CUDA events, the median a step; the kernel's
ptxas line and blocks. ``--scene kernel|device|plain``: the scene's 20000
steps from rest through the kernel (``MxuStep``, G=100), the device form,
or the plain version (``mxu_step``, eagerly), its drift against
``goldens/1024x1024.final_state.f64.npz`` by check.py's formula (the 0.3 %
budget), av_vels' relative error at a few steps and the mass's change.

Run one process per checkout, the checkouts in turns, to compare two
trees; a variant and this tree in one call compare two kernels.

Usage: python3 scripts/mxu_ab_torch.py [--repo DIR | --variant NAME]
           [--scene kernel|device|plain] [-o FILE]
       (A CUDA device is required.)
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "goldens" / "1024x1024.final_state.f64.npz"
G = 100

_TF32X3_PRODUCTS = '''    double a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = table[i * 32 + lane];
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(ah[i]) : "f"((float)a[i]));
        ah[i] &= 0xffffe000u;
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(al[i])
            : "f"((float)a[i] - __uint_as_float(ah[i])));
    }
#pragma unroll
    for (int T = 0; T < 8; ++T) {
        if (8 * T >= P) break;  // the same for the whole warp
        const int c = 8 * T + g;
        const float x0 = sc[mxu_slot(t, c, P)];
        const float x1 = t < 2 ? sc[mxu_slot(t + 4, c, P)] : 0.0f;
        uint32_t h0, l0, h1, l1;
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h0) : "f"(x0));
        h0 &= 0xffffe000u;
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l0) : "f"(x0 - __uint_as_float(h0)));
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h1) : "f"(x1));
        h1 &= 0xffffe000u;
        asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l1) : "f"(x1 - __uint_as_float(h1)));
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        auto mma = [&](const uint32_t (&x)[4], uint32_t y0, uint32_t y1) {
            asm volatile(
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y0), "r"(y1));
        };
        mma(al, h0, h1);  // the small terms first
        mma(ah, l0, l1);
        mma(ah, h0, h1);
        const int e = 8 * T + 2 * t;
        *reinterpret_cast<float2*>(sc + mxu_slot(g, e, P)) =
            make_float2(d[0], d[1]);
        if (g == 0) {
            *reinterpret_cast<float2*>(sc + mxu_slot(8, e, P)) =
                make_float2(d[2], d[3]);
        }
    }
}
'''

# The f64 products' loop, from its A loads to the function's end.
_F64_PRODUCTS = '''    double a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = table[i * 32 + lane];
#pragma unroll
    for (int T = 0; T < 8; ++T) {
        if (8 * T >= P) break;  // the same for the whole warp
        // B: features t and t + 4 (none past 5) of the tile's cell g.
        const int c = 8 * T + g;
        const double b0 = sc[mxu_slot(t, c, P)];
        const double b1 = t < 2 ? sc[mxu_slot(t + 4, c, P)] : 0.0;
        double d[4] = {0.0, 0.0, 0.0, 0.0};
        mma_f64(d, a, b0, b1);
        // Speed g of the tile's cells 2t and 2t + 1; speed 8 from lane g = 0
        // (rows 9..15 are W's padding).
        const int e = 8 * T + 2 * t;
        *reinterpret_cast<float2*>(sc + mxu_slot(g, e, P)) =
            make_float2(__double2float_rn(d[0]), __double2float_rn(d[1]));
        if (g == 0) {
            *reinterpret_cast<float2*>(sc + mxu_slot(8, e, P)) =
                make_float2(__double2float_rn(d[2]), __double2float_rn(d[3]));
        }
    }
}
'''
_ONE_BLOCK = "__global__ void __launch_bounds__(MxuBlock::kThreads, 1)"
_TWO_BLOCKS = "__global__ void __launch_bounds__(MxuBlock::kThreads, 2)"

# Each variant: (source file under lbm_tpu_torch/csrc, old, new) triples.
VARIANTS = {
    "tf32x3": [("lbm_depth.cuh", _F64_PRODUCTS, _TF32X3_PRODUCTS)],
    "tf32x3-2": [("lbm_depth.cuh", _F64_PRODUCTS, _TF32X3_PRODUCTS),
                 ("mxu_eq.cu", _ONE_BLOCK, _TWO_BLOCKS)],
}


def make_variant(name: str) -> Path:
    """This tree's package copied under build/mxu_variants/NAME with the
    variant's replacements; returns the copy's root."""
    root = REPO / "build" / "mxu_variants" / name
    # The package anew; its build directory (root/build) is kept, its
    # libraries keyed by their sources' hash.
    shutil.rmtree(root / "lbm_tpu_torch", ignore_errors=True)
    shutil.copytree(REPO / "lbm_tpu_torch", root / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for source, old, new in VARIANTS[name]:
        path = root / "lbm_tpu_torch" / "csrc" / source
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: the text to replace occurs "
                             f"{text.count(old)} times in {source}")
        path.write_text(text.replace(old, new))
    return root


def ptxas_line(log: Path) -> str:
    """The build log's ``-Xptxas -v`` registers and spills of the kernel."""
    out, name = [], None
    for ln in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = m.group(1)
        elif name and "mxu_resident_kernel" in name and (
                "spill" in ln or "registers" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return "; ".join(dict.fromkeys(out))


def scene_mask(np):
    from lbm_tpu_torch.obstacles import generate_obstacles

    mask = generate_obstacles(1024, 1024)
    mask[:, 1024 // 3] = True
    return mask


def time_kernels(torch, np):
    """Device ms a step of the device form and of the kernel, in turns."""
    from lbm_tpu_torch.ops import mxu_eq, resident
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    p = Params(nx=1024, ny=1024, max_iters=200, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    mask = torch.from_numpy(scene_mask(np)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    noise = torch.rand((9, 1024, 1024), generator=gen, device="cuda")
    cells = (initial_state(p, "cuda") * (1 + 0.2 * (noise - 0.5))).contiguous()
    w = (p.accel_w1, p.accel_w2, p.omega)
    kernels = {"device": resident.Resident(mask, *w, G, form="device"),
               "mxu": mxu_eq.MxuStep(mask, *w, G)}
    bufs = [cells, torch.empty_like(cells)]
    av = torch.zeros(G, device="cuda")

    def run(k):
        bufs[:] = k.run(bufs[0], bufs[1], av)

    for k in kernels.values():
        run(k)
        run(k)
    torch.cuda.synchronize()
    ms = {k: [] for k in kernels}
    for label in ["device", "mxu", "mxu", "device"]:
        for _ in range(5):
            torch.cuda._sleep(50_000_000)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            run(kernels[label])
            run(kernels[label])
            t1.record()
            t1.synchronize()
            ms[label].append(t0.elapsed_time(t1) / (2 * G))
    med = {k: statistics.median(v) for k, v in ms.items()}
    return {"device_ms": med["device"], "mxu_ms": med["mxu"],
            "mxu_over_device": med["mxu"] / med["device"], "all_ms": ms,
            "blocks": {k: v.blocks for k, v in kernels.items()},
            "finite": bool(torch.isfinite(bufs[0]).all())}


def run_scene(torch, np, which: str):
    """The scene's 20000 steps through ``which``; its drift."""
    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import num_non_obstacles_r
    from lbm_tpu_torch.ops import mxu_eq, resident
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    golden = np.load(GOLDEN)
    p = Params(nx=1024, ny=1024, max_iters=20000, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    mask = scene_mask(np)
    if not np.array_equal(mask, golden["u"].reshape(1024, 1024) == 0):
        raise SystemExit("the scene's mask differs from the golden's")
    inv = float(num_non_obstacles_r(mask))
    m = torch.from_numpy(mask).cuda()
    cells = initial_state(p, "cuda")
    spare = torch.empty_like(cells)
    av = torch.zeros(20000, device="cuda")
    w = (p.accel_w1, p.accel_w2, p.omega)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if which == "plain":
        for t in range(20000):
            cells, tot = mxu_eq.mxu_step(cells, m, *w)
            av[t] = tot * inv
    else:
        k = (mxu_eq.MxuStep(m, *w, G) if which == "kernel"
             else resident.Resident(m, *w, G, form="device"))
        for t in range(0, 20000, G):
            cells, spare = k.run(cells, spare, av, t, inv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pressure = lio.final_state_fields(p, cells.cpu().numpy(), mask)[3].ravel()
    d_av = lio._diff(golden["av_vels"], av.cpu().numpy(), 0.3)
    d_p = lio._diff(golden["pressure"], pressure, 0.3)
    rel = (av.cpu().numpy() - golden["av_vels"]) / golden["av_vels"]
    return {"scene": which, "seconds": seconds,
            "av_vels_max_pct": d_av.max_diff_pcnt,
            "pressure_max_pct": d_p.max_diff_pcnt,
            "margin_pct": 0.3 - max(abs(d_av.max_diff_pcnt),
                                    abs(d_p.max_diff_pcnt)),
            "av_vels_rel_at": {str(t): float(rel[t])
                               for t in (9, 99, 999, 4999, 9999, 19999)},
            "mass_rel": float(cells.double().sum()
                              / (0.1 * 1024 * 1024) - 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--repo", default=str(REPO),
                     help="import lbm_tpu_torch from this checkout")
    src.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--scene", choices=["kernel", "device", "plain"])
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    root = make_variant(args.variant) if args.variant else Path(args.repo)
    sys.path.insert(0, str(root.resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"error": "requires a CUDA device"}))
        return 2
    from lbm_tpu_torch.ops import _build

    library, seconds = _build.build()
    same = Path(args.repo).resolve() == REPO
    out = {"checkout": args.variant or ("this tree" if same else args.repo),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "build_s": seconds, "ptxas": ptxas_line(library.with_suffix(".log"))}
    out.update(run_scene(torch, np, args.scene) if args.scene
               else time_kernels(torch, np))
    text = json.dumps(out)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
