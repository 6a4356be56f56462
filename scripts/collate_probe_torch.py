#!/usr/bin/env python3
"""The collate copy of a scene's final lattice on the card, and the
device tail it can hide behind, at the benchmark's two reference scenes
(1024² for 20000 steps, 256² for 80000, walls and a column):

- ``tail``: a whole scene enqueued by ``_Simulation.run_chunk``, then the
  host seconds from the last launch's return to the end of
  ``synchronize()`` (the launch queue draining), beside the launch loop's;
- ``prepare``: the host seconds to make a fresh array of the lattice's
  shape ready for the copy, three ways: ``page`` (``runner.
  prefaulted_array``, a byte a page), ``fill`` (a torch ``zero_``),
  ``madvise`` (``MADV_POPULATE_WRITE`` over the page-aligned range, the
  edge pages written);
- ``copy``: the lattice's copy to the host into a fresh array
  (``.cpu().numpy()``), into a prepared pageable one, and into a prepared
  one registered with ``cudaHostRegister`` for the copy (the register,
  copy and unregister seconds apart), in turns;
- ``scenes``: ``run_simulation``'s own ``compute.prefault``,
  ``compute.prefault.hidden`` and ``collate.copy``.

Usage: python scripts/collate_probe_torch.py [--grids 1024 256]
           [--reps 8] [--scenes 4] [-o FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import mmap
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lbm_tpu_torch import runner  # noqa: E402
from lbm_tpu_torch.params import Params  # noqa: E402
from lbm_tpu_torch.state import initial_state  # noqa: E402

GRIDS = {1024: (20000, 0.01), 256: (80000, 0.005)}
MADV_POPULATE_WRITE = 23


def scene(n: int):
    iters, accel = GRIDS[n]
    p = Params(nx=n, ny=n, max_iters=iters, reynolds_dim=10, density=0.1,
               accel=accel, omega=1.85)
    mask = np.zeros((n, n), dtype=bool)
    mask[0, :] = mask[-1, :] = mask[:, 0] = mask[:, -1] = True
    mask[:, n // 3] = True
    return p, mask


def tail(p, mask, dev):
    """One scene's launch loop and queue drain, on the host's clock, and
    its final lattice on the device."""
    sim = runner._Simulation(p, initial_state(p, dev),
                             torch.from_numpy(mask).to(dev), "cuda",
                             p.max_iters)
    sim.synchronize()
    t0 = time.perf_counter()
    sim.run_chunk(0, p.max_iters)
    t1 = time.perf_counter()
    sim.synchronize()
    t2 = time.perf_counter()
    return {"loop_s": t1 - t0, "tail_s": t2 - t1}, sim.result()[0]


def madvised(shape, dtype) -> np.ndarray:
    out = np.empty(shape, dtype)
    libc = ctypes.CDLL(None, use_errno=True)
    libc.madvise.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int)
    page = mmap.PAGESIZE
    lo = -(-out.ctypes.data // page) * page
    hi = (out.ctypes.data + out.nbytes) // page * page
    if hi > lo and libc.madvise(lo, hi - lo, MADV_POPULATE_WRITE) != 0:
        raise OSError(ctypes.get_errno(), "madvise(MADV_POPULATE_WRITE)")
    flat = out.reshape(-1).view(np.uint8)
    flat[:page] = 0
    flat[-page:] = 0
    return out


def filled(shape, dtype) -> np.ndarray:
    out = np.empty(shape, dtype)
    torch.from_numpy(out).zero_()
    return out


PREPARE = {"page": runner.prefaulted_array, "fill": filled,
           "madvise": madvised}


def prepare(shape, reps: int) -> dict:
    times = {k: [] for k in PREPARE}
    for _ in range(reps):
        for name, make in PREPARE.items():
            t0 = time.perf_counter()
            try:
                out = make(shape, np.float32)
            except OSError as e:
                times[name] = f"refused: {e}"
                continue
            if isinstance(times[name], list):
                times[name].append(time.perf_counter() - t0)
            del out
    return times


def copies(x: torch.Tensor, reps: int) -> dict:
    cudart = torch.cuda.cudart()
    t = {"fresh": [], "pageable": [], "register": [], "registered": [],
         "unregister": []}
    ok = True
    for turn in range(reps):
        order = ("fresh", "pageable", "registered")
        for kind in order if turn % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            if kind == "fresh":
                t0 = time.perf_counter()
                y = x.cpu().numpy()
                t["fresh"].append(time.perf_counter() - t0)
                continue
            y = runner.prefaulted_array(tuple(x.shape), np.float32)
            if kind == "pageable":
                t0 = time.perf_counter()
                torch.from_numpy(y).copy_(x)
                t["pageable"].append(time.perf_counter() - t0)
                continue
            t0 = time.perf_counter()
            err = int(cudart.cudaHostRegister(y.ctypes.data, y.nbytes, 0))
            t1 = time.perf_counter()
            torch.from_numpy(y).copy_(x)
            t2 = time.perf_counter()
            err2 = int(cudart.cudaHostUnregister(y.ctypes.data))
            t3 = time.perf_counter()
            ok = ok and err == 0 and err2 == 0
            t["register"].append(t1 - t0)
            t["registered"].append(t2 - t1)
            t["unregister"].append(t3 - t2)
            ok = ok and np.array_equal(y, x.cpu().numpy())
    t["registered_ok"] = ok
    return t


def scenes(p, mask, n: int) -> list[dict]:
    keys = ("compute", "compute.prefault", "compute.prefault.hidden",
            "collate", "collate.copy", "total")
    out = []
    for _ in range(n):
        r = runner.run_simulation(p, mask)
        out.append({k: r.timings.get(k) for k in keys})
    return out


def med_ms(v):
    return (f"{1e3 * statistics.median(v):.3f} ms "
            f"[{1e3 * min(v):.3f}, {1e3 * max(v):.3f}]"
            if isinstance(v, list) and v else str(v))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", type=int, nargs="+", default=[1024, 256])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("-o", "--output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    report = {"card": card.strip(), "grids": {}}
    print(report["card"], flush=True)
    for n in args.grids:
        p, mask = scene(n)
        runner.run_simulation(p, mask)  # builds or loads every kernel
        tails, x = [], None
        for _ in range(3):
            reading, x = tail(p, mask, dev)
            tails.append(reading)
        row = {"tail": tails,
               "prepare": prepare(tuple(x.shape), args.reps),
               "copy": copies(x, args.reps),
               "scenes": scenes(p, mask, args.scenes)}
        report["grids"][n] = row
        print(f"{n}²: tail " + ", ".join(
            f"loop {1e3 * r['loop_s']:.1f} ms tail {1e3 * r['tail_s']:.2f} ms"
            for r in tails), flush=True)
        for kind, v in row["prepare"].items():
            print(f"  prepare {kind}: {med_ms(v)}")
        for kind, v in row["copy"].items():
            print(f"  copy {kind}: {med_ms(v)}")
        for s in row["scenes"]:
            print("  scene " + ", ".join(
                f"{k} {v * 1e3:.3f} ms" if isinstance(v, float)
                else f"{k} {v}" for k, v in s.items()))
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
