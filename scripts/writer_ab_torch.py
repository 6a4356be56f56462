#!/usr/bin/env python3
"""A/B of the port's ``final_state.dat`` writer on the host CPU: the C
writer as the port builds it (``csrc_host/lbm_io.c``, whose ``%.12E``
formatter makes the 13 digits in 128-bit integers) against the same
buffered writer built with ``-DLBM_IO_PRINTF_ONLY`` (glibc's
``snprintf("%.12E")`` for every float field). Both write the same
float32 fields of a perturbed rest state with the generator's walls;
the bytes must be equal. Each grid runs exact, printf, printf, exact
per turn; a row keeps every time and the best of each. Needs no card;
run it on the card's machine to time that host.

Usage: python scripts/writer_ab_torch.py [--grids 1024x1024 16384x1024]
           [--turns 1] [-o FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import sweep_torch  # noqa: E402

REPO = sweep_torch.REPO
GRIDS = ["1024x1024", "16384x1024"]
VARIANTS = {"exact": (), "printf": ("-DLBM_IO_PRINTF_ONLY",)}
WORKDIR = REPO / "build" / "lbm_tpu_torch" / "writer_ab"


def same_bytes(a: Path, b: Path, chunk: int = 1 << 24) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def run_grid(name: str, turns: int, seed: int = 12) -> dict:
    import numpy as np

    from lbm_tpu_torch import io as lio
    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops import _build
    from lbm_tpu_torch.state import initial_state_np

    p = sweep_torch.grid_params(name)
    rng = np.random.default_rng(seed)
    cells = initial_state_np(p) * (
        np.float32(0.9) + rng.random((9, p.ny, p.nx), dtype=np.float32)
        * np.float32(0.2))
    mask = generate_obstacles(p.nx, p.ny)
    fields = [np.ascontiguousarray(f)
              for f in lio.final_state_fields(p, cells, mask)]
    del cells
    obs = np.ascontiguousarray(mask, dtype=np.int32)
    libs = {k: _build.load_host(d) for k, d in VARIANTS.items()}
    WORKDIR.mkdir(parents=True, exist_ok=True)
    files = {k: WORKDIR / f"{k}.dat" for k in VARIANTS}
    times = {k: [] for k in VARIANTS}
    for _ in range(turns):
        for k in ("exact", "printf", "printf", "exact"):
            t0 = time.perf_counter()
            lio._host_call(files[k], libs[k].lbm_write_final_state, p.nx,
                           p.ny, *(f.ctypes.data for f in fields),
                           obs.ctypes.data, 0)
            times[k].append(time.perf_counter() - t0)
    size = files["exact"].stat().st_size
    equal = same_bytes(files["exact"], files["printf"])
    for f in files.values():
        f.unlink()
    best = {k: min(v) for k, v in times.items()}
    return {"grid": name, "lines": p.nx * p.ny, "bytes": size,
            "equal_bytes": equal, "exact_s": times["exact"],
            "printf_s": times["printf"], "best_exact_s": best["exact"],
            "best_printf_s": best["printf"],
            "printf_over_exact": best["printf"] / best["exact"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grids", nargs="+", default=GRIDS)
    p.add_argument("--turns", type=int, default=1)
    p.add_argument("-o", "--out", type=Path)
    args = p.parse_args(argv)
    smi = sweep_torch.card()
    rows = []
    for name in args.grids:
        row = run_grid(name, args.turns)
        if smi:
            row["nvidia_smi"] = smi
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"rows": rows}, indent=1) + "\n")
    return 0 if all(r["equal_bytes"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
