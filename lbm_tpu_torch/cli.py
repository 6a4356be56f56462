"""Command-line entry point: ``python -m lbm_tpu_torch <paramfile> <obstaclefile>``.

The stdout contract of ``python -m lbm_tpu``: ``==done==``, the Reynolds
number and the four elapsed-time lines, then ``final_state.dat`` and
``av_vels.dat`` in the same byte formats. The resolved kernel and device
go to stderr on one line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lbm_tpu_torch import io as lio
from lbm_tpu_torch import runner
from lbm_tpu_torch.obstacles import load_obstacles
from lbm_tpu_torch.params import load_params


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lbm_tpu_torch",
        description="D2Q9 BGK lattice-Boltzmann solver on PyTorch/CUDA",
    )
    p.add_argument("paramfile", help=".params scene file")
    p.add_argument("obstaclefile", help="obstacle .dat mask file")
    p.add_argument(
        "--kernel",
        choices=runner.KERNELS,
        default="auto",
        help="step implementation: the hand-written CUDA kernel or plain "
             "PyTorch ops (auto: cuda for float32 on a GPU)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device for the lattice (cuda, cuda:N or cpu)",
    )
    p.add_argument(
        "--final-state-file", default=lio.FINAL_STATE_FILE, help="output path"
    )
    p.add_argument("--av-vels-file", default=lio.AV_VELS_FILE, help="output path")
    p.add_argument(
        "--iters", type=int, default=None, help="override maxIters (debugging)"
    )
    p.add_argument(
        "--precision",
        choices=["float32", "float64"],
        default="float32",
        help="working precision: float32 matches the reference artifact; "
             "float64 reproduces the golden data's original code",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except (OSError, ValueError) as exc:
        # The reference's die(): one line on stderr, exit 1.
        print(f"Error: {exc}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    dtype = np.float64 if args.precision == "float64" else np.float32
    params = load_params(args.paramfile, dtype=dtype)
    obstacles = load_obstacles(args.obstaclefile, params.nx, params.ny)
    device = runner._resolve_device(args.device)
    kernel = runner._resolve_kernel(args.kernel, params, device)
    print(f"kernel: {kernel} on {device} ({args.precision})", file=sys.stderr)

    result = runner.run_simulation(
        params, obstacles, kernel=kernel, n_iters=args.iters, device=device
    )

    t = result.timings
    print("==done==")
    print("Reynolds number:\t\t%.12E" % result.reynolds)
    print("Elapsed Init time:\t\t\t%.6f (s)" % t["init"])
    print("Elapsed Compute time:\t\t\t%.6f (s)" % t["compute"])
    print("Elapsed Collate time:\t\t\t%.6f (s)" % t["collate"])
    print("Elapsed Total time:\t\t\t%.6f (s)" % t["total"])

    lio.write_final_state(args.final_state_file, params, result.cells, obstacles)
    lio.write_av_vels(args.av_vels_file, result.av_vels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
