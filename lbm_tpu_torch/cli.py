"""Command-line entry point: ``python -m lbm_tpu_torch <paramfile> <obstaclefile>``.

The stdout contract of ``python -m lbm_tpu``: ``==done==``, the Reynolds
number and the four elapsed-time lines, then ``final_state.dat`` and
``av_vels.dat`` in the same byte formats. The resolved kernel and device
go to stderr on one line, with the planned segments of a ``cuda`` run
(for example ``resident G=100 x200``), and ``transposed`` where a wide
grid runs on the transposed lattice (``kernel: cuda on cuda (float32),
transposed: depth D=4 x5000``). ``--devices N`` shards the rows (a wide
grid: the columns) over N CUDA devices, clamped to the visible ones as
the JAX package's ``--devices`` is (the notes go to stderr).

``--chunk-iters`` and ``--checkpoint-every`` run the scene in chunks, each
planned on its own (the plan line then names each chunk length's
segments); ``--checkpoint-every`` saves an ``.npz`` after each chunk,
``--resume`` continues one (written by this package or by ``lbm_tpu``).
With periodic checkpointing on, SIGTERM or SIGINT stops the run at the
next chunk boundary with its state saved: exit code 75, one line on stderr
naming the ``--resume`` command, and no output files. ``--debug`` prints
the reference's per-step block; ``--trace DIR`` writes a
``torch.profiler`` trace of the compute phase. ``--compilation-cache DIR``
(or ``LBM_COMPILATION_CACHE``; the flag first) builds and reuses the
kernels' and the host module's libraries in DIR.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from lbm_tpu_torch import io as lio
from lbm_tpu_torch import runner
from lbm_tpu_torch.obstacles import load_obstacles
from lbm_tpu_torch.ops import _build, plan
from lbm_tpu_torch.parallel import halo
from lbm_tpu_torch.parallel.decomp import visible_devices
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
        "--devices",
        type=int,
        default=1,
        help="shard the lattice rows (a wide grid's columns) over this many "
             "devices of --device's type (1 = unsharded; clamped to the "
             "visible devices)",
    )
    p.add_argument(
        "--final-state-file", default=lio.FINAL_STATE_FILE, help="output path"
    )
    p.add_argument("--av-vels-file", default=lio.AV_VELS_FILE, help="output path")
    p.add_argument(
        "--iters", type=int, default=None, help="override maxIters (debugging)"
    )
    p.add_argument(
        "--debug", action="store_true",
        help="print per-step av velocity and total density "
             "(the reference's -DDEBUG block)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None, metavar="N",
        help="save a checkpoint every N steps. Cells are bit-identical "
             "to the uninterrupted run's for any N; av_vels too when N is "
             "even under a depth plan (a multiple of G under a resident "
             "or ring plan): an odd N leaves one step of each chunk to "
             "the one-step kernel, which sums in its own order (av_vels "
             "then agree to ~1e-6 relative)",
    )
    p.add_argument(
        "--checkpoint-file", default=None, metavar="PATH",
        help="checkpoint path (with --checkpoint-every; default "
             "lbm_checkpoint.npz)",
    )
    p.add_argument(
        "--resume", default=None, metavar="CKPT",
        help="resume from a checkpoint file (this package's or lbm_tpu's)",
    )
    p.add_argument(
        "--chunk-iters", type=int, default=None, metavar="N",
        help="bound any single planned set of kernel launches to N "
             "timesteps, without checkpoint I/O (identical trajectory: "
             "the cells' bits for any N, av_vels' bits for the strides "
             "--checkpoint-every names)",
    )
    p.add_argument(
        "--precision",
        choices=["float32", "float64"],
        default="float32",
        help="working precision: float32 matches the reference artifact; "
             "float64 reproduces the golden data's original code",
    )
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the compute phase into DIR "
             "(summarise with scripts/trace_report_torch.py)",
    )
    p.add_argument(
        "--compilation-cache", default=None, metavar="DIR",
        help="build and reuse the CUDA kernels' and the host module's "
             "libraries in DIR, an existing writable directory (also via "
             "LBM_COMPILATION_CACHE; default build/lbm_tpu_torch beside the "
             "package); each library is keyed by its sources' hash",
    )
    return p


def _describe_chunks(sizes, chunked: bool, describe) -> str:
    """The plan line's tail: ``describe(n)`` for a run in one go, or for
    each chunk length of a chunked one."""
    if not chunked:
        return describe(sizes[0])
    return "; ".join(f"{describe(n)} per {n}-step chunk" for n in sizes)


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except (OSError, ValueError) as exc:
        # The reference's die(): one line on stderr, exit 1.
        print(f"Error: {exc}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cache = args.compilation_cache or os.environ.get("LBM_COMPILATION_CACHE")
    if cache:
        _build.set_build_dir(cache)
    dtype = np.float64 if args.precision == "float64" else np.float32
    params = load_params(args.paramfile, dtype=dtype)
    obstacles = load_obstacles(args.obstaclefile, params.nx, params.ny)
    device = runner._resolve_device(args.device)
    iters = params.max_iters if args.iters is None else args.iters
    mesh = None
    if args.devices > 1:
        # Clamp to the visible devices, pad or demote to a divisor: the
        # policy lives in halo.resolve_mesh, as in the JAX package.
        mesh, notes = halo.resolve_mesh(
            params, obstacles, args.devices, args.kernel,
            devices=visible_devices(device.type))
        for note in notes:
            print(note, file=sys.stderr)

    ckpt_file = args.checkpoint_file
    if args.checkpoint_every is None:
        if ckpt_file is not None:
            # The runner errors on the reverse misconfiguration
            # (every-without-file); this direction silently saves
            # nothing, which deserves at least a note.
            print(
                "note: --checkpoint-file without --checkpoint-every "
                "saves nothing; pass --checkpoint-every N",
                file=sys.stderr,
            )
    elif ckpt_file is None:
        ckpt_file = "lbm_checkpoint.npz"

    # The chunk lengths the run takes, each planned on its own (the
    # debug loop steps one at a time).
    stride = args.checkpoint_every or args.chunk_iters
    start = runner.checkpoint_step(args.resume) if args.resume else 0
    chunked = bool(stride) or args.debug
    sizes = [1] if args.debug else runner.chunk_sizes(
        start, iters, stride if stride and stride > 0 else None)
    if mesh is not None:
        sp = halo.plan_run(params, obstacles, mesh, args.kernel, iters)
        kernel = args.kernel
        layout = ", transposed" if sp.transposed else ""
        line = (f"kernel: {sp.kernel} on {mesh.device_type} "
                f"({args.precision}){layout}")

        def describe(n):
            return halo.describe(
                halo.plan_run(params, obstacles, mesh, args.kernel, n), mesh)
    else:
        kernel = runner._resolve_kernel(args.kernel, params, device)
        line = f"kernel: {kernel} on {device} ({args.precision})"
        if kernel == "cuda":
            if runner.plan_layout(params, kernel):
                line += ", transposed"

        def describe(n):
            return plan.describe(runner.plan_run(params, kernel, n,
                                                 device=device))
    if sizes and (mesh is not None or kernel == "cuda"):
        line += ": " + _describe_chunks(sizes, chunked, describe)
    print(line, file=sys.stderr)

    result = runner.run_simulation(
        params, obstacles, kernel=kernel, n_iters=args.iters, device=device,
        mesh=mesh,
        debug=args.debug,
        checkpoint_every=args.checkpoint_every,
        checkpoint_file=ckpt_file,
        resume_from=args.resume,
        trace_dir=args.trace,
        chunk_iters=args.chunk_iters,
    )

    if result.preempted:
        # Graceful preemption (SIGTERM/SIGINT with periodic checkpointing
        # on): state through completed_steps is flushed to the checkpoint.
        # Write no final outputs (a partial final_state.dat would
        # masquerade as a finished run) and exit with EX_TEMPFAIL so an
        # orchestrator knows to launch again with --resume.
        print(
            f"preempted at step {result.completed_steps}/"
            f"{args.iters or params.max_iters}: checkpoint saved to "
            f"{ckpt_file}; resume with --resume {ckpt_file}",
            file=sys.stderr,
        )
        return 75  # EX_TEMPFAIL

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
