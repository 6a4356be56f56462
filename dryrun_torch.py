"""Entry points of the PyTorch/CUDA port that also run without a card,
the twins of ``__graft_entry__``'s.

- ``entry(device="cuda")``: one timestep of the port's one-step kernel
  (``ops.fused.FusedStep``) on the 256x256 scene, returned as
  ``(step, (cells, obstacles))``; ``step(cells, obstacles)`` returns the
  new lattice and tot_u. On the CPU the wrapper takes its plain version.
- ``dryrun_multichip(n, device="cuda")``: every production sharding
  configuration of the port, run in this process on a mesh of ``n``
  shards of one device (``parallel.decomp.make_mesh(n, devices=[dev] *
  n)``: torch needs no subprocess to make devices), each planned as its
  name says and checked against the unsharded plain run. The cases are
  ``__graft_entry__._dryrun_cases`` without the ring's in-place mode,
  which the port leaves out (the TPU's VMEM workaround). On the CPU the
  ``cuda`` cases step the planned path on CPU tensors, every kernel
  wrapper taking its plain version; with ``device="cuda"`` the same
  cases run the CUDA kernels as ``n`` shards on one card.

Run: ``python dryrun_torch.py [--device cpu|cuda] [N]`` (default: the
card, 8 shards).
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys

import numpy as np

PLAN_ENV = ("LBM_SHARD_RESIDENT",)


def _params(nx, ny, iters=10):
    from lbm_tpu_torch.params import Params

    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def entry(device="cuda"):
    """``(step, (cells, obstacles))`` on the 256x256 scene of
    ``__graft_entry__.entry``, on ``device``."""
    import torch

    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.ops.fused import FusedStep
    from lbm_tpu_torch.runner import _resolve_device
    from lbm_tpu_torch.state import initial_state

    dev = _resolve_device(device)
    params = _params(256, 256)
    cells = initial_state(params, dev)
    obstacles = torch.from_numpy(
        generate_obstacles(params.nx, params.ny)).to(dev)
    w1, w2, omega = params.accel_w1, params.accel_w2, params.omega

    def step(cells, obstacles):
        kernel = FusedStep(obstacles, w1, w2, omega)
        new = torch.empty_like(cells)
        tot = torch.empty(1, dtype=cells.dtype, device=cells.device)
        kernel.step(cells, new, tot)
        return new, tot[0]

    return step, (cells, obstacles)


def _dryrun_cases(n_devices: int) -> list:
    """``(name, kernel, params, env)`` rows: the JAX package's cases
    (``__graft_entry__._dryrun_cases``) with ``pallas`` as the port's
    ``cuda``, less ``pallas/resident-ring-inplace``. One shape differs:
    the port transposes a wide grid only above 512x512 cells
    (``ops.plan.TRANSPOSED_MIN_CELLS``), so the ``-x`` cases take 16 rows
    of 16392 or more columns, a multiple of 8 and of the mesh."""

    def rows_of(minimum):
        return n_devices * -(-minimum // n_devices)

    side = rows_of(16)
    unit = 8 * n_devices // math.gcd(8, n_devices)
    wide = unit * (16384 // unit + 1)
    ring = {"LBM_SHARD_RESIDENT": "1"}
    ny_nondiv = 8 * n_devices + (1 if n_devices == 2 else 2)
    return [
        ("reference/rows", "reference", _params(32, rows_of(16), iters=20),
         {}),
        ("pallas/rows", "cuda", _params(side, side, iters=20), {}),
        ("pallas/rows-fused", "cuda", _params(8, 8 * n_devices, iters=20),
         {}),
        ("pallas/transposed-x", "cuda", _params(wide, 16, iters=20), {}),
        ("pallas/resident-ring", "cuda", _params(side, side, iters=20), ring),
        ("pallas/resident-ring-x", "cuda", _params(wide, 16, iters=20), ring),
        ("pallas/rows-padded", "cuda", _params(32, ny_nondiv, iters=20), {}),
        ("pallas/resident-ring-padded", "cuda",
         _params(32, ny_nondiv, iters=20), ring),
        ("reference/wall-less-wrap", "reference",
         _params(32, ny_nondiv, iters=20), {}),
        ("pallas/wall-less-wrap", "cuda", _params(32, ny_nondiv, iters=20),
         {}),
        ("reference/wall-less-fallback", "reference",
         _params(32, n_devices + 1, iters=20), {}),
    ]


@contextlib.contextmanager
def _env(values: dict):
    saved = {k: os.environ.pop(k, None) for k in PLAN_ENV}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def _run(params, obstacles, mesh, kernel, dev):
    """``(cells, av_vels)`` as numpy, the cells unpadded: the sharded
    run on ``mesh`` (as ``runner.run_simulation(mesh=)`` builds it, which
    refuses ``cuda`` on a CPU mesh), or the unsharded run without one."""
    import torch

    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.runner import _Simulation
    from lbm_tpu_torch.state import initial_state

    if mesh is None:
        sim = _Simulation(params, initial_state(params, dev),
                          torch.from_numpy(obstacles.copy()).to(dev), kernel,
                          params.max_iters)
        sim.run()
        cells, av, pad = sim.cells, sim.av_vels, 0
    else:
        sp = halo.plan_run(params, obstacles, mesh, kernel, params.max_iters)
        sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, dev),
                                     sp.obstacles, mesh, sp.kernel,
                                     params.max_iters, sp.wrap_pad)
        sim.run()
        cells, av = sim.result()
        pad = sp.pad
    return cells[:, pad:].cpu().numpy(), av.cpu().numpy()


def _check_plan(name, kernel, params, obstacles, mesh, n, ring, devices):
    """The assertions of ``__graft_entry__._dryrun_body`` on the plan
    ``kernel`` takes (host-only planners); returns the case's mesh."""
    from lbm_tpu_torch.parallel import halo
    from lbm_tpu_torch.parallel.decomp import largest_divisor_leq

    case_mesh = mesh
    if "wall-less" in name:
        case_mesh, notes = halo.resolve_mesh(params, obstacles, n, kernel,
                                             devices=devices)
        ny = params.ny
        pad = -(-ny // n) * n - ny
        if n > 1 and pad and pad <= (ny + pad) // n - 1:
            expected = n
        else:
            expected = largest_divisor_leq(ny, n)
        if n > 2 and name.endswith("-wrap") != (expected == n):
            raise AssertionError(
                f"{name}: case shape no longer exercises its policy "
                f"(ny={ny} over {n} -> expected {expected} devices)")
        got = case_mesh.size if case_mesh is not None else 1
        if got != expected:
            raise AssertionError(f"{name}: expected {expected} devices, got "
                                 f"{got} (notes={notes})")
        if kernel == "cuda" and case_mesh is not None and got == n:
            mode, _ = halo.plan_padding_mode(params, obstacles, case_mesh,
                                             kernel)
            if mode != "wrap":
                raise AssertionError(f"{name}: expected the seam kernel's "
                                     f"wrap plan, got {mode!r}")
    elif "-padded" in name:
        pad = halo.plan_row_padding(params, obstacles, mesh, kernel)
        if (pad > 0) != (n > 1):
            raise AssertionError(f"{name}: expected a non-divisor padding "
                                 f"plan (got pad={pad} on {n} devices)")
    else:
        transposed, _ = halo.plan_sharding(params, mesh, kernel)
        if transposed != name.endswith("-x"):
            raise AssertionError(f"{name}: unexpected sharding plan "
                                 f"(transposed={transposed})")
    if ring:
        sp = halo.plan_run(params, obstacles, mesh, kernel, params.max_iters)
        if not any(seg.kernel == "ring" for seg in sp.segments):
            raise AssertionError(f"{name}: planner did not select the ring "
                                 f"({[s.describe() for s in sp.segments]})")
    return case_mesh


def dryrun_multichip(n_devices: int, device="cuda") -> list[str]:
    """Run every case on ``n_devices`` shards of ``device`` (the card
    unless ``device="cpu"`` is passed), each against
    the unsharded plain run (cells rtol 2e-5 / atol 5e-8, av_vels rtol
    1e-4, the JAX dryrun's bounds); prints and returns one
    ``dryrun[name] ok`` line a case. Raises on the first failure."""
    import torch

    from lbm_tpu_torch.obstacles import generate_obstacles
    from lbm_tpu_torch.parallel.decomp import make_mesh
    from lbm_tpu_torch.runner import _resolve_device

    dev = _resolve_device(device)
    devices = [dev] * n_devices
    mesh = make_mesh(n_devices, devices=devices)
    lines = []
    for name, kernel, params, env in _dryrun_cases(n_devices):
        with _env(env):
            if "wall-less" in name:
                obstacles = np.zeros((params.ny, params.nx), dtype=bool)
            else:
                obstacles = generate_obstacles(params.nx, params.ny)
            case_mesh = _check_plan(name, kernel, params, obstacles, mesh,
                                    n_devices, bool(env), devices)
            base = _run(params, obstacles, None, "reference", dev)
            res = _run(params, obstacles, case_mesh, kernel, dev)
        np.testing.assert_allclose(
            base[0], res[0], rtol=2e-5, atol=5e-8,
            err_msg=f"{name}: sharded cells diverge from unsharded")
        np.testing.assert_allclose(
            base[1], res[1], rtol=1e-4,
            err_msg=f"{name}: sharded av_vels diverge from unsharded")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        n_used = case_mesh.size if case_mesh is not None else 1
        line = (f"dryrun[{name}] ok: {params.ny}x{params.nx} on {n_used} "
                f"devices matches unsharded")
        print(line, flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="shards of the one device (default 8)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    step, (cells, obstacles) = entry(args.device)
    new, tot = step(cells, obstacles)
    if not (bool(new.isfinite().all()) and math.isfinite(float(tot))):
        raise AssertionError("entry: the step is not finite")
    print("entry ok")
    dryrun_multichip(args.n, args.device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
