"""The simulation loop, the twin of :mod:`lbm_tpu.runner`.

One device: the run planned into segments (:mod:`.ops.plan`, the twin of
``lbm_tpu.runner._segments``), each stepped by one of three CUDA kernels
(one step, D steps or G steps per launch), with av_vels kept on the
device, scaled by 1/fluid cells each step, and copied to the host once at
the end. A wide grid (:func:`.ops.plan.transposed_layout`) runs on the
transposed lattice, the kernels in column mode, transposed in once and
out once (the twin of ``TransposedCarryStep`` and
``TransposedResidentStep``). The plain path (``reference``, and float64)
steps one timestep at a time, never transposed.

A mesh (``run_simulation(..., mesh=)``): the lattice's rows sharded over
the mesh's devices, padded where ny does not divide, or for a wide grid
the transposed lattice's rows (physical x), and stepped by
:mod:`.parallel.halo` (the seam modes of the one-step and depth kernels,
or the ring kernel under ``LBM_SHARD_RESIDENT=1``).

Not ported yet (ROADMAP 1.9, 1.10): checkpoint/resume, chunking, the
debug loop and tracing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.obstacles import num_non_obstacles_r
from lbm_tpu_torch.observables import calc_reynolds
from lbm_tpu_torch.ops import fused, fused_depth, plan, resident
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.profiling import PhaseTimers
from lbm_tpu_torch.state import initial_state, transpose_state

KERNELS = ("auto", "reference", "cuda")


@dataclasses.dataclass
class SimulationResult:
    cells: np.ndarray  # (9, ny, nx) final global state, params.dtype
    av_vels: np.ndarray  # (maxIters,) params.dtype
    reynolds: float
    timings: dict  # init / compute / collate / total seconds
    completed_steps: int = -1  # -1 = the full iteration count
    preempted: bool = False


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not there is
    an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            f"device {device!r} requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); use --device cpu"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _resolve_kernel(kernel: str, params: Params, device: torch.device) -> str:
    """``auto`` is the CUDA kernel for float32 on a CUDA device and the
    plain reference otherwise (float64 always takes the reference, as
    in lbm_tpu). An explicit ``cuda`` request that cannot run raises."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "auto":
        f32_cuda = device.type == "cuda" and params.dtype == np.float32
        kernel = "cuda" if f32_cuda else "reference"
    if kernel == "cuda" and params.dtype != np.float32:
        raise ValueError(
            "the cuda kernel is float32-only; use --kernel reference "
            "with --precision float64"
        )
    if kernel == "cuda" and device.type != "cuda":
        raise ValueError(
            f"the cuda kernel needs a CUDA device, got {device}; use "
            "--kernel reference on the CPU"
        )
    return kernel


def plan_layout(params: Params, kernel: str, transposed=None) -> bool:
    """Whether a run under ``kernel`` (as resolved) steps the transposed
    lattice: for ``cuda``, :func:`.ops.plan.layout`'s rule unless
    ``transposed`` says otherwise (the physical layout of a wide grid is
    built with ``transposed=False``, as JAX code can build ``CarryStep``
    for one); ``reference`` never transposes."""
    if kernel != "cuda":
        if transposed:
            raise ValueError("only the cuda kernel runs the transposed layout")
        return False
    return plan.layout(params)[0] if transposed is None else bool(transposed)


def plan_run(params: Params, kernel: str, iters: int, transposed=None):
    """The segments a run of ``iters`` steps takes under ``kernel`` (as
    resolved): :func:`.ops.plan.segments` on the execution layout's rows
    and lanes for ``cuda`` (:func:`plan_layout`), one plain segment for
    ``reference``."""
    if kernel == "cuda":
        t = plan_layout(params, kernel, transposed)
        rows, lanes = (params.nx, params.ny) if t else (params.ny, params.nx)
        return plan.segments(rows, lanes, iters)
    return [plan.Segment("reference", 1, iters)]


def _make_impl(seg: plan.Segment, mask, w1, w2, omega, axis: int):
    if seg.kernel == "resident":
        return resident.Resident(mask, w1, w2, omega, seg.steps_per_call, axis)
    if seg.kernel == "depth":
        return fused_depth.FusedDepth(mask, w1, w2, omega, seg.steps_per_call,
                                      axis)
    return fused.FusedStep(mask, w1, w2, omega, axis)


class _Simulation:
    """One run's device state: the ping-pong lattice buffers, the mask,
    av_vels and the planned segments' kernels, all allocated once. The
    ``cuda`` path also runs on CPU tensors, where every kernel wrapper
    takes its plain version. ``transposed``: the layout
    (:func:`plan_layout`; None, the planner's rule). A transposed run
    holds the lattice and the mask transposed from construction to the
    end of :meth:`run`, its kernels in column mode; ``cells`` is
    physical before and after."""

    def __init__(self, params: Params, cells, mask, kernel: str, iters: int,
                 transposed=None):
        self.params, self.kernel = params, kernel
        self.mask = mask
        self.transposed = plan_layout(params, kernel, transposed)
        self.cells = (transpose_state(cells) if self.transposed
                      else cells.contiguous())
        self.inv_fluid = num_non_obstacles_r(
            mask.cpu().numpy(), dtype=params.dtype
        )
        self.av_vels = torch.empty(iters, dtype=cells.dtype, device=cells.device)
        self.iters = iters
        self.segments = plan_run(params, kernel, iters, self.transposed)
        w1, w2, omega = params.accel_w1, params.accel_w2, params.omega
        if kernel == "cuda":
            exec_mask = mask.T.contiguous() if self.transposed else mask
            axis = int(self.transposed)
            self._impls = [
                (_make_impl(seg, exec_mask, w1, w2, omega, axis), seg.steps)
                for seg in self.segments]
            self._spare = torch.empty_like(self.cells)
        else:
            self._ref = (w1, w2, omega)

    def run(self) -> None:
        cells, av, inv = self.cells, self.av_vels, self.inv_fluid
        if self.kernel == "cuda":
            spare, t = self._spare, 0
            for impl, n in self._impls:
                spc = impl.steps_per_call
                for _ in range(n // spc):
                    cells, spare = impl.run(cells, spare, av, t, inv)
                    t += spc
        else:
            w1, w2, omega = self._ref
            scale = float(inv)
            for t in range(self.iters):
                cells, tot = ref_ops.fused_step(cells, self.mask, w1, w2, omega)
                av[t] = tot * scale
        self.cells = transpose_state(cells) if self.transposed else cells
        if cells.device.type == "cuda":
            torch.cuda.synchronize(cells.device)


def simulate(params: Params, cells, mask, kernel: str = "auto",
             n_iters: int | None = None, transposed=None):
    """Advance the device state ``cells`` (9, ny, nx) with bool ``mask``
    by ``n_iters`` steps (default ``params.max_iters``). Returns the
    final cells and the av_vels trajectory as device tensors; ``cells``
    is not modified. ``transposed``: the layout of a ``cuda`` run
    (:func:`plan_layout`; None, the planner's rule)."""
    iters = params.max_iters if n_iters is None else n_iters
    kernel = _resolve_kernel(kernel, params, cells.device)
    sim = _Simulation(params, cells.clone(), mask, kernel, iters, transposed)
    sim.run()
    return sim.cells, sim.av_vels


def run_simulation(
    params: Params,
    obstacles: np.ndarray,
    kernel: str = "auto",
    n_iters: int | None = None,
    device="cuda",
    mesh=None,
) -> SimulationResult:
    """Run the scene from the equilibrium state and return the final
    state, the trajectory, the Reynolds number and the phase times.

    ``kernel``: ``auto``, ``reference`` (plain PyTorch ops) or ``cuda``
    (the hand-written kernels, as :func:`plan_run` plans them).
    ``device``: where the state lives; a CUDA device must exist.
    ``mesh``: a :class:`.parallel.decomp.Mesh`; when given, the rows are
    sharded over its devices (``device`` is then unused).
    """
    timers = PhaseTimers()
    timers.start("total")
    timers.start("init")
    iters = params.max_iters if n_iters is None else n_iters
    if iters <= 0:
        raise ValueError(f"iteration count must be positive, got {iters}")
    if mesh is not None:
        return _run_sharded(params, obstacles, kernel, iters, mesh, timers)
    dev = _resolve_device(device)
    kernel = _resolve_kernel(kernel, params, dev)
    obstacles = np.asarray(obstacles, dtype=bool)
    mask = torch.from_numpy(obstacles.copy()).to(dev)
    # Init covers allocation, upload and (first use) the kernel build,
    # as lbm_tpu's init covers compilation.
    sim = _Simulation(params, initial_state(params, dev), mask, kernel, iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    timers.stop("init")

    with timers.phase("compute"):
        sim.run()  # ends in a device synchronize

    with timers.phase("collate"):
        cells_np = sim.cells.cpu().numpy()
        av_np = sim.av_vels.cpu().numpy()
        reynolds = float(calc_reynolds(params, sim.cells, mask))
    timers.stop("total")
    return SimulationResult(
        cells=cells_np,
        av_vels=av_np,
        reynolds=reynolds,
        timings=dict(timers.elapsed),
        completed_steps=iters,
    )


def _run_sharded(params: Params, obstacles, kernel: str, iters: int, mesh,
                 timers: PhaseTimers) -> SimulationResult:
    """The mesh branch of :func:`run_simulation`, the twin of
    ``lbm_tpu.runner.run_simulation``'s: plan the padding, step the
    shards, gather, slice the pad rows off, and take the Reynolds number
    on the unpadded lattice. A CUDA mesh without a card, or ``cuda`` on
    a CPU mesh, raises; nothing moves to the CPU or to fewer shards."""
    from lbm_tpu_torch.parallel import halo

    for dev in dict.fromkeys(mesh.devices):
        _resolve_device(dev)
    if kernel == "cuda" and mesh.device_type != "cuda":
        raise ValueError(
            f"the cuda kernel needs CUDA devices, got a mesh on "
            f"{mesh.device_type}; use --kernel reference on the CPU"
        )
    obstacles = np.asarray(obstacles, dtype=bool)
    sp = halo.plan_run(params, obstacles, mesh, kernel, iters)
    dev0 = mesh.devices[0]
    sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, dev0),
                                 sp.obstacles, mesh, sp.kernel, iters,
                                 sp.wrap_pad, sp.transposed)
    timers.stop("init")

    with timers.phase("compute"):
        sim.run()  # ends in a synchronize of every device of the mesh

    with timers.phase("collate"):
        cells, av = sim.result()
        cells = cells[:, sp.pad:]
        cells_np = cells.cpu().numpy()
        av_np = av.cpu().numpy()
        mask = torch.from_numpy(obstacles.copy()).to(dev0)
        reynolds = float(calc_reynolds(params, cells, mask))
    timers.stop("total")
    return SimulationResult(
        cells=cells_np,
        av_vels=av_np,
        reynolds=reynolds,
        timings=dict(timers.elapsed),
        completed_steps=iters,
    )
