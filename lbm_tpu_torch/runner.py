"""The simulation loop, the main-path twin of :mod:`lbm_tpu.runner`: one
device, one kernel launch (plus one reduce launch) per timestep, with
av_vels kept on the device, scaled by 1/fluid cells each step, and
copied to the host once at the end.

Not ported yet (ROADMAP 1.9-1.11): checkpoint/resume, chunking, the
debug loop, tracing and sharding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbm_tpu_torch.obstacles import num_non_obstacles_r
from lbm_tpu_torch.observables import calc_reynolds
from lbm_tpu_torch.ops import fused
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.profiling import PhaseTimers
from lbm_tpu_torch.state import initial_state

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


class _Simulation:
    """One run's device state: the ping-pong lattice buffers, the mask,
    av_vels and the step implementation, all allocated once."""

    def __init__(self, params: Params, cells, mask, kernel: str, iters: int):
        self.params, self.kernel = params, kernel
        self.mask = mask
        self.cells = cells.contiguous()
        self.inv_fluid = num_non_obstacles_r(
            mask.cpu().numpy(), dtype=params.dtype
        )
        self.av_vels = torch.empty(iters, dtype=cells.dtype, device=cells.device)
        self.iters = iters
        w1, w2, omega = params.accel_w1, params.accel_w2, params.omega
        if kernel == "cuda":
            self._stepper = fused.FusedStep(mask, w1, w2, omega)
            self._spare = torch.empty_like(self.cells)
        else:
            self._ref = (w1, w2, omega)

    def run(self) -> None:
        cells, av, inv = self.cells, self.av_vels, self.inv_fluid
        if self.kernel == "cuda":
            stepper, spare = self._stepper, self._spare
            for t in range(self.iters):
                stepper.step(cells, spare, av, t, inv)
                cells, spare = spare, cells
        else:
            w1, w2, omega = self._ref
            scale = float(inv)
            for t in range(self.iters):
                cells, tot = ref_ops.fused_step(cells, self.mask, w1, w2, omega)
                av[t] = tot * scale
        self.cells = cells
        if cells.device.type == "cuda":
            torch.cuda.synchronize(cells.device)


def simulate(params: Params, cells, mask, kernel: str = "auto",
             n_iters: int | None = None):
    """Advance the device state ``cells`` (9, ny, nx) with bool ``mask``
    by ``n_iters`` steps (default ``params.max_iters``). Returns the
    final cells and the av_vels trajectory as device tensors; ``cells``
    is not modified."""
    iters = params.max_iters if n_iters is None else n_iters
    kernel = _resolve_kernel(kernel, params, cells.device)
    sim = _Simulation(params, cells.clone(), mask, kernel, iters)
    sim.run()
    return sim.cells, sim.av_vels


def run_simulation(
    params: Params,
    obstacles: np.ndarray,
    kernel: str = "auto",
    n_iters: int | None = None,
    device="cuda",
) -> SimulationResult:
    """Run the scene from the equilibrium state and return the final
    state, the trajectory, the Reynolds number and the phase times.

    ``kernel``: ``auto``, ``reference`` (plain PyTorch ops) or ``cuda``
    (the hand-written kernel). ``device``: where the state lives; a CUDA
    device must exist.
    """
    timers = PhaseTimers()
    timers.start("total")
    timers.start("init")
    iters = params.max_iters if n_iters is None else n_iters
    if iters <= 0:
        raise ValueError(f"iteration count must be positive, got {iters}")
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
