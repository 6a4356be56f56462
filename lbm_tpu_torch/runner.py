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

Beyond the whole run in one go, as in the JAX package: chunked execution
(``chunk_iters``), periodic checkpoints and resume (an ``.npz`` of the
step index, the physical lattice as the writing run padded it and the
trajectory prefix, the JAX package's format, so a file written by either
package resumes in the other), graceful preemption on SIGTERM/SIGINT, a
debug mode printing the reference's per-step block, and a profiler trace
of the compute phase. Every kernel is bit-identical to the plain version,
so a chunked, a resumed and a single-shot run of a scene under the same
kernel and mesh give the same bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import mmap
import resource
from pathlib import Path

import numpy as np
import torch

from lbm_tpu_torch.obstacles import num_non_obstacles_r
from lbm_tpu_torch.observables import calc_reynolds, total_density
from lbm_tpu_torch.ops import fused, fused_depth, plan, resident
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.profiling import PhaseTimers
from lbm_tpu_torch.profiling import trace as _trace
from lbm_tpu_torch.state import (
    D2Q9, initial_state, initial_state_np, transpose_state,
)

KERNELS = ("auto", "reference", "cuda")


# Numbers the calls of run_simulation in this process: the ``run=<n>`` of
# every span of one call.
_RUNS = itertools.count(1)


@dataclasses.dataclass
class SimulationResult:
    """What a run returns. ``timings`` is its one per-scene record of the
    phases (:class:`.profiling.PhaseTimers`), each in seconds: ``init``
    (with ``init.plan``, the planning and the kernels' construction, and
    ``init.transpose``, the transposition of a lattice handed in to a
    transposed run), ``compute`` (with ``compute.wrappers``, the
    wrappers' own host time in the launch loop, less the library's launch
    calls; absent under ``reference``, which launches nothing; and, on a
    CUDA device only, ``compute.prefault``, the host array's preparation
    while the device finishes its queue), ``collate`` (with
    ``collate.copy``, the final lattice's copy to the host, and on the
    transposed layout ``collate.transpose``, its transposition back) and
    ``total``; on a CUDA device that transposes, ``transpose.device``,
    the device seconds of those transpositions (CUDA events); and counts,
    not seconds: ``collate.copy.minflt``, the process's minor page faults
    during that copy, ``collate.copy.bytes``, the bytes it copies,
    ``compute.launches.cols``, the run's column-mode launches, on a
    CUDA device ``compute.prefault.hidden``, 1 where the device was still
    busy when the preparation ended, else 0, and where the run launched
    the depth kernel's flow form, ``compute.depth.flow_tiles``, the tiles
    of its launches' rounds after the first, and ``compute.depth.waits``,
    those whose first poll found a neighbouring tile behind (ints).
    ``timings`` is the one record of a run that the benchmark
    (``lbmbench.harness.Port``) copies whole, so a per-run count goes here
    beside the seconds."""

    cells: np.ndarray  # (9, ny, nx) final global state, params.dtype
    av_vels: np.ndarray  # (maxIters,) params.dtype
    reynolds: float
    timings: dict
    # Graceful preemption (the checkpointing paths only): the number of
    # steps actually completed, and whether the run stopped early on
    # SIGTERM/SIGINT with its state flushed to the checkpoint file.
    # av_vels entries past completed_steps are zeros, not trajectory.
    completed_steps: int = -1  # -1 = the full iteration count
    preempted: bool = False


class _PreemptionGuard:
    """Graceful-preemption watch for the chunked loops: while active,
    SIGTERM/SIGINT set a flag instead of killing the process, so the
    loop can flush a checkpoint at the next chunk boundary and stop
    early with a resumable state (accelerator jobs are routinely
    preempted, and the reference simply lost the whole run). A SECOND
    signal restores default handling (the escalation path if the current
    chunk hangs). Armed only when periodic checkpointing gives the loop
    a boundary to stop at; inert outside the main thread, where
    ``signal.signal`` raises."""

    _SIGNALS = ("SIGTERM", "SIGINT")

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.requested = False
        self._saved = {}

    def _handle(self, signum, frame):
        self.requested = True
        self._restore()  # second signal: default (deadly) behaviour

    def _restore(self):
        import signal as _signal

        for num, prev in self._saved.items():
            _signal.signal(num, prev)
        self._saved = {}

    def __enter__(self):
        if not self.enabled:
            return self
        import signal as _signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return self
        for name in self._SIGNALS:
            num = getattr(_signal, name, None)
            if num is None:
                continue
            self._saved[num] = _signal.signal(num, self._handle)
        return self

    def __exit__(self, *exc):
        self._restore()
        return False


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


def _check_mesh(mesh, kernel: str) -> None:
    """A CUDA mesh without a card, or ``cuda`` on a CPU mesh, raises:
    nothing moves to the CPU or to the plain version."""
    for dev in dict.fromkeys(mesh.devices):
        _resolve_device(dev)
    if kernel == "cuda" and mesh.device_type != "cuda":
        raise ValueError(
            f"the cuda kernel needs CUDA devices, got a mesh on "
            f"{mesh.device_type}; use --kernel reference on the CPU"
        )


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


def plan_run(params: Params, kernel: str, iters: int, transposed=None,
             device=None):
    """The segments a run (or one chunk) of ``iters`` steps takes under
    ``kernel`` (as resolved): :func:`.ops.plan.segments` on the execution
    layout's rows and lanes for ``cuda`` (:func:`plan_layout`), one plain
    segment for ``reference``. On a CUDA ``device`` the resident
    segments carry the kernel's form there (:func:`.ops.resident.
    segments`)."""
    if kernel == "cuda":
        t = plan_layout(params, kernel, transposed)
        rows, lanes = (params.nx, params.ny) if t else (params.ny, params.nx)
        return resident.segments(rows, lanes, iters, device, axis=int(t))
    return [plan.Segment("reference", 1, iters)]


def chunk_sizes(start_step: int, iters: int, stride: int | None) -> list[int]:
    """The distinct chunk lengths of a run from ``start_step`` to
    ``iters`` in chunks of ``stride`` steps (None: the rest in one go):
    the full stride and, where it does not divide the rest, the shorter
    tail, in the order they first run. Each gets its own planned set of
    kernels, as the JAX package compiles one runner per size."""
    stride = stride or (iters - start_step)
    sizes, tt = [], start_step
    while tt < iters:
        n = min(stride, iters - tt)
        if n not in sizes:
            sizes.append(n)
        tt += n
    return sizes


def _make_impl(seg: plan.Segment, mask, w1, w2, omega, axis: int):
    if seg.kernel == "resident":
        return resident.Resident(mask, w1, w2, omega, seg.steps_per_call, axis,
                                 seg.form)
    if seg.kernel == "depth":
        return fused_depth.FusedDepth(mask, w1, w2, omega,
                                      seg.steps_per_call // seg.rounds, axis,
                                      seg.rounds)
    return fused.FusedStep(mask, w1, w2, omega, axis)


@contextlib.contextmanager
def _transposition(timers, phase: str, device, events: list):
    """A block that transposes a lattice: the phase ``phase`` of
    ``timers`` and, on a CUDA ``device``, a CUDA event before and after
    it on the current stream, the pair appended to ``events``
    (:meth:`_Simulation.record_transposes`)."""
    with timers.phase(phase):
        if device.type != "cuda":
            yield
            return
        stream = torch.cuda.current_stream(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        yield
        end.record(stream)
    events.append((start, end))


class _Simulation:
    """One run's device state: the ping-pong lattice buffers, the mask,
    av_vels and the planned segments' kernels, all allocated once. The
    ``cuda`` path also runs on CPU tensors, where every kernel wrapper
    takes its plain version. ``transposed``: the layout
    (:func:`plan_layout`; None, the planner's rule). A transposed run
    holds the lattice and the mask transposed from construction on, its
    kernels in column mode, and transposes back only in :meth:`result`.
    ``cells`` None: the run starts from rest, its lattice built in the
    execution layout (:func:`.state.initial_state`), so a transposed run
    from rest makes no physical lattice and transposes nothing in; a
    lattice handed in is transposed under the phase ``init.transpose``.

    The chunk form: ``sizes`` are the chunk lengths the run will take
    (default: ``iters`` in one go), each planned on its own
    (:func:`plan_run`, so a 7-step chunk plans a main segment and a tail)
    with every kernel built here, kernels of the same granularity shared.
    :meth:`run_chunk` runs ``n`` steps from step ``t0`` and writes
    ``av_vels[t0:t0 + n]``; ``av0`` fills the trajectory before the first
    chunk of a resumed run. ``timers``: the run's
    :class:`.profiling.PhaseTimers`, which time the planning
    (``init.plan``) and each segment's launch loop."""

    def __init__(self, params: Params, cells, mask, kernel: str, iters: int,
                 transposed=None, sizes=None, av0=None, timers=None):
        self.params, self.kernel = params, kernel
        self.mask = mask
        self.timers = PhaseTimers() if timers is None else timers
        self.transposed = plan_layout(params, kernel, transposed)
        # The CUDA events around the timed transpositions (_transposition).
        self.transposes = []
        if cells is None:
            self._exec = initial_state(params, mask.device,
                                       transposed=self.transposed)
        elif self.transposed:
            with _transposition(self.timers, "init.transpose", cells.device,
                                self.transposes):
                self._exec = transpose_state(cells)
        else:
            self._exec = cells.contiguous()
        self.inv_fluid = num_non_obstacles_r(
            mask.cpu().numpy(), dtype=params.dtype
        )
        # Zeros: a preempted run returns zeros past its completed steps.
        self.av_vels = torch.zeros(iters, dtype=self._exec.dtype,
                                   device=self._exec.device)
        if av0 is not None:
            self.av_vels.copy_(torch.from_numpy(np.asarray(av0)))
        self.iters = iters
        self._ref = (params.accel_w1, params.accel_w2, params.omega)
        self._kernels, self._plans = {}, {}
        with self.timers.phase("init.plan"):
            self.segments = plan_run(params, kernel, iters, self.transposed,
                                     self._exec.device)
            if kernel == "cuda":
                self._exec_mask = (mask.T.contiguous() if self.transposed
                                   else mask)
                self._spare = torch.empty_like(self._exec)
            for n in (iters,) if sizes is None else sizes:
                self._plan(n)

    def _plan(self, n: int):
        """The kernels of an ``n``-step chunk, ``[(impl, segment), ...]``
        (no kernel on the plain path)."""
        if n not in self._plans:
            axis = int(self.transposed)
            parts = []
            for seg in plan_run(self.params, self.kernel, n, self.transposed,
                                self._exec.device):
                key = (seg.kernel, seg.steps_per_call, seg.form, seg.rounds)
                if self.kernel == "cuda" and key not in self._kernels:
                    self._kernels[key] = _make_impl(seg, self._exec_mask,
                                                    *self._ref, axis)
                parts.append((self._kernels.get(key), seg))
            self._plans[n] = parts
        return self._plans[n]

    def run_chunk(self, t0: int, n: int) -> None:
        """``n`` steps from step ``t0``; returns without waiting for the
        device."""
        av, inv, t = self.av_vels, self.inv_fluid, t0
        w1, w2, omega = self._ref
        scale = float(inv)

        def plain(t):
            self._exec, tot = ref_ops.fused_step(self._exec, self.mask, w1,
                                                 w2, omega)
            av[t] = tot * scale

        for impl, seg in self._plan(n):
            def launch(t, impl=impl):
                # The result may be in either buffer (an odd number of
                # one-step launches): keep both as they come back.
                self._exec, self._spare = impl.run(self._exec, self._spare,
                                                   av, t, inv)

            t = self.timers.segment(seg, t, plain if impl is None else launch)

    def synchronize(self) -> None:
        if self._exec.device.type == "cuda":
            torch.cuda.synchronize(self._exec.device)

    def flow_counts(self):
        """``(waits, flowing tiles)`` of the run's depth launches of more
        than one round (:class:`.ops.fused_depth.FusedDepth`), or None
        where it has none. Call it once the device is done."""
        flows = [k for k in self._kernels.values()
                 if isinstance(k, fused_depth.FusedDepth) and k.rounds > 1]
        if not flows:
            return None
        return (sum(k.waits() for k in flows),
                sum(k.flow_tiles for k in flows))

    def run(self) -> None:
        """The whole run in one chunk; ``cells`` is then the physical
        final lattice."""
        self.run_chunk(0, self.iters)
        self.cells = self.result()[0]
        self.synchronize()

    def result(self):
        """``(cells, av_vels)``: the physical (9, ny, nx) lattice as it
        stands and the trajectory, on the device."""
        cells = transpose_state(self._exec) if self.transposed else self._exec
        return cells, self.av_vels

    def record_transposes(self) -> None:
        """``timings["transpose.device"]``: the device seconds between the
        CUDA events of :attr:`transposes`, where there are any. Call it
        once the host has waited for them (the collate copy does)."""
        if self.transposes:
            self.timers.elapsed["transpose.device"] = 1e-3 * sum(
                start.elapsed_time(end) for start, end in self.transposes)

    def av_value(self, t: int) -> float:
        """``av_vels[t]`` on the host (waits for step ``t``)."""
        return float(self.av_vels[t])

    def total_density(self, pad_rows: int = 0) -> float:
        return float(total_density(self._exec))


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


def save_checkpoint(path: str | Path, step: int, cells, av_vels) -> None:
    """Persist (step, lattice, trajectory prefix) as .npz, the JAX
    package's format: ``cells`` is the physical (9, ny + pad, nx) lattice
    as the writing run padded it, never the transposed one."""
    np.savez_compressed(
        path,
        step=np.int64(step),
        cells=np.asarray(cells),
        av_vels=np.asarray(av_vels),
    )


def _read_checkpoint(path: str | Path, read):
    try:
        with np.load(path) as z:
            return read(z)
    except OSError:
        raise  # missing/unreadable file: already on the CLI die() path
    except Exception as exc:
        # zipfile.BadZipFile (truncated/corrupt), KeyError (missing
        # arrays), EOFError, numpy's misleading pickled-data ValueError:
        # translate to the CLI's one-line die() contract instead of an
        # unhandled traceback or a cryptic message.
        raise ValueError(f"invalid checkpoint file {path!r}: {exc!r}") \
            from exc


def load_checkpoint(path: str | Path):
    """Returns (step, cells, av_vels) from a checkpoint file."""
    return _read_checkpoint(
        path, lambda z: (int(z["step"]), z["cells"], z["av_vels"]))


def checkpoint_step(path: str | Path) -> int:
    """The step a checkpoint file was written at (reads only that)."""
    return _read_checkpoint(path, lambda z: int(z["step"]))


def _resume_state(path, iters: int, orig_ny: int, params: Params,
                  pad_rows: int):
    """``(start_step, cells, av0)`` of a run of ``iters`` steps resumed
    from the checkpoint at ``path``: the lattice as THIS run pads it
    (``params`` is the padded scene, ``pad_rows`` its pad) and the
    (iters,) trajectory with the checkpoint's prefix."""
    start_step, cells_np, av_prefix = load_checkpoint(path)
    if not 0 <= start_step <= iters:
        # A clamp here would return the checkpoint's too-advanced
        # lattice as the "result" of a shorter run.
        raise ValueError(
            f"checkpoint at step {start_step} cannot resume a "
            f"{iters}-iteration run"
        )
    # Reconcile row padding: checkpoints store the PADDED lattice of the
    # run that wrote them, and this run's device count may pad
    # differently. Pad rows never feed the interior: wall-shielded pads
    # are causally disconnected behind the walls, and wrap-mode pads are
    # rewritten from the wrap halo before any real row reads them
    # (plan_padding_mode), so stripping the writer's pad and substituting
    # fresh equilibrium pad rows is exact either way.
    old_pad = (cells_np.shape[1] - orig_ny) if cells_np.ndim == 3 else -1
    if (old_pad < 0 or cells_np.shape[0] != D2Q9.Q
            or cells_np.shape[2] != params.nx):
        raise ValueError(
            f"checkpoint lattice shape {cells_np.shape} does not "
            f"match the {orig_ny}x{params.nx} scene"
        )
    if old_pad != pad_rows:
        interior = cells_np[:, old_pad:, :]
        if pad_rows:
            fresh = initial_state_np(params, dtype=params.dtype)
            fresh[:, pad_rows:, :] = interior
            cells_np = fresh
        else:
            cells_np = interior
    if len(av_prefix) < start_step:
        # A truncated write (or a hand-edited step field) would
        # otherwise surface as a raw numpy broadcast error.
        raise ValueError(
            f"checkpoint av_vels prefix has {len(av_prefix)} "
            f"entries but claims step {start_step}"
        )
    av0 = np.zeros((iters,), dtype=params.dtype)
    av0[:start_step] = av_prefix[:start_step]
    cells = np.ascontiguousarray(cells_np, dtype=params.dtype)
    return start_step, cells, av0


def run_simulation(
    params: Params,
    obstacles: np.ndarray,
    kernel: str = "auto",
    n_iters: int | None = None,
    device="cuda",
    mesh=None,
    debug: bool = False,
    checkpoint_every: int | None = None,
    checkpoint_file: str | Path | None = None,
    resume_from: str | Path | None = None,
    trace_dir: str | Path | None = None,
    chunk_iters: int | None = None,
) -> SimulationResult:
    """Run the scene from the equilibrium state (or a checkpoint) and
    return the final state, the trajectory, the Reynolds number and the
    phase times.

    ``kernel``: ``auto``, ``reference`` (plain PyTorch ops) or ``cuda``
    (the hand-written kernels, as :func:`plan_run` plans them).
    ``device``: where the state lives; a CUDA device must exist.
    ``mesh``: a :class:`.parallel.decomp.Mesh`; when given, the rows are
    sharded over its devices (``device`` is then unused).
    ``checkpoint_every``/``checkpoint_file``: periodically persist state;
    ``resume_from``: continue a previous run's checkpoint (written by
    this package or by ``lbm_tpu``, under any row padding).
    ``chunk_iters``: bound any single planned set of launches to this
    many timesteps WITHOUT checkpoint I/O (the trajectory is identical:
    the same chunks the checkpoint path runs, minus the saves).
    ``debug``: print the reference's -DDEBUG per-step block (slow path).
    ``trace_dir``: capture a ``torch.profiler`` trace of the compute
    phase (:func:`.profiling.trace`; summarise with
    ``scripts/trace_report_torch.py``).

    Under a profiler, the phases are spans ``lbm.init`` (with
    ``lbm.init.plan`` and, where a lattice handed in is transposed,
    ``lbm.init.transpose``), ``lbm.compute`` (with one
    ``lbm.segment.<kernel>`` a planned segment a chunk and, on a CUDA
    device, ``lbm.compute.prefault``) and ``lbm.collate`` (with
    ``lbm.collate.copy`` and, on the transposed layout,
    ``lbm.collate.transpose``), all with the args ``run=<n>``, ``n`` this
    call's number in the process (:class:`.profiling.PhaseTimers`).
    """
    timers = PhaseTimers(run=next(_RUNS))
    timers.start("total")
    with timers.phase("init"):
        if checkpoint_every is not None and checkpoint_every <= 0:
            raise ValueError(
                f"checkpoint_every must be a positive step count, "
                f"got {checkpoint_every}"
            )
        if checkpoint_every is not None and checkpoint_file is None:
            # Without a file the chunked path would run and save nothing: a
            # misconfiguration, not a request. Execution-length bounding
            # without I/O is chunk_iters' job.
            raise ValueError(
                "checkpoint_every requires checkpoint_file (periodic "
                "checkpointing needs somewhere to write); to bound "
                "execution length without saving, use chunk_iters"
            )
        if chunk_iters is not None and chunk_iters <= 0:
            raise ValueError(
                f"chunk_iters must be a positive step count, got "
                f"{chunk_iters}")
        if chunk_iters is not None and checkpoint_every is not None:
            # Two competing strides would silently pick one; refuse.
            raise ValueError(
                "chunk_iters and checkpoint_every are mutually exclusive "
                "(checkpointing already chunks at its own stride)"
            )
        iters = params.max_iters if n_iters is None else n_iters
        if iters <= 0:
            raise ValueError(
                f"iteration count must be positive, got {iters}")
        obstacles = np.asarray(obstacles, dtype=bool)
        # The scene as it is stepped: padded under a non-divisor mesh.
        run_params, run_obstacles, pad_rows, sp = params, obstacles, 0, None
        if mesh is not None:
            from lbm_tpu_torch.parallel import halo

            _check_mesh(mesh, kernel)
            sp = halo.plan_run(params, obstacles, mesh, kernel, iters)
            run_params, run_obstacles, pad_rows = (sp.params, sp.obstacles,
                                                   sp.pad)
            dev = mesh.devices[0]
        else:
            dev = _resolve_device(device)
            kernel = _resolve_kernel(kernel, params, dev)

        start_step, av0 = 0, None
        if resume_from is not None:
            start_step, cells_np, av0 = _resume_state(
                resume_from, iters, params.ny, run_params, pad_rows)
            cells0 = torch.from_numpy(cells_np).to(dev)
        elif mesh is not None:
            cells0 = initial_state(run_params, dev)
        else:
            cells0 = None  # from rest, in the run's own layout

        checkpointing = bool(checkpoint_every and checkpoint_file is not None)
        stride = checkpoint_every or chunk_iters
        sizes = [1] if debug else chunk_sizes(start_step, iters, stride)
        # Init covers allocation, upload and (first use) the kernel build of
        # every chunk length, as lbm_tpu's init covers compilation.
        if mesh is not None:
            sim = halo.ShardedSimulation(
                run_params, cells0, run_obstacles, mesh, sp.kernel, iters,
                sp.wrap_pad, sp.transposed, sizes=sizes, av0=av0,
                start_step=start_step, timers=timers)
        else:
            sim = _Simulation(run_params, cells0,
                              torch.from_numpy(obstacles.copy()).to(dev),
                              kernel, iters, sizes=sizes, av0=av0,
                              timers=timers)
        del cells0  # the run holds its own lattice
        sim.synchronize()

    def save(step: int) -> None:
        # The copies to the host are the fence.
        cells, av = sim.result()
        save_checkpoint(checkpoint_file, step, cells.cpu().numpy(),
                        av.cpu().numpy())

    # The profiler trace covers the compute phase only, entered after
    # every kernel is built.
    trace_ctx = (_trace(str(trace_dir), cuda=dev.type == "cuda")
                 if trace_dir is not None else contextlib.nullcontext())
    guard = _PreemptionGuard(enabled=checkpointing)
    tt = start_step
    cols = _cols_launches()
    with trace_ctx, timers.phase("compute"):
        with guard:
            if debug:
                tt = _debug_loop(sim, start_step, iters, pad_rows, guard,
                                 checkpoint_every if checkpointing else None,
                                 save)
            while not debug and tt < iters:
                n = min(stride or iters - tt, iters - tt)
                sim.run_chunk(tt, n)
                tt += n
                if checkpointing:
                    save(tt)
                if guard.requested:
                    # Preempted: the chunk just completed and its state
                    # is flushed; stop here, the caller resumes from the
                    # checkpoint (latency bound: one chunk).
                    break
            out = (_prepare_host(timers, dev, (D2Q9.Q, params.ny, params.nx),
                                 params.dtype)
                   if dev.type == "cuda" else None)
            sim.synchronize()
    timers.elapsed["compute.launches.cols"] = _cols_launches() - cols
    flow = sim.flow_counts() if mesh is None else None
    if flow is not None:
        (timers.elapsed["compute.depth.waits"],
         timers.elapsed["compute.depth.flow_tiles"]) = flow

    # Collate: device -> host copy of the final lattice and trajectory;
    # the Reynolds number is taken on the device-resident state, on the
    # unpadded lattice.
    with timers.phase("collate"):
        transposing = (
            _transposition(timers, "collate.transpose", dev, sim.transposes)
            if mesh is None and sim.transposed else contextlib.nullcontext())
        with transposing:
            cells, av = sim.result()
        cells = cells[:, pad_rows:]
        with timers.phase("collate.copy"):
            faults = _minor_faults()
            if out is None:
                cells_np = cells.cpu().numpy()
            else:
                cells_np = out
                torch.from_numpy(out).copy_(cells)
            timers.elapsed["collate.copy.minflt"] = _minor_faults() - faults
        timers.elapsed["collate.copy.bytes"] = (cells.numel()
                                                * cells.element_size())
        if mesh is None:
            sim.record_transposes()
        av_np = av.cpu().numpy()
        mask = torch.from_numpy(obstacles.copy()).to(cells.device)
        reynolds = float(calc_reynolds(params, cells, mask))
    timers.stop("total")
    return SimulationResult(
        cells=cells_np,
        av_vels=av_np,
        reynolds=reynolds,
        timings=dict(timers.elapsed),
        completed_steps=tt,
        preempted=guard.requested and tt < iters,
    )


def prefaulted_array(shape, dtype) -> np.ndarray:
    """A fresh C-contiguous array of ``shape`` and ``dtype`` with one byte
    of each of its pages written, so a copy into it pays no first touch:
    an array above the allocator's mmap threshold (the 37.7 MB of a 1024²
    lattice) is a fresh mapping every call, each page faulted in by its
    first write."""
    out = np.empty(shape, dtype)
    flat = out.reshape(-1).view(np.uint8)
    flat[::mmap.PAGESIZE] = 0
    flat[-1:] = 0
    return out


def _prepare_host(timers, device, shape, dtype) -> np.ndarray:
    """The collate's destination, prepared while ``device`` runs the
    launches queued so far (phase ``compute.prefault``);
    ``compute.prefault.hidden`` says whether the device was still busy
    when it was ready."""
    queued = torch.cuda.Event()
    queued.record(torch.cuda.current_stream(device))
    with timers.phase("compute.prefault"):
        out = prefaulted_array(shape, dtype)
    timers.elapsed["compute.prefault.hidden"] = int(not queued.query())
    return out


def _cols_launches() -> int:
    """The column-mode launches of the process so far: the ``_cols``
    counts of :data:`.ops.fused.LAUNCHES`."""
    counts = fused.LAUNCHES
    return sum(counts[name] for name in counts if name.endswith("_cols"))


def _minor_faults() -> int:
    """The process's minor page faults so far: the process's, not the
    thread's, since the CUDA driver may touch a copy's pages from a thread
    of its own."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def _debug_loop(sim, start_step: int, iters: int, pad_rows: int, guard,
                checkpoint_every, save) -> int:
    """The per-step loop printing the reference's -DDEBUG block
    (d2q9-bgk.c:198-202), on one device and under a mesh (one-step
    chunks; the per-step reduce and host fetch are the debug path's
    explicit cost). It resumes mid-trajectory, honours periodic
    checkpointing, and on a signal flushes a checkpoint at once: there is
    no chunk boundary to wait for. Returns the steps completed."""
    done = start_step
    for tt in range(start_step, iters):
        sim.run_chunk(tt, 1)
        print("==timestep: %d==" % tt)
        print("av velocity: %.12E" % sim.av_value(tt))
        # Without the wall-shielded pad rows of a non-divisor mesh: their
        # mass is not part of the scene, and the pad row next to the wall
        # is not exactly at rest.
        print("tot density: %.12E" % sim.total_density(pad_rows))
        done = tt + 1
        if checkpoint_every and (done % checkpoint_every == 0
                                 or done == iters or guard.requested):
            save(done)
        if guard.requested:
            break
    return done
