"""The fused-step kernel's wrapper: one timestep of the lattice in one
CUDA launch (``csrc/fused_step.cu``, the port of
``lbm_tpu/ops/pallas_fused.py::_kernel``, in row and in column mode),
plus a launch that sums the per-block tot_u partials on the device
(``csrc/lbm_reduce.cuh``); in seam mode (:class:`SeamStep`) the launch
sums them itself. Also what every kernel wrapper shares
(:class:`LatticeKernel`) and the launch counts of all of them.

A tensor on the CPU runs the plain version, :mod:`.reference`; that is
the only case the plain version stands in for the kernel. A CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.state import D2Q9

# Launch counts of every kernel of the package, one per kernel: the
# one-step kernel, the tot_u sum as a launch of its own (after every
# launch of the periodic one-step kernel, in both of its modes; the depth
# kernel and the seam one-step kernel sum in the launch), the depth
# kernel (one round a launch, and its flow form, "depth_flow"), the resident kernel in its device-memory form (and its shift
# mode, "resident_shift") and its on-chip form (two buffers, and one:
# "resident_onchip_inplace"), the seam modes of the one-step and depth
# kernels (one launch per shard) and the ring kernel (one launch per card)
# in its device-memory form and its on-chip form (two buffers, and one:
# "ring_onchip_inplace"), each also in column mode (the "_cols" counts:
# the transposed lattice of a wide grid; the shift mode has none), the
# three modes of the stream-cost probe and the tensor-core equilibrium's
# kernel ("mxu", row mode only). Only :func:`launch` increments them.
_KERNELS = ("step", "depth", "depth_flow", "resident", "resident_shift", "resident_onchip",
            "resident_onchip_inplace", "step_seam", "depth_seam", "ring",
            "ring_onchip", "ring_onchip_inplace")
LAUNCHES = {"reduce": 0, **{k + s: 0 for k in _KERNELS for s in ("", "_cols")},
            **{f"probe_{m}": 0 for m in ref_ops.PROBE_MODES}, "mxu": 0}


# Host nanoseconds spent inside the library's launch entry points, summed
# over every launch of the process (:func:`launch`): the ctypes call and
# what the entry point does on the host, cudaLaunchKernel (or its
# cooperative form) included, also where it blocks on a full launch queue.
LAUNCH_NS = 0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch(lib, name: str, what: str, entry, *args) -> None:
    """Launch a kernel: call the library's entry point ``entry(*args)``,
    raise on the error code it returns (``what`` names the launch), count
    one launch of ``name`` in :data:`LAUNCHES` and add the call's host
    nanoseconds to :data:`LAUNCH_NS`. Every kernel launch of the package
    goes through here."""
    global LAUNCH_NS
    t0 = time.perf_counter_ns()
    code = entry(*args)
    LAUNCH_NS += time.perf_counter_ns() - t0
    _build.check(lib, code, what)
    LAUNCHES[name] += 1


def new_scratch(rows: int, n: int, device):
    """The scratch of a kernel that sums tot_u in the launch, and the
    ``(rows, n)`` view of the last launch's per-tile partials. The
    scratch is ``rows * n`` slots that are empty between launches (the
    bits of -1, a NaN no sum produces), the block counter (one 32-bit
    word, zero between launches) and the ``rows * n`` partials as the
    block that summed them read them (``csrc/lbm_reduce.cuh``). Each
    kernel object owns its own, so no two launches share slots."""
    scratch = torch.full((2 * rows * n + 1,), -1, dtype=torch.int32,
                         device=device)
    scratch[rows * n] = 0
    scratch = scratch.view(torch.float32)
    return scratch, scratch[rows * n + 1:].view(rows, n)


class LatticeKernel:
    """What the kernel wrappers share: one obstacle mask, the scene
    constants, the association mode (``LBM_PAIRED_EQ`` / ``LBM_OMEGA_EQ``,
    read at construction, as the JAX package reads it when it traces a
    run), the forcing axis, the device, the checks on what a kernel
    takes, and on a CUDA mask the built kernel library.

    ``axis`` 0 forces the row H-2 of an (H, W) lattice; ``axis`` 1 is the
    column mode, for the transposed lattice of a wide grid: the column W-2
    is forced (:func:`.reference.forcing`). The mask is in the same
    layout as the lattice.

    ``run(a, b, out, t, scale)`` advances the lattice in ``a`` by
    ``steps_per_call`` steps, using ``b`` as the other buffer, writes
    ``scale * tot_u`` of each step into ``out[t:t + steps_per_call]``
    and returns ``(cells, spare)``: the buffer holding the result and
    the other one.
    """

    steps_per_call = 1

    def __init__(self, mask: torch.Tensor, w1, w2, omega, axis: int = 0):
        if mask.dtype != torch.bool or mask.dim() != 2:
            raise ValueError(
                f"mask must be a 2-D bool tensor, got {mask.dtype} "
                f"{tuple(mask.shape)}"
            )
        if axis not in (0, 1):
            raise ValueError(f"axis must be 0 or 1, got {axis}")
        self.mask, self.axis = mask, axis
        # The forced row (axis 0) or column (axis 1) of a periodic lattice.
        n = mask.shape[axis]
        self.accel = (n - 2) % n
        self.shape = (D2Q9.Q, *mask.shape)
        self.w1, self.w2, self.omega = (
            np.float32(w1), np.float32(w2), np.float32(omega)
        )
        self.mode = ref_ops.association_mode(torch.float32)
        self.device = mask.device
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"no CUDA kernel for device {self.device}")
        self._lib = _build.load()
        self._mask_u8 = mask.to(torch.uint8).contiguous()
        self._index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()

    @property
    def on_cpu(self) -> bool:
        return self.device.type == "cpu"

    def _check(self, t: torch.Tensor, name: str, shape) -> None:
        if t.device != self.device:
            raise ValueError(f"{name} is on {t.device}, mask on {self.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    def _check_call(self, src, dst, out, t: int) -> None:
        self._check(src, "src", self.shape)
        self._check(dst, "dst", self.shape)
        self._check(out, "out", out.shape)
        n = self.steps_per_call
        if out.dim() != 1 or t < 0 or t + n > out.shape[0]:
            raise ValueError(
                f"out[{t}:{t + n}] is not a slice of a 1-D tensor of "
                f"{out.shape[0] if out.dim() else 0}"
            )
        if src.data_ptr() == dst.data_ptr():
            raise ValueError("src and dst must be distinct buffers")

    def _stream(self):
        return torch.cuda.current_stream(self.device).cuda_stream

    def _launch(self, kernel: str, what: str, entry, *args) -> None:
        """:func:`launch` of ``kernel``, counted under its column mode's
        name in column mode."""
        launch(self._lib, kernel + ("_cols" if self.axis else ""), what,
               entry, *args)

    def _scale(self, scale) -> float:
        return float(np.float32(scale))


class FusedStep(LatticeKernel):
    """The one-step kernel: ``step(src, dst, out, t, scale)`` writes one
    timestep of ``src`` into ``dst`` and ``scale * tot_u`` into
    ``out[t]``. On a CUDA mask this builds the kernel library on first
    use and allocates the tot_u partials once; the kernel itself
    allocates nothing."""

    def __init__(self, mask: torch.Tensor, w1, w2, omega, axis: int = 0):
        super().__init__(mask, w1, w2, omega, axis)
        if self.on_cpu:
            return
        ny, nx = mask.shape
        if ny > self._lib.lbm_max_rows():
            raise ValueError(
                f"{ny} rows exceed the kernel's limit of "
                f"{self._lib.lbm_max_rows()}"
            )
        self._partials = torch.empty(
            self._lib.lbm_num_partials(ny, nx), dtype=torch.float32,
            device=self.device,
        )

    def step(self, src, dst, out, t: int = 0, scale=1.0) -> None:
        self._check_call(src, dst, out, t)
        if self.on_cpu:
            new, tot = ref_ops.fused_step(
                src, self.mask, self.w1, self.w2, self.omega, axis=self.axis
            )
            dst.copy_(new)
            out[t] = tot * self._scale(scale)
            return
        lib, ny, nx = self._lib, self.shape[1], self.shape[2]
        self._launch(
            "step", "fused step launch", lib.lbm_fused_step,
            src.data_ptr(), dst.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), ny, nx, self.accel, self.w1, self.w2,
            self.omega, self.mode, self.axis, self._index, self._stream())
        self._reduce(self._partials, out, t, scale)

    def run(self, a, b, out, t: int = 0, scale=1.0):
        self.step(a, b, out, t, scale)
        return b, a

    def _reduce(self, partials, out, t: int, scale) -> None:
        """``out[t] = scale * sum(partials)``: one launch of the
        fixed-order sum, behind every launch of this kernel (the depth
        and seam kernels run that sum in the launch)."""
        lib = self._lib
        launch(lib, "reduce", "tot_u reduce launch", lib.lbm_reduce_tot,
               partials.data_ptr(), partials.numel(), np.float32(scale),
               out.data_ptr() + 4 * t, self._index, self._stream())


class SeamKernel(LatticeKernel):
    """What the seam-mode wrappers share: a shard's mask rows, the static
    obstacle rows of its k-row halos, the global index ``row0`` of its
    first row and the global (padded) row count ``ny``. ``axis`` 1: a
    shard of the transposed lattice, sharded over its rows (physical x);
    the column W-2 of every row is forced, halo rows included."""

    def __init__(self, mask, hmask_s, hmask_n, w1, w2, omega, row0: int,
                 ny: int, axis: int = 0):
        super().__init__(mask, w1, w2, omega, axis)
        k = hmask_s.shape[0]
        for name, m in (("hmask_s", hmask_s), ("hmask_n", hmask_n)):
            if m.dtype != torch.bool or tuple(m.shape) != (k, mask.shape[1]) \
                    or m.device != mask.device:
                raise ValueError(f"{name} must be a ({k}, {mask.shape[1]}) "
                                 f"bool tensor on {mask.device}")
        if not 0 <= row0 <= ny - mask.shape[0]:
            raise ValueError(f"rows {row0}..{row0 + mask.shape[0] - 1} are "
                             f"not inside a lattice of {ny} rows")
        self.hmask_s, self.hmask_n = hmask_s, hmask_n
        self.k, self.row0, self.ny = k, int(row0), int(ny)
        self.halo_shape = (D2Q9.Q, k, mask.shape[1])
        if not self.on_cpu:
            self._hmask_u8 = (hmask_s.to(torch.uint8).contiguous(),
                              hmask_n.to(torch.uint8).contiguous())

    def _check_halos(self, halo_s, halo_n) -> None:
        self._check(halo_s, "halo_s", self.halo_shape)
        self._check(halo_n, "halo_n", self.halo_shape)

    def _plain(self, a, halo_s, halo_n, n: int):
        return ref_ops.halo_multi_step(
            a, halo_s, halo_n, self.mask, self.hmask_s, self.hmask_n,
            self.row0, self.ny, self.w1, self.w2, self.omega, n, self.axis)


class _SeamStepArgs(ctypes.Structure):
    """``csrc/fused_step.cu``'s ``SeamStepArgs``, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "src", "dst", "mask", "halo_s", "halo_n", "hmask_s", "hmask_n",
            "scratch", "out")),
        ("plane_s", ctypes.c_longlong), ("plane_n", ctypes.c_longlong),
        *((name, ctypes.c_float) for name in ("scale", "w1", "w2", "omega")),
        *((name, ctypes.c_int) for name in (
            "h", "nx", "row0", "ny_global", "wrap_row", "mode", "axis")),
    ]


class SeamStep(SeamKernel):
    """The one-step kernel in seam mode, bound to one shard:
    ``run(a, b, halo_s, halo_n, out, t, scale)`` writes one step of ``a``
    into ``b`` with row -1 from the last row of ``halo_s`` and row h from
    the first of ``halo_n``, ``scale * tot_u`` into ``out[t]`` (summed in
    the launch), and returns ``(b, a)``. A halo is any (9, k, nx) view
    whose rows are contiguous, so it may be a neighbouring shard's rows in
    place (plane stride h * nx) as well as a halo buffer. ``wrap_row``
    (the wrap pad's row p - 1 of shard 0, or -1): a row whose speeds are
    taken from row -1 instead, with its own obstacle flags, as the plain
    shard step refreshes it. On a CPU tensor it runs the plain version,
    :func:`.reference.halo_multi_step`."""

    def __init__(self, mask, hmask_s, hmask_n, w1, w2, omega, row0: int,
                 ny: int, axis: int = 0, wrap_row: int = -1):
        super().__init__(mask, hmask_s, hmask_n, w1, w2, omega, row0, ny,
                         axis)
        h, nx = mask.shape
        if not -1 <= wrap_row < h:
            raise ValueError(f"wrap_row {wrap_row} is not a row of the "
                             f"{h}-row shard")
        self.wrap_row = int(wrap_row)
        if self.on_cpu:
            return
        limit = self._lib.lbm_seam_max_rows(axis)
        if h > limit:
            raise ValueError(f"{h} rows exceed the kernel's limit of {limit}")
        self._scratch, self._partials = new_scratch(
            1, self._lib.lbm_seam_num_partials(h, nx, axis), self.device)

    def _check_halos(self, halo_s, halo_n) -> None:
        for t, name in ((halo_s, "halo_s"), (halo_n, "halo_n")):
            if tuple(t.shape) != self.halo_shape or t.dtype != torch.float32:
                raise ValueError(f"{name} must be a float32 "
                                 f"{self.halo_shape} tensor, got {t.dtype} "
                                 f"{tuple(t.shape)}")
            if t.stride(2) != 1 or t.stride(1) != self.shape[2]:
                raise ValueError(f"{name}'s rows must be contiguous")
            # Another card's rows are read in place only as a peer's.
            if t.device != self.device and not (
                    t.device.type == self.device.type == "cuda"):
                raise ValueError(f"{name} is on {t.device}, mask on "
                                 f"{self.device}")

    def run(self, a, b, halo_s, halo_n, out, t: int = 0, scale=1.0):
        if not self.on_cpu:
            self.launcher(a, b, halo_s, halo_n, out, scale)(t, self._stream())
            return b, a
        self._check_call(a, b, out, t)
        self._check_halos(halo_s, halo_n)
        src = a
        if self.wrap_row >= 0:
            src = a.clone()
            src[:, self.wrap_row] = halo_s[:, -1]
        new, tots = self._plain(src, halo_s, halo_n, 1)
        b.copy_(new)
        out[t] = tots[0] * self._scale(scale)
        return b, a

    def launcher(self, a, b, halo_s, halo_n, out, scale=1.0):
        """The launch of one step of ``a`` into ``b`` on these buffers,
        checked once: ``go(t, stream)`` writes ``scale * tot_u`` into
        ``out[t]`` and launches on the stream whose handle is ``stream``.
        For a loop that pairs the same buffers every other step; ``go``
        holds the tensors whose addresses it passes."""
        self._check_call(a, b, out, 0)
        self._check_halos(halo_s, halo_n)
        if self.on_cpu:
            raise ValueError("a launcher needs CUDA tensors")
        k, (h, nx) = self.k, self.mask.shape
        args = _SeamStepArgs(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            halo_s[:, k - 1].data_ptr(), halo_n[:, 0].data_ptr(),
            self._hmask_u8[0][k - 1].data_ptr(),
            self._hmask_u8[1][0].data_ptr(), self._scratch.data_ptr(),
            out.data_ptr(), halo_s.stride(0), halo_n.stride(0),
            self._scale(scale), self.w1, self.w2, self.omega, h, nx,
            self.row0, self.ny, self.wrap_row, self.mode, self.axis)
        lib, index, ref, n = self._lib, self._index, ctypes.byref(args), \
            out.shape[0]
        name = "step_seam_cols" if self.axis else "step_seam"

        def go(t: int, stream) -> None:
            if not 0 <= t < n:
                raise ValueError(f"out[{t}] is not in a tensor of {n}")
            launch(lib, name, "seam step launch", lib.lbm_fused_step_seam,
                   ref, t, index, stream)

        go.buffers = (a, b, halo_s, halo_n, out, args)
        return go


def fused_step(cells, obstacles, w1, w2, omega, axis: int = 0):
    """One timestep: ``(new_cells, tot_u)`` for a float32 (9, ny, nx)
    lattice and its (ny, nx) bool mask (``axis`` 1: a transposed lattice,
    column mode). Launches the kernel on a CUDA tensor; runs
    :func:`fused_step_plain` on a CPU tensor."""
    stepper = FusedStep(obstacles, w1, w2, omega, axis)
    new = torch.empty_like(cells)
    tot = torch.empty(1, dtype=torch.float32, device=cells.device)
    stepper.step(cells, new, tot)
    return new, tot[0]


def fused_step_plain(cells, obstacles, w1, w2, omega, axis: int = 0):
    """The kernel's plain version: :func:`.reference.fused_step` with
    the wrapper's signature."""
    return ref_ops.fused_step(cells, obstacles, w1, w2, omega, axis=axis)
