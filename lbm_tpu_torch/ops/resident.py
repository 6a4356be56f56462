"""The resident kernel's wrapper: ``gsteps`` timesteps of the lattice in
one persistent, cooperative CUDA launch (``csrc/resident.cu``, the port
of ``lbm_tpu/ops/pallas_resident.py::_kernel_resident``, in row mode and
in the column mode of its ``lane_accel``), which also writes the
``gsteps`` tot_u values on the device.

A tensor on the CPU runs the plain version,
:func:`.reference.multi_step`; a CUDA tensor launches the kernel or
raises, also when the device refuses the cooperative launch. The kernel
ping-pongs between the two buffers it is given, so the result is in the
first after an even ``gsteps`` and in the second after an odd one; the
CPU path keeps the same contract.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LAUNCHES, LatticeKernel


class Resident(LatticeKernel):
    """The resident kernel bound to one mask: ``run(a, b, out, t,
    scale)`` runs ``gsteps`` steps from ``a`` and returns ``(cells,
    spare)``: ``(a, b)`` for an even ``gsteps``, ``(b, a)`` for an odd
    one. On a CUDA mask the block count of the cooperative launch is
    fixed at construction (co-resident blocks, at most one per 32x8
    tile) and the (gsteps, blocks) partials are allocated once."""

    def __init__(self, mask: torch.Tensor, w1, w2, omega, gsteps: int,
                 axis: int = 0):
        if gsteps < 1:
            raise ValueError(f"gsteps must be positive, got {gsteps}")
        super().__init__(mask, w1, w2, omega, axis)
        self.gsteps = self.steps_per_call = int(gsteps)
        if self.on_cpu:
            return
        ny, nx = mask.shape
        blocks = self._lib.lbm_resident_blocks(ny, nx, axis, self._index)
        if blocks < 0:
            _build.check(self._lib, -blocks, "resident launch geometry")
        self.blocks = blocks
        self._partials = torch.empty(
            self.gsteps * blocks, dtype=torch.float32, device=self.device
        )

    def run(self, a, b, out, t: int = 0, scale=1.0):
        self._check_call(a, b, out, t)
        g = self.gsteps
        result = (a, b) if g % 2 == 0 else (b, a)
        if self.on_cpu:
            new, tots = ref_ops.multi_step(
                a, self.mask, self.w1, self.w2, self.omega, g, self.axis
            )
            result[0].copy_(new)
            out[t:t + g] = tots * self._scale(scale)
            return result
        lib, ny, nx = self._lib, self.shape[1], self.shape[2]
        _build.check(lib, lib.lbm_resident(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), out.data_ptr() + 4 * t, ny, nx,
            self.accel, self.w1, self.w2, self.omega, self.mode, g,
            self._scale(scale), self.blocks, self.axis, self._index,
            self._stream(),
        ), f"resident G={g} cooperative launch")
        self._launched("resident")
        return result


def resident(cells, obstacles, w1, w2, omega, gsteps: int, axis: int = 0):
    """``gsteps`` timesteps: ``(new_cells, tots)`` with ``tots`` the
    (gsteps,) per-step tot_u (``axis`` 1: a transposed lattice, column
    mode). Launches the kernel on a CUDA tensor (on copies: the kernel
    overwrites both of its buffers); runs :func:`.reference.multi_step`
    on a CPU tensor."""
    kernel = Resident(obstacles, w1, w2, omega, gsteps, axis)
    a, b = cells.clone(), torch.empty_like(cells)
    tots = torch.empty(gsteps, dtype=torch.float32, device=cells.device)
    new, _ = kernel.run(a, b, tots)
    return new, tots


def resident_plain(cells, obstacles, w1, w2, omega, gsteps: int,
                   axis: int = 0):
    """The kernel's plain version: :func:`.reference.multi_step`."""
    return ref_ops.multi_step(cells, obstacles, w1, w2, omega, gsteps, axis)
