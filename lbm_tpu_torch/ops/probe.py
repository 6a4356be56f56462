"""The stream-cost probe's wrapper: ``gsteps`` variant-steps of the
lattice in one persistent, cooperative CUDA launch (``csrc/probe.cu``, the
port of ``scripts/stream_cost_probe.py::_probe_call``), in one of three
modes (:data:`.reference.PROBE_MODES`), with the ``gsteps`` per-step
totals written on the device. It splits a step's time between pull
streaming and the BGK collision; it is an instrument
(``scripts/stream_cost_probe_torch.py``), no simulation runs through it.

A tensor on the CPU runs the plain version,
:func:`.reference.probe_multi_step`; a CUDA tensor launches the kernel or
raises, also when the device refuses the cooperative launch. ``gsteps``
is even, so the result is back in the first of the two buffers.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LatticeKernel

MODES = ref_ops.PROBE_MODES


class Probe(LatticeKernel):
    """The probe kernel bound to one mask and mode: ``run(a, b, out, t)``
    runs ``gsteps`` variant-steps from ``a``, using ``b`` as the other
    buffer, writes each step's total into ``out[t:t + gsteps]`` and
    returns ``(a, b)``. No row is forced. On a CUDA mask the block count
    of the cooperative launch is fixed at construction and the (gsteps,
    blocks) partials are allocated once."""

    def __init__(self, mask: torch.Tensor, omega, gsteps: int, mode: str):
        if mode not in MODES:
            raise ValueError(f"unknown probe mode {mode!r}; known: {MODES}")
        if gsteps < 2 or gsteps % 2:
            raise ValueError(f"the probe takes an even step count >= 2, "
                             f"got {gsteps}")
        super().__init__(mask, 0.0, 0.0, omega)
        self.probe_mode = mode
        self.gsteps = self.steps_per_call = int(gsteps)
        if self.on_cpu:
            return
        ny, nx = mask.shape
        blocks = self._lib.lbm_probe_blocks(ny, nx, MODES.index(mode),
                                            self._index)
        if blocks < 0:
            _build.check(self._lib, -blocks, "probe launch geometry")
        self.blocks = blocks
        self._partials = torch.empty(
            self.gsteps * blocks, dtype=torch.float32, device=self.device
        )

    def run(self, a, b, out, t: int = 0):
        self._check_call(a, b, out, t)
        g = self.gsteps
        if self.on_cpu:
            new, tots = ref_ops.probe_multi_step(a, self.mask, self.omega, g,
                                                 self.probe_mode)
            a.copy_(new)
            out[t:t + g] = tots
            return a, b
        lib, ny, nx = self._lib, self.shape[1], self.shape[2]
        _build.check(lib, lib.lbm_probe(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), out.data_ptr() + 4 * t, ny, nx,
            self.omega, self.mode, g, MODES.index(self.probe_mode),
            self.blocks, self._index, self._stream(),
        ), f"probe {self.probe_mode} G={g} cooperative launch")
        self._launched(f"probe_{self.probe_mode}")
        return a, b


def probe(cells, obstacles, omega, gsteps: int, mode: str):
    """``gsteps`` variant-steps in ``mode``: ``(new_cells, tots)`` with
    ``tots`` the (gsteps,) per-step totals. Launches the kernel on a CUDA
    tensor (on copies: the kernel overwrites both of its buffers); runs
    :func:`probe_plain` on a CPU tensor."""
    kernel = Probe(obstacles, omega, gsteps, mode)
    a, b = cells.clone(), torch.empty_like(cells)
    tots = torch.empty(gsteps, dtype=torch.float32, device=cells.device)
    new, _ = kernel.run(a, b, tots)
    return new, tots


def probe_plain(cells, obstacles, omega, gsteps: int, mode: str):
    """The kernel's plain version: :func:`.reference.probe_multi_step`."""
    return ref_ops.probe_multi_step(cells, obstacles, omega, gsteps, mode)
