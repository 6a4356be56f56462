"""The stream-cost probe's wrapper: ``gsteps`` variant-steps of the
lattice in one persistent, cooperative CUDA launch (``csrc/probe.cu``, the
port of ``scripts/stream_cost_probe.py::_probe_call``), in one of three
modes (:data:`.reference.PROBE_MODES`), with the ``gsteps`` per-step
totals written on the device. It splits a step's time between pull
streaming and the BGK collision; it is an instrument
(``scripts/stream_cost_probe_torch.py``), no simulation runs through it.

The kernel is the device-memory resident form's (``csrc/resident.cu``):
rounds of 4, 2 and 1 steps on the depth kernel's tiles
(:func:`.resident.device_rounds`), one grid barrier a round, the modes
differing only in the tile's stage body (``csrc/lbm_depth.cuh``), so
the split is the stage loop's. :func:`probe_device_emulated` is that
schedule in plain PyTorch, for the CPU tests.

A tensor on the CPU runs the plain version,
:func:`.reference.probe_multi_step`; a CUDA tensor launches the kernel or
raises, also when the device refuses the cooperative launch. ``gsteps``
is even, so the result is back in the first of the two buffers.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_depth, resident
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LatticeKernel
from lbm_tpu_torch.state import D2Q9

MODES = ref_ops.PROBE_MODES


class Probe(LatticeKernel):
    """The probe kernel bound to one mask and mode: ``run(a, b, out, t)``
    runs ``gsteps`` variant-steps from ``a``, using ``b`` as the other
    buffer, writes each step's total into ``out[t:t + gsteps]`` and
    returns ``(a, b)``. No row is forced. On a CUDA mask the launch
    geometry (``blocks``, as many as can be co-resident, at most one a
    tile; ``rounds``, :func:`.resident.device_rounds`) is fixed at
    construction and the (gsteps, tiles) partials and the two tile
    tickets are allocated once."""

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
        lib, (ny, nx) = self._lib, mask.shape
        blocks = lib.lbm_probe_blocks(ny, nx, MODES.index(mode), self._index)
        if blocks < 0:
            _build.check(lib, -blocks, "probe launch geometry")
        self.blocks = blocks
        self.rounds = resident.device_rounds(self.gsteps)
        self._partials = torch.empty(
            self.gsteps * lib.lbm_depth_num_partials(4, ny, nx),
            dtype=torch.float32, device=self.device)
        # The tile tickets of even and odd rounds, zero between launches.
        self._tickets = torch.zeros(2, dtype=torch.int32, device=self.device)

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
        rounds = self.rounds
        _build.check(lib, lib.lbm_probe(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), self._tickets.data_ptr(),
            out.data_ptr() + 4 * t, ny, nx, self.omega, self.mode, g,
            rounds.count(4), rounds.count(2), rounds.count(1),
            MODES.index(self.probe_mode), self.blocks, self._index,
            self._stream(),
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


def _probe_stage(mode: str, omega):
    """The tile's stage body of ``mode`` for
    :func:`.fused_depth.fused_depth_emulated`: ``(new interior, the
    interior's values to sum)`` of a (9, H, W) window and its mask, as
    ``csrc/lbm_depth.cuh``'s ``kStage`` computes them. ``full``: the
    pulled speeds, bounce-back and BGK, |u| (0 on an obstacle);
    ``collide``: the same of each cell's own speeds; ``stream``: the
    pulled speeds, speed 0."""

    def stage(win, wmask):
        h, w = win.shape[1] - 2, win.shape[2] - 2
        inner = wmask[1:-1, 1:-1]
        if mode == "collide":
            s = [win[k, 1:-1, 1:-1] for k in range(D2Q9.Q)]
        else:
            # Speed k at interior (r, c) pulls window (r + 1 - cy, c + 1 - cx).
            s = []
            for k in range(D2Q9.Q):
                cy, cx = int(D2Q9.CY[k]), int(D2Q9.CX[k])
                s.append(win[k, 1 - cy:1 - cy + h, 1 - cx:1 - cx + w])
        if mode == "stream":
            return torch.stack(s), s[0]
        planes, umag = ref_ops._bgk_update_planes(s, inner, omega)
        return torch.stack(planes), umag.masked_fill(inner, 0.0)

    return stage


def probe_device_emulated(cells, obstacles, omega, gsteps: int, mode: str):
    """The kernel's schedule in plain PyTorch: each round of
    :func:`.resident.device_rounds` is
    :func:`.fused_depth.fused_depth_emulated` at that depth on the depth
    kernel's 32 x 24 tile and 40-wide window with ``mode``'s stage body,
    its totals summed by tile in tile order, as the kernel sums them
    (``stream``: every owned cell's speed 0, obstacles included). Returns
    ``(new_cells, tots)``; cells are bit-identical to
    :func:`.reference.probe_multi_step`, tots differ from its by
    summation order (``full``'s are the bits of
    :func:`.resident.resident_device_emulated` with the forcing at 0)."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; known: {MODES}")
    stage = _probe_stage(mode, omega)
    tots, c = [], cells
    for d in resident.device_rounds(gsteps):
        c, t = fused_depth.fused_depth_emulated(
            c, obstacles, 0.0, 0.0, omega, d, tile=fused_depth.TILES[4],
            halo_x=fused_depth.HALO_X[4], stage=stage)
        tots.append(t)
    return c, torch.cat(tots)
