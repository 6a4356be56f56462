"""The depth kernel's wrapper: ``depth`` timesteps of the lattice in one
CUDA launch (``csrc/fused_depth.cu``, the port of
``lbm_tpu/ops/pallas_fused.py::_kernel_fused``, in row and in column
mode), which also writes the ``depth`` tot_u values on the device (the
block that started last sums the per-tile partials in a fixed order,
``csrc/lbm_reduce.cuh``).

A tensor on the CPU runs the plain version,
:func:`.reference.multi_step`; a CUDA tensor launches the kernel or
raises. :func:`fused_depth_emulated` is the kernel's tiling in plain
PyTorch (window, periodic gather, every stage on the whole window with
garbage outside its valid region, owned-cell tot_u per stage at a fixed
place), so the tile and halo logic is tested where no card exists.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LatticeKernel, SeamKernel, new_scratch
from lbm_tpu_torch.state import D2Q9

# Depths the kernel is built for, each depth's (TY, TX) output tile and
# the x-halo of its window (csrc/fused_depth.cu, Geo<D, V>). The window is
# (TY + 2 D) x (TX + 2 HALO_X): HALO_X is D rounded up to whole quads of
# four cells, so the tile starts on a 16-byte boundary of a window row.
# D = 2 and D = 4 share tile and halo, and so the thread, warp and tile of
# every owned cell: a step's tot_u has the same bits under either.
DEPTHS = (8, 4, 2)
TILES = {2: (24, 32), 4: (24, 32), 8: (16, 32)}
HALO_X = {2: 4, 4: 4, 8: 8}


class FusedDepth(LatticeKernel):
    """The depth kernel bound to one mask: ``run(a, b, out, t, scale)``
    writes ``depth`` steps of ``a`` into ``b`` and returns ``(b, a)``."""

    def __init__(self, mask: torch.Tensor, w1, w2, omega, depth: int,
                 axis: int = 0):
        if depth not in DEPTHS:
            raise ValueError(f"depth {depth} not in {DEPTHS}")
        super().__init__(mask, w1, w2, omega, axis)
        self.depth = self.steps_per_call = depth
        if self.on_cpu:
            return
        ny, nx = mask.shape
        limit = self._lib.lbm_depth_max_rows(depth)
        if ny > limit:
            raise ValueError(
                f"{ny} rows exceed the depth-{depth} kernel's limit of {limit}"
            )
        self._scratch, self._partials = new_scratch(
            depth, self._lib.lbm_depth_num_partials(depth, ny, nx),
            self.device)

    def run(self, a, b, out, t: int = 0, scale=1.0):
        self._check_call(a, b, out, t)
        d = self.depth
        if self.on_cpu:
            new, tots = ref_ops.multi_step(
                a, self.mask, self.w1, self.w2, self.omega, d, self.axis
            )
            b.copy_(new)
            out[t:t + d] = tots * self._scale(scale)
            return b, a
        lib, ny, nx = self._lib, self.shape[1], self.shape[2]
        self._launch(
            "depth", f"depth-{d} launch", lib.lbm_fused_depth,
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._scratch.data_ptr(), ny, nx, self.accel, self.w1, self.w2,
            self.omega, self.mode, d, self.axis, np.float32(scale),
            out.data_ptr() + 4 * t, self._index, self._stream())
        return b, a


class FusedDepthSeam(SeamKernel):
    """The depth kernel in seam mode, bound to one shard: ``run(a, b,
    halo_s, halo_n, out, t, scale)`` writes ``depth`` steps of ``a`` into
    ``b``, the window rows outside the shard from the ``depth``-row halos,
    and returns ``(b, a)``. On a CPU tensor it runs the plain version,
    :func:`.reference.halo_multi_step`."""

    def __init__(self, mask, hmask_s, hmask_n, w1, w2, omega, row0: int,
                 ny: int, depth: int, axis: int = 0):
        if depth not in DEPTHS:
            raise ValueError(f"depth {depth} not in {DEPTHS}")
        super().__init__(mask, hmask_s, hmask_n, w1, w2, omega, row0, ny,
                         axis)
        if self.k < depth:
            raise ValueError(f"depth {depth} needs halos of {depth} rows, "
                             f"got {self.k}")
        self.depth = self.steps_per_call = depth
        if self.on_cpu:
            return
        h, nx = mask.shape
        limit = self._lib.lbm_depth_max_rows(depth)
        if h > limit:
            raise ValueError(
                f"{h} rows exceed the depth-{depth} kernel's limit of {limit}"
            )
        self._scratch, self._partials = new_scratch(
            depth, self._lib.lbm_depth_num_partials(depth, h, nx),
            self.device)

    def run(self, a, b, halo_s, halo_n, out, t: int = 0, scale=1.0):
        self._check_call(a, b, out, t)
        self._check_halos(halo_s, halo_n)
        d = self.depth
        if self.on_cpu:
            new, tots = self._plain(a, halo_s, halo_n, d)
            b.copy_(new)
            out[t:t + d] = tots * self._scale(scale)
            return b, a
        lib, h, nx = self._lib, self.shape[1], self.shape[2]
        self._launch(
            "depth_seam", f"seam depth-{d} launch", lib.lbm_fused_depth_seam,
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            halo_s.data_ptr(), halo_n.data_ptr(),
            self._hmask_u8[0].data_ptr(), self._hmask_u8[1].data_ptr(),
            self.k, self._scratch.data_ptr(), h, nx, self.row0, self.ny,
            self.w1, self.w2, self.omega, self.mode, d, self.axis,
            np.float32(scale), out.data_ptr() + 4 * t, self._index,
            self._stream())
        return b, a


def fused_depth(cells, obstacles, w1, w2, omega, depth: int, axis: int = 0):
    """``depth`` timesteps: ``(new_cells, tots)`` with ``tots`` the
    (depth,) per-step tot_u (``axis`` 1: a transposed lattice, column
    mode). Launches the kernel on a CUDA tensor; runs
    :func:`.reference.multi_step` on a CPU tensor."""
    kernel = FusedDepth(obstacles, w1, w2, omega, depth, axis)
    new = torch.empty_like(cells)
    tots = torch.empty(depth, dtype=torch.float32, device=cells.device)
    kernel.run(cells, new, tots)
    return new, tots


def fused_depth_plain(cells, obstacles, w1, w2, omega, depth: int,
                      axis: int = 0):
    """The kernel's plain version: :func:`.reference.multi_step`."""
    return ref_ops.multi_step(cells, obstacles, w1, w2, omega, depth, axis)


def fused_depth_emulated(cells, obstacles, w1, w2, omega, depth: int,
                         tile: tuple[int, int] | None = None, axis: int = 0,
                         halo_x: int | None = None, stage=None, bgk=None):
    """The depth kernel's tiling in plain PyTorch: for each ``(TY, TX)``
    tile (default :data:`TILES`), gather the periodic window of
    ``depth`` rows and ``halo_x`` columns (default :data:`HALO_X`) more on
    each side and run ``depth`` stages on it, forcing the pulled copy
    from the forced row (``axis`` 1: the forced column, from the kernel's
    per-column flags). As in the kernel every stage works on the same
    fixed cells, the whole window: stage ``s`` is only valid on the
    window shrunk by ``s`` cells a side, and what lies outside is garbage
    (here NaN, so a stage that read it into an owned cell would show).
    The owned tile sits at the same place of the window at every stage;
    tot_u of a stage sums the tile's in-grid fluid cells as one
    fixed-shape ``(TY, TX)`` sum, then the tiles in tile order, so a
    step's total does not depend on its stage, nor on which of two
    depths that share a tile ran it. Returns ``(new_cells, tots)``; cells
    are bit-identical to :func:`.reference.multi_step`, tots differ from
    its by summation order.

    ``stage``: another stage body in place of the step's, as the tile's
    ``kStage`` in ``csrc/lbm_depth.cuh`` (the stream-cost probe's,
    :mod:`.probe`): ``stage(win, wmask)`` gives the (9, H-2, W-2) new
    interior and the (H-2, W-2) values whose sum over the tile's in-grid
    cells, obstacles included, is the stage's total; the forcing is not
    applied.

    ``bgk``: another update of the stage's pulled and forced planes in
    place of :func:`.reference._bgk_update_planes` (same signature), as
    the tile's ``kStageMxu`` forms the equilibria on the tensor cores
    (:mod:`.mxu_eq`)."""
    ty, tx = TILES[depth] if tile is None else tile
    hx = HALO_X[depth] if halo_x is None else halo_x
    if hx < depth:
        raise ValueError(f"x-halo {hx} is narrower than depth {depth}")
    _, ny, nx = cells.shape
    np_type = ref_ops._np_type(cells.dtype)
    deltas, guards = ref_ops.forcing(np_type(w1), np_type(w2), axis)
    accel = (cells.shape[1 + axis] - 2) % cells.shape[1 + axis]
    new = torch.empty_like(cells)
    tots = torch.zeros(depth, dtype=cells.dtype)
    own = (slice(depth, depth + ty), slice(hx, hx + tx))
    for by in range(math.ceil(ny / ty)):
        for bx in range(math.ceil(nx / tx)):
            # The tile's in-grid height and width (the last tile of a
            # ragged grid overhangs it).
            hy, wx = min(ty, ny - by * ty), min(tx, nx - bx * tx)
            rows = torch.arange(by * ty - depth, (by + 1) * ty + depth) % ny
            cols = torch.arange(bx * tx - hx, (bx + 1) * tx + hx) % nx
            win = cells[:, rows][:, :, cols]
            wmask = obstacles[rows][:, cols]
            # The window's cells on the forced line (row or column flags).
            forced = ((rows == accel)[:, None] if axis == 0
                      else (cols == accel)[None, :]).expand(wmask.shape)
            # Owned fluid cells: in the tile, in the grid, not an obstacle
            # (any owned cell under another stage body).
            counted = torch.zeros((ty, tx), dtype=torch.bool)
            counted[:hy, :wx] = True if stage is not None \
                else ~wmask[own][:hy, :wx]
            for s in range(depth):
                if stage is None:
                    inner, umag, _, _ = _stage(win, wmask, forced, deltas,
                                               guards, omega, bgk)
                else:
                    inner, umag = stage(win, wmask)
                # The stage's results inside a ring of garbage.
                win = torch.full_like(win, float("nan"))
                win[:, 1:-1, 1:-1] = inner
                u = torch.zeros(wmask.shape, dtype=cells.dtype)
                u[1:-1, 1:-1] = umag
                tots[s] += torch.where(counted, u[own],
                                       torch.zeros((), dtype=cells.dtype)).sum()
            new[:, by * ty:by * ty + hy, bx * tx:bx * tx + wx] = \
                win[:, own[0], own[1]][:, :hy, :wx]
    return new, tots


def _stage(win, wmask, forced, deltas, guards, omega, bgk=None):
    """One stage on a (9, H, W) window with its mask and forced-line
    cells: the updated (9, H-2, W-2) interior, its |u|, and the
    interior's mask and forced-line cells. ``bgk``: the update of the
    pulled planes (default :func:`.reference._bgk_update_planes`)."""
    h, w = win.shape[1] - 2, win.shape[2] - 2
    # The forcing guard of each source cell on the forced line.
    ok = ~wmask & forced
    for g, t in guards:
        ok = ok & (win[g] - float(t) > 0)
    pulled = []
    for k in range(D2Q9.Q):
        # Speed k at interior (r, c) pulls window (r + 1 - cy, c + 1 - cx).
        cy, cx = int(D2Q9.CY[k]), int(D2Q9.CX[k])
        src = (slice(1 - cy, 1 - cy + h), slice(1 - cx, 1 - cx + w))
        v = win[k][src]
        if deltas[k]:
            v = torch.where(ok[src], v + float(deltas[k]), v)
        pulled.append(v)
    inner = wmask[1:-1, 1:-1]
    planes, umag = (bgk or ref_ops._bgk_update_planes)(pulled, inner, omega)
    return torch.stack(planes), umag, inner, forced[1:-1, 1:-1]
