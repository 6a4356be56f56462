"""The depth kernel's wrapper: ``depth`` timesteps of the lattice in one
CUDA launch (``csrc/fused_depth.cu``, the port of
``lbm_tpu/ops/pallas_fused.py::_kernel_fused``, in row and in column
mode), plus one launch of the fixed-order reduce that writes the
``depth`` tot_u values on the device.

A tensor on the CPU runs the plain version,
:func:`.reference.multi_step`; a CUDA tensor launches the kernel or
raises. :func:`fused_depth_emulated` is the kernel's tiling in plain
PyTorch (window, periodic gather, shrinking stage regions, owned-cell
tot_u per stage), so the tile and halo logic is tested where no card
exists.
"""

from __future__ import annotations

import math

import torch

from lbm_tpu_torch.ops import _build
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LAUNCHES, LatticeKernel, SeamKernel
from lbm_tpu_torch.state import D2Q9

# Depths the kernel is built for, and each depth's (TY, TX) output tile
# (csrc/fused_depth.cu, Tile<D>).
DEPTHS = (8, 4, 2)
TILES = {2: (32, 32), 4: (24, 32), 8: (16, 32)}


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
        n = self._lib.lbm_depth_num_partials(depth, ny, nx)
        self._partials = torch.empty(
            depth * n, dtype=torch.float32, device=self.device
        )

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
        _build.check(lib, lib.lbm_fused_depth(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), ny, nx, self.accel, self.w1, self.w2,
            self.omega, self.mode, d, self.axis, self._index, self._stream(),
        ), f"depth-{d} launch")
        self._launched("depth")
        self._reduce(self._partials, d, out, t, scale)
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
        n = self._lib.lbm_depth_num_partials(depth, h, nx)
        self._partials = torch.empty(
            depth * n, dtype=torch.float32, device=self.device
        )

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
        _build.check(lib, lib.lbm_fused_depth_seam(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            halo_s.data_ptr(), halo_n.data_ptr(),
            self._hmask_u8[0].data_ptr(), self._hmask_u8[1].data_ptr(),
            self.k, self._partials.data_ptr(), h, nx, self.row0, self.ny,
            self.w1, self.w2, self.omega, self.mode, d, self.axis,
            self._index, self._stream(),
        ), f"seam depth-{d} launch")
        self._launched("depth_seam")
        self._reduce(self._partials, d, out, t, scale)
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
                         tile: tuple[int, int] | None = None, axis: int = 0):
    """The depth kernel's tiling in plain PyTorch: for each ``(TY, TX)``
    tile (default :data:`TILES`), gather the periodic window of
    ``depth`` cells more on each side, run ``depth`` stages on it, each
    over the window shrunk by one more cell per side, forcing the pulled
    copy from the forced row (``axis`` 1: the forced column, from the
    kernel's per-column flags), and keep the tile. tot_u of each stage
    counts the tile's in-grid fluid cells only. Returns ``(new_cells,
    tots)``; cells are bit-identical to :func:`.reference.multi_step`,
    tots differ by summation order."""
    ty, tx = TILES[depth] if tile is None else tile
    _, ny, nx = cells.shape
    np_type = ref_ops._np_type(cells.dtype)
    deltas, guards = ref_ops.forcing(np_type(w1), np_type(w2), axis)
    accel = (cells.shape[1 + axis] - 2) % cells.shape[1 + axis]
    new = torch.empty_like(cells)
    tots = torch.zeros(depth, dtype=cells.dtype)
    for by in range(math.ceil(ny / ty)):
        for bx in range(math.ceil(nx / tx)):
            # The tile's in-grid height and width (the last tile of a
            # ragged grid overhangs it).
            hy, hx = min(ty, ny - by * ty), min(tx, nx - bx * tx)
            rows = torch.arange(by * ty - depth, (by + 1) * ty + depth) % ny
            cols = torch.arange(bx * tx - depth, (bx + 1) * tx + depth) % nx
            win = cells[:, rows][:, :, cols]
            wmask = obstacles[rows][:, cols]
            # The window's cells on the forced line (row or column flags).
            forced = ((rows == accel)[:, None] if axis == 0
                      else (cols == accel)[None, :]).expand(wmask.shape)
            for s in range(1, depth + 1):
                win, umag, wmask, forced = _stage(
                    win, wmask, forced, deltas, guards, omega
                )
                # Owned cells sit depth - s cells in from this region.
                own = (slice(depth - s, depth - s + hy),
                       slice(depth - s, depth - s + hx))
                tots[s - 1] += umag[own][~wmask[own]].sum()
            new[:, by * ty:by * ty + hy, bx * tx:bx * tx + hx] = \
                win[:, :hy, :hx]
    return new, tots


def _stage(win, wmask, forced, deltas, guards, omega):
    """One stage on a (9, H, W) window with its mask and forced-line
    cells: the updated (9, H-2, W-2) interior, its |u|, and the
    interior's mask and forced-line cells."""
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
    planes, umag = ref_ops._bgk_update_planes(pulled, inner, omega)
    return torch.stack(planes), umag, inner, forced[1:-1, 1:-1]
