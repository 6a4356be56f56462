"""The resident kernel's wrapper: ``gsteps`` timesteps of the lattice in
one persistent, cooperative CUDA launch, the port of
``lbm_tpu/ops/pallas_resident.py::_kernel_resident`` (in row mode and in
the column mode of its ``lane_accel``), which also writes the ``gsteps``
tot_u values on the device. Two forms of the one TPU kernel, chosen by
size (:func:`.plan.resident_form`):

- ``"onchip"`` (``csrc/resident_onchip.cu``): each block holds its strip
  of rows in shared memory for all G steps and trades its edge rows with
  its two neighbours through L2, each halo value a 64-bit word that
  carries its step's tag (two slots a direction, by step parity);
- ``"inplace"``: the same kernel's single-buffer mode (the JAX kernel's
  in-place mode, ``LBM_RESIDENT_INPLACE``): one buffer a strip, updated in
  place in waves, what a later wave pulls from an overwritten cell carried
  beside it;
- ``"device"`` (``csrc/resident.cu``): the lattice stays in device
  memory; the blocks step it in rounds of up to four steps on the depth
  kernel's shared-memory tiles (``csrc/lbm_depth.cuh``), one grid barrier
  a round (:func:`device_rounds`);
- ``"shift"``: the same form's shift mode (the JAX kernel's offset-load
  mode, ``LBM_RESIDENT_SHIFT``, row mode only): a step at a time over
  blocks that each own a rectangle of whole depth tiles for the launch
  (:func:`.plan.shift_rects`) and wait only on their neighbours' step
  counters; the cells in shared memory where a block's fit
  (:func:`.plan.shift_residence`), else in the two lattice buffers, each
  cell's nine speeds loaded from the source buffer at offset rows and
  columns.

A tensor on the CPU runs the plain version,
:func:`.reference.multi_step`, whatever the form; a CUDA tensor launches
the kernel of its form or raises, also when the device refuses the
cooperative launch or the strip's shared memory: a refused form never
falls back to the other. The result is in the first of the two buffers
they are given after an even ``gsteps`` and in the second after an odd
one (the single-buffer mode copies out to whichever the contract names);
the CPU path keeps the same contract. :func:`resident_onchip_emulated` is
the on-chip form's strips, halo slots and sums in plain PyTorch, in both
of its modes, :func:`resident_device_emulated` the device form's rounds,
:func:`resident_shift_emulated` its shift mode's steps and
:func:`shift_schedule_emulated` the shift mode's blocks, rings, edge
buffer and step counters, for the CPU tests.
"""

from __future__ import annotations

import torch

from lbm_tpu_torch.ops import _build, fused_depth, plan
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops.fused import LatticeKernel
from lbm_tpu_torch.state import D2Q9

# Speeds a halo row carries: to the block above (pulled by its row 0 from
# the row below it) and to the block below.
NORTH_SPEEDS = (2, 5, 6)
SOUTH_SPEEDS = (4, 7, 8)
# Tags restart from zero (the halo words zeroed) before they would pass
# 2**31.
_TAG_LIMIT = 1 << 31
# Threads of an on-chip block (csrc/lbm_onchip.cuh's kThreads): the
# cells of a wave of the single-buffer mode.
THREADS = 1024
# The rows of three speeds that a cell of the single-buffer mode carries
# for later waves before its store (the kernel's R and T).
_CARRIED = ("R", "T")
# The speeds of a cell that the row above pulls (up to nx + 1 positions
# later): the single-buffer mode stores them last.
_LATE = (2, 5, 6)


def device_rounds(gsteps: int) -> list[int]:
    """The steps of each round of the device form's launch of ``gsteps``
    steps, in order: as many rounds of 4 as fit, then 2, then 1, with one
    round of 4 (or, where there is none, of 2) split in two halves where
    that is what gives the count of rounds the parity of ``gsteps``. Each
    round moves the lattice from one buffer to the other, so the result
    lands where the contract puts it: the first buffer after an even
    ``gsteps``, the second after an odd one (100: 24 rounds of 4, then 2
    of 2). The three depths share the depth kernel's tile and thread map,
    so every step's tot_u has the bits of the depth plan's."""
    if gsteps < 1:
        raise ValueError(f"gsteps must be positive, got {gsteps}")
    n4, rest = divmod(gsteps, 4)
    n2, n1 = divmod(rest, 2)
    if (n4 + n2 + n1 - gsteps) % 2:
        if n4:
            n4, n2 = n4 - 1, n2 + 2
        else:
            n2, n1 = n2 - 1, n1 + 2
    return [4] * n4 + [2] * n2 + [1] * n1


def device_limits(device) -> tuple[int, int]:
    """``(SMs, shared memory a block may opt in to)`` of a CUDA device,
    from the kernel library."""
    lib = _build.load()
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    sms, smem = lib.lbm_sm_count(index), lib.lbm_smem_optin(index)
    for v, what in ((sms, "SM count"), (smem, "shared memory limit")):
        if v < 0:
            _build.check(lib, -v, what)
    return sms, smem


def _limits(device):
    """:func:`device_limits` of a CUDA ``device``, else None."""
    on_card = device is not None and torch.device(device).type == "cuda"
    return device_limits(device) if on_card else None


def planned_form(ny: int, nx: int, device, axis: int = 0) -> str | None:
    """The resident kernel's form for an ny x nx lattice on ``device`` in
    forcing mode ``axis`` (1: a transposed lattice, which has no shift
    mode): :func:`.plan.planned_form` (the pins, else the size rule) with
    the card's limits; None off the card."""
    return plan.planned_form(ny, nx, _limits(device), shift_mode=axis == 0)


def segments(ny: int, nx: int, iters: int, device, axis: int = 0) -> list:
    """:func:`.plan.segments` of ``iters`` steps of an ny x nx lattice on
    ``device`` in forcing mode ``axis``, with the resident kernel's planned
    form and the card's limits (None off the card)."""
    limits = _limits(device)
    return plan.segments(ny, nx, iters, plan.planned_form(
        ny, nx, limits, shift_mode=axis == 0), limits)


class Resident(LatticeKernel):
    """The resident kernel bound to one mask: ``run(a, b, out, t,
    scale)`` runs ``gsteps`` steps from ``a`` and returns ``(cells,
    spare)``: ``(a, b)`` for an even ``gsteps``, ``(b, a)`` for an odd
    one. ``form``: "onchip", "inplace" (the on-chip form's single-buffer
    mode), "device" or "shift" (the device form's shift mode, row mode
    only); None takes :func:`planned_form`. ``blocks``: the block count
    (default: the on-chip form's :func:`.plan.onchip_blocks`; the device
    form's as many as can be co-resident, at most one a tile; the shift
    mode's the blocks that own tiles over one an SM, or, in device memory,
    over as many as can be co-resident); a device-form launch of more than
    can be co-resident raises. ``residence`` ("shared" or "device"): the
    shift mode's, by default :func:`.plan.shift_residence`'s (a shared
    residence that does not fit raises). On a CUDA mask the launch
    geometry is fixed at construction and the scratch (partials and tile
    tickets; the shift mode's step counters and edge buffer; on chip halo
    slots and the ticket) allocated once; an on-chip mode whose
    strips do not fit the card's shared memory raises there."""

    def __init__(self, mask: torch.Tensor, w1, w2, omega, gsteps: int,
                 axis: int = 0, form: str | None = None,
                 blocks: int | None = None, residence: str | None = None):
        if gsteps < 1:
            raise ValueError(f"gsteps must be positive, got {gsteps}")
        if form is not None and form not in plan.RESIDENT_FORMS:
            raise ValueError(f"unknown resident form {form!r}; known: "
                             f"{plan.RESIDENT_FORMS}")
        if form == "shift" and axis:
            raise ValueError("the shift mode runs in row mode only (axis 0), "
                             "as the JAX kernel's")
        if residence is not None and (
                form != "shift" or residence not in plan.SHIFT_RESIDENCES):
            raise ValueError(f"residence {residence!r}: the shift mode's "
                             f"are {plan.SHIFT_RESIDENCES}")
        super().__init__(mask, w1, w2, omega, axis)
        self.gsteps = self.steps_per_call = int(gsteps)
        self.form = form
        if self.on_cpu:
            return
        ny, nx = mask.shape
        if self.form is None:
            self.form = planned_form(ny, nx, self.device, axis)
        if self.form in ("onchip", "inplace"):
            self._init_onchip(ny, nx, blocks)
            return
        lib = self._lib
        if self.form == "shift":
            self._init_shift(ny, nx, blocks, residence)
            return
        n = lib.lbm_resident_blocks(ny, nx, axis, 0, self._index)
        if n < 0:
            _build.check(lib, -n, "resident launch geometry")
        self.blocks = n if blocks is None else int(blocks)
        if self.blocks < 1:
            raise ValueError(f"{self.blocks} blocks")
        self.rounds = device_rounds(self.gsteps)
        self._partials = torch.empty(
            self.gsteps * lib.lbm_depth_num_partials(4, ny, nx),
            dtype=torch.float32, device=self.device)
        # The tile tickets of even and odd rounds, zero between launches.
        self._tickets = torch.zeros(2, dtype=torch.int32, device=self.device)

    def _init_shift(self, ny: int, nx: int, blocks: int | None,
                    residence: str | None) -> None:
        """The shift mode's geometry: the residence by the block's bytes
        (:func:`.plan.shift_residence` over one block an SM), unless
        ``residence`` names one; the ownership over ``blocks`` blocks, or
        over the SMs (shared) or the device residence's co-resident blocks,
        of which the owning ones launch."""
        lib = self._lib
        sms, smem = device_limits(self.device)
        own = sms if blocks is None else int(blocks)
        if own < 1:
            raise ValueError(f"{own} blocks")
        self.residence = residence or plan.shift_residence(ny, nx, own, smem)
        if self.residence == "shared" and not plan.shift_fits(ny, nx, own,
                                                              smem):
            raise ValueError(
                f"the shift mode's shared residence needs "
                f"{plan.shift_smem_bytes(ny, nx, own)} B of shared memory a "
                f"block for {ny}x{nx} over {own} blocks; the card gives "
                f"{smem}")
        if self.residence == "device" and blocks is None:
            own = lib.lbm_resident_blocks(ny, nx, 0, 1, self._index)
            if own < 0:
                _build.check(lib, -own, "shift-mode launch geometry")
        self._owners = own
        owning = len(plan.shift_rects(ny, nx, own))
        if lib.lbm_shift_owners(ny, nx, own) != owning or (
                self.residence == "shared" and
                lib.lbm_shift_smem_bytes(ny, nx, own)
                != plan.shift_smem_bytes(ny, nx, own)):
            raise RuntimeError("ops/plan.py and csrc/resident.cu own the "
                               "shift mode's tiles differently")
        self.blocks = owning if blocks is None else int(blocks)
        self.rounds = [1] * self.gsteps
        dev = self.device
        self._partials = torch.empty(
            self.gsteps * lib.lbm_depth_num_partials(4, ny, nx),
            dtype=torch.float32, device=dev)
        # Step counters as int32 words the kernel reads as unsigned, zero
        # between launches; the edge buffer by step parity (shared only).
        self._done = torch.zeros(self.blocks, dtype=torch.int32, device=dev)
        edges = (lib.lbm_shift_edge_floats(ny, nx, own)
                 if self.residence == "shared" else 1)
        self._edges = torch.empty(edges, dtype=torch.float32, device=dev)

    def _init_onchip(self, ny: int, nx: int, blocks: int | None) -> None:
        lib = self._lib
        sms, smem = device_limits(self.device)
        self.blocks = plan.onchip_blocks(ny, nx, sms) if blocks is None \
            else int(blocks)
        if not 1 <= self.blocks <= ny:
            raise ValueError(f"{self.blocks} strips of {ny} rows")
        self.buffers = 1 if self.form == "inplace" else 2
        self.smem_bytes = plan.onchip_smem_bytes(ny, nx, self.blocks,
                                                 self.buffers)
        if lib.lbm_onchip_smem_bytes(ny, nx, self.blocks,
                                     self.buffers) != self.smem_bytes:
            raise RuntimeError("ops/plan.py and csrc/resident_onchip.cu "
                               "size a strip differently")
        mode = "single-buffer" if self.buffers == 1 else "two-buffer"
        if self.smem_bytes > smem:
            raise ValueError(
                f"the on-chip resident form's {mode} mode needs "
                f"{self.smem_bytes} B of shared memory a block for {ny}x{nx} "
                f"over {self.blocks} strips; the card gives {smem}")
        _build.check(lib, lib.lbm_onchip_prepare(
            self.axis, self.mode, self.buffers, self.smem_bytes, self.blocks,
            self._index,
        ), f"on-chip resident form ({mode}) over {self.blocks} blocks")
        dev = self.device
        # (B, 2, 2, 3, nx) halo words: a value's bits and its step's tag.
        self._halo = torch.zeros(self.blocks * 2 * 2 * 3 * nx,
                                 dtype=torch.int64, device=dev)
        # The ticket as an int32 word the kernel reads as unsigned.
        self._ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self._partials = torch.empty(self.gsteps * self.blocks,
                                     dtype=torch.float32, device=dev)
        self._step_base = 0

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
        if self.form in ("onchip", "inplace"):
            if self._step_base + g >= _TAG_LIMIT:
                self._halo.zero_()
                self._step_base = 0
            self._launch(
                "resident_onchip_inplace" if self.buffers == 1
                else "resident_onchip",
                f"on-chip resident G={g} cooperative launch",
                lib.lbm_resident_onchip,
                a.data_ptr(), result[0].data_ptr(), self._mask_u8.data_ptr(),
                self._halo.data_ptr(), self._partials.data_ptr(), self._ticket.data_ptr(),
                out.data_ptr() + 4 * t, ny, nx, self.accel, self.w1,
                self.w2, self.omega, self.mode, g, self._scale(scale),
                self._step_base, self.blocks, self.axis, self.buffers,
                self._index, self._stream())
            self._step_base += g
            return result
        if self.form == "shift":
            self._launch(
                "resident_shift", f"resident shift G={g} cooperative launch",
                lib.lbm_resident_shift,
                a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
                self._partials.data_ptr(), self._done.data_ptr(),
                self._edges.data_ptr(), out.data_ptr() + 4 * t, ny, nx,
                self.accel, self.w1, self.w2, self.omega, self.mode, g,
                self._scale(scale), self.blocks, self._owners,
                int(self.residence == "shared"), self._index, self._stream())
            return result
        rounds = self.rounds
        self._launch(
            "resident", f"resident G={g} cooperative launch", lib.lbm_resident,
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), self._tickets.data_ptr(),
            out.data_ptr() + 4 * t, ny, nx, self.accel, self.w1, self.w2,
            self.omega, self.mode, g, rounds.count(4), rounds.count(2),
            rounds.count(1), self._scale(scale), self.blocks, self.axis,
            self._index, self._stream())
        return result


def resident(cells, obstacles, w1, w2, omega, gsteps: int, axis: int = 0,
             form: str | None = None, blocks: int | None = None):
    """``gsteps`` timesteps: ``(new_cells, tots)`` with ``tots`` the
    (gsteps,) per-step tot_u (``axis`` 1: a transposed lattice, column
    mode; ``form`` and ``blocks`` as :class:`Resident`). Launches the
    kernel on a CUDA tensor (on copies: the kernel overwrites both of its
    buffers); runs :func:`.reference.multi_step` on a CPU tensor."""
    kernel = Resident(obstacles, w1, w2, omega, gsteps, axis, form, blocks)
    a, b = cells.clone(), torch.empty_like(cells)
    tots = torch.empty(gsteps, dtype=torch.float32, device=cells.device)
    new, _ = kernel.run(a, b, tots)
    return new, tots


def resident_plain(cells, obstacles, w1, w2, omega, gsteps: int,
                   axis: int = 0):
    """The kernel's plain version: :func:`.reference.multi_step`."""
    return ref_ops.multi_step(cells, obstacles, w1, w2, omega, gsteps, axis)


def _rounds_emulated(cells, obstacles, w1, w2, omega, rounds, axis,
                     bgk=None):
    """Each round of ``rounds`` (its steps) as
    :func:`.fused_depth.fused_depth_emulated` at that depth on the depth
    kernel's 32 x 24 tile and 40-wide window (the kernel's tile at every
    depth, 1 included), its tots summed by tile in tile order (``bgk``:
    the stage's update, as there)."""
    tots, c = [], cells
    for d in rounds:
        c, t = fused_depth.fused_depth_emulated(
            c, obstacles, w1, w2, omega, d, tile=fused_depth.TILES[4],
            axis=axis, halo_x=fused_depth.HALO_X[4], bgk=bgk)
        tots.append(t)
    return c, torch.cat(tots)


def resident_device_emulated(cells, obstacles, w1, w2, omega, gsteps: int,
                             axis: int = 0):
    """The device form's rounds in plain PyTorch: the rounds of
    :func:`device_rounds` on the depth kernel's tile, each step's tots
    summed by tile in tile order, as the kernel sums them. Returns
    ``(new_cells, tots)``; cells are bit-identical to
    :func:`.reference.multi_step`, tots differ from its by summation
    order."""
    return _rounds_emulated(cells, obstacles, w1, w2, omega,
                            device_rounds(gsteps), axis)


def resident_shift_emulated(cells, obstacles, w1, w2, omega, gsteps: int):
    """The shift mode in plain PyTorch (row mode): ``gsteps`` rounds of
    one step, each :func:`.fused_depth.fused_depth_emulated` at D = 1 on
    the depth kernel's tile, its tots summed by tile in tile order. The
    kernel loads each cell's speeds from the source buffer where the
    emulation gathers a one-row window; a cell, its thread and its tile
    are the same, so the cells and tots are those of the device form's
    rounds and of the depth plan's. Returns ``(new_cells, tots)``."""
    return _rounds_emulated(cells, obstacles, w1, w2, omega, [1] * gsteps, 0)


# The edge buffer's sides (csrc/lbm_rounds.cuh's EdgeSide) and the speeds
# each carries: a column group's first column (what its west neighbour
# pulls), its last column, a row group's bottom row, its top row, and the
# forced row (the guard's reads across a side).
EDGE_SPEEDS = {"colW": (3, 6, 7), "colE": (1, 5, 8), "rowS": (4, 7, 8),
               "rowN": (2, 5, 6), "forced": (3, 6, 7)}


class ShiftHazard(AssertionError):
    """The shift schedule's emulation let a block run more than one step
    ahead of a neighbour whose cells it pulls."""


def _shift_segments(h: int, w: int, ncg: int, nrg: int):
    """The ring's segments of an h x w block, as the kernel's warps fill
    them: ``(cells, kind)`` with cells the local ``(r, c)`` of the ring and
    kind "W", "E" (a column side), "S", "N" (a row side) or a corner "SW",
    "SE", "NW", "NE". Where the rows wrap inside the block (``nrg`` 1) the
    columns take the corners, else where the columns do (``ncg`` 1) the
    rows; a corner is a segment of its own only where both are cut."""
    cols, rows = (range(-1, h + 1) if nrg == 1 else range(h),
                  range(-1, w + 1) if nrg > 1 and ncg == 1 else range(w))
    segs = [([(r, -1) for r in cols], "W"), ([(r, w) for r in cols], "E"),
            ([(-1, c) for c in rows], "S"), ([(h, c) for c in rows], "N")]
    if nrg > 1 and ncg > 1:
        segs += [([(-1, -1)], "SW"), ([(-1, w)], "SE"),
                 ([(h, -1)], "NW"), ([(h, w)], "NE")]
    return segs


def _rim(h: int, w: int) -> torch.Tensor:
    """The (h, w) block's rim cells: rows 0 and h-1 and columns 0 and w-1,
    the cells that pull from the ring; the others pull nothing from it."""
    rim = torch.zeros((h, w), dtype=torch.bool)
    rim[0] = rim[h - 1] = True
    rim[:, 0] = rim[:, w - 1] = True
    return rim


def shift_schedule_emulated(cells, obstacles, w1, w2, omega, gsteps: int,
                            blocks: int, seed: int = 0,
                            ring_before_wait: bool = False,
                            check_drift: bool = True):
    """The shift mode's schedule in plain PyTorch (row mode): each block of
    :func:`.plan.shift_rects` over ``blocks`` blocks holds its cells in two
    padded buffers with a one-cell ring, and steps them as the kernel's
    shared residence does: the interior cells beside, in any order, the
    ring's segments and then the rim cells, those on a side or on the
    forced row publishing what a neighbour pulls into the edge buffer's
    slot of the next step's parity, then its step counter; the next step
    once both are done. The blocks advance in a seeded adversarial order
    (the block furthest ahead first, every other turn a random one) that
    only the counters constrain: a segment that another block owns is
    filled at step k > 0 only once that block's counter reads k, from the
    lattice at step 0.

    Poisoned: at each step the buffer being written and the ring are NaN
    until filled, and an edge entry read at step k that does not hold step
    k (a stale parity, or one not written yet) reads NaN; so a fill of the
    wrong speeds, too early or from the wrong slot shows in the cells.
    ``ring_before_wait``: the mutant that fills its ring before its wait.
    Raises :class:`ShiftHazard` if a block finishes a step more than one
    ahead of a neighbour (``check_drift``). Returns ``(new_cells, tots)``, tots summed by
    tile in tile order as :func:`.fused_depth.fused_depth_emulated` sums
    them."""
    import numpy as np

    _, ny, nx = cells.shape
    dt = cells.dtype
    nan = float("nan")
    d = ref_ops._np_type(dt)
    deltas, guards = ref_ops.forcing(d(w1), d(w2), 0)
    accel = (ny - 2) % ny
    rects = plan.shift_rects(ny, nx, blocks)
    ncg, nrg = plan.shift_groups(ny, nx, blocks)
    owner = torch.empty((ny, nx), dtype=torch.long)
    for b, (y0, y1, x0, x1) in enumerate(rects):
        owner[y0:y1, x0:x1] = b
    col_of = [b % ncg for b in range(len(rects))]
    row_of = [b // ncg for b in range(len(rects))]
    # The edge buffer by slot: values and the step each entry holds.
    sizes = {"colW": (ncg, ny), "colE": (ncg, ny), "rowS": (nrg, nx),
             "rowN": (nrg, nx), "forced": (1, nx)}
    edges = [{k: (torch.full((g, 3, n), nan, dtype=dt),
                  torch.full((g, n), -1, dtype=torch.long))
              for k, (g, n) in sizes.items()} for _ in range(2)]

    def edge_read(slot, side, group, at, step):
        vals, tags = edges[slot][side]
        if int(tags[group, at]) != step:
            return torch.full((3,), nan, dtype=dt)
        return vals[group, :, at]

    blk = []
    for y0, y1, x0, x1 in rects:
        h, w = y1 - y0, x1 - x0
        rows = torch.arange(y0 - 1, y1 + 1) % ny
        cols = torch.arange(x0 - 1, x1 + 1) % nx
        cur = torch.full((9, h + 2, w + 2), nan, dtype=dt)
        cur[:, 1:-1, 1:-1] = cells[:, y0:y1, x0:x1]
        blk.append({"rect": (y0, y1, x0, x1), "h": h, "w": w,
                    "rows": rows, "cols": cols, "cur": cur,
                    "mask": obstacles[rows][:, cols],
                    "forced": (rows == accel)[:, None].expand(h + 2, w + 2),
                    "rim": _rim(h, w),
                    "segs": _shift_segments(h, w, ncg, nrg),
                    "nbrs": {int(owner[int(rows[r]), int(cols[c])])
                             for r in (0, h // 2 + 1, h + 1)
                             for c in (0, w // 2 + 1, w + 1)}})
    done = [0] * len(rects)
    umag = [torch.zeros((ny, nx), dtype=dt) for _ in range(gsteps)]

    def lanes(b, k):
        # A block's step k: the interior ("I") beside the rim group's ring
        # segments ("F", each) and rim ("R"), in any order between them.
        return [[("I", k)],
                [("F", k, s) for s in range(len(blk[b]["segs"]))]
                + [("R", k)]]

    def seg_owner(b, s):
        o = blk[b]
        cells_ = o["segs"][s][0]
        r, c = cells_[len(cells_) // 2]
        return int(owner[int(o["rows"][r + 1]), int(o["cols"][c + 1])])

    def ready(b, ph):
        if ph[0] != "F" or ph[1] == 0 or ring_before_wait:
            return True
        n = seg_owner(b, ph[2])
        return n == b or done[n] >= ph[1]

    def run(b, ph):
        o = blk[b]
        h, w, k = o["h"], o["w"], ph[1]
        y0, _, x0, _ = o["rect"]
        if ph[0] == "I":
            inner, um, _, _ = fused_depth._stage(
                o["cur"], o["mask"], o["forced"], deltas, guards, omega)
            keep = ~o["rim"]
            o["nxt"][:, 1:-1, 1:-1][:, keep] = inner[:, keep]
            umag[k][y0:y0 + h, x0:x0 + w][keep] = um[keep]
        elif ph[0] == "F":
            cells_, kind = o["segs"][ph[2]]
            n = seg_owner(b, ph[2])
            col = kind in ("W", "E") or (len(kind) == 2 and ncg > 1)
            side = (("colE" if kind.endswith("W") else "colW") if col else
                    ("rowN" if kind.startswith("S") else "rowS"))
            for r, c in cells_:
                gy, gx = int(o["rows"][r + 1]), int(o["cols"][c + 1])
                to = o["cur"][:, r + 1, c + 1]
                if n == b:
                    to[:] = o["cur"][:, gy - y0 + 1, gx - x0 + 1]
                elif k == 0:
                    to[:] = cells[:, gy, gx]
                else:
                    slot, at = k % 2, gy if col else gx
                    group = col_of[n] if col else row_of[n]
                    to[list(EDGE_SPEEDS[side])] = edge_read(slot, side, group,
                                                            at, k)
                    if gy == accel and side != "colW":
                        to[list(EDGE_SPEEDS["forced"])] = edge_read(
                            slot, "forced", 0, gx, k)
        else:
            inner, um, _, _ = fused_depth._stage(
                o["cur"], o["mask"], o["forced"], deltas, guards, omega)
            rim = o["rim"]
            o["nxt"][:, 1:-1, 1:-1][:, rim] = inner[:, rim]
            umag[k][y0:y0 + h, x0:x0 + w][rim] = um[rim]
            if k + 1 < gsteps:
                slot = (k + 1) % 2

                def put(side, group, at, vals):
                    edges[slot][side][0][group, :, at] = vals[
                        list(EDGE_SPEEDS[side])]
                    edges[slot][side][1][group, at] = k + 1

                for r, c in rim.nonzero().tolist():
                    gy, gx = y0 + r, x0 + c
                    vals = inner[:, r, c]
                    if ncg > 1 and c == 0:
                        put("colW", col_of[b], gy, vals)
                    if ncg > 1 and c == w - 1:
                        put("colE", col_of[b], gy, vals)
                    if nrg > 1 and r == 0:
                        put("rowS", row_of[b], gx, vals)
                    if nrg > 1 and r == h - 1:
                        put("rowN", row_of[b], gx, vals)
                    if gy == accel:
                        put("forced", 0, gx, vals)
            done[b] = k + 1
            for n in o["nbrs"] - {b}:
                if check_drift and done[b] - done[n] > 1:
                    raise ShiftHazard(f"block {b} finished step {k} while "
                                      f"its neighbour {n} has {done[n]}")

    def start(b, k):
        # Poison the buffer step k writes and the ring it reads.
        o = blk[b]
        o["nxt"] = torch.full_like(o["cur"], nan)
        ring = torch.ones(o["cur"].shape[1:], dtype=torch.bool)
        ring[1:-1, 1:-1] = False
        o["cur"][:, ring] = nan
        o["step"], o["lanes"] = k, lanes(b, k)

    rng = np.random.default_rng(seed)
    for b in range(len(rects)):
        start(b, 0)
    live = set(range(len(rects)))
    turn = 0
    while live:
        cands = [(b, i) for b in sorted(live)
                 for i, lane in enumerate(blk[b]["lanes"])
                 if lane and ready(b, lane[0])]
        if not cands:
            raise ShiftHazard("no block can move: the counters deadlock")
        if turn % 2 == 0:
            b, i = max(cands, key=lambda bi: (
                blk[bi[0]]["step"], len(blk[bi[0]]["lanes"][bi[1]][0]),
                blk[bi[0]]["lanes"][bi[1]][0][-1]))
        else:
            b, i = cands[int(rng.integers(len(cands)))]
        turn += 1
        run(b, blk[b]["lanes"][i].pop(0))
        o = blk[b]
        if not any(o["lanes"]):
            # Both lanes done: the step's buffer becomes the next's source.
            o["cur"], o["nxt"] = o["nxt"], None
            if o["step"] + 1 < gsteps:
                start(b, o["step"] + 1)
            else:
                live.discard(b)
    new = torch.empty_like(cells)
    for o in blk:
        y0, y1, x0, x1 = o["rect"]
        new[:, y0:y1, x0:x1] = o["cur"][:, 1:-1, 1:-1]
    ty, tx = plan.SHIFT_TILE
    tots = torch.zeros(gsteps, dtype=dt)
    for k in range(gsteps):
        for by in range(-(-ny // ty)):
            for bx in range(-(-nx // tx)):
                hy, wx = min(ty, ny - by * ty), min(tx, nx - bx * tx)
                u = torch.zeros((ty, tx), dtype=dt)
                sl = (slice(by * ty, by * ty + hy), slice(bx * tx, bx * tx + wx))
                u[:hy, :wx] = torch.where(obstacles[sl], torch.zeros((), dtype=dt),
                                          umag[k][sl])
                tots[k] += u.sum()
    return new, tots


def strips(ny: int, blocks: int) -> list[tuple[int, int]]:
    """``(r0, h)`` of each block's strip, as the on-chip kernel splits ny
    rows: the first ``ny % blocks`` strips one row taller."""
    base, rem = divmod(ny, blocks)
    return [(b * base + min(b, rem), base + (b < rem)) for b in range(blocks)]


def _sent_row(row, mrow, on: bool, w1, w2, axis: int, speeds):
    """The halo copies a block sends from one of its rows (9, nx): the
    given three speeds of the row forced as the kernel's sender forces
    them, on the whole row (row mode, ``on``: it is the forced row) or at
    the forced column (column mode)."""
    if axis == 0:
        forced = ref_ops._accelerated_line(row, mrow, w1, w2) if on else row
    else:
        forced = ref_ops.accelerate_flow(row[:, None], mrow[None], w1, w2,
                                         axis=1)[:, 0]
    return forced[list(speeds)]


def inplace_delay(h: int, nx: int, wave: int = THREADS) -> int:
    """Waves by which the single-buffer mode defers the stores of a wave's
    speeds 2, 5 and 6 in a strip of ``h`` rows of ``nx`` cells
    (``csrc/lbm_onchip.cuh``'s kD; the other six wait one): the row above
    pulls them up to nx + 1 positions later, so where a strip has two rows
    or more and a row is wider than a wave they wait three waves (rows up
    to 3 wave - 1 wide: every two-row strip that fits an H100's shared
    memory); else one.
    A row of exactly ``wave`` cells keeps one: its waves start at column
    0, where speed 5 comes from the cell just before."""
    if h < 2 or nx <= wave:
        return 1
    if nx + 1 > 3 * wave:
        raise ValueError(f"strips of {h} rows of {nx} cells: the single-"
                         f"buffer mode defers stores by at most 3 waves of "
                         f"{wave} cells, which covers rows up to "
                         f"{3 * wave - 1} wide")
    return 3


class InplaceHazard(AssertionError):
    """A pull of the single-buffer emulation's poisoned mode that read a
    cell whose deferred store had landed, or a carried value that was not
    the one it stands for."""


def _inplace_strip_step(buf, mask, south, north, omega, wave: int,
                        poison: bool = False):
    """One step of the single-buffer mode on one strip, in place: ``buf``
    (9, h, nx), forced already; ``south`` the (3, nx) speeds 2, 5, 6 of
    the row below, ``north`` the speeds 4, 7, 8 of the row above (halo
    slots). The kernel's schedule (``csrc/lbm_onchip.cuh``): two phases,
    the interior rows 1..h-2 and then the edge rows 0 and h-1, each over
    positions p = r nx + i of its rows, in waves of ``wave`` cells and one
    phase a wave. Wave k gathers every pull and computes; its speeds 2, 5
    and 6 land only after every thread has gathered wave k + D
    (:func:`inplace_delay`), the other six after wave k + 1 (the cells that
    pull those sit at most a position away, but for column 0's speed 3).
    So at wave k's gather the six of waves k - 2 and before and the three
    of waves k - D - 1 and before may have landed, and this emulation lands
    them there, the earliest they may. A pull reads the buffer, except:

    - row 0 pulls row 1's old speeds 4, 7, 8 from T and row h-1 (h > 2) row
      h-2's old 2, 5, 6 from R, which those cells copy from themselves just
      before their stores land (NaN until then);
    - column nx-1 pulls the x wrap's speed 6 from the row below's column 0
      (2 nx - 1 positions back) and, where a row is wider than a wave,
      speed 3 from its own row's column 0 (nx - 1 back), through a slot of
      two by row parity where the buffer's copy may have landed: column
      nx-1 of the row below (z6) or column 0 (z3) fills it at its own
      gather, a wave or more before.

    ``poison``: fail (:class:`InplaceHazard`) on any buffer pull of a cell
    whose store has landed, and on any slot read that another row's value
    or the same wave filled. Returns |u| as an (h, nx) plane."""
    _, h, nx = buf.shape
    flat = buf.view(D2Q9.Q, h * nx)
    solid = mask.reshape(-1)
    delay = inplace_delay(h, nx, wave)
    carry = {"R": torch.full((3, nx), float("nan"), dtype=buf.dtype),
             "T": torch.full((3, nx), float("nan"), dtype=buf.dtype)}
    # landed[late][cell]: the cell's speeds 2, 5, 6 (late) or its other
    # six have been stored.
    landed = torch.zeros((2, h * nx), dtype=torch.bool)
    umag = torch.zeros(h * nx, dtype=buf.dtype)
    nan = float("nan")

    def pull(k, idx):
        if poison and bool(landed[int(k in _LATE), idx].any()):
            raise InplaceHazard(f"wave pulls speed {k} of a cell already "
                                "stored")
        return flat[k, idx]

    def land(phase_rows, p, new, late):
        """Store the late speeds (2, 5, 6) or the other six of positions p
        of the phase, each cell's carried row copied first."""
        j = torch.tensor(phase_rows)[p // nx]
        i = p % nx
        o = j * nx + i
        speeds = list(_LATE) if late else [k for k in range(D2Q9.Q)
                                            if k not in _LATE]
        if phase_rows[0] == 1:  # the interior: T and R before the store
            name, row, carried = (("R", h - 2, _LATE) if late
                                  else ("T", 1, (4, 7, 8)))
            sel = j == row
            if name in _CARRIED and bool(sel.any()):
                carry[name][:, i[sel]] = flat[list(carried)][:, o[sel]]
        flat[torch.tensor(speeds)[:, None], o] = new[speeds]
        landed[int(late), o] = True

    def phase(rows, below, above):
        """``rows``: the strip rows in the phase's order; ``below[r]`` /
        ``above[r]``: ("buf", strip row), ("slot", (3, nx) speeds)."""
        n = len(rows) * nx
        slots = {"z3": [None, None], "z6": [None, None]}
        pending = {}
        for k in range(-(-n // wave)):
            for m in sorted(pending):
                if m <= k - 2 and not pending[m][2]:
                    land(rows, *pending[m][:2], late=False)
                    pending[m][2] = True
                if m <= k - delay - 1:
                    land(rows, *pending.pop(m)[:2], late=True)
            # Below lo a late speed may have landed, below lo3 another.
            lo, lo3 = (k - delay) * wave, (k - 1) * wave
            p = torch.arange(k * wave, min((k + 1) * wave, n))
            read, written = set(), {}
            sp = [torch.empty(len(p), dtype=buf.dtype) for _ in range(9)]
            for r in sorted(set((p // nx).tolist())):
                sel = (p // nx) == r
                pr = p[sel]
                i = pr % nx
                iw, ie = (i - 1) % nx, (i + 1) % nx
                j = rows[r]
                rj = j * nx
                sp[0][sel] = pull(0, rj + i)
                sp[1][sel] = pull(1, rj + iw)
                z3 = (i == nx - 1) & (pr - nx + 1 < lo3)
                v3 = torch.full((len(pr),), nan, dtype=buf.dtype)
                v3[~z3] = pull(3, rj + ie[~z3])
                if bool(z3.any()):
                    v3[z3] = _slot_read(slots, "z3", r, r, k, poison, read)
                sp[3][sel] = v3
                kind, src = below[r]
                inphase = kind == "buf" and r > 0 and rows[r - 1] == src
                z6 = (inphase & (i == nx - 1) & (pr - 2 * nx + 1 < lo)
                      if inphase else torch.zeros_like(i, dtype=torch.bool))
                for q, (spd, c) in enumerate(((2, i), (5, iw), (6, ie))):
                    if kind == "buf":
                        v = torch.full((len(pr),), nan, dtype=buf.dtype)
                        ok = ~z6 if spd == 6 else torch.ones_like(z6)
                        v[ok] = pull(spd, src * nx + c[ok])
                        if spd == 6 and bool(z6.any()):
                            v[z6] = _slot_read(slots, "z6", r - 1, r, k,
                                               poison, read)
                    else:
                        v = src[q, c]
                    sp[spd][sel] = v
                kind, src = above[r]
                for q, (spd, c) in enumerate(((4, i), (7, ie), (8, iw))):
                    sp[spd][sel] = (pull(spd, src * nx + c) if kind == "buf"
                                    else src[q, c])
                # The slots this wave fills for later waves.
                w3 = (i == 0) & (pr < ((pr + nx - 1) // wave - 1) * wave)
                if bool(w3.any()):
                    written[("z3", r % 2)] = (pull(3, rj).clone()[None], r,
                                              k)
                nxt = r + 1 < len(rows) and below[r + 1] == ("buf", j)
                w6 = ((i == nx - 1) & (pr - nx + 1 < (
                    (pr + nx) // wave - delay) * wave)) if nxt else None
                if w6 is not None and bool(w6.any()):
                    written[("z6", r % 2)] = (pull(6, rj).clone()[None], r,
                                              k)
            if poison and read & set(written):
                raise InplaceHazard(f"wave {k} reads a slot it fills")
            for (name, s), v in written.items():
                slots[name][s] = v
            j = torch.tensor(rows)[p // nx]
            o = j * nx + p % nx
            planes, um = ref_ops._bgk_update_planes(sp, solid[o], omega)
            umag[o] = um
            pending[k] = [p, torch.stack(planes), False]
        for m in sorted(pending):
            p, new, early_landed = pending.pop(m)
            if not early_landed:
                land(rows, p, new, late=False)
            land(rows, p, new, late=True)

    if h > 2:
        phase(list(range(1, h - 1)),
              [("buf", j - 1) for j in range(1, h - 1)],
              [("buf", j + 1) for j in range(1, h - 1)])
    if h == 1:
        phase([0], [("slot", south)], [("slot", north)])
    elif h == 2:
        phase([0, 1], [("slot", south), ("buf", 0)],
              [("buf", 1), ("slot", north)])
    else:
        phase([0, h - 1], [("slot", south), ("slot", carry["R"])],
              [("slot", carry["T"]), ("slot", north)])
    return umag.view(h, nx)


def _slot_read(slots, name, row, reader_row, k, poison, read):
    """The value a wrap slot holds for ``row``, read at wave ``k``."""
    held = slots[name][row % 2]
    if held is None:
        if poison:
            raise InplaceHazard(f"row {reader_row} reads an empty {name}")
        return float("nan")
    value, filled_row, filled_wave = held
    if poison and (filled_row != row or filled_wave >= k):
        raise InplaceHazard(f"row {reader_row} reads {name} of row "
                            f"{filled_row} (wave {filled_wave}) at wave {k}")
    read.add((name, row % 2))
    return value


def _halo_slot(step: int) -> int:
    """The slot a strip reads at ``step``: the one its neighbours filled
    in that step."""
    return step % 2


def onchip_schedule(cells, obstacles, w1, w2, omega, gsteps: int, parts,
                    axis: int = 0, buffers: int = 2, wave: int = THREADS,
                    poison: bool = False):
    """The on-chip form's strip step in plain PyTorch over the strips
    ``parts`` (``(r0, h)`` pairs that tile the rows of ``cells`` in order,
    each stepped from its own rows and two halo slots by step parity, its
    north neighbour the next strip, wrapping). Each strip's rows of a step
    are sent before the step: its top row's speeds 2, 5, 6 into the north
    neighbour's south slot, its bottom row's 4, 7, 8 into the south
    neighbour's north slot; then it steps from the slot of that step
    (:func:`_halo_slot`; both slots NaN before their first rows land).

    ``buffers`` 2: step 0 sends the strip's rows, and every later step's
    rows are sent from the update of the step before (the kernel's edge
    cells send the new speeds they hold; the last step sends nothing); the
    copies are forced by the sender where the row (column mode: the
    column) is forced and the guard passes. Then each
    strip steps from ``[south slot, rows, north slot]``, the six speeds no
    halo carries left NaN (a pull that read one would show), with its own
    rows forced by the rule and the halo rows not again.

    ``buffers`` 1, the single-buffer mode: each strip forces its part of
    the forced line in place first and sends the forced rows; then one
    strip tensor is updated in place wave by wave
    (:func:`_inplace_strip_step`, ``wave`` cells a wave, the kernel's
    threads by default), each wave's stores deferred until the waves that
    pull its cells have gathered, the x wrap's far pulls and the edge rows'
    pulls of overwritten rows served from carried values; ``poison``: fail
    on any pull of a cell whose store has landed.

    Returns ``(new_cells, partials)``: ``partials[s, b]`` is strip b's sum
    of |u| over its fluid cells in step s."""
    if buffers not in (1, 2):
        raise ValueError(f"buffers must be 1 or 2, got {buffers}")
    _, ny, nx = cells.shape
    d = ref_ops._np_type(cells.dtype)
    accel = (cells.shape[1 + axis] - 2) % cells.shape[1 + axis]
    blocks = len(parts)
    state = [cells[:, r0:r0 + h].clone() for r0, h in parts]
    masks = [obstacles[r0:r0 + h] for r0, h in parts]
    # slots[b][0 south / 1 north][slot]: (3, nx) rows.
    unset = torch.full((3, nx), float("nan"), dtype=cells.dtype)
    slots = [[[unset, unset], [unset, unset]] for _ in parts]
    partials = torch.zeros((gsteps, blocks), dtype=cells.dtype)
    nan = torch.full((nx,), float("nan"), dtype=cells.dtype)
    forced = buffers == 2

    def send(slot):
        for b, (r0, h) in enumerate(parts):
            north, south = (b + 1) % blocks, (b - 1) % blocks
            top, bot = r0 + h - 1, r0
            slots[north][0][slot] = _sent_row(
                state[b][:, h - 1], masks[b][h - 1], forced and top == accel,
                d(w1), d(w2), axis if forced else 0, NORTH_SPEEDS)
            slots[south][1][slot] = _sent_row(
                state[b][:, 0], masks[b][0], forced and bot == accel, d(w1),
                d(w2), axis if forced else 0, SOUTH_SPEEDS)

    for s in range(gsteps):
        slot = s % 2
        if buffers == 1:
            for b, (r0, h) in enumerate(parts):
                if axis == 1:
                    state[b] = ref_ops.accelerate_flow(state[b], masks[b],
                                                       w1, w2, axis=1)
                elif r0 <= accel < r0 + h:
                    state[b] = ref_ops.accelerate_flow(
                        state[b], masks[b], w1, w2, row=accel - r0)
        if buffers == 1 or s == 0:
            send(slot)
        read = _halo_slot(s)
        new_state = []
        for b, (r0, h) in enumerate(parts):
            if buffers == 1:
                umag = _inplace_strip_step(state[b], masks[b],
                                           slots[b][0][read],
                                           slots[b][1][read], omega, wave,
                                           poison)
                new_state.append(state[b])
                partials[s, b] = torch.sum(umag.masked_fill(masks[b], 0.0))
                continue
            south_row = torch.stack([nan] * D2Q9.Q)
            north_row = torch.stack([nan] * D2Q9.Q)
            south_row[list(NORTH_SPEEDS)] = slots[b][0][read]
            north_row[list(SOUTH_SPEEDS)] = slots[b][1][read]
            own = state[b]
            if axis == 1:
                own = ref_ops.accelerate_flow(own, masks[b], w1, w2, axis=1)
            elif r0 <= accel < r0 + h:
                own = ref_ops.accelerate_flow(own, masks[b], w1, w2,
                                              row=accel - r0)
            ext = torch.cat([south_row[:, None], own, north_row[:, None]], 1)
            planes, umag = ref_ops._bgk_update_planes(
                ref_ops._pull_halo(ext, h), masks[b], omega)
            new_state.append(torch.stack(planes))
            partials[s, b] = torch.sum(umag.masked_fill(masks[b], 0.0))
        state = new_state
        if forced and s + 1 < gsteps:
            send((s + 1) % 2)
    return torch.cat(state, dim=1), partials


def sum_in_order(partials):
    """Each row of ``partials`` summed from zero in its order, one addition
    at a time (a strip's partials in block order, as the on-chip kernels'
    last block sums them)."""
    tots = torch.zeros(partials.shape[0], dtype=partials.dtype)
    for s, row in enumerate(partials):
        tot = torch.zeros((), dtype=partials.dtype)
        for p in row:
            tot = tot + p
        tots[s] = tot
    return tots


def resident_onchip_emulated(cells, obstacles, w1, w2, omega, gsteps: int,
                             blocks: int, axis: int = 0, buffers: int = 2,
                             wave: int = THREADS, poison: bool = False):
    """The on-chip form's schedule in plain PyTorch: ``blocks`` strips of
    whole rows (:func:`strips`) stepped by :func:`onchip_schedule` in
    ``buffers`` buffers. tot_u: per strip the sum over its fluid cells,
    then the strips' partials in block order (so both modes give the same
    tots). Returns ``(new_cells, tots)``; cells are bit-identical to
    :func:`.reference.multi_step`, tots differ from its by summation
    order."""
    new, partials = onchip_schedule(cells, obstacles, w1, w2, omega, gsteps,
                                    strips(cells.shape[1], blocks), axis,
                                    buffers, wave, poison)
    return new, sum_in_order(partials)
