"""The resident kernel's wrapper: ``gsteps`` timesteps of the lattice in
one persistent, cooperative CUDA launch, the port of
``lbm_tpu/ops/pallas_resident.py::_kernel_resident`` (in row mode and in
the column mode of its ``lane_accel``), which also writes the ``gsteps``
tot_u values on the device. Two forms of the one TPU kernel, chosen by
size (:func:`.plan.resident_form`):

- ``"onchip"`` (``csrc/resident_onchip.cu``): each block holds its strip
  of rows in shared memory for all G steps and trades its edge rows with
  its two neighbours through L2, under a flag per (direction, slot);
- ``"inplace"``: the same kernel's single-buffer mode (the JAX kernel's
  in-place mode, ``LBM_RESIDENT_INPLACE``): one buffer a strip, updated in
  place in waves, what a later wave pulls from an overwritten cell carried
  beside it;
- ``"device"`` (``csrc/resident.cu``): the lattice stays in device
  memory; the blocks step it in rounds of up to four steps on the depth
  kernel's shared-memory tiles (``csrc/lbm_depth.cuh``), one grid barrier
  a round (:func:`device_rounds`);
- ``"shift"``: the same form's shift mode (the JAX kernel's offset-load
  mode, ``LBM_RESIDENT_SHIFT``, row mode only): rounds of one step on the
  same tiles, each cell's nine speeds loaded straight from the source
  buffer at offset rows and columns, nothing staged.

A tensor on the CPU runs the plain version,
:func:`.reference.multi_step`, whatever the form; a CUDA tensor launches
the kernel of its form or raises, also when the device refuses the
cooperative launch or the strip's shared memory: a refused form never
falls back to the other. The result is in the first of the two buffers
they are given after an even ``gsteps`` and in the second after an odd
one (the single-buffer mode copies out to whichever the contract names);
the CPU path keeps the same contract. :func:`resident_onchip_emulated` is
the on-chip form's strips, halo slots and sums in plain PyTorch, in both
of its modes, :func:`resident_device_emulated` the device form's rounds
and :func:`resident_shift_emulated` its shift mode's, for the CPU tests.
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
# Tags restart from zero (flags zeroed) before they would pass 2**31.
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
    form's as many as can be co-resident, at most one a tile); a
    device-form launch of more than can be co-resident raises. On a CUDA
    mask the launch geometry is fixed at construction and the scratch
    (partials and tile tickets; on chip halo slots, flags and the ticket)
    allocated once; an on-chip mode whose strips do not fit the card's
    shared memory raises there."""

    def __init__(self, mask: torch.Tensor, w1, w2, omega, gsteps: int,
                 axis: int = 0, form: str | None = None,
                 blocks: int | None = None):
        if gsteps < 1:
            raise ValueError(f"gsteps must be positive, got {gsteps}")
        if form is not None and form not in plan.RESIDENT_FORMS:
            raise ValueError(f"unknown resident form {form!r}; known: "
                             f"{plan.RESIDENT_FORMS}")
        if form == "shift" and axis:
            raise ValueError("the shift mode runs in row mode only (axis 0), "
                             "as the JAX kernel's")
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
        self._shift = int(self.form == "shift")
        n = lib.lbm_resident_blocks(ny, nx, axis, self._shift, self._index)
        if n < 0:
            _build.check(lib, -n, "resident launch geometry")
        self.blocks = n if blocks is None else int(blocks)
        if self.blocks < 1:
            raise ValueError(f"{self.blocks} blocks")
        self.rounds = ([1] * self.gsteps if self._shift
                       else device_rounds(self.gsteps))
        self._partials = torch.empty(
            self.gsteps * lib.lbm_depth_num_partials(4, ny, nx),
            dtype=torch.float32, device=self.device)
        # The tile tickets of even and odd rounds, zero between launches.
        self._tickets = torch.zeros(2, dtype=torch.int32, device=self.device)

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
        self._halo = torch.zeros(self.blocks * 2 * 2 * 3 * nx,
                                 dtype=torch.float32, device=dev)
        # Flags and ticket as int32 words the kernel reads as unsigned.
        self._flags = torch.zeros(self.blocks * 4, dtype=torch.int32,
                                  device=dev)
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
                self._flags.zero_()
                self._step_base = 0
            _build.check(lib, lib.lbm_resident_onchip(
                a.data_ptr(), result[0].data_ptr(), self._mask_u8.data_ptr(),
                self._halo.data_ptr(), self._flags.data_ptr(),
                self._partials.data_ptr(), self._ticket.data_ptr(),
                out.data_ptr() + 4 * t, ny, nx, self.accel, self.w1,
                self.w2, self.omega, self.mode, g, self._scale(scale),
                self._step_base, self.blocks, self.axis, self.buffers,
                self._index, self._stream(),
            ), f"on-chip resident G={g} cooperative launch")
            self._step_base += g
            self._launched("resident_onchip_inplace" if self.buffers == 1
                           else "resident_onchip")
            return result
        rounds = self.rounds
        _build.check(lib, lib.lbm_resident(
            a.data_ptr(), b.data_ptr(), self._mask_u8.data_ptr(),
            self._partials.data_ptr(), self._tickets.data_ptr(),
            out.data_ptr() + 4 * t, ny, nx, self.accel, self.w1, self.w2,
            self.omega, self.mode, g, rounds.count(4), rounds.count(2),
            rounds.count(1), self._scale(scale), self.blocks, self.axis,
            self._shift, self._index, self._stream(),
        ), f"resident G={g} cooperative launch")
        self._launched("resident_shift" if self._shift else "resident")
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


def _rounds_emulated(cells, obstacles, w1, w2, omega, rounds, axis):
    """Each round of ``rounds`` (its steps) as
    :func:`.fused_depth.fused_depth_emulated` at that depth on the depth
    kernel's 32 x 24 tile and 40-wide window (the kernel's tile at every
    depth, 1 included), its tots summed by tile in tile order."""
    tots, c = [], cells
    for d in rounds:
        c, t = fused_depth.fused_depth_emulated(
            c, obstacles, w1, w2, omega, d, tile=fused_depth.TILES[4],
            axis=axis, halo_x=fused_depth.HALO_X[4])
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
    north neighbour the next strip, wrapping). Every step each strip first
    sends: its top row's speeds 2, 5, 6 into the north neighbour's south
    slot, its bottom row's 4, 7, 8 into the south neighbour's north slot;
    then it steps from the slot of that step (:func:`_halo_slot`; both
    slots NaN before their first rows land).

    ``buffers`` 2: the copies are forced by the sender where the row
    (column mode: the column) is forced and the guard passes. Then each
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
        for b, (r0, h) in enumerate(parts):
            north, south = (b + 1) % blocks, (b - 1) % blocks
            top, bot = r0 + h - 1, r0
            forced = buffers == 2
            slots[north][0][slot] = _sent_row(
                state[b][:, h - 1], masks[b][h - 1], forced and top == accel,
                d(w1), d(w2), axis if forced else 0, NORTH_SPEEDS)
            slots[south][1][slot] = _sent_row(
                state[b][:, 0], masks[b][0], forced and bot == accel, d(w1),
                d(w2), axis if forced else 0, SOUTH_SPEEDS)
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
