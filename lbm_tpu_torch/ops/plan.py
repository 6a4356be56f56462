"""The segment planner: which kernel runs which steps of a run.

The twin of the JAX package's planning functions, with the same env pins
and meanings:

- ``lbm_tpu.ops.pallas_resident``: ``resident_prefs``,
  ``_pinned_steps`` and ``_G_PREF``;
- ``lbm_tpu.ops.pallas_fused``: ``_depth_preference``, ``plan_split``
  and the kernel choice of ``make_carry_step``;
- ``lbm_tpu.runner._segments``.

Pins: ``LBM_RESIDENT`` ("0" disables the resident kernel, "1" forces
it), ``LBM_RESIDENT_STEPS`` (pins G; a positive integer, even unless the
planned form is the single-buffer one, as the JAX package's
``_pinned_steps``), ``LBM_RESIDENT_INPLACE`` ("1" pins the on-chip form's
single-buffer mode, "0", "" or "false" its two buffers; the JAX
package's knob for ``_kernel_resident``'s in-place mode),
``LBM_RESIDENT_SHIFT`` (anything but "0", "" or "false" pins the
device-memory form's shift mode in row layout, "0", "" or "false" keeps
it off; the JAX package's knob for ``_kernel_resident``'s offset-load
mode) and ``LBM_PALLAS_DEPTH`` (caps
the depth kernel's D and prefers the cap; 1 leaves the one-step kernel);
the port's own ``LBM_RESIDENT_FORM`` ("onchip", its two buffers, or
"device") pins the resident kernel's form, which is otherwise
:func:`resident_form`'s size rule.

What the automatic choice prefers is measured on the H100, not carried
over from the TPU's VMEM gates (PERF.md, "Where the time goes"). The
single-buffer mode has the JAX package's place in the order (two buffers
where they fit, else one); where it runs under ``auto`` was measured
again on the H100. The shift mode, opt-in in JAX, is taken by ``auto``
where it was measured faster (:func:`shift_auto`).
"""

from __future__ import annotations

import dataclasses
import os

from lbm_tpu_torch.ops.fused_depth import DEPTHS, FLOW_DEPTH, n_tiles
from lbm_tpu_torch.profiling import BYTES_PER_CELL_PASS, CHIP_PEAKS

# G per resident launch, most preferred first: the JAX package's list.
# Large G amortises the launch; the list stays divisor-rich so official
# iteration counts (20000, 40000, 2000) plan as one segment, and stops at
# 16 so that a small exact divisor never takes a whole run from the
# main + tail split at G=100.
G_PREF = (100, 64, 50, 32, 20, 16)

# Automatic choice, set from chip_smoke.py's timing phases and
# scripts/resident_ab_torch.py on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md, "Where the time goes"). The resident kernel removes the
# per-step launches. Its on-chip form in two buffers (where a strip fits,
# up to about 418K cells) beat the depth kernel at D=4 at every lattice
# measured. Its device-memory form, rounds of up to four steps on the
# depth kernel's tiles, is 0.97-1.04x D=4 up to RESIDENT_AUTO_MAX_CELLS
# and 1.07-1.12x above it in row mode (0.98x on the transposed 131072x128
# and 16384x1024): faster by 2 % nowhere above the limit, which stays the
# device form's. The on-chip form's single-buffer mode takes the lattices
# whose two-buffer strips do not fit and whose one-buffer strips of at
# least INPLACE_MIN_ROWS rows do, below the limit and above it
# (resident_form): 0.77-0.84x D=4 at 1024x400, 400x1024, 3200x128,
# 1024x512, 1024x640 and 768x768, 0.85x and 0.93x with strips of 2 and 3
# rows (1600x264, 1200x396), where the device form takes 0.97-1.07x; but
# 1.46x at 4096x64, whose strips are one row: every cell is an edge cell,
# sent and received every step, and no interior row hides the
# neighbours' wait. A pin never lifts the cell limit (resident_prefs).
# D=4 is the depth kernel's best at 1024x1024 and 16384x1024, D=2 its
# next, and so on the transposed 131072x128 too (D=8 about 1.37x D=4):
# the JAX package's D=8 preference at 128 lanes, a TPU measurement, is
# not carried over.
RESIDENT_AUTO_MAX_CELLS = 792 * 528
INPLACE_MIN_ROWS = 2
AUTO_DEPTHS = (4, 2)
# The depth kernel's flow form (flow_rounds): rounds of FLOW_DEPTH steps,
# FLOW_STEPS steps a launch (as the resident forms' G=100), where a
# one-round launch is shorter than FLOW_MAX_WAVES waves of the card's
# block slots, by forcing mode (row, column). Each launch of one round
# pays a fixed cost (its lockstep start, partial last wave, last block's
# epilogue and the gap to the next kernel), the flow form a cost a tile
# (the ticket and the neighbours' polls before the window, the release
# after the stores), higher in row mode, whose flow kernel spills more.
# Measured with scripts/depth_ab_torch.py --flow on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md, the flow form's findings), device time a step
# against one round a launch: row mode 0.94x at 1024^2 (5.2 waves),
# 0.974x at 1024x1152 (5.8), 0.984x at 1024x1280 (6.5), 1.008x at
# 1024x1536 (7.8), 1.039x at 1024x2048 (10.4), 1.077x at 1024x4096
# (20.7); column mode 0.972x at the transposed 2048x1024
# (10.4), 1.028x at 4096x1024 (20.7), 1.055x at 8192x1024 (41.5) and
# 1.069x at 16384x1024 (82.8).
FLOW_STEPS = 100
FLOW_MAX_WAVES = (7, 15)
# The wide-grid layout's size rule (transposed_layout), measured on the
# H100 when the resident kernel's limit was 512x512 cells and left there
# when that limit moved (PERF.md).
TRANSPOSED_MIN_CELLS = 512 * 512

# The resident kernel's forms (ops/resident.py). The on-chip form
# (csrc/resident_onchip.cu) gives each of up to one block an SM a strip of
# whole rows in shared memory for all G steps: two float32 buffers of nine
# speeds and the mask bytes, 73 B a cell, beside a fixed scratch; its
# single-buffer mode ("inplace") one buffer, 37 B a cell, beside the
# scratch and its carry (four floats and, for strips of two rows or more,
# one or two rows of three speeds). Its halo rows (three speeds a cell)
# stay in L2 and take no shared memory. The device-memory form
# (csrc/resident.cu) keeps the lattice in device memory and takes any
# size; its shift mode ("shift", row mode only) steps a step at a time
# over blocks that own their tiles for the launch, the cells in shared
# memory where a block's fit (shift_residence).
# LBM_RESIDENT_FORM pins one of FORM_PINS, LBM_RESIDENT_SHIFT the shift
# mode.
RESIDENT_FORMS = ("onchip", "inplace", "device", "shift")
FORM_PINS = ("onchip", "device")
ONCHIP_BYTES_PER_CELL = {2: 73, 1: 37}
ONCHIP_SCRATCH_BYTES = (2 * 32 + 4) * 4
# The shift mode under auto (shift_auto), measured on an NVIDIA H100 80GB
# HBM3 at 700 W (chip_smoke.py's onchip_timing, PERF.md): the narrow
# channels 4096x64 and 8192x32, whose on-chip strips would be one row and
# whose two buffers and mask fit the L2, at 0.80-0.92x the device form's
# rounds and 0.79-0.92x D=4 (0.49-0.54x the device form since its
# redesign, PERF.md). Where the lattice does not fit the L2 a pass
# a step costs (1024x1024: 1.48x the device form), and at 512x512 and the
# physical 1024x400 it was 0.99x and 1.09x: neither is taken.
L2_BYTES = CHIP_PEAKS["h100"]["l2_bytes"]


def transposed_layout(ny: int, nx: int) -> bool:
    """The one home of the wide-grid policy: the transposed lattice,
    (9, nx, ny) with its speeds permuted by
    :data:`lbm_tpu_torch.state.SIGMA`, the forced row ny-2 becoming the
    column ny-2. The single-device planner (:func:`layout`) and the
    sharded one (``parallel.halo.plan_sharding``) both ask here, so a
    sharded run and the unsharded run share a layout.

    ``lbm_tpu.ops.pallas_fused._transposed_layout``'s rule (at least
    twice as wide as tall, nx a multiple of 8), narrowed by the H100's
    timings (PERF.md, "Where the time goes"): above
    :data:`TRANSPOSED_MIN_CELLS` the column modes run no slower than the
    row modes (131072x128 and 16384x1024: depth D=4 and the one-step
    kernel faster), and the x-plan's halo is a small fraction of the row
    plan's; up to it they ran slower (1024x256), so those grids keep the
    physical layout."""
    return nx >= 2 * ny and nx % 8 == 0 and nx * ny > TRANSPOSED_MIN_CELLS


def onchip_blocks(ny: int, nx: int, sms: int) -> int:
    """Blocks of the on-chip form for an ny x nx lattice on a card of
    ``sms`` SMs: one an SM, at most one a row."""
    return max(1, min(ny, sms))


def onchip_smem_bytes(ny: int, nx: int, blocks: int,
                      buffers: int = 2) -> int:
    """Dynamic shared memory of one block of the on-chip form over
    ``blocks`` strips in ``buffers`` buffers (2, or 1: the single-buffer
    mode): the tallest strip's cells at 73 B (37 B), plus the scratch and,
    in one buffer, the carry: 16 B and 12 B a column for each of
    ``min(h - 1, 2)`` rows (``csrc/resident_onchip.cu``'s
    ``smem_bytes``)."""
    h = -(-ny // blocks)
    cells = ONCHIP_BYTES_PER_CELL[buffers] * h * nx + ONCHIP_SCRATCH_BYTES
    if buffers == 2:
        return cells
    return cells + 16 + 12 * nx * min(h - 1, 2)


def onchip_fits(ny: int, nx: int, sms: int, smem_per_block: int,
                buffers: int) -> bool:
    """Whether the on-chip form's strips of the ny x nx lattice over
    :func:`onchip_blocks` blocks fit ``smem_per_block`` bytes of shared
    memory (the card's opt-in limit) in ``buffers`` buffers."""
    blocks = onchip_blocks(ny, nx, sms)
    return onchip_smem_bytes(ny, nx, blocks, buffers) <= smem_per_block


def resident_form(ny: int, nx: int, sms: int, smem_per_block: int) -> str:
    """The resident kernel's form for the ny x nx lattice under
    ``auto`` on a card of ``sms`` SMs and ``smem_per_block`` bytes of
    shared memory a block, in the JAX package's order (``_inplace_mode``):
    ``"onchip"`` where the two-buffer strips fit, else ``"inplace"`` (the
    single-buffer mode) where the one-buffer strips fit and are at least
    :data:`INPLACE_MIN_ROWS` rows tall (the measured exception above), else
    ``"device"``. A pure size rule: the wrapper of a form that the card
    then refuses raises; it never takes another form."""
    if onchip_fits(ny, nx, sms, smem_per_block, 2):
        return "onchip"
    tall = -(-ny // onchip_blocks(ny, nx, sms)) >= INPLACE_MIN_ROWS
    if tall and onchip_fits(ny, nx, sms, smem_per_block, 1):
        return "inplace"
    return "device"


def pinned_form() -> str | None:
    """The ``LBM_RESIDENT_FORM`` pin ("onchip" or "device"), or None."""
    pin = os.environ.get("LBM_RESIDENT_FORM")
    if not pin:
        return None
    if pin not in FORM_PINS:
        raise ValueError(f"LBM_RESIDENT_FORM={pin!r}: expected one of "
                         f"{FORM_PINS}")
    return pin


def pinned_inplace() -> bool | None:
    """The ``LBM_RESIDENT_INPLACE`` pin as the JAX package reads it
    (``_inplace_override``): None unset, False for "0", "" or "false"
    (two buffers), True for anything else (one buffer)."""
    env = os.environ.get("LBM_RESIDENT_INPLACE")
    if env is None:
        return None
    return env not in ("0", "", "false")


def pinned_shift() -> bool | None:
    """The ``LBM_RESIDENT_SHIFT`` pin as the JAX package reads it
    (``_pallas_resident``): None unset, False for "0", "" or "false", True
    for anything else."""
    env = os.environ.get("LBM_RESIDENT_SHIFT")
    if env is None:
        return None
    return env not in ("0", "", "false")


def shift_auto(ny: int, nx: int, sms: int) -> bool:
    """Whether ``auto`` takes the device-memory form's shift mode for a
    row-layout ny x nx lattice that :func:`resident_form` sends to the
    device form, on a card of ``sms`` SMs: where its on-chip strips would
    be one row (``ny <= sms``: the narrow channels) and both buffers and
    the mask fit the L2, the measured rule above :data:`L2_BYTES`."""
    return ny <= sms and BYTES_PER_CELL_PASS * ny * nx <= L2_BYTES


# The shift mode's ownership and residence (csrc/lbm_rounds.cuh's
# shift_groups, slab_bytes; csrc/resident.cu's shift_shape): each block owns
# a rectangle of whole depth tiles (SHIFT_TILE rows x columns) for the
# launch, and holds its cells in shared memory (two buffers of nine speeds
# with a one-cell ring, the mask, the partials' lanes of its tiles by step
# parity) where that fits the card's opt-in limit less
# SHIFT_STATIC_BYTES, at one block an SM; else the cells stay in device
# memory, at as many blocks as the device residence's kernel keeps on the
# card.
SHIFT_TILE = (24, 32)
SHIFT_TILE_WARPS = 15
SHIFT_STATIC_BYTES = 1024
SHIFT_RESIDENCES = ("shared", "device")


def _group_start(g: int, n: int, t: int) -> int:
    """The first tile of group g of n groups over t tiles: the first
    ``n - t % n`` groups take ``t // n`` tiles, the rest one more (so the
    ragged last tile falls in a larger group)."""
    q, small = divmod(t, n)[0], n - t % n
    return g * q if g <= small else small * q + (g - small) * (q + 1)


def shift_groups(ny: int, nx: int, blocks: int) -> tuple[int, int]:
    """``(column groups, row groups)`` of the shift mode's ownership of an
    ny x nx lattice over at most ``blocks`` blocks: a group of whole tile
    columns a block where there are as many tile columns as blocks
    (full-height slabs), else each tile column cut into as many groups of
    whole tile rows as the blocks allow. Block ``rg * ncg + cg`` owns
    column group cg of row group rg."""
    if blocks < 1:
        raise ValueError(f"{blocks} blocks")
    ty, tx = SHIFT_TILE
    tiles_x, tiles_y = -(-nx // tx), -(-ny // ty)
    if tiles_x >= blocks:
        return blocks, 1
    return tiles_x, min(tiles_y, blocks // tiles_x)


def shift_rects(ny: int, nx: int, blocks: int) -> list[tuple[int, ...]]:
    """Each owning block's ``(y0, y1, x0, x1)`` (rows ``[y0, y1)``, columns
    ``[x0, x1)``), in block order, over at most ``blocks`` blocks."""
    ty, tx = SHIFT_TILE
    tiles_x, tiles_y = -(-nx // tx), -(-ny // ty)
    ncg, nrg = shift_groups(ny, nx, blocks)
    cols = [(_group_start(g, ncg, tiles_x) * tx,
             min(nx, _group_start(g + 1, ncg, tiles_x) * tx))
            for g in range(ncg)]
    rows = [(_group_start(g, nrg, tiles_y) * ty,
             min(ny, _group_start(g + 1, nrg, tiles_y) * ty))
            for g in range(nrg)]
    return [(y0, y1, x0, x1) for y0, y1 in rows for x0, x1 in cols]


def shift_smem_bytes(ny: int, nx: int, blocks: int) -> int:
    """Dynamic shared memory of a block of the shift mode's shared
    residence over at most ``blocks`` blocks: two (h + 2) x (w + 2) planes
    of nine float32 speeds (the cells and a one-cell ring) and one of mask
    bytes for the widest and tallest block, and a |u| a cell and
    SHIFT_TILE_WARPS warp sums (float32) a tile of its most tiles, by step
    parity."""
    rects = shift_rects(ny, nx, blocks)
    ty, tx = SHIFT_TILE
    w = max(x1 - x0 for _, _, x0, x1 in rects)
    h = max(y1 - y0 for y0, y1, _, _ in rects)
    tiles = max(-(-(x1 - x0) // tx) for _, _, x0, x1 in rects) * \
        max(-(-(y1 - y0) // ty) for y0, y1, _, _ in rects)
    plane = (h + 2) * (w + 2)
    return (2 * 9 * plane * 4
            + 2 * tiles * (ty * tx + SHIFT_TILE_WARPS) * 4 + plane)


def shift_residence(ny: int, nx: int, blocks: int, smem_per_block: int) -> str:
    """Where the shift mode keeps its cells over at most ``blocks`` blocks
    (one an SM: the card's SM count) on a card of ``smem_per_block`` opt-in
    shared memory: "shared" where a block fits (:func:`shift_fits`), else
    "device". Measured on an H100 (PERF.md): shared 0.64x the device
    residence's time at 4096x64, 0.92x at 256x256, 0.66x at 512x512."""
    return "shared" if shift_fits(ny, nx, blocks, smem_per_block) else "device"


def shift_fits(ny: int, nx: int, blocks: int, smem_per_block: int) -> bool:
    """Whether a block of the shift mode's shared residence over at most
    ``blocks`` blocks fits ``smem_per_block`` bytes of opt-in shared
    memory beside the kernel's static shared memory."""
    need = shift_smem_bytes(ny, nx, blocks) + SHIFT_STATIC_BYTES
    return need <= smem_per_block


def planned_form(ny: int, nx: int, limits,
                 shift_mode: bool = False) -> str | None:
    """The resident kernel's form for an ny x nx lattice on a card of
    ``limits`` = ``(SMs, shared memory a block may opt in to)``, or None
    off the card (``limits`` None). ``shift_mode``: the kernel that runs
    has the shift mode (the single-device resident kernel in row layout;
    not the ring, not column mode, as in JAX).

    The pins first: ``LBM_RESIDENT_SHIFT`` where ``shift_mode``, the
    device-memory form's shift mode, on the card or off it (a pin that
    cannot hold beside it raises a ``ValueError``: ``LBM_RESIDENT_FORM=
    onchip`` or a set ``LBM_RESIDENT_INPLACE``, which pin the on-chip
    form); ``LBM_RESIDENT_FORM=device`` the device-memory form (with
    ``LBM_RESIDENT_INPLACE=1`` a ``ValueError``: that form has no
    single-buffer mode); ``LBM_RESIDENT_INPLACE`` "1" the single-buffer
    mode, "0" the two buffers, of the on-chip form;
    ``LBM_RESIDENT_FORM=onchip`` the on-chip form's two buffers. Unpinned,
    :func:`resident_form`, and where that is the device form and
    ``shift_mode``, its shift mode where :func:`shift_auto` takes it
    (``LBM_RESIDENT_SHIFT=0`` keeps the default mode). A pinned mode whose
    strips do not fit is returned all the same: the wrapper raises where
    it would run."""
    form, inplace, shift = pinned_form(), pinned_inplace(), pinned_shift()
    if shift_mode and shift:
        if form == "onchip" or inplace is not None:
            pin = ("LBM_RESIDENT_FORM=onchip" if form == "onchip" else
                   "LBM_RESIDENT_INPLACE="
                   + os.environ["LBM_RESIDENT_INPLACE"])
            raise ValueError(f"LBM_RESIDENT_SHIFT with {pin}: the shift mode "
                             "is the device-memory form's, and the other "
                             "pin is the on-chip form's")
        return "shift"
    if form == "device":
        if inplace:
            raise ValueError("LBM_RESIDENT_INPLACE=1 with LBM_RESIDENT_FORM="
                             "device: the device-memory form has no "
                             "single-buffer mode")
        return "device"
    if limits is None:
        return None
    if inplace is not None:
        return "inplace" if inplace else "onchip"
    if form:
        return form
    auto = resident_form(ny, nx, *limits)
    if (auto == "device" and shift_mode and shift is None
            and shift_auto(ny, nx, limits[0])):
        return "shift"
    return auto


def layout(params) -> tuple[bool, int, int]:
    """``(transposed, rows, lanes)`` of the execution layout of a
    ``cuda`` run, the twin of ``lbm_tpu.ops.pallas_fused._layout``: the
    transposed lattice's ``(nx, ny)`` where :func:`transposed_layout`
    says so, else ``(ny, nx)``.
    The segment planners take these rows and lanes."""
    ny, nx = params.ny, params.nx
    if transposed_layout(ny, nx):
        return True, nx, ny
    return False, ny, nx


@dataclasses.dataclass(frozen=True)
class Segment:
    """``steps`` steps of one kernel, ``steps_per_call`` per launch:
    ``kernel`` is "step" (one step per launch), "depth" (D per launch),
    "resident" (G per launch), "ring" (G per launch on every shard) or
    "reference" (the plain path). ``form``: the resident kernel's or the
    ring's form on the card ("onchip", "inplace", "device" or "shift",
    :func:`planned_form`, ``parallel.resident_ring.ring_form``), None
    where no card was asked."""

    kernel: str
    steps_per_call: int
    steps: int
    form: str | None = None
    # The depth kernel's rounds a launch (its flow form where above 1):
    # steps_per_call = D * rounds.
    rounds: int = 1

    @property
    def launches(self) -> int:
        return self.steps // self.steps_per_call

    @property
    def launch_key(self) -> str:
        """The kernel's name in ``ops.fused.LAUNCHES`` (without the
        column mode's "_cols")."""
        if self.kernel == "depth" and self.rounds > 1:
            return "depth_flow"
        if self.kernel not in ("resident", "ring"):
            return self.kernel
        return {"onchip": f"{self.kernel}_onchip",
                "inplace": f"{self.kernel}_onchip_inplace",
                "shift": f"{self.kernel}_shift"}.get(self.form, self.kernel)

    def describe(self) -> str:
        rounds = f" K={self.rounds}" if self.rounds > 1 else ""
        size = {"depth": f" D={self.steps_per_call // self.rounds}{rounds}",
                "resident": f" G={self.steps_per_call}",
                "ring": f" G={self.steps_per_call}"}.get(self.kernel, "")
        form = {"onchip": " on-chip", "inplace": " on-chip 1-buf",
                "device": " device-memory",
                "shift": " device-memory shift"}.get(self.form, "")
        return f"{self.kernel}{size}{form} x{self.launches}"


def _pinned_steps(even: bool) -> int | None:
    """The ``LBM_RESIDENT_STEPS`` pin, or None; an invalid or
    non-positive value raises, and so does an odd one where ``even`` (a
    form that is not the single-buffer one), as the JAX package's
    ``_pinned_steps``."""
    pin = os.environ.get("LBM_RESIDENT_STEPS")
    if not pin:
        return None
    try:
        g = int(pin)
    except ValueError:
        raise ValueError(f"LBM_RESIDENT_STEPS={pin!r} is not an integer") \
            from None
    if g < 1:
        raise ValueError(f"LBM_RESIDENT_STEPS={g} must be positive")
    if even and g % 2:
        raise ValueError(
            f"LBM_RESIDENT_STEPS={g}: this kernel steps in pairs and needs "
            "an even count; only the on-chip resident form's single-buffer "
            "mode (LBM_RESIDENT_INPLACE=1, or the planned form 'inplace') "
            "takes an odd one"
        )
    return g


def resident_prefs(ny: int, nx: int, form: str | None = None,
                   limits=None) -> tuple[int, ...] | None:
    """G preferences, most preferred first, when the resident kernel
    applies to an ny x nx lattice whose planned form is ``form``
    (:func:`planned_form`) on a card of ``limits`` (None off the card);
    else None. ``LBM_RESIDENT`` "0" disables, "1" forces; unset, the
    measured size rule decides: up to RESIDENT_AUTO_MAX_CELLS, and above
    it where the form is the single-buffer one and :func:`resident_form`
    takes that mode there itself (a pin never lifts the limit). An odd
    ``LBM_RESIDENT_STEPS`` needs that form."""
    env = os.environ.get("LBM_RESIDENT")
    if env is not None and env in ("0", "", "false"):
        return None
    if env is None and ny * nx > RESIDENT_AUTO_MAX_CELLS and not (
            form == "inplace" and limits is not None
            and resident_form(ny, nx, *limits) == "inplace"):
        return None
    pin = _pinned_steps(even=form != "inplace")
    return (pin,) if pin else G_PREF


def depth_preference(ny: int, nx: int) -> list[int]:
    """Depths to try, most preferred first. ``LBM_PALLAS_DEPTH`` caps
    the depth and prefers the cap (1 or less: none, the one-step kernel
    only); unset, the measured rule."""
    env = os.environ.get("LBM_PALLAS_DEPTH")
    if env is not None:
        dmax = int(env)
        return [d for d in DEPTHS if d <= dmax]
    return list(AUTO_DEPTHS)


def split(iters: int, gprefs, depths) -> tuple[int, int]:
    """``(main, tail)``: split ``iters`` so the main part runs at the
    preferred granularity, for given G preferences (None: no G-step
    kernel) and depths, most preferred first. A count some preferred G
    divides is one G-step segment; otherwise a G-step main at the first
    G. When no G-step kernel applies, or the count is shorter than that
    G, a depth main at the first preferred D that the count exceeds
    without dividing it, unless an earlier D divides it. ``(iters, 0)``
    when no split helps.

    One difference from the JAX package's ``plan_split``, which tries
    only its first depth: a count shorter than the first D tries the
    next, so a tail never leaves more than one step to the one-step
    kernel (the smallest D is 2)."""
    if gprefs and iters > 0:
        if any(iters % g == 0 for g in gprefs):
            return iters, 0
        main = iters - iters % gprefs[0]
        if main:
            return main, iters % gprefs[0]
    for d in depths:
        if iters % d == 0:
            break
        if iters > d:
            return iters - iters % d, iters % d
    return iters, 0


def choose(n_iters: int, gprefs, depths, many: str = "resident"):
    """``(kernel, steps_per_call)`` for a segment of ``n_iters`` steps:
    the G-step kernel (``many``: "resident", or "ring" on a sharded run)
    at the first preferred G that divides it, else the depth kernel at
    the first preferred D that divides it, else the one-step kernel."""
    g = next((g for g in gprefs or () if n_iters % g == 0), None)
    if g:
        return many, g
    for d in depths:
        if n_iters % d == 0:
            return "depth", d
    return "step", 1


def segments(ny: int, nx: int, iters: int, form: str | None = None,
             limits=None, slots: int | None = None,
             axis: int = 0) -> list[Segment]:
    """Plan a run of ``iters`` steps as segments that sum to ``iters``.
    One segment when a preferred granularity divides ``iters``;
    otherwise a main segment and the tail re-planned, so any count runs
    at full speed with at most one step on the one-step kernel (for
    example 1099 steps with the resident kernel: 1000 at G=100, 96 at
    G=32, then 2 at D=2 and 1 single step). ``form``: the resident
    kernel's form, given to its segments; ``limits``: the card's
    (:func:`resident_prefs`); ``slots``: the depth kernel's resident
    blocks on the card (None off it), whose D = 4 segments then take
    :func:`flow_rounds` rounds a launch (:func:`flow_segments`) in
    forcing mode ``axis``."""
    return flow_segments(
        plan_segments(iters, resident_prefs(ny, nx, form, limits),
                      depth_preference(ny, nx), form=form),
        flow_rounds(ny, nx, slots, axis))


def flow_rounds(ny: int, nx: int, slots: int | None, axis: int = 0) -> int:
    """Rounds of :data:`FLOW_DEPTH` steps a launch of the depth kernel
    over an ny x nx lattice in forcing mode ``axis`` on a card of
    ``slots`` resident blocks (None: off the card, one): :data:`FLOW_STEPS`
    steps a launch where a one-round launch is shorter than the mode's
    :data:`FLOW_MAX_WAVES` waves of the slots, else one. A rule on the
    launch's shape; no pin."""
    if (not slots or n_tiles(ny, nx, FLOW_DEPTH)
            >= FLOW_MAX_WAVES[axis] * slots):
        return 1
    return FLOW_STEPS // FLOW_DEPTH


def flow_segments(parts: list[Segment], rounds: int) -> list[Segment]:
    """``parts`` with each depth segment at :data:`FLOW_DEPTH` run
    ``rounds`` rounds a launch: its whole launches of ``rounds`` rounds,
    then the rest as one launch of fewer (one round: the one-round
    kernel). Every other segment, and all of them where ``rounds`` is 1,
    as they are; the steps still sum to the run."""
    if rounds == 1:
        return parts
    out = []
    for seg in parts:
        if seg.kernel != "depth" or seg.steps_per_call != FLOW_DEPTH:
            out.append(seg)
            continue
        spc = FLOW_DEPTH * rounds
        main, rest = seg.steps - seg.steps % spc, seg.steps % spc
        if main:
            out.append(Segment("depth", spc, main, rounds=rounds))
        if rest:
            out.append(Segment("depth", rest, rest,
                               rounds=rest // FLOW_DEPTH))
    return out


def plan_segments(iters: int, gprefs, depths, many: str = "resident",
                  form: str | None = None) -> list[Segment]:
    """:func:`segments` for given G preferences and depths; ``form``
    rides on the G-step (``many``) segments."""

    def seg(n):
        kernel, spc = choose(n, gprefs, depths, many)
        return Segment(kernel, spc, n, form if kernel == many else None)

    if iters < 1:
        raise ValueError(f"iteration count must be positive, got {iters}")
    parts = []
    remaining = iters
    while remaining > 0:
        main, tail = split(remaining, gprefs, depths)
        if not tail:
            break
        parts.append(seg(main))
        remaining = tail
    if remaining > 0:
        parts.append(seg(remaining))
    return parts


def describe(parts: list[Segment]) -> str:
    return ", ".join(seg.describe() for seg in parts)
