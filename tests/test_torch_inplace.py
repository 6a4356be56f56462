"""The on-chip resident form's single-buffer mode (csrc/resident_onchip.cu
with one buffer; ``ops.resident.resident_onchip_emulated(buffers=1)``) on
the CPU: the emulation of its in-place schedule, one strip tensor updated
wave by wave, each wave's stores landing only once the waves that pull
its cells have gathered (the latest the kernel may land them), the x
wrap's far pulls and the edge rows' pulls of overwritten rows served from
carried values, against the plain version (``multi_step``) bit for bit,
against the two-buffer mode's emulation bit for bit (cells and tots), and
against the JAX package's ``_kernel_resident`` in its in-place mode
(``LBM_RESIDENT_INPLACE=1``, ``ResidentStep`` in interpret mode, as
tests/test_resident.py runs it). Small waves stand in for the kernel's
1024 threads, so that waves split rows and span them at these widths. The
emulation's poisoned mode fails on any pull of a cell whose store has
landed: run at rows narrower than a wave, a wave wide and wider, it is
the proof that the deferral reaches far enough.

Tolerances: cells bit for bit and tots rtol 1e-5 against ``multi_step``
(the strips sum tot_u in another order); against JAX, rtol 1e-4 and
atol 5e-8 on cells and rtol 1e-4 on tots (tests/test_torch_resident.py's
ONCHIP_RTOL and ATOL; ROADMAP.md section 3, item 3: XLA's jit moves
JAX's f32 steps by ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.ops.pallas_resident import ResidentStep, TransposedResidentStep
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.ops import resident
from lbm_tpu_torch.state import transpose_state

torch.set_num_threads(2)

ONCHIP_RTOL, ATOL = 1e-4, 5e-8

# (ny, nx, blocks, gsteps, wave, obstacles on the forced line, axis):
# physical NXxNY is nx columns by ny rows; axis 1 runs the transposed
# lattice (nx rows of ny lanes), as a wide grid does.
CASES = {
    # The 4096x64 shape at small width: a row a strip, each row split
    # over three waves (96, 96, 64 cells), as 4096 over four of 1024.
    "one-row-strips": (8, 256, 8, 4, 96, False, 0),
    # Strips of two rows, rows wider than a wave: row h-1 pulls row 0 from
    # the buffer, its stores three waves deferred, and the x wrap's speed
    # 6 from its slot.
    "two-row-strips": (16, 40, 8, 4, 24, False, 0),
    # Strips of 8 and 7 rows, waves wider than a row (they span rows),
    # an odd G.
    "multi-row-strips-odd-g": (30, 24, 4, 5, 40, False, 0),
    # Rows of 50 over waves of 32: every row crosses a wave boundary and
    # is wider than a wave (stores three waves deferred).
    "wave-splits-rows": (24, 50, 3, 3, 32, False, 0),
    # Strips of 2 rows: row 14 = ny-2 starts the last strip, so the forced
    # row is a strip edge and a halo row, with obstacles in it; G odd.
    "forced-row-on-a-strip-edge": (16, 20, 8, 5, 16, True, 0),
    # One block: it is its own north and south neighbour.
    "one-block": (10, 16, 1, 4, 12, False, 0),
    # The kernel's own wave of 1024 cells.
    "kernel-wave": (12, 64, 3, 4, resident.THREADS, False, 0),
    # Column mode: 64 rows of 16 lanes over 7 uneven strips, the forced
    # column 14 crossing every strip, obstacles on it.
    "columns": (16, 64, 7, 4, 20, True, 1),
    "columns-odd-g": (16, 40, 3, 3, 13, True, 1),
}


def _params(ny, nx, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _mask(ny, nx, obstacles_on_line, rng):
    mask = generate_obstacles(nx, ny)
    mask |= rng.random((ny, nx)) < 0.1
    if obstacles_on_line:
        mask[ny - 2, :] |= rng.random(nx) < 0.3
    return mask


def _case(name):
    """The case's params, its perturbed state (the forced line failing the
    guard in places) and mask in the execution layout, and the run's
    arguments."""
    ny, nx, blocks, gsteps, wave, on_line, axis = CASES[name]
    p = _params(ny, nx, gsteps)
    rng = np.random.default_rng(ny * nx + blocks)
    eq = initial_state_np(p)
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    c[6, ny - 2][rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    cells = torch.from_numpy(c)
    mask = torch.from_numpy(_mask(ny, nx, on_line, rng))
    if axis:
        cells, mask = transpose_state(cells), mask.T.contiguous()
    return p, cells, mask, (blocks, gsteps, wave, axis)


@pytest.mark.parametrize("name", list(CASES))
def test_single_buffer_emulation_is_multi_step_bit_for_bit(name):
    """Every bit of the plain version's cells, tots to rtol 1e-5."""
    p, cells, mask, (blocks, g, wave, axis) = _case(name)
    args = (mask, p.accel_w1, p.accel_w2, p.omega, g)
    want, want_tots = ref_ops.multi_step(cells, *args, axis)
    got, tots = resident.resident_onchip_emulated(
        cells, *args, blocks, axis=axis, buffers=1, wave=wave)
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.numpy(), want_tots.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_single_buffer_emulation_equals_the_two_buffer_one(name):
    """The single-buffer mode updates the same cells with the same
    arithmetic and sums each strip the same way: cells and tots of the
    two-buffer emulation, bit for bit."""
    p, cells, mask, (blocks, g, wave, axis) = _case(name)
    args = (mask, p.accel_w1, p.accel_w2, p.omega, g, blocks)
    one, one_tots = resident.resident_onchip_emulated(
        cells, *args, axis=axis, buffers=1, wave=wave)
    two, two_tots = resident.resident_onchip_emulated(cells, *args,
                                                      axis=axis)
    assert torch.equal(one, two)
    assert torch.equal(one_tots, two_tots)


@pytest.mark.parametrize("name", list(CASES))
def test_single_buffer_emulation_matches_jax_in_place(name, monkeypatch):
    """The same schedules from the same perturbed state against the JAX
    package's in-place mode (``LBM_RESIDENT_INPLACE=1``;
    ``TransposedResidentStep`` in column mode), one JAX call of G steps,
    odd G included."""
    p, cells, mask, (blocks, g, wave, axis) = _case(name)
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    # Row blocks of 8 rows where they divide the lattice, as
    # tests/test_resident.py forces several in its in-place case.
    rows, lanes = mask.shape
    if rows % 8 == 0:
        monkeypatch.setattr(pf, "_SLOT_BYTES", 8 * 9 * lanes * 4)
    # JAX takes the physical layout and transposes it itself.
    phys, phys_mask = ((transpose_state(cells), mask.T) if axis
                       else (cells, mask))
    impl = (TransposedResidentStep if axis else ResidentStep)(p, g)
    prepared = impl.prepare(jnp.asarray(phys_mask.numpy()))
    carry, want_tots = impl.step(
        impl.init(jnp.asarray(phys.numpy()), prepared), prepared)
    want = np.asarray(impl.final(carry))
    got, tots = resident.resident_onchip_emulated(
        cells, mask, p.accel_w1, p.accel_w2, p.omega, g, blocks, axis=axis,
        buffers=1, wave=wave)
    if axis:
        got = transpose_state(got)
    np.testing.assert_allclose(got.numpy(), want, rtol=ONCHIP_RTOL, atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), np.asarray(want_tots),
                               rtol=ONCHIP_RTOL)


def test_emulation_takes_one_or_two_buffers():
    p, cells, mask, (blocks, g, wave, axis) = _case("one-block")
    with pytest.raises(ValueError, match="buffers"):
        resident.resident_onchip_emulated(cells, mask, p.accel_w1, p.accel_w2,
                                          p.omega, g, blocks, buffers=3)


# The reach of the deferral: rows narrower than a wave, one short of it, a
# wave wide (waves start at column 0), one wider and two waves and one
# wider, in strips of 2, 3 and 8 rows (no interior, one interior row, six).
WAVE = 8
HAZARD_NX = {"small": 5, "wave-1": WAVE - 1, "wave": WAVE,
             "wave+1": WAVE + 1, "2wave+1": 2 * WAVE + 1}
HAZARD_BLOCKS, HAZARD_G = 3, 3


def _hazard_case(lanes, h, axis):
    """A perturbed state of HAZARD_BLOCKS strips of ``h`` rows of
    ``lanes`` cells in the execution layout (``axis`` 1: column mode) and
    its mask, obstacles on the forced line."""
    rows = HAZARD_BLOCKS * h
    ny, nx = (rows, lanes) if axis == 0 else (lanes, rows)
    p = _params(ny, nx, HAZARD_G)
    rng = np.random.default_rng(rows * lanes + axis)
    eq = initial_state_np(p)
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    cells = torch.from_numpy(c)
    mask = torch.from_numpy(_mask(ny, nx, True, rng))
    if axis:
        cells, mask = transpose_state(cells), mask.T.contiguous()
    return p, cells, mask


@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
@pytest.mark.parametrize("h", [2, 3, 8])
@pytest.mark.parametrize("nx", list(HAZARD_NX.values()),
                         ids=list(HAZARD_NX))
def test_no_wave_pulls_a_cell_whose_store_has_landed(nx, h, axis):
    """The poisoned emulation (every cell marked once its deferred store
    lands; any pull of a marked cell, or a carried slot read in the wave
    that fills it or holding another row's value, fails) runs G steps,
    and its cells are the plain version's, bit for bit."""
    p, cells, mask = _hazard_case(nx, h, axis)
    args = (mask, p.accel_w1, p.accel_w2, p.omega, HAZARD_G)
    got, _ = resident.resident_onchip_emulated(
        cells, *args, HAZARD_BLOCKS, axis=axis, buffers=1, wave=WAVE,
        poison=True)
    want, _ = ref_ops.multi_step(cells, *args, axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nx,h,delay", [(5, 8, 0), (WAVE + 1, 8, 1)],
                         ids=["stores-at-once",
                              "one-wave-on-rows-wider-than-a-wave"])
def test_poisoned_emulation_catches_stores_that_land_too_early(
        nx, h, delay, monkeypatch):
    """The hazard test can fail: stores that land in their own wave's
    phase, and stores deferred one wave where a row is wider than a wave
    (the row above pulls speed 5 nx + 1 back), each pull a landed cell."""
    p, cells, mask = _hazard_case(nx, h, 0)
    monkeypatch.setattr(resident, "inplace_delay", lambda *a: delay)
    with pytest.raises(resident.InplaceHazard):
        resident.resident_onchip_emulated(
            cells, mask, p.accel_w1, p.accel_w2, p.omega, HAZARD_G,
            HAZARD_BLOCKS, buffers=1, wave=WAVE, poison=True)


def test_a_row_wider_than_three_waves_has_no_single_buffer_schedule():
    """Rows of two or more a strip up to 3 wave - 1 wide defer three
    waves; wider ones raise (no H100 strip of two rows is that wide)."""
    assert resident.inplace_delay(1, 10 * WAVE, WAVE) == 1
    assert resident.inplace_delay(2, WAVE, WAVE) == 1
    assert resident.inplace_delay(2, WAVE + 1, WAVE) == 3
    assert resident.inplace_delay(2, 3 * WAVE - 1, WAVE) == 3
    with pytest.raises(ValueError, match="3 waves"):
        resident.inplace_delay(2, 3 * WAVE, WAVE)

