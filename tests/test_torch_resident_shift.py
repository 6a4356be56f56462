"""The resident kernel's shift mode on the CPU: the device-memory form's
offset-load mode (``LBM_RESIDENT_SHIFT``, ``csrc/resident.cu``'s
``resident_shift_kernel``), the port of ``_kernel_resident``'s
``_streamed_shifted``. Its emulation,
``lbm_tpu_torch.ops.resident.resident_shift_emulated`` (rounds of one step
on the depth kernel's tile), against the JAX package's
``_pallas_resident`` with ``LBM_RESIDENT_SHIFT=1`` in interpret mode, with
one of its row blocks and with several, as tests/test_resident.py runs it;
bit for bit against the device form's rounds and the depth plan's
emulation; the mode's CPU wrapper. The planner's pins are in
tests/test_torch_plan.py; the kernel is compared with the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: against JAX, cells rtol 1e-4 / atol 5e-8 and tots rtol 1e-4
(ROADMAP.md section 3, item 3: XLA's jit moves JAX's f32 steps by ulps);
within the port, every bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.ops.pallas_fused import AccelSpec
from lbm_tpu.ops.pallas_resident import _pallas_resident
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state, initial_state_np
from lbm_tpu_torch.ops import fused, fused_depth, resident
from lbm_tpu_torch.ops import reference as ref_ops

torch.set_num_threads(2)

ONCHIP_RTOL, ATOL = 1e-4, 5e-8
MODES = {
    "paired": {},
    "reference_order": {"LBM_PAIRED_EQ": "0"},
    "omega_absorbed": {"LBM_OMEGA_EQ": "1"},
}


def _params(ny, nx, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


@pytest.mark.parametrize("blocks", ["single-block", "multiblock"])
def test_shift_emulation_matches_jax_shift_mode(blocks, monkeypatch):
    """From rest on 48x64 with the generator's walls, 4 steps: JAX's
    kernel with the shift mode on (offset loads; one row block of 48 rows
    or blocks of 8, whose windows stitch the periodic wrap) against the
    emulation."""
    p = _params(48, 64, 4)
    if blocks == "multiblock":
        monkeypatch.setattr(pf, "_SLOT_BYTES", 8 * 9 * p.nx * 4)
    assert pf._pick_block_rows(p.ny, p.nx) == (8 if blocks == "multiblock"
                                               else p.ny)
    mask = generate_obstacles(p.nx, p.ny)
    monkeypatch.setenv("LBM_RESIDENT_SHIFT", "1")
    monkeypatch.delenv("LBM_RESIDENT_INPLACE", raising=False)
    want, want_tots = _pallas_resident(
        initial_state(p), jnp.asarray(mask).astype(jnp.int8),
        omega_f=float(p.omega), interpret=True,
        accel=AccelSpec.rows(p, p.ny), gsteps=4)
    got, tots = resident.resident_shift_emulated(
        torch.from_numpy(initial_state_np(p)), torch.from_numpy(mask),
        p.accel_w1, p.accel_w2, p.omega, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ONCHIP_RTOL, atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), np.asarray(want_tots),
                               rtol=ONCHIP_RTOL)


def _perturbed(kind, seed):
    """A perturbed state on a ragged 50x70 lattice (24 and 32 divide
    neither side) and its mask, ``kind`` "walls" or "wall-less" (random
    obstacles, periodic both ways); the forced row fails the guard in
    places (speed 6 at its weight)."""
    p = _params(50, 70, 16)
    rng = np.random.default_rng(seed)
    eq = initial_state_np(p)
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    c[6, p.ny - 2][rng.random(p.nx) < 0.3] = np.float32(p.accel_w2)
    mask = (generate_obstacles(p.nx, p.ny) if kind == "walls"
            else rng.random((p.ny, p.nx)) < 0.15)
    return p, torch.from_numpy(c), torch.from_numpy(mask)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["walls", "wall-less"])
@pytest.mark.parametrize("g", [2, 4, 16])
def test_shift_emulation_has_the_device_forms_and_the_depth_plans_bits(
        g, kind, mode, monkeypatch):
    """G rounds of one step give every bit of the device form's rounds
    (rounds of 4 and 2) and of the depth plan (G / D launches, D = 4 where
    it divides G, else 2), cells and each step's tot, in every BGK
    association; and the plain version's cells."""
    for name in ("LBM_PAIRED_EQ", "LBM_OMEGA_EQ"):
        monkeypatch.delenv(name, raising=False)
    for name, value in MODES[mode].items():
        monkeypatch.setenv(name, value)
    p, c0, mask = _perturbed(kind, seed=g + len(mode))
    w = (mask, p.accel_w1, p.accel_w2, p.omega)
    got, tots = resident.resident_shift_emulated(c0, *w, g)
    dev, dev_tots = resident.resident_device_emulated(c0, *w, g)
    assert torch.equal(got, dev)
    assert torch.equal(tots, dev_tots)
    d = 4 if g % 4 == 0 else 2
    c, want_tots = c0, []
    for _ in range(g // d):
        c, t = fused_depth.fused_depth_emulated(c, *w, d)
        want_tots.append(t)
    assert torch.equal(got, c)
    assert torch.equal(tots, torch.cat(want_tots))
    want, _ = ref_ops.multi_step(c0, *w, g)
    assert torch.equal(got, want)


@pytest.mark.parametrize("gsteps", [2, 6])
def test_cpu_wrapper_of_the_shift_mode_runs_the_plain_version(gsteps):
    """On CPU tensors the mode's wrapper runs ``resident_plain``: its cells
    land in the first buffer (G even), out[t:t+G] gets the scaled tots,
    and nothing launches."""
    p, c0, mask = _perturbed("walls", seed=gsteps)
    w = (mask, p.accel_w1, p.accel_w2, p.omega)
    kernel = resident.Resident(*w, gsteps, form="shift")
    assert kernel.form == "shift" and kernel.steps_per_call == gsteps
    a, b = c0.clone(), torch.empty_like(c0)
    av = torch.full((gsteps + 3,), -1.0)
    before = dict(fused.LAUNCHES)
    new, spare = kernel.run(a, b, av, 1, 0.5)
    assert (new, spare) == (a, b)
    want, want_tots = resident.resident_plain(c0, *w, gsteps)
    assert torch.equal(new, want)
    assert torch.equal(av[1:1 + gsteps], want_tots * 0.5)
    assert av[0] == -1 and (av[1 + gsteps:] == -1).all()
    assert fused.LAUNCHES == before, "no kernel launches on the CPU"
    got, tots = resident.resident(c0, *w, gsteps, form="shift")
    assert torch.equal(got, want) and torch.equal(tots, want_tots)


def test_shift_mode_has_no_column_mode():
    """As in JAX, the mode runs in row layout only: the wrapper refuses
    column mode."""
    mask = torch.from_numpy(generate_obstacles(16, 8))
    with pytest.raises(ValueError, match="row mode"):
        resident.Resident(mask, 1e-5, 1e-6, 1.85, 4, axis=1, form="shift")
    resident.Resident(mask, 1e-5, 1e-6, 1.85, 4, axis=1, form="device")


# The redesigned schedule: each block owns whole depth tiles for the
# launch (plan.shift_rects) and waits only on its neighbours' step
# counters (csrc/lbm_rounds.cuh's shift_block).

OWNERSHIP = [((64, 4096), 132), ((32, 8192), 132), ((256, 256), 132),
             ((1024, 1024), 132), ((1024, 1024), 264), ((64, 4096), 264),
             ((37, 99), 7), ((36, 100), 7), ((50, 70), 7), ((25, 33), 7),
             ((256, 256), 7), ((1024, 1024), 7), ((49, 161), 3)]


@pytest.mark.parametrize("shape,blocks", OWNERSHIP,
                         ids=[f"{s[1]}x{s[0]}-{b}" for s, b in OWNERSHIP])
def test_every_tile_is_owned_once_and_whole(shape, blocks):
    """Over at most ``blocks`` blocks every depth tile of the lattice lies
    in exactly one block's rectangle, and the blocks' cell counts differ
    by at most one tile column (32 lanes at full height)."""
    from lbm_tpu_torch.ops import plan

    ny, nx = shape
    ty, tx = plan.SHIFT_TILE
    rects = plan.shift_rects(ny, nx, blocks)
    assert 1 <= len(rects) <= blocks
    owner = np.full((ny, nx), -1)
    for b, (y0, y1, x0, x1) in enumerate(rects):
        assert y0 % ty == 0 and x0 % tx == 0
        assert y1 == ny or y1 % ty == 0
        assert x1 == nx or x1 % tx == 0
        assert (owner[y0:y1, x0:x1] == -1).all(), "a cell owned twice"
        owner[y0:y1, x0:x1] = b
    assert (owner >= 0).all(), "a cell owned by none"
    cells = [(y1 - y0) * (x1 - x0) for y0, y1, x0, x1 in rects]
    assert max(cells) - min(cells) <= tx * ny


def test_narrow_channels_own_full_height_slabs():
    """At the narrow channels on an H100's 132 SMs each block owns a slab
    of whole tile columns at full height: 4096x64 128 of 32 x 64 cells,
    8192x32 132 of one or two tile columns (at most 64 x 32), in which the
    y wrap and the forced row are internal; both, and 256x256, keep their
    cells in shared memory, 1024x1024 and the physical 4100x100 (blocks
    too large) in device memory."""
    from lbm_tpu_torch.ops import plan

    h100 = (132, 232448)
    slabs = plan.shift_rects(64, 4096, 132)
    assert len(slabs) == 128 and plan.shift_groups(64, 4096, 132) == (128, 1)
    assert all((y0, y1, x1 - x0) == (0, 64, 32) for y0, y1, x0, x1 in slabs)
    slabs = plan.shift_rects(32, 8192, 132)
    assert len(slabs) == 132 and plan.shift_groups(32, 8192, 132) == (132, 1)
    widths = sorted(x1 - x0 for _, _, x0, x1 in slabs)
    assert widths == [32] * 8 + [64] * 124
    assert all((y0, y1) == (0, 32) for y0, y1, _, _ in slabs)
    for ny, nx, want in [(64, 4096, "shared"), (32, 8192, "shared"),
                         (256, 256, "shared"), (1024, 1024, "device"),
                         (100, 4100, "device")]:
        assert plan.shift_residence(ny, nx, h100[0], h100[1]) == want
    assert plan.shift_smem_bytes(64, 4096, 132) <= h100[1] - \
        plan.SHIFT_STATIC_BYTES


def _case_48x64():
    p = _params(48, 64, 4)
    return p, torch.from_numpy(initial_state_np(p)), torch.from_numpy(
        generate_obstacles(p.nx, p.ny))


@pytest.mark.parametrize("blocks", [1, 2, 7, 132])
def test_shift_schedule_matches_jax_shift_mode(blocks, monkeypatch):
    """From rest on 48x64 with the generator's walls, 4 steps: JAX's
    kernel with the shift mode on (as test_shift_emulation_matches_jax_
    shift_mode runs it, one row block) against the schedule's emulation
    over 1, 2, 7 and 132 blocks: one block, two full-height slabs, and
    2 x 2 blocks of one tile each (rows, columns and corners from
    neighbours)."""
    p, c0, mask = _case_48x64()
    monkeypatch.setenv("LBM_RESIDENT_SHIFT", "1")
    monkeypatch.delenv("LBM_RESIDENT_INPLACE", raising=False)
    want, want_tots = _pallas_resident(
        initial_state(p), jnp.asarray(mask.numpy()).astype(jnp.int8),
        omega_f=float(p.omega), interpret=True,
        accel=AccelSpec.rows(p, p.ny), gsteps=4)
    got, tots = resident.shift_schedule_emulated(
        c0, mask, p.accel_w1, p.accel_w2, p.omega, 4, blocks, seed=blocks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ONCHIP_RTOL, atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), np.asarray(want_tots),
                               rtol=ONCHIP_RTOL)


@pytest.mark.parametrize("kind", ["walls", "wall-less"])
@pytest.mark.parametrize("blocks,seed", [(2, 0), (3, 1), (7, 2), (7, 3),
                                         (12, 4), (132, 5)])
def test_shift_schedule_has_the_device_forms_bits_in_any_order(
        blocks, seed, kind):
    """The schedule's emulation on the ragged 50x70 lattice, 6 steps, its
    blocks advanced in a seeded adversarial order that only the counters
    constrain, the stale parity poisoned: every bit of the device form's
    rounds (cells and each step's tot) and the plain version's cells."""
    p, c0, mask = _perturbed(kind, seed=seed)
    w = (mask, p.accel_w1, p.accel_w2, p.omega)
    got, tots = resident.shift_schedule_emulated(c0, *w, 6, blocks,
                                                 seed=seed)
    dev, dev_tots = resident.resident_device_emulated(c0, *w, 6)
    assert torch.equal(got, dev)
    assert torch.equal(tots, dev_tots)
    want, _ = ref_ops.multi_step(c0, *w, 6)
    assert torch.equal(got, want)


def test_shift_schedule_of_one_tile_column_cut_into_row_groups():
    """A lattice one tile column wide (30 lanes) over 3 blocks: one column
    group cut into three row groups, whose rows take the ring's corners
    and wrap in x inside each block; every bit of the device form's."""
    p = _params(70, 30, 6)
    rng = np.random.default_rng(7)
    eq = initial_state_np(p)
    c0 = torch.from_numpy(
        (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32))
    mask = torch.from_numpy(rng.random((p.ny, p.nx)) < 0.15)
    w = (mask, p.accel_w1, p.accel_w2, p.omega)
    assert resident.plan.shift_groups(p.ny, p.nx, 3) == (1, 3)
    got, tots = resident.shift_schedule_emulated(c0, *w, 6, 3, seed=7)
    dev, dev_tots = resident.resident_device_emulated(c0, *w, 6)
    assert torch.equal(got, dev) and torch.equal(tots, dev_tots)


@pytest.mark.parametrize("blocks", [2, 7, 12])
def test_a_ring_filled_before_its_wait_fails(blocks):
    """The mutant that fills its ring before waiting for the owner's step
    counter runs ahead of its neighbours and reads a slot that does not
    hold its step: the emulation refuses the drift, and without that check
    the poisoned slot shows in the cells."""
    p, c0, mask = _perturbed("walls", seed=blocks)
    w = (mask, p.accel_w1, p.accel_w2, p.omega)
    with pytest.raises(resident.ShiftHazard):
        resident.shift_schedule_emulated(c0, *w, 6, blocks, seed=0,
                                         ring_before_wait=True)
    got, _ = resident.shift_schedule_emulated(
        c0, *w, 6, blocks, seed=0, ring_before_wait=True, check_drift=False)
    want, _ = ref_ops.multi_step(c0, *w, 6)
    assert torch.isnan(got).any() and not torch.equal(got, want)


def test_residence_is_the_shift_modes_alone():
    """A residence is asked of the shift mode only, and by its name."""
    mask = torch.from_numpy(generate_obstacles(16, 8))
    with pytest.raises(ValueError, match="residence"):
        resident.Resident(mask, 1e-5, 1e-6, 1.85, 4, form="device",
                          residence="shared")
    with pytest.raises(ValueError, match="residence"):
        resident.Resident(mask, 1e-5, 1e-6, 1.85, 4, form="shift",
                          residence="l2")
    k = resident.Resident(mask, 1e-5, 1e-6, 1.85, 4, form="shift",
                          residence="device")
    assert k.form == "shift"
