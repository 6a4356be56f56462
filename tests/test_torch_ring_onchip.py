"""The on-chip ring (``csrc/ring_onchip.cu``) on the CPU: its strip
schedule in plain PyTorch (``resident_ring.ring_onchip_emulated``: each
shard's rows in strips, the strips of all shards one ring, seam rows
through the slots of the neighbouring shard's edge strip, forcing by
global row; in two buffers, or in one updated in place in waves with the
carry), its planner (``ring_form``) and its wrapper's CPU path.

- The emulation in both modes against the ring's plain version, bit for
  bit on cells, over two calls (small waves stand in for the kernel's
  1024 threads, so that waves split rows and span them), and one buffer
  against two, bit for bit on cells and tots.
- The emulation against the JAX package's ``RingShardImpl``
  (``LBM_SHARD_RESIDENT=1``, the Pallas TPU interpreter on the 8 virtual
  CPU devices, 4 steps at G=4 from one perturbed state: the interpreter
  is slow) with
  ``LBM_RESIDENT_INPLACE=1`` (its in-place mode) and ``=0``: 2 and 4
  shards, one shard (the ring closes on itself), the forced row on a
  shard edge, column mode. Tolerances: cells rtol 2e-5 / atol 5e-8,
  av_vels rtol 1e-4 (tests/test_torch_ring.py's; the JAX kernel sums
  its tots in its own order).
- The planner: the strips' bytes and forms on the H100's limits, the
  pins (a pinned mode that does not fit raises), and the in-place pin
  reaching the planned path.
- A resume across modes, and three faults the emulation must catch: a
  dropped carry row, an unforced sent row, a stale slot.
"""

import functools

import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.params import Params as JParams
from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.parallel import resident_ring as jring
from lbm_tpu.runner import run_simulation as jrun
from lbm_tpu.runner import save_checkpoint as jsave
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import plan, resident
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp, halo, resident_ring
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL, ATOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4
PLAN_ENV = ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_RESIDENT", "LBM_RESIDENT_INPLACE", "LBM_RESIDENT_FORM")
# The H100's SMs and the shared memory a block may opt in to.
H100 = (132, 232448)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)


def _params(nx, ny, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _mask(nx, ny, seed, on_line=True):
    mask = generate_obstacles(nx, ny)
    rng = np.random.default_rng(seed)
    mask |= rng.random((ny, nx)) < 0.05
    if on_line:
        mask[ny - 2, :] |= rng.random(nx) < 0.3
        mask[ny - 2, 5] = False
    return mask


def _perturbed(p, seed):
    """A perturbed physical state of ``p``'s lattice, the forced line
    failing the guard in places."""
    rng = np.random.default_rng(seed)
    eq = initial_state(p).numpy()
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    c[6, p.ny - 2][rng.random(p.nx) < 0.3] = np.float32(p.accel_w2)
    return c


def _sets(nx, ny, n, steps, axis=0, copies=2, seed=5):
    """``copies`` CPU shard sets of one perturbed state (:func:`_perturbed`)
    over ``n`` shards, for ``steps`` steps; ``axis`` 1 the x-plan's column
    blocks."""
    p = _params(nx, ny, steps)
    mesh = decomp.make_mesh(n, devices=[CPU] * n)
    cells, mask = torch.from_numpy(_perturbed(p, seed)), _mask(nx, ny, seed)
    return [halo.ShardSet(p, cells, mask, mesh, steps, axis)
            for _ in range(copies)]


def _plain(ss, g, t=0):
    resident_ring.RingShardImpl(ss, g)._run_plain(t)


# (physical nx, ny, shards, axis, strips a shard, wave): uneven strips
# whose waves split rows (2 and 4 shards), one shard (its top strip's
# north neighbour is its own strip 0), strips of one row (2 rows a shard;
# the forced row 14 is shard 7's row 0, a shard edge), strips of two rows
# (the carry R alone), and column mode (the x-plan: column ny-2 of every
# shard forced, crossing every strip).
CASES = {
    "2-shards": (24, 40, 2, 0, 3, 16),
    "4-shards": (20, 64, 4, 0, 3, 12),
    "one-shard": (24, 30, 1, 0, 4, 20),
    "forced-row-on-a-shard-edge-1-row-strips": (16, 16, 8, 0, 2, 8),
    "forced-row-on-a-shard-edge-2-row-strips": (16, 16, 8, 0, 1, 8),
    "columns": (64, 16, 4, 1, 3, 10),
}


@pytest.mark.parametrize("buffers", [2, 1], ids=["two-buffers", "one-buffer"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_is_the_plain_ring_bit_for_bit(case, buffers):
    """Two calls of G=4 (the slots' parity goes on from the first call)
    against 8 plain steps: every bit of the cells, tots to rtol 1e-5."""
    nx, ny, n, axis, blocks, wave = CASES[case]
    emu, plain = _sets(nx, ny, n, 8, axis)
    for t in (0, 4):
        resident_ring.ring_onchip_emulated(emu, 4, buffers, blocks, wave, t)
        _plain(plain, 4, t)
    assert torch.equal(emu.gather(), plain.gather())
    np.testing.assert_allclose(emu.av_vels(1.0).numpy(),
                               plain.av_vels(1.0).numpy(), rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_one_buffer_is_two_buffers_bit_for_bit(case):
    """The same cells in the same order and each strip summed the same
    way: cells and every shard's tots, bit for bit."""
    nx, ny, n, axis, blocks, wave = CASES[case]
    one, two = _sets(nx, ny, n, 6, axis)
    resident_ring.ring_onchip_emulated(one, 6, 1, blocks, wave)
    resident_ring.ring_onchip_emulated(two, 6, 2, blocks, wave)
    assert torch.equal(one.gather(), two.gather())
    for a, b in zip(one.shards, two.shards):
        assert torch.equal(a.tots, b.tots)


def test_cpu_wrapper_runs_the_plain_ring():
    """On CPU tensors either mode of the wrapper is the plain ring."""
    ring_sets = _sets(24, 40, 2, 4, copies=3)
    resident_ring.RingOnchipImpl(ring_sets[0], 4, "onchip").run(0)
    resident_ring.RingOnchipImpl(ring_sets[1], 4, "inplace").run(0)
    _plain(ring_sets[2], 4)
    want = ring_sets[2].gather()
    for ss in ring_sets[:2]:
        assert torch.equal(ss.gather(), want)
        assert torch.equal(ss.av_vels(1.0), ring_sets[2].av_vels(1.0))
    with pytest.raises(ValueError, match="forms"):
        resident_ring.RingOnchipImpl(ring_sets[0], 4, "device")
    with pytest.raises(ValueError, match="even"):
        resident_ring.RingOnchipImpl(ring_sets[0], 5, "inplace")
    with pytest.raises(ValueError, match="strips"):
        resident_ring.ring_onchip_emulated(ring_sets[0], 4, 1, 21)


# --------------------------------------------------------------------------
# Against the JAX package's ring in the Pallas TPU interpreter.
# --------------------------------------------------------------------------

# (physical nx, ny, shards, LBM_RESIDENT_INPLACE, x-plan, strips a shard,
# wave): 2 shards of 16 rows (JAX: two row blocks a shard), 4 shards of 16
# in two buffers, one shard, 8 shards of 2 rows (the forced row 14 on
# shard 7's edge, obstacles on it; the strip of two rows carries R), and
# the x-plan of 128x16 (4 shards of 32 columns, JAX's transposed ring,
# column 14 forced).
JAX_CASES = {
    "2-shards-in-place": (32, 32, 2, "1", False, 3, 24),
    "4-shards-two-buffers": (32, 64, 4, "0", False, 3, 24),
    "one-shard-in-place": (32, 32, 1, "1", False, 4, 40),
    "forced-row-on-a-shard-edge-in-place": (16, 16, 8, "1", False, 1, 12),
    "columns-in-place": (128, 16, 4, "1", True, 3, 20),
}


def _jax_ring(nx, ny, n, inplace, start):
    """The JAX package's ring (``LBM_SHARD_RESIDENT=1``, G=4,
    ``LBM_RESIDENT_INPLACE=inplace``) for 4 steps over ``n`` shards from
    the step-0 checkpoint ``start``: ``(cells, av_vels)``."""
    mask = _mask(nx, ny, nx + ny)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LBM_SHARD_RESIDENT", "1")
        mp.setenv("LBM_RESIDENT_STEPS", "4")
        mp.setenv("LBM_RESIDENT_INPLACE", inplace)
        jp = JParams(nx=nx, ny=ny, max_iters=4, reynolds_dim=10, density=0.1,
                     accel=0.005, omega=1.85)
        jmesh = jdecomp.make_mesh(n)
        assert jring.ring_planned(jp, jmesh, 4)
        want = jrun(jp, mask, kernel="pallas", mesh=jmesh, resume_from=start)
    return want.cells, want.av_vels


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_emulation_matches_jax_ring(case, monkeypatch, tmp_path):
    """The emulation in the pinned mode through the planned shard set
    (JAX's layout rule patched in, as tests/test_torch_wide_sharded.py
    does, for the small x-plan), and JAX's ring, from one perturbed state:
    a step-0 checkpoint that both packages resume."""
    nx, ny, n, inplace, cols, blocks, wave = JAX_CASES[case]
    monkeypatch.setattr(plan, "transposed_layout", pf._transposed_layout)
    p, mask = _params(nx, ny, 4), _mask(nx, ny, nx + ny)
    start = _perturbed(p, nx * ny + n)
    ck = tmp_path / "start.npz"
    jsave(ck, 0, start, np.zeros(0, np.float32))
    mesh = decomp.make_mesh(n, devices=[CPU] * n)
    sp = halo.plan_run(p, mask, mesh, "cuda", 4)
    assert sp.transposed == cols and sp.pad == 0
    sim = halo.ShardedSimulation(sp.params, torch.from_numpy(start),
                                 sp.obstacles, mesh, sp.kernel, 4)
    resident_ring.ring_onchip_emulated(sim.ss, 4, 1 if inplace == "1" else 2,
                                       blocks, wave)
    cells, av = (x.numpy() for x in sim.result())
    want_cells, want_av = _jax_ring(nx, ny, n, inplace, ck)
    np.testing.assert_allclose(cells, want_cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av, want_av, rtol=TRAJ_RTOL)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu",
                                  resume_from=ck)
    if not cols:
        np.testing.assert_array_equal(cells, base.cells)


# --------------------------------------------------------------------------
# The planner.
# --------------------------------------------------------------------------

# (shard rows, lanes, two-buffer bytes, one-buffer bytes, auto's form) of
# 4 shards on one H100 (33 strips a shard): the row plan of 256x256,
# 512x512, 640x512, 768x768 and 1024x1024, the x-plan of 1024x512.
FORM_TABLE = [(64, 256, 37648, 22304, "onchip"),
              (128, 512, 149776, 88352, "onchip"),
              (128, 640, 187152, 110368, "onchip"),
              (192, 768, 336656, 189216, "inplace"),
              (256, 512, 299280, 164128, "inplace"),
              (256, 1024, 598288, 327968, "device")]


@pytest.mark.parametrize("rows,lanes,two,one,form", FORM_TABLE)
def test_ring_form_on_the_h100(rows, lanes, two, one, form):
    blocks = resident_ring.ring_blocks(rows, 4, H100[0])
    assert blocks == 33
    assert plan.onchip_smem_bytes(rows, lanes, blocks, 2) == two
    assert plan.onchip_smem_bytes(rows, lanes, blocks, 1) == one
    assert resident_ring.ring_form(rows, lanes, 4, *H100) == form


def test_ring_form_takes_one_row_strips_only_in_two_buffers():
    """Shards thinner than their share of blocks get one-row strips: two
    buffers where they fit, never one buffer under auto
    (plan.INPLACE_MIN_ROWS), else the device ring."""
    assert resident_ring.ring_blocks(32, 4, 132) == 32
    assert resident_ring.ring_blocks(2, 8, 132) == 2
    assert resident_ring.ring_blocks(500, 200, 132) == 1
    assert resident_ring.ring_form(32, 128, 4, *H100) == "onchip"
    # 33 one-row strips of 4096 lanes: two buffers need 299280 B, one
    # buffer's rows are too short for auto.
    assert resident_ring.ring_form(33, 4096, 4, *H100) == "device"


def test_ring_form_pins(monkeypatch):
    form = functools.partial(resident_ring.ring_form, sms=H100[0],
                             smem_per_block=H100[1], shards_on_card=4)
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    assert form(64, 256) == form(192, 768) == "inplace"
    with pytest.raises(ValueError, match="single-buffer mode .pinned."):
        form(256, 1024)
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "0")
    assert form(64, 256) == "onchip"
    with pytest.raises(ValueError, match="two-buffer mode .pinned. needs "
                                         "336656 B"):
        form(192, 768)
    monkeypatch.delenv("LBM_RESIDENT_INPLACE")
    monkeypatch.setenv("LBM_RESIDENT_FORM", "onchip")
    assert form(64, 256) == "onchip"
    with pytest.raises(ValueError, match="two-buffer"):
        form(192, 768)
    monkeypatch.setenv("LBM_RESIDENT_FORM", "device")
    assert form(64, 256) == form(256, 1024) == "device"
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    with pytest.raises(ValueError, match="no single-buffer mode"):
        form(64, 256)


def _h100_planner(monkeypatch):
    """Plan the ring's form on the CPU mesh as on one H100."""
    def planned(h, lanes, mesh):
        return resident_ring.ring_form(h, lanes, mesh.size, *H100)

    monkeypatch.setattr(resident_ring, "planned_ring_form", planned)


def test_the_in_place_pin_reaches_the_planned_path(monkeypatch):
    """LBM_RESIDENT_INPLACE is read under LBM_SHARD_RESIDENT=1: the plan
    names the mode, the simulation builds the on-chip ring in it (on CPU
    tensors its plain version runs) and off the card no form is
    planned."""
    p, mask = _params(32, 64, 23), generate_obstacles(32, 64)
    mesh = decomp.make_mesh(4, devices=[CPU] * 4)
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    assert plan.describe(halo.plan_run(p, mask, mesh, "cuda", 23).segments) \
        == "ring G=20 x1, depth D=2 x1, step x1"
    assert resident_ring.planned_ring_form(16, 32, mesh) is None
    _h100_planner(monkeypatch)
    want = {None: "ring G=20 on-chip x1", "1": "ring G=20 on-chip 1-buf x1",
            "0": "ring G=20 on-chip x1"}
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    for pin, describe in want.items():
        if pin is not None:
            monkeypatch.setenv("LBM_RESIDENT_INPLACE", pin)
        sp = halo.plan_run(p, mask, mesh, "cuda", 23)
        assert plan.describe(sp.segments).startswith(describe)
        assert sp.segments[0].launch_key == (
            "ring_onchip_inplace" if pin == "1" else "ring_onchip")
        sim = halo.ShardedSimulation(p, initial_state(p, CPU), mask, mesh,
                                     "cuda", 23)
        ring = sim._impls[0][0]
        assert isinstance(ring, resident_ring.RingOnchipImpl)
        assert ring.form == ("inplace" if pin == "1" else "onchip")
        sim.run()
        cells, av = sim.result()
        np.testing.assert_array_equal(cells.numpy(), base.cells)
        np.testing.assert_allclose(av.numpy(), base.av_vels, rtol=TRAJ_RTOL)
    monkeypatch.setenv("LBM_RESIDENT_FORM", "device")
    monkeypatch.delenv("LBM_RESIDENT_INPLACE")
    sp = halo.plan_run(p, mask, mesh, "cuda", 23)
    assert plan.describe(sp.segments).startswith("ring G=20 device-memory x1")
    sim = halo.ShardedSimulation(p, initial_state(p, CPU), mask, mesh, "cuda",
                                 23)
    assert isinstance(sim._impls[0][0], resident_ring.RingShardImpl)


def test_a_pinned_mode_that_does_not_fit_raises_in_the_planner(monkeypatch):
    p, mask = _params(1024, 1024, 200), generate_obstacles(1024, 1024)
    mesh = decomp.make_mesh(4, devices=[CPU] * 4)
    _h100_planner(monkeypatch)
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    assert plan.describe(halo.plan_run(p, mask, mesh, "cuda", 200).segments) \
        == "ring G=100 device-memory x2"
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    with pytest.raises(ValueError, match="single-buffer"):
        halo.plan_run(p, mask, mesh, "cuda", 200)


# --------------------------------------------------------------------------
# A resume across modes, and the faults the emulation must catch.
# --------------------------------------------------------------------------


def test_resume_across_modes(monkeypatch):
    """A two-buffer run's state resumes in one buffer (a new wrapper, its
    slots and tags from zero): the single-shot trajectory's cells. Through
    the planned path (a checkpoint's cells into a new simulation) and by
    the emulation's schedules."""
    p, mask = _params(32, 64, 16), generate_obstacles(32, 64)
    mesh = decomp.make_mesh(4, devices=[CPU] * 4)
    _h100_planner(monkeypatch)
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "8")
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "0")
    first = halo.ShardedSimulation(p, initial_state(p, CPU), mask, mesh,
                                   "cuda", 16, sizes=[8])
    assert first._plans[8][0][0].form == "onchip"
    first.run_chunk(0, 8)
    cells, av = first.result()
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    second = halo.ShardedSimulation(p, cells, mask, mesh, "cuda", 16,
                                    sizes=[8], av0=av.numpy(), start_step=8)
    assert second._plans[8][0][0].form == "inplace"
    second.run_chunk(8, 8)
    got, _ = second.result()
    np.testing.assert_array_equal(got.numpy(), base.cells)

    emu, plain = _sets(20, 64, 4, 16)
    resident_ring.ring_onchip_emulated(emu, 8, 2, 3, 12)
    resumed = halo.ShardSet(emu.params, emu.gather(), emu.mask_np, emu.mesh,
                            16)
    resident_ring.ring_onchip_emulated(resumed, 8, 1, 3, 12, t=8)
    _plain(plain, 16)
    assert torch.equal(resumed.gather(), plain.gather())


def _equal_to_plain(case, buffers, g=4):
    nx, ny, n, axis, blocks, wave = CASES[case]
    emu, plain = _sets(nx, ny, n, g, axis)
    resident_ring.ring_onchip_emulated(emu, g, buffers, blocks, wave)
    _plain(plain, g)
    return torch.equal(emu.gather(), plain.gather())


@pytest.mark.parametrize("carried", [("R",), ("T",)], ids=["drop-T", "drop-R"])
def test_emulation_catches_a_dropped_carry_row(carried, monkeypatch):
    """One buffer: a cell that an earlier wave overwrote is read only from
    the carry; without one of its rows the cells differ."""
    assert _equal_to_plain("2-shards", 1)
    monkeypatch.setattr(resident, "_CARRIED", carried)
    assert not _equal_to_plain("2-shards", 1)


@pytest.mark.parametrize("case", ["forced-row-on-a-shard-edge-1-row-strips",
                                  "columns"])
def test_emulation_catches_an_unforced_sent_row(case, monkeypatch):
    """Two buffers: the owner forces the copies it sends and the receiver
    does not force them again; a sender that skips it gives other cells
    where the forced line is on a strip's edge row (a shard edge here;
    every edge row in column mode)."""
    def unforced(row, mrow, on, w1, w2, axis, speeds):
        return row[list(speeds)]

    assert _equal_to_plain(case, 2)
    monkeypatch.setattr(resident, "_sent_row", unforced)
    assert not _equal_to_plain(case, 2)


@pytest.mark.parametrize("buffers", [2, 1], ids=["two-buffers", "one-buffer"])
def test_emulation_catches_a_stale_slot(buffers, monkeypatch):
    """A strip that reads the other slot (the rows of the step before, or
    nothing at step 0) gives other cells."""
    monkeypatch.setattr(resident, "_halo_slot", lambda step: (step + 1) % 2)
    assert not _equal_to_plain("4-shards", buffers)
