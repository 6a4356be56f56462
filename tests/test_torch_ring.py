"""The ring (``csrc/ring.cu``'s protocol and its plain version) on the CPU.

- The ring's plain version, the path its wrapper takes on CPU tensors
  (G steps of the halo exchange and the plain seam step on every shard),
  against the JAX package's ``RingShardImpl`` (``LBM_SHARD_RESIDENT=1``,
  the Pallas TPU interpreter on the 8 virtual CPU devices), at the
  repo's bound for this kernel: rtol 2e-5 (the JAX kernel sums per-block
  tots in its own order; cells within rtol 2e-5 / atol 5e-8).
- The gating of ``LBM_SHARD_RESIDENT`` and ``LBM_RESIDENT_STEPS``.
- A model of the kernel's slot protocol: shards as Python coroutines,
  seam transfers that land in any order, a hypothesis-chosen
  interleaving. With one flag per (direction, slot) every halo read sees
  the payload of its own step; with one flag per direction shared by the
  two slots some interleaving reads a wrong step (the trap the JAX
  package measured as silent wrong trajectories, tests/test_ring.py).
  The same model in rounds of D-row payloads, each row a transfer of its
  own (``csrc/ring.cu``'s rounds).
- The kernel's round schedule (:func:`resident_ring.ring_emulated`:
  D-row slots, the pre-round send, interior tiles before the rows land
  and edge tiles after, raw halo rows forced by the receiver, column
  mode) against the ring's plain version bit for bit, against the JAX
  ring at the bound above, and two faults it must catch: halo rows left
  unforced, and a stale slot.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, find, given, settings
from hypothesis import strategies as st

from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.parallel import resident_ring as jring
from lbm_tpu.runner import run_simulation as jrun
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp, halo, resident_ring
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL, ATOL = 2e-5, 5e-8
PLAN_ENV = ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_RESIDENT_INPLACE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)


def _params(nx, ny, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _scene(nx, ny):
    mask = generate_obstacles(nx, ny)
    rng = np.random.default_rng(55)
    mask[ny - 2, :] |= rng.random(nx) < 0.3
    mask[ny - 2, 5] = False
    return _params(nx, ny, 4), mask


@functools.lru_cache(maxsize=None)
def _jax_ring(nx, ny):
    """The JAX package's ring (``LBM_SHARD_RESIDENT=1``, G=4) for 4 steps
    over 8 shards, in the Pallas TPU interpreter: ``(cells, av_vels)``."""
    from lbm_tpu.params import Params as JParams

    _, mask = _scene(nx, ny)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LBM_SHARD_RESIDENT", "1")
        mp.setenv("LBM_RESIDENT_STEPS", "4")
        jp = JParams(nx=nx, ny=ny, max_iters=4, reynolds_dim=10, density=0.1,
                     accel=0.005, omega=1.85)
        jmesh = jdecomp.make_mesh(8)
        jpad = jhalo.plan_row_padding(jp, mask, jmesh, "pallas")
        jpp = jhalo.pad_scene(jp, mask, jpad)[0] if jpad else jp
        assert jring.ring_planned(jpp, jmesh, 4)
        want = jrun(jp, mask, kernel="pallas", mesh=jmesh)
    return want.cells, want.av_vels


def _port_ring(nx, ny, emulated=False):
    """4 steps at G=4 over 8 CPU shards through the planned path: the
    ring's plain version, or ``emulated``, its kernel's round schedule.
    Returns ``(cells without the pad, av_vels)``."""
    p, mask = _scene(nx, ny)
    mesh = decomp.make_mesh(8, devices=[CPU] * 8)
    sp = halo.plan_run(p, mask, mesh, "cuda", 4)
    assert [s.describe() for s in sp.segments] == ["ring G=4 x1"]
    sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, CPU),
                                 sp.obstacles, mesh, sp.kernel, 4, sp.wrap_pad)
    assert isinstance(sim._impls[0][0], resident_ring.RingShardImpl)
    if emulated:
        resident_ring.ring_emulated(sim.ss, 4, resident_ring.ring_depth(
            4, sim.ss.h))
    else:
        sim.run()
    cells, av = sim.result()
    return cells[:, sp.pad:].numpy(), av.numpy()


@pytest.mark.parametrize("nx,ny", [(16, 16), (32, 66)],
                         ids=["16x16-forced-row-on-a-seam", "32x66-padded"])
def test_ring_plain_version_matches_jax_ring(nx, ny, monkeypatch):
    """4 steps at G=4 over 8 shards (the JAX interpreter is slow). At
    16x16 each shard has 2 rows and the forced row 14 is shard 7's row 0,
    a seam row; 66 rows pad to 72 behind the walls."""
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    cells, av = _port_ring(nx, ny)
    want_cells, want_av = _jax_ring(nx, ny)
    np.testing.assert_allclose(cells, want_cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av, want_av, rtol=RTOL)
    p, mask = _scene(nx, ny)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(cells, base.cells)


@pytest.mark.parametrize("nx,ny", [(16, 16), (32, 66)],
                         ids=["16x16-2-row-shards-D2", "32x66-padded-D4"])
def test_ring_emulation_matches_jax_ring(nx, ny, monkeypatch):
    """The kernel's round schedule on the same run: D=2 on 2-row shards
    (the forced row on a seam), D=4 on the padded 9-row shards; the JAX
    ring within the bound, the port's plain run bit for bit."""
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    cells, av = _port_ring(nx, ny, emulated=True)
    want_cells, want_av = _jax_ring(nx, ny)
    np.testing.assert_allclose(cells, want_cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av, want_av, rtol=RTOL)
    p, mask = _scene(nx, ny)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(cells, base.cells)
    np.testing.assert_allclose(av, base.av_vels, rtol=RTOL)


def test_ring_gating_through_the_planner(monkeypatch):
    p = _params(32, 64, 23)
    mask = generate_obstacles(32, 64)
    mesh = decomp.make_mesh(8, devices=[CPU] * 8)

    def planned():
        return plan.describe(halo.plan_run(p, mask, mesh, "cuda", 23).segments)

    assert "ring" not in planned()
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "0")
    assert "ring" not in planned()
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    assert planned() == "ring G=20 x1, depth D=2 x1, step x1"
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    assert planned() == "ring G=4 x5, depth D=2 x1, step x1"
    # The reference kernel and the wrap discipline never take the ring.
    assert plan.describe(halo.plan_run(p, mask, mesh, "reference",
                                       23).segments) == "reference x23"
    wall_less = np.zeros((66, 32), bool)
    assert plan.describe(halo.plan_run(_params(32, 66, 20), wall_less, mesh,
                                       "cuda", 20).segments) == "step x20"
    # One row a shard has no row 0 and row h-1 apart: no ring.
    assert resident_ring.ring_prefs(1, 32) is None
    with pytest.raises(ValueError, match="even"):
        resident_ring.RingShardImpl(halo.ShardSet(
            p, initial_state(p, CPU), mask, mesh, 23), 5)


def test_ring_tail_runs_exactly(monkeypatch):
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    p = _params(32, 64, 23)
    mask = generate_obstacles(32, 64)
    mesh = decomp.make_mesh(8, devices=[CPU] * 8)
    sim = halo.ShardedSimulation(p, initial_state(p, CPU), mask, mesh, "cuda", 23)
    sim.run()
    cells, av = sim.result()
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(cells.numpy(), base.cells)
    np.testing.assert_allclose(av.numpy(), base.av_vels, rtol=1e-4)


# --------------------------------------------------------------------------
# The kernel's round schedule (csrc/ring.cu) against the plain version.
# --------------------------------------------------------------------------


def _shard_sets(nx, ny, n, g, axis=0, seed=3):
    """Two copies of a perturbed state over ``n`` CPU shards, padded as
    the planner pads it (the row plan) or as the x-plan's column blocks
    (``axis`` 1), for ``2 g`` steps."""
    p = _params(nx, ny, 2 * g)
    rng = np.random.default_rng(seed)
    mask = generate_obstacles(nx, ny)
    mask[ny - 2, :] |= rng.random(nx) < 0.3
    mask[ny - 2, 5] = False
    eq = initial_state(p).numpy()
    cells = torch.from_numpy(
        (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32))
    mesh = decomp.make_mesh(n, devices=[CPU] * n)
    pad = 0
    if axis == 0:
        sp = halo.plan_run(p, mask, mesh, "cuda", g)
        p, mask, pad = sp.params, sp.obstacles, sp.pad
        if pad:
            full = initial_state(p).clone()
            full[:, pad:] = cells
            cells = full
    return [halo.ShardSet(p, cells, mask, mesh, 2 * g, axis)
            for _ in range(2)], pad


def _emulated_against_plain(nx, ny, n, g, depth=None, axis=0):
    """Two calls of ``g`` steps (the slots' parity goes on across calls)
    by the round schedule at ``depth`` (default: the ring's) and by the
    ring's plain version: ``(equal cells, emulated av_vels, plain
    av_vels, shard rows)``."""
    (plain, emu), pad = _shard_sets(nx, ny, n, g, axis)
    d = depth or resident_ring.ring_depth(g, emu.h)
    ring = resident_ring.RingShardImpl(plain, g)
    for c in range(2):
        ring.run(c * g)
        resident_ring.ring_emulated(emu, g, d, c * g)
    a, b = plain.gather()[:, pad:], emu.gather()[:, pad:]
    return (torch.equal(a, b), emu.av_vels(1.0).numpy(),
            plain.av_vels(1.0).numpy(), emu.h)


# (physical nx, ny, shards, G, pinned D or None, axis, expected D, rows a
# shard): D=2 and D=4, a G that forces D=2, 2-row shards, the padded
# lattice, the forced row on a seam (16x16/8: row 14 is shard 7's row 0),
# shards with interior tiles (54 rows: tile row 1 of 3; nx = 40, a ragged
# tile column), and column mode (the x-plan) with and without them.
EMULATED_CASES = {
    "16x16/8-2-row-shards-forced-row-on-a-seam": (16, 16, 8, 4, None, 0, 2, 2),
    "32x66/8-padded-D4": (32, 66, 8, 4, None, 0, 4, 9),
    "32x66/8-padded-G6-forces-D2": (32, 66, 8, 6, None, 0, 2, 9),
    "40x216/4-interior-tiles-D4": (40, 216, 4, 8, None, 0, 4, 54),
    "40x216/4-interior-tiles-D2": (40, 216, 4, 8, 2, 0, 2, 54),
    "216x40/4-x-plan-interior-tiles-D4": (216, 40, 4, 8, None, 1, 4, 54),
    "64x16/4-x-plan-D4": (64, 16, 4, 4, None, 1, 4, 16),
    "16x64/8-x-plan-2-row-shards": (16, 64, 8, 4, None, 1, 2, 2),
}


@pytest.mark.parametrize("case", list(EMULATED_CASES))
def test_ring_emulation_equals_the_plain_ring(case):
    nx, ny, n, g, depth, axis, want_d, rows = EMULATED_CASES[case]
    (ss, _), _ = _shard_sets(nx, ny, n, g, axis)
    assert ss.h == rows
    assert (depth or resident_ring.ring_depth(g, rows)) == want_d
    equal, av, want_av, _ = _emulated_against_plain(nx, ny, n, g, depth, axis)
    assert equal
    np.testing.assert_allclose(av, want_av, rtol=RTOL)


def test_ring_emulation_runs_interior_tiles_without_halos():
    """54-row shards at D=4 have one interior tile row, 40 lanes two tile
    columns: tiles 2 and 3 run before the rows land (with NaN slots)."""
    assert resident_ring.inner_tiles(54, 40, 4) == (2, 4)
    assert resident_ring.inner_tiles(54, 40, 2) == (2, 4)
    assert resident_ring.inner_tiles(52, 128, 4) == (4, 8)
    assert resident_ring.inner_tiles(51, 128, 4) == (4, 4)
    assert resident_ring.inner_tiles(256, 1024, 4) == (32, 320)
    assert resident_ring.inner_tiles(2, 16, 2) == (1, 1)


def test_ring_emulation_catches_unforced_halo_rows(monkeypatch):
    """The receiver must force the raw halo rows: with the forced row on
    a seam, a receiver that forces only its own rows gives other cells."""
    forced = resident_ring._window_forced

    def own_rows_only(ys, cols, row0, ny, nx, h, axis):
        f = forced(ys, cols, row0, ny, nx, h, axis).clone()
        f[(ys < 0) | (ys >= h)] = False
        return f

    monkeypatch.setattr(resident_ring, "_window_forced", own_rows_only)
    equal, av, want_av, _ = _emulated_against_plain(16, 16, 8, 4)
    assert not equal
    assert not np.allclose(av, want_av, rtol=RTOL)


@pytest.mark.parametrize("case", ["16x16/8", "40x216/4"])
def test_ring_emulation_catches_a_stale_slot(case, monkeypatch):
    """Edge tiles that read the other slot (the rows of the round before,
    or nothing in round 0) give other cells."""
    monkeypatch.setattr(resident_ring, "_receive_slot", lambda k: (k + 1) % 2)
    nx, ny, n, g = {"16x16/8": (16, 16, 8, 4), "40x216/4": (40, 216, 4, 8)}[case]
    equal, _, _, _ = _emulated_against_plain(nx, ny, n, g)
    assert not equal


@pytest.mark.parametrize("g,rows,want", [
    (100, 256, 4), (50, 256, 2), (100, 2, 2), (100, 3, 2), (4, 9, 4),
    (64, 4, 4), (18, 1024, 2), (16, 32768, 4)])
def test_ring_depth_is_the_first_auto_depth_that_fits(g, rows, want):
    assert resident_ring.ring_depth(g, rows) == want


def test_ring_depth_is_checked():
    p = _params(32, 64, 8)
    mesh = decomp.make_mesh(8, devices=[CPU] * 8)
    ss = halo.ShardSet(p, initial_state(p, CPU), generate_obstacles(32, 64),
                       mesh, 8)
    assert resident_ring.RingShardImpl(ss, 8).depth == 4
    assert resident_ring.RingShardImpl(ss, 6).depth == 2
    with pytest.raises(ValueError, match="depth"):
        resident_ring.ring_depth(5, 64)
    with pytest.raises(ValueError, match="depth"):
        resident_ring.ring_depth(4, 1)
    for depth in (4, 3, 8):
        with pytest.raises(ValueError, match="depth"):
            resident_ring.ring_emulated(ss, 6, depth)


def test_ring_ab_script_needs_a_card(capsys):
    """scripts/ring_ab_torch.py measures on a card only: without one it
    exits 2 before building or printing a result."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "ring_ab_torch.py"
    spec = importlib.util.spec_from_file_location("ring_ab_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [s for s, _ in mod.SHAPES] == ["1024x1024", "16384x1024",
                                          "131072x128"]
    assert mod.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


# --------------------------------------------------------------------------
# A model of the ring's slot protocol.
# --------------------------------------------------------------------------


class _Ring:
    """``n`` shards of one row each running ``g`` steps. Shard r, step t,
    slot t % 2: send its row (r, t) north and south as transfers that land
    in any order, compute, wait for its two flags, read both halos,
    record what it read. ``per_slot``: a flag per (direction, slot);
    else one flag per direction shared by both slots. A flag holds the
    largest tag (step + 1) that landed on it."""

    def __init__(self, n: int, g: int, per_slot: bool):
        self.n, self.g, self.per_slot = n, g, per_slot
        self.halo = {(r, side, s): None for r in range(n)
                     for side in "sn" for s in (0, 1)}
        self.flag = {}
        self.pending = []
        self.reads = []
        self.programs = [self._program(r) for r in range(n)]
        self.ready = list(range(n))
        self.waiting = {}

    def _flag_key(self, r, side, slot):
        return (r, side, slot if self.per_slot else 0)

    def _landed(self, r, slot, tag):
        return all(self.flag.get(self._flag_key(r, side, slot), 0) >= tag
                   for side in "sn")

    def _can_run(self, r):
        return r not in self.waiting or self._landed(r, *self.waiting[r])

    def _program(self, r):
        n = self.n
        for t in range(self.g):
            slot, tag = t % 2, t + 1
            # Our row goes to the north neighbour's south halo and the
            # south neighbour's north halo.
            self.pending.append(((r + 1) % n, "s", slot, (r, t), tag))
            self.pending.append(((r - 1) % n, "n", slot, (r, t), tag))
            yield  # interior rows
            self.waiting[r] = (slot, tag)
            while not self._landed(r, slot, tag):
                yield  # spinning: not scheduled until both flags hold tag
            del self.waiting[r]
            self.reads.append((r, t, self.halo[(r, "s", slot)],
                               self.halo[(r, "n", slot)]))
            yield  # boundary rows, barrier

    def actions(self):
        return [("run", r) for r in self.ready if self._can_run(r)] + \
            [("land", i) for i in range(len(self.pending))]

    def do(self, action):
        kind, i = action
        if kind == "land":
            dst, side, slot, payload, tag = self.pending.pop(i)
            self.halo[(dst, side, slot)] = payload
            key = self._flag_key(dst, side, slot)
            self.flag[key] = max(self.flag.get(key, 0), tag)
            return
        try:
            next(self.programs[i])
        except StopIteration:
            self.ready.remove(i)

    def run(self, choices):
        """Run to the end, the k-th action chosen by ``choices[k]``
        (cycled); returns the wrong reads."""
        k = 0
        while self.ready or self.pending:
            acts = self.actions()
            assert acts, "deadlock"
            self.do(acts[choices[k % len(choices)] % len(acts)] if choices
                    else acts[0])
            k += 1
            assert k < 10_000, "livelock"
        return self.wrong_reads()

    def wrong_reads(self):
        n = self.n
        return [(r, t, s, nn) for r, t, s, nn in self.reads
                if s != ((r - 1) % n, t) or nn != ((r + 1) % n, t)]


_choices = st.lists(st.integers(0, 63), min_size=1, max_size=200)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(n=st.integers(1, 4), choices=_choices)
def test_slot_protocol_reads_its_own_step_with_per_slot_flags(n, choices):
    ring = _Ring(n, 6, per_slot=True)
    assert ring.run(choices) == []
    assert len(ring.reads) == 6 * n


def test_slot_protocol_with_one_shared_flag_reads_a_wrong_step():
    def wrong(choices):
        return _Ring(2, 4, per_slot=False).run(choices) != []

    choices = find(_choices, wrong,
                   settings=settings(max_examples=2000, database=None))
    reads = _Ring(2, 4, per_slot=False).run(choices)
    assert reads
    # The same interleaving is right with a flag per slot.
    assert _Ring(2, 4, per_slot=True).run(choices) == []


class _RoundRing:
    """The slot protocol in rounds of ``d``-row payloads
    (``csrc/ring.cu``): shard r, round t, slot t % 2, sends its d rows
    (r, t, i) north and south, each row a transfer that lands with its
    signal in any order (as a DMA with a semaphore does, and as stores
    to another card may without a fence: the kernel's fence before its
    tag only narrows this); computes its interior tiles; waits until its
    flags count the rows of round t; reads both slots' d rows; passes
    its barrier. ``per_slot``: a counter per (direction, slot), which
    must count the rows of every round that used the slot up to t; else
    one counter per direction, which must count the rows of every round
    up to t."""

    def __init__(self, n: int, g: int, d: int, per_slot: bool):
        self.n, self.g, self.d, self.per_slot = n, g, d, per_slot
        self.halo = {}
        self.count = {}
        self.pending = []
        self.reads = []
        self.programs = [self._program(r) for r in range(n)]
        self.ready = list(range(n))
        self.waiting = {}

    def _landed(self, r, t):
        key = t % 2 if self.per_slot else 0
        need = self.d * (t // 2 + 1 if self.per_slot else t + 1)
        return all(self.count.get((r, side, key), 0) >= need
                   for side in "sn")

    def _can_run(self, r):
        return r not in self.waiting or self._landed(r, self.waiting[r])

    def _program(self, r):
        n, d = self.n, self.d
        for t in range(self.g):
            slot = t % 2
            for i in range(d):
                self.pending.append(((r + 1) % n, "s", slot, i, (r, t, i)))
                self.pending.append(((r - 1) % n, "n", slot, i, (r, t, i)))
            yield  # interior tiles
            self.waiting[r] = t
            while not self._landed(r, t):
                yield  # spinning: not scheduled until the rows are counted
            del self.waiting[r]
            self.reads.append((r, t, [self.halo.get((r, "s", slot, i))
                                      for i in range(d)],
                               [self.halo.get((r, "n", slot, i))
                                for i in range(d)]))
            yield  # edge tiles, barrier

    def actions(self):
        return [("run", r) for r in self.ready if self._can_run(r)] + \
            [("land", i) for i in range(len(self.pending))]

    def do(self, action):
        kind, i = action
        if kind == "land":
            dst, side, slot, row, payload = self.pending.pop(i)
            self.halo[(dst, side, slot, row)] = payload
            key = (dst, side, slot if self.per_slot else 0)
            self.count[key] = self.count.get(key, 0) + 1
            return
        try:
            next(self.programs[i])
        except StopIteration:
            self.ready.remove(i)

    def run(self, choices):
        """Run to the end, the k-th action chosen by ``choices[k]``
        (cycled); returns the wrong reads."""
        k = 0
        while self.ready or self.pending:
            acts = self.actions()
            assert acts, "deadlock"
            self.do(acts[choices[k % len(choices)] % len(acts)])
            k += 1
            assert k < 20_000, "livelock"
        n, d = self.n, self.d
        return [(r, t) for r, t, s, nn in self.reads
                if s != [((r - 1) % n, t, i) for i in range(d)]
                or nn != [((r + 1) % n, t, i) for i in range(d)]]


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(n=st.integers(1, 4), d=st.sampled_from([1, 2, 4]), choices=_choices)
def test_round_protocol_reads_its_own_round_with_per_slot_flags(n, d,
                                                                choices):
    ring = _RoundRing(n, 5, d, per_slot=True)
    assert ring.run(choices) == []
    assert len(ring.reads) == 5 * n


@pytest.mark.parametrize("d", [2, 4])
def test_round_protocol_with_one_shared_flag_reads_a_wrong_round(d):
    def wrong(choices):
        return _RoundRing(2, 4, d, per_slot=False).run(choices) != []

    choices = find(_choices, wrong,
                   settings=settings(max_examples=2000, database=None))
    assert _RoundRing(2, 4, d, per_slot=False).run(choices)
    # The same interleaving is right with a flag per slot.
    assert _RoundRing(2, 4, d, per_slot=True).run(choices) == []
