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
"""

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


@pytest.mark.parametrize("nx,ny", [(16, 16), (32, 66)],
                         ids=["16x16-forced-row-on-a-seam", "32x66-padded"])
def test_ring_plain_version_matches_jax_ring(nx, ny, monkeypatch):
    """4 steps at G=4 over 8 shards (the JAX interpreter is slow). At
    16x16 each shard has 2 rows and the forced row 14 is shard 7's row 0,
    a seam row; 66 rows pad to 72 behind the walls."""
    from lbm_tpu.params import Params as JParams

    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    p = _params(nx, ny, 4)
    mask = generate_obstacles(nx, ny)
    rng = np.random.default_rng(55)
    mask[ny - 2, :] |= rng.random(nx) < 0.3
    mask[ny - 2, 5] = False
    mesh = decomp.make_mesh(8, devices=[CPU] * 8)
    sp = halo.plan_run(p, mask, mesh, "cuda", 4)
    assert [s.describe() for s in sp.segments] == ["ring G=4 x1"]
    sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, CPU),
                                 sp.obstacles, mesh, sp.kernel, 4, sp.wrap_pad)
    assert isinstance(sim._impls[0][0], resident_ring.RingShardImpl)
    sim.run()
    cells, av = sim.result()
    cells = cells[:, sp.pad:].numpy()

    jp = JParams(nx=nx, ny=ny, max_iters=4, reynolds_dim=10, density=0.1,
                 accel=0.005, omega=1.85)
    jmesh = jdecomp.make_mesh(8)
    jpad = jhalo.plan_row_padding(jp, mask, jmesh, "pallas")
    jpp = jhalo.pad_scene(jp, mask, jpad)[0] if jpad else jp
    assert jring.ring_planned(jpp, jmesh, 4)
    want = jrun(jp, mask, kernel="pallas", mesh=jmesh)
    np.testing.assert_allclose(cells, want.cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av.numpy(), want.av_vels, rtol=RTOL)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(cells, base.cells)


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
