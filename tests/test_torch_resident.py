"""The resident kernel's module, lbm_tpu_torch.ops.resident, on the CPU:
the plain version (``multi_step``) and the wrapper on CPU tensors against
the JAX package's ``_kernel_resident`` in interpret mode
(``ResidentStep``), run as tests/test_resident.py runs it, with one row
block and with several; the on-chip form's emulation (strips, halo slots
by parity, fixed-order sums) against both, and a model of its flag
protocol; the device-memory form's emulation (rounds of the depth
kernel's tiles) against the depth kernel's emulation, the plain version
and JAX. The CUDA kernels themselves are compared with the plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: cells rtol 2e-5 / atol 5e-8 and tot rtol 1e-4, the repo's
kernel-vs-reference bounds (tests/test_pallas.py:204-207).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.ops.pallas_resident import ResidentStep
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state, initial_state_np
from lbm_tpu_torch.ops import fused, fused_depth, resident
from lbm_tpu_torch.ops import reference as ref_ops

torch.set_num_threads(2)

RTOL, ATOL, TOT_RTOL = 2e-5, 5e-8, 1e-4
# The on-chip form's emulation against JAX: rtol 1e-4 on cells and tots
# (ROADMAP.md section 3, item 3: XLA's jit moves JAX's f32 steps by ulps).
ONCHIP_RTOL = 1e-4


def _params(ny, nx, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _jax_resident(p, gsteps):
    """One ``ResidentStep`` call of ``gsteps`` steps from rest."""
    obstacles = jnp.asarray(generate_obstacles(p.nx, p.ny))
    impl = ResidentStep(p, gsteps)
    prepared = impl.prepare(obstacles)
    carry, tots = impl.step(impl.init(initial_state(p), prepared), prepared)
    return np.asarray(impl.final(carry)), np.asarray(tots)


def _port(p, gsteps):
    """multi_step and the wrapper on CPU tensors, from rest."""
    mask = torch.from_numpy(generate_obstacles(p.nx, p.ny))
    c0 = torch.from_numpy(initial_state_np(p))
    args = (mask, p.accel_w1, p.accel_w2, p.omega, gsteps)
    plain = ref_ops.multi_step(c0, *args)
    wrapped = resident.resident(c0, *args)
    return plain, wrapped


def _assert_matches(got, tots, want, want_tots):
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), want_tots, rtol=TOT_RTOL)


def test_matches_resident_step_single_block():
    p = _params(32, 128, 8)
    want, want_tots = _jax_resident(p, 8)
    (c, t), (cw, tw) = _port(p, 8)
    _assert_matches(c, t, want, want_tots)
    _assert_matches(cw, tw, want, want_tots)


def test_matches_resident_step_multiblock(monkeypatch):
    """Several of the TPU kernel's row blocks per step (by=8), as
    tests/test_resident.py forces them."""
    monkeypatch.setattr(pf, "_SLOT_BYTES", 8 * 9 * 64 * 4)
    p = _params(32, 64, 6)
    assert pf._pick_block_rows(p.ny, p.nx) == 8
    want, want_tots = _jax_resident(p, 6)
    (c, t), (cw, tw) = _port(p, 6)
    _assert_matches(c, t, want, want_tots)
    _assert_matches(cw, tw, want, want_tots)


@pytest.mark.parametrize("gsteps", [1, 4, 5])
def test_cpu_wrapper_keeps_the_kernels_buffer_parity(gsteps):
    """The result is in the first buffer after an even G and in the
    second after an odd one, as on the card; out[t:t+G] gets the scaled
    tots; nothing launches."""
    p = _params(24, 40, gsteps)
    rng = np.random.default_rng(gsteps)
    a = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 24, 40)).astype(np.float32))
    a0 = a.clone()
    b = torch.empty_like(a)
    mask = torch.from_numpy(generate_obstacles(40, 24))
    kernel = resident.Resident(mask, p.accel_w1, p.accel_w2, p.omega, gsteps)
    assert kernel.steps_per_call == gsteps
    av = torch.full((gsteps + 4,), -1.0)
    before = dict(fused.LAUNCHES)
    new, spare = kernel.run(a, b, av, 2, 0.25)
    assert (new, spare) == ((a, b) if gsteps % 2 == 0 else (b, a))
    want, want_tots = ref_ops.multi_step(a0, mask, p.accel_w1, p.accel_w2,
                                         p.omega, gsteps)
    assert torch.equal(new, want)
    assert torch.equal(av[2:2 + gsteps], want_tots * 0.25)
    assert (av[:2] == -1).all() and (av[2 + gsteps:] == -1).all()
    assert fused.LAUNCHES == before, "no kernel launches on the CPU"


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mask = torch.from_numpy(generate_obstacles(16, 8))
    with pytest.raises(ValueError, match="positive"):
        resident.Resident(mask, 1e-5, 1e-6, 1.85, 0)
    kernel = resident.Resident(mask, 1e-5, 1e-6, 1.85, 4)
    a, b = torch.ones(9, 8, 16), torch.empty(9, 8, 16)
    with pytest.raises(ValueError, match="slice"):
        kernel.run(a, b, torch.empty(6), 3)  # out[3:7] of 6
    with pytest.raises(ValueError, match="shape"):
        kernel.run(torch.ones(9, 8, 15), b, torch.empty(6), 0)
    with pytest.raises(ValueError):
        resident.Resident(mask.to(torch.uint8), 1e-5, 1e-6, 1.85, 4)


def test_multi_step_is_n_fused_steps():
    p = _params(16, 24, 3)
    rng = np.random.default_rng(9)
    c0 = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 16, 24)).astype(np.float32))
    mask = torch.from_numpy(rng.random((16, 24)) < 0.1)
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    got, tots = ref_ops.multi_step(c0, *args, 3)
    c = c0
    for n in range(3):
        c, tot = ref_ops.fused_step(c, *args)
        assert float(tots[n]) == float(tot)
    assert torch.equal(got, c)
    with pytest.raises(ValueError, match="positive"):
        ref_ops.multi_step(c0, *args, 0)


# The device-memory form's rounds (ops.resident.device_rounds,
# resident_device_emulated).


def test_device_rounds_keep_the_buffer_parity():
    """As many rounds of 4 as fit; the count of rounds has G's parity (the
    result lands in the first buffer after an even G), so one round of 4,
    or of 2 where there is none, is split in two."""
    want = {100: (24, 2, 0), 64: (16, 0, 0), 50: (11, 3, 0), 32: (8, 0, 0),
            20: (4, 2, 0), 16: (4, 0, 0), 8: (2, 0, 0), 6: (1, 1, 0),
            5: (0, 2, 1), 4: (0, 2, 0), 2: (0, 0, 2), 1: (0, 0, 1)}
    for g, counts in want.items():
        rounds = resident.device_rounds(g)
        assert tuple(rounds.count(d) for d in (4, 2, 1)) == counts, g
        assert rounds == sorted(rounds, reverse=True)
    for g in range(1, 230):
        rounds = resident.device_rounds(g)
        assert sum(rounds) == g and len(rounds) % 2 == g % 2
        assert rounds.count(1) <= 3 and rounds.count(2) <= 3
    with pytest.raises(ValueError, match="positive"):
        resident.device_rounds(0)


def _device_case(kind, axis, seed):
    """A perturbed state on a ragged lattice (24 and 32 divide neither
    side) and its mask, ``kind`` "walls" or "wall-less" (random
    obstacles, periodic both ways), the forced line failing the guard in
    places; ``axis`` 1: a wide grid's transposed lattice."""
    rows, lanes = (100, 40) if axis else (50, 70)
    p = _params(rows, lanes, 8)
    rng = np.random.default_rng(seed)
    eq = initial_state_np(p)
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    if axis:
        c[8, :, lanes - 2][rng.random(rows) < 0.3] = np.float32(p.accel_w2)
    else:
        c[6, rows - 2][rng.random(lanes) < 0.3] = np.float32(p.accel_w2)
    mask = (generate_obstacles(lanes, rows) if kind == "walls"
            else rng.random((rows, lanes)) < 0.15)
    return p, torch.from_numpy(c), torch.from_numpy(mask)


@pytest.mark.parametrize("g,depth", [(8, 4), (6, 2)], ids=["G8-D4", "G6-D2"])
@pytest.mark.parametrize("kind", ["walls", "wall-less"])
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
def test_device_emulation_is_the_depth_emulation_g_over_d_times(axis, kind,
                                                                g, depth):
    """Where D divides G, the device form's rounds give every bit of G / D
    depth-kernel calls, in cells and in each step's tot (the depths share
    the tile, so a step sums the same way whichever round runs it)."""
    p, c0, mask = _device_case(kind, axis, seed=g + 10 * axis)
    args = (mask, p.accel_w1, p.accel_w2, p.omega)
    got, tots = resident.resident_device_emulated(c0, *args, g, axis=axis)
    c, want_tots = c0, []
    for _ in range(g // depth):
        c, t = fused_depth.fused_depth_emulated(c, *args, depth, axis=axis)
        want_tots.append(t)
    assert torch.equal(got, c)
    assert torch.equal(tots, torch.cat(want_tots))
    want, _ = ref_ops.multi_step(c0, *args, g, axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("g", [5, 1])
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
def test_device_emulation_of_an_odd_g(axis, g):
    """An odd G ends on a one-step round: the plain version's cells bit
    for bit, tots within the bound."""
    p, c0, mask = _device_case("walls", axis, seed=g)
    args = (mask, p.accel_w1, p.accel_w2, p.omega, g)
    got, tots = resident.resident_device_emulated(c0, *args, axis=axis)
    want, want_tots = ref_ops.multi_step(c0, *args, axis)
    assert resident.device_rounds(g)[-1] == 1
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.numpy(), want_tots.numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.parametrize("blocks", ["single-block", "multiblock"])
def test_device_emulation_matches_resident_step(blocks, monkeypatch):
    """The device form's rounds from rest against the JAX package's
    ``_kernel_resident`` in interpret mode (``ResidentStep``), with one
    of its row blocks per step and with several, as
    tests/test_resident.py runs it."""
    if blocks == "multiblock":
        monkeypatch.setattr(pf, "_SLOT_BYTES", 8 * 9 * 64 * 4)
        p = _params(32, 64, 6)
        assert pf._pick_block_rows(p.ny, p.nx) == 8
    else:
        p = _params(32, 128, 8)
    want, want_tots = _jax_resident(p, p.max_iters)
    mask = torch.from_numpy(generate_obstacles(p.nx, p.ny))
    got, tots = resident.resident_device_emulated(
        torch.from_numpy(initial_state_np(p)), mask, p.accel_w1, p.accel_w2,
        p.omega, p.max_iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=ONCHIP_RTOL, atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), want_tots, rtol=ONCHIP_RTOL)


# The on-chip form's schedule (ops.resident.resident_onchip_emulated):
# strips of whole rows, halo slots by step parity holding three
# sender-forced speeds, tot_u by strip then in block order. Cases:
# (ny, nx, blocks, gsteps, obstacle on row ny-2 in a strip's halo row).
ONCHIP_CASES = {
    # 20 rows over 6 blocks: strips of 4, 4, 3, 3, 3, 3.
    "uneven-strips": (20, 24, 6, 4, False),
    # A row a block: every row an edge row, both halos from one row each.
    "one-row-strips": (12, 16, 12, 4, False),
    # One block: it is its own north and south neighbour.
    "one-block": (10, 16, 1, 4, False),
    # Strips of 2 rows: row 14 = ny-2 starts the last strip, so the strip
    # below it (rows 12, 13) pulls the forced row as its north halo; an
    # obstacle sits in that halo row. G odd.
    "forced-row-as-halo": (16, 20, 8, 5, True),
}


def _onchip_mask(ny, nx, obstacle_on_forced_row):
    mask = generate_obstacles(nx, ny)
    if obstacle_on_forced_row:
        mask[ny - 2, [3, 11]] = True
    return mask


@pytest.mark.parametrize("case", list(ONCHIP_CASES))
def test_onchip_emulation_is_multi_step_bit_for_bit(case):
    """The strips with their halo slots give every bit of the plain
    version's cells, from a perturbed state whose forced row fails the
    guard in places (speed 6 at its weight); the six speeds no halo
    carries are NaN in the emulation, so a pull of one would show."""
    ny, nx, blocks, gsteps, obst = ONCHIP_CASES[case]
    p = _params(ny, nx, gsteps)
    rng = np.random.default_rng(ny * nx + blocks)
    eq = initial_state_np(p)
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    c[6, ny - 2][rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    c0 = torch.from_numpy(c)
    mask = torch.from_numpy(_onchip_mask(ny, nx, obst))
    args = (mask, p.accel_w1, p.accel_w2, p.omega, gsteps)
    want, want_tots = ref_ops.multi_step(c0, *args)
    got, tots = resident.resident_onchip_emulated(c0, *args, blocks)
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.numpy(), want_tots.numpy(), rtol=1e-5)


@pytest.mark.parametrize("case", list(ONCHIP_CASES))
def test_onchip_emulation_matches_resident_step(case):
    """The same schedules from rest against the JAX package's
    ``_kernel_resident`` in interpret mode (``ResidentStep``). Its
    two-buffer mode takes an even G only, so an odd G is held to one
    JAX call of 2G as two emulated calls of G."""
    ny, nx, blocks, gsteps, obst = ONCHIP_CASES[case]
    calls = 2 if gsteps % 2 else 1
    p = _params(ny, nx, calls * gsteps)
    mask = _onchip_mask(ny, nx, obst)
    impl = ResidentStep(p, calls * gsteps)
    prepared = impl.prepare(jnp.asarray(mask))
    carry, want_tots = impl.step(impl.init(initial_state(p), prepared),
                                 prepared)
    want = np.asarray(impl.final(carry))
    got, tots = torch.from_numpy(initial_state_np(p)), []
    for _ in range(calls):
        got, t = resident.resident_onchip_emulated(
            got, torch.from_numpy(mask), p.accel_w1, p.accel_w2, p.omega,
            gsteps, blocks)
        tots.append(t)
    np.testing.assert_allclose(got.numpy(), want, rtol=ONCHIP_RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(torch.cat(tots).numpy(),
                               np.asarray(want_tots), rtol=ONCHIP_RTOL)


def test_onchip_emulation_column_mode():
    """Column mode on a small transposed lattice (a wide grid's 64x16,
    rows 64 over 7 uneven strips, the forced column 14 crossing every
    strip, scattered obstacles on it): every bit of the plain column-mode
    steps, and within the bounds of JAX's transposed resident run
    (``make_simulate(kernel="pallas")``, ``TransposedResidentStep``)."""
    from lbm_tpu.obstacles import num_non_obstacles_r
    from lbm_tpu.runner import make_simulate
    from lbm_tpu_torch.state import transpose_state

    nx, ny, gsteps, blocks = 64, 16, 4, 7
    p = _params(ny, nx, 2 * gsteps)
    rng = np.random.default_rng(5)
    mask = generate_obstacles(nx, ny)
    mask |= rng.random((ny, nx)) < 0.1
    mask[ny - 2, :] |= rng.random(nx) < 0.3
    ct = transpose_state(torch.from_numpy(initial_state_np(p)))
    mt = torch.from_numpy(mask).T.contiguous()
    args = (p.accel_w1, p.accel_w2, p.omega, gsteps)
    got, tots, c = [], [], ct
    for _ in range(2):
        want, want_tots = ref_ops.multi_step(c, mt, *args, axis=1)
        c, t = resident.resident_onchip_emulated(c, mt, *args, blocks, axis=1)
        assert torch.equal(c, want)
        np.testing.assert_allclose(t.numpy(), want_tots.numpy(), rtol=1e-5)
        tots.append(t)
    import os
    env = {"LBM_RESIDENT": "1", "LBM_RESIDENT_STEPS": str(gsteps)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jc, jav = make_simulate(p, kernel="pallas", n_iters=2 * gsteps)(
            jnp.asarray(initial_state_np(p)), jnp.asarray(mask),
            num_non_obstacles_r(mask))
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    phys = transpose_state(c)
    np.testing.assert_allclose(phys.numpy(), np.asarray(jc), rtol=ONCHIP_RTOL,
                               atol=ATOL)
    av = torch.cat(tots) * float(num_non_obstacles_r(mask))
    np.testing.assert_allclose(av.numpy(), np.asarray(jav), rtol=ONCHIP_RTOL)


def test_strips_split_rows_evenly():
    assert resident.strips(20, 6) == [(0, 4), (4, 4), (8, 3), (11, 3),
                                      (14, 3), (17, 3)]
    assert resident.strips(16, 8)[-1] == (14, 2)
    for ny, b in [(128, 128), (256, 132), (512, 132), (7, 3), (5, 1)]:
        parts = resident.strips(ny, b)
        assert sum(h for _, h in parts) == ny
        assert max(h for _, h in parts) - min(h for _, h in parts) <= 1
        assert all(r0 + h == nxt for (r0, h), (nxt, _) in
                   zip(parts, parts[1:]))
    assert all(h == 1 for _, h in resident.strips(12, 12))


@pytest.mark.parametrize("form", ["onchip", "inplace", "device", None])
def test_cpu_wrapper_of_either_form_runs_the_plain_version(form):
    """On the CPU every form (the on-chip form's single-buffer mode too,
    and no form) runs ``multi_step``; nothing launches; a form that is not
    one raises."""
    mask = torch.from_numpy(generate_obstacles(16, 12))
    c0 = torch.from_numpy(initial_state_np(_params(12, 16, 4)))
    before = dict(fused.LAUNCHES)
    got, tots = resident.resident(c0, mask, 1e-4, 2.5e-5, 1.85, 4,
                                  form=form)
    want, want_tots = ref_ops.multi_step(c0, mask, 1e-4, 2.5e-5, 1.85, 4)
    assert torch.equal(got, want) and torch.equal(tots, want_tots)
    assert fused.LAUNCHES == before
    with pytest.raises(ValueError, match="form"):
        resident.Resident(mask, 1e-4, 2.5e-5, 1.85, 4, form="shared")


# A model of the on-chip form's flag protocol between the blocks of one
# launch: as tests/test_torch_ring.py models the ring's.


class _Strips:
    """B blocks in a ring, each a coroutine: at step t (slot t % 2, tag
    t + 1) store its rows into the neighbours' slots, each store landing
    with its flag in any order, compute its interior, wait until both of
    its flags for the slot hold the tag, read both halo slots, record what
    it read. ``per_slot``: a flag per (direction, slot), as
    csrc/resident_onchip.cu has; else one flag per direction shared by
    both slots."""

    def __init__(self, n: int, g: int, per_slot: bool):
        self.n, self.g, self.per_slot = n, g, per_slot
        # An empty slot holds None: reading one is a wrong read too.
        self.halo = {(b, side, slot): None for b in range(n)
                     for side in "sn" for slot in (0, 1)}
        self.flag, self.pending, self.reads = {}, [], []
        self.progs = {b: self._program(b) for b in range(n)}
        self.done = set()

    def _key(self, b, side, slot):
        return (b, side, slot if self.per_slot else 0)

    def _landed(self, b, slot, tag):
        return all(self.flag.get(self._key(b, side, slot), 0) >= tag
                   for side in ("s", "n"))

    def _program(self, b):
        n = self.n
        for t in range(self.g):
            slot, tag = t % 2, t + 1
            self.pending.append(((b + 1) % n, "s", slot, (b, t), tag))
            self.pending.append(((b - 1) % n, "n", slot, (b, t), tag))
            yield  # the interior rows
            while not self._landed(b, slot, tag):
                yield
            self.reads.append((b, t, self.halo[(b, "s", slot)],
                               self.halo[(b, "n", slot)]))
            yield

    def run(self, choices):
        """Run to the end, taking the action ``choices`` picks (an index
        into the enabled actions, modulo their count) at each point."""
        choices = iter(choices)
        while len(self.done) < self.n:
            acts = [("land", i) for i in range(len(self.pending))]
            acts += [("run", b) for b in self.progs if b not in self.done]
            kind, x = acts[next(choices, 0) % len(acts)]
            if kind == "land":
                dst, side, slot, payload, tag = self.pending.pop(x)
                self.halo[(dst, side, slot)] = payload
                key = self._key(dst, side, slot)
                self.flag[key] = max(self.flag.get(key, 0), tag)
            else:
                try:
                    next(self.progs[x])
                except StopIteration:
                    self.done.add(x)
        return [(b, t, s, nn) for b, t, s, nn in self.reads
                if s != ((b - 1) % self.n, t) or nn != ((b + 1) % self.n, t)]


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_onchip_flags_per_slot_read_their_own_step(n):
    rng = np.random.default_rng(n)
    for _ in range(200):
        choices = rng.integers(0, 1 << 30, 4000)
        assert _Strips(n, 6, per_slot=True).run(choices) == []


def test_onchip_one_flag_for_both_slots_reads_a_wrong_step():
    """With one flag per direction some interleaving lets a block read a
    slot that a neighbour already refilled for the next step; the same
    interleaving is right with a flag per slot."""
    rng = np.random.default_rng(0)
    for _ in range(2000):
        choices = rng.integers(0, 1 << 30, 4000)
        wrong = _Strips(3, 4, per_slot=False).run(choices)
        if wrong:
            break
    assert wrong, "no interleaving showed the shared flag's wrong read"
    assert _Strips(3, 4, per_slot=True).run(choices) == []
