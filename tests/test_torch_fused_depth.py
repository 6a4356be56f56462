"""The depth kernel's module, lbm_tpu_torch.ops.fused_depth, on the CPU.

Its tiling emulation (window, periodic gather, every stage on the whole
window with NaN for the cells outside its valid region, owned-cell tot_u
per stage at a fixed place) is held against the JAX package's
``_kernel_fused`` run in interpret mode, as tests/test_pallas.py runs it
(``run_simulation(kernel="pallas")`` with ``LBM_PALLAS_DEPTH``), and
against the plain version bit for bit. The CUDA kernel itself is
compared with the plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py).

Tolerances: cells rtol 2e-5 / atol 5e-8 and tot/av_vels rtol 1e-4, the
repo's kernel-vs-reference bounds (tests/test_pallas.py:204-207);
against the plain version, cells are bit-identical and tot_u differs
only by summation order (rtol 1e-6). A step's tot_u has the same bits at
every stage of a launch and under D = 2 and D = 4 (one tile, one map).
"""

import functools
import os
import random

import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles, num_non_obstacles_r
from lbm_tpu.params import Params
from lbm_tpu.runner import _select_impl, run_simulation
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch.ops import fused, fused_depth
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.state import transpose_state

torch.set_num_threads(2)

RTOL, ATOL, TOT_RTOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4, 1e-4
SUM_RTOL = 1e-6
N, ITERS = 32, 12


def _params(ny=N, nx=N, iters=ITERS):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _mask(kind, ny=N, nx=N):
    if kind == "walls":
        return generate_obstacles(nx, ny)
    rng = np.random.default_rng(17)
    mask = rng.random((ny, nx)) < 0.15
    mask[ny - 2, 3] = False  # keep the forced row partly fluid
    return mask


@functools.lru_cache(maxsize=None)
def _jax_run(kind, depth, iters=ITERS, ny=N, nx=N):
    """``iters`` steps of lbm_tpu's main path pinned to ``_kernel_fused``
    at ``depth`` (interpret mode on the CPU): (cells, av_vels). Cached:
    several tilings are held against one JAX run. A wide grid (nx >= 2 ny)
    runs the kernel's lane mode on the transposed lattice."""
    saved = {k: os.environ.get(k) for k in ("LBM_PALLAS_DEPTH", "LBM_RESIDENT")}
    os.environ["LBM_PALLAS_DEPTH"] = str(depth)
    os.environ["LBM_RESIDENT"] = "0"
    try:
        p = _params(ny, nx, iters)
        impl = _select_impl("pallas", p, paired=True, n_iters=iters)
        assert impl.fused == depth, "the JAX run must take _kernel_fused"
        r = run_simulation(p, _mask(kind, ny, nx), kernel="pallas")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    return r.cells, r.av_vels


def _emulated_run(kind, depth, tile, iters=ITERS, ny=N, nx=N, axis=0):
    """The same run through the emulation; ``axis`` 1: on the transposed
    lattice in column mode, transposed back at the end."""
    p = _params(ny, nx, iters)
    mask = _mask(kind, ny, nx)
    inv = num_non_obstacles_r(mask)
    cells = torch.from_numpy(initial_state_np(p))
    m = torch.from_numpy(mask)
    if axis:
        cells, m = transpose_state(cells), m.T.contiguous()
    av = []
    for _ in range(iters // depth):
        cells, tots = fused_depth.fused_depth_emulated(
            cells, m, p.accel_w1, p.accel_w2, p.omega, depth, tile, axis)
        assert torch.isfinite(cells).all(), "garbage reached an owned cell"
        av.append(tots * float(inv))
    if axis:
        cells = transpose_state(cells)
    return cells.numpy(), torch.cat(av).numpy()


@pytest.mark.parametrize("kind,depth,tile", [
    # ny-2 = 30 is the first row of the ragged last tile (rows 30-35).
    pytest.param("walls", 2, (6, 8), id="forced-row-first-in-tile-D2"),
    # ... and the last row of tile 0 (rows 0-30).
    pytest.param("walls", 2, (31, 12), id="forced-row-last-in-tile-D2"),
    # The 40x28 window of the default 24x32 tile wraps the 32x32 grid.
    pytest.param("walls", 2, None, id="grid-smaller-than-window-D2"),
    # A tile larger than the grid: periodic indices repeat cells.
    pytest.param("walls", 4, (48, 48), id="tile-larger-than-grid-D4"),
    # The default 24x32 tile: a ragged second row of tiles.
    pytest.param("walls", 4, None, id="ragged-default-tile-D4"),
    pytest.param("random", 2, (5, 7), id="wall-less-random-D2"),
    pytest.param("random", 2, None, id="wall-less-random-default-tile-D2"),
])
def test_emulation_matches_kernel_fused(kind, depth, tile):
    want_cells, want_av = _jax_run(kind, depth)
    got_cells, got_av = _emulated_run(kind, depth, tile)
    np.testing.assert_allclose(got_cells, want_cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_av, want_av, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("kind,depth,ny,nx,axis", [
    # The 48x32 window of D = 8 (tile 16x32, x-halo 8) wraps the grid.
    pytest.param("walls", 8, 32, 32, 0, id="grid-smaller-than-window-D8"),
    pytest.param("random", 8, 32, 32, 0, id="wall-less-random-D8"),
    # A ragged grid: 40 = 24 + 16 rows, 72 = 2 * 32 + 8 columns.
    pytest.param("walls", 4, 40, 72, 0, id="ragged-40x72-D4"),
    # Column mode: a wide grid runs transposed, (9, 64, 16), ragged in
    # both axes of its tiles, the forced column in the x-halo of none.
    pytest.param("walls", 2, 16, 64, 1, id="column-mode-D2"),
    pytest.param("walls", 4, 16, 64, 1, id="column-mode-D4"),
    pytest.param("walls", 8, 16, 64, 1, id="column-mode-D8"),
])
def test_default_tiles_match_kernel_fused(kind, depth, ny, nx, axis):
    """The kernel's own tiles and fixed-place stages, at every depth and
    in both forcing modes, against ``_kernel_fused`` over 16 steps."""
    want_cells, want_av = _jax_run(kind, depth, 16, ny, nx)
    got_cells, got_av = _emulated_run(kind, depth, None, 16, ny, nx, axis)
    np.testing.assert_allclose(got_cells, want_cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_av, want_av, rtol=TRAJ_RTOL)


@pytest.mark.parametrize("depth", fused_depth.DEPTHS)
@pytest.mark.parametrize("ny,nx,tile", [
    (32, 32, None), (30, 17, (7, 5)), (12, 20, None), (5, 9, (3, 4)),
])
def test_emulation_is_bit_identical_to_multi_step(depth, ny, nx, tile):
    p = _params(ny, nx)
    rng = np.random.default_rng(ny * nx + depth)
    cells = rng.uniform(0.01, 0.2, (9, ny, nx)).astype(np.float32)
    cells[7, ny - 2, rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    mask = torch.from_numpy(rng.random((ny, nx)) < 0.15)
    c = torch.from_numpy(cells)
    args = (mask, p.accel_w1, p.accel_w2, p.omega, depth)
    got, got_tots = fused_depth.fused_depth_emulated(c, *args, tile)
    want, want_tots = ref_ops.multi_step(c, *args)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_tots.numpy(), want_tots.numpy(),
                               rtol=SUM_RTOL)


def _random_case(ny, nx, seed):
    p = _params(ny, nx)
    rng = np.random.default_rng(seed)
    eq = initial_state_np(p)
    cells = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    cells[7, ny - 2, rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    mask = torch.from_numpy(rng.random((ny, nx)) < 0.15)
    return torch.from_numpy(cells), (mask, p.accel_w1, p.accel_w2, p.omega)


@pytest.mark.parametrize("depth", fused_depth.DEPTHS)
@pytest.mark.parametrize("ny,nx", [(32, 32), (30, 17), (50, 70)])
def test_a_steps_tot_u_does_not_depend_on_its_stage(depth, ny, nx):
    """Step t + 1 .. t + D - 1 are stages 2 .. D of a launch at step t
    and stages 1 .. D - 1 of a launch at step t + 1: the same bits, since
    the owned cells are summed at a fixed place of the window."""
    c, args = _random_case(ny, nx, depth + ny)
    _, here = fused_depth.fused_depth_emulated(c, *args, depth)
    shifted, _ = ref_ops.multi_step(c, *args, 1)
    _, later = fused_depth.fused_depth_emulated(shifted, *args, depth)
    assert torch.equal(here[1:], later[:-1])


@pytest.mark.parametrize("ny,nx", [(32, 32), (30, 17), (50, 70)])
def test_the_depths_auto_plans_share_tile_and_sum(ny, nx):
    """D = 2 (a tail) sums a step as D = 4 (the main segment) does: one
    tile shape and one x-halo, so chunked runs keep av_vels' bits."""
    assert fused_depth.TILES[2] == fused_depth.TILES[4]
    assert fused_depth.HALO_X[2] == fused_depth.HALO_X[4]
    c, args = _random_case(ny, nx, ny)
    new4, tots4 = fused_depth.fused_depth_emulated(c, *args, 4)
    mid, tots2a = fused_depth.fused_depth_emulated(c, *args, 2)
    new2, tots2b = fused_depth.fused_depth_emulated(mid, *args, 2)
    assert torch.equal(new2, new4)
    assert torch.equal(torch.cat([tots2a, tots2b]), tots4)


@pytest.mark.parametrize("depth", fused_depth.DEPTHS)
def test_garbage_outside_a_stage_never_reaches_an_owned_cell(depth):
    """Every stage runs on the whole window and leaves NaN outside its
    valid region. With the narrowest window that is legal (an x-halo of
    D) the owned tile is still finite and bit-identical to the plain
    version; a narrower halo is refused."""
    c, args = _random_case(30, 44, depth)
    want, _ = ref_ops.multi_step(c, *args, depth)
    for hx in (depth, fused_depth.HALO_X[depth]):
        got, tots = fused_depth.fused_depth_emulated(c, *args, depth,
                                                     halo_x=hx)
        assert torch.isfinite(got).all() and torch.isfinite(tots).all()
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="narrower"):
        fused_depth.fused_depth_emulated(c, *args, depth, halo_x=depth - 1)


def test_cpu_wrapper_is_the_plain_version():
    p = _params(24, 40)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 24, 40)).astype(np.float32))
    mask = torch.from_numpy(generate_obstacles(40, 24))
    kernel = fused_depth.FusedDepth(mask, p.accel_w1, p.accel_w2, p.omega, 4)
    assert kernel.steps_per_call == 4
    b = torch.empty_like(a)
    av = torch.full((10,), -1.0)
    before = dict(fused.LAUNCHES)
    new, spare = kernel.run(a, b, av, 3, 0.5)
    assert new is b and spare is a
    want, want_tots = ref_ops.multi_step(a, mask, p.accel_w1, p.accel_w2,
                                         p.omega, 4)
    assert torch.equal(b, want)
    assert torch.equal(av[3:7], want_tots * 0.5)
    assert (av[:3] == -1).all() and (av[7:] == -1).all()
    assert fused.LAUNCHES == before, "no kernel launches on the CPU"
    got, tots = fused_depth.fused_depth(a, mask, p.accel_w1, p.accel_w2,
                                        p.omega, 4)
    assert torch.equal(got, want) and torch.equal(tots, want_tots)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    mask = torch.from_numpy(generate_obstacles(16, 8))
    with pytest.raises(ValueError, match="depth"):
        fused_depth.FusedDepth(mask, 1e-5, 1e-6, 1.85, 3)
    kernel = fused_depth.FusedDepth(mask, 1e-5, 1e-6, 1.85, 2)
    a, b = torch.ones(9, 8, 16), torch.empty(9, 8, 16)
    with pytest.raises(ValueError, match="slice"):
        kernel.run(a, b, torch.empty(5), 4)  # out[4:6] of 5
    with pytest.raises(ValueError, match="distinct"):
        kernel.run(a, a, torch.empty(5), 0)


# The flow form: K rounds of D = 4 steps a launch (csrc/fused_depth_flow.cu).


@pytest.mark.parametrize("rounds", [2, 3, 25])
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
def test_k_round_run_equals_k_single_round_runs(rounds, axis):
    """A K-round ``run`` on the CPU gives the cells and every step's
    tot_u of K single-round runs, bit for bit, and hands back the
    buffers as K single-round runs leave them: the result in ``b`` after
    an odd K, in ``a`` after an even one."""
    c, (mask, w1, w2, omega) = _random_case(30, 44, rounds)
    if axis:
        c, mask = transpose_state(c), mask.T.contiguous()
    flow = fused_depth.FusedDepth(mask, w1, w2, omega, 4, axis, rounds)
    one = fused_depth.FusedDepth(mask, w1, w2, omega, 4, axis)
    assert flow.steps_per_call == 4 * rounds and flow.rounds == rounds
    av_flow = torch.full((4 * rounds + 2,), -1.0)
    av_one = av_flow.clone()
    a, b = c.clone(), torch.empty_like(c)
    got, spare = flow.run(a, b, av_flow, 1, 0.5)
    assert (got, spare) == ((b, a) if rounds % 2 else (a, b))
    bufs = [c.clone(), torch.empty_like(c)]
    for k in range(rounds):
        bufs[:] = one.run(bufs[0], bufs[1], av_one, 1 + 4 * k, 0.5)
    assert torch.equal(got, bufs[0])
    assert torch.equal(av_flow, av_one)
    assert flow.n_tiles == (2 * 2 if axis == 0 else 2 * 1)
    assert flow.flow_tiles == (rounds - 1) * flow.n_tiles
    assert flow.waits() == 0 and one.flow_tiles == 0


def test_the_flow_form_runs_depth_4_only():
    mask = torch.from_numpy(generate_obstacles(16, 8))
    for depth in (2, 8):
        with pytest.raises(ValueError, match="flow form"):
            fused_depth.FusedDepth(mask, 1e-5, 1e-6, 1.85, depth, rounds=2)
    with pytest.raises(ValueError, match="flow form"):
        fused_depth.FusedDepth(mask, 1e-5, 1e-6, 1.85, 4, rounds=0)


def _window_owners(n, tile, halo, b):
    """The tiles owning a cell of tile b's window, by brute force."""
    return {(y % n) // tile
            for y in range(b * tile - halo, (b + 1) * tile + halo)}


@pytest.mark.parametrize("n", [1, 5, 24, 25, 26, 27, 28, 31, 32, 47, 50, 73,
                               96, 100, 130, 242, 1000, 1024, 1026])
@pytest.mark.parametrize("tile,halo", [(24, 4), (32, 4)])
def test_flow_reach_holds_every_dependency_both_ways(n, tile, halo):
    """Every tile whose cells a tile's window reads, and every tile whose
    window reads its cells, lies within the reach of it, and the reach is
    the least that holds them (the tile count where a window covers the
    axis)."""
    tiles = -(-n // tile)
    reach = fused_depth.flow_reach(n, tile, halo)

    def dist(a, b):
        d = (a - b) % tiles
        return min(d, tiles - d)

    pairs = {(b, o) for b in range(tiles)
             for o in _window_owners(n, tile, halo, b)}
    pairs |= {(o, b) for b, o in pairs}
    assert all(dist(b, o) <= reach for b, o in pairs)
    if tile + 2 * halo >= n:
        assert reach == tiles
    else:
        assert reach == max(dist(b, o) for b, o in pairs)
        assert reach >= 1 or tiles == 1
    if n % tile == 0 or n % tile >= halo:
        assert reach <= 1 or 2 * reach + 1 >= tiles


class FlowHazard(AssertionError):
    """A block of :func:`flow_schedule_emulated` read a cell of a version
    other than its round's input, or published a tile partial into a slot
    whose partial of two rounds before was not yet summed."""


def flow_schedule_emulated(ny: int, nx: int, rounds: int, slots: int,
                           seed: int, reach=None,
                           sum_wait: bool = True) -> int:
    """The flow form's schedule (``csrc/fused_depth_flow.cu``) at D =
    ``fused_depth.FLOW_DEPTH`` in plain Python, with each cell of the two
    buffers holding the version of the lattice it is (0 in a, none in b)
    and each partial slot the round whose partial it holds. Blocks take
    tickets in the order they start, at most ``slots`` at once; the tile
    of a ticket is the kernel's walk. A block of round r > 0 waits until
    every tile within ``reach`` (default ``fused_depth.flow_reach`` by
    axis, ``(rows, columns)``) has finished round r - 1 and, from round 2
    on (unless not ``sum_wait``), until round r - 2 is summed; then reads
    its window (the version r of every cell, or :class:`FlowHazard`);
    then, later, writes version r + 1 of its owned cells into the other
    buffer, publishes its partial into its slot of the round's parity
    (which must be empty) and counts its round. The round's last ticket
    then sums the round, once every partial of it is in and every round
    before is summed, emptying the slots. Running blocks take their
    events in an order drawn from ``seed``; a schedule in which no block
    can move raises. Returns the flowing blocks whose first look found a
    counter behind."""
    depth = fused_depth.FLOW_DEPTH
    ty, tx = fused_depth.TILES[depth]
    hy, hx = depth, fused_depth.HALO_X[depth]
    tiles_y, tiles_x = -(-ny // ty), -(-nx // tx)
    n = tiles_y * tiles_x
    ry, rx = reach or (fused_depth.flow_reach(ny, ty, hy),
                       fused_depth.flow_reach(nx, tx, hx))

    def near(b, r_, m):
        return range(m) if 2 * r_ + 1 >= m else [
            (b + j) % m for j in range(-r_, r_ + 1)]

    def tile_of(i, r):
        return (i + ((tiles_y // 2) * tiles_x if r % 2 else 0)) % n

    def ready(r, tile):
        by, bx = divmod(tile, tiles_x)
        return (not sum_wait or r < 2 or summed >= r - 1) and all(
            done[y * tiles_x + x] >= r for y in near(by, ry, tiles_y)
            for x in near(bx, rx, tiles_x))

    version = np.full((2, ny, nx), -1)
    version[0] = 0
    partial = np.full((2, n), -1)
    done = np.zeros(n, dtype=int)
    rng = random.Random(seed)
    running, next_ticket, waits, summed = [], 0, 0, 0
    # A block: [round, tile, state, first look, last of its round]; states
    # 0 wait, 1 read, 2 write and publish, 3 sum.
    while running or next_ticket < rounds * n:
        while len(running) < slots and next_ticket < rounds * n:
            r, i = divmod(next_ticket, n)
            running.append([r, tile_of(i, r), 0, True, i == n - 1])
            next_ticket += 1
        movable = []
        for blk in running:
            r, tile, state, first, _ = blk
            if state == 0:
                ok = r == 0 or ready(r, tile)
                if r > 0 and first:
                    waits += not ok
                    blk[3] = False
            else:
                ok = state < 3 or (summed == r
                                   and (partial[r % 2] == r).all())
            if ok:
                movable.append(blk)
        if not movable:
            raise RuntimeError("no block of the flow schedule can move")
        blk = rng.choice(movable)
        r, tile, state, _, last = blk
        by, bx = divmod(tile, tiles_x)
        if state == 1:
            rows = np.arange(by * ty - hy, (by + 1) * ty + hy) % ny
            cols = np.arange(bx * tx - hx, (bx + 1) * tx + hx) % nx
            seen = version[r % 2][np.ix_(rows, cols)]
            if (seen != r).any():
                raise FlowHazard(f"round {r} tile {tile} read versions "
                                 f"{sorted(set(seen.ravel().tolist()))}")
        elif state == 2:
            version[(r + 1) % 2, by * ty:(by + 1) * ty,
                    bx * tx:(bx + 1) * tx] = r + 1
            if partial[r % 2, tile] != -1:
                raise FlowHazard(f"round {r} tile {tile} published over "
                                 f"round {partial[r % 2, tile]}'s partial")
            partial[r % 2, tile] = r
            done[tile] += 1
            if not last:
                running.remove(blk)
                continue
        elif state == 3:
            partial[r % 2] = -1
            summed += 1
            running.remove(blk)
            continue
        blk[2] += 1
    return waits


@pytest.mark.parametrize("ny,nx,slots", [
    *((ny, nx, slots)
      for ny, nx in ((100, 130), (242, 96), (26, 40), (24, 32), (50, 33),
                     (130, 64), (1000, 40), (40, 1000))
      for slots in (3, 40, 10000)),
    (1024, 1024, 3), (1024, 1024, 40)],
    ids=lambda v: str(v))
def test_flow_schedule_reads_each_rounds_input(ny, nx, slots):
    """The flow schedule's blocks, in seeded orders and at few and at
    unbounded slots, each read their round's input in every cell of the
    window (never the round before's, never the round after's) and the
    launch ends: tiles_x 1 and 2, rows not a multiple of 24, ragged last
    tiles thinner than the halo, lattices smaller than a window."""
    for seed in range(3):
        waits = flow_schedule_emulated(ny, nx, 4, slots, seed)
        assert 0 <= waits <= 3 * fused_depth.n_tiles(ny, nx, 4)


@pytest.mark.parametrize("ny,nx,reach", [
    (128, 128, (0, 1)), (128, 128, (1, 0)),
    # The ragged last tile row holds 2 rows, fewer than the halo's 4.
    (242, 96, (1, 1)),
    (100, 130, (1, 1))])
def test_flow_schedule_catches_a_reach_too_short(ny, nx, reach):
    """One tile less of reach than flow_reach gives, along either axis,
    lets some seeded order read a cell of the wrong round."""
    assert reach < (fused_depth.flow_reach(ny, 24, 4),
                    fused_depth.flow_reach(nx, 32, 4))
    hazards = 0
    for seed in range(8):
        try:
            flow_schedule_emulated(ny, nx, 3, 10000, seed, reach)
        except FlowHazard:
            hazards += 1
    assert hazards


def test_flow_schedule_catches_a_slot_reused_before_its_sum():
    """Without the wait for round r - 2's sum, a block of round r can
    publish its partial over one that is not yet summed."""
    hazards = 0
    for seed in range(4):
        try:
            flow_schedule_emulated(240, 320, 4, 10000, seed,
                                               sum_wait=False)
        except FlowHazard as e:
            hazards += "published over" in str(e)
    assert hazards
