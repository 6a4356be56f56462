"""The one-step seam kernel's path on the CPU: the halo plan
(:func:`lbm_tpu_torch.parallel.halo.halo_sources`), halos read in place
against halos copied, the wrap pad's row read from the south halo, and a
model of the kernel's in-launch tot_u sum.

``SeamShardImpl`` on ``[cpu] * n`` meshes runs each shard's
:class:`lbm_tpu_torch.ops.fused.SeamStep` on its plain version, on the
halo views the plan gives (rows of the neighbours' lattices in place, or
the receiver's buffers where the plan copies), so the plan, the views and
the ordering of the swaps are the ones the card runs.

Bounds (ROADMAP section 3): the port against its own plain version and
the in-place form against the copy form bit for bit; against the JAX
package's sharded runs (``kernel="pallas"`` in interpret mode) at rtol
1e-4 (XLA's jit moves the f32 trajectory by ulps); the sum model against
a float64 sum within 1e-6 relative (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.runner import run_simulation as jrun
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import fused
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp, halo
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

CPU = torch.device("cpu")
TRAJ_RTOL, SUM_RTOL = 1e-4, 1e-6
STEPS = 20
# csrc/fused_step.cu: a seam tile is kSeamRows * kBY rows (by forcing
# axis: one row a thread in row mode, two in column mode) by kBX columns;
# lbm_reduce.cuh sums the tiles' partials kReduceWidth wide.
TILE_ROWS, TILE_COLS, WARP, REDUCE_WIDTH = {0: 8, 1: 16}, 32, 32, 256


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_RESIDENT"):
        monkeypatch.delenv(k, raising=False)


def _params(nx, ny, iters=STEPS):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _jparams(p):
    from lbm_tpu.params import Params as JParams

    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters,
                   reynolds_dim=p.reynolds_dim, density=p.density,
                   accel=p.accel, omega=p.omega, dtype=p.dtype)


def _mesh(n):
    return decomp.make_mesh(n, devices=[CPU] * n)


def _never(recv, send):
    return False


def _shard_set(nx, ny, n, walls, seed=3, axis=0, iters=STEPS):
    """A perturbed state of an NXxNY scene over ``n`` CPU shards, padded
    as the planner pads it: ``(plan, shard set)``. ``walls`` False is a
    wall-less random mask, which wrap-pads where ny does not divide."""
    rng = np.random.default_rng(seed)
    p = _params(nx, ny, iters)
    mask = generate_obstacles(nx, ny) if walls else rng.random((ny, nx)) < 0.1
    mesh = _mesh(n)
    sp = halo.plan_run(p, mask, mesh, "cuda", iters)
    cells = initial_state(sp.params).numpy()
    cells = cells * (1 + 0.2 * (rng.random(cells.shape) - 0.5))
    cells[6, sp.params.ny - 2, rng.random(nx) < 0.3] = np.float32(
        sp.params.accel_w2)
    c = torch.from_numpy(cells.astype(np.float32))
    return sp, halo.ShardSet(sp.params, c, sp.obstacles, mesh, iters, axis)


# --------------------------------------------------------------------------
# The halo plan.
# --------------------------------------------------------------------------


def _rows_sent(ss, r, k, wrap_pad):
    """The global rows of shard ``r``'s (south, north) halos as the
    exchange sends them: the south neighbour's top k rows, the north
    neighbour's bottom k rows, and from shard 0 rows wrap_pad ..
    instead of its first rows when wrap-padded (lbm_tpu/parallel/halo.py:
    291-306)."""
    n, h = len(ss.shards), ss.h
    south, north = (r - 1) % n, (r + 1) % n
    lo = wrap_pad if wrap_pad and north == 0 else 0
    return ([south * h + h - k + i for i in range(k)],
            [north * h + lo + i for i in range(k)])


@pytest.mark.parametrize("case", [
    # (nx, ny, shards, axis, k, wrap_pad)
    *((64, 64, 4, 0, 1, w) for w in range(0, 16)),
    (64, 64, 4, 0, 4, 0), (64, 16, 8, 0, 1, 0), (64, 16, 8, 0, 2, 0),
    (128, 16, 4, 1, 1, 0), (128, 16, 4, 1, 8, 0), (64, 16, 8, 1, 1, 0),
], ids=lambda c: "x{}x{}/{}-axis{}-k{}-wrap{}".format(*c))
def test_halo_sources_name_the_rows_the_exchange_sends(case):
    """For every shard position, the row plan and the x-plan, one-row
    and deeper halos and wrap pads 1 .. h-1: the plan's sender and rows
    are those the exchange sends (and the static halo mask rows describe),
    one-row halos are read in place with the sender's plane stride, deeper
    ones and unreachable senders are copied with the buffer's."""
    nx, ny, n, axis, k, wrap_pad = case
    _, ss = _shard_set(nx, ny, n, True, axis=axis)
    h, lanes = ss.h, ss.nx
    assert wrap_pad <= h - 1
    for reach, in_place in ((halo.reachable, k == 1), (_never, False)):
        plan = halo.halo_sources(ss, k, wrap_pad, reach)
        assert len(plan) == n
        for r, pair in enumerate(plan):
            want_rows = _rows_sent(ss, r, k, wrap_pad)
            masks = ss.halo_masks(r, k, wrap_pad)
            for src, rows, m in zip(pair, want_rows, masks):
                got = [src.shard * h + src.row + i for i in range(k)]
                assert got == rows, (r, src)
                assert src.in_place == in_place
                assert src.plane == (h if in_place else k) * lanes
                np.testing.assert_array_equal(m.numpy(), ss.mask_np[rows])


def test_views_alias_the_neighbours_rows_and_no_buffer_is_made():
    """In place, a shard's halos are views of its neighbours' current
    cells and no halo buffer is allocated; copied, they are buffers
    filled with the same rows."""
    _, ss = _shard_set(64, 62, 4, False)
    w, h = 2, ss.h
    impl = halo.SeamShardImpl(ss, 1, w)
    assert impl.halos == [(None, None)] * 4
    views = ss.halo_views(impl.sources, impl.halos, 1)
    for r, (hs, hn) in enumerate(views):
        south, north = ss.shards[(r - 1) % 4], ss.shards[(r + 1) % 4]
        assert hs.data_ptr() == south.cells[:, h - 1].data_ptr()
        lo = w if north.index == 0 else 0
        assert hn.data_ptr() == north.cells[:, lo].data_ptr()
        assert hs.stride(0) == h * ss.nx
    copied = halo.SeamShardImpl(ss, 1, w, reach=_never)
    ss.exchange(copied.sources, copied.halos, 1)
    for (hs, hn), (cs, cn) in zip(views, copied.halos):
        assert cs.is_contiguous() and cs.stride(0) == ss.nx
        assert torch.equal(cs, hs) and torch.equal(cn, hn)


def test_the_wrap_pad_row_reads_the_south_halo():
    """Shard 0's kernel under the wrap discipline reads its pad row p-1
    from its south halo row (what the plain shard step copies in), and
    no other shard's does."""
    sp, ss = _shard_set(64, 62, 4, False)
    impl = halo.SeamShardImpl(ss, 1, sp.wrap_pad)
    assert sp.wrap_pad == 2
    assert [k.wrap_row for k in impl.kernels] == [1, -1, -1, -1]
    with pytest.raises(ValueError, match="wrap_row"):
        k = impl.kernels[0]
        fused.SeamStep(k.mask, k.hmask_s, k.hmask_n, k.w1, k.w2, k.omega,
                       k.row0, k.ny, wrap_row=ss.h)


# --------------------------------------------------------------------------
# In place against copied, against the plain shard steps and JAX.
# --------------------------------------------------------------------------

SCENES = {"64x62-wall-less-wrap": (64, 62, False),
          "64x64-walls": (64, 64, True)}


def _run(ss, impl, steps=STEPS):
    for t in range(steps):
        impl.run(t)
    return ss.gather(), ss.av_vels(1.0)


@pytest.mark.parametrize("scene", list(SCENES))
def test_in_place_equals_copied_and_the_plain_shard_steps(scene):
    """20 one-step calls over 4 shards with halos read in place, the same
    with every halo copied, and 20 plain shard steps: the same cells bit
    for bit; tots the same bits between the two forms (the same sums)
    and at 1e-5 against the plain steps (another order)."""
    nx, ny, walls = SCENES[scene]
    sp, ss = _shard_set(nx, ny, 4, walls)
    w = sp.wrap_pad
    assert (w == 2) == (not walls)
    _, copied_ss = _shard_set(nx, ny, 4, walls)
    _, plain_ss = _shard_set(nx, ny, 4, walls)
    got, got_av = _run(ss, halo.SeamShardImpl(ss, 1, w))
    cop, cop_av = _run(copied_ss,
                       halo.SeamShardImpl(copied_ss, 1, w, reach=_never))
    want, want_av = _run(plain_ss, halo.ReferenceShardImpl(plain_ss, w))
    assert torch.equal(got, cop) and torch.equal(got_av, cop_av)
    assert torch.equal(got[:, sp.pad:], want[:, sp.pad:])
    np.testing.assert_allclose(got_av.numpy(), want_av.numpy(), rtol=1e-5)


@pytest.mark.parametrize("scene", list(SCENES))
def test_the_one_step_seam_path_matches_jax(scene, monkeypatch):
    """The planned one-step sharded run over 4 CPU shards against the JAX
    package's (``_WrapPallasShardImpl`` under the wrap pad, else
    ``_PallasShardImpl`` pinned to one step), in interpret mode: cells and
    av_vels at rtol 1e-4."""
    nx, ny, walls = SCENES[scene]
    monkeypatch.setenv("LBM_PALLAS_DEPTH", "1")
    p = _params(nx, ny)
    mask = generate_obstacles(nx, ny) if walls else np.zeros((ny, nx), bool)
    mask[ny // 2, nx // 3] = True
    if walls:
        jmesh = jdecomp.make_mesh(4)
    else:
        jmesh, _ = jhalo.resolve_mesh(_jparams(p), mask, 4, "pallas",
                                      backend="cpu")
        assert jmesh.shape["y"] == 4
    mesh = _mesh(4)
    sp = halo.plan_run(p, mask, mesh, "cuda", STEPS)
    assert [s.describe() for s in sp.segments] == [f"step x{STEPS}"]
    assert sp.wrap_pad == (0 if walls else 2)
    sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, CPU),
                                 sp.obstacles, mesh, sp.kernel, STEPS,
                                 sp.wrap_pad)
    sim.run()
    cells, av = sim.result()
    want = jrun(_jparams(p), mask, kernel="pallas", mesh=jmesh)
    np.testing.assert_allclose(av.numpy(), want.av_vels, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(cells[:, sp.pad:].numpy(), want.cells,
                               rtol=TRAJ_RTOL)


@pytest.mark.parametrize("sizes", [(7, 13), (10, 10), (1, 19)],
                         ids=["7+13", "10+10", "1+19"])
def test_wrap_path_chunked_equals_single_shot(sizes):
    """On the wrap path every step is a one-step call, so a run cut into
    chunks gives the single-shot run's cells and av_vels bit for bit."""
    p = _params(64, 62)
    mask = np.random.default_rng(4).random((62, 64)) < 0.1
    mesh = _mesh(4)
    sp = halo.plan_run(p, mask, mesh, "cuda", STEPS)
    assert sp.mode == "wrap"
    c0 = initial_state(sp.params, CPU)
    args = (sp.params, c0, sp.obstacles, mesh, sp.kernel, STEPS, sp.wrap_pad)
    single = halo.ShardedSimulation(*args)
    single.run()
    chunked = halo.ShardedSimulation(*args, sizes=list(sizes))
    t = 0
    for n in sizes:
        chunked.run_chunk(t, n)
        t += n
    for a, b in zip(single.result(), chunked.result()):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# The in-launch tot_u sum.
# --------------------------------------------------------------------------


def _butterfly(v):
    """A warp's __shfl_xor_sync sum over its last axis of 32 lanes:
    every lane ends with the same bits; lane 0's."""
    v = v.astype(np.float32)
    lanes = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v[..., 0]


def in_launch_sum(umag, axis=0, scale=1.0):
    """The seam kernel's tot_u in plain numpy, in its order: a tile of
    TILE_ROWS[axis] x TILE_COLS cells per block, in row-major order of the
    tiles; thread (ty, tx) adds rows ty, ty + 8, ... of column tx from
    0.0; a butterfly adds each warp (one row of threads); thread 0 adds
    the 8 warps in order into the tile's partial. Then lbm_sum_rows:
    thread t < REDUCE_WIDTH adds partials t, t + REDUCE_WIDTH, ... from
    0.0, a butterfly adds each warp, one thread adds the warps in
    order."""
    h, nx = umag.shape
    rows = TILE_ROWS[axis]
    gy, gx = -(-h // rows), -(-nx // TILE_COLS)
    u = np.zeros((gy * rows, gx * TILE_COLS), np.float32)
    u[:h, :nx] = umag
    tiles = u.reshape(gy, rows // 8, 8, gx, TILE_COLS)
    acc = np.zeros((gy, 8, gx, TILE_COLS), np.float32)
    for r in range(rows // 8):
        acc = (acc + tiles[:, r]).astype(np.float32)
    warps = _butterfly(acc)  # (gy, 8, gx)
    part = np.zeros((gy, gx), np.float32)
    for wi in range(8):
        part = (part + warps[:, wi]).astype(np.float32)
    part = part.ravel()
    per = np.zeros(REDUCE_WIDTH, np.float32)
    for p0 in range(0, part.size, REDUCE_WIDTH):
        chunk = part[p0:p0 + REDUCE_WIDTH]
        per[:chunk.size] = (per[:chunk.size] + chunk).astype(np.float32)
    wtot = _butterfly(per.reshape(-1, WARP))
    tot = np.float32(0)
    for v in wtot:
        tot = np.float32(tot + v)
    return np.float32(tot * np.float32(scale))


@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
@pytest.mark.parametrize("shape", [(256, 1024), (62, 64), (16, 130),
                                   (4096, 32), (1, 96)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_in_launch_sum_order_against_a_float64_sum(shape, axis):
    """The model of the kernel's sum at shard shapes of the row plan, the
    x-plan and a ragged edge, in both forcing modes' tiles: within 1e-6
    of the float64 sum, and its order (so its bits) fixed by the shape
    and mode alone."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    umag = rng.uniform(0.0, 0.1, shape).astype(np.float32)
    umag[rng.random(shape) < 0.15] = 0.0  # obstacles add nothing
    got = in_launch_sum(umag, axis)
    want = float(torch.sum(torch.from_numpy(umag).double()))
    assert abs(float(got) - want) <= SUM_RTOL * want
    assert in_launch_sum(umag.copy(), axis) == got
    assert in_launch_sum(umag, axis, 0.5) == np.float32(got * np.float32(0.5))


def test_seam_step_ab_script_needs_a_card(capsys):
    """scripts/seam_step_ab_torch.py measures on a card only: without one
    it exits 2 before building or printing a result. Its shapes are the
    prediction's four, the wrap shape wall-less."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parent.parent / "scripts"
            / "seam_step_ab_torch.py")
    spec = importlib.util.spec_from_file_location("seam_step_ab_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [(s, k) for s, k, _ in mod.SHAPES] == [
        ("1024x1024", "scene"), ("16384x1024", "walls"),
        ("131072x128", "walls"), ("1024x1022", "random")]
    assert mod.main(["--kept-only"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
