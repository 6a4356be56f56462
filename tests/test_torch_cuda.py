"""The CUDA kernels against their plain versions, on the card. Skips
where no CUDA device is present. This file imports no jax, so on a machine
without it run it alone, without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import fused, fused_depth, resident
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

RTOL, ATOL, TOT_RTOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4, 1e-4

MODES = {
    "paired": {},
    "reference_order": {"LBM_PAIRED_EQ": "0"},
    "omega_absorbed": {"LBM_OMEGA_EQ": "1"},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(nx, ny, walls, seed=0, perturbed=False):
    """A seeded state, uniform in [0.01, 0.2] (held for one step only:
    at omega 1.85 it is unstable) or, ``perturbed``, the equilibrium at
    rest with each value moved by up to +-10 % (stable over many
    steps), and its mask."""
    p = Params(nx=nx, ny=ny, max_iters=200, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    rng = np.random.default_rng(seed)
    cells = rng.uniform(0.01, 0.2, (9, ny, nx)).astype(np.float32)
    if perturbed:
        eq = initial_state(p).numpy()
        cells = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    cells[6, ny - 2, rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    mask = generate_obstacles(nx, ny) if walls else rng.random((ny, nx)) < 0.15
    return p, cells, mask


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [(128, 128, True), (130, 100, False)],
                         ids=["128x128", "130x100-wall-less"])
def test_kernel_step_matches_plain(cuda, shape, mode, monkeypatch):
    monkeypatch.delenv("LBM_PAIRED_EQ", raising=False)
    monkeypatch.delenv("LBM_OMEGA_EQ", raising=False)
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    p, cells, mask = _case(*shape)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    args = (m, p.accel_w1, p.accel_w2, p.omega)
    before = fused.LAUNCHES["step"]
    got, got_tot = fused.fused_step(c, *args)
    want, want_tot = fused.fused_step_plain(c, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["step"] == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert np.isclose(float(got_tot), float(want_tot), rtol=TOT_RTOL)


@pytest.mark.cuda
def test_kernel_trajectory_matches_plain_and_is_deterministic(cuda):
    from lbm_tpu_torch.runner import simulate

    p, _, mask = _case(128, 128, True)
    m = torch.from_numpy(mask).to(cuda)
    c0 = initial_state(p, cuda)
    ck, ak = simulate(p, c0, m, kernel="cuda")
    ck2, ak2 = simulate(p, c0, m, kernel="cuda")
    cr, ar = simulate(p, c0, m, kernel="reference")
    assert torch.equal(ck, ck2) and torch.equal(ak, ak2)
    np.testing.assert_allclose(ak.cpu().numpy(), ar.cpu().numpy(),
                               rtol=TRAJ_RTOL)


def _set_mode(monkeypatch, mode):
    monkeypatch.delenv("LBM_PAIRED_EQ", raising=False)
    monkeypatch.delenv("LBM_OMEGA_EQ", raising=False)
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", [128, 256], ids=["128x128", "256x256"])
@pytest.mark.parametrize("kernel,steps", [
    ("depth", 2), ("depth", 4), ("depth", 8), ("resident", 16),
    ("resident", 5), ("resident_onchip", 16), ("resident_onchip", 5),
], ids=["depth-2", "depth-4", "depth-8", "resident-16", "resident-5",
        "resident-onchip-16", "resident-onchip-5"])
def test_many_step_kernel_matches_multi_step(cuda, grid, mode, kernel, steps,
                                              monkeypatch):
    """Each many-step kernel, the resident kernel in both forms
    ("resident": the device-memory form); both resident forms give the
    plain version's cells bit for bit."""
    _set_mode(monkeypatch, mode)
    p, cells, mask = _case(grid, grid, True, seed=grid + steps, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    args = (m, p.accel_w1, p.accel_w2, p.omega, steps)
    before = dict(fused.LAUNCHES)
    if kernel == "depth":
        got, got_tots = fused_depth.fused_depth(c, *args)
    else:
        form = "onchip" if kernel == "resident_onchip" else "device"
        got, got_tots = resident.resident(c, *args, form=form)
    want, want_tots = fused_depth.fused_depth_plain(c, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[kernel] == before[kernel] + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    if kernel in ("resident", "resident_onchip"):
        assert torch.equal(got, want)
    np.testing.assert_allclose(got_tots.cpu().numpy(),
                               want_tots.cpu().numpy(), rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [
    {"LBM_RESIDENT": "1"}, {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "4"},
    {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "8"},
], ids=["resident", "depth-4", "depth-8"])
def test_planned_runs_match_the_step_kernel(cuda, env, monkeypatch):
    """203 steps (a main segment and a tail) through the runner: the
    same cells as the one-step kernel, av_vels within the trajectory
    bound, and bit-identical repeats."""
    from lbm_tpu_torch.runner import simulate

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    p, _, mask = _case(128, 128, True)
    m = torch.from_numpy(mask).to(cuda)
    c0 = initial_state(p, cuda)
    monkeypatch.setenv("LBM_RESIDENT", "0")
    monkeypatch.setenv("LBM_PALLAS_DEPTH", "1")
    ck, ak = simulate(p, c0, m, kernel="cuda", n_iters=203)
    monkeypatch.delenv("LBM_PALLAS_DEPTH")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cg, ag = simulate(p, c0, m, kernel="cuda", n_iters=203)
    cg2, ag2 = simulate(p, c0, m, kernel="cuda", n_iters=203)
    assert torch.equal(cg, cg2) and torch.equal(ag, ag2)
    np.testing.assert_allclose(cg.cpu().numpy(), ck.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ag.cpu().numpy(), ak.cpu().numpy(),
                               rtol=TRAJ_RTOL)


def _shard_case(cuda, nx, ny, n, walls=True, seed=0):
    """A perturbed state over ``n`` shards on one card, padded as the
    planner pads it, and a second copy for the plain version."""
    from lbm_tpu_torch.parallel import decomp, halo

    p, cells, mask = _case(nx, ny, walls, seed=seed, perturbed=True)
    mesh = decomp.make_mesh(n, devices=[cuda] * n)
    sp = halo.plan_run(p, mask, mesh, "cuda", 16)
    if sp.pad:
        pad_cells = initial_state(sp.params).numpy()
        pad_cells[:, sp.pad:] = cells
        cells = pad_cells
    c = torch.from_numpy(cells).to(cuda)
    sets = [halo.ShardSet(sp.params, c, sp.obstacles, mesh, 64)
            for _ in range(2)]
    return sp, sets


def _plain_steps(ss, n, wrap_pad=0):
    from lbm_tpu_torch.parallel import halo

    ref = halo.ReferenceShardImpl(ss, wrap_pad)
    for t in range(n):
        ref.run(t)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["step", "depth-2", "depth-4", "depth-8",
                                  "ring-16", "ring-18"])
@pytest.mark.parametrize("case", [(128, 128, 4, True), (64, 16, 8, True),
                                  (100, 130, 4, False), (128, 126, 4, True)],
                         ids=["128x128/4", "64x16/8", "100x130/4-wrap",
                              "128x126/4-wall-pad"])
def test_shard_kernels_match_the_plain_shard_step(cuda, kind, case,
                                                  monkeypatch):
    from lbm_tpu_torch.parallel import halo, resident_ring

    _set_mode(monkeypatch, "paired")
    nx, ny, n, walls = case
    sp, (ss, plain) = _shard_case(cuda, nx, ny, n, walls)
    name, _, size = kind.partition("-")
    steps = int(size or 1)
    if sp.wrap_pad and name != "step":
        pytest.skip(f"{kind} does not run under the wrap discipline")
    if name == "depth" and steps > ss.h:
        pytest.skip(f"{kind} does not run on {ss.h}-row shards")
    if name == "ring":
        impl = resident_ring.RingShardImpl(ss, steps)
        key = "ring"
    else:
        impl = halo.SeamShardImpl(ss, steps, sp.wrap_pad)
        key = "step_seam" if name == "step" else "depth_seam"
    before = dict(fused.LAUNCHES)
    impl.run(0)
    ss.synchronize()
    _plain_steps(plain, steps, sp.wrap_pad)
    if cuda.type == "cuda":
        launched = fused.LAUNCHES[key] - before[key]
        assert launched == (1 if key == "ring" else n)
    got, want = ss.gather()[:, sp.pad:], plain.gather()[:, sp.pad:]
    assert torch.equal(got, want)
    np.testing.assert_allclose(ss.av_vels(1.0)[:steps].cpu().numpy(),
                               plain.av_vels(1.0)[:steps].cpu().numpy(),
                               rtol=TOT_RTOL)


def _ring_sets(cuda, nx, ny, n, axis, copies=3):
    """``copies`` shard sets of one perturbed state over ``n`` shards on
    the card, for up to 128 steps: the row plan padded as planned, or the
    x-plan (``axis`` 1). Returns ``(pad, sets)``."""
    from lbm_tpu_torch.parallel import decomp, halo

    if axis == 0:
        sp, (ss, _) = _shard_case(cuda, nx, ny, n)
        return sp.pad, [halo.ShardSet(sp.params, ss.gather(), sp.obstacles,
                                      ss.mesh, 128) for _ in range(copies)]
    p, cells, mask = _case(nx, ny, True, perturbed=True)
    mesh = decomp.make_mesh(n, devices=[cuda] * n)
    c = torch.from_numpy(cells).to(cuda)
    return 0, [halo.ShardSet(p, c, mask, mesh, 128, axis=1)
               for _ in range(copies)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("g", [16, 18], ids=["G16-D4", "G18-D2"])
@pytest.mark.parametrize("plan", ["row", "x"])
def test_ring_rounds_equal_the_plain_steps_and_the_seam_depth_tots(
        cuda, plan, g, mode, monkeypatch):
    """The ring's D-step rounds in every association, row mode (128x128
    over 4: the forced row 126 in the top D rows that shard 3 sends) and
    column mode (the x-plan of 512x128): cells equal to G plain shard
    steps, and each shard's per-step tots the bits of the seam depth
    kernel's G / D calls at the same D."""
    from lbm_tpu_torch.parallel import halo, resident_ring

    _set_mode(monkeypatch, mode)
    axis = int(plan == "x")
    nx, ny = (512, 128) if axis else (128, 128)
    pad, (ss, plain, seam) = _ring_sets(cuda, nx, ny, 4, axis)
    ring = resident_ring.RingShardImpl(ss, g)
    assert ring.depth == (4 if g == 16 else 2)
    ring.run(0)
    depth = halo.SeamShardImpl(seam, ring.depth)
    for t in range(0, g, ring.depth):
        depth.run(t)
    ss.synchronize()
    seam.synchronize()
    _plain_steps(plain, g)
    assert torch.equal(ss.gather()[:, pad:], plain.gather()[:, pad:])
    assert torch.equal(ss.gather(), seam.gather())
    for a, b in zip(ss.shards, seam.shards):
        assert torch.equal(a.tots[:g], b.tots[:g])


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["row", "x"])
def test_ring_calls_go_on_from_each_other(cuda, plan):
    """Two calls of G=50 (25 rounds of D=2: an odd count, so the result
    changes buffer) equal 100 plain steps; one launch a call."""
    from lbm_tpu_torch.parallel import resident_ring

    axis = int(plan == "x")
    nx, ny = (512, 128) if axis else (128, 128)
    pad, (ss, plain) = _ring_sets(cuda, nx, ny, 4, axis, copies=2)
    ring = resident_ring.RingShardImpl(ss, 50)
    assert ring.depth == 2
    key = "ring_cols" if axis else "ring"
    before = fused.LAUNCHES[key]
    ring.run(0)
    ring.run(50)
    ss.synchronize()
    assert fused.LAUNCHES[key] == before + 2
    _plain_steps(plain, 100)
    assert torch.equal(ss.gather()[:, pad:], plain.gather()[:, pad:])
    np.testing.assert_allclose(ss.av_vels(1.0)[:100].cpu().numpy(),
                               plain.av_vels(1.0)[:100].cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [16, 18], ids=["G16-D4", "G18-D2"])
def test_ring_blocks_that_cannot_be_co_resident_raise(cuda, g):
    """A cooperative launch of more blocks than the card holds at once is
    refused; the wrapper raises and does not fall back."""
    from lbm_tpu_torch.parallel import resident_ring

    ss = _ring_sets(cuda, 128, 128, 4, 0, copies=1)[1][0]
    ring = resident_ring.RingShardImpl(ss, g, blocks=4096)
    with pytest.raises(RuntimeError, match="cooperative launch"):
        ring.run(0)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{}, {"LBM_SHARD_RESIDENT": "1"},
                                 {"LBM_PALLAS_DEPTH": "1"}],
                         ids=["auto", "ring", "step"])
def test_sharded_runs_equal_the_unsharded_kernel_run(cuda, env, monkeypatch):
    from lbm_tpu_torch.parallel import decomp
    from lbm_tpu_torch.runner import run_simulation

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_SHARD_RESIDENT"):
        monkeypatch.delenv(k, raising=False)
    p, _, mask = _case(128, 128, True)
    base = run_simulation(p, mask, n_iters=203)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh = decomp.make_mesh(4, devices=[cuda] * 4)
    a = run_simulation(p, mask, n_iters=203, mesh=mesh)
    b = run_simulation(p, mask, n_iters=203, mesh=mesh)
    np.testing.assert_array_equal(a.cells, base.cells)
    np.testing.assert_array_equal(a.cells, b.cells)
    np.testing.assert_array_equal(a.av_vels, b.av_vels)
    np.testing.assert_allclose(a.av_vels, base.av_vels, rtol=TRAJ_RTOL)


# The column modes (a wide grid's transposed lattice, physical row ny-2
# forced as the lattice's column ny-2): every kernel against its plain
# version in column mode, bit for bit.


def _wide_case(cuda, nx, ny, walls, seed=0, perturbed=False):
    """:func:`_case` of the physical NXxNY grid, transposed onto the card:
    the (9, nx, ny) lattice and its (nx, ny) mask."""
    from lbm_tpu_torch.state import transpose_state

    p, cells, mask = _case(nx, ny, walls, seed=seed, perturbed=perturbed)
    c = transpose_state(torch.from_numpy(cells)).to(cuda)
    m = torch.from_numpy(mask.T.copy()).to(cuda)
    return p, c, m


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["step", "depth-2", "depth-4", "depth-8",
                                  "resident-16", "resident_onchip-16"])
@pytest.mark.parametrize("shape", [(512, 128, True), (264, 100, False)],
                         ids=["512x128", "264x100-wall-less"])
def test_column_kernels_match_plain(cuda, shape, kind, mode, monkeypatch):
    _set_mode(monkeypatch, mode)
    name, _, size = kind.partition("-")
    steps = int(size or 1)
    p, c, m = _wide_case(cuda, *shape, perturbed=name != "step")
    args = (m, p.accel_w1, p.accel_w2, p.omega)
    before = dict(fused.LAUNCHES)
    if name == "step":
        got, got_tots = fused.fused_step(c, *args, axis=1)
        got_tots = got_tots[None]
    elif name == "depth":
        got, got_tots = fused_depth.fused_depth(c, *args, steps, axis=1)
    else:
        form = "onchip" if name == "resident_onchip" else "device"
        got, got_tots = resident.resident(c, *args, steps, axis=1, form=form)
    want, want_tots = fused_depth.fused_depth_plain(c, *args, steps, axis=1)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[name + "_cols"] == before[name + "_cols"] + 1
    assert fused.LAUNCHES[name] == before[name]
    assert torch.equal(got, want)
    np.testing.assert_allclose(got_tots.cpu().numpy(),
                               want_tots.cpu().numpy(), rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["step", "depth-2", "depth-4", "depth-8",
                                  "ring-16", "ring-18"])
@pytest.mark.parametrize("case", [(512, 128, 4, True), (64, 16, 8, True),
                                  (264, 100, 4, False)],
                         ids=["512x128/4", "64x16/8", "264x100/4-wall-less"])
def test_column_shard_kernels_match_the_plain_shard_step(cuda, kind, case,
                                                         monkeypatch):
    """The x-plan on a one-card mesh (built on request: the planner
    takes it above the resident kernel's size): each shard holds a block
    of physical columns, transposed; one call of each seam kernel and of
    the ring in column mode equals as many plain shard steps, bit for
    bit."""
    from lbm_tpu_torch.parallel import decomp, halo, resident_ring

    _set_mode(monkeypatch, "paired")
    nx, ny, n, walls = case
    p, cells, mask = _case(nx, ny, walls, perturbed=True)
    mesh = decomp.make_mesh(n, devices=[cuda] * n)
    c = torch.from_numpy(cells).to(cuda)
    ss, plain = (halo.ShardSet(p, c, mask, mesh, 64, axis=1) for _ in range(2))
    name, _, size = kind.partition("-")
    steps = int(size or 1)
    if name == "ring":
        impl, key = resident_ring.RingShardImpl(ss, steps), "ring_cols"
    else:
        impl = halo.SeamShardImpl(ss, steps)
        key = "step_seam_cols" if name == "step" else "depth_seam_cols"
    before = dict(fused.LAUNCHES)
    impl.run(0)
    ss.synchronize()
    _plain_steps(plain, steps)
    assert fused.LAUNCHES[key] - before[key] == (1 if key == "ring_cols"
                                                  else n)
    assert torch.equal(ss.gather(), plain.gather())
    np.testing.assert_allclose(ss.av_vels(1.0)[:steps].cpu().numpy(),
                               plain.av_vels(1.0)[:steps].cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{}, {"LBM_SHARD_RESIDENT": "1"},
                                 {"LBM_PALLAS_DEPTH": "1"}],
                         ids=["auto", "ring", "step"])
def test_x_sharded_runs_equal_the_unsharded_transposed_run(cuda, env,
                                                           monkeypatch):
    """2048x256 (a wide grid above the resident kernel's size) over 4
    shards on one card takes the x-plan; its cells equal the unsharded
    run's (transposed, column mode), which stays within the trajectory
    bound of the physical layout's run."""
    from lbm_tpu_torch.parallel import decomp
    from lbm_tpu_torch.runner import run_simulation, simulate

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_SHARD_RESIDENT"):
        monkeypatch.delenv(k, raising=False)
    p, _, mask = _case(2048, 256, True)
    base = run_simulation(p, mask, n_iters=203)
    m = torch.from_numpy(mask).to(cuda)
    c0 = initial_state(p, cuda)
    cp, ap = simulate(p, c0, m, kernel="cuda", n_iters=203, transposed=False)
    np.testing.assert_allclose(base.av_vels, ap.cpu().numpy(), rtol=TRAJ_RTOL)
    np.testing.assert_allclose(base.cells, cp.cpu().numpy(), rtol=RTOL,
                               atol=ATOL)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh = decomp.make_mesh(4, devices=[cuda] * 4)
    before = dict(fused.LAUNCHES)
    a = run_simulation(p, mask, n_iters=203, mesh=mesh)
    assert any(fused.LAUNCHES[k] > before[k] for k in
               ("step_seam_cols", "depth_seam_cols", "ring_cols"))
    np.testing.assert_array_equal(a.cells, base.cells)
    np.testing.assert_allclose(a.av_vels, base.av_vels, rtol=TRAJ_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "collide", "stream"])
@pytest.mark.parametrize("shape", [(128, 128, True), (130, 100, False)],
                         ids=["128x128", "130x100-wall-less"])
def test_probe_kernel_matches_plain(cuda, shape, mode, monkeypatch):
    """The stream-cost probe's three modes, 16 variant-steps in one
    launch: the plain version's bits in the cells, totals within the
    bound, one launch counted; full mode is the resident kernel without
    forcing."""
    from lbm_tpu_torch.ops import probe
    from lbm_tpu_torch.ops import reference as ref_ops

    _set_mode(monkeypatch, "paired")
    p, cells, mask = _case(*shape, seed=7, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    name = f"probe_{mode}"
    before = fused.LAUNCHES[name]
    got, tots = probe.probe(c, m, p.omega, 16, mode)
    want, want_tots = ref_ops.probe_multi_step(c, m, p.omega, 16, mode)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[name] == before + 1
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=TOT_RTOL)
    if mode == "full":
        same, _ = resident.resident(c, m, 0.0, 0.0, p.omega, 16)
        assert torch.equal(got, same)
    with pytest.raises(ValueError, match="even step count"):
        probe.probe(c, m, p.omega, 5, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("env", [
    {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "1"}, {"LBM_RESIDENT": "1"},
    {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "4"},
    {"LBM_RESIDENT": "0", "LBM_PALLAS_DEPTH": "8"},
], ids=["step", "resident", "depth-4", "depth-8"])
def test_chunked_and_resumed_runs_equal_single_shot(cuda, env, monkeypatch,
                                                    tmp_path):
    """240 steps under each kernel: chunks of 80 (whole launches of every
    kernel) and a run checkpointed at 80 and resumed give the single-shot
    run's bits in the cells and the trajectory; chunks of 70 (each with a
    tail under another kernel) give its cells."""
    from lbm_tpu_torch.runner import run_simulation

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if env.get("LBM_RESIDENT") == "1":
        monkeypatch.setenv("LBM_RESIDENT_STEPS", "40")
    p, _, mask = _case(128, 128, True)
    base = run_simulation(p, mask, kernel="cuda", n_iters=240)
    chunked = run_simulation(p, mask, kernel="cuda", n_iters=240,
                             chunk_iters=80)
    ck = tmp_path / "ck.npz"
    half = run_simulation(p, mask, kernel="cuda", n_iters=80,
                          checkpoint_every=80, checkpoint_file=ck)
    assert half.completed_steps == 80 and not half.preempted
    resumed = run_simulation(p, mask, kernel="cuda", n_iters=240,
                             resume_from=ck)
    for run in (chunked, resumed):
        np.testing.assert_array_equal(run.cells, base.cells)
        np.testing.assert_array_equal(run.av_vels, base.av_vels)
    odd = run_simulation(p, mask, kernel="cuda", n_iters=240, chunk_iters=70)
    np.testing.assert_array_equal(odd.cells, base.cells)
    np.testing.assert_allclose(odd.av_vels, base.av_vels, rtol=TRAJ_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
@pytest.mark.parametrize("depth", [2, 4, 8])
def test_tot_u_is_summed_in_the_kernel(cuda, depth, axis):
    """A depth launch leaves scale * tot_u of each of its steps in
    ``out``: the block that started last sums the per-tile partials. Held
    against ``torch.sum`` of the same partials (another order: rtol 1e-6);
    no launch of the sum on the kernel's path."""
    from lbm_tpu_torch.state import transpose_state

    p, cells, mask = _case(264, 100, False, seed=5, perturbed=True)
    c, m = torch.from_numpy(cells).to(cuda), torch.from_numpy(mask).to(cuda)
    if axis:
        c, m = transpose_state(c), m.T.contiguous()
    w = (m, p.accel_w1, p.accel_w2, p.omega)
    rows = depth
    kernel = fused_depth.FusedDepth(*w, depth, axis)
    out = torch.full((rows + 2,), -1.0, device=cuda)
    before = fused.LAUNCHES["reduce"]
    for _ in range(3):  # every launch leaves the scratch ready for the next
        kernel.run(c, torch.empty_like(c), out, 1, 0.5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["reduce"] == before
    assert out[0] == -1 and out[-1] == -1
    partials = kernel._partials
    # Empty slots (all bits set), then the block counter at zero.
    words = kernel._scratch.view(torch.int32)[:partials.numel() + 1]
    assert (words[:-1] == -1).all() and words[-1] == 0
    np.testing.assert_allclose(out[1:-1].cpu().numpy(),
                               (partials.sum(1) * 0.5).cpu().numpy(),
                               rtol=1e-6)
    # The sum's order is fixed: a second launch gives the same bits.
    again = torch.empty_like(out)
    kernel.run(c, torch.empty_like(c), again, 1, 0.5)
    assert torch.equal(again[1:-1], out[1:-1])


@pytest.mark.cuda
def test_no_reduce_launch_on_a_depth_plan(cuda, monkeypatch):
    """202 steps under a depth plan (D = 4, on the card in the flow
    form's launches of 25 rounds, and a D = 2 tail): depth launches as
    planned and none of the tot_u sum, which the depth kernel runs in the
    launch. A 203rd step goes to the one-step kernel, whose sum is a
    launch of its own."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import simulate

    monkeypatch.delenv("LBM_RESIDENT_STEPS", raising=False)
    monkeypatch.setenv("LBM_RESIDENT", "0")
    monkeypatch.setenv("LBM_PALLAS_DEPTH", "4")
    p, _, mask = _case(128, 128, True)
    c0, m = initial_state(p, cuda), torch.from_numpy(mask).to(cuda)
    assert plan.describe(plan.segments(128, 128, 202)) == \
        "depth D=4 x50, depth D=2 x1"
    assert plan.describe(resident.segments(128, 128, 202, cuda)) == \
        "depth D=4 K=25 x2, depth D=2 x1"
    fused.reset_launches()
    simulate(p, c0, m, kernel="cuda", n_iters=202)
    assert fused.LAUNCHES["depth_flow"] == 2 and fused.LAUNCHES["depth"] == 1
    assert fused.LAUNCHES["step"] == 0 and fused.LAUNCHES["reduce"] == 0
    assert plan.describe(resident.segments(128, 128, 203, cuda)) == \
        "depth D=4 K=25 x2, depth D=2 x1, step x1"
    fused.reset_launches()
    simulate(p, c0, m, kernel="cuda", n_iters=203)
    assert fused.LAUNCHES["depth_flow"] == 2 and fused.LAUNCHES["depth"] == 1
    assert fused.LAUNCHES["step"] == 1 and fused.LAUNCHES["reduce"] == 1


@pytest.mark.cuda
def test_even_chunks_keep_every_bit_under_the_auto_depths(cuda, monkeypatch,
                                                          tmp_path):
    """Under the depths ``auto`` plans (D = 4 with a D = 2 tail) any even
    chunk length and checkpoint step gives the single-shot run's bits in
    cells and in av_vels: a step's total is summed at a fixed place of the
    tile, the same at every stage and under both depths."""
    from lbm_tpu_torch.runner import run_simulation

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LBM_RESIDENT", "0")
    p, _, mask = _case(128, 128, True)
    base = run_simulation(p, mask, kernel="cuda", n_iters=240)
    for stride in (70, 42, 6):
        run = run_simulation(p, mask, kernel="cuda", n_iters=240,
                             chunk_iters=stride)
        np.testing.assert_array_equal(run.cells, base.cells)
        np.testing.assert_array_equal(run.av_vels, base.av_vels)
    ck = tmp_path / "ck.npz"
    run_simulation(p, mask, kernel="cuda", n_iters=42, checkpoint_every=42,
                   checkpoint_file=ck)
    resumed = run_simulation(p, mask, kernel="cuda", n_iters=240,
                             resume_from=ck)
    np.testing.assert_array_equal(resumed.cells, base.cells)
    np.testing.assert_array_equal(resumed.av_vels, base.av_vels)


# The depth kernel's flow form (csrc/fused_depth_flow.cu's
# fused_depth_flow_kernel): K rounds of 4 steps a launch.


def _flow_case(cuda, ny, nx, axis, seed):
    """A seeded perturbed state and its mask on the card, in the layout
    of ``axis`` (1: transposed, column mode), and the kernels' scene
    constants."""
    from lbm_tpu_torch.state import transpose_state

    p, cells, mask = _case(nx, ny, axis == 0, seed=seed, perturbed=True)
    c, m = torch.from_numpy(cells).to(cuda), torch.from_numpy(mask).to(cuda)
    if axis:
        c, m = transpose_state(c).contiguous(), m.T.contiguous()
    return c, (m, p.accel_w1, p.accel_w2, p.omega)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
@pytest.mark.parametrize("ny,nx,rounds", [
    (1024, 1024, 25), (128, 128, 25), (100, 130, 7), (242, 96, 25),
    (50, 33, 3), (200, 32, 25), (200, 64, 24), (1000, 40, 2),
    (20, 24, 25)],
    ids=["1024x1024", "128x128", "100x130", "242x96-thin-last-tile-row",
         "50x33", "200x32-one-tile-column", "200x64-two-tile-columns",
         "1000x40", "20x24-one-tile"])
def test_a_k_round_launch_gives_k_single_round_launches_bits(
        cuda, ny, nx, rounds, axis):
    """Two launches of K rounds give the cells and every step's tot_u of
    2K one-round launches, bit for bit (the round counters carry on from
    one launch to the next); each leaves its slots empty and its ticket at
    zero, every tile's counter at the rounds run, and its wait count
    within the flowing tiles."""
    c, w = _flow_case(cuda, ny, nx, axis, seed=ny + nx + rounds)
    flow = fused_depth.FusedDepth(*w, 4, axis, rounds)
    one = fused_depth.FusedDepth(*w, 4, axis)
    steps = 4 * rounds
    out_flow = torch.full((2 * steps + 2,), -1.0, device=cuda)
    out_one = out_flow.clone()
    key = "depth_flow" + ("_cols" if axis else "")
    before = fused.LAUNCHES[key]
    bufs = [c.clone(), torch.empty_like(c)]
    for k in range(2):
        bufs[:] = flow.run(bufs[0], bufs[1], out_flow, 1 + k * steps, 0.5)
    got = bufs[0]
    assert fused.LAUNCHES[key] == before + 2
    bufs = [c.clone(), torch.empty_like(c)]
    for k in range(2 * rounds):
        bufs[:] = one.run(bufs[0], bufs[1], out_one, 1 + 4 * k, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, bufs[0])
    assert torch.equal(out_flow, out_one)
    assert out_flow[0] == -1 and out_flow[-1] == -1
    n = flow.n_tiles
    words = flow._scratch.view(torch.int32)[:8 * n + 1]
    assert (words[:8 * n] == -1).all() and words[8 * n] == 0
    done = flow._done.cpu()
    assert (done[:n] == 2 * rounds).all() and done[n + 1] == 2 * rounds
    assert 0 <= flow.waits() <= flow.flow_tiles == 2 * (rounds - 1) * n
    # The kept partials of the last round (its parity's rows) are the
    # one-round launches' last ones.
    last = 4 * ((rounds - 1) % 2)
    assert torch.equal(flow._partials[last:last + 4], one._partials)


@pytest.mark.cuda
def test_a_one_tile_lattice_flows_through_many_rounds(cuda):
    """One tile, which waits on itself alone, over 40 launches of 25
    rounds: every launch ends, and the bits are the one-round kernel's."""
    c, w = _flow_case(cuda, 20, 24, 0, seed=3)
    flow = fused_depth.FusedDepth(*w, 4, 0, 25)
    assert flow.n_tiles == 1
    out = torch.zeros(100, device=cuda)
    bufs = [c.clone(), torch.empty_like(c)]
    for _ in range(40):
        bufs[:] = flow.run(bufs[0], bufs[1], out, 0, 1.0)
    torch.cuda.synchronize()
    want, _ = fused_depth.fused_depth_plain(c, *w, 4000)
    assert torch.equal(bufs[0], want)
    assert int(flow._done[0]) == int(flow._done[2]) == 1000
    assert flow.waits() <= 40 * 24


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
def test_flow_runs_give_the_one_round_runs_bits(cuda, axis, monkeypatch):
    """Through the runner: 242 steps planned as the card plans them (two
    launches of 25 rounds, one of 10, a D = 2 tail) give the cells and
    av_vels of the one-round plan (the depth kernel's slots hidden from
    the planner), and record their flowing tiles and waits."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import run_simulation

    for k in ("LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LBM_RESIDENT", "0")
    p, _, mask = _case(256 if axis else 128, 128, True)
    if axis:
        monkeypatch.setattr(plan, "transposed_layout",
                            lambda ny, nx: nx >= 2 * ny and nx % 8 == 0)
    flow = run_simulation(p, mask, kernel="cuda", n_iters=242)
    n = fused_depth.n_tiles(*((256, 128) if axis else (128, 128)), 4)
    t = flow.timings
    assert t["compute.depth.flow_tiles"] == (2 * 24 + 9) * n
    assert 0 <= t["compute.depth.waits"] <= t["compute.depth.flow_tiles"]
    assert t["compute.launches.cols"] == (4 if axis else 0)
    monkeypatch.setattr(fused_depth, "block_slots", lambda device, axis=0: 0)
    one = run_simulation(p, mask, kernel="cuda", n_iters=242)
    assert "compute.depth.flow_tiles" not in one.timings
    np.testing.assert_array_equal(flow.cells, one.cells)
    np.testing.assert_array_equal(flow.av_vels, one.av_vels)


@pytest.mark.cuda
def test_flow_chunks_and_resumes_keep_the_uncut_runs_bits(cuda, tmp_path):
    """The 1024^2 scene's first 6004 steps under ``auto`` (the flow form):
    in chunks of 3002 (each a launch of 25 rounds short of whole, its own
    plan) and checkpointed at 3002 and resumed, the uncut run's cells and
    av_vels bit for bit."""
    from lbm_tpu_torch.runner import run_simulation

    p = Params(nx=1024, ny=1024, max_iters=6004, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    mask = generate_obstacles(p.nx, p.ny)
    mask[:, 341] = True
    base = run_simulation(p, mask)
    assert base.timings["compute.depth.flow_tiles"] > 0
    chunked = run_simulation(p, mask, chunk_iters=3002)
    ck = tmp_path / "ck.npz"
    run_simulation(p, mask, n_iters=3002, checkpoint_every=3002,
                   checkpoint_file=ck)
    resumed = run_simulation(p, mask, resume_from=ck)
    for run in (chunked, resumed):
        np.testing.assert_array_equal(run.cells, base.cells)
        np.testing.assert_array_equal(run.av_vels, base.av_vels)


# The resident kernel's on-chip form (csrc/resident_onchip.cu).


@pytest.mark.cuda
@pytest.mark.parametrize("gsteps", [16, 5])
@pytest.mark.parametrize("grid,axis", [
    ((128, 128), 0), ((256, 256), 0), ((512, 512), 0), ((1024, 256), 0),
    ((264, 100), 1), ((512, 128), 1),
], ids=["128x128", "256x256", "512x512", "1024x256", "264x100-columns",
        "512x128-columns"])
def test_onchip_form_matches_plain(cuda, grid, axis, gsteps):
    """One launch of the on-chip form, one block an SM, against the plain
    version: every bit of the cells, tots within the bound, one launch
    counted; a second launch from the result continues bit for bit
    (the halo words' tags go on across launches)."""
    from lbm_tpu_torch.state import transpose_state

    nx, ny = grid
    p, cells, mask = _case(nx, ny, axis == 0, seed=nx + ny, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    if axis:
        c, m = transpose_state(c).contiguous(), m.T.contiguous()
    w = (m, p.accel_w1, p.accel_w2, p.omega)
    kernel = resident.Resident(*w, gsteps, axis, form="onchip")
    assert kernel.form == "onchip"
    key = "resident_onchip" + ("_cols" if axis else "")
    bufs, out = [c.clone(), torch.empty_like(c)], torch.zeros(
        2 * gsteps, device=cuda)
    before = fused.LAUNCHES[key]
    want, want_tots = fused_depth.fused_depth_plain(c, *w, 2 * gsteps,
                                                    axis=axis)
    for t in (0, gsteps):
        bufs[:] = kernel.run(bufs[0], bufs[1], out, t, 1.0)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 2
    assert torch.equal(bufs[0], want)
    np.testing.assert_allclose(out.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,ny", [(1, 16), (7, 100), (32, 128),
                                       (64, 128), (128, 128)],
                         ids=["1", "7", "32", "64", "128"])
def test_onchip_form_at_any_block_count(cuda, blocks, ny):
    """Fewer, taller strips (and one block alone, its own neighbour, on
    a lattice whose 16 rows fit one block) give the same bits; repeat
    runs are bit-identical."""
    p, cells, mask = _case(128, ny, True, seed=blocks, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    args = (m, p.accel_w1, p.accel_w2, p.omega, 16)
    got, tots = resident.resident(c, *args, form="onchip", blocks=blocks)
    again, tots2 = resident.resident(c, *args, form="onchip", blocks=blocks)
    want, _ = fused_depth.fused_depth_plain(c, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(tots, tots2)


@pytest.mark.cuda
def test_onchip_form_raises_where_it_does_not_fit(cuda, monkeypatch):
    """1024x1024 plans the device-memory form; the on-chip form asked
    for there raises and never runs the other form."""
    from lbm_tpu_torch.ops import plan

    monkeypatch.delenv("LBM_RESIDENT_FORM", raising=False)
    m = torch.from_numpy(generate_obstacles(1024, 1024)).to(cuda)
    assert resident.planned_form(1024, 1024, cuda) == "device"
    assert resident.planned_form(256, 256, cuda) == "onchip"
    with pytest.raises(ValueError, match="shared memory"):
        resident.Resident(m, 1e-4, 2.5e-5, 1.85, 100, form="onchip")
    sms, smem = resident.device_limits(cuda)
    assert plan.resident_form(1024, 1024, sms, smem) == "device"
    monkeypatch.setenv("LBM_RESIDENT_FORM", "onchip")
    with pytest.raises(ValueError, match="shared memory"):
        resident.Resident(m, 1e-4, 2.5e-5, 1.85, 100)


@pytest.mark.cuda
def test_auto_runs_small_lattices_on_chip(cuda, monkeypatch):
    """Under auto a 256x256 run plans and launches the on-chip form; the
    device-memory form pinned gives the same cells."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import plan_run, simulate

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_RESIDENT_FORM"):
        monkeypatch.delenv(k, raising=False)
    p, _, mask = _case(256, 256, True)
    m = torch.from_numpy(mask).to(cuda)
    parts = plan_run(p, "cuda", 200, device=cuda)
    assert plan.describe(parts) == "resident G=100 on-chip x2"
    before = dict(fused.LAUNCHES)
    c_on, av_on = simulate(p, initial_state(p, cuda), m, kernel="cuda")
    assert fused.LAUNCHES["resident_onchip"] == before["resident_onchip"] + 2
    monkeypatch.setenv("LBM_RESIDENT_FORM", "device")
    assert plan.describe(plan_run(p, "cuda", 200, device=cuda)) == \
        "resident G=100 device-memory x2"
    c_dev, av_dev = simulate(p, initial_state(p, cuda), m, kernel="cuda")
    assert torch.equal(c_on, c_dev)
    np.testing.assert_allclose(av_on.cpu().numpy(), av_dev.cpu().numpy(),
                               rtol=TRAJ_RTOL)


# The on-chip form's single-buffer mode (csrc/resident_onchip.cu, one
# buffer a strip, updated in place in waves).


def _inplace_case(cuda, nx, ny, axis, seed):
    """A perturbed state and its mask, on the transposed lattice in
    column mode."""
    from lbm_tpu_torch.state import transpose_state

    p, cells, mask = _case(nx, ny, True, seed=seed, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    if axis:
        c, m = transpose_state(c).contiguous(), m.T.contiguous()
    return p, c, m


@pytest.mark.cuda
@pytest.mark.parametrize("gsteps", [1, 2, 99, 100])
@pytest.mark.parametrize("grid,axis", [
    ((4096, 64), 0), ((1024, 400), 1), ((1024, 512), 1), ((768, 768), 0),
    ((1024, 640), 0), ((2001, 200), 0)],
    ids=["4096x64", "1024x400-columns", "1024x512-columns", "768x768",
         "1024x640-rows-of-a-wave", "2001x200-rows-wider-than-a-wave"])
def test_inplace_form_matches_plain(cuda, grid, axis, gsteps):
    """One launch of the single-buffer mode where two buffers do not fit:
    every bit of the plain version's cells, tots within the bound, one
    launch counted."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.ops import reference as ref_ops

    nx, ny = grid
    p, c, m = _inplace_case(cuda, nx, ny, axis, seed=nx + gsteps)
    sms, smem = resident.device_limits(cuda)
    assert not plan.onchip_fits(*m.shape, sms, smem, 2)
    w = (m, p.accel_w1, p.accel_w2, p.omega)
    kernel = resident.Resident(*w, gsteps, axis, form="inplace")
    assert kernel.buffers == 1
    key = "resident_onchip_inplace" + ("_cols" if axis else "")
    before = fused.LAUNCHES[key]
    got, tots = resident.resident(c, *w, gsteps, axis=axis, form="inplace")
    want, want_tots = ref_ops.multi_step(c, *w, gsteps, axis)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(512, 512), (792, 528)],
                         ids=["512x512", "792x528"])
def test_inplace_tots_are_the_two_buffer_bits(cuda, grid, monkeypatch):
    """Where both modes fit, LBM_RESIDENT_INPLACE=1 against 0: the same
    cells and each step's tot_u with the same bits (each thread updates
    and sums the same cells in the same order)."""
    nx, ny = grid
    p, c, m = _inplace_case(cuda, nx, ny, 0, seed=3)
    w = (m, p.accel_w1, p.accel_w2, p.omega, 100)
    runs = {}
    for pin, form in (("1", "inplace"), ("0", "onchip")):
        monkeypatch.setenv("LBM_RESIDENT_INPLACE", pin)
        assert resident.planned_form(ny, nx, cuda) == form
        runs[form] = resident.resident(c, *w)
    torch.cuda.synchronize()
    assert torch.equal(runs["inplace"][0], runs["onchip"][0])
    assert torch.equal(runs["inplace"][1], runs["onchip"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("grid,axis,g", [((768, 768), 0, 100),
                                         ((1024, 400), 1, 99)],
                         ids=["768x768-G100", "1024x400-columns-G99"])
def test_inplace_200_steps_keep_every_bit(cuda, grid, axis, g):
    """Launches from one wrapper that go on from each other (the halo
    words' tags carried across them, an odd G too), 200 steps and more on a
    perturbed state: the plain version's cells bit for bit."""
    from lbm_tpu_torch.ops import reference as ref_ops

    nx, ny = grid
    p, c, m = _inplace_case(cuda, nx, ny, axis, seed=11)
    w = (m, p.accel_w1, p.accel_w2, p.omega)
    kernel = resident.Resident(*w, g, axis, form="inplace")
    calls = -(-200 // g)
    bufs, out = [c.clone(), torch.empty_like(c)], torch.zeros(calls * g,
                                                             device=cuda)
    for t in range(0, calls * g, g):
        bufs[:] = kernel.run(bufs[0], bufs[1], out, t, 1.0)
    want, _ = ref_ops.multi_step(c, *w, calls * g, axis)
    torch.cuda.synchronize()
    assert torch.equal(bufs[0], want)
    assert bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_a_pinned_mode_that_does_not_fit_raises(cuda, monkeypatch):
    """LBM_RESIDENT_INPLACE=1 at 1024x1024 (one buffer does not fit), =0
    at 4096x64 (two do not), and =1 with LBM_RESIDENT_FORM=device raise;
    none runs another form."""
    monkeypatch.delenv("LBM_RESIDENT_FORM", raising=False)
    cases = [("1", 1024, 1024, "single-buffer"), ("0", 64, 4096, "two-buffer")]
    for pin, ny, nx, mode in cases:
        monkeypatch.setenv("LBM_RESIDENT_INPLACE", pin)
        m = torch.from_numpy(generate_obstacles(nx, ny)).to(cuda)
        before = dict(fused.LAUNCHES)
        with pytest.raises(ValueError, match=mode):
            resident.Resident(m, 1e-4, 2.5e-5, 1.85, 100)
        assert fused.LAUNCHES == before
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    monkeypatch.setenv("LBM_RESIDENT_FORM", "device")
    with pytest.raises(ValueError, match="single-buffer"):
        resident.planned_form(256, 256, cuda)


@pytest.mark.cuda
def test_auto_runs_narrow_and_tall_lattices_in_one_buffer(cuda, monkeypatch):
    """Under auto 1024x400 (transposed) plans and launches the
    single-buffer mode, 4096x64 (one-row strips) the device-memory form's
    shift mode; both give the plain version's cells."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import plan_run, simulate

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_RESIDENT_FORM", "LBM_RESIDENT_INPLACE",
              "LBM_RESIDENT_SHIFT"):
        monkeypatch.delenv(k, raising=False)
    for (nx, ny), word, key in [
            ((1024, 400), "on-chip 1-buf", "resident_onchip_inplace_cols"),
            ((4096, 64), "device-memory shift", "resident_shift")]:
        p, _, mask = _case(nx, ny, True)
        m = torch.from_numpy(mask).to(cuda)
        assert plan.describe(plan_run(p, "cuda", 200, device=cuda)) == \
            f"resident G=100 {word} x2"
        before = dict(fused.LAUNCHES)
        got, _ = simulate(p, initial_state(p, cuda), m, kernel="cuda",
                          n_iters=200)
        assert fused.LAUNCHES[key] == before[key] + 2
        monkeypatch.setenv("LBM_RESIDENT", "0")
        want, _ = simulate(p, initial_state(p, cuda), m, kernel="cuda",
                           n_iters=200)
        monkeypatch.delenv("LBM_RESIDENT")
        assert torch.equal(got, want)


# The resident kernel's device-memory form (csrc/resident.cu): rounds of
# up to four steps on the depth kernel's tiles, a grid barrier a round.


def _device_form_case(cuda, axis, seed):
    """256x256 in row mode, or the transposed 512x128 in column mode (the
    forced column 126 in a tile column of its own), perturbed."""
    from lbm_tpu_torch.state import transpose_state

    nx, ny = (512, 128) if axis else (256, 256)
    p, cells, mask = _case(nx, ny, True, seed=seed, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    if axis:
        c, m = transpose_state(c).contiguous(), m.T.contiguous()
    return p, c, m


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("axis,form", [(0, "device"), (1, "device"),
                                       (0, "shift")],
                         ids=["rows", "columns", "rows-shift"])
@pytest.mark.parametrize("g,depth", [(16, 4), (100, 4), (50, 2)],
                         ids=["G16-D4", "G100-D4", "G50-D2"])
def test_device_form_tots_are_the_depth_plans_bits(cuda, g, depth, axis,
                                                   form, mode, monkeypatch):
    """Where D divides G, one launch of the device form, or of its shift
    mode (G rounds of one step), gives each step's tot_u the bits of
    G / D depth launches (the same tile, thread and warp map, the same
    sum), and their cells."""
    _set_mode(monkeypatch, mode)
    p, c, m = _device_form_case(cuda, axis, seed=g + axis)
    w = (m, p.accel_w1, p.accel_w2, p.omega)
    got, tots = resident.resident(c, *w, g, axis, form=form)
    dep = fused_depth.FusedDepth(*w, depth, axis)
    want, spare = c.clone(), torch.empty_like(c)
    want_tots = torch.zeros(g, device=cuda)
    for t in range(0, g, depth):
        want, spare = dep.run(want, spare, want_tots, t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(tots, want_tots)


@pytest.mark.cuda
@pytest.mark.parametrize("grid,blocks,form,residence", [
    ((256, 256), None, "device", None), ((256, 256), 7, "device", None),
    ((1024, 1024), None, "device", None), ((256, 256), None, "shift", None),
    ((256, 256), 7, "shift", None), ((1024, 1024), None, "shift", None),
    ((4096, 64), None, "shift", None), ((8192, 32), None, "shift", None),
    ((4096, 64), 7, "shift", None), ((4096, 64), None, "shift", "device"),
    ((8192, 32), None, "shift", "device"), ((256, 256), None, "shift",
                                            "device")],
    ids=["256x256", "256x256-7-blocks", "1024x1024", "256x256-shift",
         "256x256-7-blocks-shift", "1024x1024-shift", "4096x64-shift",
         "8192x32-shift", "4096x64-7-blocks-shift",
         "4096x64-shift-device-residence", "8192x32-shift-device-residence",
         "256x256-shift-device-residence"])
def test_device_form_200_rounds_keep_every_bit(cuda, grid, blocks, form,
                                               residence):
    """200 rounds of 4 steps (the shift mode: 800 steps, each block waiting
    only on its neighbours' step counters) in one launch on a perturbed
    state, every round reading what other blocks wrote in the round before:
    the plain version's cells bit for bit (a stale or non-coherent load of
    a neighbour's rows would show), tots within the bound; with 7 blocks
    each takes many tiles; the shift mode at the narrow channels' slabs in
    both residences."""
    nx, ny = grid
    p, cells, mask = _case(nx, ny, True, seed=3, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    args = (m, p.accel_w1, p.accel_w2, p.omega, 800)
    kernel = resident.Resident(*args, form=form, blocks=blocks,
                               residence=residence)
    assert kernel.rounds == ([4] * 200 if form == "device" else [1] * 800)
    key = "resident" if form == "device" else "resident_shift"
    bufs, out = [c.clone(), torch.empty_like(c)], torch.zeros(800, device=cuda)
    before = fused.LAUNCHES[key]
    bufs[:] = kernel.run(bufs[0], bufs[1], out)
    want, want_tots = fused_depth.fused_depth_plain(c, *args)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    assert torch.equal(bufs[0], want)
    np.testing.assert_allclose(out.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("axis,form", [(0, "device"), (1, "device"),
                                       (0, "shift")],
                         ids=["rows", "columns", "rows-shift"])
def test_device_form_blocks_that_cannot_be_co_resident_raise(cuda, axis,
                                                             form):
    """A cooperative launch of more blocks than the card holds at once is
    refused; the wrapper raises and falls back to nothing, and leaves no
    error behind: the next launch runs and gives the plain version's
    cells."""
    p, c, m = _device_form_case(cuda, axis, seed=1)
    w = (m, p.accel_w1, p.accel_w2, p.omega, 16, axis)
    kernel = resident.Resident(*w, form=form, blocks=4096)
    key = ("resident" if form == "device" else "resident_shift") + (
        "_cols" if axis else "")
    before = fused.LAUNCHES[key]
    with pytest.raises(RuntimeError, match="cooperative launch"):
        kernel.run(c.clone(), torch.empty_like(c), torch.zeros(16, device=cuda))
    assert fused.LAUNCHES[key] == before
    got, _ = resident.resident(c, *w, form=form)
    want, _ = resident.resident_plain(c, *w)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    assert torch.equal(got, want)


# The device form's shift mode (LBM_RESIDENT_SHIFT; csrc/resident.cu's
# resident_shift_kernel): rounds of one step, each cell's speeds loaded
# straight from the source buffer.


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("g", [2, 16, 100], ids=["G2", "G16", "G100"])
@pytest.mark.parametrize("blocks", [None, 7], ids=["planned", "7-blocks"])
@pytest.mark.parametrize("nx,ny,walls", [
    (100, 36, True), (99, 37, False), (30, 100, False), (256, 256, True),
    (4096, 64, True), (8192, 32, True), (1024, 1024, True)],
    ids=["100x36", "99x37-wall-less", "30x100-wall-less", "256x256",
         "4096x64", "8192x32", "1024x1024"])
def test_shift_mode_matches_plain(cuda, nx, ny, walls, blocks, g, mode,
                                  monkeypatch):
    """One launch of G steps from a perturbed state, over the planned
    blocks (the narrow channels' slabs) and over 7: the plain version's
    cells bit for bit (99x37: columns wrap mid-quad, a block of 3 lanes;
    30x100: one tile column cut into row groups), its tots within the
    bound, and each step's tot the bits of the device form's."""
    _set_mode(monkeypatch, mode)
    p, cells, mask = _case(nx, ny, walls, seed=nx + g, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    w = (m, p.accel_w1, p.accel_w2, p.omega, g)
    before = fused.LAUNCHES["resident_shift"]
    got, tots = resident.resident(c, *w, form="shift", blocks=blocks)
    want, want_tots = resident.resident_plain(c, *w)
    _, dev_tots = resident.resident(c, *w, form="device")
    torch.cuda.synchronize()
    assert fused.LAUNCHES["resident_shift"] == before + 1
    assert float((got - want).abs().max()) == 0.0
    np.testing.assert_allclose(tots.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=TOT_RTOL)
    assert torch.equal(tots, dev_tots)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("g", [2, 17], ids=["G2", "G17"])
@pytest.mark.parametrize("nx,ny,walls,blocks", [
    (100, 36, True, None), (99, 37, False, 7), (30, 100, False, None),
    (256, 256, True, None), (70, 100, True, 7)],
    ids=["100x36", "99x37-7-blocks", "30x100", "256x256",
         "70x100-7-blocks"])
def test_shift_shared_residence_off_the_slabs_matches_plain(
        cuda, nx, ny, walls, blocks, g, mode, monkeypatch):
    """The shared residence off the narrow channels' slabs (blocks with
    row groups: rows, columns and corners from up to eight neighbours; one
    tile column cut into row groups; 3 x 2 blocks over 7): the plain
    version's cells bit for bit and each step's tot the bits of the device
    form's."""
    _set_mode(monkeypatch, mode)
    p, cells, mask = _case(nx, ny, walls, seed=ny + g, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    w = (m, p.accel_w1, p.accel_w2, p.omega, g)
    kernel = resident.Resident(*w, form="shift", blocks=blocks,
                               residence="shared")
    assert kernel.residence == "shared"
    bufs, tots = [c.clone(), torch.empty_like(c)], torch.zeros(g, device=cuda)
    got, _ = kernel.run(bufs[0], bufs[1], tots)
    want, _ = resident.resident_plain(c, *w)
    _, dev_tots = resident.resident(c, *w, form="device")
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) == 0.0
    assert torch.equal(tots, dev_tots)


@pytest.mark.cuda
def test_shift_mode_picks_its_residence_by_the_blocks_bytes(cuda):
    """The narrow channels (one block an SM, slabs of whole tile columns)
    and 256x256 (one-tile blocks) keep their cells in shared memory,
    1024x1024 (too large) in device memory; the planner's rule and the
    card agree."""
    from lbm_tpu_torch.ops import plan

    sms, smem = resident.device_limits(cuda)
    for (nx, ny), want in [((4096, 64), "shared"), ((8192, 32), "shared"),
                           ((256, 256), "shared"), ((1024, 1024), "device")]:
        m = torch.zeros((ny, nx), dtype=torch.bool, device=cuda)
        k = resident.Resident(m, 1e-4, 1e-5, 1.85, 4, form="shift")
        assert k.residence == want == plan.shift_residence(ny, nx, sms, smem)
        if want == "shared":
            assert k.blocks == len(plan.shift_rects(ny, nx, sms))
    assert resident.Resident(m, 1e-4, 1e-5, 1.85, 4, form="shift",
                             residence="device").residence == "device"
    big = torch.zeros((1024, 1024), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared residence"):
        resident.Resident(big, 1e-4, 1e-5, 1.85, 4, form="shift",
                          residence="shared")


@pytest.mark.cuda
def test_shift_pin_runs_the_mode_through_the_runner(cuda, monkeypatch):
    """Under LBM_RESIDENT_SHIFT=1 the runner plans and launches the mode
    (256x256, 200 steps: two launches), and its cells and av_vels have the
    bits of the device form's run (LBM_RESIDENT_FORM=device)."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.runner import plan_run, simulate

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_RESIDENT_FORM", "LBM_RESIDENT_INPLACE",
              "LBM_RESIDENT_SHIFT"):
        monkeypatch.delenv(k, raising=False)
    p, _, mask = _case(256, 256, True)
    m = torch.from_numpy(mask).to(cuda)
    runs = {}
    for pin, value, key in [("LBM_RESIDENT_SHIFT", "1", "resident_shift"),
                            ("LBM_RESIDENT_FORM", "device", "resident")]:
        monkeypatch.setenv(pin, value)
        word = "device-memory shift" if key == "resident_shift" \
            else "device-memory"
        assert plan.describe(plan_run(p, "cuda", 200, device=cuda)) == \
            f"resident G=100 {word} x2"
        before = fused.LAUNCHES[key]
        runs[key] = simulate(p, initial_state(p, cuda), m, kernel="cuda",
                             n_iters=200)
        assert fused.LAUNCHES[key] == before + 2
        monkeypatch.delenv(pin)
    (cs, avs), (cd, avd) = runs["resident_shift"], runs["resident"]
    assert torch.equal(cs, cd)
    assert torch.equal(avs, avd)


# The stream-cost probe (csrc/probe.cu): the device-memory form's rounds
# with the probe's stage bodies.


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("g", [16, 100], ids=["G16", "G100"])
def test_probe_full_tots_are_the_device_forms_bits(cuda, g, mode,
                                                   monkeypatch):
    """``full`` runs the device-memory resident form's code with no
    forced line: in every association its cells and each step's total are
    the bits of that form's with the forcing set to 0."""
    from lbm_tpu_torch.ops import probe

    _set_mode(monkeypatch, mode)
    p, c, m = _device_form_case(cuda, 0, seed=g)
    got, tots = probe.probe(c, m, p.omega, g, "full")
    want, want_tots = resident.resident(c, m, 0.0, 0.0, p.omega, g,
                                        form="device")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(tots, want_tots)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "collide", "stream"])
@pytest.mark.parametrize("grid", [256, 1024], ids=["256x256", "1024x1024"])
def test_probe_200_rounds_keep_every_bit(cuda, grid, mode):
    """200 rounds of 4 variant-steps in one launch on a perturbed state,
    every round reading what other blocks wrote in the round before: the
    plain version's cells bit for bit (a stale or non-coherent load of a
    neighbour's rows would show), totals within the bound."""
    from lbm_tpu_torch.ops import probe
    from lbm_tpu_torch.ops import reference as ref_ops

    p, cells, mask = _case(grid, grid, True, seed=5, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    kernel = probe.Probe(m, p.omega, 800, mode)
    assert kernel.rounds == [4] * 200
    a, out = c.clone(), torch.zeros(800, device=cuda)
    before = fused.LAUNCHES[f"probe_{mode}"]
    kernel.run(a, torch.empty_like(c), out)
    want, want_tots = ref_ops.probe_multi_step(c, m, p.omega, 800, mode)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[f"probe_{mode}"] == before + 1
    assert torch.equal(a, want)
    np.testing.assert_allclose(out.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(256, 256), (1024, 1024), (1024, 16384)],
                         ids=["256x256", "1024x1024", "16384x1024"])
def test_probe_modes_launch_the_same_blocks(cuda, grid):
    """The three modes launch the same blocks and rounds from the same
    occupancy query, the device-memory resident form's: only the stage
    body differs."""
    from lbm_tpu_torch.ops import probe

    m = torch.from_numpy(generate_obstacles(grid[1], grid[0])).to(cuda)
    kernels = [probe.Probe(m, 1.85, 100, mode) for mode in probe.MODES]
    form = resident.Resident(m, 0.0, 0.0, 1.85, 100, form="device")
    assert {k.blocks for k in kernels} == {form.blocks}
    assert all(k.rounds == form.rounds for k in kernels)


@pytest.mark.cuda
def test_probe_blocks_that_cannot_be_co_resident_raise(cuda):
    """A cooperative launch of more blocks than the card holds at once is
    refused; the wrapper raises and falls back to nothing."""
    from lbm_tpu_torch.ops import probe

    p, c, m = _device_form_case(cuda, 0, seed=1)
    kernel = probe.Probe(m, p.omega, 16, "full")
    kernel.blocks = 4096
    before = fused.LAUNCHES["probe_full"]
    a = c.clone()
    with pytest.raises(RuntimeError, match="cooperative launch"):
        kernel.run(a, torch.empty_like(c), torch.zeros(16, device=cuda))
    assert fused.LAUNCHES["probe_full"] == before
    assert torch.equal(a, c)


# The tensor-core equilibrium (csrc/mxu_eq.cu): the device-memory form's
# rounds with the equilibrium as an f64 product on the tensor cores.


@pytest.mark.cuda
@pytest.mark.parametrize("gsteps", [3, 6, 100], ids=["G3", "G6", "G100"])
@pytest.mark.parametrize("shape", [(128, 128, True), (100, 130, False),
                                   (1024, 1024, True)],
                         ids=["128x128", "100x130-wall-less", "1024x1024"])
def test_mxu_kernel_matches_plain(cuda, shape, gsteps):
    """One launch (rounds of 1, 4 + 2 and 24x4 + 2x2: every window depth
    and its last warp) against mxu_multi_step on the card: cells within
    cells_atol, each step's total within the trajectory rtol."""
    from lbm_tpu_torch.ops import mxu_eq

    p, cells, mask = _case(*shape, seed=gsteps, perturbed=True)
    c = torch.from_numpy(cells).to(cuda)
    m = torch.from_numpy(mask).to(cuda)
    before = fused.LAUNCHES["mxu"]
    got, tots = mxu_eq.mxu_resident(c, m, p.accel_w1, p.accel_w2, p.omega,
                                    gsteps)
    want, want_tots = mxu_eq.mxu_multi_step(c, m, p.accel_w1, p.accel_w2,
                                            p.omega, gsteps)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["mxu"] == before + 1
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= mxu_eq.cells_atol(gsteps, p.omega), err
    np.testing.assert_allclose(tots.cpu().numpy(), want_tots.cpu().numpy(),
                               rtol=mxu_eq.TOT_RTOL)


@pytest.mark.cuda
def test_mxu_kernel_reaches_the_tensor_cores(cuda):
    """The contraction is DMMA instructions in the kernel's SASS (the f64
    products of each 8 cells), not a loop on the CUDA cores."""
    counts = _sass_opcodes()["mxu_resident_kernel"]
    assert sum(n for op, n in counts.items() if op.startswith("DMMA")) > 0


@pytest.mark.cuda
def test_mxu_kernel_launches_the_device_forms_rounds(cuda):
    """The same rounds as the device-memory form, and as many blocks or
    fewer (its block holds 1 KB more shared memory)."""
    from lbm_tpu_torch.ops import mxu_eq

    m = torch.from_numpy(generate_obstacles(1024, 1024)).to(cuda)
    k = mxu_eq.MxuStep(m, 0.0, 0.0, 1.85, 100)
    form = resident.Resident(m, 0.0, 0.0, 1.85, 100, form="device")
    assert k.rounds == form.rounds == resident.device_rounds(100)
    assert 0 < k.blocks <= form.blocks


@pytest.mark.cuda
def test_mxu_blocks_that_cannot_be_co_resident_raise(cuda):
    """A cooperative launch of more blocks than the card holds at once is
    refused; the wrapper raises and falls back to nothing."""
    from lbm_tpu_torch.ops import mxu_eq

    p, c, m = _device_form_case(cuda, 0, seed=1)
    kernel = mxu_eq.MxuStep(m, p.accel_w1, p.accel_w2, p.omega, 16)
    kernel.blocks = 4096
    before = fused.LAUNCHES["mxu"]
    a = c.clone()
    with pytest.raises(RuntimeError, match="cooperative launch"):
        kernel.run(a, torch.empty_like(c), torch.zeros(16, device=cuda))
    assert fused.LAUNCHES["mxu"] == before
    assert torch.equal(a, c)


# The one-step seam kernel: halos read in place on one card, tot_u summed
# in the launch.


def _never(recv, send):
    return False


def _seam_sets(cuda, nx, ny, n, walls, axis, copies=3):
    """``(pad, wrap_pad, sets)``: ``copies`` shard sets of one perturbed
    NXxNY state over ``n`` shards on the card, the row plan padded as
    planned (a wall-less mask wrap-pads where ny does not divide), or the
    x-plan (``axis`` 1)."""
    from lbm_tpu_torch.parallel import decomp, halo

    p, cells, mask = _case(nx, ny, walls, seed=7, perturbed=True)
    mesh = decomp.make_mesh(n, devices=[cuda] * n)
    if axis:
        c = torch.from_numpy(cells).to(cuda)
        return 0, 0, [halo.ShardSet(p, c, mask, mesh, 64, axis=1)
                      for _ in range(copies)]
    sp = halo.plan_run(p, mask, mesh, "cuda", 16)
    if sp.pad:
        pad_cells = initial_state(sp.params).numpy()
        pad_cells[:, sp.pad:] = cells
        cells = pad_cells
    c = torch.from_numpy(cells).to(cuda)
    return sp.pad, sp.wrap_pad, [
        halo.ShardSet(sp.params, c, sp.obstacles, mesh, 64)
        for _ in range(copies)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1024, 1024, True, 0),
                                  (1024, 1022, False, 0),
                                  (131072, 128, True, 1)],
                         ids=["1024x1024/4", "1024x1022/4-wrap",
                              "131072x128/4-x-plan"])
def test_seam_step_in_place_equals_copied_and_plain(cuda, case, monkeypatch):
    """8 one-step calls over 4 shards on one card with halos read in
    place, the same with every halo copied, and 8 plain shard steps: cells
    max abs error 0 between all three; the two forms' tots the same bits.
    The in-place calls launch one kernel a shard and nothing else: no
    reduce, no copy."""
    from lbm_tpu_torch.parallel import halo

    _set_mode(monkeypatch, "paired")
    nx, ny, walls, axis = case
    pad, wrap_pad, (ss, copied_ss, plain) = _seam_sets(cuda, nx, ny, 4,
                                                       walls, axis)
    assert (wrap_pad == 2) == (not walls)
    copies = []
    real_copy = halo.ShardSet._copy
    monkeypatch.setattr(halo.ShardSet, "_copy", staticmethod(
        lambda *a: (copies.append(1), real_copy(*a))))
    impl = halo.SeamShardImpl(ss, 1, wrap_pad)
    copied = halo.SeamShardImpl(copied_ss, 1, wrap_pad, reach=_never)
    fused.reset_launches()
    for t in range(8):
        impl.run(t)
    ss.synchronize()
    key = "step_seam_cols" if axis else "step_seam"
    assert {k: v for k, v in fused.LAUNCHES.items() if v} == {key: 32}
    assert copies == []
    for t in range(8):
        copied.run(t)
    copied_ss.synchronize()
    assert len(copies) == 8 * 4 * 2
    _plain_steps(plain, 8, wrap_pad)
    got = ss.gather()[:, pad:]
    assert torch.equal(got, copied_ss.gather()[:, pad:])
    assert torch.equal(got, plain.gather()[:, pad:])
    for a, b in zip(ss.shards, copied_ss.shards):
        assert torch.equal(a.tots[:8], b.tots[:8])
    np.testing.assert_allclose(ss.av_vels(1.0)[:8].cpu().numpy(),
                               plain.av_vels(1.0)[:8].cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1], ids=["rows", "columns"])
def test_seam_step_sums_tot_u_in_the_launch(cuda, axis):
    """A seam step leaves scale * tot_u in ``out[t]``, summed in the
    launch: held against torch.sum of the tiles' partials (rtol 1e-6),
    the slots empty and the counter zero after every launch, so two
    consecutive launches give the bits of two fresh kernels'."""
    from lbm_tpu_torch.state import transpose_state

    p, cells, mask = _case(264, 100, False, seed=5, perturbed=True)
    c, m = torch.from_numpy(cells).to(cuda), torch.from_numpy(mask).to(cuda)
    if axis:
        c, m = transpose_state(c), m.T.contiguous()
    h, nx = m.shape
    rows = torch.arange(-1, h + 1) % h
    halo_s, halo_n = c[:, rows[:1]], c[:, rows[-1:]]
    args = (m, m[rows[:1]], m[rows[-1:]], p.accel_w1, p.accel_w2, p.omega,
            0, h)

    def fresh():
        return fused.SeamStep(*args, axis=axis)

    kernel = fresh()
    out = torch.full((4,), -1.0, device=cuda)
    before = fused.LAUNCHES["reduce"]
    dst = torch.empty_like(c)
    for t in (1, 2):  # the same input twice
        kernel.run(c, dst, halo_s, halo_n, out, t, 0.5)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["reduce"] == before
    assert out[0] == -1 and out[3] == -1 and out[1] == out[2]
    words = kernel._scratch.view(torch.int32)[:kernel._partials.numel() + 1]
    assert (words[:-1] == -1).all() and words[-1] == 0
    np.testing.assert_allclose(float(out[1]),
                               float(kernel._partials.sum() * 0.5), rtol=1e-6)
    again = torch.empty_like(out)
    fresh().run(c, torch.empty_like(c), halo_s, halo_n, again, 1, 0.5)
    assert again[1] == out[1]
    new, tots = fused.ref_ops.halo_multi_step(
        c, halo_s, halo_n, m, args[1], args[2], 0, h, p.accel_w1, p.accel_w2,
        p.omega, 1, axis)
    assert torch.equal(dst, new)
    np.testing.assert_allclose(float(out[1]), float(tots[0] * 0.5),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
def test_wrap_path_chunks_and_resumes_bit_for_bit(cuda, monkeypatch,
                                                  tmp_path):
    """A wall-less 128x126 scene over 4 shards on one card (the wrap
    discipline: every step a one-step seam call): 60 steps chunked by 25,
    and checkpointed at 30 and resumed, give the single-shot run's cells
    and av_vels bit for bit."""
    from lbm_tpu_torch.parallel import decomp, halo
    from lbm_tpu_torch.runner import run_simulation

    p, _, mask = _case(128, 126, False)
    mesh = decomp.make_mesh(4, devices=[cuda] * 4)
    sp = halo.plan_run(p, mask, mesh, "auto", 60)
    assert sp.mode == "wrap" and [s.kernel for s in sp.segments] == ["step"]
    base = run_simulation(p, mask, n_iters=60, mesh=mesh)
    chunked = run_simulation(p, mask, n_iters=60, mesh=mesh, chunk_iters=25)
    ck = tmp_path / "ck.npz"
    run_simulation(p, mask, n_iters=30, mesh=mesh, checkpoint_every=30,
                   checkpoint_file=ck)
    resumed = run_simulation(p, mask, n_iters=60, mesh=mesh, resume_from=ck)
    for run in (chunked, resumed):
        np.testing.assert_array_equal(run.cells, base.cells)
        np.testing.assert_array_equal(run.av_vels, base.av_vels)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_card(cuda, n, monkeypatch):
    """``dryrun_torch``'s cases as n shards on one card, the CUDA kernels
    against the unsharded plain run on the card."""
    import sys
    from pathlib import Path

    monkeypatch.delenv("LBM_SHARD_RESIDENT", raising=False)
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import dryrun_torch

    lines = dryrun_torch.dryrun_multichip(n, device="cuda")
    assert len(lines) == len(dryrun_torch._dryrun_cases(n))


@pytest.mark.cuda
def test_entry_step_on_the_card_matches_the_cpu_step(cuda, monkeypatch):
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    import dryrun_torch

    step, (cells, obstacles) = dryrun_torch.entry()
    assert cells.device.type == "cuda"
    before = fused.LAUNCHES["step"]
    new, tot = step(cells, obstacles)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["step"] == before + 1
    cstep, (ccells, cobstacles) = dryrun_torch.entry(device="cpu")
    cnew, ctot = cstep(ccells, cobstacles)
    np.testing.assert_array_equal(new.cpu().numpy(), cnew.numpy())
    assert np.isclose(float(tot), float(ctot), rtol=1e-6)


# The on-chip ring (csrc/ring_onchip.cu): each shard's strips in shared
# memory for G steps, seam rows through the ring's slots, in two buffers
# and in one, row mode (the row plan) and column mode (the x-plan).


def _onchip_ring_sets(cuda, nx, ny, n, axis, steps, copies=2):
    """``copies`` shard sets of one perturbed state (the forced line
    failing the guard in places, obstacles on it) over ``n`` shards on the
    card, for ``steps`` steps: the row plan (ny divides n here) or the
    x-plan (``axis`` 1)."""
    from lbm_tpu_torch.parallel import decomp, halo

    p, cells, mask = _case(nx, ny, True, seed=nx + ny + n, perturbed=True)
    rng = np.random.default_rng(nx * ny)
    mask[ny - 2, :] |= rng.random(nx) < 0.2
    mesh = decomp.make_mesh(n, devices=[cuda] * n)
    c = torch.from_numpy(cells).to(cuda)
    return [halo.ShardSet(p, c, mask, mesh, steps, axis) for _ in range(copies)]


# (physical nx, ny, shards, axis): strips of 1 row (128x128/4 and the
# forced row on a shard edge at 16x16/8: two rows a shard), 2 rows
# (256x256/4), 4 rows (512x512/4, 512x128/4 x-plan), 6 rows (768x768/4:
# one buffer only) and 8 rows (1024x512/4 x-plan: one buffer only).
ONCHIP_RING_CASES = {
    "128x128/4": (128, 128, 4, 0), "16x16/8-forced-row-on-a-shard-edge":
    (16, 16, 8, 0), "256x256/4": (256, 256, 4, 0),
    "512x512/4": (512, 512, 4, 0), "512x128/4-x-plan": (512, 128, 4, 1),
    "768x768/4": (768, 768, 4, 0), "1024x512/4-x-plan": (1024, 512, 4, 1)}


def _onchip_ring_fits(ss, form):
    from lbm_tpu_torch.ops import plan, resident
    from lbm_tpu_torch.parallel import resident_ring

    sms, smem = resident.device_limits(ss.shards[0].device)
    blocks = resident_ring.ring_blocks(ss.h, len(ss.shards), sms)
    buffers = 1 if form == "inplace" else 2
    return plan.onchip_smem_bytes(ss.h, ss.nx, blocks, buffers) <= smem


@pytest.mark.cuda
@pytest.mark.parametrize("g", [16, 100], ids=["G16", "G100"])
@pytest.mark.parametrize("form", ["onchip", "inplace"])
@pytest.mark.parametrize("case", list(ONCHIP_RING_CASES))
def test_ring_onchip_matches_the_plain_steps(cuda, case, form, g):
    """One call of G steps against G plain shard steps: cells max abs
    error 0, tots within TOT_RTOL (another order of summation), one
    launch a card."""
    from lbm_tpu_torch.parallel import resident_ring

    nx, ny, n, axis = ONCHIP_RING_CASES[case]
    ss, plain = _onchip_ring_sets(cuda, nx, ny, n, axis, g)
    if not _onchip_ring_fits(ss, form):
        with pytest.raises(ValueError, match="shared memory"):
            resident_ring.RingOnchipImpl(ss, g, form)
        return
    ring = resident_ring.RingOnchipImpl(ss, g, form)
    key = ("ring_onchip_inplace" if form == "inplace" else "ring_onchip") \
        + ("_cols" if axis else "")
    before = fused.LAUNCHES[key]
    ring.run(0)
    ss.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    _plain_steps(plain, g)
    assert float((ss.gather() - plain.gather()).abs().max()) == 0.0
    np.testing.assert_allclose(ss.av_vels(1.0).cpu().numpy(),
                               plain.av_vels(1.0).cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["128x128/4", "256x256/4", "512x512/4",
                                  "512x128/4-x-plan"])
def test_ring_onchip_one_buffer_tots_are_the_two_buffer_bits(cuda, case):
    """Where both modes fit, one buffer updates the same cells in the same
    thread map and sums each strip in the same order: cells and every
    shard's tots, bit for bit."""
    from lbm_tpu_torch.parallel import resident_ring

    nx, ny, n, axis = ONCHIP_RING_CASES[case]
    one, two = _onchip_ring_sets(cuda, nx, ny, n, axis, 100)
    resident_ring.RingOnchipImpl(one, 100, "inplace").run(0)
    resident_ring.RingOnchipImpl(two, 100, "onchip").run(0)
    one.synchronize()
    two.synchronize()
    assert torch.equal(one.gather(), two.gather())
    for a, b in zip(one.shards, two.shards):
        assert torch.equal(a.tots, b.tots)


@pytest.mark.cuda
@pytest.mark.parametrize("case,form", [
    ("256x256/4", "onchip"), ("256x256/4", "inplace"),
    ("512x128/4-x-plan", "onchip"), ("768x768/4", "inplace"),
    ("1024x512/4-x-plan", "inplace")])
def test_ring_onchip_200_steps_keep_every_bit(cuda, case, form):
    """Two calls of G=100 on a perturbed state (the tags go on across the
    calls; a non-coherent load of a slot written by another block would
    show) against 200 plain shard steps, bit for bit."""
    from lbm_tpu_torch.parallel import resident_ring

    nx, ny, n, axis = ONCHIP_RING_CASES[case]
    ss, plain = _onchip_ring_sets(cuda, nx, ny, n, axis, 200)
    ring = resident_ring.RingOnchipImpl(ss, 100, form)
    ring.run(0)
    ring.run(100)
    ss.synchronize()
    _plain_steps(plain, 200)
    assert torch.equal(ss.gather(), plain.gather())
    np.testing.assert_allclose(ss.av_vels(1.0).cpu().numpy(),
                               plain.av_vels(1.0).cpu().numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.cuda
def test_ring_onchip_pinned_mode_that_does_not_fit_raises(cuda, monkeypatch):
    """LBM_RESIDENT_INPLACE=1 at 1024x1024 over 4 (one buffer does not
    fit), =0 at 768x768 over 4 (two do not), and =1 with
    LBM_RESIDENT_FORM=device raise in the planner, and the wrapper of a
    mode that does not fit raises; nothing runs another form."""
    from lbm_tpu_torch.parallel import decomp, halo, resident_ring

    for k in ("LBM_RESIDENT_FORM", "LBM_RESIDENT_INPLACE",
              "LBM_RESIDENT_STEPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    mesh = decomp.make_mesh(4, devices=[cuda] * 4)
    for pin, n, mode in (("1", 1024, "single-buffer"),
                         ("0", 768, "two-buffer")):
        p, _, mask = _case(n, n, True)
        monkeypatch.setenv("LBM_RESIDENT_INPLACE", pin)
        with pytest.raises(ValueError, match=mode):
            halo.plan_run(p, mask, mesh, "cuda", 200)
    monkeypatch.setenv("LBM_RESIDENT_INPLACE", "1")
    monkeypatch.setenv("LBM_RESIDENT_FORM", "device")
    p, _, mask = _case(256, 256, True)
    with pytest.raises(ValueError, match="single-buffer"):
        halo.plan_run(p, mask, mesh, "cuda", 200)
    monkeypatch.delenv("LBM_RESIDENT_INPLACE")
    monkeypatch.delenv("LBM_RESIDENT_FORM")
    ss = _onchip_ring_sets(cuda, 1024, 1024, 4, 0, 100, copies=1)[0]
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="single-buffer"):
        resident_ring.RingOnchipImpl(ss, 100, "inplace")
    assert fused.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("env,grid,form", [
    ({}, (256, 256), "onchip"),
    ({"LBM_RESIDENT_INPLACE": "1"}, (256, 256), "inplace"),
    ({}, (768, 768), "inplace"),
    ({}, (1024, 1024), "device")], ids=["256-auto", "256-pinned-1-buf",
                                        "768-auto", "1024-auto"])
def test_sharded_ring_runs_the_planned_form(cuda, env, grid, form,
                                            monkeypatch):
    """Under LBM_SHARD_RESIDENT=1 over 4 shards: the planned form's
    launches (the plan line names it) and cells bit-identical to the
    unsharded run."""
    from lbm_tpu_torch.ops import plan
    from lbm_tpu_torch.parallel import decomp, halo
    from lbm_tpu_torch.runner import run_simulation

    for k in ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_SHARD_RESIDENT", "LBM_RESIDENT_INPLACE",
              "LBM_RESIDENT_FORM"):
        monkeypatch.delenv(k, raising=False)
    p, _, mask = _case(*grid, True)
    base = run_simulation(p, mask, n_iters=200)
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh = decomp.make_mesh(4, devices=[cuda] * 4)
    sp = halo.plan_run(p, mask, mesh, "cuda", 200)
    assert [s.form for s in sp.segments] == [form]
    fused.reset_launches()
    got = run_simulation(p, mask, n_iters=200, mesh=mesh)
    assert fused.LAUNCHES[sp.segments[0].launch_key] == 2
    np.testing.assert_array_equal(got.cells, base.cells)
    np.testing.assert_allclose(got.av_vels, base.av_vels, rtol=TRAJ_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["256x256/4", "512x128/4-x-plan"])
def test_ring_onchip_resumes_across_modes(cuda, case):
    """A call in two buffers, then a new wrapper in one buffer on the same
    shards (its own slots, tags from zero, as after a resume or
    a change of pin between chunks), then the device ring: 300 plain
    steps, bit for bit."""
    from lbm_tpu_torch.parallel import resident_ring

    nx, ny, n, axis = ONCHIP_RING_CASES[case]
    ss, plain = _onchip_ring_sets(cuda, nx, ny, n, axis, 300)
    rings = [resident_ring.RingOnchipImpl(ss, 100, "onchip"),
             resident_ring.RingOnchipImpl(ss, 100, "inplace"),
             resident_ring.RingShardImpl(ss, 100)]
    for t, ring in zip((0, 100, 200), rings):
        ring.run(t)
    ss.synchronize()
    _plain_steps(plain, 300)
    assert torch.equal(ss.gather(), plain.gather())


def _ring_scratch(ring):
    """The addresses of a ring wrapper's slots, flags and tickets."""
    return {v.data_ptr() for b in ring._bufs for k, v in b.items()
            if k in ("halo", "ticket", "halo_s", "halo_n", "sync")}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["onchip", "inplace", "device"])
def test_ring_freed_while_its_launch_runs_leaves_the_next_ring_whole(
        cuda, form):
    """A ring dropped right after a long launch (G=2000, milliseconds),
    with nothing synchronized, then a new wrapper on the same shards: the
    allocator hands the new wrapper the old one's scratch while the old
    launch may still spin on its flags, so the new scratch's zeroing must
    wait behind that launch. At 128x128 over 4 (32 strips a shard) SMs are
    left free, where a zeroing on another stream would run beside the
    launch. Both calls end, and the cells are 2100 plain steps' bit for
    bit."""
    from lbm_tpu_torch.parallel import resident_ring

    ss, plain = _onchip_ring_sets(cuda, 128, 128, 4, 0, 2100)
    first = resident_ring.make_ring(ss, 2000, form)
    first.run(0)
    freed = _ring_scratch(first)
    del first
    second = resident_ring.make_ring(ss, 100, form)
    assert _ring_scratch(second) & freed, "no scratch was reused"
    second.run(2000)
    ss.synchronize()
    _plain_steps(plain, 2100)
    assert torch.equal(ss.gather(), plain.gather())


# The built library's SASS (cuobjdump, scripts/depth_ab_torch.py's
# sass_opcodes with every modifier).

_SASS = {}


def _sass_opcodes():
    """``{kernel<args>: {opcode: count}}`` of every kernel of the built
    library, built once for the whole test run."""
    import importlib.util
    from pathlib import Path

    from lbm_tpu_torch.ops import _build

    if not _SASS:
        root = Path(__file__).resolve().parent.parent
        spec = importlib.util.spec_from_file_location(
            "depth_ab_torch", root / "scripts" / "depth_ab_torch.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        path, _ = _build.build()
        _SASS.update(mod.sass_opcodes(path, None, modifiers=True))
    return _SASS


# The kernels that read, within one launch, what other blocks of it wrote
# in an earlier round or step (the device-memory form and its shift mode,
# whose two residences read the neighbours' cells, edge buffer and step
# counters, the ring, the probe's rounds, the depth kernel's flow form,
# the on-chip kernels' halo slots), and the loads of each that may take
# the non-coherent read-only path (LDG...CONSTANT, what __ldg or a const
# __restrict__ pointer compiles to):
# the on-chip kernels' mask bytes, loaded once into shared memory, and no
# other. A lattice value loaded that way may come from a stale cache line.
# (The tensor-core kernel, mxu_resident_kernel, runs the device form's
# rounds.)
COHERENT_KERNELS = {"fused_depth_flow_kernel<": 2,
                    "resident_kernel<": 6, "resident_shift_kernel<": 6,
                    "ring_kernel<": 4, "probe_kernel<": 7,
                    "resident_onchip_kernel<": 12, "ring_onchip_kernel<": 24,
                    "mxu_resident_kernel": 1}
NONCOHERENT_LOADS = {"resident_onchip_kernel<": {"LDG.E.U8.CONSTANT": 29}}
# The on-chip kernels' halo words (lbm_onchip.cuh's get_word): every
# load of them is one 64-bit relaxed strong load, at device scope or (the
# ring's instantiation for a neighbour on another card) system scope,
# polled until its tag matches; a weak load may be served from a stale L1
# line or hoisted out of the poll. Their other 64-bit loads: none, but the
# ring's nine weak loads of its shard's fields (RingStripShard, the
# launch's arguments). Their only other loads of what other blocks wrote,
# the partials that the last block sums, are the 32-bit strong loads of
# sum_partials_last.
HALO_WORD_LOADS = {"LDG.E.64.STRONG.GPU", "LDG.E.64.STRONG.SYS"}
ONCHIP_OTHER_WIDE_LOADS = {"resident_onchip_kernel<": {},
                           "ring_onchip_kernel<": {"LDG.E.64": 9}}
ONCHIP_PARTIAL_LOADS = {"LDG.E.STRONG.GPU": 31}


@pytest.mark.cuda
def test_cross_block_kernels_load_the_lattice_coherently(cuda):
    """No load of the lattice in a kernel that reads what other blocks of
    its launch wrote takes the non-coherent path; the on-chip kernels'
    mask loads are pinned at their count, and every load of their halo
    words is a 64-bit strong load."""
    seen = dict.fromkeys(COHERENT_KERNELS, 0)
    for name, counts in _sass_opcodes().items():
        prefix = next((k for k in COHERENT_KERNELS if name.startswith(k)),
                      None)
        if prefix is None:
            continue
        seen[prefix] += 1
        noncoherent = {op: n for op, n in counts.items()
                       if op.startswith("LDG") and "CONSTANT" in op}
        assert noncoherent == NONCOHERENT_LOADS.get(prefix, {}), name
        if "onchip_kernel<" in prefix:
            wide = {op: n for op, n in counts.items()
                    if op.startswith("LDG") and ".64" in op}
            assert set(wide) & HALO_WORD_LOADS, (name, wide)
            other = {op: n for op, n in wide.items()
                     if op not in HALO_WORD_LOADS}
            assert other == ONCHIP_OTHER_WIDE_LOADS[prefix], (name, other)
            strong = {op: n for op, n in counts.items()
                      if op.startswith("LDG") and ".64" not in op
                      and "STRONG" in op}
            assert strong == ONCHIP_PARTIAL_LOADS, (name, strong)
    assert seen == COHERENT_KERNELS


@pytest.mark.cuda
def test_two_buffer_onchip_kernels_keep_their_pinned_sass(cuda):
    """The on-chip kernels in two buffers: every opcode count (every
    modifier) of the copy pinned from the build of the tagged halo words
    (``scripts/sass_diff_torch.py --pin-onchip``), so that a change to the
    single-buffer mode, which shares their source file, leaves them
    alone."""
    import json
    from pathlib import Path

    pinned = json.loads((Path(__file__).resolve().parent.parent / "docs" /
                         "artifacts" / "onchip_two_buffer_sass.json")
                        .read_text())["kernels"]
    got = {k: v for k, v in _sass_opcodes().items()
           if "onchip_kernel<" in k and k.split("<")[1].split(",")[2] in (
               "2", "2>")}
    assert sorted(got) == sorted(pinned)
    for name in pinned:
        assert got[name] == pinned[name], name



@pytest.mark.cuda
def test_runner_spans_hold_the_launches_on_the_card(cuda, tmp_path):
    """A traced 2000-step 1024^2 ``auto`` run: one ``lbm.segment.depth``
    span, its args (in the trace's metadata) ``steps_per_call=100`` (the
    flow form's 25 rounds of 4), with the ``cudaLaunchKernel`` of every
    ``fused_depth_flow_kernel`` launch inside it; the collate copy's page
    faults a count; the wrappers' own host time below the compute
    phase's."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile

    from lbm_tpu_torch.runner import run_simulation

    p = Params(nx=1024, ny=1024, max_iters=2000, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    mask = generate_obstacles(p.nx, p.ny)
    mask[:, 341] = True
    run_simulation(p, mask)  # builds or loads every kernel
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # Device work held inside the profiler's host-clock window.
        torch.cuda.synchronize()
        time.sleep(0.02)
        r = run_simulation(p, mask)
        torch.cuda.synchronize()
        time.sleep(0.02)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    events = [e for e in data["traceEvents"] if e.get("ph") == "X"]
    segs = [e for e in events if e["name"].startswith("lbm.segment.")
            and e.get("cat") == "user_annotation"]
    assert [e["name"] for e in segs] == ["lbm.segment.depth"]
    args = [v for k, v in data.items() if k.startswith("lbm.span.")
            and v.startswith("lbm.segment.")]
    assert len(args) == 1 and args[0].endswith(
        "kernel=depth steps_per_call=100 form=- steps=2000")
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel"
               and "fused_depth_flow_kernel" in e["name"]}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e["args"].get("correlation") in kernels]
    assert len(kernels) == len(calls) == 20
    seg = segs[0]
    assert all(e["name"] == "cudaLaunchKernel" and seg["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= seg["ts"] + seg["dur"]
               for e in calls)
    t = r.timings
    # A count, and no more: a host whose kernel charges a process no page
    # faults reads 0 here (getrusage reads 0 even for the first touch of a
    # fresh mapping on such a host).
    assert type(t["collate.copy.minflt"]) is int
    assert t["collate.copy.minflt"] >= 0
    assert 0 < t["compute.wrappers"] < t["compute"]


@pytest.mark.cuda
def test_collate_destination_is_prepared_behind_the_queue(cuda, tmp_path):
    """A whole 1024^2 scene through ``run_simulation``: the final lattice
    bit for bit ``simulate``'s, copied into an array prepared while the
    device ran the queued launches (``compute.prefault.hidden`` 1), under
    the span ``lbm.compute.prefault`` inside ``lbm.compute``; each call's
    array its own."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from lbm_tpu_torch.runner import run_simulation, simulate

    p = Params(nx=1024, ny=1024, max_iters=20000, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    mask = generate_obstacles(p.nx, p.ny)
    mask[:, 341] = True
    a = run_simulation(p, mask)
    cells, _ = simulate(p, initial_state(p, cuda),
                        torch.from_numpy(mask).to(cuda))
    np.testing.assert_array_equal(a.cells, cells.cpu().numpy())
    t = a.timings
    assert t["compute.prefault.hidden"] == 1
    assert type(t["compute.prefault.hidden"]) is int
    assert 0 < t["compute.prefault"] < t["compute"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b = run_simulation(p, mask)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    compute, = [e for e in events if e["name"] == "lbm.compute"]
    prefault, = [e for e in events if e["name"] == "lbm.compute.prefault"]
    assert compute["ts"] <= prefault["ts"] and (
        prefault["ts"] + prefault["dur"] <= compute["ts"] + compute["dur"])
    np.testing.assert_array_equal(b.cells, a.cells)
    assert not np.shares_memory(a.cells, b.cells)
    assert b.cells.flags.c_contiguous and b.cells.flags.writeable
