"""The wide-grid x-plan of the port's sharded path on ``[cpu] * n`` meshes,
against the JAX package on its 8 virtual CPU devices (tests/conftest.py):

- the mesh planners on wide grids: the plan (``transposed``), rows a
  shard, pad mode and pad against ``plan_sharding`` /
  ``plan_padding_mode(backend="cpu")``, and ``resolve_mesh``'s notes;
- the x-sharded trajectory against ``run_simulation(kernel="pallas",
  mesh=)`` (``_TransposedPallasShardImpl`` in interpret mode), as
  tests/test_sharded.py:158-187 runs it, and exactly equal to the port's
  unsharded transposed run;
- the seam modes in column mode against the plain shard step, and the
  plain shard step in column mode against the global transposed update;
- the column-mode ring against JAX's ``TransposedRingShardImpl`` in the
  Pallas TPU interpreter (slow: 4 steps at G=4).

The port's ``cuda`` path runs on CPU tensors, where every wrapper takes
its plain version. Bounds: cells rtol 2e-5 / atol 5e-8, av_vels rtol 1e-4
(tests/test_pallas.py:148-149).

The port's layout rule keeps grids up to 512x512 cells physical
(``ops.plan.transposed_layout``, PERF.md), and grids that small are the
only ones the JAX interpreter can run here. So these tests plan with
JAX's rule, patched into the one place the port keeps its rule: they
hold the x-plan's machinery to JAX's. The last test plans with the
port's own rule.
"""

import numpy as np
import pytest
import torch

from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.params import Params as JParams
from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.parallel import resident_ring as jring
from lbm_tpu.runner import run_simulation as jrun
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp, halo, resident_ring
from lbm_tpu_torch.state import initial_state, transpose_state

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL, ATOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4
JAX_KERNEL = {"cuda": "pallas", "reference": "reference", "auto": "auto"}
PLAN_ENV = ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_RESIDENT", "LBM_RESIDENT_INPLACE")
PORT_RULE = plan.transposed_layout


@pytest.fixture(autouse=True)
def _clean_env_jax_rule(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(plan, "transposed_layout", pf._transposed_layout)


def _params(nx, ny, iters=12):
    kw = dict(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10, density=0.1,
              accel=0.005, omega=1.85)
    return Params(**kw), JParams(**kw)


def _mask(nx, ny, walls=True, scattered=False):
    mask = generate_obstacles(nx, ny) if walls else np.zeros((ny, nx), bool)
    if scattered:
        rng = np.random.default_rng(nx * ny)
        mask |= rng.random((ny, nx)) < 0.1
        mask[ny - 2, :] |= rng.random(nx) < 0.3
        mask[ny - 2, 5] = False
    return mask


def _meshes(n):
    import jax

    return (decomp.make_mesh(n, devices=[CPU] * n),
            jdecomp.make_mesh(n, devices=jax.devices("cpu")))


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as exc:
        return "error", str(exc)


# Wide grids (nx >= 2 ny, nx % 8 == 0) and one just short of wide; every
# n of the 8 virtual devices that matters: 3 and 6 do not divide these
# nx, so those meshes take the row plan (JAX too).
WIDE = [(128, 16), (64, 16), (40, 16), (256, 30), (128, 30), (48, 24),
        (36, 18)]


@pytest.mark.parametrize("kernel", ["cuda", "reference", "auto"])
def test_wide_plans_match(kernel):
    for nx, ny in WIDE:
        for n in (2, 3, 4, 6, 8):
            for walls in (True, False):
                tp, jp = _params(nx, ny)
                mask = _mask(nx, ny, walls)
                tmesh, jmesh = _meshes(n)
                jk = JAX_KERNEL[kernel]
                where = f"{nx}x{ny} n={n} walls={walls} kernel={kernel}"
                got = _outcome(lambda: halo.plan_padding_mode(tp, mask, tmesh,
                                                              kernel))
                want = _outcome(lambda: jhalo.plan_padding_mode(
                    jp, mask, jmesh, jk, backend="cpu"))
                assert got == want, where
                got = _outcome(lambda: halo.plan_row_padding(tp, mask, tmesh,
                                                             kernel))
                want = _outcome(lambda: jhalo.plan_row_padding(
                    jp, mask, jmesh, jk, backend="cpu"))
                assert got == want, where
                if got[0] != "ok":
                    continue
                sp = halo.plan_run(tp, mask, tmesh, kernel, 12)
                mode, pad = jhalo.plan_padding_mode(jp, mask, jmesh, jk,
                                                    backend="cpu")
                jpp = jhalo.pad_scene(jp, mask, pad)[0] if pad else jp
                jt, jd, _, _ = jhalo.plan_sharding(
                    jpp, jmesh, "reference" if mode == "wrap_ref" else jk,
                    backend="cpu")
                assert (sp.transposed, sp.decomp.local_ny, sp.mode, sp.pad) \
                    == (jt, jd.local_ny, mode, pad), where


@pytest.mark.parametrize("kernel", ["cuda", "reference"])
def test_wide_resolve_mesh_matches(kernel):
    for nx, ny in WIDE:
        for walls in (True, False):
            tp, jp = _params(nx, ny)
            mask = _mask(nx, ny, walls)
            for n in (1, 2, 3, 5, 8, 9):
                tmesh, tnotes = halo.resolve_mesh(tp, mask, n, kernel,
                                                  devices=[CPU] * 8)
                jmesh, jnotes = jhalo.resolve_mesh(jp, mask, n,
                                                   JAX_KERNEL[kernel],
                                                   backend="cpu")
                where = f"{nx}x{ny} walls={walls} n={n}"
                assert tnotes == jnotes, where
                assert (tmesh.size if tmesh else None) == \
                    (jmesh.shape["y"] if jmesh else None), where


def test_named_wide_cases():
    """The two cases the x-plan turns on: a wall-less wide grid whose ny
    does not divide the mesh needs no padding; a wide grid whose nx does
    not divide it takes the row plan, padded behind its walls."""
    tp, jp = _params(128, 30)
    mask = _mask(128, 30, walls=False)
    tmesh, jmesh = _meshes(4)
    sp = halo.plan_run(tp, mask, tmesh, "cuda", 12)
    assert (sp.transposed, sp.mode, sp.pad, sp.decomp.local_ny) == \
        (True, "none", 0, 32)
    assert jhalo.plan_padding_mode(jp, mask, jmesh, "pallas",
                                   backend="cpu") == ("none", 0)
    assert halo.describe(sp, tmesh) == \
        "4 shards of 32 columns (cpu x4): depth D=4 x3 per shard"
    tp, jp = _params(40, 16)
    tmesh, jmesh = _meshes(6)
    sp = halo.plan_run(tp, _mask(40, 16), tmesh, "cuda", 12)
    assert (sp.transposed, sp.mode, sp.pad, sp.decomp.local_ny) == \
        (False, "wall", 2, 3)
    assert not jhalo.plan_sharding(jhalo.pad_scene(jp, _mask(40, 16), 2)[0],
                                   jmesh, "pallas", backend="cpu")[0]
    # The reference kernel and float64 keep the row plan.
    assert not halo.plan_run(tp, _mask(40, 16), _meshes(4)[0], "reference",
                             12).transposed
    with pytest.raises(ValueError, match="row plan"):
        halo._check_wrap_kernel(2, "cuda", transposed=True)


def _unsharded_transposed(p, mask, iters):
    sim = trunner._Simulation(p, initial_state(p, CPU), torch.from_numpy(mask),
                              "cuda", iters)
    assert sim.transposed
    sim.run()
    return sim.cells.numpy(), sim.av_vels.numpy()


def _port_sharded(p, mask, mesh, iters):
    sp = halo.plan_run(p, mask, mesh, "cuda", iters)
    sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, CPU),
                                 sp.obstacles, mesh, sp.kernel, iters,
                                 sp.wrap_pad)
    sim.run()
    cells, av = sim.result()
    return cells.numpy(), av.numpy(), sp, sim


@pytest.mark.parametrize("n,scattered", [(4, False), (8, True)],
                         ids=["4-shards", "8-shards-scattered"])
def test_x_sharded_run_matches_jax_and_the_unsharded_port(n, scattered):
    iters = 12
    tp, jp = _params(128, 16, iters)
    mask = _mask(128, 16, scattered=scattered)
    tmesh, jmesh = _meshes(n)
    cells, av, sp, sim = _port_sharded(tp, mask, tmesh, iters)
    assert sp.transposed and sim.ss.axis == 1
    assert plan.describe(sp.segments) == "depth D=4 x3"
    want = jrun(jp, mask, kernel="pallas", mesh=jmesh)
    np.testing.assert_allclose(cells, want.cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av, want.av_vels, rtol=TRAJ_RTOL)
    base_cells, base_av = _unsharded_transposed(tp, mask, iters)
    np.testing.assert_array_equal(cells, base_cells)
    np.testing.assert_allclose(av, base_av, rtol=1e-6)


@pytest.mark.parametrize("env,segments", [
    ({"LBM_PALLAS_DEPTH": "1"}, "step x12"),
    ({"LBM_PALLAS_DEPTH": "2"}, "depth D=2 x6"),
    ({"LBM_SHARD_RESIDENT": "1", "LBM_RESIDENT_STEPS": "4"}, "ring G=4 x3"),
], ids=["step", "depth-2", "ring"])
def test_x_sharded_plans_equal_the_unsharded_transposed_run(env, segments,
                                                            monkeypatch):
    """Every x-plan (seam one-step, seam depth, the column ring) gives
    the unsharded transposed run's cells bit for bit."""
    iters = 12
    tp, _ = _params(64, 16, iters)
    mask = _mask(64, 16, scattered=True)
    base_cells, base_av = _unsharded_transposed(tp, mask, iters)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cells, av, sp, sim = _port_sharded(tp, mask, _meshes(8)[0], iters)
    assert sp.transposed and plan.describe(sp.segments) == segments
    if "ring" in segments:
        assert isinstance(sim._impls[0][0], resident_ring.RingShardImpl)
        assert sim._impls[0][0].axis == 1
    np.testing.assert_array_equal(cells, base_cells)
    np.testing.assert_allclose(av, base_av, rtol=1e-6)


def test_column_seam_kernels_equal_the_plain_shard_step():
    """One call of each column-mode seam path equals as many plain shard
    steps in column mode, bit for bit, from a state whose forced column
    fails the guard in places; the plain shard steps equal the global
    transposed update; the x-plan's shard set gathers back the physical
    lattice."""
    rng = np.random.default_rng(7)
    p, _ = _params(64, 16)
    mask = _mask(64, 16, scattered=True)
    c0 = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 16, 64)).astype(np.float32))
    c0[6, 14, torch.from_numpy(rng.random(64) < 0.3)] = float(p.accel_w2)
    mesh = _meshes(8)[0]
    assert torch.equal(halo.ShardSet(p, c0, mask, mesh, 4, axis=1).gather(), c0)
    mt = torch.from_numpy(mask.T.copy())
    for depth in (1, 2, 4, 8):
        ss = halo.ShardSet(p, c0, mask, mesh, 8, axis=1)
        halo.SeamShardImpl(ss, depth).run(0)
        rs = halo.ShardSet(p, c0, mask, mesh, 8, axis=1)
        ref = halo.ReferenceShardImpl(rs)
        for t in range(depth):
            ref.run(t)
        assert torch.equal(ss.gather(), rs.gather()), depth
        np.testing.assert_allclose(ss.av_vels(1.0)[:depth].numpy(),
                                   rs.av_vels(1.0)[:depth].numpy(), rtol=1e-5)
        want, _ = ref_ops.multi_step(transpose_state(c0), mt, p.accel_w1,
                                     p.accel_w2, p.omega, depth, axis=1)
        assert torch.equal(rs.gather(), transpose_state(want)), depth


def test_column_halo_multi_step_is_the_global_update():
    """The seam kernels' plain version in column mode on one shard of the
    transposed lattice equals n global column-mode steps on its rows."""
    rng = np.random.default_rng(9)
    p, _ = _params(24, 20)
    c = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 24, 20)).astype(np.float32))
    c[8, :, 18][torch.from_numpy(rng.random(24) < 0.3)] = float(p.accel_w2)
    mask = torch.from_numpy(rng.random((24, 20)) < 0.15)
    w = (p.accel_w1, p.accel_w2, p.omega)
    for row0, h, k, n in [(16, 8, 4, 4), (20, 4, 4, 3), (0, 8, 2, 2),
                          (8, 8, 1, 1)]:
        rows = torch.arange(row0 - k, row0 + h + k) % 24
        win, m = c[:, rows], mask[rows]
        got, tots = ref_ops.halo_multi_step(
            win[:, k:k + h], win[:, :k], win[:, k + h:], m[k:k + h], m[:k],
            m[k + h:], row0, 24, *w, n, axis=1)
        want, _ = ref_ops.multi_step(c, mask, *w, n, axis=1)
        assert torch.equal(got, want[:, row0:row0 + h]), (row0, h, k)
        assert tots.shape == (n,)


def test_column_ring_matches_jax_transposed_ring(monkeypatch):
    """4 steps at G=4 over 8 shards of 8 columns (the JAX interpreter is
    slow), obstacles on the forced line."""
    monkeypatch.setenv("LBM_SHARD_RESIDENT", "1")
    monkeypatch.setenv("LBM_RESIDENT_STEPS", "4")
    tp, jp = _params(64, 16, 4)
    mask = _mask(64, 16, scattered=True)
    tmesh, jmesh = _meshes(8)
    cells, av, sp, sim = _port_sharded(tp, mask, tmesh, 4)
    assert sp.transposed and plan.describe(sp.segments) == "ring G=4 x1"
    assert jring.ring_planned(jp, jmesh, 4)
    assert jhalo.plan_sharding(jp, jmesh, "pallas", backend="cpu")[0]
    want = jrun(jp, mask, kernel="pallas", mesh=jmesh)
    np.testing.assert_allclose(cells, want.cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(av, want.av_vels, rtol=RTOL)
    base_cells, _ = _unsharded_transposed(tp, mask, 4)
    np.testing.assert_array_equal(cells, base_cells)


def test_port_rule_plans_the_x_plan_above_the_resident_size(monkeypatch):
    """With the port's own rule: 131072x128 over 4 takes the x-plan (32768
    columns a shard, nothing padded), as JAX plans it; a small wide grid
    takes the row plan, as the port's unsharded run keeps it physical."""
    monkeypatch.setattr(plan, "transposed_layout", PORT_RULE)
    tmesh, jmesh = _meshes(4)
    tp, jp = _params(131072, 128)
    mask = _mask(131072, 128)
    sp = halo.plan_run(tp, mask, tmesh, "cuda", 200)
    assert (sp.transposed, sp.mode, sp.pad, sp.decomp.local_ny) == \
        (True, "none", 0, 32768)
    jt, jd, _, _ = jhalo.plan_sharding(jp, jmesh, "pallas", backend="cpu")
    assert (jt, jd.local_ny) == (True, 32768)
    assert halo.describe(sp, tmesh) == \
        "4 shards of 32768 columns (cpu x4): depth D=4 x50 per shard"
    tp, _ = _params(128, 16)
    sp = halo.plan_run(tp, _mask(128, 16), tmesh, "cuda", 12)
    assert not sp.transposed and sp.decomp.local_ny == 4
    assert not trunner.plan_layout(tp, "cuda")
