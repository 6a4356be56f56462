"""The port's row-sharded path on ``[cpu] * n`` meshes against the JAX
package's sharded runs on its 8 virtual CPU devices (tests/conftest.py),
for the row cases of ``__graft_entry__._dryrun_cases``.

The JAX side runs ``kernel="reference"`` and ``kernel="pallas"`` (in
interpret mode), as tests/test_sharded.py does. The port's ``cuda`` path
runs on CPU tensors, where each kernel wrapper takes its plain version
(:func:`lbm_tpu_torch.ops.reference.halo_multi_step` on the halos the
exchange filled), so the planning, padding, halo exchange, wrap
discipline and fixed-order reduction are the ones the card runs.

Bounds: av_vels within rtol 1e-4 of the JAX run (XLA's jit moves the f32
trajectory by ulps, ROADMAP section 3); final cells exactly equal to the
port's own unsharded run (the same per-cell arithmetic); float64 at the
reference order within rtol 1e-10 of the JAX package's float64 run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu.parallel import decomp as jdecomp
from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.runner import run_simulation as jrun
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.obstacles import generate_obstacles, write_obstacles
from lbm_tpu_torch.ops import fused
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.parallel import decomp, halo
from lbm_tpu_torch.state import initial_state

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
TRAJ_RTOL, F64_RTOL = 1e-4, 1e-10
N = 8
PLAN_ENV = ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
            "LBM_RESIDENT", "LBM_RESIDENT_INPLACE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in PLAN_ENV:
        monkeypatch.delenv(k, raising=False)


def _params(nx, ny, iters=20, dtype=np.float32):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85, dtype=dtype)


def _jparams(p):
    from lbm_tpu.params import Params as JParams

    return JParams(nx=p.nx, ny=p.ny, max_iters=p.max_iters,
                   reynolds_dim=p.reynolds_dim, density=p.density,
                   accel=p.accel, omega=p.omega, dtype=p.dtype)


def _cpu_mesh(n):
    return decomp.make_mesh(n, devices=[CPU] * n)


def port_sharded(p, mask, mesh, kernel):
    """The port's sharded run: ``(cells, av_vels, plan)``, the cells
    unpadded. ``cuda`` steps the planned kernel path on CPU tensors."""
    sp = halo.plan_run(p, mask, mesh, kernel, p.max_iters)
    sim = halo.ShardedSimulation(sp.params, initial_state(sp.params, CPU),
                                 sp.obstacles, mesh, sp.kernel, p.max_iters,
                                 sp.wrap_pad)
    sim.run()
    cells, av = sim.result()
    return cells[:, sp.pad:].numpy(), av.numpy(), sp


ROWS = 2 * N  # 16: two rows a shard, the forced row on a shard edge
NONDIV = 8 * N + 2  # 66: no divisor of 8
CASES = {
    # name: (nx, ny, walls, kernel, the planned per-shard segments)
    "reference/rows": (32, ROWS, True, "reference", "reference x20"),
    "pallas/rows": (ROWS, ROWS, True, "cuda", "depth D=2 x10"),
    "pallas/rows-fused": (8, 8 * N, True, "cuda", "depth D=4 x5"),
    "pallas/rows-padded": (32, NONDIV, True, "cuda", "depth D=4 x5"),
    "reference/wall-less-wrap": (32, NONDIV, False, "reference", "reference x20"),
    "pallas/wall-less-wrap": (32, NONDIV, False, "cuda", "step x20"),
    "reference/wall-less-fallback": (32, N + 1, False, "reference",
                                     "reference x20"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_jax_and_the_unsharded_port(name):
    nx, ny, walls, kernel, segs = CASES[name]
    p = _params(nx, ny)
    mask = generate_obstacles(nx, ny) if walls else np.zeros((ny, nx), bool)
    jk = {"cuda": "pallas"}.get(kernel, kernel)
    if "wall-less" in name:
        jmesh, jnotes = jhalo.resolve_mesh(_jparams(p), mask, N, jk,
                                           backend="cpu")
        mesh, notes = halo.resolve_mesh(p, mask, N, kernel,
                                        devices=[CPU] * N)
        assert notes == jnotes
        assert mesh.size == jmesh.shape["y"]
        assert mesh.size == (3 if "fallback" in name else N)
    else:
        jmesh, mesh = jdecomp.make_mesh(N), _cpu_mesh(N)
    cells, av, sp = port_sharded(p, mask, mesh, kernel)
    from lbm_tpu_torch.ops import plan

    assert plan.describe(sp.segments) == segs
    want = jrun(_jparams(p), mask, kernel=jk, mesh=jmesh)
    np.testing.assert_allclose(av, want.av_vels, rtol=TRAJ_RTOL)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(cells, base.cells)
    np.testing.assert_allclose(av, base.av_vels, rtol=TRAJ_RTOL)


def test_run_simulation_with_a_mesh():
    """Through the entry point: padding sliced off, Reynolds number on
    the unpadded lattice, bit-identical repeats."""
    p = _params(32, NONDIV)
    mask = generate_obstacles(32, NONDIV)
    mask[NONDIV - 2, 5:9] = True
    mesh = _cpu_mesh(N)
    a = trunner.run_simulation(p, mask, kernel="reference", mesh=mesh)
    b = trunner.run_simulation(p, mask, kernel="reference", mesh=mesh)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    assert a.cells.shape == (9, NONDIV, 32)
    np.testing.assert_array_equal(a.cells, base.cells)
    np.testing.assert_array_equal(a.cells, b.cells)
    np.testing.assert_array_equal(a.av_vels, b.av_vels)
    assert np.isclose(a.reynolds, base.reynolds, rtol=1e-6)
    assert set(a.timings) >= {"init", "compute", "collate", "total"}


def test_no_fallback_from_the_kernel_path():
    p = _params(16, 16)
    mask = generate_obstacles(16, 16)
    with pytest.raises(ValueError, match="needs CUDA devices"):
        trunner.run_simulation(p, mask, kernel="cuda", mesh=_cpu_mesh(4))
    cuda_mesh = decomp.make_mesh(4, devices=[torch.device("cuda:0")] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            trunner.run_simulation(p, mask, mesh=cuda_mesh)
    with pytest.raises(ValueError, match="float32-only"):
        halo.resolve_shard_kernel(_params(16, 16, dtype=np.float64),
                                  cuda_mesh, "cuda")
    assert halo.resolve_shard_kernel(_params(16, 16), cuda_mesh, "auto") == "cuda"


def test_forced_row_on_a_shard_edge_and_in_a_deep_halo():
    """16 rows over 8 shards: the forced row 14 is shard 7's row 0 and
    the first row of shard 6's north halo (1 or 2 rows deep). Obstacles
    on the forced row exercise the guard. One call of each seam path
    equals as many plain shard steps (module 4), bit for bit."""
    rng = np.random.default_rng(55)
    p = _params(64, 16)
    mask = generate_obstacles(64, 16)
    mask[14, :] |= rng.random(64) < 0.3
    mask[14, 5] = False
    mesh = _cpu_mesh(N)
    cells, av, sp = port_sharded(p, mask, mesh, "cuda")
    assert sp.segments[0].kernel == "depth"
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    np.testing.assert_array_equal(cells, base.cells)
    want = jrun(_jparams(p), mask, kernel="reference",
                mesh=jdecomp.make_mesh(N))
    np.testing.assert_allclose(av, want.av_vels, rtol=TRAJ_RTOL)

    # One call of the seam depth path against two module-4 steps, from a
    # state whose forced row fails the guard in places.
    c0 = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 16, 64)).astype(np.float32))
    c0[6, 14, torch.from_numpy(rng.random(64) < 0.3)] = float(p.accel_w2)
    for depth in (1, 2):
        ss = halo.ShardSet(p, c0, mask, mesh, 4)
        halo.SeamShardImpl(ss, depth).run(0)
        got, got_av = ss.gather(), ss.av_vels(1.0)
        rs = halo.ShardSet(p, c0, mask, mesh, 4)
        ref = halo.ReferenceShardImpl(rs)
        for t in range(depth):
            ref.run(t)
        assert torch.equal(got, rs.gather())
        np.testing.assert_allclose(got_av[:depth].numpy(),
                                   rs.av_vels(1.0)[:depth].numpy(), rtol=1e-5)


def test_tail_segments():
    """23 steps: a depth main segment and a one-step tail, on the ring
    planner's path too."""
    p = _params(32, 64, iters=23)
    mask = generate_obstacles(32, 64)
    mesh = _cpu_mesh(N)
    base = trunner.run_simulation(p, mask, kernel="reference", device="cpu")
    cells, av, sp = port_sharded(p, mask, mesh, "cuda")
    assert [s.describe() for s in sp.segments] == \
        ["depth D=4 x5", "depth D=2 x1", "step x1"]
    np.testing.assert_array_equal(cells, base.cells)
    np.testing.assert_allclose(av, base.av_vels, rtol=TRAJ_RTOL)
    assert (av != 0).all()


def test_halo_multi_step_is_module_4():
    """The seam kernels' plain version on one shard equals D steps of the
    global update on its rows, with the forced row in the halo."""
    rng = np.random.default_rng(9)
    p = _params(20, 24)
    c = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 24, 20)).astype(np.float32))
    c[6, 22, torch.from_numpy(rng.random(20) < 0.3)] = float(p.accel_w2)
    mask = torch.from_numpy(rng.random((24, 20)) < 0.15)
    w = (p.accel_w1, p.accel_w2, p.omega)
    for row0, h, k, n in [(16, 8, 4, 4), (20, 4, 4, 3), (0, 8, 2, 2),
                          (8, 8, 1, 1)]:
        rows = torch.arange(row0 - k, row0 + h + k) % 24
        win, m = c[:, rows], mask[rows]
        got, tots = ref_ops.halo_multi_step(
            win[:, k:k + h], win[:, :k], win[:, k + h:], m[k:k + h], m[:k],
            m[k + h:], row0, 24, *w, n)
        want = c
        for s in range(n):
            # The shard's tot_u of step s: the global step's |u| on its rows.
            forced = ref_ops.accelerate_flow(want, mask, p.accel_w1, p.accel_w2)
            planes = [torch.roll(forced[q], (int(cy), int(cx)), (0, 1))
                      for q, (cy, cx) in enumerate(zip(ref_ops.D2Q9.CY,
                                                       ref_ops.D2Q9.CX))]
            _, umag = ref_ops._bgk_update_planes(planes, mask, p.omega)
            own = umag[row0:row0 + h].masked_fill(mask[row0:row0 + h], 0.0)
            assert torch.isclose(tots[s], own.sum(), rtol=1e-5)
            want, _ = ref_ops.fused_step(want, mask, *w)
        assert torch.equal(got, want[:, row0:row0 + h]), (row0, h, k)


def test_launch_counts_stay_zero_on_the_cpu():
    fused.reset_launches()
    p = _params(16, 16)
    port_sharded(p, generate_obstacles(16, 16), _cpu_mesh(4), "cuda")
    assert all(v == 0 for v in fused.LAUNCHES.values())


def test_cli_devices_clamps_to_the_visible_devices(tmp_path, capsys):
    p = _params(32, 16)
    params = tmp_path / "s.params"
    params.write_text("32\n16\n20\n10\n0.1\n0.005\n1.85\n")
    write_obstacles(tmp_path / "o.dat", generate_obstacles(32, 16))
    rc = tcli.main([str(params), str(tmp_path / "o.dat"), "--device", "cpu",
                    "--devices", "4", "--av-vels-file", str(tmp_path / "av"),
                    "--final-state-file", str(tmp_path / "fs")])
    err = capsys.readouterr().err
    assert rc == 0
    assert "note: using 1 devices (1 visible)" in err
    assert "kernel: reference on cpu (float32)" in err
    base = trunner.run_simulation(p, generate_obstacles(32, 16),
                                  kernel="reference", device="cpu")
    av = np.loadtxt(tmp_path / "av", usecols=[1])
    np.testing.assert_allclose(av, base.av_vels, rtol=1e-6)


# The JAX package's sharded float64 path does not run under jax 0.9
# (``accelerate_flow_dynamic``'s dynamic_slice gets int64 and int32
# indices with x64 on), so the float64 oracle is its unsharded run, which
# its sharded run equals by construction (tests/test_sharded.py).
_F64_SCRIPT = """
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
from lbm_tpu.params import Params
from lbm_tpu.runner import run_simulation
z = np.load(sys.argv[1])
p = Params(nx=int(z["nx"]), ny=int(z["ny"]), max_iters=20, reynolds_dim=10,
           density=0.1, accel=0.005, omega=1.85, dtype=np.float64)
r = run_simulation(p, z["mask"], kernel="reference")
np.savez(sys.argv[2], cells=r.cells, av_vels=r.av_vels, reynolds=r.reynolds)
"""


@pytest.mark.parametrize("walls", [True, False], ids=["padded", "wrap"])
def test_float64_matches_jax(tmp_path, walls):
    """float64 over 8 shards with a wall pad or a wrap pad (66 rows), in
    the reference order, against the JAX package in float64."""
    p = _params(32, NONDIV, dtype=np.float64)
    mask = generate_obstacles(32, NONDIV) if walls \
        else np.zeros((NONDIV, 32), bool)
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, mask=mask, nx=p.nx, ny=p.ny)
    env = {"PYTHONPATH": str(REPO), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", _F64_SCRIPT, str(inp), str(out)],
                         capture_output=True, text=True, cwd=REPO, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    want = np.load(out)
    got = trunner.run_simulation(p, mask, kernel="auto", mesh=_cpu_mesh(N))
    assert got.cells.dtype == np.float64
    np.testing.assert_allclose(got.cells, want["cells"], rtol=F64_RTOL,
                               atol=1e-15)
    np.testing.assert_allclose(got.av_vels, want["av_vels"], rtol=F64_RTOL)
    assert np.isclose(got.reynolds, float(want["reynolds"]), rtol=F64_RTOL)
