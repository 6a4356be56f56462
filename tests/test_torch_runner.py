"""The slice as a whole: lbm_tpu_torch.runner against lbm_tpu.runner on
a generated scene (f32 and f64), and a JAX trajectory continued in the
port."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu import observables as jobs
from lbm_tpu import runner as jrunner
from lbm_tpu.obstacles import generate_obstacles, num_non_obstacles_r
from lbm_tpu.params import Params
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch import observables as tobs
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.state import from_numpy, to_numpy

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4


def _scene(iters=200, dtype=np.float32):
    p = Params(nx=128, ny=64, max_iters=iters, reynolds_dim=10,
               density=0.1, accel=0.005, omega=1.85, dtype=dtype)
    mask = generate_obstacles(p.nx, p.ny)
    mask[:, p.nx // 3] = True  # an interior column, as in the 1024² scene
    return p, mask


def test_run_simulation_matches_lbm_tpu():
    p, mask = _scene()
    want = jrunner.run_simulation(p, mask, kernel="reference")
    got = trunner.run_simulation(p, mask, kernel="auto", device="cpu")
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.cells.dtype == np.float32 and got.av_vels.shape == (200,)
    np.testing.assert_allclose(got.cells, want.cells, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=TRAJ_RTOL)
    assert np.isclose(got.reynolds, want.reynolds, rtol=TRAJ_RTOL)
    # The plain path launches no wrapper: no "compute.wrappers".
    assert set(got.timings) == {"init", "init.plan", "compute", "collate",
                                "collate.copy", "collate.copy.minflt",
                                "collate.copy.bytes", "compute.launches.cols",
                                "total"}
    assert got.completed_steps == 200 and not got.preempted


def test_jax_trajectory_continues_in_the_port():
    """50 JAX steps, carried across with from_numpy, then 50 port steps,
    against 100 JAX steps."""
    p, mask = _scene(iters=100)
    inv = num_non_obstacles_r(mask)
    c0 = jnp.asarray(initial_state_np(p))
    mj = jnp.asarray(mask)
    c50, _ = jrunner.make_simulate(p, kernel="reference", n_iters=50)(c0, mj, inv)
    c100, a100 = jrunner.make_simulate(p, kernel="reference", n_iters=100)(
        jnp.asarray(initial_state_np(p)), mj, inv)

    cells, mt = from_numpy(np.asarray(c50), mask)
    ct, at = trunner.simulate(p, cells, mt, kernel="reference", n_iters=50)
    np.testing.assert_allclose(to_numpy(ct), np.asarray(c100),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_numpy(at), np.asarray(a100)[50:],
                               rtol=TRAJ_RTOL)


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


def test_float64_matches_lbm_tpu(tmp_path):
    p, mask = _scene(iters=20, dtype=np.float64)
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, mask=mask, nx=p.nx, ny=p.ny)
    res = subprocess.run(
        [sys.executable, "-c", _F64_SCRIPT, str(inp), str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    want = np.load(out)
    got = trunner.run_simulation(p, mask, device="cpu")
    assert got.cells.dtype == np.float64
    np.testing.assert_allclose(got.cells, want["cells"], rtol=1e-12)
    np.testing.assert_allclose(got.av_vels, want["av_vels"], rtol=1e-12)
    assert np.isclose(got.reynolds, float(want["reynolds"]), rtol=1e-12)


def test_run_simulation_refuses_what_it_cannot_run():
    p, mask = _scene(iters=5)
    with pytest.raises(ValueError, match="positive"):
        trunner.run_simulation(p, mask, n_iters=0, device="cpu")
    with pytest.raises(ValueError, match="unknown kernel"):
        trunner.run_simulation(p, mask, kernel="pallas", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            trunner.run_simulation(p, mask, device="cuda")
    p64, _ = _scene(iters=5, dtype=np.float64)
    with pytest.raises(ValueError, match="float32-only"):
        trunner._resolve_kernel("cuda", p64, torch.device("cuda"))
    assert trunner._resolve_kernel("auto", p64, torch.device("cuda")) == "reference"


def test_observables_match_lbm_tpu():
    p, mask = _scene()
    rng = np.random.default_rng(5)
    cells = rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(np.float32)
    cj, mj = jnp.asarray(cells), jnp.asarray(mask)
    ct, mt = torch.from_numpy(cells), torch.from_numpy(mask)
    for want, got in zip(jobs.macroscopic(cj), tobs.macroscopic(ct)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for want, got in [
        (jobs.av_velocity(cj, mj), tobs.av_velocity(ct, mt)),
        (jobs.calc_reynolds(p, cj, mj), tobs.calc_reynolds(p, ct, mt)),
        (jobs.total_density(cj), tobs.total_density(ct)),
    ]:
        assert got.dtype == torch.float32
        assert np.isclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("kernel", ["reference", "cuda"])
def test_each_result_is_the_callers_own_array(kernel, monkeypatch):
    """Two calls in a row, on the plain path and on the planned ``cuda``
    path (its wrappers' plain versions on CPU tensors): each ``cells`` a
    C-contiguous, writeable float32 (9, ny, nx) array, the two sharing no
    memory."""
    monkeypatch.setattr(trunner, "_resolve_kernel", lambda k, p, d: k)
    p, mask = _scene(iters=5)
    a = trunner.run_simulation(p, mask, kernel=kernel, device="cpu")
    b = trunner.run_simulation(p, mask, kernel=kernel, device="cpu")
    for r in (a, b):
        assert r.cells.shape == (9, p.ny, p.nx)
        assert r.cells.dtype == np.float32
        assert r.cells.flags.c_contiguous and r.cells.flags.writeable
    assert not np.shares_memory(a.cells, b.cells)
    np.testing.assert_array_equal(a.cells, b.cells)
    b.cells[:] = 0
    assert a.cells.any()


@pytest.mark.parametrize("shape, dtype", [
    ((9, 64, 128), np.float32), ((9, 1024, 1024), np.float32),
    ((9, 3, 5), np.float64), ((9, 0, 4), np.float32)])
def test_prefaulted_array_is_a_fresh_destination(shape, dtype):
    """The collate's prepared destination: a fresh C-contiguous, writeable
    array of the shape and dtype asked for, its own memory each call."""
    a = trunner.prefaulted_array(shape, dtype)
    b = trunner.prefaulted_array(shape, dtype)
    for x in (a, b):
        assert x.shape == shape and x.dtype == dtype
        assert x.flags.c_contiguous and x.flags.writeable
    assert a.size == 0 or not np.shares_memory(a, b)
    src = torch.rand(shape, dtype=torch.from_numpy(a).dtype)
    torch.from_numpy(a).copy_(src)
    np.testing.assert_array_equal(a, src.numpy())
