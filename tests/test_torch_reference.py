"""The port's plain ops (lbm_tpu_torch.ops.reference) against
lbm_tpu.ops.reference on the CPU: the same seeded inputs through both,
in all three f32 association modes, on a wide, an odd-sized and a
wall-less periodic scene, plus float64."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles
from lbm_tpu.ops import reference as jref
from lbm_tpu.params import Params
from lbm_tpu.runner import make_simulate
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.ops import reference as tref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

# One step: the repo's kernel-vs-reference bounds (tests/test_pallas.py);
# trajectories: its av_vels bound.
RTOL, ATOL, TOT_RTOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4, 1e-4

MODES = {
    "paired": {},
    "reference_order": {"LBM_PAIRED_EQ": "0"},
    "omega_absorbed": {"LBM_OMEGA_EQ": "1"},
}


def _params(ny, nx, dtype=np.float32, **kw):
    base = dict(nx=nx, ny=ny, max_iters=200, reynolds_dim=10,
                density=0.1, accel=0.005, omega=1.85, dtype=dtype)
    base.update(kw)
    return Params(**base)


def _mask(kind, ny, nx):
    if kind == "walls":
        return generate_obstacles(nx, ny)
    # Wall-less: periodic wrap in both axes, random interior obstacles,
    # some of them on the forced row ny-2.
    rng = np.random.default_rng(11)
    return rng.random((ny, nx)) < 0.15


def _state(p, seed=0):
    """Random state whose forced row fails the guard in places: speed 6
    below its weight, and speed 3 exactly at it (the guard is strict)."""
    rng = np.random.default_rng(seed)
    d = p.dtype
    cells = rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(d)
    row = p.ny - 2
    pick = rng.random(p.nx)
    cells[6, row, pick < 0.3] = d(p.accel_w2) * d(0.5)
    cells[3, row, (pick >= 0.3) & (pick < 0.5)] = d(p.accel_w1)
    return cells


SHAPES = [(32, 128, "walls"), (24, 100, "walls"), (48, 64, "wall-less")]


def _set_mode(monkeypatch, mode):
    monkeypatch.delenv("LBM_PAIRED_EQ", raising=False)
    monkeypatch.delenv("LBM_OMEGA_EQ", raising=False)
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-{s[2]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_one_step_matches_lbm_tpu(shape, mode, monkeypatch):
    ny, nx, kind = shape
    _set_mode(monkeypatch, mode)
    p = _params(ny, nx)
    cells, mask = _state(p), _mask(kind, ny, nx)
    w1, w2, om = p.accel_w1, p.accel_w2, p.omega
    cj, mj = jnp.asarray(cells), jnp.asarray(mask)
    ct, mt = torch.from_numpy(cells), torch.from_numpy(mask)

    np.testing.assert_allclose(
        tref.accelerate_flow(ct, mt, w1, w2).numpy(),
        np.asarray(jref.accelerate_flow(cj, mj, w1, w2)), rtol=RTOL, atol=ATOL,
    )
    for fj, ft in [
        (lambda: jref.collide_stream(cj, mj, om),
         lambda: tref.collide_stream(ct, mt, om)),
        (lambda: jref.fused_step(cj, mj, w1, w2, om),
         lambda: tref.fused_step(ct, mt, w1, w2, om)),
    ]:
        (want, want_tot), (got, got_tot) = fj(), ft()
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
        assert np.isclose(float(got_tot), float(want_tot), rtol=TOT_RTOL)
        # Stronger than the bound: op for op, the twin is bit-identical
        # to lbm_tpu's un-jitted jnp ops (same association, IEEE ops).
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forcing_guard_is_exercised():
    """The seeded state forces some cells of row ny-2 and not others."""
    p = _params(32, 128)
    cells = torch.from_numpy(_state(p))
    mask = torch.from_numpy(_mask("walls", 32, 128))
    out = tref.accelerate_flow(cells, mask, p.accel_w1, p.accel_w2)
    changed = (out[1, p.ny - 2] != cells[1, p.ny - 2])
    assert 0 < int(changed.sum()) < p.nx
    assert torch.equal(out[:, : p.ny - 2], cells[:, : p.ny - 2])


@pytest.mark.parametrize("mode", list(MODES))
def test_200_step_trajectory_matches_lbm_tpu(mode, monkeypatch):
    _set_mode(monkeypatch, mode)
    p = _params(64, 128)
    mask = generate_obstacles(p.nx, p.ny)
    inv = np.float32(1.0) / np.float32(mask.size - mask.sum())
    cj, aj = make_simulate(p, kernel="reference", n_iters=200)(
        jnp.asarray(initial_state_np(p)), jnp.asarray(mask), inv)
    ct, at = trunner.simulate(
        p, torch.from_numpy(initial_state_np(p)), torch.from_numpy(mask),
        kernel="reference", n_iters=200,
    )
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=TRAJ_RTOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=RTOL, atol=ATOL)


def test_density_conserved_on_wall_less_scene():
    p = _params(48, 64)
    cells = torch.from_numpy(_state(p))
    mask = torch.from_numpy(_mask("wall-less", 48, 64))
    before = float(cells.double().sum())
    out, _ = tref.collide_stream(cells, mask, p.omega)
    assert abs(float(out.double().sum()) - before) / before < 1e-5


_F64_SCRIPT = """
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from lbm_tpu.ops.reference import fused_step
z = np.load(sys.argv[1])
cells, mask = jnp.asarray(z["cells"]), jnp.asarray(z["mask"])
w1, w2, om = (np.float64(z[k]) for k in ("w1", "w2", "omega"))
tots = []
for _ in range(int(z["steps"])):
    cells, tot = fused_step(cells, mask, w1, w2, om)
    tots.append(float(tot))
np.savez(sys.argv[2], cells=np.asarray(cells), tots=np.asarray(tots))
"""


def test_float64_20_steps_match_lbm_tpu(tmp_path):
    """float64 keeps the reference order; 20 steps agree at 1e-12. The
    JAX side runs in a subprocess because x64 is process-global."""
    p = _params(24, 100, dtype=np.float64)
    cells, mask = _state(p, seed=3), _mask("wall-less", 24, 100)
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, cells=cells, mask=mask, w1=p.accel_w1, w2=p.accel_w2,
             omega=p.omega, steps=20)
    res = subprocess.run(
        [sys.executable, "-c", _F64_SCRIPT, str(inp), str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    want = np.load(out)
    ct, mt = torch.from_numpy(cells), torch.from_numpy(mask)
    tots = []
    for _ in range(20):
        ct, tot = tref.fused_step(ct, mt, p.accel_w1, p.accel_w2, p.omega)
        tots.append(float(tot))
    assert ct.dtype == torch.float64
    np.testing.assert_allclose(ct.numpy(), want["cells"], rtol=1e-12)
    np.testing.assert_allclose(tots, want["tots"], rtol=1e-12)
