"""The wide-grid path of the port on one device, on the CPU, against the
JAX package: the transposed layout (``SIGMA``, ``transpose_state``), its
planner rule, the column forcing, and the transposed plans' trajectories
(one-step, depth and resident) against ``make_simulate(kernel="pallas")``
in interpret mode, which builds ``TransposedCarryStep`` /
``TransposedResidentStep`` for these grids. The port's rule keeps grids
up to 512x512 cells physical (PERF.md), so its transposed plans of these
small grids are built on request (``transposed=True``).

The port's ``cuda`` path runs on CPU tensors, where every wrapper takes
its plain version in column mode; the depth kernel's column-mode tiling
is checked through its emulation. The CUDA kernels themselves are held to
the plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Bounds: cells rtol 2e-5 / atol 5e-8, av_vels rtol 1e-4, the repo's
kernel-vs-reference bounds (tests/test_pallas.py:148-149).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.obstacles import generate_obstacles, num_non_obstacles_r
from lbm_tpu.ops import pallas_fused as pf
from lbm_tpu.params import Params
from lbm_tpu.runner import make_simulate
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.ops import fused_depth, plan
from lbm_tpu_torch.ops import reference as ref_ops
from lbm_tpu_torch.state import SIGMA, transpose_state

torch.set_num_threads(2)

RTOL, ATOL, TRAJ_RTOL = 2e-5, 5e-8, 1e-4
PINS = ("LBM_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
        "LBM_RESIDENT_INPLACE", "LBM_SHARD_RESIDENT")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in PINS:
        monkeypatch.delenv(k, raising=False)


def _params(nx, ny, iters):
    return Params(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)


def _mask(nx, ny, scattered):
    """The generator's walls; ``scattered`` adds random obstacles, some
    on the forced row ny-2 (the transposed lattice's forced column)."""
    mask = generate_obstacles(nx, ny)
    if scattered:
        rng = np.random.default_rng(nx + ny)
        mask |= rng.random((ny, nx)) < 0.1
        mask[ny - 2, :] |= rng.random(nx) < 0.3
        mask[ny - 2, 5] = False
    return mask


def test_sigma_and_transpose_state_match_jax():
    assert SIGMA == pf.SIGMA
    rng = np.random.default_rng(12)
    cells = rng.random((9, 16, 40), np.float32)
    got = transpose_state(torch.from_numpy(cells))
    want = np.asarray(pf.transpose_state(jnp.asarray(cells)))
    assert got.shape == (9, 40, 16) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(transpose_state(got), torch.from_numpy(cells))


def test_transposed_layout_is_jax_rule_above_the_resident_size():
    """JAX's rule, narrowed by the H100's timings to grids above the
    resident kernel's size when it was set (512x512 cells, now
    ``plan.TRANSPOSED_MIN_CELLS``): smaller wide grids, where the column
    modes ran slower, keep the physical layout."""
    big = plan.TRANSPOSED_MIN_CELLS
    for ny in (1, 2, 7, 16, 30, 64, 128, 129, 256, 1024):
        for nx in (8, 60, 64, 128, 1024, 2048, 2056, 4096, 16384, 131072):
            assert plan.transposed_layout(ny, nx) == \
                (pf._transposed_layout(ny, nx) and nx * ny > big), (ny, nx)
    for ny, nx in [(128, 131072), (1024, 16384), (128, 4096), (1024, 1024),
                   (100, 130), (256, 1024), (128, 2048), (32, 128)]:
        cls, rows, lanes = pf._layout(_params(nx, ny, 1))
        jax_t = cls is pf.TransposedCarryStep
        if nx * ny > big:
            assert plan.layout(_params(nx, ny, 1)) == (jax_t, rows, lanes)
        else:
            assert plan.layout(_params(nx, ny, 1)) == (False, ny, nx)
    assert not plan.transposed_layout(256, 1024)
    assert plan.transposed_layout(128, 131072)


def test_column_forcing_is_accel_spec_lanes():
    """Deltas and guards of the column mode are ``AccelSpec.lanes``'s,
    and forcing the column of the transposed lattice is forcing the row
    of the physical one, transposed (the forcing is a pure add)."""
    p = _params(40, 16, 1)
    d = np.float32
    spec = pf.AccelSpec.lanes(p, p.ny)
    deltas, guards = ref_ops.forcing(d(p.accel_w1), d(p.accel_w2), axis=1)
    assert [float(x) for x in deltas] == [float(d(x)) for x in spec.deltas]
    assert [(g, float(t)) for g, t in guards] == \
        [(g, float(d(t))) for g, t in spec.guards]
    rng = np.random.default_rng(4)
    c = torch.from_numpy(rng.uniform(0.01, 0.2, (9, 16, 40)).astype(np.float32))
    c[6, 14, torch.from_numpy(rng.random(40) < 0.3)] = float(p.accel_w2)
    mask = torch.from_numpy(_mask(40, 16, True))
    want = transpose_state(ref_ops.accelerate_flow(c, mask, p.accel_w1,
                                                   p.accel_w2))
    got = ref_ops.accelerate_flow(transpose_state(c), mask.T, p.accel_w1,
                                  p.accel_w2, axis=1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("depth", [2, 4, 8])
@pytest.mark.parametrize("tile", [None, (8, 8)], ids=["kernel-tile", "8x8"])
def test_depth_column_tiling_is_multi_step(depth, tile):
    """The depth kernel's tiling in column mode (per-column forced flags,
    the forced column in the window's x-halo) equals ``depth`` plain
    column-mode steps bit for bit, on a ragged wall-less grid whose
    forced column fails the guard in places."""
    p = _params(26, 12, 1)
    rng = np.random.default_rng(depth)
    eq = initial_state_np(p).transpose(0, 2, 1)
    c = (eq * (1 + 0.2 * (rng.random(eq.shape) - 0.5))).astype(np.float32)
    c[8, :, 10][rng.random(26) < 0.3] = np.float32(p.accel_w2)
    c = torch.from_numpy(c)
    mask = torch.from_numpy(rng.random((26, 12)) < 0.15)
    args = (mask, p.accel_w1, p.accel_w2, p.omega, depth)
    want, want_tots = ref_ops.multi_step(c, *args, axis=1)
    got, tots = fused_depth.fused_depth_emulated(c, *args, tile, axis=1)
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.numpy(), want_tots.numpy(), rtol=1e-5)


# The transposed plans against the JAX package's, from rest: (pins, the
# port's planned segments at 8 steps).
PLANS = {
    "step": ({"LBM_PALLAS_DEPTH": "1"}, "step x8"),
    "depth": ({}, "depth D=4 x2"),
    "resident": ({"LBM_RESIDENT": "1", "LBM_RESIDENT_STEPS": "4"},
                 "resident G=4 x2"),
}


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("nx,ny,scattered", [(128, 32, False), (64, 16, True)],
                         ids=["128x32", "64x16-scattered"])
def test_transposed_plan_matches_jax(plan_name, nx, ny, scattered,
                                     monkeypatch):
    env, segments = PLANS[plan_name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    iters = 8
    p = _params(nx, ny, iters)
    mask = _mask(nx, ny, scattered)
    sim = trunner._Simulation(p, torch.from_numpy(initial_state_np(p)),
                              torch.from_numpy(mask), "cuda", iters,
                              transposed=True)
    assert sim.transposed
    assert plan.describe(sim.segments) == segments
    sim.run()
    assert sim.cells.shape == (9, ny, nx)

    want_cells, want_av = make_simulate(p, kernel="pallas", n_iters=iters)(
        jnp.asarray(initial_state_np(p)), jnp.asarray(mask),
        num_non_obstacles_r(mask))
    np.testing.assert_allclose(sim.cells.numpy(), np.asarray(want_cells),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sim.av_vels.numpy(), np.asarray(want_av),
                               rtol=TRAJ_RTOL)


def test_either_layout_of_a_wide_grid_on_request():
    """``transposed`` builds either layout of a wide grid (as JAX code can
    build ``CarryStep`` or ``TransposedCarryStep`` for one); both agree
    within the trajectory bound; the planner's rule decides when it is
    None; the reference never transposes."""
    iters = 12
    p = _params(64, 16, iters)
    mask = torch.from_numpy(_mask(64, 16, True))
    runs = {}
    for t in (None, True, False):
        sim = trunner._Simulation(p, torch.from_numpy(initial_state_np(p)),
                                  mask, "cuda", iters, transposed=t)
        sim.run()
        runs[t] = sim
    assert runs[True].transposed and not runs[False].transposed
    assert not runs[None].transposed  # 1024 cells: below the resident size
    np.testing.assert_array_equal(runs[None].cells.numpy(),
                                  runs[False].cells.numpy())
    np.testing.assert_allclose(runs[True].cells.numpy(),
                               runs[False].cells.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(runs[True].av_vels.numpy(),
                               runs[False].av_vels.numpy(), rtol=TRAJ_RTOL)
    assert not trunner.plan_layout(p, "reference")
    with pytest.raises(ValueError, match="only the cuda kernel"):
        trunner.plan_layout(p, "reference", transposed=True)
    assert not trunner.plan_layout(p, "cuda")
    assert trunner.plan_layout(p, "cuda", transposed=True)
    assert trunner.plan_layout(_params(131072, 128, 1), "cuda")
    assert not trunner.plan_layout(_params(1024, 256, 1), "cuda")
