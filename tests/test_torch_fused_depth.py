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
