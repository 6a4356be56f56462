"""The benchmark's plain reference agrees with the port's own plain
version (``lbm_tpu_torch.ops.reference``, the oracle its kernels are held
to) in float64 on small grids on the CPU. The test imports both; the
reference imports nothing of the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lbmbench import reference, scenes


def _scene(nx, ny, iters, omega=1.85, accel=0.005, block=(5, 4, 3, 2),
           index=0):
    mask = scenes.walls(nx, ny)
    x, y, w, h = block
    mask[y:y + h, x:x + w] = True
    return scenes.Scene(index=index, nx=nx, ny=ny, iters=iters,
                        reynolds_dim=10, density=0.1, accel=accel,
                        omega=omega, mask=mask)


def _port_plain(scene):
    from lbm_tpu_torch.observables import calc_reynolds
    from lbm_tpu_torch.ops.reference import fused_step
    from lbm_tpu_torch.params import Params
    from lbm_tpu_torch.state import initial_state

    p = Params(nx=scene.nx, ny=scene.ny, max_iters=scene.iters,
               reynolds_dim=scene.reynolds_dim, density=scene.density,
               accel=scene.accel, omega=scene.omega, dtype=np.float64)
    mask = torch.from_numpy(scene.mask.copy())
    cells = initial_state(p)
    fluid = float((~scene.mask).sum())
    av = []
    for _ in range(scene.iters):
        cells, tot = fused_step(cells, mask, p.accel_w1, p.accel_w2, p.omega)
        av.append(float(tot) / fluid)
    return cells.numpy(), np.array(av), float(calc_reynolds(p, cells, mask))


@pytest.mark.parametrize("nx,ny,omega,accel", [
    (24, 20, 1.85, 0.005), (17, 30, 1.5, 0.01)])
def test_reference_matches_the_port_plain_version(nx, ny, omega, accel):
    scene = _scene(nx, ny, 60, omega, accel)
    cells, av, re = reference.run([scene], torch.float64, "cpu")[0]
    p_cells, p_av, p_re = _port_plain(scene)
    assert np.max(np.abs(cells - p_cells)) < 1e-15
    assert np.max(np.abs(av - p_av)) < 1e-12 * np.max(np.abs(p_av))
    assert re == pytest.approx(p_re, rel=1e-12)
    # The scene moved: a check against rest would not be vacuous.
    rest = reference.rest_state(scene.density, ny, nx)
    assert np.max(np.abs(cells - rest)) > 1e-5


def test_a_batch_is_its_scenes_run_alone():
    a = _scene(24, 20, 30, 1.85, 0.005, (5, 4, 3, 2), 0)
    b = _scene(24, 20, 30, 1.6, 0.008, (12, 9, 2, 5), 1)
    both = reference.run([a, b], torch.float64, "cpu")
    for scene, (cells, av, re) in zip((a, b), both):
        c1, a1, r1 = reference.run([scene], torch.float64, "cpu")[0]
        np.testing.assert_array_equal(cells, c1)
        np.testing.assert_array_equal(av, a1)
        assert re == r1


def test_a_batch_holds_one_grid_and_step_count():
    with pytest.raises(ValueError):
        reference.run([_scene(24, 20, 30), _scene(24, 20, 31)],
                      torch.float64, "cpu")
