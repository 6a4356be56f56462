"""The wide-grid path of the coursework's 16384x1024 stress scene on the
card (``cuda`` marker; each test skips where no CUDA device is present):
``run_simulation(kernel="auto")`` on the transposed layout and the depth
kernel's column mode, against the benchmark's float64 reference under the
``stress16384.scene`` cell's limits, its layout counters, its bits beside
the transposing path, and its device memory. This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stress_cuda.py
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch import runner as trunner
from lbm_tpu_torch.ops import plan
from lbm_tpu_torch.params import Params
from lbm_tpu_torch.state import initial_state
from lbmbench import compare, reference, scenes, spec

SEED = 2**31 + 2416


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(nx, ny, iters):
    """A scene of the cell's recipe at ``nx`` x ``ny``: walls and one
    full-height column drawn from [nx/8, 7nx/8]."""
    config = spec.resolve("stress16384.scene").config
    config["params"].update(nx=nx, ny=ny, max_iters=iters)
    config["mask"]["interior"] = [{"x": [nx // 8, 7 * nx // 8], "y": [0, 0],
                                   "w": [1, 1], "h": [ny, ny]}]
    scene = scenes.make_scene(config, SEED, 0)
    p = Params(nx=nx, ny=ny, max_iters=iters,
               reynolds_dim=scene.reynolds_dim,
               density=np.float32(scene.density),
               accel=np.float32(scene.accel), omega=np.float32(scene.omega))
    return scene, p


def _within_the_cells_limits(scene, r, device):
    ref = reference.run([scene], torch.float64, device)[0]
    gaps = compare.gaps(scene, r.cells, r.av_vels, r.reynolds, ref)
    limits = spec.resolve("stress16384.scene").check["limits"]
    assert compare.verdict(gaps, limits), (gaps, limits)


@pytest.mark.cuda
def test_a_wide_grid_runs_transposed_in_column_mode(cuda):
    """4096x256, 2000 steps: the transposed layout, column-mode depth D=4
    x500 (2048x256 would plan the on-chip single-buffer form), within the
    cell's limits; the repaired rest state gives the bits of the
    transposing path."""
    scene, p = _scene(4096, 256, 2000)
    assert plan.layout(p)[0]
    assert trunner.plan_run(p, "cuda", 2000, device=cuda) == [
        plan.Segment("depth", 4, 2000)]
    r = trunner.run_simulation(p, scene.mask, kernel="auto", device=cuda)
    t = r.timings
    assert t["compute.launches.cols"] == 500
    assert t["transpose.device"] > 0
    assert "collate.transpose" in t and "init.transpose" not in t
    assert t["collate.copy.bytes"] == 9 * 256 * 4096 * 4
    _within_the_cells_limits(scene, r, cuda)

    mask = torch.from_numpy(scene.mask).to(cuda)
    cells, av = trunner.simulate(p, initial_state(p, cuda), mask,
                                 kernel="cuda")
    assert torch.equal(torch.from_numpy(r.cells), cells.cpu())
    assert torch.equal(torch.from_numpy(r.av_vels), av.cpu())


@pytest.mark.cuda
def test_the_stress_grid_holds_three_lattices_at_most(cuda):
    """16384x1024, 200 steps, within the cell's limits; the device memory
    the run allocates stays at or under three lattices (the two it steps
    and the collate's transposition) and 768 MB for the Reynolds number's
    temporaries. Built physical and transposed in, it held four."""
    scene, p = _scene(16384, 1024, 200)
    lattice = 9 * 1024 * 16384 * 4
    trunner.run_simulation(p, scene.mask, kernel="auto", device=cuda,
                           n_iters=8)  # the library built and loaded
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r = trunner.run_simulation(p, scene.mask, kernel="auto", device=cuda)
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= 3 * lattice + 768 * 2**20, peak
    assert r.timings["compute.launches.cols"] == 50
    _within_the_cells_limits(scene, r, cuda)
