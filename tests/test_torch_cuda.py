"""The CUDA kernel against its plain version, on the card. Skips where
no CUDA device is present. This file imports no jax, so on a machine
without it run it alone, without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import fused
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


def _case(ny, nx, walls, seed=0):
    p = Params(nx=nx, ny=ny, max_iters=200, reynolds_dim=10,
               density=0.1, accel=0.01, omega=1.85)
    rng = np.random.default_rng(seed)
    cells = rng.uniform(0.01, 0.2, (9, ny, nx)).astype(np.float32)
    cells[6, ny - 2, rng.random(nx) < 0.3] = np.float32(p.accel_w2)
    mask = generate_obstacles(nx, ny) if walls else rng.random((ny, nx)) < 0.15
    return p, cells, mask


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", [(128, 128, True), (100, 130, False)],
                         ids=["128x128", "100x130-wall-less"])
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
