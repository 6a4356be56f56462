"""lbm_tpu_torch.state against lbm_tpu.state, and the port's import
boundary: no module of lbm_tpu_torch may import jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu.params import Params
from lbm_tpu.state import D2Q9 as JaxD2Q9
from lbm_tpu.state import initial_state_np
from lbm_tpu_torch import state as tstate

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _params(dtype=np.float32):
    return Params(nx=24, ny=16, max_iters=5, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85, dtype=dtype)


@pytest.mark.parametrize("name", ["Q", "CX", "CY", "W", "OPP"])
def test_d2q9_matches_lbm_tpu(name):
    want = getattr(JaxD2Q9, name)
    got = getattr(tstate.D2Q9, name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_initial_state_matches_lbm_tpu(dtype):
    p = _params(dtype)
    got = tstate.initial_state(p)
    assert got.is_contiguous()
    assert got.dtype == {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    np.testing.assert_array_equal(got.numpy(), initial_state_np(p))


def test_from_numpy_copies_and_round_trips():
    rng = np.random.default_rng(0)
    cells = rng.uniform(0.01, 0.2, (9, 6, 10)).astype(np.float32)
    mask = rng.random((6, 10)) < 0.2
    cells_t, mask_t = tstate.from_numpy(cells, mask)
    assert cells_t.dtype == torch.float32 and mask_t.dtype == torch.bool
    np.testing.assert_array_equal(tstate.to_numpy(cells_t), cells)
    cells_t.zero_()  # the port steps in place: it must not alias the input
    assert cells.min() >= 0.01
    np.testing.assert_array_equal(mask_t.numpy(), mask)
    with pytest.raises(ValueError):
        tstate.from_numpy(cells, mask[:, :5])
    with pytest.raises(ValueError):
        tstate.from_numpy(cells, mask, dtype=np.float16)


def test_port_never_imports_jax(tmp_path):
    """Every module of the port, and a 5-step CPU run through the CLI,
    in a fresh interpreter: jax must not be loaded."""
    code = f"""
import importlib, pkgutil, sys
import lbm_tpu_torch
for mod in pkgutil.walk_packages(lbm_tpu_torch.__path__, "lbm_tpu_torch."):
    importlib.import_module(mod.name)
from lbm_tpu.obstacles import generate_obstacles, write_obstacles
from lbm_tpu_torch.cli import main
d = {str(tmp_path)!r}
open(d + "/s.params", "w").write("32\\n16\\n5\\n10\\n0.1\\n0.005\\n1.85\\n")
write_obstacles(d + "/o.dat", generate_obstacles(32, 16))
rc = main([d + "/s.params", d + "/o.dat", "--device", "cpu",
           "--av-vels-file", d + "/av.dat",
           "--final-state-file", d + "/fs.dat"])
assert rc == 0, rc
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not bad, bad
print("OK")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                       "HOME": str(tmp_path), "OMP_NUM_THREADS": "2"},
        timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("OK")
