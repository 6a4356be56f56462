"""``dryrun_torch``, the port's twin of ``__graft_entry__``: its
``dryrun_multichip`` on CPU meshes of 1, 2 and 8 shards, and its
``entry()`` step against the JAX package's ``entry()`` step on the same
cells."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import __graft_entry__ as jentry  # noqa: E402
import dryrun_torch  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("LBM_SHARD_RESIDENT", "LBM_RESIDENT_STEPS", "LBM_PALLAS_DEPTH",
              "LBM_RESIDENT"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_on_the_cpu(n, capsys):
    lines = dryrun_torch.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out.splitlines()
    names = [name for name, *_ in dryrun_torch._dryrun_cases(n)]
    assert out == lines
    assert [line.split("]")[0][len("dryrun["):] for line in lines] == names
    assert all(line.endswith("matches unsharded") for line in lines)


def test_the_cases_are_the_jax_cases_but_the_in_place_ring():
    want = [(name, {"pallas": "cuda"}.get(k, k), env)
            for name, k, _, env in jentry._dryrun_cases(4)
            if name != "pallas/resident-ring-inplace"]
    got = [(name, k, env) for name, k, _, env in dryrun_torch._dryrun_cases(4)]
    assert got == want
    for (name, _, p, _), (jname, _, jp, _) in zip(
            dryrun_torch._dryrun_cases(4),
            [c for c in jentry._dryrun_cases(4)
             if c[0] != "pallas/resident-ring-inplace"]):
        if name.endswith("-x"):
            assert p.nx >= 2 * p.ny and p.nx * p.ny > 512 * 512
            assert p.nx % 8 == 0 and p.nx % 4 == 0
        else:
            assert (p.nx, p.ny, p.max_iters) == (jp.nx, jp.ny, jp.max_iters)


def test_a_wrong_plan_fails_the_dryrun(monkeypatch):
    from lbm_tpu_torch.parallel import halo

    real = halo.plan_sharding
    monkeypatch.setattr(halo, "plan_sharding",
                        lambda p, m, k: (False, real(p, m, k)[1]))
    with pytest.raises(AssertionError, match="transposed-x"):
        dryrun_torch.dryrun_multichip(2, device="cpu")


def test_entry_matches_the_jax_entry_step():
    step, (cells, obstacles) = dryrun_torch.entry(device="cpu")
    jstep, (jcells, jobstacles) = jentry.entry()
    assert cells.device.type == "cpu" and tuple(cells.shape) == (9, 256, 256)
    np.testing.assert_array_equal(obstacles.numpy(), np.asarray(jobstacles))
    rng = np.random.default_rng(12)
    start = (np.asarray(jcells)
             * rng.uniform(0.9, 1.1, jcells.shape)).astype(np.float32)
    new, tot = step(torch.from_numpy(start), obstacles)
    jnew, jtot = jax.jit(jstep)(jax.numpy.asarray(start), jobstacles)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-6)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-6)
    assert new.dtype == torch.float32


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ValueError, match="no CUDA device"):
        dryrun_torch.entry()
