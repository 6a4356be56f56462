"""The stream-cost probe of the port against the JAX package's.

``lbm_tpu_torch.ops.reference.probe_multi_step`` (the plain version of
``csrc/probe.cu``, and the CPU path of ``ops.probe``) against
``scripts/stream_cost_probe.py::_probe_call`` on the same inputs, made
from a seed with numpy, for the three modes. ``_probe_call`` hard-codes
``interpret=False`` and TPU memory spaces, so it runs here as the JAX
package's own tests run the resident kernel on the CPU: in interpret mode,
through a wrapper around ``jax.experimental.pallas.pallas_call`` that the
test installs for the call; nothing in the script changes.

The kernel's schedule (``ops.probe.probe_device_emulated``: the
device-memory resident form's rounds of depth tiles with the mode's stage
body) against the plain version, and its ``full`` totals against the
resident form's with the forcing at 0.

Bounds: cells at atol 5e-8 / rtol 2e-5 and totals at rtol 2e-5 (the
repo's kernel-vs-reference bounds, tests/test_pallas.py); the schedule's
cells bit for bit, its totals at rtol 2e-5 (another summation order).
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lbm_tpu_torch.obstacles import generate_obstacles
from lbm_tpu_torch.ops import fused, probe, resident
from lbm_tpu_torch.ops import reference as ref_ops

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL, TOT_RTOL = 2e-5, 5e-8, 2e-5
OMEGA = 1.85
GSTEPS = 4


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_probe(monkeypatch):
    """``_probe_call`` with its pallas_call interpreted."""
    real = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    return _script("stream_cost_probe")._probe_call


def _case(name):
    """Seeded state near equilibrium (stable under the full step) and its
    mask: walls, a ragged wall-less random mask, or walls with interior
    obstacles."""
    ny, nx, kind = {"walls-16x32": (16, 32, "walls"),
                    "odd-13x24": (13, 24, "random"),
                    "interior-24x40": (24, 40, "interior")}[name]
    rng = np.random.default_rng(len(name))
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, np.float32) * 0.1
    cells = (w[:, None, None] * (1 + 0.2 * (rng.random((9, ny, nx)) - 0.5))
             ).astype(np.float32)
    if kind == "random":
        mask = rng.random((ny, nx)) < 0.15
    else:
        mask = generate_obstacles(nx, ny)
        if kind == "interior":
            mask[8:14, 10:13] = True
            mask |= rng.random((ny, nx)) < 0.04
    return cells, mask


CASES = ["walls-16x32", "odd-13x24", "interior-24x40"]


@pytest.mark.parametrize("mode", probe.MODES)
@pytest.mark.parametrize("case", CASES)
def test_probe_matches_the_jax_probe(jax_probe, case, mode):
    cells, mask = _case(case)
    want, want_tots = jax_probe(jnp.asarray(cells),
                                jnp.asarray(mask.astype(np.int8)),
                                mode=mode, gsteps=GSTEPS, omega=OMEGA)
    got, tots = ref_ops.probe_multi_step(
        torch.from_numpy(cells), torch.from_numpy(mask), OMEGA, GSTEPS, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tots.numpy(), np.asarray(want_tots),
                               rtol=TOT_RTOL)
    assert tots.shape == (GSTEPS,) and (tots > 0).all()


@pytest.mark.parametrize("case", CASES)
def test_full_mode_is_the_step_without_forcing(case):
    """``full`` equals ``multi_step`` with the forcing set to 0, bit for
    bit: the resident kernel's work when no row is forced."""
    cells, mask = _case(case)
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    got, tots = ref_ops.probe_multi_step(c, m, OMEGA, 6, "full")
    want, want_tots = ref_ops.multi_step(c, m, 0.0, 0.0, OMEGA, 6)
    assert torch.equal(got, want) and torch.equal(tots, want_tots)


@pytest.mark.parametrize("case", CASES)
def test_stream_mode_permutes_and_collide_mode_conserves(case):
    cells, mask = _case(case)
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    got, tots = ref_ops.probe_multi_step(c, m, OMEGA, 6, "stream")
    # Pure streaming permutes each speed's plane: the sorted values stay,
    # and speed 0 does not move, so every step's total is its plane sum.
    for k in range(9):
        assert torch.equal(got[k].flatten().sort().values,
                           c[k].flatten().sort().values)
    assert torch.equal(got[0], c[0])
    assert torch.equal(tots, torch.sum(c[0]).expand(6))
    # Six steps of speed k move it by six lattice vectors.
    assert torch.equal(got[5], torch.roll(c[5], (6, 6), (0, 1)))
    # Collision without streaming keeps every cell's density.
    got, _ = ref_ops.probe_multi_step(c, m, OMEGA, 6, "collide")
    np.testing.assert_allclose(got.sum(0).numpy(), c.sum(0).numpy(), rtol=1e-5)
    # An obstacle bounces its own speeds: after an even count they are back.
    assert torch.equal(got[:, m], c[:, m])


@pytest.mark.parametrize("gsteps", [4, 6, 10])
@pytest.mark.parametrize("mode", probe.MODES)
@pytest.mark.parametrize("case", CASES)
def test_device_schedule_matches_the_plain_probe(case, mode, gsteps):
    """The kernel's rounds (4; 4 + 2; 4 + 2 + 2 + 2, a count with G's
    parity) of depth tiles with the mode's stage body: the plain
    version's cells bit for bit, totals summed by tile within the
    bound."""
    cells, mask = _case(case)
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    assert sum(resident.device_rounds(gsteps)) == gsteps
    got, tots = probe.probe_device_emulated(c, m, OMEGA, gsteps, mode)
    want, want_tots = ref_ops.probe_multi_step(c, m, OMEGA, gsteps, mode)
    assert torch.equal(got, want)
    np.testing.assert_allclose(tots.numpy(), want_tots.numpy(),
                               rtol=TOT_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_device_schedule_full_is_the_resident_forms_bits(case):
    """``full`` runs the resident form's stage body with no forced line:
    its totals, obstacles counted as 0, are the bits of the device form's
    with the forcing at 0 (fluid cells counted), and so are its cells."""
    cells, mask = _case(case)
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    got, tots = probe.probe_device_emulated(c, m, OMEGA, 10, "full")
    want, want_tots = resident.resident_device_emulated(c, m, 0.0, 0.0,
                                                        OMEGA, 10)
    assert torch.equal(got, want) and torch.equal(tots, want_tots)


def test_device_schedule_counts_obstacles_in_stream_mode():
    """``stream`` sums speed 0 of every owned cell, obstacles included, as
    the plain version sums the whole plane: with speed 0 zero in the
    fluid, the total is the obstacles' alone."""
    cells, mask = _case("interior-24x40")
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    c[0][~m] = 0.0
    _, tots = probe.probe_device_emulated(c, m, OMEGA, 4, "stream")
    np.testing.assert_allclose(tots.numpy(),
                               torch.sum(c[0]).expand(4).numpy(),
                               rtol=TOT_RTOL)
    assert (tots > 0).all()
    with pytest.raises(ValueError, match="unknown probe mode"):
        probe.probe_device_emulated(c, m, OMEGA, 4, "both")


def test_wrapper_on_the_cpu_runs_the_plain_version():
    cells, mask = _case("walls-16x32")
    c, m = torch.from_numpy(cells), torch.from_numpy(mask)
    fused.reset_launches()
    for mode in probe.MODES:
        got, tots = probe.probe(c, m, OMEGA, GSTEPS, mode)
        want, want_tots = probe.probe_plain(c, m, OMEGA, GSTEPS, mode)
        assert torch.equal(got, want) and torch.equal(tots, want_tots)
        # The buffers' contract: an even count ends in the first buffer,
        # at the given offset of the totals.
        kernel = probe.Probe(m, OMEGA, GSTEPS, mode)
        a, b, out = c.clone(), torch.empty_like(c), torch.zeros(GSTEPS + 2)
        new, spare = kernel.run(a, b, out, 2)
        assert new is a and spare is b and torch.equal(a, want)
        assert torch.equal(out[2:], want_tots) and not out[:2].any()
    assert all(v == 0 for v in fused.LAUNCHES.values())
    assert {f"probe_{m}" for m in probe.MODES} <= set(fused.LAUNCHES)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _, mask = _case("walls-16x32")
    m = torch.from_numpy(mask)
    with pytest.raises(ValueError, match="unknown probe mode"):
        probe.Probe(m, OMEGA, 4, "both")
    for g in (0, 3, -2):
        with pytest.raises(ValueError, match="even step count"):
            probe.Probe(m, OMEGA, g, "full")
        with pytest.raises(ValueError, match="even step count"):
            ref_ops.probe_multi_step(torch.zeros(9, 16, 32), m, OMEGA, g, "full")
    kernel = probe.Probe(m, OMEGA, 4, "full")
    a = torch.zeros(9, 16, 32)
    with pytest.raises(ValueError, match="distinct buffers"):
        kernel.run(a, a, torch.zeros(4))
    with pytest.raises(ValueError, match="float32"):
        kernel.run(a.double(), a.double().clone(), torch.zeros(4))
    with pytest.raises(ValueError, match="not a slice"):
        kernel.run(a, a.clone(), torch.zeros(3))


def test_the_script_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = _script("stream_cost_probe_torch")
    assert script.main(["--grid", "64x32", "--gsteps", "4"]) != 0
    out = json.loads(capsys.readouterr().out)
    assert "requires a CUDA device" in out["error"] and "rows" not in out
    with pytest.raises(SystemExit, match="even"):
        script.main(["--gsteps", "3"])
