"""The port's own scene layer (params, obstacles, .dat I/O, the checker)
against the JAX package's numpy modules on the same inputs, and the guard
that no module of the port imports JAX or the JAX package. Files are
compared byte for byte; arrays exactly."""

import ast
from pathlib import Path

import numpy as np
import pytest

from lbm_tpu import io as jio
from lbm_tpu import obstacles as jobs
from lbm_tpu import params as jpar
from lbm_tpu_torch import check as tcheck
from lbm_tpu_torch import io as tio
from lbm_tpu_torch import obstacles as tobs
from lbm_tpu_torch import params as tpar

REPO = Path(__file__).resolve().parent.parent


def _port_sources():
    """Every module of the port, its on-card check, its scripts and its
    root entry points (the port's scripts and root files are named
    ``*_torch.py``)."""
    return (sorted((REPO / "lbm_tpu_torch").rglob("*.py"))
            + [REPO / "chip_smoke.py"]
            + sorted((REPO / "scripts").glob("*_torch.py"))
            + sorted(REPO.glob("*_torch.py")))


def _foreign_imports(path: Path, root: Path = REPO) -> list[str]:
    """Imports of jax or of the JAX package (``lbm_tpu`` but not
    ``lbm_tpu_torch``) anywhere in ``path``, at any depth."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top == "jax" or top == "jaxlib" or top == "lbm_tpu":
                bad.append(f"{path.relative_to(root)}:{node.lineno}: {name}")
    return bad


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    names = {p.name for p in sources}
    assert {"probe.py", "profiling.py", "stream_cost_probe_torch.py",
            "trace_report_torch.py", "chip_smoke.py", "dryrun_torch.py",
            "validate_scenes_torch.py", "full_scenes_torch.py",
            "sharded_overhead_torch.py", "sweep_torch.py",
            "plot_roofline_torch.py", "ab_kernel_torch.py",
            "writer_ab_torch.py", "mxu_eq.py", "mxu_probe_torch.py"} <= names
    bad = [b for path in sources for b in _foreign_imports(path)]
    assert not bad, "\n".join(bad)


def test_the_guard_sees_each_kind_of_foreign_import(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import jax.numpy as jnp\nfrom lbm_tpu.io import _diff\n"
                   "import lbm_tpu_torch.io\n"
                   "def f():\n    from lbm_tpu import params\n")
    names = [b.split(": ")[1] for b in _foreign_imports(src, tmp_path)]
    assert names == ["jax.numpy", "lbm_tpu.io", "lbm_tpu"]


PARAM_TEXTS = {
    "scene": "1024\n1024\n20000\n10\n0.1\n0.01\n1.85\n",
    "spaced": "  128 64\n100 10 0.1 0.005\n1.7  trailing words\n",
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(PARAM_TEXTS))
def test_load_params_matches(tmp_path, name, dtype):
    path = tmp_path / "s.params"
    path.write_text(PARAM_TEXTS[name])
    got, want = tpar.load_params(path, dtype=dtype), jpar.load_params(path, dtype=dtype)
    assert got.__dict__ == want.__dict__
    for attr in ("viscosity", "accel_w1", "accel_w2"):
        assert getattr(got, attr) == getattr(want, attr)
        assert type(getattr(got, attr)) is type(getattr(want, attr))


@pytest.mark.parametrize("text", ["1\n2\n3\n", "a\nb\nc\nd\ne\nf\ng\n"])
def test_load_params_errors_match(tmp_path, text):
    path = tmp_path / "bad.params"
    path.write_text(text)
    with pytest.raises(ValueError) as got:
        tpar.load_params(path)
    with pytest.raises(ValueError) as want:
        jpar.load_params(path)
    assert str(got.value) == str(want.value)


def test_ensure_dtype_computable():
    p = tpar.Params(nx=4, ny=4, max_iters=1, reynolds_dim=1, density=0.1,
                    accel=0.01, omega=1.0, dtype=np.float64)
    tpar.ensure_dtype_computable(p)
    half = tpar.Params(nx=4, ny=4, max_iters=1, reynolds_dim=1, density=0.1,
                       accel=0.01, omega=1.0, dtype=np.float16)
    with pytest.raises(ValueError, match="float32 or float64"):
        tpar.ensure_dtype_computable(half)


@pytest.mark.parametrize("interior", [False, True])
def test_generate_and_count_match(interior):
    for nx, ny in [(16, 8), (130, 100), (7, 33)]:
        got = tobs.generate_obstacles(nx, ny, interior)
        want = jobs.generate_obstacles(nx, ny, interior)
        np.testing.assert_array_equal(got, want)
        for dtype in (np.float32, np.float64):
            a = tobs.num_non_obstacles_r(got, dtype)
            b = jobs.num_non_obstacles_r(want, dtype)
            assert a == b and type(a) is type(b)


def test_load_obstacles_with_duplicate_corners_matches(tmp_path):
    rng = np.random.default_rng(3)
    mask = tobs.generate_obstacles(40, 24) | (rng.random((24, 40)) < 0.1)
    tobs.write_obstacles(tmp_path / "t.dat", mask)
    jobs.write_obstacles(tmp_path / "j.dat", mask)
    assert (tmp_path / "t.dat").read_bytes() == (tmp_path / "j.dat").read_bytes()
    # The shipped files repeat the corner entries.
    with open(tmp_path / "t.dat", "a") as fh:
        fh.write("0 0 1\n39 23 1\n0 23 1\n")
    got = tobs.load_obstacles(tmp_path / "t.dat", 40, 24)
    want = jobs.load_obstacles(tmp_path / "t.dat", 40, 24)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, mask)
    assert tobs.num_non_obstacles_r(got) == jobs.num_non_obstacles_r(want)


@pytest.mark.parametrize("text", ["1 2\n", "50 0 1\n", "0 30 1\n", "1 1 2\n"])
def test_load_obstacles_errors_match(tmp_path, text):
    path = tmp_path / "bad.dat"
    path.write_text(text)
    with pytest.raises(ValueError) as got:
        tobs.load_obstacles(path, 40, 24)
    with pytest.raises(ValueError) as want:
        jobs.load_obstacles(path, 40, 24)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_writers_are_byte_identical(tmp_path, dtype):
    rng = np.random.default_rng(11)
    p = tpar.Params(nx=12, ny=9, max_iters=5, reynolds_dim=10, density=0.1,
                    accel=0.005, omega=1.85, dtype=dtype)
    cells = rng.uniform(0.01, 0.2, (9, p.ny, p.nx)).astype(dtype)
    mask = tobs.generate_obstacles(p.nx, p.ny)
    av = rng.uniform(0, 1e-3, 17).astype(dtype)
    tio.write_final_state(tmp_path / "fs_t.dat", p, cells, mask)
    jio.write_final_state(tmp_path / "fs_j.dat", p, cells, mask)
    tio.write_av_vels(tmp_path / "av_t.dat", av)
    jio.write_av_vels(tmp_path / "av_j.dat", av)
    assert (tmp_path / "fs_t.dat").read_bytes() == (tmp_path / "fs_j.dat").read_bytes()
    assert (tmp_path / "av_t.dat").read_bytes() == (tmp_path / "av_j.dat").read_bytes()
    for got, want in zip(tio.final_state_fields(p, cells, mask),
                         jio.final_state_fields(p, cells, mask)):
        np.testing.assert_array_equal(got, want)
    assert (tio.FINAL_STATE_FILE, tio.AV_VELS_FILE) == \
        (jio.FINAL_STATE_FILE, jio.AV_VELS_FILE)


@pytest.mark.parametrize("scale", [1.0, 1.00001, 1.02])
def test_compare_golden_matches(tmp_path, scale, capsys):
    rng = np.random.default_rng(5)
    p = tpar.Params(nx=6, ny=5, max_iters=8, reynolds_dim=10, density=0.1,
                    accel=0.005, omega=1.85)
    cells = rng.uniform(0.01, 0.2, (9, 5, 6)).astype(np.float32)
    mask = tobs.generate_obstacles(6, 5)
    av = rng.uniform(1e-4, 1e-3, 8).astype(np.float32)
    files = [tmp_path / n for n in ("av.dat", "fs.dat", "av_r.dat", "fs_r.dat")]
    tio.write_av_vels(files[0], av * np.float32(scale))
    tio.write_final_state(files[1], p, cells * np.float32(scale), mask)
    tio.write_av_vels(files[2], av)
    tio.write_final_state(files[3], p, cells, mask)
    got = tio.compare_golden(*files, tolerance=1.0)
    want = jio.compare_golden(*files, tolerance=1.0)
    assert got.passed == want.passed
    assert got.av_vels.__dict__ == want.av_vels.__dict__
    assert got.final_state.__dict__ == want.final_state.__dict__
    d1, d2 = tio._diff(av, av * 1.5), jio._diff(av, av * 1.5)
    assert d1.__dict__ == d2.__dict__
    argv = [f"--av-vels-file={files[0]}", f"--final-state-file={files[1]}",
            f"--ref-av-vels-file={files[2]}", f"--ref-final-state-file={files[3]}"]
    from lbm_tpu import check as jcheck

    rc_t = tcheck.main(argv)
    out_t = capsys.readouterr().out
    rc_j = jcheck.main(argv)
    out_j = capsys.readouterr().out
    assert (rc_t, out_t) == (rc_j, out_j)
    assert rc_t == (0 if want.passed else 1)
