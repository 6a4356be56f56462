"""The port's CLI against lbm_tpu's on a generated scene: same stdout
contract, same output files (compared with check.py's formula), and the
die() contract for what the port refuses."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lbm_tpu import cli as jcli
from lbm_tpu.io import compare_golden
from lbm_tpu.obstacles import generate_obstacles, write_obstacles
from lbm_tpu_torch import cli as tcli
from lbm_tpu_torch.ops import _build

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# check.py's max-%-diff. Both runs share the scene and the association;
# they differ only where XLA's jit fuses or contracts the f32 ops the
# port runs one by one (un-jitted, the two are bit-identical: see
# tests/test_torch_reference.py). Over 100 steps from rest that reaches
# 2.2e-3 % on this scene's early, near-zero av_vels, so the bound is the
# repo's trajectory rtol of 1e-4, as a percentage.
TOL_PCT = 1e-2


@pytest.fixture
def scene(tmp_path):
    params = tmp_path / "scene.params"
    params.write_text("128\n64\n40000\n10\n0.1\n0.005\n1.85\n")
    mask = generate_obstacles(128, 64)
    mask[:, 128 // 3] = True
    obs = tmp_path / "obstacles.dat"
    write_obstacles(obs, mask)
    return tmp_path, str(params), str(obs)


def _outputs(d, tag):
    return ["--av-vels-file", str(d / f"av_{tag}.dat"),
            "--final-state-file", str(d / f"fs_{tag}.dat")]


def test_cli_matches_lbm_tpu(scene, capsys):
    d, params, obs = scene
    assert jcli.main([params, obs, "--kernel", "reference", "--iters", "100",
                      *_outputs(d, "jax")]) == 0
    capsys.readouterr()
    res = subprocess.run(
        [sys.executable, "-m", "lbm_tpu_torch", params, obs, "--device", "cpu",
         "--iters", "100", *_outputs(d, "torch")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
             "HOME": str(d), "OMP_NUM_THREADS": "2"},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stderr.strip() == "kernel: reference on cpu (float32)"
    out = res.stdout.splitlines()
    assert out[0] == "==done=="
    assert out[1].startswith("Reynolds number:\t\t")
    float(out[1].split("\t")[-1])
    for line, name in zip(out[2:6], ("Init", "Compute", "Collate", "Total")):
        assert line.startswith(f"Elapsed {name} time:\t\t\t")
        assert line.endswith(" (s)")
    assert len(out) == 6

    r = compare_golden(d / "av_torch.dat", d / "fs_torch.dat",
                       d / "av_jax.dat", d / "fs_jax.dat", tolerance=TOL_PCT)
    assert r.passed, (r.av_vels, r.final_state)
    # Byte formats: same line count and the same coordinate columns.
    jl = (d / "fs_jax.dat").read_text().splitlines()
    tl = (d / "fs_torch.dat").read_text().splitlines()
    assert len(jl) == len(tl) == 128 * 64
    assert [ln.split()[:2] + ln.split()[6:] for ln in jl] == \
        [ln.split()[:2] + ln.split()[6:] for ln in tl]
    assert len((d / "av_torch.dat").read_text().splitlines()) == 100


def test_cli_float64_on_cpu(scene, capsys):
    d, params, obs = scene
    assert tcli.main([params, obs, "--device", "cpu", "--precision", "float64",
                      "--iters", "3", *_outputs(d, "f64")]) == 0
    captured = capsys.readouterr()
    assert "kernel: reference on cpu (float64)" in captured.err
    assert np.loadtxt(d / "av_f64.dat", usecols=[1]).shape == (3,)


def _dies(argv, capsys, match):
    assert tcli.main(argv) == 1
    captured = capsys.readouterr()
    lines = captured.err.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("Error: "), captured.err
    assert match in lines[0]
    assert captured.out == ""


def test_cuda_device_without_gpu_dies(scene, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, params, obs = scene
    _dies([params, obs, "--device", "cuda", "--iters", "2", *_outputs(d, "x")],
          capsys, "no CUDA device")
    assert not (d / "av_x.dat").exists()


def test_cuda_kernel_in_float64_dies(scene, capsys):
    d, params, obs = scene
    _dies([params, obs, "--kernel", "cuda", "--precision", "float64",
           "--device", "cpu", *_outputs(d, "x")], capsys, "float32-only")


def test_cuda_kernel_on_cpu_dies(scene, capsys):
    d, params, obs = scene
    _dies([params, obs, "--kernel", "cuda", "--device", "cpu",
           *_outputs(d, "x")], capsys, "needs a CUDA device")


def test_missing_input_dies(scene, capsys):
    d, params, _ = scene
    _dies([params, str(d / "missing.dat"), "--device", "cpu"], capsys,
          "could not open")


def test_the_flags_are_lbm_tpus_and_the_ports_device():
    """Every flag of lbm_tpu's CLI, and the port's --device besides."""
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    port, jax_cli = flags(tcli.build_parser()), flags(jcli.build_parser())
    assert port - jax_cli == {"--device"} and jax_cli <= port


@pytest.fixture
def build_dir(monkeypatch):
    """The kernels' build directory, restored after the test (the CLI
    sets it for the rest of its process)."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.delenv("LBM_COMPILATION_CACHE", raising=False)
    return _build.BUILD_DIR


def test_compilation_cache_names_the_build_directory(scene, build_dir,
                                                      monkeypatch, tmp_path):
    """--compilation-cache DIR, else LBM_COMPILATION_CACHE, else the
    default: where the libraries are built and reused. With a C compiler
    on the machine, the host module's library lands there."""
    d, params, obs = scene
    flag_dir, env_dir = tmp_path / "flag", tmp_path / "env"
    flag_dir.mkdir()
    env_dir.mkdir()
    run = [params, obs, "--device", "cpu", "--iters", "2", *_outputs(d, "c")]
    assert tcli.main(run) == 0
    assert _build.BUILD_DIR == build_dir
    monkeypatch.setenv("LBM_COMPILATION_CACHE", str(env_dir))
    assert tcli.main(run) == 0
    assert _build.BUILD_DIR == env_dir.resolve()
    assert tcli.main(run + ["--compilation-cache", str(flag_dir)]) == 0
    assert _build.BUILD_DIR == flag_dir.resolve()
    assert _build.library_path().parent == flag_dir.resolve()
    if shutil.which(_build.host_compiler()):
        for where in (env_dir, flag_dir):
            assert [p.name for p in where.glob("liblbm_io-*.so")] == [
                _build.host_library_path().name]


@pytest.mark.parametrize("what", ["missing", "a file"])
def test_compilation_cache_that_is_no_directory_dies(scene, build_dir,
                                                     capsys, what):
    d, params, obs = scene
    path = d / "cache"
    if what == "a file":
        path.write_text("")
    _dies([params, obs, "--device", "cpu", "--iters", "2",
           "--compilation-cache", str(path), *_outputs(d, "x")], capsys,
          "no such directory")
    assert _build.BUILD_DIR == build_dir
    assert not (d / "av_x.dat").exists()
