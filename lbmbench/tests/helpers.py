"""Helpers of the benchmark's own tests."""

from __future__ import annotations

import copy
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny(cell, nx=32, ny=24, iters=400, scenes=2):
    """``cell`` at a size a CPU test run holds: the same traffic, mask
    kind and limits, a small grid and few steps."""
    cell = copy.deepcopy(cell)
    cell.config["params"].update(nx=nx, ny=ny, max_iters=iters)
    cell.config["mask"]["interior"] = [
        {"x": [4, nx - 8], "y": [4, ny - 8], "w": [2, 4], "h": [2, 4]}]
    cell.check["scenes"] = scenes
    return cell


def run_module(args, cwd, env_extra=None, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)
