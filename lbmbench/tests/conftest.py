"""Fixtures of the benchmark's own tests (``pytest lbmbench/tests``).

Tests that need a card carry the repository's ``cuda`` marker and take
the ``cuda`` fixture, which decides whether there is one when the test
runs and skips with a reason where there is none.
"""

from __future__ import annotations

import shutil

import pytest

from lbmbench.tests.helpers import REPO, tiny


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    from lbmbench import spec

    return tiny(spec.resolve("ref256.scene"))


@pytest.fixture
def bench_copy(tmp_path):
    """A directory holding only ``BENCHMARK.json`` and ``lbmbench/``."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "lbmbench", tmp_path / "lbmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path
