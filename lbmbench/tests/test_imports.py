"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or
``lbm_tpu`` (compared by whole top-level names, since ``lbm_tpu_torch``
begins with ``lbm_tpu``), and the yardstick imports nothing of the
program."""

from __future__ import annotations

import ast
import json

from lbmbench.harness import FORBIDDEN
from lbmbench.tests.helpers import REPO, run_module

# The yardstick: traffic, reference, comparison, trace reduction and
# roofline take nothing from the program.
YARDSTICK = ("scenes.py", "reference.py", "compare.py", "tracing.py",
             "roofline.py", "spec.py")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_forbidden_module_after_the_harness_and_the_runner_load():
    code = ("import sys, json, lbmbench.run, lbmbench.harness, "
            "lbmbench.calibrate, lbm_tpu_torch.runner, lbm_tpu_torch.ops.fused;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = run_module(["-c", code], cwd=REPO)
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.splitlines()[-1]))
    assert "lbm_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_sources_import_no_forbidden_module():
    files = list((REPO / "lbmbench").rglob("*.py"))
    assert files
    for path in files:
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert "lbm_tpu_torch" not in _imports(REPO / "lbmbench" / name), name
    for path in (REPO / "lbmbench" / "metrics").glob("*.py"):
        assert "lbm_tpu_torch" not in _imports(path), path
