#!/usr/bin/env python3
"""Hold the card test of coherent lattice loads to mutants that it must
catch: ``tests/test_torch_cuda.py::
test_cross_block_kernels_load_the_lattice_coherently`` on this checkout
(it must pass) and on a copy per mutant, where it must fail:

- ``shift``: the device form's shift mode loads the six neighbour speeds
  of its quad through the non-coherent read-only path (``__ldg``;
  ``lbm_tpu_torch/csrc/lbm_rounds.cuh``'s ``shift_quad``, the shift mode's
  device residence). Behind the step counters those values are what other
  blocks wrote, and a read-only cache line may hold the step before's;
- ``weak_poll``: the on-chip strip step polls its halo words with a weak
  load (``ld.global.b64`` in ``lbm_tpu_torch/csrc/lbm_onchip.cuh``'s
  ``get_word``), which may be served from a stale L1 line and spin for
  ever, or be hoisted out of the poll.

The 200-round bit tests of the card suite see neither. Each copy (the
package, the card tests, ``scripts/`` and the pinned artifacts) goes to
``build/coherence_mutant/<mutant>/`` (a directory ``.gitignore`` lists),
builds its own library and runs the test from there. Prints one JSON
line: each run's pytest exit code and last line, and ``ok``: the
checkout passed and every mutant failed. Exit code 0 when ``ok``.

Usage: python scripts/coherence_mutant_torch.py [--mutants shift,weak_poll]
       [-o artifact.json]
       (A CUDA device and cuobjdump are required.)
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
COPY = REPO / "build" / "coherence_mutant"
TEST = ("tests/test_torch_cuda.py::"
        "test_cross_block_kernels_load_the_lattice_coherently")
# Per mutant, the source it changes and its (text, mutant text) pairs,
# each of which must occur there exactly once. MUTATIONS: the shift
# mode's __ldg; WEAK_POLL: the halo words' weak poll.
MUTATIONS = tuple(
    (f"    const float e{k} = src[{k} * plane + {row} + {col}];\n",
     f"    const float e{k} = __ldg(src + {k} * plane + {row} + {col});\n")
    for k, row, col in ((1, "rc", "xw"), (5, "rm", "xw"), (8, "rp", "xw"),
                        (3, "rc", "xe"), (6, "rm", "xe"), (7, "rp", "xe")))
WEAK_POLL = tuple(
    (f'"ld.relaxed.{scope}.global.b64 %0, [%1];"', '"ld.global.b64 %0, [%1];"')
    for scope in ("sys", "gpu"))
MUTANTS = {"shift": ("lbm_rounds.cuh", MUTATIONS),
           "weak_poll": ("lbm_onchip.cuh", WEAK_POLL)}


def mutant_copy(name: str) -> Path:
    copy = COPY / name
    shutil.rmtree(copy, ignore_errors=True)
    for part in ("lbm_tpu_torch", "tests", "scripts", "docs/artifacts"):
        shutil.copytree(REPO / part, copy / part,
                        ignore=shutil.ignore_patterns("__pycache__"))
    source, mutations = MUTANTS[name]
    src = copy / "lbm_tpu_torch" / "csrc" / source
    text = src.read_text()
    for old, new in mutations:
        if text.count(old) != 1:
            raise SystemExit(f"coherence_mutant_torch: {source} no longer "
                             f"holds exactly one {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return copy


def run_test(root: Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-m", "cuda", TEST],
        cwd=root, capture_output=True, text=True)
    lines = (proc.stdout.strip() or proc.stderr.strip()).splitlines()
    return {"rc": proc.returncode, "last_line": lines[-1] if lines else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mutants", default=",".join(MUTANTS))
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    result = {"checkout": run_test(REPO), "mutants": {
        name: run_test(mutant_copy(name))
        for name in args.mutants.split(",")}}
    result["ok"] = result["checkout"]["rc"] == 0 and all(
        r["rc"] != 0 and "failed" in r["last_line"]
        for r in result["mutants"].values())
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
