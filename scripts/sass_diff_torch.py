#!/usr/bin/env python3
"""Compare two checkouts' kernels instruction by instruction: every
kernel's SASS opcode counts, each opcode with all its modifiers
(``scripts/depth_ab_torch.py``'s ``sass_opcodes``), in this checkout's
library and in another's (``--parent``, a copy of another commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists). Each
checkout builds its own library in a process of its own.

Prints one JSON line: the card (``nvidia-smi``), the kernels whose counts
are the same, those that differ (``--skip``: name prefixes a change is
expected to alter, reported apart) and those only one library has; exit
code 0 when no kernel outside ``--skip`` differs or is missing.

``--pin-onchip FILE`` also writes this checkout's two-buffer on-chip
kernels' counts (``*onchip_kernel<kCols, kMode, 2...>``) to FILE, the pin that
``tests/test_torch_cuda.py::test_two_buffer_onchip_kernels_keep_their_
pinned_sass`` holds the build to (``docs/artifacts/
onchip_two_buffer_sass.json``).

Usage: python scripts/sass_diff_torch.py --parent DIR
       [--skip resident_shift_kernel<] [--pin-onchip FILE] [-o artifact.json]
       (The CUDA toolkit's nvcc and cuobjdump are required.)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def library(checkout: Path) -> Path:
    """The checkout's kernel library, built in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from lbm_tpu_torch.ops import _build; print(_build.build()[0])")
    out = subprocess.run([sys.executable, "-c", code, str(checkout)],
                         capture_output=True, text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--skip", action="append", default=[],
                    help="a kernel name prefix the change is expected to "
                    "alter (repeatable)")
    ap.add_argument("--pin-onchip", metavar="FILE")
    ap.add_argument("-o", "--output")
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location(
        "depth_ab_torch", REPO / "scripts" / "depth_ab_torch.py")
    dab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dab)
    parent = dab.sass_opcodes(library(Path(args.parent).resolve()), None,
                              modifiers=True)
    change = dab.sass_opcodes(library(REPO), None, modifiers=True)

    def skipped(name):
        return any(name.startswith(s) for s in args.skip)

    names = sorted(set(parent) | set(change))
    result = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(),
        "same": [k for k in names if parent.get(k) == change.get(k)],
        "differ": [k for k in names if k in parent and k in change
                   and parent[k] != change[k] and not skipped(k)],
        "expected_to_differ": [k for k in names if skipped(k)
                               and parent.get(k) != change.get(k)],
        "only_parent": [k for k in names if k not in change
                        and not skipped(k)],
        "only_change": [k for k in names if k not in parent
                        and not skipped(k)],
    }
    result["ok"] = not (result["differ"] or result["only_parent"]
                        or result["only_change"])
    if args.pin_onchip:
        nvcc = subprocess.run(["nvcc", "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
        pin = {"what": "cuobjdump -sass opcode counts, every modifier, of "
                       "the on-chip kernels in two buffers, built by "
                       f"lbm_tpu_torch/ops/_build.py ({nvcc}, sm_90a) on "
                       f"{result['card']}",
               "kernels": {k: change[k] for k in sorted(change)
                           if "onchip_kernel<" in k and k.split("<")[1].split(
                               ",")[2] in ("2", "2>")}}
        Path(args.pin_onchip).write_text(json.dumps(pin, indent=0) + "\n")
    text = json.dumps(result)
    print(text, flush=True)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
