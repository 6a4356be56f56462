"""The benchmark's command line.

    python3 -m lbmbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card this process finds
(:mod:`lbmbench.harness`) and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit. The same numbers are
the last lines of standard error.

It exits with another code than 0, and prints no result, where no CUDA
device is available or fewer than the cell asks for, and where ``jax``,
``jaxlib``, ``flax`` or ``lbm_tpu`` is loaded in this process once the
window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Exit codes other than 0.
NO_CARD, FORBIDDEN_LOADED = 2, 3


def _args(argv):
    p = argparse.ArgumentParser(prog="python3 -m lbmbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_note() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return "card: " + p.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"card: nvidia-smi did not answer ({exc})"


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _args(sys.argv[1:] if argv is None else argv)

    from lbmbench import harness, spec

    cell = spec.resolve(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"lbmbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {found}", file=sys.stderr)
        return NO_CARD
    result, notes, bad = harness.run_cell(cell, args.seed, args.seconds,
                                          bool(args.trace), "cuda", t0=t0)
    bad = sorted(set(bad) | set(harness.forbidden_modules()))
    if bad:
        print(f"lbmbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return FORBIDDEN_LOADED
    print(card_note(), file=sys.stderr)
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
