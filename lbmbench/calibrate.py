"""The readings a cell's limits are set from, in one process on the card:

- ``port``: the program's numbers (:mod:`lbmbench.compare`) over a
  short window of the cell on each seed, as a run's check reads them;
  the largest over a dozen seeds or more is the lower reading;
- ``control``: the plain reference put in the program's place with its
  state kept in bfloat16 (:class:`.harness.Control`), the same scenes
  and comparison; the smallest over three seeds or more is the upper
  reading;
- ``witness``: the plain reference in float32 in the program's place, a
  second float32 computation to set the program's readings beside.

    python3 -m lbmbench.calibrate --workload ref256.scene --program port \\
        --seeds 1 2 3 ... [--seconds 1]

Prints one JSON line a seed, then the largest and the smallest reading
of each number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lbmbench import compare, harness, spec

PROGRAMS = {"port": None, "control": (torch.float32, torch.bfloat16),
            "witness": (torch.float32, None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m lbmbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--program", choices=sorted(PROGRAMS), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.resolve(args.workload)
    rows = []
    for seed in args.seeds:
        kind = PROGRAMS[args.program]
        program = None if kind is None else harness.Control(args.device,
                                                            *kind)
        result, notes, _ = harness.run_cell(
            cell, seed, args.seconds, False, args.device, program,
            warm=kind is None)
        row = {n: result["checks"][n]["value"] for n in compare.NUMBERS}
        rows.append(row)
        print(json.dumps({"workload": cell.name, "program": args.program,
                          "seed": seed, "correct": result["correct"],
                          "scenes": result["attempted"], **row}), flush=True)
    for what, pick in (("largest", max), ("smallest", min)):
        print(json.dumps({"workload": cell.name, "program": args.program,
                          "seeds": len(rows), what: {
                              n: pick(r[n] if r[n] is not None
                                      else float("inf") for r in rows)
                              for n in compare.NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
