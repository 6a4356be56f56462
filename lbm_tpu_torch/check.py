"""Golden-output checker CLI, the twin of :mod:`lbm_tpu.check` (a drop-in
for the reference's ``check/check.py``: same flags, same printed diff
report, same exit codes; check/check.py:19-151).

Usage::

    python -m lbm_tpu_torch.check --ref-av-vels-file=... --ref-final-state-file=...
        --av-vels-file=... --final-state-file=... [--tolerance 1]
"""

from __future__ import annotations

import argparse
import sys

from lbm_tpu_torch.io import compare_golden_arrays, load_av_vels, load_final_state


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="Golden-output checker for lbm_tpu_torch results",
        fromfile_prefix_chars="@",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--tolerance", nargs=1, default=[1], type=float,
                   help="Percentage tolerance to match against reference results")
    p.add_argument("--ref-av-vels-file", nargs=1, required=True)
    p.add_argument("--ref-final-state-file", nargs=1, required=True)
    p.add_argument("--av-vels-file", nargs=1, required=True)
    p.add_argument("--final-state-file", nargs=1, required=True)
    args = p.parse_args(argv)

    try:
        fs_sim = load_final_state(args.final_state_file[0])
        res = compare_golden_arrays(
            load_av_vels(args.av_vels_file[0]),
            fs_sim,
            load_av_vels(args.ref_av_vels_file[0]),
            load_final_state(args.ref_final_state_file[0]),
            tolerance=args.tolerance[0],
        )
    except (ValueError, OSError) as exc:
        print(exc)
        return 1

    av = res.av_vels
    print("Total difference in av_vels : %.12E" % av.total)
    print("Biggest difference (at step %d) : %.12E" % (av.max_diff_index, av.max_diff))
    print("  %.12E vs. %.12E = %.2g%%" % (av.sim_val, av.ref_val, av.max_diff_pcnt))
    print()
    fs = res.final_state
    jj = int(fs_sim[fs.max_diff_index, 0])
    ii = int(fs_sim[fs.max_diff_index, 1])
    print("Total difference in final_state : %.12E" % fs.total)
    print("Biggest difference (at coord (%d,%d)) : %.12E" % (jj, ii, fs.max_diff))
    print("  %.12E vs. %.12E = %.2g%%" % (fs.sim_val, fs.ref_val, fs.max_diff_pcnt))
    print()

    if fs.failed:
        print("final state failed check")
    if av.failed:
        print("av_vels failed check")
    if fs.failed or av.failed:
        return 1
    print("Both tests passed!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
