"""Result I/O: re-exported from the numpy-only :mod:`lbm_tpu.io`, so the
port writes byte-identical ``final_state.dat`` / ``av_vels.dat`` files
and compares them with the same check.py formula."""

from lbm_tpu.io import (
    AV_VELS_FILE,
    FINAL_STATE_FILE,
    _diff,
    compare_golden,
    compare_golden_arrays,
    load_av_vels,
    load_final_state,
    write_av_vels,
    write_final_state,
)

__all__ = [
    "AV_VELS_FILE",
    "FINAL_STATE_FILE",
    "_diff",
    "compare_golden",
    "compare_golden_arrays",
    "load_av_vels",
    "load_final_state",
    "write_av_vels",
    "write_final_state",
]
