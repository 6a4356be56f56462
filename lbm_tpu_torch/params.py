"""Scene parameters: re-exported from the numpy-only :mod:`lbm_tpu.params`
so both packages parse ``.params`` files identically."""

from lbm_tpu.params import Params, load_params

__all__ = ["Params", "load_params"]
