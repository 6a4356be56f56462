"""lbmbench: the benchmark of ``lbm_tpu_torch``, the PyTorch and CUDA port
of ``lbm_tpu``. ``python3 -m lbmbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; see ``README.md`` beside this file."""
