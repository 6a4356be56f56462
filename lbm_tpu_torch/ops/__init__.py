"""Per-timestep operators: the plain PyTorch reference (:mod:`.reference`)
and the CUDA kernel's wrapper (:mod:`.fused`, built by :mod:`._build`)."""
