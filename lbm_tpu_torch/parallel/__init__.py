"""Row sharding of the lattice over a list of devices: the twin of
:mod:`lbm_tpu.parallel`.

One controller drives every shard, as ``jax.shard_map`` does: each shard
owns its rows of the lattice on its own device and CUDA stream, halo rows
are device-to-device copies (peer copies across cards), and av_vels is
summed over the shards in a fixed order once per run. A device list may
repeat a device, so P shards can share one card.

- :mod:`.decomp`: the mesh and the row decomposition;
- :mod:`.halo`: the padding and mesh planners, the halo exchange, the
  per-shard step implementations and the sharded simulation;
- :mod:`.resident_ring`: the ring kernel's planner and wrapper.
"""
