"""Multi-device: the row mesh over ``torch.distributed`` and the
row-sharded grid engines.

Port of the JAX package's ``parallel/`` package, so far without
``ring.py`` and ``distributed_md.py`` (plain JAX, no kernel), which are
still to be ported.
"""

from jax_tpus_benchmark_physics_simulation_tpu_torch.parallel.mesh import (
    RowMesh,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_along,
)

__all__ = ["RowMesh", "make_mesh", "shard_along", "replicated", "pad_to_multiple"]
