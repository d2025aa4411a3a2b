"""Multi-GPU: one process per device (``torch.distributed``), the mesh, and
the collectives the sharded paths use.

Re-exports the names ``light_unet_tpu.parallel`` does, apart from
``batch_sharding`` and ``replicated_sharding``, which return
``jax.sharding`` objects and have no counterpart: a rank holds its rows of
a batch (``shard_batch``) or a whole copy (``replicate``) as a plain
tensor."""

from light_unet_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    mesh_from_config,
    replicate,
    shard_batch,
)
