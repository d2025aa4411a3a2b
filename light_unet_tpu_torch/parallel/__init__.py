"""Multi-GPU: one process per device (``torch.distributed``), the mesh, and
the collectives the sharded paths use."""
