"""Data-parallel training across cards on ``torch.distributed``.

The port of the JAX package's ``parallel/mesh.py`` and
``parallel/sharded_pool.py``: one process a card (a rank), a process
group over them (``mesh.make_mesh``), the global batch split over the
ranks, the batch-global statistics of the step (BN, the CCA layer's
moments, the ranking loss's score matrix) computed across them, and a
piece-sharded device dataset (``sharded_pool.ShardedDevicePool``).
"""
