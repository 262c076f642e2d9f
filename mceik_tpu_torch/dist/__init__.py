"""Distribution over ``torch.distributed`` ranks: the mesh, chain and
particle sharding and the collectives (``mesh.py``), sharded resampling
(``resample.py``), and the dryrun of every sharded path (``dryrun.py``).
The grid-sharded solve is ``eikonal/dist_sweep.py``, the table reshard
``forward/reshard.py``."""
