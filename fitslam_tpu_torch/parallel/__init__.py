"""Meshes of ranks and the sharded solvers (port of ``fitslam_tpu/parallel/``).

The reference shards over a device mesh driven by one controller
(``jax.sharding`` + ``shard_map``). The port runs one process a device (a
rank) joined by ``torch.distributed``: ``mesh.py`` builds the meshes, the
collectives and the launcher, ``dist_ba.py`` the observation- and
landmark-sharded BA, ``dist_stages.py`` sharded fusion, raycast, PGO and the
frontend | backend stage pipeline, ``multihost.py`` the multi-process runner
and ``dryrun.py`` the N-rank dry run.
"""
