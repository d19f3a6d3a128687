"""SPMD mesh decomposition over a jax device mesh.

JAX replacement for the reference's MPI domain decomposition
(Metis partitions + mpas_dmpar halo exchange; SURVEY.md section 2h):
cells are partitioned into contiguous blocks after a locality reordering,
each shard gets a local submesh of owned + 2-deep-halo entities (the
MPAS block structure, reference Registry.xml:337-340 config_num_halos=2),
and halo refresh is a collective inside the single jitted step.
"""

from .partition import Partition, partition_mesh
from .sharded import ShardedSeaIceModel, dryrun
