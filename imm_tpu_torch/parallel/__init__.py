"""Multi-process training of the port: the data-parallel mesh and its
collectives (``mesh``), process-group start-up and dataset sharding
(``distributed``), and a dry run of the data-parallel step on the CPU
(``dryrun``)."""

from imm_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate"]
