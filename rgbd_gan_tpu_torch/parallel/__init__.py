from .mesh import DATA_AXIS, is_master, make_mesh, maybe_initialize_distributed, replicate, shard_batch

__all__ = ["DATA_AXIS", "is_master", "make_mesh", "maybe_initialize_distributed", "replicate", "shard_batch"]
