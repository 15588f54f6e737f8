"""The port of ``repro.distributed``: the mesh context, the per-rank
``shard_map`` and its collectives (:mod:`.context`), the sharding rules
(:mod:`.sharding`), the pipeline-parallel decode (:mod:`.pp_decode`) and
process identity for fleet-tagged traces."""
from .context import process_info, process_tags, shard_path
from .sharding import ShardingRules, dp_axes, mesh_axis_size

__all__ = ["ShardingRules", "dp_axes", "mesh_axis_size",
           "process_info", "process_tags", "shard_path"]
