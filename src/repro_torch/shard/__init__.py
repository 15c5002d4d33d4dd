"""Block-sharded field store over the analytics device mesh.

Placement (:class:`BlockPlacement`) stripes a field's compressor blocks
over a 1-D ``("shard",)`` mesh (:func:`repro_torch.launch.mesh
.make_analytics_mesh`); the shard programs (:class:`ShardPrograms`) decode
region queries from shard-local payload stripes and merge temporal
summaries homomorphically; the :class:`ShardedFieldStore` serves both
through per-shard byte-budgeted caches, bit-identical to the single-device
store.
"""
from .placement import BlockPlacement
from .exec import ShardPrograms, mesh_sig, spatial_bands
from .store import ShardedFieldStore

__all__ = ["BlockPlacement", "ShardPrograms", "ShardedFieldStore",
           "mesh_sig", "spatial_bands"]
