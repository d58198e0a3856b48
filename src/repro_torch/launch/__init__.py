"""Launcher layer: device selection, the step builders, meshes over
``torch.distributed`` and the data-parallel shard_map step."""
from .mesh import make_data_mesh, make_debug_mesh, make_production_mesh

__all__ = ["make_data_mesh", "make_debug_mesh", "make_production_mesh"]
