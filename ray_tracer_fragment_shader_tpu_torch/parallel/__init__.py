"""Pixel sharding over ``torch.distributed`` ranks (the JAX package's
``parallel/``): ``mesh`` (the ranks), ``shard`` (sharded render and
gradient reduction), ``multihost`` (process-group bring-up, the scaling
sweep and the dry run)."""
from .mesh import TILE_AXIS, make_mesh, replicated, row_sharded
from .shard import render_image_sharded, sharded_value_and_grad

__all__ = ["TILE_AXIS", "make_mesh", "replicated", "row_sharded",
           "render_image_sharded", "sharded_value_and_grad"]
