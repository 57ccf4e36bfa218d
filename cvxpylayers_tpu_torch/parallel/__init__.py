from .mesh import (
    batch_sharding,
    make_data_mesh,
    pad_batch,
    replicated,
    shard_layer_call,
)

__all__ = [
    "batch_sharding",
    "make_data_mesh",
    "pad_batch",
    "replicated",
    "shard_layer_call",
]
