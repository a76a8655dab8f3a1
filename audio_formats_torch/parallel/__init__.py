from .batch import BatchDecoder
from .encode import encode_qoa_batch, encode_wav_batch
from .mesh import (Mesh, batch_channel_sharding, batch_sharding, make_mesh,
                   shard_batch)

__all__ = ["BatchDecoder", "Mesh", "batch_channel_sharding",
           "batch_sharding", "encode_qoa_batch", "encode_wav_batch",
           "make_mesh", "shard_batch"]
