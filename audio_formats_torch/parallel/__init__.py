from .batch import BatchDecoder
from .encode import encode_qoa_batch

__all__ = ["BatchDecoder", "encode_qoa_batch"]
