"""Sharded search over a list of torch devices (``faiss_tpu.parallel``'s
counterpart): the database row-sharded over the devices, each shard's
search on its own device, the per-shard top-k lists merged on the first.
One process drives every device; a list may name one device more than
once."""

from .sharded import ShardedIndexFlat  # noqa: F401
from .sharded_ivf import ShardedIndexIVFFlat  # noqa: F401
