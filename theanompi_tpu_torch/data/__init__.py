"""The data plane of the port (``theanompi_tpu/data``).

``pipeline`` — :class:`HostStager` (pinned buffers and a copy stream:
the one host→device path) and :class:`StreamingLoader` (producer-thread
ring of staged batches, the drop-in ``next()`` for the worker loops),
with :func:`engine_feed` over the async rules' replica engine.
``sharding`` — :class:`ShardedBatches` (worker-w-of-n stride views)
and the journal :func:`coverage_check`.
"""

from theanompi_tpu_torch.data.pipeline import (
    HostStager,
    StagedBatch,
    StreamingLoader,
    engine_feed,
    resolve_loader_depth,
)
from theanompi_tpu_torch.data.sharding import (
    ShardedBatches,
    coverage_check,
    shard_ids,
)

__all__ = [
    "HostStager",
    "ShardedBatches",
    "StagedBatch",
    "StreamingLoader",
    "coverage_check",
    "engine_feed",
    "resolve_loader_depth",
    "shard_ids",
]
