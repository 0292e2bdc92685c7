"""Serving: KV-cache decoders, paged attention and the
continuous-batching engine (port of ``theanompi_tpu/serving``)."""

from theanompi_tpu_torch.serving.blocks import (
    BlockAllocator,
    BlockManager,
    OutOfBlocks,
)
from theanompi_tpu_torch.serving.decoder import (
    LlamaDecoder,
    PagedLlamaDecoder,
    decoder_from_checkpoint,
    default_prefill_buckets,
)
from theanompi_tpu_torch.serving.engine import (
    Engine,
    Request,
    Result,
    ServingFuture,
)
from theanompi_tpu_torch.serving.paged_attention import (
    paged_attend,
    paged_attend_reference,
)
from theanompi_tpu_torch.serving.prefix_cache import PrefixCache

__all__ = [
    "BlockAllocator", "BlockManager", "OutOfBlocks",
    "LlamaDecoder", "PagedLlamaDecoder", "decoder_from_checkpoint",
    "default_prefill_buckets",
    "Engine", "Request", "Result", "ServingFuture",
    "paged_attend", "paged_attend_reference",
    "PrefixCache",
]
