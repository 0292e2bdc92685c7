"""Serving: KV-cache decoders, paged attention, the continuous-batching
engine with speculative decoding, the KV handoff records of
disaggregated prefill/decode and the batched tokenize front door (port
of ``theanompi_tpu/serving``; the fleet — router, replicas, autoscaler —
is not ported yet)."""

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
from theanompi_tpu_torch.serving.kv_transfer import (
    build_handoff,
    handoff_bytes,
    inject_handoff,
)
from theanompi_tpu_torch.serving.paged_attention import (
    paged_attend,
    paged_attend_reference,
)
from theanompi_tpu_torch.serving.prefix_cache import PrefixCache
from theanompi_tpu_torch.serving.speculation import NGramDrafter
from theanompi_tpu_torch.serving.tokenize import (
    ByteTokenizer,
    TokenizeService,
)

__all__ = [
    "BlockAllocator", "BlockManager", "OutOfBlocks",
    "LlamaDecoder", "PagedLlamaDecoder", "decoder_from_checkpoint",
    "default_prefill_buckets",
    "Engine", "Request", "Result", "ServingFuture",
    "build_handoff", "handoff_bytes", "inject_handoff",
    "paged_attend", "paged_attend_reference",
    "PrefixCache", "NGramDrafter", "ByteTokenizer", "TokenizeService",
]
