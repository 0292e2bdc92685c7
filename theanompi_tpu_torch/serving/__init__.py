"""Serving: KV-cache decoders, paged attention, the continuous-batching
engine with speculative decoding, the KV handoff records of
disaggregated prefill/decode, the batched tokenize front door, and the
fleet — replicas in-process or over TCP, the router over them and the
autoscaler (port of ``theanompi_tpu/serving``, at tp = 1)."""

from theanompi_tpu_torch.serving.autoscaler import Autoscaler
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
from theanompi_tpu_torch.serving.replica import (
    InProcessReplica,
    ReplicaServer,
    TCPReplicaClient,
)
from theanompi_tpu_torch.serving.router import (
    ConsistentHashRing,
    Router,
    prefix_affinity_key,
)
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
    "InProcessReplica", "ReplicaServer", "TCPReplicaClient",
    "ConsistentHashRing", "Router", "prefix_affinity_key", "Autoscaler",
]
