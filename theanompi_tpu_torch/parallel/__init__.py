"""Device selection, the BSP exchange and the async rules' merges of
the port."""

from theanompi_tpu_torch.parallel.exchange import (
    elastic_center_merge,
    elastic_center_merge_masked,
    elastic_pair_update,
    gossip_deliver,
    gossip_matrix_round,
    gossip_merge,
    gossip_push,
    gossip_send,
)
from theanompi_tpu_torch.parallel.mesh import (
    resolve_device,
    resolve_replica_devices,
)

__all__ = ["elastic_center_merge", "elastic_center_merge_masked",
           "elastic_pair_update", "gossip_deliver", "gossip_matrix_round",
           "gossip_merge", "gossip_push", "gossip_send", "resolve_device",
           "resolve_replica_devices"]
