"""Debug-mode consistency check of the replicas (``TM_DEBUG_SYNC=1``).

Port of ``theanompi_tpu/parallel/debug.py``.  There one controller holds
every device's copy of a replicated array and compares them on the
host.  Here each rank of the process group holds one copy, so rank 0's
values are broadcast and every rank takes the worst |rank r − rank 0|
of each tensor on its own device (in fp32: bf16 and fp32 values are
exact in it, and x − y is 0.0 exactly when x == y), then the group's
worst spread is an ``all_reduce(MAX)``.  Nonzero means a broken
collective, a missed update or silent corruption.

The BSP worker runs the check at every epoch end when ``TM_DEBUG_SYNC``
is ``1``; it raises on any nonzero spread (``strict=False`` returns the
spread instead).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


@torch.no_grad()
def replica_buffer_spread(tree, group=None) -> float:
    """Worst |rank r − rank 0| over every tensor of ``tree`` (nested
    dicts and lists of tensors) and every rank of the group (the default
    group, or a layout axis: an object with ``size``, ``ranks`` and
    ``device_group``, whose first rank is the reference); 0.0 without a
    group of more than one rank."""
    if not dist.is_initialized():
        return 0.0
    size = dist.get_world_size() if group is None else group.size
    if size < 2:
        return 0.0
    pg = None if group is None else group.device_group
    src = 0 if group is None else group.ranks[0]
    worst = None
    for t in _leaves(tree):
        if t.numel() == 0:
            continue
        ref = t.detach().clone()
        dist.broadcast(ref, src=src, group=pg)
        d = (t.detach().float() - ref.float()).abs().max()
        worst = d if worst is None else torch.maximum(worst, d)
    if worst is None:
        return 0.0
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=pg)
    return float(worst)


def check_replicas_synced(tree, *, strict: bool = True,
                          label: str = "params", group=None) -> float:
    """Assert (or report) that the ranks (of ``group``) hold equal
    copies of ``tree``."""
    spread = replica_buffer_spread(tree, group)
    if spread > 0.0 and strict:
        raise RuntimeError(
            f"replica desync in {label}: device copies differ by "
            f"{spread:g} — broken collective or memory corruption"
        )
    return spread
