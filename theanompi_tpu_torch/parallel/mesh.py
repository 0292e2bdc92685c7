"""Device selection and the data-parallel process group.

The JAX package builds one mesh over ``default_devices()`` driven by a
single controller.  The port runs one process per device instead: rank
``r`` of a ``torch.distributed`` group owns device ``r``, NCCL on cards
and gloo on the CPU.  A one-rank group is still a group, so a one-card
run goes through the same exchange code as a multi-card run.

The asynchronous rules run W replicas in one process instead
(:func:`resolve_replica_devices`): their ``devices`` list has one entry
per worker, and every entry names the same device.

The card is the default: the CPU is used only when a caller asks for
it, and a missing card is an error rather than a quiet fall back to
the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` unless told otherwise.  Raises when a CUDA device is
    wanted (the default) and none is present; ``device="cpu"`` is the
    only way onto the CPU.  Resolving a CUDA device also pins float32
    matrix products to full float32 (no TF32), the precision the JAX
    reference computes in."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: the port runs on the card "
                "by default; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def resolve_devices(devices=None) -> list[torch.device]:
    """The devices of a data-parallel run, rank ``r`` owning entry
    ``r``.  ``None`` means every visible card (an error without one);
    entries are card indices, ``"cuda:i"`` names or ``"cpu"`` — a list
    of ``"cpu"`` entries is the only way onto the CPU.  One run does
    not mix the CPU with cards."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            resolve_device()          # raises: no card
        return [resolve_device(f"cuda:{i}") for i in range(n)]
    out = []
    for d in devices:
        out.append(resolve_device(f"cuda:{d}" if isinstance(d, int) else d))
    if not out:
        raise ValueError("devices is empty")
    if len({d.type for d in out}) > 1:
        raise ValueError(f"devices mix the CPU and cards: {devices}")
    if out[0].type == "cuda":
        n = torch.cuda.device_count()
        if any(d.index >= n for d in out):
            raise ValueError(f"requested {devices}, have {n} cards")
    if len(set(out)) != len(out) and out[0].type == "cuda":
        raise ValueError(f"a card appears twice in {devices}")
    return out


def resolve_replica_devices(devices=None) -> tuple[torch.device, int]:
    """``(device, n_workers)`` of an in-process async run: one entry
    of ``devices`` per worker (``["cpu"] * 4``, ``[0, 0]``), all naming
    one device, on which the replicas are stacked tensors.  ``None``
    means one worker per visible card.  Workers spread over several
    devices are the multi-process rules (ROADMAP.md A10)."""
    if devices is None:
        devs = resolve_devices(None)
    else:
        devs = [resolve_device(f"cuda:{d}" if isinstance(d, int) else d)
                for d in devices]
        if not devs:
            raise ValueError("devices is empty")
        cards = [d for d in devs if d.type == "cuda"]
        n = torch.cuda.device_count() if cards else 0
        if any(d.index >= n for d in cards):
            raise ValueError(f"requested {devices}, have {n} cards")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"async workers on several devices ({sorted(map(str, set(devs)))}"
            f") are not ported yet (ROADMAP.md A10: the multi-process "
            f"rules); list one device once per worker")
    return devs[0], len(devs)


def init_group(device: torch.device, rank: int = 0, world_size: int = 1,
               init_method: str | None = None) -> bool:
    """Join (or create) the default process group for ``device``.
    Returns True when this call created it (the caller then destroys
    it with :func:`destroy_group`); an existing group is kept when its
    backend, rank and size agree, and is an error otherwise.  A
    one-rank group needs no address (an in-memory store); a larger one
    takes ``init_method`` (``tcp://localhost:<port>``)."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
        if have != (backend, rank, world_size):
            raise ValueError(
                f"a process group ({have[0]}, rank {have[1]} of {have[2]}) "
                f"exists; this run needs ({backend}, rank {rank} of "
                f"{world_size})"
            )
        return False
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    if world_size == 1 and init_method is None:
        kw["store"] = dist.HashStore()
    elif init_method is None:
        raise ValueError(
            f"a {world_size}-rank group needs init_method "
            f"(tcp://localhost:<port>)"
        )
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return True


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
