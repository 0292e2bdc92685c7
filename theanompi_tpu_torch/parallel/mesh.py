"""Device selection and the data-parallel process group.

The JAX package builds one mesh over ``default_devices()`` driven by a
single controller.  The port runs one process per device instead: rank
``r`` of a ``torch.distributed`` group owns device ``r``, NCCL on cards
and gloo on the CPU.  A one-rank group is still a group, so a one-card
run goes through the same exchange code as a multi-card run.

The asynchronous rules run W replicas in one process when their
``devices`` list names one device once per worker
(:func:`resolve_replica_devices`), and one process per device
otherwise: each process is then one worker, its peers found through a
:class:`KVStore` on the run's ``tcp://host:port`` address.

Tensor-parallel serving joins a :class:`ModelGroup`: one process a
rank, a device group for the activations' collectives (NCCL, one card a
rank; gloo only when the caller asks, e.g. for two ranks on one card)
and a CPU gloo group for the small headers rank 0 sends its followers.

The card is the default: the CPU is used only when a caller asks for
it, and a missing card is an error rather than a quiet fall back to
the CPU.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from urllib.parse import urlparse

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
    if len(set(out)) != len(out) and out[0].type == "cuda" and not (
            dist.is_initialized() and dist.get_backend() == "gloo"):
        # NCCL takes one card a rank; ranks that joined a gloo group
        # before the run (init_group(backend="gloo")) may share one
        raise ValueError(f"a card appears twice in {devices}")
    return out


def resolve_worker_devices(devices=None) -> list[torch.device]:
    """The device of each async worker: one entry of ``devices`` per
    worker (``["cpu"] * 4``, ``[0, 0]``, ``[0, 1]``; a device may
    repeat).  ``None`` means one worker per visible card."""
    if devices is None:
        return resolve_devices(None)
    devs = [resolve_device(f"cuda:{d}" if isinstance(d, int) else d)
            for d in devices]
    if not devs:
        raise ValueError("devices is empty")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices mix the CPU and cards: {devices}")
    cards = [d for d in devs if d.type == "cuda"]
    n = torch.cuda.device_count() if cards else 0
    if any(d.index >= n for d in cards):
        raise ValueError(f"requested {devices}, have {n} cards")
    return devs


def resolve_replica_devices(devices=None) -> tuple[torch.device, int]:
    """``(device, n_workers)`` of an in-process async run: one entry
    of ``devices`` per worker (``["cpu"] * 4``, ``[0, 0]``), all naming
    one device, on which the replicas are stacked tensors.  ``None``
    means one worker per visible card.  Workers on several devices run
    one process per device (``launcher.launch(mode="subprocess")``)."""
    devs = resolve_worker_devices(devices)
    if len(set(devs)) > 1:
        raise ValueError(
            f"async workers on several devices ({sorted(map(str, set(devs)))}"
            f") run one process per device: use launcher.launch(mode="
            f"'subprocess'), or list one device once per worker to run "
            f"them in this process")
    return devs[0], len(devs)


class KVStore:
    """The key-value store a multi-process async run bootstraps
    through: a ``torch.distributed.TCPStore`` on ``init_method``
    (``tcp://host:port``) with rank 0 as its master.  ``set`` and a
    blocking ``get`` with a timeout in ms are the two calls the JAX
    workers make on the ``jax.distributed`` client (``key_value_set``,
    ``blocking_key_value_get``).

    ``close`` ends the run's use of it: every rank posts a leaving
    mark, and the master waits (at most ``timeout_s``) for all of them
    before dropping the store, so no rank loses it mid-read."""

    def __init__(self, rank: int, world_size: int, init_method: str,
                 timeout_s: float = 300.0):
        url = urlparse(init_method)
        if url.scheme != "tcp" or not url.hostname or not url.port:
            raise ValueError(
                f"init_method must be tcp://host:port, got {init_method!r}")
        self.host = url.hostname
        self.rank, self.world_size = int(rank), int(world_size)
        self._timeout_s = float(timeout_s)
        self._store = dist.TCPStore(
            self.host, url.port, self.world_size, self.rank == 0,
            datetime.timedelta(seconds=timeout_s), wait_for_workers=False)

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get(self, key: str, timeout_ms: int) -> str:
        """``key``'s value once some rank has set it; ``TimeoutError``
        after ``timeout_ms``."""
        try:
            self._store.wait([key],
                             datetime.timedelta(milliseconds=timeout_ms))
        except dist.DistStoreError as e:
            raise TimeoutError(
                f"key {key!r} not set within {timeout_ms} ms") from e
        return self._store.get(key).decode()

    def close(self) -> None:
        self.set(f"tm_kv_left_{self.rank}", "1")
        if self.rank == 0:
            for r in range(1, self.world_size):
                try:
                    self.get(f"tm_kv_left_{r}", int(self._timeout_s * 1000))
                except TimeoutError:
                    break
        self._store = None


def init_group(device: torch.device, rank: int = 0, world_size: int = 1,
               init_method: str | None = None, *,
               backend: str | None = None) -> bool:
    """Join (or create) the default process group for ``device``.
    Returns True when this call created it (the caller then destroys
    it with :func:`destroy_group`); an existing group is kept when its
    backend, rank and size agree, and is an error otherwise.  A
    one-rank group needs no address (an in-memory store); a larger one
    takes ``init_method`` (``tcp://localhost:<port>``).

    ``backend``: ``"nccl"`` (the default for a CUDA device) or
    ``"gloo"`` (the default for the CPU; on a card only when asked,
    e.g. for ranks that share one card, which NCCL refuses).  With
    ``backend=None`` an existing group's backend is kept, so a run
    started inside a gloo group its caller made goes on in it.  Under
    NCCL, ranks that name the same card are an error, raised on every
    rank before the group is made."""
    if backend is None:
        backend = (dist.get_backend() if dist.is_initialized()
                   else "nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got "
                         f"{device}")
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
        if backend == "nccl":
            kw["device_id"] = device
    if world_size == 1 and init_method is None:
        kw["store"] = dist.HashStore()
    elif init_method is None:
        raise ValueError(
            f"a {world_size}-rank group needs init_method "
            f"(tcp://localhost:<port>)"
        )
    elif backend == "nccl":
        kw["store"] = _distinct_cards(device, rank, world_size, init_method)
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return True


def _distinct_cards(device, rank, world_size, init_method):
    """The rendezvous store of ``init_method``, after every rank has
    posted its card's UUID: raises on each rank when two ranks name one
    card (NCCL would refuse them later and less clearly)."""
    store, _, _ = next(dist.rendezvous(init_method, rank, world_size))
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    store.set(f"tm_card_{rank}", uuid)
    cards = [store.get(f"tm_card_{r}").decode() for r in range(world_size)]
    if len(set(cards)) < world_size:
        raise ValueError(
            f"ranks {cards} share a card under nccl, which takes one card "
            f"a rank; pass backend='gloo' to run several ranks on one card"
        )
    return store


@dataclass
class ModelGroup:
    """One rank's view of a tensor-parallel model group: its ``rank``
    and the group's ``size``, ``device_group`` for the activations'
    collectives (the default process group: NCCL, or gloo when asked)
    and ``cpu_group``, a gloo group for host headers."""

    rank: int
    size: int
    device_group: object
    cpu_group: object

    @classmethod
    def join(cls, device, rank: int, size: int, init_method: str, *,
             backend: str | None = None) -> "ModelGroup":
        """Create the default group (:func:`init_group`) and the CPU
        header group; every rank calls this, in the same order."""
        init_group(torch.device(device), rank, size, init_method,
                   backend=backend)
        return cls(rank, size, dist.group.WORLD,
                   dist.new_group(backend="gloo"))


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
