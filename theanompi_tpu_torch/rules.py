"""User-facing synchronization-rule classes (port of
``theanompi_tpu/rules.py``)::

    rule = BSP()
    rule.init(devices=["cpu"], modelfile="theanompi_tpu_torch.models.llama",
              modelclass="Llama", launch="inprocess", n_epochs=1)
    rule.wait()

``init`` starts the run in processes of its own (``launch=
"subprocess"``, the default: it returns at once and ``wait()`` joins
them) or runs the worker in this process (``launch="inprocess"``:
``wait()`` returns its summary).  BSP takes one process per device.
``EASGD`` and ``GOSGD`` run all their workers in one process, as
replicas on one device: ``devices`` lists that device once per worker
(``["cpu"] * 4``, ``[0, 0, 0, 0]``), or one worker a process:
``rule.init(devices=[d], rank=r, world_size=n, init_method=...)`` in
each process (the launcher's ``--coordinator`` does the same).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from theanompi_tpu_torch import launcher as _launcher


class Rule:
    """Base synchronization rule (a facade over the launcher)."""

    #: worker module run per process, overridden by subclasses
    worker_module: str = ""

    def __init__(self) -> None:
        self._handle: Optional[_launcher.LaunchHandle] = None
        self.result: Any = None

    def init(
        self,
        devices: Sequence[Any] | None = None,
        modelfile: str = "",
        modelclass: str = "",
        *,
        launch: str = "subprocess",
        **kwargs: Any,
    ) -> None:
        """Start training ``modelclass`` from ``modelfile`` on
        ``devices`` (None: every card; ``["cpu"]``: the CPU)."""
        if not modelfile or not modelclass:
            raise ValueError("modelfile and modelclass are required")
        self._handle = _launcher.launch(
            worker_module=self.worker_module,
            devices=devices,
            modelfile=modelfile,
            modelclass=modelclass,
            mode=launch,
            rule_kwargs=kwargs,
        )

    def wait(self) -> Any:
        """Block until training finishes."""
        if self._handle is None:
            raise RuntimeError("call init() before wait()")
        self.result = self._handle.wait()
        return self.result


class BSP(Rule):
    """Bulk-synchronous parallel: gradient mean-allreduce every step."""

    worker_module = "theanompi_tpu_torch.workers.bsp_worker"


class EASGD(Rule):
    """Elastic-averaging SGD (Zhang et al. 2015): W replicas exchanging
    with a center every ``tau`` steps.  ``init`` accepts ``server=...``
    and ``workers=[...]`` as the reference's async launch did; the
    center lives in the controller, so ``server`` is ignored."""

    worker_module = "theanompi_tpu_torch.workers.easgd_worker"

    def init(  # type: ignore[override]
        self,
        server: Any = None,
        workers: Sequence[Any] | None = None,
        devices: Sequence[Any] | None = None,
        modelfile: str = "",
        modelclass: str = "",
        **kwargs: Any,
    ) -> None:
        if devices is None and workers is not None:
            devices = list(workers)
        kwargs.setdefault("server_device", server)
        super().init(devices=devices, modelfile=modelfile,
                     modelclass=modelclass, **kwargs)


class GOSGD(Rule):
    """Gossip SGD (Blot et al. 2016): randomized peer push and
    score-weighted merge between W replicas."""

    worker_module = "theanompi_tpu_torch.workers.gosgd_worker"
