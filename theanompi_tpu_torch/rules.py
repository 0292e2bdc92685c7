"""User-facing synchronization-rule classes (port of
``theanompi_tpu/rules.py``)::

    rule = BSP()
    rule.init(devices=["cpu"], modelfile="theanompi_tpu_torch.models.llama",
              modelclass="Llama", launch="inprocess", n_epochs=1)
    rule.wait()

``init`` launches one process per device (``launch="subprocess"``, the
default: it returns at once and ``wait()`` joins) or runs the worker in
this process on one device (``launch="inprocess"``: ``wait()`` returns
its summary).  ``EASGD`` and ``GOSGD`` are not ported yet (ROADMAP.md
A10).
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


class _Unported(Rule):
    def init(self, *args, **kwargs) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} is not ported yet (ROADMAP.md A10: the "
            f"asynchronous rules)"
        )


class EASGD(_Unported):
    """Elastic-averaging SGD (not ported yet)."""


class GOSGD(_Unported):
    """Gossip SGD (not ported yet)."""
