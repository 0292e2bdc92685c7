"""Device selection and the tp=1 building blocks of the port."""

from theanompi_tpu_torch.parallel.mesh import resolve_device

__all__ = ["resolve_device"]
