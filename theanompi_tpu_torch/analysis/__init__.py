"""Static registries of the port (``registry.py``)."""
