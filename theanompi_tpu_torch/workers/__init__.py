"""Training workers of the port (``bsp_worker``)."""
