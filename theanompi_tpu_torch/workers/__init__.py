"""Training workers of the port (``bsp_worker``; ``easgd_worker`` and
``gosgd_worker`` over ``replica_engine``)."""
