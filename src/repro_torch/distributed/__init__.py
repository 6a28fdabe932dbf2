"""Distribution layer of the port: the serving half of the reference's
``repro.distributed`` (page-pool sharding over a device mesh)."""
