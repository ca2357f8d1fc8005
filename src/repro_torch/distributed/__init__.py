"""Sharding rules on a ``DeviceMesh``, collectives and pipeline
parallelism."""
