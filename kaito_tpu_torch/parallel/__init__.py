"""Parallelism: the device mesh of a tensor-parallel engine, the
logical-axis sharding rules, and the planner that sizes a Workspace's
slice and mesh (counterpart of ``kaito_tpu.parallel``)."""
