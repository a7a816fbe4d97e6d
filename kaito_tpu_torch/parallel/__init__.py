"""Tensor parallelism for the serving engine: the device mesh and the
logical-axis sharding rules (counterpart of ``kaito_tpu.parallel``)."""
