"""PyTorch serving engine: config-driven transformer, paged KV cache,
continuous batching, Hopper attention kernels and an OpenAI-compatible
HTTP front end."""

from kaito_tpu_torch.engine.config import EngineConfig  # noqa: F401
