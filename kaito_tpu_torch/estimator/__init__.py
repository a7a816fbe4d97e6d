"""Device-memory sizing: the TPU estimator (a copy of
``kaito_tpu.estimator``) and its GPU half for the port's engine."""

from kaito_tpu_torch.estimator.estimator import (  # noqa: F401
    CUDA_CONTEXT_BYTES,
    HBM_UTILIZATION,
    WEIGHT_EXPANSION,
    PER_CHIP_OVERHEAD_BYTES,
    SliceEstimate,
    engine_weight_bytes,
    estimate_chip_count,
    estimate_slice,
    gpu_card_budget,
    max_kv_tokens,
    weight_bytes,
)
