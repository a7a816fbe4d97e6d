"""Workload rendering: Services, StatefulSets and tuning Jobs from a
ParallelPlan, and the endpoint picker's Deployment (a copy of
``kaito_tpu.manifests``)."""

from kaito_tpu_torch.manifests.inference import (  # noqa: F401
    build_engine_command,
    generate_inference_workload,
)
from kaito_tpu_torch.manifests.core import (  # noqa: F401
    generate_service,
    generate_headless_service,
    generate_statefulset,
)
