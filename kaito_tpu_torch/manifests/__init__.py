"""Workload rendering: Services, StatefulSets and tuning Jobs from a
ParallelPlan (a copy of ``kaito_tpu.manifests`` less ``epp.py``, the
endpoint picker's Deployment, which waits for the port's runtime
services: ROADMAP queue 1, items 1-2)."""

from kaito_tpu_torch.manifests.inference import (  # noqa: F401
    build_engine_command,
    generate_inference_workload,
)
from kaito_tpu_torch.manifests.core import (  # noqa: F401
    generate_service,
    generate_headless_service,
    generate_statefulset,
)
