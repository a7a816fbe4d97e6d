"""A copy of ``kaito_tpu.api``."""

from kaito_tpu_torch.api.meta import Condition, ObjectMeta, now_iso  # noqa: F401
from kaito_tpu_torch.api.workspace import (  # noqa: F401
    InferenceSpec,
    ResourceSpec,
    TuningSpec,
    Workspace,
    WorkspaceStatus,
)
from kaito_tpu_torch.api.inferenceset import InferenceSet, InferenceSetSpec  # noqa: F401
from kaito_tpu_torch.api.ragengine import RAGEngine, RAGEngineSpec  # noqa: F401
from kaito_tpu_torch.api.multiroleinference import (  # noqa: F401
    MultiRoleInference,
    RoleSpec,
)
from kaito_tpu_torch.api.modelmirror import ModelMirror, ModelMirrorSpec  # noqa: F401
