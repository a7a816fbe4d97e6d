from kaito_tpu_torch.models.metadata import (  # noqa: F401
    AttentionKind,
    ModelArch,
    ModelMetadata,
)
from kaito_tpu_torch.models.registry import (  # noqa: F401
    get_model_by_name,
    is_valid_preset,
    list_presets,
    register_model,
)
from kaito_tpu_torch.models.autogen import metadata_from_hf_config  # noqa: F401
import kaito_tpu_torch.models.presets  # noqa: F401  (registers built-in presets)
