"""The accelerator catalog: TPU generations and machine types (a copy
of ``kaito_tpu.sku``) and the GPU half (GKE's A3 machine types)."""

from kaito_tpu_torch.sku.catalog import (  # noqa: F401
    TPUChipSpec,
    TPUSliceSpec,
    TPUSKUHandler,
    GKETPUSKUHandler,
    GPUCardSpec,
    GPU_CATALOG,
    GPU_MACHINE_TYPES,
    get_sku_handler,
    parse_topology,
    topology_chips,
    get_tpu_config_from_node_labels,
    get_gpu_config_from_node_labels,
    get_slice_config_from_node_labels,
    machine_chip,
    CHIP_CATALOG,
)
