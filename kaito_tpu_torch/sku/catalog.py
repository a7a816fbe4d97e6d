"""TPU chip & slice catalog — the TPU-native replacement for the
reference's GPU SKU layer (``pkg/sku/cloud_sku_handler.go:25``,
``pkg/sku/azure_sku_handler.go:21``).

Where the reference maps *cloud VM instance types* to
``{GPUCount, GPUMemGB, GPUModel}``, we map *TPU machine types and slice
topologies* to chip generation specs: HBM per chip, bf16 peak FLOPs,
HBM bandwidth, ICI link characteristics, chips per host (VM), and the
set of valid slice topologies.  The estimator and the sharding planner
consume these to size slices and lay out device meshes.

Public (documented) hardware characteristics only; see Google's TPU
system architecture docs for the v4/v5e/v5p/v6e numbers.

A copy of ``kaito_tpu.sku.catalog`` with a GPU half: GKE's A3 machine
types (NVIDIA H100 80GB, ``nvidia.com/gpu``) in :data:`GPU_CATALOG` and
:data:`GPU_MACHINE_TYPES`, and the BYO lookup from the labels NVIDIA's
GPU feature discovery puts on a node
(:func:`get_gpu_config_from_node_labels`).  Every catalog entry carries
its device plugin's resource name, its node-label keys, its taint and
the engine its pods run, so provisioning, rendering and the controller
read them from the entry.  The TPU entries render what the JAX
operator renders.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping, Optional, Sequence

from kaito_tpu_torch.engine.devprof import CARD_PEAKS

GiB = 2**30
MiB = 2**20

# GKE node labels for TPU slices (the analogue of the reference reading
# nvidia.com/* node labels in pkg/sku/helpers.go:75).
LABEL_TPU_ACCELERATOR = "cloud.google.com/gke-tpu-accelerator"
LABEL_TPU_TOPOLOGY = "cloud.google.com/gke-tpu-topology"
LABEL_TPU_MACHINE = "node.kubernetes.io/instance-type"
RESOURCE_TPU = "google.com/tpu"
# the JAX engine's image (kaito_tpu.manifests.inference.DEFAULT_IMAGE)
TPU_IMAGE = "ghcr.io/kaito-tpu/engine:latest"

# GKE's accelerator label on GPU nodes, and the labels NVIDIA's GPU
# feature discovery sets (the reference reads these in
# GetGPUConfigFromNodeLabels, pkg/sku/helpers.go:75)
LABEL_GKE_ACCELERATOR = "cloud.google.com/gke-accelerator"
LABEL_GPU_PRODUCT = "nvidia.com/gpu.product"
LABEL_GPU_COUNT = "nvidia.com/gpu.count"
LABEL_GPU_MEMORY = "nvidia.com/gpu.memory"     # MiB
RESOURCE_GPU = "nvidia.com/gpu"
# the port's engine image: kaito_tpu_torch with its CUDA kernels
GPU_IMAGE = "ghcr.io/kaito-tpu/engine-cuda:latest"


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse a topology string like ``2x4`` or ``4x4x8`` into dims."""
    try:
        dims = tuple(int(p) for p in topology.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"invalid TPU topology {topology!r}") from e
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"invalid TPU topology {topology!r}")
    return dims


def topology_chips(topology: str) -> int:
    """Total chip count of a topology string."""
    n = 1
    for d in parse_topology(topology):
        n *= d
    return n


@dataclass(frozen=True)
class TPUChipSpec:
    """Per-chip hardware characteristics of one TPU generation."""

    generation: str              # "v4" | "v5e" | "v5p" | "v6e"
    hbm_bytes: int               # HBM capacity per chip
    bf16_tflops: float           # peak dense bf16 TFLOP/s per chip
    int8_tops: float             # peak int8 TOP/s per chip
    hbm_gbps: float              # HBM bandwidth GB/s per chip
    ici_axes: int                # torus dimensionality (2D / 3D)
    ici_gbps_per_link: float     # one-direction ICI bandwidth per link, GB/s
    chips_per_host: int          # chips attached to one VM/host at full density
    accelerator_label: str       # value of cloud.google.com/gke-tpu-accelerator
    valid_topologies: Sequence[str]  # slice topologies GKE accepts
    max_chips: int               # largest slice (pod) size
    # what provisioning and rendering read from the entry
    # the device plugin's resource; its nodes carry a taint of that key
    resource: str = RESOURCE_TPU
    accelerator_key: str = LABEL_TPU_ACCELERATOR
    topology_key: str = LABEL_TPU_TOPOLOGY   # "" when nodes carry none
    engine_package: str = "kaito_tpu"        # python -m <package>.engine.server
    image: str = TPU_IMAGE
    # torch's device for the HF fallback runtime ("": none, the pod asks
    # for CPU and memory; else one ``resource`` and ``--device`` this)
    torch_device: str = ""
    # False: a slice spans hosts, a pod takes every chip of its host
    # (GKE's TPU rule) and the JAX mesh env.  True: a slice is the
    # plan's devices of one host, which a pod requests (GPU plans are one
    # node: ROADMAP queue 1, M19 for more)
    single_host: bool = False
    family: str = "TPU"                      # in operator-facing messages

    def topology_for_chips(self, chips: int) -> Optional[str]:
        """Smallest valid topology with at least ``chips`` chips."""
        best = None
        best_n = None
        for t in self.valid_topologies:
            n = topology_chips(t)
            if n >= chips and (best_n is None or n < best_n):
                best, best_n = t, n
        return best

    def hosts_for_topology(self, topology: str) -> int:
        chips = topology_chips(topology)
        return max(1, -(-chips // self.chips_per_host))

    def devices_per_pod(self, chips: int) -> int:
        """The ``resource`` count one pod of a ``chips``-device slice
        requests."""
        return min(chips, self.chips_per_host) if self.single_host else self.chips_per_host

    def on_machine(self, per_vm: int) -> "TPUChipSpec":
        """This entry as one machine type of ``per_vm`` devices offers it:
        a single-host entry's slices stop at ``per_vm``; others are
        unchanged."""
        if not self.single_host:
            return self
        topos = tuple(t for t in self.valid_topologies if topology_chips(t) <= per_vm)
        return replace(self, chips_per_host=per_vm, valid_topologies=topos,
                       max_chips=per_vm)


# Catalog of chip generations.  Topology lists follow GKE's accepted
# `gke-tpu-topology` values for each machine family.
CHIP_CATALOG: Mapping[str, TPUChipSpec] = {
    "v4": TPUChipSpec(
        generation="v4",
        hbm_bytes=32 * GiB,
        bf16_tflops=275.0,
        int8_tops=275.0,
        hbm_gbps=1228.0,
        ici_axes=3,
        ici_gbps_per_link=100.0,
        chips_per_host=4,
        accelerator_label="tpu-v4-podslice",
        valid_topologies=(
            "2x2x1", "2x2x2", "2x2x4", "2x4x4", "4x4x4", "4x4x8",
            "4x8x8", "8x8x8", "8x8x16", "8x16x16", "16x16x16",
        ),
        max_chips=4096,
    ),
    "v5e": TPUChipSpec(
        generation="v5e",
        hbm_bytes=16 * GiB,
        bf16_tflops=197.0,
        int8_tops=394.0,
        hbm_gbps=819.0,
        ici_axes=2,
        ici_gbps_per_link=50.0,
        chips_per_host=8,
        accelerator_label="tpu-v5-lite-podslice",
        valid_topologies=(
            "1x1", "2x2", "2x4", "4x4", "4x8", "8x8", "8x16", "16x16",
        ),
        max_chips=256,
    ),
    "v5p": TPUChipSpec(
        generation="v5p",
        hbm_bytes=95 * GiB,
        bf16_tflops=459.0,
        int8_tops=918.0,
        hbm_gbps=2765.0,
        ici_axes=3,
        ici_gbps_per_link=200.0,
        chips_per_host=4,
        accelerator_label="tpu-v5p-slice",
        valid_topologies=(
            "2x2x1", "2x2x2", "2x2x4", "2x4x4", "4x4x4", "4x4x8",
            "4x8x8", "8x8x8", "8x8x16", "8x16x16", "16x16x16",
        ),
        max_chips=8960,
    ),
    "v6e": TPUChipSpec(
        generation="v6e",
        hbm_bytes=32 * GiB,
        bf16_tflops=918.0,
        int8_tops=1836.0,
        hbm_gbps=1640.0,
        ici_axes=2,
        ici_gbps_per_link=100.0,
        chips_per_host=8,
        accelerator_label="tpu-v6e-slice",
        valid_topologies=(
            "1x1", "2x2", "2x4", "4x4", "4x8", "8x8", "8x16", "16x16",
        ),
        max_chips=256,
    ),
}

# GKE TPU machine types → (generation, chips per VM).  The analogue of
# the per-cloud instance-type tables in pkg/sku/{azure,aws}_sku_handler.go.
MACHINE_TYPES: Mapping[str, tuple[str, int]] = {
    # v4
    "ct4p-hightpu-4t": ("v4", 4),
    # v5e
    "ct5lp-hightpu-1t": ("v5e", 1),
    "ct5lp-hightpu-4t": ("v5e", 4),
    "ct5lp-hightpu-8t": ("v5e", 8),
    "ct5l-hightpu-1t": ("v5e", 1),
    "ct5l-hightpu-4t": ("v5e", 4),
    "ct5l-hightpu-8t": ("v5e", 8),
    # v5p
    "ct5p-hightpu-4t": ("v5p", 4),
    # v6e
    "ct6e-standard-1t": ("v6e", 1),
    "ct6e-standard-4t": ("v6e", 4),
    "ct6e-standard-8t": ("v6e", 8),
}

_ACCELERATOR_TO_GEN = {spec.accelerator_label: gen for gen, spec in CHIP_CATALOG.items()}


@dataclass(frozen=True)
class GPUCardSpec(TPUChipSpec):
    """One NVIDIA card model.  A GPU slice is 1, 2, 4 or 8 cards of one
    node (its "topology" is the count), served by the port's engine at
    tensor parallelism over all of them."""

    product: str = ""            # nvidia.com/gpu.product (GPU feature discovery)
    device_name: str = ""        # torch.cuda.get_device_name()
    resource: str = RESOURCE_GPU
    accelerator_key: str = LABEL_GKE_ACCELERATOR
    topology_key: str = ""
    engine_package: str = "kaito_tpu_torch"
    image: str = GPU_IMAGE
    torch_device: str = "cuda"
    single_host: bool = True
    family: str = "GPU"


def _h100(generation: str, accelerator_label: str) -> GPUCardSpec:
    """The H100 SXM5 80GB (HBM3): peaks from the engine's one table
    (``engine.devprof.CARD_PEAKS``); memory as CUDA reports the card's
    total (``torch.cuda.mem_get_info``: 85017493504 bytes on an NVIDIA H100
    80GB HBM3, ``chip_smoke.py``'s sizing reports); NVLink 4, 18 links
    of 25 GB/s each way."""
    name = "NVIDIA H100 80GB HBM3"
    bf16, int8, bytes_s = CARD_PEAKS[name]
    return GPUCardSpec(
        generation=generation, hbm_bytes=85017493504,
        bf16_tflops=bf16 / 1e12, int8_tops=int8 / 1e12, hbm_gbps=bytes_s / 1e9,
        ici_axes=0, ici_gbps_per_link=25.0, chips_per_host=8,
        accelerator_label=accelerator_label, valid_topologies=("1", "2", "4", "8"),
        max_chips=8, product=name.replace(" ", "-"), device_name=name)


GPU_CATALOG: Mapping[str, GPUCardSpec] = {
    "h100-80gb": _h100("h100-80gb", "nvidia-h100-80gb"),
    "h100-mega-80gb": _h100("h100-mega-80gb", "nvidia-h100-mega-80gb"),
}

# GKE's A3 machine types -> (card, cards per VM)
GPU_MACHINE_TYPES: Mapping[str, tuple[str, int]] = {
    "a3-highgpu-1g": ("h100-80gb", 1),
    "a3-highgpu-2g": ("h100-80gb", 2),
    "a3-highgpu-4g": ("h100-80gb", 4),
    "a3-highgpu-8g": ("h100-80gb", 8),
    "a3-megagpu-8g": ("h100-mega-80gb", 8),
}


def is_known_machine_type(machine_type: str) -> bool:
    return machine_type in MACHINE_TYPES or machine_type in GPU_MACHINE_TYPES


def machine_chip(machine_type: str) -> Optional[TPUChipSpec]:
    """The catalog entry a machine type provisions (a GPU entry cut to the
    machine's cards), or None for an unknown type."""
    entry = MACHINE_TYPES.get(machine_type)
    if entry is not None:
        return CHIP_CATALOG[entry[0]]
    entry = GPU_MACHINE_TYPES.get(machine_type)
    if entry is not None:
        return GPU_CATALOG[entry[0]].on_machine(entry[1])
    return None


@dataclass(frozen=True)
class TPUSliceSpec:
    """A concrete provisionable slice: generation + topology."""

    chip: TPUChipSpec
    topology: str
    machine_type: str = ""

    @property
    def num_chips(self) -> int:
        return topology_chips(self.topology)

    @property
    def num_hosts(self) -> int:
        return self.chip.hosts_for_topology(self.topology)

    @property
    def total_hbm_bytes(self) -> int:
        return self.num_chips * self.chip.hbm_bytes

    @property
    def dims(self) -> tuple[int, ...]:
        return parse_topology(self.topology)

    def node_selector(self) -> dict[str, str]:
        """GKE node labels selecting this slice shape."""
        sel = {self.chip.accelerator_key: self.chip.accelerator_label}
        if self.chip.topology_key:
            sel[self.chip.topology_key] = self.topology
        if self.machine_type:
            sel[LABEL_TPU_MACHINE] = self.machine_type
        return sel


class TPUSKUHandler:
    """Catalog lookups, interface-compatible with the reference's
    ``CloudSKUHandler`` (``pkg/sku/cloud_sku_handler.go:25-28``) but in
    terms of TPU machine types / generations."""

    def get_supported_generations(self) -> list[str]:
        raise NotImplementedError

    def get_chip_config(self, generation: str) -> Optional[TPUChipSpec]:
        raise NotImplementedError

    def get_chip_config_by_machine_type(self, machine_type: str) -> Optional[tuple[TPUChipSpec, int]]:
        raise NotImplementedError


class GKETPUSKUHandler(TPUSKUHandler):
    def get_supported_generations(self) -> list[str]:
        return sorted(CHIP_CATALOG) + sorted(GPU_CATALOG)

    def get_chip_config(self, generation: str) -> Optional[TPUChipSpec]:
        return CHIP_CATALOG.get(generation) or GPU_CATALOG.get(generation)

    def get_chip_config_by_machine_type(self, machine_type: str) -> Optional[tuple[TPUChipSpec, int]]:
        entry = MACHINE_TYPES.get(machine_type)
        if entry is not None:
            gen, chips_per_vm = entry
            return CHIP_CATALOG[gen], chips_per_vm
        entry = GPU_MACHINE_TYPES.get(machine_type)
        if entry is None:
            return None
        card, per_vm = entry
        return GPU_CATALOG[card].on_machine(per_vm), per_vm

    def default_machine_type(self, generation: str, topology: str) -> str:
        """Pick the GKE machine type serving a topology of this generation."""
        chips = topology_chips(topology)
        candidates = [
            (mt, per_vm)
            for mt, (gen, per_vm) in MACHINE_TYPES.items()
            if gen == generation
        ]
        if not candidates:
            raise ValueError(f"unknown TPU generation {generation!r}")
        # Multi-host slices use the full-density machine type; single-host
        # slices use the machine type that exactly fits the chip count.
        exact = [mt for mt, per_vm in candidates if per_vm == chips]
        if exact:
            return exact[0]
        return max(candidates, key=lambda c: c[1])[0]


_HANDLERS = {"gke": GKETPUSKUHandler}


def get_sku_handler(cloud: str = "gke") -> TPUSKUHandler:
    """Pick the SKU handler for a cloud (reference: ``GetSKUHandler``
    selected by the ``CLOUD_PROVIDER`` env, ``cmd/workspace/main.go:157``)."""
    try:
        return _HANDLERS[cloud.lower()]()
    except KeyError:
        raise ValueError(f"unsupported cloud provider for TPU: {cloud!r}")


def get_tpu_config_from_node_labels(labels: Mapping[str, str]) -> Optional[TPUSliceSpec]:
    """Derive a slice spec from node labels — the BYO-node path
    (reference: ``sku.GetGPUConfigFromNodeLabels``, ``pkg/sku/helpers.go:75``)."""
    acc = labels.get(LABEL_TPU_ACCELERATOR)
    topo = labels.get(LABEL_TPU_TOPOLOGY)
    if not acc or not topo:
        return None
    gen = _ACCELERATOR_TO_GEN.get(acc)
    if gen is None:
        return None
    return TPUSliceSpec(
        chip=CHIP_CATALOG[gen],
        topology=topo,
        machine_type=labels.get(LABEL_TPU_MACHINE, ""),
    )


def get_gpu_config_from_node_labels(labels: Mapping[str, str]) -> Optional[TPUSliceSpec]:
    """Derive a GPU slice spec from the labels NVIDIA's GPU feature
    discovery puts on a node: ``nvidia.com/gpu.product`` names the card
    (its CUDA device name, spaces as ``-``), ``nvidia.com/gpu.count`` the
    cards (the slice), ``nvidia.com/gpu.memory`` one card's MiB, which
    must be within 1% of the entry's.  GKE's accelerator label, when the
    node has one, picks among entries of one product (the reference's
    ``GetGPUConfigFromNodeLabels``, ``pkg/sku/helpers.go:75``)."""
    product = labels.get(LABEL_GPU_PRODUCT)
    if not product:
        return None
    cards = [c for c in GPU_CATALOG.values() if c.product == product]
    acc = labels.get(LABEL_GKE_ACCELERATOR)
    if acc:
        cards = [c for c in cards if c.accelerator_label == acc]
    if not cards:
        return None
    card = cards[0]
    mem = labels.get(LABEL_GPU_MEMORY)
    try:
        count = int(labels.get(LABEL_GPU_COUNT, "1"))
        if mem is not None and abs(int(mem) * MiB - card.hbm_bytes) > 0.01 * card.hbm_bytes:
            return None
    except ValueError:
        return None
    if count < 1:
        return None
    return TPUSliceSpec(chip=card.on_machine(count), topology=str(count),
                        machine_type=labels.get(LABEL_TPU_MACHINE, ""))


def get_slice_config_from_node_labels(labels: Mapping[str, str]) -> Optional[TPUSliceSpec]:
    """The BYO lookup over both halves of the catalog: a TPU node's GKE
    labels, else a GPU node's feature-discovery labels."""
    return get_tpu_config_from_node_labels(labels) or get_gpu_config_from_node_labels(labels)
