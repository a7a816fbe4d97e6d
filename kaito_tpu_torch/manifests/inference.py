"""Inference workload generation: ParallelPlan -> StatefulSet + Services.

The TPU-native re-design of ``pkg/workspace/inference/
preset_inferences.go:158`` (GeneratePresetInference) and the command
construction ``pkg/model/interface.go:340-560``: instead of rendering vLLM
flags + a Ray bootstrap script, we render the engine server command
with the planner's mesh baked into env/flags, and rely on GKE's
TPU_WORKER_ID / TPU_WORKER_HOSTNAMES injection plus the headless
service for the JAX coordinator.

A copy of ``kaito_tpu.manifests.inference`` that renders from the plan's
catalog entry: the engine package its pods run (``python -m
<package>.engine.server``, so a GPU plan runs ``kaito_tpu_torch``), the
image, the device resource and how many a pod requests (a TPU host's
every chip; the plan's cards on a GPU node), the taint it tolerates,
the runtime probes the package ships and the mesh env (the JAX mesh,
coordinator and topology on a TPU; the parallel degrees the port's
server reads on a GPU).  A TPU plan renders what the JAX operator
renders.
"""

from __future__ import annotations

import json
import shlex
from typing import Optional

from kaito_tpu_torch.api.workspace import LABEL_WORKSPACE_NAME, Workspace
from kaito_tpu_torch.manifests.core import (
    generate_headless_service,
    generate_service,
    generate_statefulset,
)
from kaito_tpu_torch.models.metadata import ModelMetadata
from kaito_tpu_torch.parallel.plan import ParallelPlan

PORT = 5000

ANNOTATION_ADAPTERS = "kaito-tpu.io/adapters"

# dynamic-adapter source schemes _resolve_adapter_source accepts; a
# plan-time check here beats a 400 at the first hot-load request
_ADAPTER_SOURCE_SCHEMES = ("hub://", "oras://")


def parse_adapters_annotation(text: str) -> Optional[dict]:
    """Parse the ``kaito-tpu.io/adapters`` Workspace annotation into
    the dynamic multi-LoRA cache config (docs/multi-lora.md).  Empty
    input returns None — the whole adapter plane stays off.  Raises
    ValueError on a malformed document; the workspace controller calls
    this at plan time so a bad annotation becomes a PlanFailed
    condition instead of a crash-looping pod (the qos precedent).
    jax-free on purpose: the controller imports it.

    .. code-block:: json

        {"slots": 4, "rmax": 16, "host_bytes": 268435456,
         "allow_base_mismatch": false,
         "allowlist": ["oras://ghcr.io/acme/"]}
    """
    text = (text or "").strip()
    if not text:
        return None
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"adapters config is not valid JSON: {e}") \
            from None
    if not isinstance(doc, dict):
        raise ValueError("adapters config must be a JSON object")
    unknown = set(doc) - {"slots", "rmax", "host_bytes",
                          "allow_base_mismatch", "allowlist"}
    if unknown:
        raise ValueError(f"adapters config has unknown field(s): "
                         f"{sorted(unknown)}")
    try:
        slots = int(doc.get("slots", 0))
        rmax = int(doc.get("rmax", 16))
        host_bytes = int(doc.get("host_bytes", 256 << 20))
    except (TypeError, ValueError) as e:
        raise ValueError(f"adapters config: {e}") from None
    if slots < 1:
        raise ValueError("adapters config needs 'slots' >= 1 (the HBM "
                         "slot-table capacity)")
    if rmax < 1:
        raise ValueError("adapters config: rmax must be >= 1")
    if host_bytes < 0:
        raise ValueError("adapters config: host_bytes must be >= 0")
    allow_mismatch = doc.get("allow_base_mismatch", False)
    if not isinstance(allow_mismatch, bool):
        raise ValueError("adapters config: allow_base_mismatch must be "
                         "a boolean")
    allowlist = doc.get("allowlist", [])
    if not isinstance(allowlist, list):
        raise ValueError("adapters config: allowlist must be a list of "
                         "source-prefix strings")
    for pref in allowlist:
        if not isinstance(pref, str) or not pref.startswith(
                _ADAPTER_SOURCE_SCHEMES):
            raise ValueError(
                f"adapters config: allowlist entry {pref!r} must start "
                f"with one of {list(_ADAPTER_SOURCE_SCHEMES)}")
        if "," in pref:
            raise ValueError(
                f"adapters config: allowlist entry {pref!r} must not "
                f"contain ',' (the flag joins entries with commas)")
    return {"slots": slots, "rmax": rmax, "host_bytes": host_bytes,
            "allow_base_mismatch": allow_mismatch,
            "allowlist": [str(p) for p in allowlist]}


def parse_structured_output_annotation(text: str) -> Optional[dict]:
    """Parse the ``kaito-tpu.io/structured-output`` Workspace
    annotation (docs/structured-output.md).  Empty input returns None —
    the server keeps its defaults (structured output ON).  Accepts a
    bare boolean string (``"false"`` turns the surface off fleet-wide)
    or a JSON object sizing the grammar compile cache:

    .. code-block:: json

        {"enabled": true, "cache_entries": 128, "max_states": 1024}

    Raises ValueError on a malformed document; the workspace controller
    calls this at plan time so a bad annotation becomes a PlanFailed
    condition instead of a crash-looping pod (the adapters-annotation
    precedent).  jax-free on purpose: the controller imports it."""
    text = (text or "").strip()
    if not text:
        return None
    lowered = text.lower()
    if lowered in ("true", "1", "on", "enabled"):
        return {"enabled": True, "cache_entries": None, "max_states": None}
    if lowered in ("false", "0", "off", "disabled"):
        return {"enabled": False, "cache_entries": None, "max_states": None}
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"structured-output config is not valid JSON: {e}") from None
    if not isinstance(doc, dict):
        raise ValueError("structured-output config must be a boolean "
                         "string or a JSON object")
    unknown = set(doc) - {"enabled", "cache_entries", "max_states"}
    if unknown:
        raise ValueError(f"structured-output config has unknown "
                         f"field(s): {sorted(unknown)}")
    enabled = doc.get("enabled", True)
    if not isinstance(enabled, bool):
        raise ValueError("structured-output config: enabled must be a "
                         "boolean")
    out = {"enabled": enabled, "cache_entries": None, "max_states": None}
    for field, lo in (("cache_entries", 1), ("max_states", 2)):
        if field not in doc:
            continue
        v = doc[field]
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(
                f"structured-output config: {field} must be an integer")
        if v < lo:
            raise ValueError(
                f"structured-output config: {field} must be >= {lo}")
        out[field] = v
    return out


def parse_prefill_pack_annotation(text: str) -> Optional[int]:
    """Parse the ``kaito-tpu.io/prefill-pack`` Workspace annotation
    (docs/prefill.md).  Empty input returns None — the server keeps its
    default (auto packing up to max-num-seqs).  Accepts a non-negative
    integer: 0 = auto, 1 = serial legacy scheduler, N > 1 caps the pack
    size.  Raises ValueError on anything else; the workspace controller
    calls this at plan time so a bad annotation becomes a PlanFailed
    condition instead of a crash-looping pod.  jax-free on purpose:
    the controller imports it."""
    text = (text or "").strip()
    if not text:
        return None
    try:
        pack = int(text)
    except ValueError:
        raise ValueError(
            f"prefill-pack annotation must be a non-negative integer, "
            f"got {text!r}") from None
    if pack < 0:
        raise ValueError("prefill-pack annotation must be >= 0 "
                         "(0 = auto, 1 = serial scheduler)")
    return pack


def parse_devprof_annotation(text: str) -> Optional[float]:
    """Parse the ``kaito-tpu.io/devprof`` Workspace annotation
    (docs/observability.md): the device-profiler sampling interval in
    seconds.  Empty input returns None — the server keeps its default
    (off), so an absent annotation leaves the pod command and metrics
    exposition byte-identical.  Accepts a positive number (seconds
    between sampled profile windows); ``0``/``off``/``false`` return
    None too, an explicit way to say "keep it off".  Raises ValueError
    otherwise; the workspace controller calls this at plan time so a
    bad annotation becomes a PlanFailed condition instead of a
    crash-looping pod.  jax-free on purpose: the controller imports
    it."""
    text = (text or "").strip()
    if not text:
        return None
    if text.lower() in ("off", "false", "0", "0.0"):
        return None
    try:
        interval = float(text)
    except ValueError:
        raise ValueError(
            f"devprof annotation must be a sampling interval in "
            f"seconds (or 'off'), got {text!r}") from None
    if interval != interval or interval <= 0.0:  # NaN or non-positive
        raise ValueError(
            "devprof annotation must be a positive number of seconds")
    if interval < 1.0:
        raise ValueError(
            "devprof annotation must be >= 1.0 seconds — each sample "
            "captures a full profiler window, so sub-second cadence "
            "would perturb the workload it measures")
    return interval


def parse_kv_pool_disk_annotation(disk_text: str,
                                  kv_pool_text: str = "") -> Optional[int]:
    """Parse the ``kaito-tpu.io/kv-pool-disk`` Workspace annotation
    (docs/kv-pool.md "Tier 3: SSD"): the byte budget for the pool's
    disk spill tier.  Empty input returns None — the server keeps its
    default (no disk tier), so an absent annotation leaves the pod
    command, spill behavior, and metrics exposition byte-identical.
    Accepts a Kubernetes resource quantity (``20Gi``, ``500M``) or
    plain bytes; ``0``/``off``/``false`` return None too, an explicit
    way to keep the tier off.  The tier holds spill from the cluster
    pool's host store, so naming a budget without
    ``kaito-tpu.io/kv-pool`` enabled is an error.  Raises ValueError
    on anything else; the workspace controller calls this at plan time
    so a bad annotation becomes a PlanFailed condition instead of a
    crash-looping pod.  jax-free on purpose: the controller imports
    it."""
    text = (disk_text or "").strip()
    if not text or text.lower() in ("off", "false", "0"):
        return None
    from kaito_tpu_torch.utils.quantity import parse_quantity
    try:
        nbytes = parse_quantity(text)
    except ValueError:
        raise ValueError(
            f"kv-pool-disk annotation must be a byte quantity "
            f"(e.g. '20Gi') or 'off', got {text!r}") from None
    if nbytes <= 0:
        return None
    if (kv_pool_text or "").strip().lower() not in ("true", "1", "on",
                                                    "enabled"):
        raise ValueError(
            "kv-pool-disk requires kaito-tpu.io/kv-pool enabled — the "
            "SSD tier spills the cluster pool's host store and is "
            "inert without it")
    return nbytes


def parse_comm_overlap_annotation(text: str) -> Optional[bool]:
    """Parse the ``kaito-tpu.io/comm-overlap`` Workspace annotation
    (docs/multichip.md): the collective-compute overlap gate for TP
    decode.  Empty input returns None — the server keeps its default
    (off), so an absent annotation leaves the pod command, dispatch and
    metrics exposition byte-identical.  Accepts the usual boolean
    spellings (true/1/on/enabled, false/0/off/disabled).  Raises
    ValueError otherwise; the workspace controller calls this at plan
    time so a bad annotation becomes a PlanFailed condition instead of
    a crash-looping pod.  jax-free on purpose: the controller imports
    it."""
    text = (text or "").strip().lower()
    if not text:
        return None
    if text in ("true", "1", "on", "enabled"):
        return True
    if text in ("false", "0", "off", "disabled"):
        return False
    raise ValueError(
        f"comm-overlap annotation must be a boolean "
        f"(true/1/on/enabled or false/0/off/disabled), got {text!r}")


def parse_itl_annotation(text: str) -> Optional[bool]:
    """Parse the ``kaito-tpu.io/itl`` Workspace annotation
    (docs/observability.md): the true per-token inter-token-latency
    gate.  Empty input returns None — the server keeps its default
    (off), so an absent annotation leaves the pod command and metrics
    exposition byte-identical.  Accepts the usual boolean spellings.
    Raises ValueError otherwise; the workspace controller calls this at
    plan time so a bad annotation becomes a PlanFailed condition
    instead of a crash-looping pod.  jax-free on purpose: the
    controller imports it."""
    text = (text or "").strip().lower()
    if not text:
        return None
    if text in ("true", "1", "on", "enabled"):
        return True
    if text in ("false", "0", "off", "disabled"):
        return False
    raise ValueError(
        f"itl annotation must be a boolean "
        f"(true/1/on/enabled or false/0/off/disabled), got {text!r}")


def parse_flight_annotation(dir_text: str,
                            max_text: str = "") -> Optional[dict]:
    """Parse the ``kaito-tpu.io/flight-dir`` (+ optional
    ``kaito-tpu.io/flight-max-bundles``) Workspace annotations
    (docs/observability.md): the incident flight recorder.  An empty
    dir returns None — the server keeps its default (off), so an
    absent annotation leaves the pod command byte-identical and
    ``/debug/flight`` answers 403.  The dir must be an absolute path
    (it names a pod-local volume mount); max-bundles must be a
    positive integer.  Raises ValueError otherwise; the workspace
    controller calls this at plan time so a bad annotation becomes a
    PlanFailed condition instead of a crash-looping pod.  jax-free on
    purpose: the controller imports it."""
    dir_text = (dir_text or "").strip()
    if not dir_text or dir_text.lower() in ("off", "false", "0"):
        return None
    if not dir_text.startswith("/"):
        raise ValueError(
            f"flight-dir annotation must be an absolute path "
            f"(a pod-local volume mount), got {dir_text!r}")
    out = {"dir": dir_text, "max_bundles": None}
    max_text = (max_text or "").strip()
    if max_text:
        try:
            n = int(max_text)
        except ValueError:
            raise ValueError(
                f"flight-max-bundles annotation must be a positive "
                f"integer, got {max_text!r}") from None
        if n <= 0:
            raise ValueError(
                "flight-max-bundles annotation must be >= 1")
        out["max_bundles"] = n
    return out


def coordinator_address(workspace_name: str, namespace: str) -> str:
    """Pod-0 DNS via the headless service — same convention the
    reference uses for the Ray leader (``pkg/utils/common.go:229``),
    reused as the JAX distributed coordinator."""
    return (f"{workspace_name}-0.{workspace_name}-headless."
            f"{namespace}.svc.cluster.local:8476")


def build_engine_command(
    ws: Workspace,
    md: ModelMetadata,
    plan: ParallelPlan,
    *,
    config_file: str = "",
    adapters_dir: str = "",
) -> list[str]:
    """The pod command (analogue of buildVLLMInferenceCommand
    ``pkg/model/interface.go:374`` + configureParallelism ``:500``).

    Long-tail presets (``runtime: transformers``) render the HF
    fallback runtime instead — the reference's vLLM-vs-text-generation
    runtime split (RuntimeName, interface.go)."""
    mesh = plan.mesh
    pkg = plan.chip.engine_package
    if getattr(md, "runtime", "engine") == "transformers":
        return [
            "python", "-m", f"{pkg}.runtime.hf_fallback",
            "--model", md.hf_id,
            "--port", str(PORT),
            "--max-model-len", str(plan.max_model_len),
            "--served-model-name", md.name or md.hf_id,
        ]
    args = [
        "python", "-m", f"{pkg}.engine.server",
        "--model", md.name if md.name else md.hf_id,
        "--port", str(PORT),
        "--max-model-len", str(plan.max_model_len),
    ]
    kv_dtype = ws.metadata.annotations.get(
        "kaito-tpu.io/kv-cache-dtype", "")
    if kv_dtype:
        args += ["--kv-cache-dtype", kv_dtype]
    # weight-only quantization (docs/quantization.md): the controller
    # validated the scheme at plan time (PlanFailed on unknown values),
    # and the planner already sized node counts with the smaller
    # weight bytes — the flag must render or the pods would serve
    # bf16 on capacity planned for int8/int4
    quant = ws.metadata.annotations.get("kaito-tpu.io/quantization", "")
    if quant:
        args += ["--quantization", quant]
    qos = ws.metadata.annotations.get("kaito-tpu.io/qos", "")
    if qos:
        args += ["--qos-config", qos]
    # packed prefill (docs/prefill.md): auto is the server default, so
    # only an explicit annotation renders — absent keeps the pod
    # command byte-identical
    pack = parse_prefill_pack_annotation(
        ws.metadata.annotations.get("kaito-tpu.io/prefill-pack", ""))
    if pack is not None:
        args += ["--prefill-pack", str(pack)]
    # cluster KV pool (docs/kv-pool.md): opt-in per workspace; the
    # controller mirrors the same annotation onto the EPP deployment so
    # holder adverts and fetch hints switch on together
    kv_pool = ws.metadata.annotations.get("kaito-tpu.io/kv-pool", "")
    if kv_pool.lower() in ("true", "1", "on", "enabled"):
        args += ["--kv-pool"]
        pool_bytes = ws.metadata.annotations.get(
            "kaito-tpu.io/kv-pool-bytes", "")
        if pool_bytes:
            args += ["--kv-pool-bytes", pool_bytes]
        # tier-3 SSD spill (docs/kv-pool.md "Tier 3: SSD"): renders
        # only inside the kv-pool branch — the validated parse below
        # already rejects a disk budget without the pool
        disk = parse_kv_pool_disk_annotation(
            ws.metadata.annotations.get("kaito-tpu.io/kv-pool-disk", ""),
            kv_pool)
        if disk is not None:
            args += ["--kv-pool-disk-bytes", str(disk)]
    spec_draft = ws.metadata.annotations.get(
        "kaito-tpu.io/speculative-draft", "")
    if spec_draft:
        # "auto" resolves to the preset's curated pairing here (the
        # controller already validated it) so the pod command names a
        # concrete catalog preset
        from kaito_tpu_torch.models.registry import resolve_speculative_draft
        resolved = resolve_speculative_draft(md, spec_draft)
        if resolved:
            args += ["--speculative-draft", resolved]
    # dynamic multi-LoRA cache (docs/multi-lora.md): the controller
    # validated the document at plan time; rendering turns it into the
    # server's slot-table flags.  The EPP deployment mirrors the same
    # annotation as --adapter-affinity so residency adverts are scraped
    # exactly when the replicas serve them.
    lora = parse_adapters_annotation(
        ws.metadata.annotations.get(ANNOTATION_ADAPTERS, ""))
    if lora:
        args += ["--adapter-slots", str(lora["slots"]),
                 "--adapter-rmax", str(lora["rmax"]),
                 "--adapter-host-bytes", str(lora["host_bytes"])]
        if lora["allow_base_mismatch"]:
            args += ["--adapter-allow-base-mismatch"]
        if lora["allowlist"]:
            args += ["--adapter-source-allowlist",
                     ",".join(lora["allowlist"])]
    # structured output (docs/structured-output.md): the controller
    # validated the document at plan time (PlanFailed on malformed);
    # rendering turns it into the grammar-cache flags.  Enabled is the
    # server default, so only the off switch and explicit sizes render
    # — an absent annotation keeps the pod command byte-identical.
    so = parse_structured_output_annotation(
        ws.metadata.annotations.get("kaito-tpu.io/structured-output", ""))
    if so is not None:
        if not so["enabled"]:
            args += ["--no-structured-output"]
        if so["cache_entries"] is not None:
            args += ["--grammar-cache-entries", str(so["cache_entries"])]
        if so["max_states"] is not None:
            args += ["--grammar-max-states", str(so["max_states"])]
    # sampled device-time attribution (docs/observability.md): off is
    # the server default (sampling costs device time), so only an
    # explicit annotation renders — absent keeps the pod command and
    # the /metrics exposition byte-identical
    devprof = parse_devprof_annotation(
        ws.metadata.annotations.get("kaito-tpu.io/devprof", ""))
    if devprof is not None:
        args += ["--devprof-interval-s", str(devprof)]
    # collective-compute overlap (docs/multichip.md): off is the server
    # default, so only an explicit opt-in renders — absent (or an
    # explicit off) keeps the pod command byte-identical.  The server
    # ignores the flag off a TP>=2 mesh, so rendering it on a plan
    # without a tensor axis is harmless, not a failure.
    overlap = parse_comm_overlap_annotation(
        ws.metadata.annotations.get("kaito-tpu.io/comm-overlap", ""))
    if overlap:
        args += ["--comm-overlap"]
    # true per-token ITL (docs/observability.md): off is the server
    # default, so only an explicit opt-in renders — absent (or an
    # explicit off) keeps the pod command and exposition byte-identical
    itl = parse_itl_annotation(
        ws.metadata.annotations.get("kaito-tpu.io/itl", ""))
    if itl:
        args += ["--itl"]
    # incident flight recorder (docs/observability.md): only an
    # explicit dir renders — absent keeps the pod command
    # byte-identical and /debug/flight answers 403
    flight = parse_flight_annotation(
        ws.metadata.annotations.get("kaito-tpu.io/flight-dir", ""),
        ws.metadata.annotations.get("kaito-tpu.io/flight-max-bundles", ""))
    if flight is not None:
        args += ["--flight-dir", flight["dir"]]
        if flight["max_bundles"] is not None:
            args += ["--flight-max-bundles", str(flight["max_bundles"])]
    if config_file:
        args += ["--kaito-config-file", config_file]
    if adapters_dir:
        args += ["--kaito-adapters-dir", adapters_dir]
    return args


def engine_env(ws: Workspace, md: ModelMetadata, plan: ParallelPlan) -> list[dict]:
    """Mesh + rendezvous env for the engine pod (replaces the Ray
    leader/worker shell logic of buildMultiNodeRayCommand).  A
    single-host slice (one GPU node) needs no coordinator or topology:
    only the degrees the server reads."""
    mesh = plan.mesh
    env = [
        {"name": "KAITO_TENSOR_PARALLEL", "value": str(mesh.size("tensor"))},
        {"name": "KAITO_DATA_PARALLEL", "value": str(mesh.size("data"))},
        {"name": "KAITO_PIPELINE_PARALLEL", "value": str(mesh.size("pipeline"))},
        {"name": "KAITO_SEQUENCE_PARALLEL", "value": str(mesh.size("sequence"))},
    ]
    if not plan.chip.single_host:
        env.insert(0, {"name": "KAITO_MESH_SPEC", "value": str(mesh)})
        env += [
            {"name": "KAITO_COORDINATOR",
             "value": coordinator_address(ws.metadata.name, ws.metadata.namespace)},
            {"name": "KAITO_TPU_TOPOLOGY", "value": plan.topology},
        ]
    role = ws.metadata.annotations.get("kaito-tpu.io/inference-role", "")
    if role:
        # P/D roles enable the KV side-channel, restricted to in-cluster
        # peers of this MRI (reference: NIXL env + routing sidecar,
        # preset_inferences.go:909-985).  The role also keys the SLO
        # watchdog's burn attribution (ROADMAP item 1): prefill pools
        # page on TTFT burn, decode pools on ITL burn.
        env.append({"name": "KAITO_INFERENCE_ROLE", "value": role})
        env.append({"name": "KAITO_PD_ENABLED", "value": "true"})
        env.append({"name": "KAITO_PD_ALLOWLIST",
                    "value": f"http://{ws.metadata.labels.get('kaito-tpu.io/multirole-inference', ws.metadata.name)}-"})
    if md.download_auth_required:
        env.append({"name": "HF_TOKEN", "valueFrom": {"secretKeyRef": {
            "name": f"{ws.metadata.name}-hf-token", "key": "token",
            "optional": True}}})
    return env


def _probes(num_hosts: int, benchmark: bool, pkg: str) -> dict:
    """Probe set (reference: preset_inferences.go:316-441): startup probe
    doubles as the self-benchmark on the leader; distributed pods use
    the coordinator-health exec probe instead of HTTP.  ``pkg`` is the
    engine package whose runtime modules the exec probes run."""
    probes: dict = {
        "readinessProbe": {
            "httpGet": {"path": "/health", "port": PORT},
            "periodSeconds": 10,
        },
        "livenessProbe": {
            "httpGet": {"path": "/health", "port": PORT},
            "periodSeconds": 30, "failureThreshold": 6,
        },
    }
    if benchmark:
        probes["startupProbe"] = {
            "exec": {"command": [
                "python", "-m", f"{pkg}.runtime.benchmark_probe"]},
            "failureThreshold": 60, "periodSeconds": 30,
            "timeoutSeconds": 600,
        }
    else:
        probes["startupProbe"] = {
            "httpGet": {"path": "/health", "port": PORT},
            "failureThreshold": 120, "periodSeconds": 10,
        }
    if num_hosts > 1:
        # workers have no HTTP server; health == coordinator liveness
        probes["livenessProbe"] = {
            "exec": {"command": [
                "python", "-m", f"{pkg}.runtime.health",
                "--role", "auto"]},
            "periodSeconds": 30, "failureThreshold": 6,
        }
    return probes


def generate_inference_workload(
    ws: Workspace,
    md: ModelMetadata,
    plan: ParallelPlan,
    node_selector: dict,
    *,
    image: str = "",
    benchmark: bool = True,
) -> list:
    """Render Service + headless Service + StatefulSet for a workspace
    (``image`` "" takes the plan's entry's).  The self-benchmark startup
    probe renders only for an engine package that ships it."""
    chip = plan.chip
    image = image or chip.image
    benchmark = benchmark and "benchmark_probe" in chip.runtime_modules
    name = ws.metadata.name
    ns = ws.metadata.namespace
    labels = {LABEL_WORKSPACE_NAME: name}
    num_hosts = plan.num_hosts

    cmd = build_engine_command(
        ws, md, plan,
        config_file=(f"/mnt/config/inference_config.yaml"
                     if ws.inference and ws.inference.config else ""),
        adapters_dir="/mnt/adapters" if ws.inference and ws.inference.adapters else "")

    volumes: list[dict] = [{"name": "shm", "emptyDir": {"medium": "Memory"}}]
    mounts = [{"name": "shm", "mountPath": "/dev/shm"}]
    if ws.inference and ws.inference.config:
        volumes.append({"name": "config", "configMap": {"name": ws.inference.config}})
        mounts.append({"name": "config", "mountPath": "/mnt/config"})

    init_containers = []
    if ws.inference:
        for a in ws.inference.adapters:
            # adapter puller (reference: pkg/workspace/image/puller.go via ORAS)
            volumes.append({"name": f"adapter-{a.name}", "emptyDir": {}})
            mounts.append({"name": f"adapter-{a.name}",
                           "mountPath": f"/mnt/adapters/{a.name}"})
            init_containers.append({
                "name": f"pull-adapter-{a.name}",
                "image": a.source_image,
                "command": ["sh", "-c",
                            f"cp -r /data/* /mnt/adapters/{a.name}/ 2>/dev/null || "
                            f"oras pull {shlex.quote(a.source_image)} "
                            f"-o /mnt/adapters/{a.name}"],
                "volumeMounts": [{"name": f"adapter-{a.name}",
                                  "mountPath": f"/mnt/adapters/{a.name}"}],
            })

    fallback = getattr(md, "runtime", "engine") == "transformers"
    if fallback:
        # CPU torch runtime: no TPU chips to pin, and the engine
        # self-benchmark probe would 400 on small-context long-tail
        # models (input_len 2048 > n_positions) — plain HTTP probes
        resources = {"requests": {"cpu": "4", "memory": "16Gi"}}
        benchmark = False
    else:
        n = str(chip.devices_per_pod(plan.chips_per_slice))
        resources = {"requests": {chip.resource: n}, "limits": {chip.resource: n}}
    container = {
        "name": "engine",
        "image": image,
        "command": cmd,
        "env": engine_env(ws, md, plan),
        "ports": [{"containerPort": PORT}],
        "resources": resources,
        "volumeMounts": mounts,
        **_probes(num_hosts, benchmark, chip.engine_package),
    }

    svc = generate_service(name, ns, labels, labels=labels)
    headless = generate_headless_service(name, ns, labels, labels=labels)
    ss = generate_statefulset(
        name, ns, replicas=num_hosts, labels=labels,
        node_selector=node_selector, containers=[container],
        init_containers=init_containers or None, volumes=volumes,
        tolerations=[{"key": chip.resource, "operator": "Exists",
                      "effect": "NoSchedule"}])
    return [svc, headless, ss]
