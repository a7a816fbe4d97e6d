"""Tuning Job rendering.

Parity: ``pkg/workspace/tuning/preset_tuning.go:145`` CreatePresetTuning
— data-downloader init container (URL/image/volume sources), the
trainer command (our JAX LoRA trainer instead of accelerate+HF), a
results volume, and an ORAS pusher sidecar when output.image is set.

A copy of ``kaito_tpu.manifests.tuning_job`` that renders from the
plan's catalog entry: ``python -m <package>.tuning.cli`` (the port's
trainer on a GPU plan), its metrics sidecar, the image, and the entry's
device resource, count and taint.
"""

from __future__ import annotations

import shlex

from kaito_tpu_torch.api.meta import ObjectMeta
from kaito_tpu_torch.api.workspace import LABEL_WORKSPACE_NAME, Workspace
from kaito_tpu_torch.controllers.objects import Unstructured
from kaito_tpu_torch.parallel.plan import ParallelPlan

RESULTS_DIR = "/mnt/results"
DATA_DIR = "/mnt/data"
SENTINEL = "fine_tuning_completed.txt"


def build_tuning_command(ws: Workspace, md, plan: ParallelPlan) -> list[str]:
    t = ws.tuning
    return [
        "python", "-m", f"{plan.chip.engine_package}.tuning.cli",
        "--model", md.name,
        "--method", t.method,
        "--data-dir", DATA_DIR,
        "--output-dir", RESULTS_DIR,
        "--mesh", str(plan.mesh),
    ] + (["--config-file", "/mnt/config/tuning_config.yaml"] if t.config else [])


def generate_tuning_job(ws: Workspace, md, plan: ParallelPlan,
                        node_selector: dict,
                        image: str = "") -> Unstructured:
    t = ws.tuning
    chip = plan.chip
    image = image or chip.image
    n = str(chip.devices_per_pod(plan.chips_per_slice))
    labels = {LABEL_WORKSPACE_NAME: ws.metadata.name}
    volumes = [{"name": "results", "emptyDir": {}},
               {"name": "data", "emptyDir": {}}]
    mounts = [{"name": "results", "mountPath": RESULTS_DIR},
              {"name": "data", "mountPath": DATA_DIR}]

    init_containers = []
    if t.input.urls:
        urls = " ".join(shlex.quote(u) for u in t.input.urls)
        init_containers.append({
            "name": "data-downloader",
            "image": "curlimages/curl:latest",
            "command": ["sh", "-c", f"cd {DATA_DIR} && for u in {urls}; do "
                        f"curl -sSLO \"$u\"; done"],
            "volumeMounts": [{"name": "data", "mountPath": DATA_DIR}],
        })
    elif t.input.image:
        init_containers.append({
            "name": "data-puller",
            "image": t.input.image,
            "command": ["sh", "-c", f"cp -r /data/* {DATA_DIR}/"],
            "volumeMounts": [{"name": "data", "mountPath": DATA_DIR}],
        })
    elif t.input.volume:
        volumes.append({"name": "input-volume", **t.input.volume})
        mounts.append({"name": "input-volume", "mountPath": DATA_DIR})

    containers = [{
        "name": "tuning",
        "image": image,
        "command": build_tuning_command(ws, md, plan),
        "volumeMounts": mounts,
        "resources": {"requests": {chip.resource: n}, "limits": {chip.resource: n}},
    }, {
        # metrics sidecar (reference: metrics_server.py on :5000)
        "name": "metrics",
        "image": image,
        "command": ["python", "-m", f"{chip.engine_package}.tuning.metrics_server",
                    "--port", "5000", "--results-dir", RESULTS_DIR],
        "ports": [{"containerPort": 5000}],
        "volumeMounts": [{"name": "results", "mountPath": RESULTS_DIR}],
    }]
    if t.output.image:
        # pusher waits for the sentinel then pushes results as an OCI
        # artifact (reference: pkg/workspace/image/pusher.go via ORAS)
        containers.append({
            "name": "pusher",
            "image": "ghcr.io/oras-project/oras:v1.2.0",
            "command": ["sh", "-c",
                        f"while [ ! -f {RESULTS_DIR}/{SENTINEL} ]; do sleep 5; done; "
                        f"cd {RESULTS_DIR} && oras push {shlex.quote(t.output.image)} ."],
            "volumeMounts": [{"name": "results", "mountPath": RESULTS_DIR}],
        })

    return Unstructured(
        "Job",
        ObjectMeta(name=f"{ws.metadata.name}", namespace=ws.metadata.namespace,
                   labels=labels),
        spec={
            "backoffLimit": 2,
            "template": {
                "metadata": {"labels": labels},
                "spec": {
                    "nodeSelector": dict(node_selector),
                    "restartPolicy": "Never",
                    "initContainers": init_containers,
                    "containers": containers,
                    "volumes": volumes,
                    "tolerations": [{"key": chip.resource,
                                     "operator": "Exists",
                                     "effect": "NoSchedule"}],
                },
            },
        })
