"""Model weight fetch / streaming utility.

Parity with two reference mechanisms: the ModelMirror download job
(hf transfer into shared storage, ``pkg/modelmirror/download/job.go:33``)
and the model-streaming load path (vLLM runai_streamer from cloud blob,
``pkg/workspace/inference/modelstreaming/``).  On GKE the natural
substrate is GCS: managed mirrors download HF -> gs:// once; pods
stream safetensors straight from the bucket at startup.

The port's own copy of ``kaito_tpu/runtime/weight_fetch.py``; the
port's server fetches a ``hub://`` adapter source through
:func:`fetch_from_hub`.  ``huggingface_hub`` is imported inside the
function, so the module imports without it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys

logger = logging.getLogger(__name__)


def fetch_from_hub(model_id: str, dest: str, token: str = "") -> int:
    """Download safetensors + config via huggingface_hub (network
    permitting; in air-gapped test environments the local HF cache is
    the only source)."""
    from huggingface_hub import snapshot_download

    path = snapshot_download(
        model_id, token=token or None,
        allow_patterns=["*.safetensors", "*.json", "tokenizer*", "*.model"])
    os.makedirs(dest, exist_ok=True)
    for name in os.listdir(path):
        src = os.path.join(path, name)
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(dest, name))
    return 0


def copy_to_gcs(local: str, bucket_dest: str) -> int:
    """gs:// upload via gsutil (present on GKE node images)."""
    import subprocess

    return subprocess.call(["gsutil", "-m", "rsync", "-r", local, bucket_dest])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-id", required=True)
    ap.add_argument("--dest", required=True, help="local dir or gs:// URI")
    ap.add_argument("--hf-token", default=os.environ.get("HF_TOKEN", ""))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    staging = args.dest
    to_gcs = args.dest.startswith("gs://")
    if to_gcs:
        staging = "/tmp/weight-staging"
    try:
        rc = fetch_from_hub(args.model_id, staging, args.hf_token)
    except Exception as e:
        logger.error("hub fetch failed: %s", e)
        return 1
    if rc == 0 and to_gcs:
        rc = copy_to_gcs(staging, args.dest)
    print(json.dumps({"model_id": args.model_id, "dest": args.dest,
                      "status": "ok" if rc == 0 else "failed"}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
