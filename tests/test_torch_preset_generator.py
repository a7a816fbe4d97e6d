"""The port's preset generator CLI
(``kaito_tpu_torch/models/preset_generator.py``) against the JAX one.

- ``tests/test_preset_autogen_production.py``'s CLI cases through the
  port: a catalog id offline prints its JSON (24 layers, a plan whose
  mesh ends in ``tensor:1``), an unknown id offline exits 1.
- For every TPU generation and several catalog ids, the port's output
  equals the JAX CLI's key for key (plain and ``--json``, with
  ``--quantization`` and ``--kv-cache-dtype``).
- The ``h100-80gb`` plan preview: the port's planner on the H100 entry
  (one card for a small model, several at TP for a 70B-class config).
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from kaito_tpu.models import preset_generator as jax_cli
from kaito_tpu_torch.models import preset_generator as cli
from tests.test_torch_operator_workspace import _offline_fetchers  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_preset_generator_cli_json():
    out = subprocess.run(
        [sys.executable, "-m", "kaito_tpu_torch.models.preset_generator",
         "--model", "Qwen/Qwen2.5-0.5B-Instruct", "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "HF_HUB_OFFLINE": "1"})
    assert out.returncode == 0, out.stderr
    data = json.loads(out.stdout)
    assert data["num_layers"] == 24
    assert data["plan"]["mesh"].endswith("tensor:1")


def test_preset_generator_cli_unknown_model_offline():
    out = subprocess.run(
        [sys.executable, "-m", "kaito_tpu_torch.models.preset_generator",
         "--model", "no-such-org/no-such-model"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ".", "HF_HUB_OFFLINE": "1"})
    assert out.returncode == 1
    assert "no config for no-such-org/no-such-model" in out.stderr


CASES = [
    ("Qwen/Qwen2.5-0.5B-Instruct", "v5e", []),
    ("Qwen/Qwen2.5-0.5B-Instruct", "v6e", ["--kv-cache-dtype", "int8"]),
    ("TinyLlama/TinyLlama-1.1B-Chat-v1.0", "v4", ["--quantization", "int8"]),
    ("TinyLlama/TinyLlama-1.1B-Chat-v1.0", "v5p", ["--quantization", "int4"]),
    ("Qwen/Qwen2.5-0.5B-Instruct", "no-such-chip", []),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("as_json", [True, False], ids=["json", "plain"])
def test_tpu_output_equals_the_jax_cli(case, as_json):
    model, chip, extra = CASES[case]
    argv = ["--model", model, "--chip", chip, *extra] + (["--json"] if as_json else [])
    got, want = _run(cli, argv), _run(jax_cli, argv)
    assert got == want and got[0] == 0
    if as_json:
        data = json.loads(got[1])
        assert ("plan_error" in data) == (chip == "no-such-chip")


LLAMA_70B = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
             "hidden_size": 8192, "num_hidden_layers": 80, "num_attention_heads": 64,
             "num_key_value_heads": 8, "intermediate_size": 28672, "vocab_size": 128256,
             "max_position_embeddings": 131072, "rope_theta": 500000.0,
             "rms_norm_eps": 1e-5, "torch_dtype": "bfloat16"}


def test_h100_plan_preview(tmp_path):
    rc, out, _ = _run(cli, ["--model", "Qwen/Qwen2.5-0.5B-Instruct", "--chip",
                            "h100-80gb", "--json"])
    assert rc == 0
    small = json.loads(out)
    assert small["plan"] == {"chip": "h100-80gb", "topology": "1", "num_slices": 1,
                             "mesh": "pipeline:1xdata:1xfsdp:1xexpert:1xsequence:1xtensor:1",
                             "notes": ["tensor parallel over 1 card(s) of one node"]}
    (tmp_path / "config.json").write_text(json.dumps(LLAMA_70B))
    rc, out, _ = _run(cli, ["--model", "org/llama-70b-like", "--chip", "h100-mega-80gb",
                            "--config-file", str(tmp_path / "config.json"), "--json"])
    big = json.loads(out)
    assert rc == 0 and big["num_layers"] == 80
    assert big["plan"]["chip"] == "h100-mega-80gb" and big["plan"]["num_slices"] == 1
    assert big["plan"]["mesh"].endswith(f"tensor:{big['plan']['topology']}")
    assert int(big["plan"]["topology"]) > 1
    # the JAX CLI has no H100 entry: its preview fails where the port's plans
    assert "plan_error" in json.loads(_run(jax_cli, ["--model", "Qwen/Qwen2.5-0.5B-Instruct",
                                                     "--chip", "h100-80gb", "--json"])[1])
