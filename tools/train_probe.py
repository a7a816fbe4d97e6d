"""Where a training step's time goes, on one card.

Run from the root of a checkout, on a card:

    python3 tools/train_probe.py [RUN ...]

RUN is one of ``lora``, ``qlora``, ``qlora-short``, ``full`` (default:
all four), the runs of ``chip_smoke.py``'s phase 16: Llama-3.1-8B LoRA
and QLoRA at B=4 x T=512, QLoRA at B=1 x T=256, Llama-3.2-1B full
fine-tuning at B=4 x T=512, synthetic bf16 weights from seed 0, a
batch of seeded tokens with every position in the loss.  For each it
builds the ``Trainer`` (no output dir), takes 3 steps to warm up, times
5 more between synchronizations (host clock), then traces 2 steps with
``torch.profiler`` and prints one JSON line: the step ms, the card's
busy ms a step (the sum of the kernels' device time: one stream, so
they do not overlap) and its share of the median untraced step, the
device time under each ``record_function`` range a step (``attention``:
the forward and rematerialized attention, not its backward), kernels a
step, the host's operator calls a step, and the kernels with the most
device time.
Nothing fails but an exception.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = {"lora": ("llama-3.1-8b-instruct", "lora", 4, 512),
        "qlora": ("llama-3.1-8b-instruct", "qlora", 4, 512),
        "qlora-short": ("llama-3.1-8b-instruct", "qlora", 1, 256),
        "full": ("llama-3.2-1b-instruct", "full", 4, 512)}


def probe(name: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kaito_tpu_torch.tuning.lora import LoraConfig
    from kaito_tpu_torch.tuning.trainer import TrainConfig, Trainer

    model, method, B, T = RUNS[name]
    cfg = TrainConfig(model=model, method=method, output_dir="",
                      lora=LoraConfig(r=8, alpha=16), batch_size=B, max_seq_len=T,
                      max_steps=10, warmup_steps=2, checkpoint_every=0,
                      dtype="bfloat16")
    tr = Trainer(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, 256, (B, T + 1), device="cuda", generator=gen,
                                     dtype=torch.int32),
             "mask": torch.ones((B, T), device="cuda")}

    def step():
        tr.state, m = tr._step_fn(tr.state, batch)
        return m

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / 2
    kernels, ranges, ops = {}, {}, 0
    for e in prof.events():
        dev = getattr(e, "device_type", None)
        if dev is not None and dev.name == "CUDA":
            # a record_function range seen on the device's track spans
            # kernels already counted
            into = ranges if getattr(e, "is_user_annotation", False) or \
                e.name == "attention" or e.name.startswith("kaito/") else kernels
            k = into.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
        elif e.cpu_parent is None and e.name.startswith("aten::"):
            ops += 1
    busy = sum(v[1] for v in kernels.values()) / 2
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    out = dict(run=name, model=model, method=method, batch=B, seq=T,
               device=torch.cuda.get_device_name(0), step_ms=sorted(ms),
               traced_step_ms=traced_ms, busy_ms=busy,
               busy_share_of_untraced_median=busy / sorted(ms)[2],
               ranges_ms={n: round(t / 2, 3) for n, (c, t) in ranges.items()},
               kernels_a_step=sum(v[0] for v in kernels.values()) / 2,
               host_ops_a_step=ops / 2,
               top=[(n[:80], c // 2, round(t / 2, 3)) for n, (c, t) in top])
    del tr
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(RUNS)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from kaito_tpu_torch.ops import build

    build.build_all()
    for name in names:
        print(json.dumps(probe(name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
