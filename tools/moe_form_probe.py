"""Probe of the MoE expert products on one card: the two forms a captured
decode window can hold, at gpt-oss-20b's widths.

Run from the root of a checkout (the one whose ``kaito_tpu_torch`` it
imports), on a card:

    python3 tools/moe_form_probe.py

- ``caps``: which dtypes ``torch._grouped_mm`` takes on this card's
  torch, eagerly and under CUDA-graph capture; whether rows past the last
  group offset change the rows inside the groups; and what an empty group
  costs (32 rows routed to 4 experts against 32 rows spread over all 32,
  one call each, timed back to back).
- ``forms``: one MoE MLP of gpt-oss-20b (hidden 2880, 32 experts, top-4,
  expert width 2880, bf16, random weights) in its two capturable forms:
  ``grouped`` (``nn.moe_mlp_ragged(grouped=True)``, one
  ``torch._grouped_mm`` per projection over device-side group offsets,
  the inactive rows in no group) and ``dense`` (``nn.moe_mlp``, every
  row through every expert).  A decode window of the engine has 8 rows
  (``max_num_seqs``): one active sequence, and eight.  Each form runs as
  a captured CUDA graph of 24 layers (the model's depth), cycling
  through 4 copies of the layer's weights (6.4 GB: every call finds its
  experts cold, as a decode step does), replayed and timed with CUDA
  events; the bytes bound counts the experts the active rows chose.  The
  grouped form is also held against the host-sized ragged loop and the
  dense form, and two replays against each other, bitwise.

Each prints JSON lines; nothing fails but an exception.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # the checkout's root

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
LAYERS, COPIES, ROWS = 24, 4, 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def caps() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(32, 256, generator=gen, device=dev).to(dtype)
        w = torch.randn(8, 256, 128, generator=gen, device=dev).to(dtype)
        offs = torch.tensor([4, 4, 10, 16, 16, 20, 26, 30], dtype=torch.int32,
                            device=dev)
        res = {}
        try:
            out = torch._grouped_mm(x, w, offs=offs)
            ref = torch.cat([x[lo:hi].float() @ w[e].float() for e, (lo, hi) in
                             enumerate(zip([0] + offs.tolist()[:-1], offs.tolist()))])
            res["eager"] = dict(out_dtype=str(out.dtype), out_stride=out.stride(),
                                max_err=(out[:30].float() - ref).abs().max().item())
            # rows past offs[-1] (30, 31) hold anything: the rows inside
            # the groups must not move when they change
            x2 = x.clone()
            x2[30:] = float("nan")
            out2 = torch._grouped_mm(x2, w, offs=offs)
            res["rows_past_last_offset_leave_groups_alone"] = bool(
                torch.equal(out[:30], out2[:30]))
        except (RuntimeError, NotImplementedError) as e:
            res["eager"] = f"{type(e).__name__}: {e}"
        try:
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                torch._grouped_mm(x, w, offs=offs)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(g):
                gout = torch._grouped_mm(x, w, offs=offs)
            g.replay()
            torch.cuda.synchronize()
            # rows 30 and 31 lie past the last offset: nothing writes them
            res["capture"] = dict(equal_to_eager=bool(torch.equal(gout[:30], out[:30]))
                                  if isinstance(res["eager"], dict) else None)
        except (RuntimeError, NotImplementedError) as e:
            res["capture"] = f"{type(e).__name__}: {e}"
        emit(probe="grouped_mm", dtype=str(dtype), torch=torch.__version__, **res)

    # an empty group: 32 rows on 4 experts against 32 rows over 32
    E, Im, X = 2880, 2880, 32
    ws = [torch.randn(X, E, Im, generator=gen, device=dev, dtype=torch.bfloat16)
          for _ in range(COPIES)]
    x = torch.randn(32, E, generator=gen, device=dev, dtype=torch.bfloat16)
    # experts 0, 8, 16 and 24 take 8 rows each; the other groups are empty
    few = (8 * (torch.arange(X, device=dev) // 8 + 1)).to(torch.int32)
    spread = torch.arange(1, X + 1, dtype=torch.int32, device=dev)
    times = {}
    for name, offs in (("4 experts", few), ("32 experts", spread)):
        calls = [lambda w=w, offs=offs: torch._grouped_mm(x, w, offs=offs) for w in ws]
        times[name] = time_calls(calls, 40)
    emit(probe="empty_groups", rows=32, ms_per_call=times,
         bound_ms={"4 experts": 4 * E * Im * 2 / HBM_BYTES_PER_S * 1e3,
                   "32 experts": X * E * Im * 2 / HBM_BYTES_PER_S * 1e3})


def time_calls(calls, iters) -> float:
    """Card ms per call, cycling ``calls``, back to back behind a sleep."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layers(arch, gen, dev):
    E, X, Im = arch.hidden_size, arch.num_experts, arch.moe_intermediate_size
    return [{"router": torch.randn(E, X, generator=gen, device=dev) / E ** 0.5,
             "experts_gate": (torch.randn(X, E, Im, generator=gen, device=dev,
                                          dtype=torch.bfloat16) / E ** 0.5),
             "experts_up": (torch.randn(X, E, Im, generator=gen, device=dev,
                                        dtype=torch.bfloat16) / E ** 0.5),
             "experts_down": (torch.randn(X, Im, E, generator=gen, device=dev,
                                          dtype=torch.bfloat16) / Im ** 0.5)}
            for _ in range(COPIES)]


def forms() -> None:
    from kaito_tpu_torch.engine import nn
    from kaito_tpu_torch.models.registry import get_model_by_name

    arch = get_model_by_name("gpt-oss-20b").arch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = _layers(arch, gen, dev)
    for p in layers:
        p["router"] = p["router"].to(torch.bfloat16)
    E, X, Im, k = (arch.hidden_size, arch.num_experts, arch.moe_intermediate_size,
                   arch.num_experts_per_tok)
    x = torch.randn(ROWS, E, generator=gen, device=dev, dtype=torch.bfloat16)
    for active in (1, ROWS):
        valid = torch.arange(ROWS, device=dev) < active
        fns = {"grouped": lambda p: nn.moe_mlp_ragged(x, p, arch, grouped=True,
                                                      valid=valid),
               "dense": lambda p: nn.moe_mlp(x, p, arch)}
        # the experts each layer copy's active rows chose
        chosen = []
        for p in layers:
            _, idx = torch.topk(x[:active].float() @ p["router"].float(), k, dim=-1)
            chosen.append(len(set(idx.flatten().tolist())))
        res = {}
        outs = {}
        for name, fn in fns.items():
            out_ref = fn(layers[0])
            graph, gout = _capture(lambda fn=fn: [fn(layers[i % COPIES])
                                                  for i in range(LAYERS)])
            graph.replay()
            torch.cuda.synchronize()
            first = gout[0].clone()
            graph.replay()
            torch.cuda.synchronize()
            replays_equal = bool(torch.equal(first, gout[0]))
            ms = time_graph(graph, 10)
            outs[name] = first
            experts = [chosen[i % COPIES] if name == "grouped" else X
                       for i in range(LAYERS)]
            nbytes = sum(3 * n * E * Im * 2 for n in experts) \
                + LAYERS * (E * X * 2 + 2 * ROWS * E * 2)
            res[name] = dict(ms_24_layers=ms, ms_per_layer=ms / LAYERS,
                             experts_read_per_layer=sum(experts) / LAYERS,
                             bound_ms_24_layers=nbytes / HBM_BYTES_PER_S * 1e3,
                             replays_bitwise_equal=replays_equal,
                             replay_equals_eager=bool(torch.equal(first, out_ref)))
        loop = nn.moe_mlp_ragged(x, layers[0], arch, grouped=False, valid=valid)
        scale = loop[:active].float().abs().max().item()

        def rel(a):
            return (a[:active].float() - loop[:active].float()).abs().max().item() / scale

        emit(probe="forms", rows=ROWS, active=active, card=card_line(),
             forms=res, grouped_vs_ragged_loop_rel=rel(outs["grouped"]),
             dense_vs_ragged_loop_rel=rel(outs["dense"]),
             inactive_rows_zero=bool((outs["grouped"][active:] == 0).all()))


def _capture(body):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()                                   # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = body()
    return g, out


def time_graph(graph, iters) -> float:
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("this probe needs a card")
    print(card_line(), flush=True)
    with torch.no_grad():
        caps()
        forms()
