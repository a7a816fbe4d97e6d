#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kaito_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, in
order; any failure exits non-zero and prints no result:

1. Card and build: the card's name and power limit (``nvidia-smi``),
   then every kernel under ``kaito_tpu_torch/csrc/`` built from the
   checkout with ``nvcc``.
2. Kernels against their plain versions on the card, at Llama-3.1-8B
   shapes, in bf16 and fp32: paged decode (K1), flash prefill over a
   fresh chunk (K2) and over a segment-packed row (K3) at T = 512, 256
   and 200 (ragged), with windows of 128 and 32 tokens, a softcap, and
   packed layouts of four segments and of many 1-3-token ones (K2 and
   K3 are timed at T = 512 and at T = 256, the bucket of phase 4's
   200-token prompt), paged decode
   over int8 pages with scales (K1q, over the K1 pools quantized), and
   the fused dequant matmuls of int8 (K4) and int4 (K5) weights at the
   four projection shapes with 1, 5, 8, 9, 16, 17, 64, 65, 200 and 256
   rows (bf16 calls of 17-256 rows take the wide path, whose launch
   counter must follow), timed at 1, 8, 16 and 200 rows at every shape
   and also at 64 and 256 rows at gate/up; K4 and K5 again at
   DeepSeek-V3's eight projection shapes (kv_a 7168x576, whose 576
   columns take the CUDA-core path, q_a, q_b, o, and the dense and
   shared-expert MLPs) with 1, 8, 16, 17, 200 and 256 bf16 rows, each
   call one launch, on the wide path exactly when the wrapper takes it
   (the errors, paths and launches by shape go into the kernel
   records); K4 likewise at TinyLlama-1.1B's four projection shapes
   (q/o 2048x2048, k/v 2048x256, gate/up 2048x5632, down 5632x2048) with
   1, 4, 16, 17, 200 and 256 rows, timed at gate/up with 4 and 200 rows
   (phase 18's model); and K6, the int8 and
   int4 kernels with the next layer's slab prefetched into L2, at the
   TP=2 ring-chunk shapes (o and down chunks, strided views), whose
   output must be bitwise K4/K5's.  The decode-row path (bf16, 1-16
   rows) logs its plan at each shape and ptxas's register and spill
   lines (a spill fails the run), its merge counters must read zero
   after the checks, and one K5 and one K6 call captured in a CUDA
   graph must match the plain version (and the eager kernel, bitwise)
   when replayed after new x is copied into its input and after an
   eager call with more partials.  K1 runs with the
   page-table width the full-width engine gives it at its context limit,
   and is also timed at the live width the engine passes and with one
   live sequence beside idle (length-0) rows; K1q is timed at both
   widths too.  The K1/K1q plan (splits, CTAs, scratch) and ptxas's
   register and spill lines for ``decode_attention.cu`` are logged (a
   spill fails the run), the merge counters must read zero after the
   checks, and one K1 and one K1q call captured in a CUDA graph must
   match the plain version when replayed after new lengths and page
   tables are copied into its inputs (and after an eager call at a
   larger batch).  Tolerances: fp32 atol
   1e-4 (the kernels sum in another order than the plain versions);
   bf16 atol 2e-2 (P is rounded to bf16 before the PV product, relative
   to a different running max in each); for K4 and K5 relative to the
   output's largest magnitude (K6 the same as K4/K5); K1 and K1q (K1q
   only so) also relative to each sequence's largest magnitude, since a
   long sequence comes out far smaller than a short one.  The reading
   of a kernel that loses one split of the longest sequence (the plain
   version without that split's pages) is logged beside them and must
   fail that check.  Each kernel,
   its plain version and
   one PyTorch call as a yardstick (``scaled_dot_product_attention``;
   ``torch.matmul`` against the dequantized bf16 weight for K4/K5) are
   timed with CUDA events on the card's clock (behind a sleep kernel, so
   host issue does not enter), and the host time each kernel call takes
   is recorded beside it.  K4/K5 and their yardstick cycle through copies
   of the weight that together exceed the 50 MB L2, as a decode step
   finds each weight cold; K6 is also timed by what its prefetch buys:
   the next layer's K4/K5 call right after K6, against the same call
   right after a K4/K5 call without the prefetch.  At gpt-oss-20b's
   attention shape (64 query heads over 8 KV heads, head_dim 64) K1 and
   K1q run eight sequences with a global window and with its window of
   128, and K2 and K3 a 512-token chunk with the same two windows, each
   against its plain version (bf16 and fp32) and timed in bf16 beside
   SDPA (a boolean mask where a window cuts it) and the bound, which
   counts only the keys the window keeps; K1's plan there is logged.
   K2 also at prompt scoring's lengths, T = 1024 and 4096 with true_len
   T - 37 (bf16 and fp32, the same tolerances), timed at T = 4096 beside
   SDPA, and as phase 17's embedder calls it: fp32, 32 and 64 rows of
   T = 256, each row's true_len a query's or a document's token count
   and the last row empty, compared on the valid rows.  At the head dims of the other dense families
   (:data:`FAMILY_HEADS`: phi-3-mini H = Hkv = 32, D = 96; phi-2 H = Hkv
   = 32, D = 80; gemma-3-4b H = 8, Hkv = 4, D = 256, scale 1/16, global
   and its window of 1024) K1 and K1q run the eight sequences and K2 and
   K3 T = 512 and 200 (and 2048 for gemma-3), bf16 and fp32 against
   their plain versions with the same tolerances, each timed in bf16
   beside SDPA and the bound; one K1 and one K1q call at D = 96 and at D
   = 256 replay from a CUDA graph; ``flash_prefill.cu`` must not spill.
3. Goldens: ``tiny-llama-real`` in fp32 through the port's engine on the
   card, the prefix cache on, must reproduce the ``fp32``, ``int8``,
   ``weight_int4`` and ``kv_int8`` sections of
   ``tests/testdata/goldens_tiny-llama-real.json`` (greedy tokens exact,
   logprobs within atol 2e-3), every decode window a replayed CUDA
   graph; the four again at page 16 with each prompt served twice, the
   second run a prefix hit that must take its whole prompt pages from
   the cache (``kv_int8``'s logprobs there held against a CPU engine's
   same runs); the four again through the async decode loop
   (``async_dispatch``); then at tensor_parallel 2 (all four) and 4 (all
   but ``weight_int4``, which that degree refuses), each with the
   comm-overlap ring off and on, and fp32 at TP=2 with the ring through
   the async loop, on a mesh of the first cards or, on a one-card
   machine, of slots that all map onto that card (windows at TP >= 2 run
   eagerly).  Then the MoE checkpoint ``tiny-moe-real``: its four
   sections (``tests/testdata/goldens_tiny-moe-real.json``) through
   captured windows, and ``fp32`` through the async loop.  Last a tiny
   MLA model (``tests/test_mla.py``'s config: q_lora, one dense and two
   MoE layers, a shared expert; weights drawn once on the CPU from seed
   0) in the four modes ``fp32``, ``int8``, ``weight_int4`` and
   ``kv_int8``: an engine on the card must give the greedy tokens of one
   on the CPU (which the CPU tests hold against the JAX engine) with
   logprobs within atol 2e-3, every card window a replay.  The fp32
   goldens are also scored (``score_prompt``: each golden prompt plus
   its golden tokens, K2 once a layer): the scores of the golden tokens
   must be the golden logprobs within 2e-3.  The four sections of
   ``tiny-llama-real`` again through n-gram speculation (4 tokens), and
   ``fp32`` through the checkpoint as its own draft (k=4: full-accept
   rounds and the draft KV's backfill): tokens exact, logprobs within
   2e-3 (``kv_int8``'s against a CPU engine's same runs, its verify
   windows requantizing a page over the window), every verify round
   and draft scan a graph replay, fewer target forwards than tokens.
4. Full width: the port's HTTP server serves ``llama-3.1-8b-instruct``
   (all 32 layers, bf16, synthetic weights from seed 0): one completion,
   one streamed chat, then four concurrent 100-400-token prompts (a
   prefill pack) and one 700-token prompt (a continuation chunk).  Every
   response must be well formed and carry its ``max_tokens``; a seeded
   sampled completion (seed 7) sent twice must give one text and one
   set of logprobs, seed 8 others (per-slot keys under graph replay);
   the launch
   counts of K1, K2 and K3, zeroed just before this phase, must each
   have grown (a replayed decode window counts its kernels), and every
   decode window must have been a graph replay.  Cold TTFT (the
   minimum over three 200-byte prompts new to the prefix cache), decode
   tokens/s (a cold 129-token run against it) and the inter-token gaps
   of one sequence alone are printed beside the card; then warm TTFT (a
   prompt the cache holds: three repeats after one cold run, each
   taking 192 of its tokens from the cache, and a repeat whose greedy
   text must be the cold run's; an MLA leg must have no tree and reads
   none).  The routes: ``/metrics`` must parse, its histograms be
   cumulative and its prompt, generation and cached-token counters
   equal the engine's; a request sent with an ``X-Request-Id`` must have
   its span tree at ``/debug/trace?trace_id=`` and engine steps inside
   it at ``/debug/timeline``; ``/debug/slo`` must answer and
   ``/debug/device`` answer 403 (sampling off); with QoS and ITL off no ``/metrics``
   series may carry a ``tenant`` label or belong to an ITL family.  Then the decode readings of one
   sequence: host launch and copy calls a decode step and a window (on
   the bf16, int8 and bf16-async legs no more than when decode windows
   were first captured, PERF.md section 5), device
   kernels a step (profiled), the windows' captures, graph pool and
   kernel nodes.  Then the server stops, the
   engine greedily decodes a batch of four prompts step by step, and an
   engine with the eager reference loop (``_eager_decode``; same config,
   seed and weights) must emit the same tokens; its one-sequence tok/s
   and ITL (9 tokens) and launches a step (4 profiled decode steps) are
   printed beside the
   captured engine's.
5. Quantized, full width: the server, configured by its own command line
   (``--quantization int4 --kv-cache-dtype int8``), serves the same model
   and request mix; then a shorter ``--quantization int8`` leg (bf16 KV).
   The launch counts of K5 and K1q (int4 leg) and of K4 (int8 leg), and
   of K5's and K4's launches on the wide (prefill-row) path, are zeroed
   before each leg and must grow.  Last, the bf16 server with
   ``--async-dispatch`` and the request mix of phase 4.  Each of these
   TP=1 legs is held against the eager loop as in phase 4.
6. Tensor parallel, full width cut in depth: the same model at TP=2
   (its 32 layers cut to 4) with the
   comm-overlap ring, its engine built on an explicit mesh (two cards, or
   two slots of one card, which the log names) and handed to
   ``make_server``: int4 weights + int8 KV with the request mix of phase
   5 (K6 int4, K5, K1q, K2 and K3 must launch), then int8 weights with
   bf16 KV without the burst (K6 int8 and K1).  On one card a ring hop
   moves nothing, so these legs time no transfer.
7. MoE, full width (leg ``moe-bf16``), after the card is released from
   the llama legs: the server serves ``gpt-oss-20b`` (all 24 layers,
   32 experts, top-4, bf16, synthetic weights from seed 0) with the
   request mix of phase 4; K1, K2 and K3 must launch, every decode window
   must be a graph replay (its expert products in the grouped form), and
   the greedy batch must equal the eager loop's, as in phase 4.
8. MLA, full width cut in depth (legs ``mla-bf16`` and ``mla-int8-kv8``):
   ``deepseek-v3-0324`` at its published widths (hidden 7168, 128 heads,
   latent 512 + rope 64, 256 experts, top-8, one shared expert, vocab
   129280), its 61 layers cut to 5 (the 3 dense layers and 2 MoE ones;
   synthetic bf16 weights from seed 0, 53.2 GB), the engine built with
   the cut metadata and handed to ``make_server``, and the request mix
   of phase 4.  Every window must be a graph replay, the greedy batch
   must equal the eager loop's, and K1, K1q, K2 and K3 must not launch
   (MLA attends through ``attention.mla_*``).  Then 4 layers (3 dense +
   1 MoE) with ``--quantization int8 --kv-cache-dtype int8``: K4 must
   launch on the decode-row and the wide path.  Each leg also times the
   plain MLA decode attention at one layer of its pool (8 sequences,
   the full table width) against its bound.
9. QoS, deadlines, ITL, scoring and ``n`` (leg ``qos-bf16``): the bf16
   server of phase 4 with its own flags ``--qos-config`` (``acme``
   guaranteed, everyone else best-effort with a queue budget of 4),
   ``--itl``, ``--kv-shed-threshold 0.95`` and ``--max-queue-len 64``.
   acme's streamed TTFT alone, then under a best-effort flood of
   24-token requests: acme always completes, the flood takes 429s with a
   Retry-After, the per-tenant shed counters agree, and acme's loaded
   TTFT p50 stays within max(2x, +250 ms) of its unloaded one.  With
   every slot held by best-effort decodes an acme request completes
   unpreempted while a best-effort one is preempted and still finishes.
   A request queued behind a full batch with a 50 ms timeout answers 408
   without spending a prompt token; a 400-token decode with a 1 s
   timeout answers 408 mid-decode; every page comes back.  The ITL
   histogram's count must equal the leg's tokens less one a request,
   logged beside the client's stamps of one sequence.  ``echo`` scores a
   1000- and a 4000-byte prompt (twice each), each with exactly one K2
   launch a layer, and a served greedy continuation's logprobs against
   the same tokens scored (bf16, within 0.1).  ``n``: four greedy choices
   hold n=1's tokens up to a near-tie (the two picks' logprobs within
   0.1), four sampled ones sum to the usage, and ``n`` with ``stream``
   is a 400.  K1 and K2 must launch, and every decode window
   must be a graph replay.
10. Speculation (leg ``spec-bf16``): Llama-3.1-8B at full width in bf16
   (phase 4's config), three engines sharing one copy of the weights:
   the plain engine, n-gram speculation (4 tokens, min match 2) and the
   synthetic ``llama-3.2-1b-instruct`` draft at full width (k=4).  Four
   repetitive prompts, 64 greedy tokens each, submitted together: each
   speculative engine's tokens must equal the plain engine's, or part
   from them only at a near-tie (both picks' logprobs within 0.1: a
   verify window's [B, W] forward sums in another order than a decode
   step); n-gram must accept proposals and emit more tokens than its
   target forwards; the draft's depth controller must fall back to
   n-gram and probe the draft again; a temperature-0.8 batch completes;
   a seeded request (seed 7) sent twice to one slot gives one answer,
   seed 8 another, on the plain engine and the draft one; every verify
   round and draft scan is a graph replay (none eager); ``/metrics``'
   ``kaito:spec_*`` equal the counters.  Logged: tokens a target
   forward, host calls and device kernels a scheduler step (profiled),
   ms a token of one sequence alone against the plain engine's, the
   card ms of each captured verify graph and of the plain context
   attention at its width, and K1's launches on the draft scan.
11. Structured output and tool calling (leg ``grammar-bf16``):
   Llama-3.1-8B at full width in bf16 (phase 4's config with the
   prefix cache off, so a batch reruns exactly), byte tokenizer, a
   server over the engine.  No ``kaito:grammar_*`` line on ``/metrics``
   before the first constrained request, the whole family after it.
   Over HTTP: a ``json_schema`` of a finite language (enums and a
   boolean) on chat and completions must ``json.loads``, match and
   finish ``stop``; a bounded regex must match whole and finish
   ``stop``; ``json_object`` (unbounded) must open an object and parse
   where it stops; ``tool_choice: "required"`` and a named function
   answer ``tool_calls`` whose arguments parse, streamed as deltas that
   accumulate to them; ``auto`` answers, streamed and not; 400s, 422
   ``invalid_grammar_error`` for a regex past the state cap and an
   unsupported schema, 403 for ``kv_transfer`` with P/D off, and 400
   ``structured_output_disabled`` from a second server over the same
   engine with ``--no-structured-output``; a seeded constrained sampled
   request twice gives one answer, another seed another.  Then, on the
   engine stepped directly: four unconstrained rows beside four
   constrained ones equal their all-unconstrained run; a constrained
   request decodes while requests under other grammars go live past the
   table's capacity, which doubles mid-stream (the old table's graphs
   dropped, the device table equal to the host's, the output walking
   its automaton).  Last, n-gram and draft engines on the same weights
   give the plain engine's constrained greedy batch up to the near-tie
   rule of phase 10, every verify round and draft scan under the grammar
   a graph replay.  Phase 5's int4 + int8 KV leg also answers one
   ``json_schema`` chat (K5 and K1q under a mask).  Logged beside the
   card: each grammar's compile ms, the table's MiB and upload ms, the
   kernel nodes and card ms of a constrained K=4 window against an
   unconstrained one, ms a token of one constrained sequence alone
   against plain, host calls and device kernels a decode step of each.
12. Multi-LoRA serving (legs ``adapter-bf16`` and ``adapter-fp32``).
   Full width: Llama-3.1-8B in bf16 (phase 4's config, the prefix cache
   off) with ``--adapter-slots 4 --adapter-rmax 16``; five adapters on
   all seven targets (three at r=16, one at r=8, one at alpha/r = 1.5)
   written on the card by the port's own ``save_adapter``.  Four are
   hot-loaded over ``POST /v1/adapters`` while a base request decodes;
   ``GET /v1/adapters``, ``/v1/models``, ``kaito:adapter_*`` and one
   completion per adapter by the ``model`` field answer.  On the engine
   stepped directly: a mixed batch of 8 (two prompts under the base and
   three adapters) against each row alone under phase 10's near-tie
   rule, every adapter stream apart from the base's, every decode window
   a graph replay, K1, K2 and K3 launched; then a load that evicts, a
   fault back in and a DELETE leave the count of captured graphs and the
   lanes' addresses unchanged, and the batch reruns to the same tokens.
   Logged: the slot table's MiB, each hot-load's ms, ms a token of one
   sequence alone (base and adapter), host calls and device kernels a
   decode step of each, and the kernel nodes and card ms of a K=4
   window of 8 rows with adapters and without.  Exact: ``tiny-llama-real``
   in fp32 with ``--adapter-slots 2`` and three adapters, on the card and
   on the CPU: a mixed batch (base and two adapters) equals each row
   alone and the CPU engine token for token, and an evict -> fault
   round trip leaves the adapter's lane bit-equal and its stream
   unchanged.

13. The rest of the dense families (legs ``families-bf16`` and
   ``families-fp32``).  Full width, bf16, synthetic weights from seed 0,
   phase 4's config (page 64, 8 sequences, 512 prefill tokens, the
   prefix cache on), each model served over HTTP (a completion with
   logprobs, a streamed chat, phase 4's burst, TTFT and tok/s of one
   request alone, the decode readings; K1, K2 and K3 zeroed before and
   each launched): ``phi-3-mini-128k-instruct``'s widths through
   ``autogen`` with longrope factor lists of 48 values from a seed and
   an original length of 4096 (the tables at 4095 and 4096 must be short
   then long; a ~4000-token prompt decodes 160 greedy tokens past 4096
   in captured windows, every window a replay; the decode logprobs past
   4096 within 0.1 of a fresh prefill's, ``score_prompt``, over the same
   tokens; an eager-loop engine must give the same 160 tokens);
   ``gemma-3-4b-instruct`` (D = 256; a 1100-token prompt scored, one K2 a
   layer under the window of 1024, and decoded 24 tokens past it); and
   ``phi-2`` (D = 80, partial rotary, parallel residual, biases).
   Exact: a tiny phi-3 (hidden 384, 4 heads of 96, 2 layers, longrope
   lists, original length 48) written as a fused checkpoint
   (``qkv_proj``, ``gate_up_proj``) by the port's ``write_safetensors``
   and served in fp32 from it on the card and on the CPU: two prompts
   across position 48, tokens equal, logprobs within 2e-3.
14. Device profiling and the host KV tier (legs ``devprof-bf16`` and
   ``offload-bf16``).  Llama-3.1-8B at full width in bf16, phase 4's
   config, the two legs sharing one copy of the weights.  Device
   profiling: the server with ``--devprof-interval-s 0.5
   --devprof-window-s 0.25`` serves 8 concurrent 256-token greedy
   completions (after 8 of 16 tokens, which capture the graphs they
   replay: a window over a capture is skipped; up to two more rounds
   until a window falls inside the decodes) while ``/debug/device`` is
   polled: every window's buckets
   sum to 100 (within 0.01), and in every window with only decodes live
   decode holds at least 95% of the busy time, matmul is the largest
   busy bucket and attention is above 0 (the newest one's split of a
   decode step is logged); the ``kaito:device_*`` gauges equal the last
   window; ``/start_profile {"seconds": 2}`` answers 200, a second start
   409, a sampler window meanwhile is skipped, the trace under
   ``KAITO_PROFILE_DIR`` holds ``decode_tc_kernel`` and none of its K1-K3,
   quant-matmul or GEMM slices is classified ``other`` (each bucket's top
   names logged), ``/stop_profile`` on the idle profiler answers 409; the
   same completions on an engine with sampling off (both tok/s logged
   beside the card line); each window's seconds stopping the profiler on
   the engine thread are logged, and one above 1.0 s fails the run (a
   window closes after one decode window or its 0.25 s);
   and phase 4's greedy batch on an engine with a profiler window around
   every step, its graph captures among them, equals an engine's without
   token for token.  The host tier: at
   ``--max-model-len 2048`` with 160 pages of 64, eight ~1500-token
   prompts decoding 256 tokens each, with an 8 GiB tier and without:
   preemptions, spilled and restored pages each at least 1, fewer prefill
   tokens with the tier, the greedy tokens equal the tier-off engine's up
   to the near-tie rule, every restore leaves the pool tensors'
   addresses, every window is a replay, every page returns, K1 and K2
   launch; each restore's and spill's card ms (between two
   synchronizations) is logged against a 1600-token recompute prefill.
   Exact: ``tiny-llama-real`` in fp32 and with int8 KV, two sequences
   overrunning a 9-page pool with the tier on, on the card and on the
   CPU: tokens equal, logprobs within 2e-3, a restore on both.
15. KV movement (leg ``pd-bf16``).  Llama-3.1-8B at full width in bf16
   at ``--max-model-len 4096``, two HTTP servers in this process sharing
   one copy of the weights, 240 pages of 64 each, both ``--pd-enabled
   --kv-pool``, the second with a 60 MiB store (one published prefix)
   and a disk tier in a temp dir.  P/D: prompts of ~1500 and ~3000
   tokens through ``/pd/prefill`` on the first, decoded on the second
   with ``kv_transfer`` over the HTTP wire (forced past the break-even)
   and over the colocated device path: the decode pool's imported pages
   equal the prefill pool's gathered slab (``torch.equal``), the decode
   engine runs no prefill dispatch and captures no graph for them, the
   first token equals and the greedy tokens follow the decode engine's
   own monolithic run up to the near-tie rule.  The pool: a prompt the
   first server published is fetched by the second through the
   ``X-Kaito-KV-Fetch`` headers (one fetch, whole pages, held in its
   store after); a second publish demotes it to disk; a repeat hits the
   disk tier.  Logged: the prefill role's ms, the meta handshake's, wire
   bytes and GB/s, the import's card ms (two synchronizations) against a
   recompute prefill of a prompt of the same length, the device path's
   copy ms, TTFT through a fetch and a disk hit against cold.  Exact:
   ``tiny-llama-real``'s four sections through P/D over both wires,
   pages equal, tokens exact and logprobs within 2e-3 of the goldens
   (``kv_int8`` of a CPU pair's same runs).
16. Fine-tuning (legs ``train-bf16`` and ``train-fp32``).  Through
   ``tuning.trainer.Trainer`` with no output dir, synthetic bf16 weights
   from seed 0 and a seeded instruction/response jsonl in a temp dir, 8
   steps each: LoRA (r 8, alpha 16, q/k/v/o) and QLoRA on Llama-3.1-8B
   at full width with B=4, T=512 (QLoRA's 2048-row products take the
   dequant route), QLoRA at B=1, T=256 (256 rows: K4 under autograd, its
   launch counter must rise), and full fine-tuning of Llama-3.2-1B at
   B=4, T=512.  Logged for each: the loss at each step, the median step
   ms over steps 3-8 (synchronized), tokens/s by the trainer's formula
   and the peak GiB; then one more forward and backward, whose gradient
   on every trainable leaf is finite and non-zero in every layer, and
   every B has moved.  Throughout, no ``quant_matmul_cuda`` call takes an
   x that needs a gradient outside ``QuantMatmulFn`` and the flash
   prefill kernel never launches.  Exact: ``tiny-llama-real`` (LoRA, and
   QLoRA at 64 rows, K4 launching) and ``tiny-moe-real`` (LoRA) in fp32
   from their checkpoints, 5 steps on the CPU and on the card from the
   same weights and factors: losses (rtol 1e-4), grad norms (rtol 1e-3)
   and final leaves (measured in the summed learning rates, since Adam
   moves an element about the learning rate a step: 99% of each leaf
   within 1%, all within 25%, Adam's either-sign step at rounding-level
   gradients excepted) equal; each LoRA run's adapter,
   saved and served by a card engine, gives its first greedy token the
   logprob ``forward_train`` gives it (within 2e-3).
17. The RAG service (legs ``rag-bf16`` and ``rag-fp32``).  One process
   holds the port's RAG server (``kaito_tpu_torch.rag.app``) with
   ``EMBEDDING_MODEL_ID=qwen3-8b``: Qwen3-Embedding-8B's architecture
   (36 layers, hidden 4096, 32 query heads over 8 KV heads of 128, q/k
   norm) uncut in fp32 with synthetic weights from seed 0, ~32.8 GB,
   built first; then the port's OpenAI server on Llama-3.1-8B in bf16
   (phase 4's config, 240 pages of 64) as its upstream.  64 seeded
   documents of 200-1000 bytes (the byte tokenizer cuts at 256 tokens)
   indexed in two calls with metadata: the flash prefill kernel (K2)
   launches 36 times a forward, and no plain ``prefill_attention`` runs
   anywhere in the phase; ``/indexes`` lists the index; 16
   ``/retrieve`` calls, a query equal to a document's text returning that
   document first with score 1, a metadata filter excluding what it
   names; chats with the retrieved context injected under
   ``llm_context_window`` 1024, not streamed and streamed, answered by
   the upstream with their ``max_tokens``; a ``MaxLength`` guardrails
   policy loaded by ``reload_guardrails`` ends a stream and a reply with
   the block message; ``/metrics`` carries the ``kaito_rag:*`` families
   with this phase's counts; ``/persist``, then a second RAG service
   (the first one's embedder released) loading the directory at its
   start retrieves the same ids with scores within 1e-6.  Logged beside
   the card: the embed card ms of each forward and its rows, of one
   64-row forward, documents/s, ``/retrieve`` p50, a chat's TTFT through
   the RAG server against the same injected prompt sent straight to the
   upstream (three rounds each, the prompt's pages cached), the peak
   GiB.  Exact: ``LocalTorchEmbedder`` on ``tiny-llama-real``'s
   checkpoint on the card and on the CPU: 24 texts (the empty text, one
   past 256 bytes, non-ASCII) give vectors within atol 1e-5, a row of no
   token the zero vector on both, K2 four launches a forward, and an
   index over each the same top-5 ids for 8 queries.
18. Start-up from the operator's command line (leg ``startup-int8``).
   The catalog's ``TinyLlama/TinyLlama-1.1B-Chat-v1.0`` at full width
   (22 layers, hidden 2048, 32 query heads over 4 KV heads of 64,
   intermediate 5632, vocab 32000), resolved by the port's hub fetcher
   from the committed catalog; synthetic bf16 weights drawn on the card
   from seed 0 and written under HF names in one ``model.safetensors``
   (2.2 GB), served by a local file server that answers ``Range``.  The
   server starts through ``start_server`` (``main`` less its serving
   loop) from the command line the JAX operator renders for such a
   Workspace (``--model <id> --port P --max-model-len 2048``) plus
   ``--weights-dir http://127.0.0.1:W/`` and ``--kaito-config-file F``
   (``vllm:`` max-num-seqs 4, served-model-name, ``quantization:
   int8``).  While the weights stream and quantize, ``/health`` (polled
   every 20 ms) answers 503 ``loading``, ``/metrics`` carries
   ``kaito:engine_loading 1`` and a POST answers 503; then ``/health``
   200 and ``/v1/models`` the file's name.  The streamed tree equals the
   disk loader's on the same file bit for bit; no shard read is
   unranged.  The command line and env come from the port's operator:
   a Workspace for that id on ``a3-highgpu-1g`` with the annotation
   ``kaito-tpu.io/quantization: int8`` and an ``inference.config``
   ConfigMap, reconciled by the port's ``WorkspaceReconciler`` with its
   Karpenter provisioner over ``FakeCloud`` until ``InferenceReady``.
   Its StatefulSet's engine container must run ``python -m
   kaito_tpu_torch.engine.server --model <id> --port 5000
   --max-model-len 2048 --quantization int8 --kaito-config-file
   /mnt/config/inference_config.yaml``, request and limit
   ``nvidia.com/gpu: "1"``, and select the fake node by its labels; the
   phase serves that argv with the port and the config path mapped to
   its own and ``--weights-dir`` added, under the container's env.  Four streamed chats of 64 greedy tokens: one alone (a
   ~190-token prompt), then three admitted together (one packed
   prefill); ``/ui`` answers the page and one chat goes through the
   standalone UI proxy.  K1, K2, K3 and K4 (decode rows and the wide
   path), zeroed just before the start, must each launch in this
   process, and K1q and K5 must not.  Logged beside the card: the
   ``KAITO_WEIGHTS_STREAM_RESULT`` line's seconds, bytes and MiB/s, the
   load's seconds, TTFT and tok/s of the four chats, the phase's
   seconds.  Phase 2 holds K4 at TinyLlama's four projection shapes
   (1-256 rows) and times it at gate/up with 4 and 200 rows; K1, K2 and
   K3 at its head dim 64 and 8 query heads a KV head are the gpt-oss-20b
   cases there.
19. The SKU catalog and the estimator against the card (no model of its
   own).  Node labels made from the card as GPU feature discovery makes
   them (``torch.cuda.get_device_name()`` with spaces as ``-``, total
   memory in MiB, the count) resolve through the BYO lookup to the
   catalog's H100 entry, whose memory is within 1% of the card's.  For
   the engines of phase 4 (bf16), phase 5 (int4 + int8 KV; int8) and
   phase 18 (TinyLlama, int8), the estimator's weight bytes must be no
   less than the engine's ``param_bytes()``, and its KV tokens for a
   one-card plan no more than the tokens the engine's measured free
   memory holds after its reserve (before the ``max_num_seqs`` cap).
   Both, and their ratio, are logged beside the CUDA context measured at
   the script's start.
20. The operator's manager closes its loop on the card (leg
   ``manager-int8``).  The port's ``Manager`` (gates
   ``enableInferenceSetController``, ``autoscaler``) over the in-memory
   store, with its Karpenter provisioner over ``FakeCloud`` (nodes only:
   no fake kubelet), its metrics server on 127.0.0.1:0 and its fleet
   plane scraping every second; an InferenceSet of phase 18's TinyLlama
   on ``a3-highgpu-1g`` (int8, phase 18's config map), one replica,
   autoscaling 1-2 with a 3 s sustain, 2 s of stabilization and 2 s of
   cooldown (the phase's own values, logged).  The child Workspace's
   pod (command, env, resources, node selector) must equal phase 18's,
   names apart; the phase serves it through ``start_server`` (weights
   written and streamed again), points the fleet's scrape-URL
   annotation at it and marks its StatefulSet ready once ``/health``
   answers.  One chat alone, then idle: three scrapes, the signal
   nominal, one replica, the fleet's folded running, waiting, KV and
   request samples equal to the server's own ``/metrics``.  Then 24
   clients chat 64 tokens in a loop against ``max-num-seqs`` 4: the
   signal must leave nominal within 7 s, the autoscaler take
   ``spec.replicas`` to 2 and the second child's pod equal the first's
   (it is not served; its Service name is never resolved).  After it:
   every enabled controller counted ``result="ok"`` reconciles on the
   manager's ``/metrics`` and none ``"error"``, the ``kaito:fleet_*``
   gauges are there, K1-K4 launched in the serving process and K1q/K5
   did not.  Host only: a RAGEngine on ``a3-highgpu-1g`` renders the
   port's RAG app on one ``nvidia.com/gpu`` with an env the port's
   ``RAGConfig`` reads; a GPU InferenceSet under the Gateway API gate
   renders its InferencePool and the port's picker
   (``kaito_tpu_torch.runtime.epp`` from the GPU image), no
   ``EPPUnavailable``.  Every thread and server the phase started is
   gone at the next phase start, which is logged.
21. The runtime services (leg ``services-int8``), under the same refusal
   of every name lookup but the loopback.  The port's manager (gates
   ``enableInferenceSetController``, ``gatewayAPIInferenceExtension``)
   renders phase 18's TinyLlama as an InferenceSet of two replicas on
   ``a3-highgpu-1g``: each child's pod runs phase 18's command on one
   ``nvidia.com/gpu`` with the port's benchmark probe as its startup
   probe, and the pool's ``extensionRef`` names a Deployment running
   ``kaito_tpu_torch.runtime.epp`` from the GPU image over both.  Two
   replicas uncut (int8, phase 18's config file, ``--max-pages 512``
   each, one checkpoint from seed 0 read from disk) served through
   ``start_server`` from that command and env; the picker a child
   process from the Deployment's command (its ``--backend`` URLs the
   loopback ports), the round-robin ``dp_router`` another.  A chat on
   each replica captures its windows, three admitted together on the
   first launch K3.  Eight sessions (a 1536-char system prefix of
   their own, four turns of 32 greedy tokens) through the picker: each
   session's turns 2-4 reach its turn 1's replica (by the replicas'
   request counters) and the picker counts 24 affinity hits; eight
   fresh sessions through the round robin; the picker's share of
   prompt tokens served from the prefix caches at least the round
   robin's (each front's share and TTFT p50 logged).  The same prompt
   on both replicas gives the same greedy tokens.  Replica B stopped:
   eight requests through each front answer 200 from A and each
   front's ``/metrics`` shows B's breaker not closed;
   ``python -m kaito_tpu_torch.runtime.health --role leader`` exits 0
   for A and 1 for B; ``python -m kaito_tpu_torch.runtime.benchmark_probe
   --duration 10 --input-len 512 --output-len 64`` on A exits 0 with
   ``generation_tokens > 0``.  K1, K2, K3 and K4 launched in the
   replicas, K1q and K5 did not; each front, sent SIGTERM, drains and
   exits 0.  Last, the HF fallback: GPT-2 at ``GPT2Config()``'s widths
   (12 layers, 768 wide, 12 heads, vocab 50257) drawn from seed 0 on a
   thread from the phase's start and saved locally (``safetensors``
   where it imports), served as a child process from the command the
   port's operator renders for its Workspace on ``a3-highgpu-1g``
   (``kaito_tpu_torch.runtime.hf_fallback --device cuda`` on one
   ``nvidia.com/gpu``; ``KAITO_OFFLINE=1``): ``/health`` names a CUDA
   device, a 32-token chat and a 16-token SSE stream are answered, and
   the port's fallback on the card gives the CPU's logits for 64 ids
   within 1e-3.  Logged: each replica's pages and GiB, whether
   ``safetensors`` and ``huggingface_hub`` import, the probe's result,
   the fallback's load seconds and tok/s.

Every phase start hands back the cuBLAS workspaces the phases before it
left (one per stream a finished engine used, 32 MiB each) and logs what
they left in the process (live threads and OS threads, engines and
servers never closed, the port's CUDA graph holders, child processes,
device memory allocated and reserved, the host microseconds of an eager
launch); phases 4, 9 and 18 also the largest CUDA tensors still alive
and what holds them, and the CPU each OS thread of the process and each
process of the machine took over one second.  Phase 9 logs its garbage collections while acme is timed.

The last three lines of standard output are the card line, one JSON
object with the kernel records, and ``{"ok": true, "device": ...}``.
``--phase2-only`` stops after phase 2 and prints the kernel records
(without launch counts) and no result line; ``--first-leg-only`` skips
phase 3 and every server leg after phase 4's bf16 one (with
``--profile``, the quickest reading of TTFT and prefill device time)
and prints no result line either; nor does ``--leg NAME`` (one of
``bf16``, ``int4-kv8``, ``int8``, ``bf16-async``, ``tp2-int4-kv8``,
``tp2-int8``, ``moe-bf16``, ``mla-bf16``, ``mla-int8-kv8``, ``qos-bf16``,
``spec-bf16``, ``grammar-bf16``, ``adapter-bf16``, ``adapter-fp32``,
``families-bf16``, ``families-fp32``, ``devprof-bf16``, ``offload-bf16``,
``pd-bf16``, ``train-bf16``, ``train-fp32``, ``rag-bf16``, ``rag-fp32``,
``startup-int8``, which runs phase 19 after it on its one engine,
``manager-int8``, ``services-int8``), which
builds the kernels and runs that server leg alone, phases 2 and 3
skipped: with ``--profile``, the quickest reading of a leg's TTFT and of
its quantized matmuls' device time per 200-token prefill, in one call
for a parent tree and this one.  ``--sweep-run-ahead`` adds
a decode sweep over ``decode_run_ahead`` at
full width, with the rule that picks the engine's CUDA auto value
(:func:`pick_run_ahead`; PERF.md).  On a machine with two cards or more,
each phase 6 leg runs on the first two cards and again with both shards
on the first card, so one run compares a real ring hop with none.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_ATOL, BF16_ATOL = 1e-4, 2e-2
BIG = 1 << 30
SLEEP_CYCLES = 100_000_000   # ~50 ms of GPU clock: longer than any queue of calls
T_START = time.perf_counter()   # reset when main() starts


# every kernel of the port: (record name, wrapper module, wrapper, the
# wrapper's launch counter for that kernel)
_OPS = "kaito_tpu_torch.engine.ops."
KERNELS = (
    ("paged_decode_attention", _OPS + "decode_attention",
     "paged_decode_attention_cuda", "launches"),
    ("flash_prefill_attention", _OPS + "flash_prefill",
     "flash_prefill_attention_cuda", "launches"),
    ("flash_prefill_packed", _OPS + "flash_prefill",
     "flash_prefill_packed_cuda", "launches"),
    ("paged_decode_attention_int8kv", _OPS + "decode_attention",
     "paged_decode_attention_cuda", "launches_q"),
    ("quant_matmul_int8", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int8"),
    ("quant_matmul_int4", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int4"),
    ("quant_matmul_int8_pf", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int8_pf"),
    ("quant_matmul_int4_pf", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int4_pf"),
)


# K4/K5's launches on the wide (prefill-row) path: (counter name, the
# kernel record it belongs to, the wrapper's counter)
WIDE_COUNTERS = (
    ("quant_matmul_int8_wide", "quant_matmul_int8", "launches_int8_wide"),
    ("quant_matmul_int4_wide", "quant_matmul_int4", "launches_int4_wide"),
)


class SmokeFailure(RuntimeError):
    pass


def _counter(name):
    """(wrapper, counter attribute) of the kernel record or wide-path
    counter ``name``."""
    for wide, record, attr in WIDE_COUNTERS:
        if name == wide:
            return _counter(record)[0], attr
    _, mod, fn, attr = next(k for k in KERNELS if k[0] == name)
    return getattr(importlib.import_module(mod), fn), attr


def log(msg: str) -> None:
    """A line on stderr, stamped with the seconds since the run started."""
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(card ms, host ms) per call of ``fn``.  A sleep kernel holds the
    stream while the host queues all ``iters`` calls, so the CUDA events
    time the card's work back to back, not the rate at which Python
    issues it; the host time is how long each call held the issuing
    thread."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# Decode lengths of phase 2: eight live sequences up to 2048 tokens
K1_LENGTHS = [2048, 1, 37, 511, 1000, 1536, 64, 1999]
K1_SINGLE = [230] + [0] * 7      # one live sequence, seven idle rows (length 0)


def _path_pages_per_seq() -> int:
    """Page-table width of the full-width config when a sequence reaches
    its context limit (the widest table the engine passes to K1)."""
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.models.registry import get_model_by_name

    md = get_model_by_name("llama-3.1-8b-instruct")
    return EngineConfig(model=md.name,
                        max_model_len=min(md.max_model_len, 8192)).pages_per_seq


def _decode_case(torch, dtype, lengths, window, softcap, gen, pmax, H=32, Hkv=8,
                 D=128):
    B, ps, L = len(lengths), 64, 2
    P = B * pmax + 57
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(L, P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    cv = torch.randn(L, P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    # pages scattered through the pool; page 0 stays the null page
    perm = torch.randperm(P - 1, generator=gen, device="cuda")[: B * pmax] + 1
    pt = perm.reshape(B, pmax).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    args = (q, ck, cv, pt, lens, window)
    kw = dict(scale=1.0 / math.sqrt(D), softcap=softcap, layer=1)
    return args, kw


def _quantize_pool(torch, pool):
    """A [L, P, ps, Hkv, D] pool as int8 codes and fp32 scales per
    (layer, page, head), as the int8 page writes leave them."""
    x = pool.float()
    scale = x.abs().amax(dim=(2, 4)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(x / safe[:, :, None, :, None]).clamp(-127, 127)
    return codes.to(torch.int8), scale.contiguous()


def _time_decode(torch, args, kw, label):
    """K1 (or K1q, when ``kw`` holds scales), its plain version and SDPA
    on one bf16 case; SDPA attends over the live pages gathered (and
    dequantized) into a contiguous [B, Hkv, S, D] copy in q's dtype (the
    gather itself is not timed)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    q, ck, cv, pt, lens, window = args
    B, H, D = q.shape
    Hkv, ps = ck.shape[3], ck.shape[2]
    quant = kw.get("k_scale") is not None
    ms, host_ms = time_ms(lambda: paged_decode_attention_cuda(*args, **kw))
    plain_ms = time_ms(lambda: paged_decode_attention_plain(*args, **kw), iters=5)[0]
    n_pg = -(-int(lens.max()) // ps)
    S = n_pg * ps
    live_pt = pt[:, :n_pg].long()

    def gathered(pool, scale):
        x = pool[1][live_pt]
        if scale is not None:
            x = x.float() * scale[1][live_pt][:, :, None, :, None]
        return x.to(q.dtype).reshape(B, S, Hkv, D).transpose(1, 2).contiguous()

    kg, vg = gathered(ck, kw.get("k_scale")), gathered(cv, kw.get("v_scale"))
    key = torch.arange(S, device="cuda")[None, :]
    mask = (key < lens[:, None].long()) & (key >= lens[:, None].long() - window)
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask,
                                      scale=kw["scale"], enable_gqa=True))[0]
    # the keys this run attends over: a window keeps the last ``window``
    live = int(lens.clamp(max=window).sum())
    el = q.element_size()
    nbytes = 2 * B * H * D * el + 2 * live * Hkv * D * ck.element_size() \
        + pt.numel() * 4 + B * 4
    if quant:
        # the fp32 k and v scales of every live page and KV head
        nbytes += 2 * sum(-(-min(int(n), window) // ps) for n in lens.tolist()) \
            * Hkv * 4
    b_ms, b_by = bound(nbytes, 4.0 * live * H * D)
    log(f"{'K1q' if quant else 'K1'} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"SDPA {library_ms:.4f}, bound {b_ms:.5f} by {b_by}; host {host_ms:.4f} ms "
        f"per call)")
    return dict(case=label, table_width=pt.shape[1], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, host_ms=host_ms)


def _build_lines(build_logs, source, kernel=""):
    """ptxas's entry, register and spill lines for csrc/``source`` (empty
    when the library was already built), only those of the kernels whose
    mangled name holds ``kernel``; and the spill lines among them, each
    with its kernel's name (a spill is a defect)."""
    lines, spills, name = [], [], ""
    for ln in build_logs.get(source, "").splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
        if kernel not in name or not any(w in ln for w in ("entry function", "registers",
                                                           "spill")):
            continue
        lines.append(ln.strip())
        if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
            spills.append(f"{name}: {ln.strip()}")
    return lines, spills


def _seq_rel_err(out, ref) -> float:
    """The worst error of a sequence of a [B, H, D] output relative to
    that sequence's largest magnitude."""
    diff = (out.float() - ref.float()).abs().flatten(1).amax(dim=1)
    return (diff / ref.float().abs().flatten(1).amax(dim=1).clamp_min(1e-30)).max().item()


def _decode_errs(out, ref) -> tuple[float, float]:
    """(absolute, per-sequence relative) error of a K1/K1q output."""
    return (out.float() - ref.float()).abs().max().item(), _seq_rel_err(out, ref)


def _dropped_split_reading(torch, args, kw, sms):
    """What the checks read for a kernel that loses the second split of
    the longest sequence (global window): the plain version with that
    split's pages left out of the sequence, against the plain version.
    Returns (absolute, relative to the batch's largest magnitude,
    per-sequence relative)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        decode_plan, decode_split, paged_decode_attention_plain)

    q, ck, cv, pt, lens, win = args
    B, H, D = q.shape
    ps, Hkv = ck.shape[2], ck.shape[3]
    b = int(lens.argmax())
    n = int(lens[b])
    _, t0, t1, n_live = decode_split(n, win, ps, decode_plan(B, H, Hkv, D, sms).n_split, 1)
    if n_live < 3:
        raise SmokeFailure(f"the longest sequence has {n_live} splits, not a middle one")
    pt2, lens2 = pt.clone(), lens.clone()
    keep = torch.cat([pt[b, :t0 // ps], pt[b, t1 // ps:]])
    pt2[b, :keep.numel()] = keep
    lens2[b] = n - (t1 - t0)
    ref = paged_decode_attention_plain(*args, **kw).float()
    bad = paged_decode_attention_plain(q, ck, cv, pt2, lens2, win, **kw).float()
    e = (bad - ref).abs().max().item()
    return e, e / ref.abs().max().item(), _seq_rel_err(bad, ref)


def _check_decode_graph(torch, full, gen, heads=None):
    """One K1 and one K1q call (bf16, the main case; at ``heads``, a dict
    of H, Hkv and D, when given) captured in a CUDA graph and replayed after new lengths and page-table contents are
    copied into the static inputs; each replay against the plain version.
    Before the replays, an eager call at a batch whose plan needs more
    scratch and counters: the workspace must not move under the graph.
    Returns the worst error of each (K1 the larger of absolute and
    per-sequence relative, K1q per-sequence relative)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain, workspace)

    heads = heads or {}
    worst = {}
    for quant in (False, True):
        args, kw = _decode_case(torch, torch.bfloat16, K1_LENGTHS, BIG, None, gen, full,
                                **heads)
        q, ck, cv, pt, lens, win = args
        if quant:
            (ck, ks), (cv, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
            kw = dict(kw, k_scale=ks, v_scale=vs)
        run = lambda: paged_decode_attention_cuda(q, ck, cv, pt, lens, win, **kw)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        ws = workspace(q.device)
        ptrs = (ws.part.data_ptr(), ws.counters.data_ptr())
        big, bkw = _decode_case(torch, torch.bfloat16, [300 + 37 * i for i in range(16)],
                                BIG, None, gen, 20, **heads)
        if quant:
            (k8, ks), (v8, vs) = _quantize_pool(torch, big[1]), _quantize_pool(torch, big[2])
            big, bkw = (big[0], k8, v8) + big[3:], dict(bkw, k_scale=ks, v_scale=vs)
        eb, rb = _decode_errs(paged_decode_attention_cuda(*big, **bkw),
                              paged_decode_attention_plain(*big, **bkw))
        err = rb if quant else max(eb, rb)
        if (ws.part.data_ptr(), ws.counters.data_ptr()) != ptrs:
            raise SmokeFailure("the decode workspace moved under a captured graph")
        del big
        for lengths in (list(reversed(K1_LENGTHS)), K1_SINGLE, [4000, 0, 1, 2, 3, 64, 65,
                                                                 8000]):
            lens.copy_(torch.tensor(lengths, dtype=torch.int32))
            P = ck.shape[1]
            pt.copy_((torch.randperm(P - 1, generator=gen, device="cuda")[:pt.numel()]
                      + 1).reshape(pt.shape).to(torch.int32))
            graph.replay()
            ref = paged_decode_attention_plain(q, ck, cv, pt, lens, win, **kw).float()
            torch.cuda.synchronize()
            e, r = _decode_errs(out, ref)
            err = max(err, r if quant else max(e, r))
        worst["K1q" if quant else "K1"] = err
        del graph
    log(f"K1/K1q CUDA graph replays {heads or ''} (new lengths and tables): max err "
        f"{worst}")
    if worst["K1"] > BF16_ATOL or worst["K1q"] > BF16_ATOL:
        raise SmokeFailure(f"K1/K1q replayed from a CUDA graph disagree: {worst}")
    return worst


def check_decode(torch, records, build_logs):
    from kaito_tpu_torch.engine.ops.decode_attention import (
        decode_plan, paged_decode_attention_cuda, paged_decode_attention_plain,
        workspace)

    lines, spills = _build_lines(build_logs, "decode_attention.cu")
    for ln in lines:
        log(f"  decode_attention.cu: {ln}")
    if spills:
        raise SmokeFailure(f"decode_attention.cu spills: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (len(K1_LENGTHS), 1):
        plan = decode_plan(B, 32, 8, 128, sms)
        log(f"K1/K1q plan, B={B} H=32 Hkv=8 D=128 on {sms} SMs: n_split "
            f"{plan.n_split}, {plan.ctas} CTAs, {plan.scratch_floats} scratch floats "
            f"(any table width)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    full = _path_pages_per_seq()
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    err_r, err_q = dict(err), dict(err)
    cases = [(K1_LENGTHS, w, c) for w, c in ((BIG, None), (300, None), (BIG, 30.0))]
    cases.append((K1_SINGLE, BIG, None))
    for dtype in (torch.bfloat16, torch.float32):
        for lengths, window, softcap in cases:
            args, kw = _decode_case(torch, dtype, lengths, window, softcap, gen,
                                    full)
            out = paged_decode_attention_cuda(*args, **kw)
            ref = paged_decode_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            e, r = _decode_errs(out, ref)
            err[dtype] = max(err[dtype], e)
            err_r[dtype] = max(err_r[dtype], r)
            # K1q over the same pools quantized to int8
            (q, ck, cv, pt, lens, win) = args
            (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
            qargs, qkw = (q, k8, v8, pt, lens, win), dict(kw, k_scale=ks, v_scale=vs)
            out = paged_decode_attention_cuda(*qargs, **qkw)
            ref = paged_decode_attention_plain(*qargs, **qkw).float()
            torch.cuda.synchronize()
            eq = _seq_rel_err(out, ref)
            err_q[dtype] = max(err_q[dtype], eq)
            log(f"K1/K1q {dtype} lengths={lengths} window={window} softcap={softcap} "
                f"page table width {full}: K1 max err {e:.3g}, per sequence "
                f"relative {r:.3g} / K1q per sequence relative {eq:.3g}")
    for name, bad in (("K1", err), ("K1 per sequence", err_r)):
        if bad[torch.bfloat16] > BF16_ATOL or bad[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {bad}")
    if err_q[torch.bfloat16] > BF16_ATOL or err_q[torch.float32] > FP32_ATOL:
        raise SmokeFailure(f"K1q disagrees with its plain version: {err_q}")
    if workspace(torch.device("cuda", 0)).counters.any():
        raise SmokeFailure("K1/K1q left a merge counter above zero")
    # a kernel that loses one split must fail the per-sequence check
    args, kw = _decode_case(torch, torch.bfloat16, K1_LENGTHS, BIG, None, gen, full)
    q, ck, cv, pt, lens, win = args
    (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
    dropped = {"K1": _dropped_split_reading(torch, args, kw, sms),
               "K1q": _dropped_split_reading(torch, (q, k8, v8, pt, lens, win),
                                             dict(kw, k_scale=ks, v_scale=vs), sms)}
    del args, ck, cv, k8, v8
    for name, (e, rel, seq) in dropped.items():
        log(f"{name} with the second split of the longest sequence lost: max err "
            f"{e:.3g}, relative to the batch {rel:.3g}, per sequence {seq:.3g}")
        if seq <= BF16_ATOL:
            raise SmokeFailure(f"{name}'s check does not see a lost split: {seq}")
    graph_err = _check_decode_graph(torch, full, gen)
    # timed at the widest page table the engine passes, and at the live
    # width it passes when no sequence is longer than these
    timed = []
    for lengths, pmax, label in (
            (K1_LENGTHS, full, f"8 live sequences <= 2048 tokens, table width {full}"),
            (K1_LENGTHS, 2048 // 64, "8 live sequences <= 2048 tokens, table width 32"),
            (K1_SINGLE, full, f"1 live sequence of 230 tokens, table width {full}"),
            (K1_SINGLE, 4, "1 live sequence of 230 tokens, table width 4")):
        args, kw = _decode_case(torch, torch.bfloat16, lengths, BIG, None, gen, pmax)
        timed.append(_time_decode(torch, args, kw, label))
    main = timed[0]
    plan = decode_plan(len(K1_LENGTHS), 32, 8, 128, sms)
    records["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="kaito_tpu_torch/csrc/decode_attention.cu",
        replaces="kaito_tpu/engine/ops/decode_attention.py:199",
        shape=f"B=8 H=32 Hkv=8 D=128 ps=64 lengths<=2048 table width {full} bf16",
        max_abs_err=err[torch.bfloat16], max_err_bf16=err[torch.bfloat16],
        max_err_fp32=err[torch.float32], max_seq_rel_err_bf16=err_r[torch.bfloat16],
        max_seq_rel_err_fp32=err_r[torch.float32], lost_split_err=dropped["K1"],
        graph_replay_err=graph_err["K1"],
        ms=main["ms"], kernel_ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        host_ms=main["host_ms"], n_split=plan.n_split, ctas=plan.ctas, cases=timed)
    # K1q at the main case, at both table widths: the same pools quantized
    # to int8
    timed_q = []
    for pmax, label in ((full, timed[0]["case"]), (2048 // 64, timed[1]["case"])):
        args, kw = _decode_case(torch, torch.bfloat16, K1_LENGTHS, BIG, None, gen, pmax)
        (q, ck, cv, pt, lens, win) = args
        (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
        del ck, cv
        timed_q.append(_time_decode(torch, (q, k8, v8, pt, lens, win),
                                    dict(kw, k_scale=ks, v_scale=vs), label))
    tq = timed_q[0]
    records["paged_decode_attention_int8kv"] = dict(
        name="paged_decode_attention_int8kv", route="cuda",
        source="kaito_tpu_torch/csrc/decode_attention.cu",
        replaces="kaito_tpu/engine/ops/decode_attention.py:76",
        shape=f"B=8 H=32 Hkv=8 D=128 ps=64 lengths<=2048 table width {full} "
              f"bf16 q, int8 pages + fp32 scales",
        max_abs_err=err_q[torch.bfloat16], max_rel_err_bf16=err_q[torch.bfloat16],
        max_rel_err_fp32=err_q[torch.float32], lost_split_err=dropped["K1q"],
        graph_replay_err=graph_err["K1q"],
        ms=tq["ms"], kernel_ms=tq["ms"],
        plain_ms=tq["plain_ms"], bound_ms=tq["bound_ms"], bound_by=tq["bound_by"],
        library_ms=tq["library_ms"], host_ms=tq["host_ms"], n_split=plan.n_split,
        ctas=plan.ctas, cases=timed_q)
    check_decode_gpt_oss(torch, records, sms, gen, full)


# gpt-oss-20b's attention: 64 query heads over 8 KV heads, head_dim 64; a
# window of 128 tokens on every other layer
GPT_OSS_HEADS = dict(H=64, Hkv=8, D=64)


def check_decode_gpt_oss(torch, records, sms, gen, full):
    """K1 and K1q at gpt-oss-20b's decode shape (8 query heads per KV
    head at head_dim 64), global and with its window of 128, against
    their plain versions in bf16 and fp32; timed in bf16 beside SDPA and
    the bound.  Kept in the K1 and K1q records under ``gpt_oss_20b``."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        decode_plan, paged_decode_attention_cuda, paged_decode_attention_plain)

    B = len(K1_LENGTHS)
    plan = decode_plan(B, **GPT_OSS_HEADS, sms=sms)
    log(f"K1/K1q plan, B={B} H=64 Hkv=8 D=64 on {sms} SMs: n_split {plan.n_split}, "
        f"{plan.ctas} CTAs, {plan.scratch_floats} scratch floats")
    err = {("K1", torch.bfloat16): 0.0, ("K1", torch.float32): 0.0,
           ("K1q", torch.bfloat16): 0.0, ("K1q", torch.float32): 0.0}
    timed = {"K1": [], "K1q": []}
    for dtype in (torch.bfloat16, torch.float32):
        for window in (BIG, 128):
            args, kw = _decode_case(torch, dtype, K1_LENGTHS, window, None, gen, full,
                                    **GPT_OSS_HEADS)
            out = paged_decode_attention_cuda(*args, **kw)
            ref = paged_decode_attention_plain(*args, **kw)
            q, ck, cv, pt, lens, win = args
            (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
            qargs, qkw = (q, k8, v8, pt, lens, win), dict(kw, k_scale=ks, v_scale=vs)
            outq = paged_decode_attention_cuda(*qargs, **qkw)
            refq = paged_decode_attention_plain(*qargs, **qkw).float()
            torch.cuda.synchronize()
            e = max(_decode_errs(out, ref))
            eq = _seq_rel_err(outq, refq)
            err["K1", dtype] = max(err["K1", dtype], e)
            err["K1q", dtype] = max(err["K1q", dtype], eq)
            log(f"K1/K1q {dtype} H=64 Hkv=8 D=64 window={window}: K1 max err "
                f"(absolute or per sequence) {e:.3g} / K1q per sequence relative "
                f"{eq:.3g}")
            if dtype == torch.bfloat16:
                label = f"gpt-oss-20b B=8 H=64 Hkv=8 D=64 window {window}"
                timed["K1"].append(_time_decode(torch, args, kw, label))
                timed["K1q"].append(_time_decode(torch, qargs, qkw, label))
            del args, ck, cv, k8, v8
    for name in ("K1", "K1q"):
        bad = {str(d): err[name, d] for d in (torch.bfloat16, torch.float32)}
        if err[name, torch.bfloat16] > BF16_ATOL or err[name, torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} at gpt-oss-20b's shape disagrees with its "
                               f"plain version: {bad}")
        rec = records["paged_decode_attention" if name == "K1"
                      else "paged_decode_attention_int8kv"]
        rec["gpt_oss_20b"] = dict(
            shape=f"B=8 H=64 Hkv=8 D=64 ps=64 lengths<=2048 table width {full} bf16",
            max_err_bf16=err[name, torch.bfloat16], max_err_fp32=err[name, torch.float32],
            n_split=plan.n_split, ctas=plan.ctas, cases=timed[name])


# projection shapes of Llama-3.1-8B, [K, N]
PROJ_SHAPES = {"q/o": (4096, 4096), "k/v": (4096, 1024),
               "gate/up": (4096, 14336), "down": (14336, 4096)}
L2_BYTES = 50 << 20


def _cold_cycle(tensors_of, nbytes):
    """Copies of a weight (``tensors_of()`` makes one) that together
    exceed twice the L2, and a function handing out the next one."""
    copies = [tensors_of() for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
    it = iter(range(1 << 62))
    return lambda: copies[next(it) % len(copies)]


# K4/K5 rows checked at every projection shape (1-16: the decode-row path
# in bf16, 17-256 the wide path) and timed: every shape at 1, 8, 16 and
# 200 rows, gate/up also at these
QM_CHECK_ROWS = (1, 5, 8, 9, 16, 17, 64, 65, 200, 256)
QM_TIME_ROWS = (1, 8, 16, 200)
QM_TIME_ROWS_GATE_UP = (1, 8, 16, 64, 200, 256)


def check_quant_matmul(torch, records, build_logs):
    """K4 and K5 against their plain version at the projection shapes,
    rows 1-256 (``QM_CHECK_ROWS``), bf16 and fp32, with the wide-path
    counter growing on every bf16 call of 17-256 rows; then timed in bf16
    at 1, 8, 16 and 200 rows (gate/up also at 64 and 256) beside
    torch.matmul against the dequantized bf16 weight.  The decode-row
    path's ptxas lines are logged (a spill fails the run), its plan at
    each shape too, and its merge counters must read zero after the
    checks."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import dequant_weight, quantize_weight

    lines, spills = _build_lines(build_logs, "quant_matmul.cu", "decode_kernel")
    for ln in lines:
        log(f"  quant_matmul.cu decode rows: {ln}")
    if spills:
        raise SmokeFailure(f"quant_matmul.cu's decode-row kernels spill: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (K, N) in dict(PROJ_SHAPES, **{f"TP=2 {k} chunk": (K, N // 2)
                                               for k, (K, N) in PF_SHAPES.items()}).items():
        for scheme in ("int8", "int4"):
            p = qm.decode_plan(8, K, N, K // 128 if scheme == "int4" else 1,
                               scheme == "int4", sms)
            log(f"decode-row plan {scheme} {label} [{K}x{N}] at 8 rows: "
                f"{N // qm.DECODE_TN * p.n_split} CTAs, {p.n_split} K slices of "
                f"{p.kc} in-rows")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for scheme, name, replaces in (
            ("int8", "quant_matmul_int8", "kaito_tpu/engine/ops/quant_matmul.py:109"),
            ("int4", "quant_matmul_int4", "kaito_tpu/engine/ops/quant_matmul.py:129")):
        err = {torch.bfloat16: 0.0, torch.float32: 0.0}
        err_wide = 0.0
        timed = []
        wide = f"launches_{scheme}_wide"
        for label, (K, N) in PROJ_SHAPES.items():
            w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda")
                                / math.sqrt(K), scheme)
            for rows in QM_CHECK_ROWS:
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(rows, K, generator=gen, device="cuda").to(dtype)
                    before = getattr(quant_matmul_cuda, wide)
                    out = quant_matmul_cuda(x, w)
                    ref = quant_matmul_plain(x, w).float()
                    torch.cuda.synchronize()
                    e = (out.float() - ref).abs().max().item() / max(
                        ref.abs().max().item(), 1e-30)
                    err[dtype] = max(err[dtype], e)
                    on_wide = dtype == torch.bfloat16 and 16 < rows <= 256
                    if getattr(quant_matmul_cuda, wide) - before != int(on_wide):
                        raise SmokeFailure(f"{name} {label} rows {rows} {dtype}: the "
                                           f"wide path's counter did not follow")
                    if on_wide:
                        err_wide = max(err_wide, e)
            log(f"{name} {label} [{K}x{N}] rows {QM_CHECK_ROWS}: max relative err "
                f"bf16 {err[torch.bfloat16]:.3g} (wide path {err_wide:.3g}) fp32 "
                f"{err[torch.float32]:.3g}")
            for rows in (QM_TIME_ROWS_GATE_UP if label == "gate/up" else QM_TIME_ROWS):
                timed.append(_time_quant_matmul(torch, w, rows, K, N, scheme,
                                                f"{label} [{K}x{N}] rows {rows}",
                                                gen, dequant_weight))
            del w
        if err[torch.bfloat16] > BF16_ATOL or err[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {err}")
        if qm.decode_workspace(torch.device("cuda", 0)).counters.any():
            raise SmokeFailure(f"{name}: a decode-row merge counter is not back at zero")
        main = next(t for t in timed if t["case"].startswith("gate/up") and
                    t["case"].endswith("rows 8"))
        prefill = next(t for t in timed if t["case"].startswith("gate/up") and
                       t["case"].endswith("rows 200"))
        records[name] = dict(
            name=name, route="cuda", source="kaito_tpu_torch/csrc/quant_matmul.cu",
            replaces=replaces,
            shape=f"x [8, 4096] bf16 @ {scheme} W [4096, 14336] (gate/up)",
            max_abs_err=err[torch.bfloat16], max_rel_err_bf16=err[torch.bfloat16],
            max_rel_err_wide=err_wide, max_rel_err_fp32=err[torch.float32],
            prefill_ms=prefill["ms"], prefill_library_ms=prefill["library_ms"],
            prefill_bound_ms=prefill["bound_ms"], ms=main["ms"], kernel_ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            host_ms=main["host_ms"], cases=timed)


# the int8 projections of DeepSeek-V3 (phase 8's mla-int8-kv8 leg), [K, N]:
# kv_a's 576 columns are no whole number of 128-column tiles, so it takes
# the CUDA-core path
DEEPSEEK_PROJ_SHAPES = {"kv_a": (7168, 576), "q_a": (7168, 1536), "q_b": (1536, 24576),
                        "o": (16384, 7168), "dense gate/up": (7168, 18432),
                        "dense down": (18432, 7168), "shared gate/up": (7168, 2048),
                        "shared down": (2048, 7168)}
DEEPSEEK_ROWS = (1, 8, 16, 17, 200, 256)


# TinyLlama-1.1B's projections (phase 18's model): q/o 2048x2048, k/v
# 2048x256 (4 KV heads of 64), gate/up 2048x5632, down 5632x2048; decode
# rows up to the config file's 4 sequences, and prefill rows
TINYLLAMA_PROJ_SHAPES = {"q/o": (2048, 2048), "k/v": (2048, 256),
                         "gate/up": (2048, 5632), "down": (5632, 2048)}
TINYLLAMA_ROWS = (1, 4, 16, 17, 200, 256)


def check_quant_matmul_deepseek(torch, records):
    """K4 and K5 at DeepSeek-V3's projection shapes
    (:func:`check_quant_matmul_shapes`, under ``deepseek_v3``)."""
    check_quant_matmul_shapes(torch, records, "DeepSeek-V3", "deepseek_v3",
                              DEEPSEEK_PROJ_SHAPES, DEEPSEEK_ROWS, ("int8", "int4"))


def check_quant_matmul_tinyllama(torch, records):
    """K4 at TinyLlama-1.1B's projection shapes (phase 18 serves it in
    int8; :func:`check_quant_matmul_shapes`, under ``tinyllama``), and
    K4 timed at gate/up with 4 rows (a decode step of the config file's
    4 sequences) and 200 rows (a prefill)."""
    check_quant_matmul_shapes(torch, records, "TinyLlama-1.1B", "tinyllama",
                              TINYLLAMA_PROJ_SHAPES, TINYLLAMA_ROWS, ("int8",))
    from kaito_tpu_torch.engine.quant import dequant_weight, quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    K, N = TINYLLAMA_PROJ_SHAPES["gate/up"]
    w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K),
                        "int8")
    records["quant_matmul_int8"]["tinyllama_timed"] = [
        _time_quant_matmul(torch, w, rows, K, N, "int8",
                           f"TinyLlama gate/up [{K}x{N}] {rows} rows", gen,
                           dequant_weight)
        for rows in (4, 200)]


def check_quant_matmul_shapes(torch, records, model, key, shapes, row_counts, schemes):
    """K4 and K5 (``schemes``) against their plain version at ``model``'s
    projection ``shapes``, bf16, at ``row_counts`` rows (decode rows,
    both sides of the wide path's lower edge, and prefill rows): each
    call must launch once, on the wide path exactly when the wrapper says
    it takes it, and agree within the phase's bf16 tolerance relative to
    the output's largest magnitude.  Each shape's path at each row count,
    its worst error and the launches this check made go into the kernel
    record under ``key``."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for scheme in schemes:
        name = f"quant_matmul_{scheme}"
        int4 = scheme == "int4"
        per_shape = {}
        for label, (K, N) in shapes.items():
            w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda")
                                / math.sqrt(K), scheme)
            codes, scale = w["q4" if int4 else "q8"], w["scale"]
            groups = scale.shape[0] if int4 else 1
            launched = {"launches": 0, "launches_wide": 0}
            err, paths = {}, {}
            for rows in row_counts:
                x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
                wide = qm.takes_wide(x, codes, scale, groups)
                paths[rows] = ("wide" if wide else "decode-row"
                               if qm.takes_decode(x, codes, scale, groups, int4)
                               else "cuda-core")
                before = (getattr(quant_matmul_cuda, f"launches_{scheme}"),
                          getattr(quant_matmul_cuda, f"launches_{scheme}_wide"))
                out = quant_matmul_cuda(x, w)
                ref = quant_matmul_plain(x, w).float()
                torch.cuda.synchronize()
                got = (getattr(quant_matmul_cuda, f"launches_{scheme}") - before[0],
                       getattr(quant_matmul_cuda, f"launches_{scheme}_wide") - before[1])
                if got != (1, int(wide)):
                    raise SmokeFailure(f"{name} {label} rows {rows}: launches "
                                       f"{got}, expected (1, {int(wide)})")
                launched["launches"] += got[0]
                launched["launches_wide"] += got[1]
                err[rows] = (out.float() - ref).abs().max().item() / max(
                    ref.abs().max().item(), 1e-30)
            worst = max(err.values())
            log(f"{name} {model} {label} [{K}x{N}] bf16 rows {row_counts}: "
                f"paths {paths}, max relative err {worst:.3g}")
            if worst > BF16_ATOL:
                raise SmokeFailure(f"{name} at {model}'s {label} [{K}x{N}] "
                                   f"disagrees with its plain version: {err}")
            per_shape[label] = dict(K=K, N=N, paths=paths, max_rel_err_bf16=err,
                                    check_launches=launched)
            del w, codes, scale
        records[name][key] = per_shape
        records[name]["max_abs_err"] = max(
            records[name]["max_abs_err"],
            *(v["max_rel_err_bf16"][r] for v in per_shape.values() for r in row_counts))


def _time_quant_matmul(torch, w, rows, K, N, scheme, label, gen, dequant_weight):
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)

    x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
    wbytes = sum(t.numel() * t.element_size() for t in w.values())
    nxt = _cold_cycle(lambda: {k: t.clone() for k, t in w.items()}, wbytes)
    ms, host_ms = time_ms(lambda: quant_matmul_cuda(x, nxt()))
    plain_ms = time_ms(lambda: quant_matmul_plain(x, nxt()), iters=5)[0]
    del nxt
    deq = dequant_weight(w, torch.bfloat16)
    nxt_lib = _cold_cycle(lambda: deq.clone(), deq.numel() * 2)
    library_ms = time_ms(lambda: torch.matmul(x, nxt_lib()))[0]
    del nxt_lib, deq
    nbytes = 2 * rows * K + wbytes + 2 * rows * N
    b_ms, b_by = bound(nbytes, 2.0 * rows * K * N)
    log(f"{scheme} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, torch.matmul bf16 "
        f"{library_ms:.4f}, bound {b_ms:.5f} by {b_by}; host {host_ms:.4f} ms per "
        f"call)")
    return dict(case=label, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, host_ms=host_ms)


# one TP=2 shard's row-parallel planes of Llama-3.1-8B, [K / 2, N]; the
# ring multiplies column chunks of N / 2
PF_SHAPES = {"o": (2048, 4096), "down": (7168, 4096)}


def _time_second(torch, first, second, iters: int = 20, warmup: int = 3) -> float:
    """Card ms of ``second()`` when it runs right after ``first()``: CUDA
    events around each ``second`` call only, behind a sleep kernel."""
    for _ in range(warmup):
        first()
        second()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in pairs:
        first()
        a.record()
        second()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def check_quant_matmul_pf(torch, records):
    """K6 at the TP=2 ring-chunk shapes of Llama-3.1-8B (o and down
    chunks [K, 2048 of 4096 columns], strided views of the shard's plane),
    rows 1, 8 and 200, bf16 and fp32: its output must be bitwise K4/K5's
    on the same views and within their tolerances of the plain version.
    Then timed at 8 rows in bf16: K6 itself; the K4/K5 call on the next
    slab right after K6 prefetched it, against the same call right after
    a K4/K5 call that did not (the next slab cold); K6's bound (both
    slabs' bytes); and torch.matmul over the dequantized bf16 chunk.
    Every timed call cycles through copies of the planes that together
    exceed the L2."""
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.ops.quant_matmul import (
        prefetch_ok, quant_matmul_cuda, quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import dequant_weight, quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for scheme, name, replaces in (
            ("int8", "quant_matmul_int8_pf", "kaito_tpu/engine/ops/quant_matmul.py:193"),
            ("int4", "quant_matmul_int4_pf", "kaito_tpu/engine/ops/quant_matmul.py:199")):
        err = {torch.bfloat16: 0.0, torch.float32: 0.0}
        timed = []
        for label, (K, N) in PF_SHAPES.items():
            def planes():
                return tuple(quantize_weight(torch.randn(K, N, generator=gen,
                                                         device="cuda")
                                             / math.sqrt(K), scheme) for _ in range(2))
            w, w_next = planes()
            nc = N // 2
            for c in (0, 1):
                wc, pc = _slice_out(w, c * nc, nc), _slice_out(w_next, c * nc, nc)
                if not prefetch_ok(wc, pc):
                    raise SmokeFailure(f"{name} {label}: prefetch_ok refused the "
                                       f"ring chunk")
                for rows in (1, 8, 200):
                    for dtype in (torch.bfloat16, torch.float32):
                        x = torch.randn(rows, K, generator=gen, device="cuda").to(dtype)
                        out = quant_matmul_cuda(x, wc, pc)
                        base = quant_matmul_cuda(x, wc)
                        ref = quant_matmul_plain(x, wc).float()
                        torch.cuda.synchronize()
                        if not torch.equal(out, base):
                            raise SmokeFailure(
                                f"{name} {label} chunk {c} rows {rows} {dtype}: not "
                                f"bitwise equal to the kernel without prefetch")
                        e = (out.float() - ref).abs().max().item() / max(
                            ref.abs().max().item(), 1e-30)
                        err[dtype] = max(err[dtype], e)
            log(f"{name} {label} chunk [{K}x{nc} of {N}] rows 1/8/200: bitwise equal "
                f"to K4/K5; max relative err bf16 {err[torch.bfloat16]:.3g} fp32 "
                f"{err[torch.float32]:.3g}")
            rows = 8
            x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
            pair_bytes = 2 * sum(t.numel() * t.element_size() for t in w.values())
            nxt = _cold_cycle(planes, pair_bytes)
            chunk = lambda t: _slice_out(t, 0, nc)   # noqa: E731
            def k6():
                live, ahead = nxt()
                return quant_matmul_cuda(x, chunk(live), chunk(ahead))

            ms, host_ms = time_ms(k6)
            state = {}

            def first(pf):
                state["w"] = nxt()
                a, b = chunk(state["w"][0]), chunk(state["w"][1])
                return quant_matmul_cuda(x, a, b) if pf else quant_matmul_cuda(x, a)

            warm = _time_second(torch, lambda: first(True),
                                lambda: quant_matmul_cuda(x, chunk(state["w"][1])))
            cold = _time_second(torch, lambda: first(False),
                                lambda: quant_matmul_cuda(x, chunk(state["w"][1])))
            plain_ms = time_ms(lambda: quant_matmul_plain(x, chunk(nxt()[0])), iters=5)[0]
            del nxt, state
            deq = dequant_weight(chunk(w), torch.bfloat16)
            nxt_lib = _cold_cycle(lambda: deq.clone(), deq.numel() * 2)
            library_ms = time_ms(lambda: torch.matmul(x, nxt_lib()))[0]
            del nxt_lib, deq
            slab = sum(t.numel() * t.element_size() for t in chunk(w).values())
            b_ms, b_by = bound(2 * rows * K + 2 * slab + 2 * rows * nc,
                               2.0 * rows * K * nc)
            log(f"{name} {label} chunk rows {rows}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"torch.matmul bf16 {library_ms:.4f}, bound {b_ms:.5f} by {b_by}; "
                f"host {host_ms:.4f}); next layer's call after the prefetch "
                f"{warm:.4f} ms, after no prefetch {cold:.4f} ms")
            timed.append(dict(case=f"{label} chunk [{K}x{nc} of {N}] rows {rows}",
                              ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=b_ms, bound_by=b_by, host_ms=host_ms,
                              next_call_prefetched_ms=warm, next_call_cold_ms=cold))
            del w, w_next
        if err[torch.bfloat16] > BF16_ATOL or err[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {err}")
        main = next(t for t in timed if t["case"].startswith("down"))
        records[name] = dict(
            name=name, route="cuda", source="kaito_tpu_torch/csrc/quant_matmul.cu",
            replaces=replaces,
            shape=f"x [8, 7168] bf16 @ {scheme} W [7168, 2048 of 4096 columns] "
                  f"(TP=2 down ring chunk) + the next layer's chunk prefetched",
            max_abs_err=err[torch.bfloat16], max_rel_err_bf16=err[torch.bfloat16],
            max_rel_err_fp32=err[torch.float32], bitwise_equal_to_no_prefetch=True,
            ms=main["ms"], kernel_ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], host_ms=main["host_ms"],
            next_call_prefetched_ms=main["next_call_prefetched_ms"],
            next_call_cold_ms=main["next_call_cold_ms"], cases=timed)


def check_quant_graph(torch, records):
    """One K5 call (x [8, 4096] @ int4 gate/up [4096, 14336]) and one K6
    call (x [8, 7168] @ the int4 TP=2 down ring chunk [7168, 2048 of 4096],
    the next chunk prefetched) captured in a CUDA graph; each replayed
    after new x is copied into its input, then again after an eager call
    of 16 rows over the whole plane (more partials than the captured plan):
    every replay against the plain version (relative to the output's
    largest magnitude, ``BF16_ATOL``) and bitwise against the eager
    kernel; the card's workspace must not move and its merge counters
    must read zero."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.quant import quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def weight(K, N):
        return quantize_weight(torch.randn(K, N, generator=gen, device="cuda")
                               / math.sqrt(K), "int4")

    def rel_err(out, ref):
        return (out.float() - ref.float()).abs().max().item() / max(
            ref.float().abs().max().item(), 1e-30)

    worst = {}
    for name, (K, N), chunk in (("quant_matmul_int4", PROJ_SHAPES["gate/up"], None),
                                ("quant_matmul_int4_pf", PF_SHAPES["down"], 2)):
        w, w_next = weight(K, N), weight(K, N)
        live = _slice_out(w, 0, N // chunk) if chunk else w
        ahead = _slice_out(w_next, 0, N // chunk) if chunk else None
        x = torch.randn(8, K, generator=gen, device="cuda").to(torch.bfloat16)
        run = lambda: qm.quant_matmul_cuda(x, live, ahead)   # noqa: E731
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        ws = qm.decode_workspace(x.device)
        ptrs = (ws.part.data_ptr(), ws.counters.data_ptr())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        err = 0.0
        for larger in (False, False, True, False):
            if larger:
                # 16 rows over the whole plane: more partials than the
                # captured plan (twice the rows; at down also twice the
                # columns of the ring's chunk)
                x16 = torch.randn(16, K, generator=gen, device="cuda").to(torch.bfloat16)
                err = max(err, rel_err(qm.quant_matmul_cuda(x16, w),
                                       qm.quant_matmul_plain(x16, w)))
                continue
            x.copy_(torch.randn(8, K, generator=gen, device="cuda").to(torch.bfloat16))
            graph.replay()
            eager = qm.quant_matmul_cuda(x, live)
            ref = qm.quant_matmul_plain(x, live)
            torch.cuda.synchronize()
            if not torch.equal(out, eager):
                raise SmokeFailure(f"{name} replayed from a CUDA graph is not bitwise the "
                                   f"eager kernel")
            err = max(err, rel_err(out, ref))
        if (ws.part.data_ptr(), ws.counters.data_ptr()) != ptrs:
            raise SmokeFailure("the quant matmul's decode workspace moved under a graph")
        if ws.counters.any():
            raise SmokeFailure(f"{name}: a merge counter is not back at zero after replays")
        worst[name] = err
        records[name]["graph_replay_max_rel_err"] = err
        del graph, w, w_next
    log(f"K5/K6 CUDA graph replays (new x, then after a larger call): max relative "
        f"err {worst}")
    if max(worst.values()) > BF16_ATOL:
        raise SmokeFailure(f"K5/K6 replayed from a CUDA graph disagree: {worst}")


def _flash_inputs(torch, dtype, T, gen, B=1, H=32, Hkv=8, D=128):
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


def _packed_layout(torch, T, seg_lens):
    segs = torch.full((1, T), -1, dtype=torch.int32)
    poss = torch.zeros((1, T), dtype=torch.int32)
    off = 0
    for si, n in enumerate(seg_lens):
        segs[0, off:off + n] = si
        poss[0, off:off + n] = torch.arange(n, dtype=torch.int32)
        off += n
    return segs.cuda(), poss.cuda()


# phase 2's packed layouts: (T, segment lengths); pads fill the rest
FLASH_PACKED = {512: (100, 150, 120, 90),          # 460 tokens + 52 pad
                256: (50, 75, 60, 45),             # 230 tokens + 26 pad
                2048: (700, 600, 500, 200)}        # gemma-3's window timing
# many short segments (1-3 tokens) and one that spans three 64-key tiles
SHORT_SEGMENTS = (1, 2, 3) * 20 + (1, 3, 170) + (2,) * 10


def _attended(n: int, window: int) -> int:
    """Query-key pairs of a causal prompt of ``n`` tokens under a window."""
    return sum(min(i + 1, window) for i in range(n))


def _time_flash(torch, T, gen, scale, H=32, Hkv=8, D=128, window=BIG):
    """K2 and K3 bf16 at B=1, T, H, Hkv, D and ``window``: the kernel, the
    plain version, one SDPA call for the same function (causal, or a
    boolean mask where a window or segments cut it), and the bound."""
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain,
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    seg_lens = FLASH_PACKED[T]
    segs, poss = _packed_layout(torch, T, seg_lens)
    q, k, v = _flash_inputs(torch, torch.bfloat16, T, gen, H=H, Hkv=Hkv, D=D)
    tl = torch.tensor([T], dtype=torch.int32, device="cuda")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    io_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    ms2, host2 = time_ms(lambda: flash_prefill_attention_cuda(q, k, v, tl, window,
                                                             scale=scale))
    plain2 = time_ms(lambda: flash_prefill_attention_plain(q, k, v, tl, window,
                                                           scale=scale), iters=5)[0]
    rows = torch.arange(T, device="cuda")
    if window >= BIG:
        lib2 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale,
                                    enable_gqa=True))[0]
    else:
        wmask = ((rows[None, :] <= rows[:, None])
                 & (rows[:, None] - rows[None, :] < window))[None, None]
        lib2 = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=wmask, scale=scale,
                                    enable_gqa=True))[0]
    b2, by2 = bound(io_bytes + 4, 4.0 * H * D * _attended(T, window))
    ms3, host3 = time_ms(lambda: flash_prefill_packed_cuda(q, k, v, segs, poss,
                                                           window, scale=scale))
    plain3 = time_ms(lambda: flash_prefill_packed_plain(q, k, v, segs, poss, window,
                                                        scale=scale), iters=5)[0]
    sq, sk = segs[0][:, None], segs[0][None, :]
    pq, pk = poss[0][:, None], poss[0][None, :]
    mask = ((sq == sk) & (sq >= 0) & (pk <= pq) & (pq - pk < window))[None, None]
    lib3 = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale,
                                enable_gqa=True))[0]
    b3, by3 = bound(io_bytes + 2 * T * 4,
                    sum(4.0 * H * D * _attended(n, window) for n in seg_lens))
    log(f"T={T} H={H} Hkv={Hkv} D={D} window={window} bf16: K2 {ms2:.4f} ms "
        f"(plain {plain2:.4f}, SDPA {lib2:.4f}, bound {b2:.5f} by {by2}); K3 "
        f"segments {seg_lens} {ms3:.4f} ms (plain {plain3:.4f}, SDPA block mask "
        f"{lib3:.4f}, bound {b3:.5f} by {by3})")
    return (dict(ms=ms2, host_ms=host2, plain_ms=plain2, library_ms=lib2,
                 bound_ms=b2, bound_by=by2),
            dict(ms=ms3, host_ms=host3, plain_ms=plain3, library_ms=lib3,
                 bound_ms=b3, bound_by=by3, segments=seg_lens))


# prompt scoring's K2 launches (one a layer over the fresh [1, T] row,
# T a multiple of 128 up to max_model_len): checked at these T with
# true_len T - 37, and timed at the longest
SCORING_T = (1024, 4096)


def _time_scoring_k2(torch, T, gen, scale):
    """K2 bf16 at a scoring length (B=1, T, H=32, Hkv=8, D=128, causal,
    the whole row valid): the kernel, the plain version, SDPA and the
    bound."""
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain)

    q, k, v = _flash_inputs(torch, torch.bfloat16, T, gen)
    tl = torch.tensor([T], dtype=torch.int32, device="cuda")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms, host = time_ms(lambda: flash_prefill_attention_cuda(q, k, v, tl, BIG,
                                                           scale=scale))
    plain = time_ms(lambda: flash_prefill_attention_plain(q, k, v, tl, BIG,
                                                          scale=scale), iters=3)[0]
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True))[0]
    b, by = bound((2 * q.numel() + k.numel() + v.numel()) * 2 + 4,
                  4.0 * 32 * 128 * _attended(T, BIG))
    log(f"K2 at scoring length T={T} bf16: {ms:.4f} ms (plain {plain:.4f}, SDPA "
        f"{lib:.4f}, bound {b:.5f} by {by}); {host:.3f} host ms a call")
    return dict(T=T, ms=ms, host_ms=host, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by)


def check_flash(torch, records):
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain,
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    err2 = {torch.bfloat16: 0.0, torch.float32: 0.0}
    err3 = dict(err2)
    # (T, H, Hkv, D) x (true_len, window, softcap) for K2; the packed
    # layouts of K3 at each T
    shapes = ((512, 32, 8, 128), (256, 32, 8, 128), (200, 8, 2, 64),
              (200, 32, 8, 128), (512, 64, 8, 64))
    for dtype in (torch.bfloat16, torch.float32):
        for T, H, Hkv, D in shapes:
            scale = 1.0 / math.sqrt(D)
            for true_len, window, softcap in ((T, BIG, None), (T * 3 // 5, 128, None),
                                              (T - 7, BIG, 30.0), (T, 32, None),
                                              (T, 128, None)):
                q, k, v = _flash_inputs(torch, dtype, T, gen, H=H, Hkv=Hkv, D=D)
                tl = torch.tensor([true_len], dtype=torch.int32, device="cuda")
                out = flash_prefill_attention_cuda(q, k, v, tl, window, scale=scale,
                                                   softcap=softcap)
                ref = flash_prefill_attention_plain(q, k, v, tl, window, scale=scale,
                                                    softcap=softcap)
                torch.cuda.synchronize()
                e = (out.float() - ref.float())[:, :true_len].abs().max().item()
                err2[dtype] = max(err2[dtype], e)
                log(f"K2 {dtype} T={T} H={H} Hkv={Hkv} D={D} true_len={true_len} "
                    f"window={window} softcap={softcap}: max err {e:.3g}")
            layouts = [FLASH_PACKED.get(T, (T // 3, T // 4, T // 5))]
            if T == 512:
                layouts.append(SHORT_SEGMENTS)
            for seg_lens in layouts:
                segs, poss = _packed_layout(torch, T, seg_lens)
                valid = sum(seg_lens)
                for window, softcap in ((BIG, None), (64, None), (BIG, 30.0),
                                        (32, None), (128, None)):
                    q, k, v = _flash_inputs(torch, dtype, T, gen, H=H, Hkv=Hkv, D=D)
                    out = flash_prefill_packed_cuda(q, k, v, segs, poss, window,
                                                    scale=scale, softcap=softcap)
                    ref = flash_prefill_packed_plain(q, k, v, segs, poss, window,
                                                     scale=scale, softcap=softcap)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out.float()).all():
                        raise SmokeFailure(f"K3 {dtype} T={T}: non-finite output")
                    e = (out.float() - ref.float())[:, :valid].abs().max().item()
                    err3[dtype] = max(err3[dtype], e)
                    log(f"K3 {dtype} T={T} D={D} {len(seg_lens)} segments "
                        f"({valid} tokens) window={window} softcap={softcap}: "
                        f"max err {e:.3g}")

    scale = 1.0 / math.sqrt(128)
    # K2 at prompt scoring's lengths, part of its record's error
    scoring_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for T in SCORING_T:
            q, k, v = _flash_inputs(torch, dtype, T, gen)
            tl = torch.tensor([T - 37], dtype=torch.int32, device="cuda")
            out = flash_prefill_attention_cuda(q, k, v, tl, BIG, scale=scale)
            ref = flash_prefill_attention_plain(q, k, v, tl, BIG, scale=scale)
            torch.cuda.synchronize()
            e = (out.float() - ref.float())[:, :T - 37].abs().max().item()
            scoring_err[dtype] = max(scoring_err[dtype], e)
            err2[dtype] = max(err2[dtype], e)
            log(f"K2 {dtype} scoring T={T} true_len={T - 37}: max err {e:.3g}")
            del q, k, v, out, ref
    # K2 as the RAG embedder calls it (phase 17): fp32, 32 and 64 rows of
    # T=256 at Qwen3-8B's heads, each row's true_len a query's or a
    # document's token count, the last row empty; part of its record's error
    rag_err, rag_lens = 0.0, _rag_token_lens()
    for B in (32, 64):
        lens = rag_lens[:B - 1] + [0]
        q, k, v = _flash_inputs(torch, torch.float32, 256, gen, B=B)
        tl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = flash_prefill_attention_cuda(q, k, v, tl, BIG, scale=scale)
        ref = flash_prefill_attention_plain(q, k, v, tl, BIG, scale=scale)
        torch.cuda.synchronize()
        valid = torch.arange(256, device="cuda")[None, :] < tl[:, None]
        e = (out - ref).abs()[valid].max().item()
        rag_err = max(rag_err, e)
        err2[torch.float32] = max(err2[torch.float32], e)
        log(f"K2 torch.float32 RAG rows B={B} T=256 true_lens {min(lens[:-1])}-"
            f"{max(lens)} and 0: max err {e:.3g}")
        del q, k, v, out, ref
    scoring = [_time_scoring_k2(torch, T, gen, scale) for T in SCORING_T]
    t512 = _time_flash(torch, 512, gen, scale)
    t256 = _time_flash(torch, 256, gen, scale)
    # gpt-oss-20b's prefill: a 512-token chunk, window 128 and global
    gpt_oss = [_time_flash(torch, 512, gen, 1.0 / math.sqrt(64), window=w,
                           **GPT_OSS_HEADS) for w in (128, BIG)]
    for name, i, src_line, shape in (
            ("flash_prefill_attention", 0, 225,
             "B=1 T=512 H=32 Hkv=8 D=128 causal bf16"),
            ("flash_prefill_packed", 1, 163,
             "B=1 T=512 (segments 100,150,120,90 + 52 pad) H=32 Hkv=8 D=128 bf16")):
        err = (err2, err3)[i]
        records[name] = dict(
            name=name, route="cuda", source="kaito_tpu_torch/csrc/flash_prefill.cu",
            replaces=f"kaito_tpu/engine/ops/flash_prefill.py:{src_line}",
            shape=shape, max_abs_err=err[torch.bfloat16],
            max_err_bf16=err[torch.bfloat16], max_err_fp32=err[torch.float32],
            kernel_ms=t512[i]["ms"], t256=t256[i], **t512[i],
            gpt_oss_20b=dict(shape="B=1 T=512 H=64 Hkv=8 D=64 bf16",
                             window_128=gpt_oss[0][i], window_global=gpt_oss[1][i]))
    records["flash_prefill_attention"]["scoring"] = dict(
        lengths=list(SCORING_T), true_len="T - 37",
        max_err_bf16=scoring_err[torch.bfloat16],
        max_err_fp32=scoring_err[torch.float32], timed=scoring)
    records["flash_prefill_attention"]["rag_rows"] = dict(
        rows=[32, 64], T=256, true_lens=rag_lens[:63] + [0], max_err_fp32=rag_err)
    for name, err in (("K2", err2), ("K3", err3)):
        if err[torch.bfloat16] > BF16_ATOL or err[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {err}")


# the dense families' attention shapes whose head dims 80, 96 and 256
# the kernels take beside 32, 64 and 128: (name, heads, scale, windows);
# gemma-3-4b's scale is 1 / sqrt(query_pre_attn_scalar), its local layers'
# window 1024
FAMILY_HEADS = (
    ("phi-3-mini", dict(H=32, Hkv=32, D=96), 96 ** -0.5, (BIG,)),
    ("phi-2", dict(H=32, Hkv=32, D=80), 80 ** -0.5, (BIG,)),
    ("gemma-3-4b", dict(H=8, Hkv=4, D=256), 256 ** -0.5, (BIG, 1024)),
)


def check_families(torch, records, build_logs):
    """K1, K1q, K2 and K3 at the head dims of phi-3-mini (96), phi-2 (80)
    and gemma-3-4b (256), against their plain versions in bf16 and fp32
    (phase 2's tolerances): decode over eight sequences up to 2048
    tokens at the full table width, prefill at T = 512 and 200 (true_len
    cut, and the four-segment layout for K3), and for gemma-3 T = 2048
    with its window of 1024.  Each is timed in bf16 beside SDPA and the
    bound; one K1 and one K1q call at D = 96 and at D = 256 are replayed
    from a CUDA graph; ``flash_prefill.cu`` must not spill (its
    instances' ptxas lines are logged; those of ``decode_attention.cu``
    are checked by :func:`check_decode`).  Kept in the kernel records
    under ``families``."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        decode_plan, paged_decode_attention_cuda, paged_decode_attention_plain)
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain,
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    lines, spills = _build_lines(build_logs, "flash_prefill.cu")
    for ln in lines:
        log(f"  flash_prefill.cu: {ln}")
    if spills:
        raise SmokeFailure(f"flash_prefill.cu spills: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    full = _path_pages_per_seq()
    B = len(K1_LENGTHS)
    out_rec = {k: {} for k in ("paged_decode_attention", "paged_decode_attention_int8kv",
                               "flash_prefill_attention", "flash_prefill_packed")}
    bad = []

    def note(err, name, dtype, x, what):
        key = f"{name} {str(dtype)[6:]}"
        err[key] = max(err.get(key, 0.0), x)
        if x > (BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL) or not math.isfinite(x):
            bad.append(f"{what}: {x:.3g}")

    for fam, heads, scale, windows in FAMILY_HEADS:
        H, Hkv, D = heads["H"], heads["Hkv"], heads["D"]
        plan = decode_plan(B, H, Hkv, D, sms)
        log(f"K1/K1q plan, {fam} B={B} H={H} Hkv={Hkv} D={D} on {sms} SMs: n_split "
            f"{plan.n_split}, {plan.ctas} CTAs, {plan.scratch_floats} scratch floats")
        err = {}
        timed = {"K1": [], "K1q": [], "K2": [], "K3": []}
        for dtype in (torch.bfloat16, torch.float32):
            for window in windows:
                args, kw = _decode_case(torch, dtype, K1_LENGTHS, window, None, gen, full,
                                        **heads)
                kw["scale"] = scale
                out = paged_decode_attention_cuda(*args, **kw)
                ref = paged_decode_attention_plain(*args, **kw)
                q, ck, cv, pt, lens, win = args
                (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
                qargs, qkw = (q, k8, v8, pt, lens, win), dict(kw, k_scale=ks, v_scale=vs)
                outq = paged_decode_attention_cuda(*qargs, **qkw)
                refq = paged_decode_attention_plain(*qargs, **qkw).float()
                torch.cuda.synchronize()
                e = max(_decode_errs(out, ref))
                eq = _seq_rel_err(outq, refq)
                note(err, "K1", dtype, e, f"{fam} K1 {dtype} window={window}")
                note(err, "K1q", dtype, eq, f"{fam} K1q {dtype} window={window}")
                log(f"K1/K1q {dtype} {fam} H={H} Hkv={Hkv} D={D} window={window}: K1 max "
                    f"err (absolute or per sequence) {e:.3g} / K1q per sequence "
                    f"relative {eq:.3g}")
                if dtype == torch.bfloat16:
                    label = f"{fam} B=8 H={H} Hkv={Hkv} D={D} window {window}"
                    timed["K1"].append(_time_decode(torch, args, kw, label))
                    timed["K1q"].append(_time_decode(torch, qargs, qkw, label))
                del args, qargs, ck, cv, k8, v8
            # prefill: T = 512 and a ragged 200 at each window; gemma-3 also
            # T = 2048, where its window of 1024 cuts
            for T in (512, 200) + ((2048,) if len(windows) > 1 else ()):
                for window in windows:
                    for true_len in (T, T * 3 // 5):
                        q, k, v = _flash_inputs(torch, dtype, T, gen, **heads)
                        tl = torch.tensor([true_len], dtype=torch.int32, device="cuda")
                        out = flash_prefill_attention_cuda(q, k, v, tl, window,
                                                           scale=scale)
                        ref = flash_prefill_attention_plain(q, k, v, tl, window,
                                                            scale=scale)
                        torch.cuda.synchronize()
                        e2 = (out.float() - ref.float())[:, :true_len].abs().max().item()
                        note(err, "K2", dtype, e2, f"{fam} K2 {dtype} T={T} "
                             f"true_len={true_len} window={window}")
                    seg_lens = FLASH_PACKED.get(T, (T // 3, T // 4, T // 5))
                    segs, poss = _packed_layout(torch, T, seg_lens)
                    valid = sum(seg_lens)
                    out = flash_prefill_packed_cuda(q, k, v, segs, poss, window,
                                                    scale=scale)
                    ref = flash_prefill_packed_plain(q, k, v, segs, poss, window,
                                                     scale=scale)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out.float()).all():
                        bad.append(f"{fam} K3 {dtype} T={T}: non-finite output")
                    e3 = (out.float() - ref.float())[:, :valid].abs().max().item()
                    note(err, "K3", dtype, e3, f"{fam} K3 {dtype} T={T} window={window}")
                    log(f"K2/K3 {dtype} {fam} T={T} D={D} window={window}: K2 max err "
                        f"{e2:.3g} (true_len {T * 3 // 5} last), K3 {seg_lens} {e3:.3g}")
                    del q, k, v, out, ref
        for T, window in [(512, BIG)] + [(2048, w) for w in windows if w < BIG]:
            k2, k3 = _time_flash(torch, T, gen, scale, window=window, **heads)
            timed["K2"].append(dict(k2, case=f"{fam} T={T} window {window}"))
            timed["K3"].append(dict(k3, case=f"{fam} T={T} window {window}"))
        graph = _check_decode_graph(torch, full, gen, heads) if D in (96, 256) else None
        shape = f"H={H} Hkv={Hkv} D={D}"
        for rec, name in (("paged_decode_attention", "K1"),
                          ("paged_decode_attention_int8kv", "K1q"),
                          ("flash_prefill_attention", "K2"),
                          ("flash_prefill_packed", "K3")):
            out_rec[rec][fam] = dict(
                shape=shape, max_err_bf16=err[f"{name} bfloat16"],
                max_err_fp32=err[f"{name} float32"], cases=timed[name],
                **({"graph_replay_err": graph[name]} if graph and name in graph
                   else {}))
    if bad:
        raise SmokeFailure(f"the families' kernels disagree with their plain "
                           f"versions: {bad}")
    for rec, fams in out_rec.items():
        records[rec]["families"] = fams


# ---------------------------------------------------------------------------
# Phase 3: goldens
# ---------------------------------------------------------------------------

# golden section -> (quantization, kv_dtype) of the engine that replays it
GOLDEN_MODES = {"fp32": ("", "float32"), "int8": ("int8", "float32"),
                "weight_int4": ("int4", "float32"), "kv_int8": ("", "int8")}


def tp_mesh(torch, n, shared=False):
    """A tensor-parallel mesh of n slots: the first n cards, or, with
    ``shared`` or on a machine with fewer, every slot on the first card."""
    from kaito_tpu_torch.parallel.mesh import build_mesh

    if torch.cuda.device_count() >= n and not shared:
        return build_mesh(tensor=n)
    return build_mesh(tensor=n, devices=["cuda:0"] * n)


def _golden_runs(eng, golden, section, runs):
    """Each golden prompt ``runs`` times in turn through a started
    engine: [(prompt, run, tokens, logprobs, prompt tokens cached)]."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    out = []
    for p in golden["prompts"]:
        for run in range(runs):
            c0 = eng.counters["prefix_cached_tokens_total"]
            req = eng.submit(list(p["prompt_tokens"]), SamplingParams(
                max_tokens=len(p[section]["greedy_tokens"]), temperature=0.0,
                ignore_eos=True, logprobs=True))
            got = list(req.stream())
            out.append((p, run, got, list(req.output_logprobs),
                        eng.counters["prefix_cached_tokens_total"] - c0))
    return out


# speculation in phase 3: n-gram (4 tokens), or the checkpoint as its own
# draft (k=4, full-accept rounds and the draft KV's backfill)
GOLDEN_SPEC = {"ngram": dict(speculative_ngram=4),
               "draft": dict(speculative_draft="tiny-llama-real", speculative_draft_k=4,
                             speculative_draft_weights_dir=os.path.join(
                                 REPO, "checkpoints", "tiny-llama-real"))}


def check_goldens(section, tp=1, overlap=False, async_on=False,
                  model="tiny-llama-real", warm=False, spec=""):
    """Replay one golden section of ``model``'s checkpoint, the prefix
    cache on; at ``tp`` > 1 on a :func:`tp_mesh`, with the comm-overlap
    decode ring on or off; with ``async_on`` through the async decode
    loop.  At TP=1 the decode windows must run as replayed CUDA graphs.
    With ``warm``, at page 16 each prompt is served twice and the second
    run must take its whole prompt pages from the cache and still match.
    Over int8 pages (``kv_int8``) the logprobs are held against the same
    runs of a CPU engine instead: a page's scale covers its 16 tokens
    (not the goldens' 64), and a reused page keeps the scale it grew.
    With ``spec`` (a key of :data:`GOLDEN_SPEC`) the decode runs through
    speculation, every verify round (and draft scan) a graph replay and
    fewer target forwards than tokens; int8 KV's verify windows
    requantize a page over the window, so ``kv_int8`` is then held
    against a CPU engine's same runs too, both at the card's decode
    window (where a round lands decides which tokens a scale covers)."""
    import torch

    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import AUTO_RUN_AHEAD_CUDA, InferenceEngine

    golden = json.load(open(os.path.join(
        REPO, "tests", "testdata", f"goldens_{model}.json")))
    quant, kv_dtype = GOLDEN_MODES[section]

    def config():
        return EngineConfig(model=model,
                            weights_dir=os.path.join(REPO, "checkpoints", model),
                            dtype="float32", kv_dtype=kv_dtype, max_model_len=512,
                            max_num_seqs=2, prefill_buckets=(64, 128),
                            page_size=16 if warm else 64, quantization=quant,
                            seed=0, tensor_parallel=tp, comm_overlap=overlap,
                            async_dispatch=async_on, **GOLDEN_SPEC.get(spec, {}),
                            # speculation: the CPU reference takes the card's
                            # windows, so verify rounds land where they do
                            decode_run_ahead=AUTO_RUN_AHEAD_CUDA if spec else None)

    eng = InferenceEngine(config(), device="cuda",
                          mesh=tp_mesh(torch, tp) if tp > 1 else None)
    if eng.comm_overlap != overlap or eng.prefix_cache is None:
        raise SmokeFailure(f"{section} TP={tp}: comm_overlap={eng.comm_overlap}, "
                           f"asked {overlap}; prefix cache {eng.prefix_cache}")
    runs = 2 if warm else 1
    # the fp32 checkpoint's goldens once more through prompt scoring (K2
    # over each golden prompt plus its golden tokens)
    score = (section == "fp32" and tp == 1 and not warm and not async_on
             and model == "tiny-llama-real" and not spec)
    eng.start()
    try:
        results = _golden_runs(eng, golden, section, runs)
        scored = score_goldens(eng, golden) if score else None
    finally:
        eng.stop()
    ref = None
    if (warm or spec) and section == "kv_int8":
        cpu = InferenceEngine(config(), device="cpu")
        cpu.start()
        try:
            ref = _golden_runs(cpu, golden, section, runs)
        finally:
            cpu.stop()
    worst = 0.0
    for i, (p, run, got, lps, cached) in enumerate(results):
        want = p[section]
        if got != want["greedy_tokens"]:
            raise SmokeFailure(f"{model} {section} golden tokens differ for "
                               f"{p['text']!r} (run {run}): {got} != "
                               f"{want['greedy_tokens']}")
        if cached != (len(p["prompt_tokens"]) // 16 * 16 if run else 0):
            raise SmokeFailure(f"{model} {section} run {run} of {p['text']!r} took "
                               f"{cached} cached tokens")
        d = max(abs(a - b) for a, b in zip(
            lps, want["logprobs"] if ref is None else ref[i][3]))
        worst = max(worst, d)
        if d > 2e-3:
            raise SmokeFailure(f"{model} {section} golden logprobs off by {d:.3g} "
                               f"for {p['text']!r} (run {run})")
    if eng.window.capture != (tp == 1) or eng.async_dispatch != async_on:
        raise SmokeFailure(f"{section} TP={tp}: capture {eng.window.capture}, async "
                           f"{eng.async_dispatch}")
    replays = eng.counters["decode_graph_replays_total"]
    if tp == 1 and replays < eng.counters["decode_windows_total"]:
        raise SmokeFailure(f"{section}: {eng.counters['decode_windows_total']} decode "
                           f"windows but {replays} graph replays")
    if spec:
        c = eng.counters
        tokens = sum(len(p[section]["greedy_tokens"]) for p in golden["prompts"])
        scan = (eng.spec_draft.scan.stats()["replays"] if eng.spec_draft is not None
                else c["spec_draft_steps_total"])
        if not c["spec_steps_total"] or c["spec_verify_eager_total"] or \
                c["spec_verify_graph_replays_total"] != c["spec_steps_total"] or \
                scan != c["spec_draft_steps_total"] or \
                c["decode_steps_total"] >= tokens:
            raise SmokeFailure(f"{section} {spec}: {c['decode_steps_total']} target "
                               f"forwards for {tokens} tokens, counters "
                               f"{ {k: n for k, n in c.items() if 'spec' in k} }")
        log(f"goldens {model} {section} through {spec} speculation: "
            f"{c['decode_steps_total']} target forwards for {tokens} tokens, "
            f"{c['spec_steps_total']} verify rounds (graph replays), accepted "
            f"{c['spec_accepted_tokens_total'] + c['spec_draft_accepted_tokens_total']}"
            f" of {c['spec_proposed_tokens_total'] + c['spec_draft_proposed_tokens_total']}")
    moe = f", expert form {eng.model.moe_impl}" if eng.md.arch.num_experts else ""
    if scored is not None:
        worst = max(worst, scored)
    log(f"goldens {model} {section} TP={tp} overlap={overlap} async={async_on}"
        f"{' warm (each prompt twice, page 16)' if warm else ''}{moe}: "
        f"{len(golden['prompts'])} prompts exact, worst logprob diff {worst:.3g}; "
        f"{eng.counters['decode_graph_captures_total']} captures, {replays} replays")
    return worst


def score_goldens(eng, golden) -> float:
    """Score each golden prompt plus its fp32 golden tokens through a
    started engine (``score_prompt``, on its thread): the scores of the
    golden tokens must be the golden logprobs within 2e-3, and each
    prompt must launch K2 once a layer.  Returns the worst difference."""
    from kaito_tpu_torch.engine.ops.flash_prefill import flash_prefill_attention_cuda

    worst = 0.0
    layers = eng.md.arch.num_layers
    for p in golden["prompts"]:
        toks, gold = list(p["prompt_tokens"]), p["fp32"]
        k2 = flash_prefill_attention_cuda.launches
        lps = eng.score_prompt(toks + gold["greedy_tokens"])
        if flash_prefill_attention_cuda.launches - k2 != layers:
            raise SmokeFailure(f"scoring {p['text']!r}: K2 launched "
                               f"{flash_prefill_attention_cuda.launches - k2} times, "
                               f"not once a layer ({layers})")
        n = len(toks)
        got = lps[n:n + len(gold["greedy_tokens"])]
        d = max(abs(a - b) for a, b in zip(got, gold["logprobs"]))
        worst = max(worst, d)
        if lps[0] is not None or d > 2e-3:
            raise SmokeFailure(f"scoring the golden {p['text']!r}: logprobs off by "
                               f"{d:.3g} (first {lps[0]})")
    log(f"goldens tiny-llama-real fp32 through prompt scoring: {len(golden['prompts'])} "
        f"prompts, worst logprob diff {worst:.3g}, K2 once a layer each")
    return worst


# TP golden replays: (tensor_parallel, sections); each with overlap off
# and on.  int4 is refused at TP=4: a shard of tiny-llama-real's o
# projection would hold 64 in-rows, not a whole group of 128
TP_GOLDENS = ((2, ("fp32", "int8", "weight_int4", "kv_int8")),
              (4, ("fp32", "int8", "kv_int8")))


# tests/test_mla.py's tiny DeepSeek-V3-shaped config (MLA with q_lora, one
# dense layer then two MoE layers with a shared expert); K4/K5 take every
# one of its projections as it is, so no width is changed
MLA_TINY_CFG = {
    "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
    "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "intermediate_size": 128,
    "moe_intermediate_size": 32, "n_routed_experts": 4, "num_experts_per_tok": 2,
    "n_shared_experts": 1, "first_k_dense_replace": 1, "kv_lora_rank": 32,
    "q_lora_rank": 48, "qk_rope_head_dim": 16, "qk_nope_head_dim": 24,
    "v_head_dim": 24, "max_position_embeddings": 256}
# 11, 29 and 40 tokens: the 40-token prompt prefills in three chunks
MLA_TINY_PROMPTS = ([(3 * i) % 500 + 2 for i in range(11)],
                    [(7 * i) % 500 + 2 for i in range(29)],
                    [(13 * i) % 480 + 3 for i in range(40)])


def check_mla_tiny(section):
    """The tiny MLA config in fp32 with the weights and KV of golden mode
    ``section``: the weights are drawn once on the CPU from seed 0
    (quantized there), the same tensors go into an engine on the CPU
    (asked for explicitly) and one on the card, and the prompts, submitted
    together, must give the same greedy tokens and logprobs within atol
    2e-3, every card window a replayed CUDA graph.  The CPU engine is the
    one the CPU tests hold against the JAX engine
    (``tests/test_torch_mla_engine.py``)."""
    import torch

    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config

    quant, kv_dtype = GOLDEN_MODES[section]
    md = metadata_from_hf_config("test/tiny-mla", MLA_TINY_CFG, name="tiny-mla-test")
    src = TransformerLM(md.arch, dtype=torch.float32, device="cpu")
    src.init_params(seed=0, quantization=quant)
    tree = src.param_tree()
    cfg = EngineConfig(model=md.name, dtype="float32", kv_dtype=kv_dtype,
                       max_model_len=128, max_num_seqs=4, prefill_buckets=(16, 32, 64),
                       max_prefill_tokens=16, decode_run_ahead=4,
                       enable_prefix_caching=False, quantization=quant, seed=0)
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = InferenceEngine(cfg, metadata=md, params=tree, device=dev)
        reqs = [eng.submit(p, SamplingParams(max_tokens=12, temperature=0.0,
                                             ignore_eos=True, logprobs=True))
                for p in MLA_TINY_PROMPTS]
        for _ in range(3000):
            eng.step()
            if all(r.finish_reason for r in reqs):
                break
        if not all(r.finish_reason == "length" for r in reqs):
            raise SmokeFailure(f"tiny MLA {section} on {dev}: requests did not finish")
        outs[dev] = ([list(r.output_tokens) for r in reqs],
                     [list(r.output_logprobs) for r in reqs], eng.counters)
        del eng
    (cpu_tok, cpu_lp, _), (tok, lp, c) = outs["cpu"], outs["cuda"]
    if tok != cpu_tok:
        raise SmokeFailure(f"tiny MLA {section}: card tokens {tok} != CPU {cpu_tok}")
    worst = max(abs(a - b) for x, y in zip(lp, cpu_lp) for a, b in zip(x, y))
    if worst > 2e-3:
        raise SmokeFailure(f"tiny MLA {section}: logprobs off by {worst:.3g}")
    if c["decode_graph_replays_total"] < c["decode_windows_total"] or \
            c["prefill_packed_steps_total"]:
        raise SmokeFailure(f"tiny MLA {section}: {c['decode_windows_total']} windows, "
                           f"{c['decode_graph_replays_total']} replays, "
                           f"{c['prefill_packed_steps_total']} packed prefills")
    log(f"tiny MLA {section}: card = CPU engine, {len(tok)} prompts exact, worst "
        f"logprob diff {worst:.3g}; {c['decode_graph_captures_total']} captures, "
        f"{c['decode_graph_replays_total']} replays")
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the full-width server
# ---------------------------------------------------------------------------

def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _prompt(n_bytes: int, salt: int) -> str:
    """``n_bytes`` of words after the salt itself: prompts of distinct
    salts share no prefix, so none is a prefix-cache hit on another
    (the word walk alone repeats with the salt modulo 12)."""
    words = ("kernel page prefill decode tensor window segment cache model "
             "token batch stream").split()
    out, i = [str(salt)], salt
    while len(" ".join(out)) < n_bytes - 1:
        out.append(words[i % len(words)])
        i = i * 7 + 3
    return " ".join(out)[: n_bytes - 1]   # the byte tokenizer adds a BOS


def _completion(base, prompt, max_tokens, **extra):
    t0 = time.perf_counter()
    status, raw = _post(f"{base}/v1/completions", dict(
        prompt=prompt, max_tokens=max_tokens, temperature=0.0, ignore_eos=True,
        **extra))
    dt = time.perf_counter() - t0
    resp = json.loads(raw)
    if status != 200 or resp.get("object") != "text_completion":
        raise SmokeFailure(f"bad completion response {status}: {raw[:300]!r}")
    ch = resp["choices"][0]
    if not isinstance(ch.get("text"), str) or ch.get("finish_reason") != "length":
        raise SmokeFailure(f"malformed choice {ch}")
    if resp["usage"]["completion_tokens"] != max_tokens:
        raise SmokeFailure(f"asked {max_tokens} tokens, got {resp['usage']}")
    return resp, dt


def _http_seed_check(base, label) -> dict:
    """A seeded sampled completion (temperature 0.8, seed 7) twice gives
    one text and one set of logprobs; seed 8 others (per-slot keys from
    the request's seed, through the replayed decode windows)."""
    def run(seed):
        status, raw = _post(f"{base}/v1/completions", dict(
            prompt=_prompt(60, 9), max_tokens=24, temperature=0.8, seed=seed,
            ignore_eos=True, logprobs=1))
        if status != 200:
            raise SmokeFailure(f"{label}: seeded completion answered {status}")
        ch = json.loads(raw)["choices"][0]
        return ch["text"], tuple(ch["logprobs"]["token_logprobs"])

    a, b, c = run(7), run(7), run(8)
    if a != b or a == c:
        raise SmokeFailure(f"{label}: seed 7 gave {a[0]!r} then {b[0]!r}; seed 8 "
                           f"{c[0]!r}")
    log(f"{label}: a seeded sampled completion reproduces (seed 7 twice), seed 8 "
        f"differs")
    return dict(seed_reproduces=True, seeds_differ=True)


def _stream_chat(base, max_tokens):
    req = urllib.request.Request(
        f"{base}/v1/chat/completions",
        data=json.dumps(dict(
            messages=[{"role": "user", "content": "Name three prime numbers."}],
            max_tokens=max_tokens, temperature=0.0, ignore_eos=True, stream=True,
            stream_options={"include_usage": True})).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
    if not events or events[-1] != "[DONE]":
        raise SmokeFailure(f"stream did not end with [DONE]: {events[-3:]}")
    chunks = [json.loads(e) for e in events[:-1]]
    if chunks[0]["choices"][0]["delta"].get("role") != "assistant":
        raise SmokeFailure(f"stream lacks the role chunk: {chunks[0]}")
    if not any(c["choices"] and c["choices"][0]["finish_reason"] == "length"
               for c in chunks):
        raise SmokeFailure("stream lacks a finish_reason=length chunk")
    usage = chunks[-1].get("usage") or {}
    if usage.get("completion_tokens") != max_tokens:
        raise SmokeFailure(f"stream asked {max_tokens} tokens, usage {usage}")
    if any(c["object"] != "chat.completion.chunk" for c in chunks):
        raise SmokeFailure("stream chunk with a wrong object type")
    return len(chunks)


def cut_metadata(model, layers):
    """``model``'s catalog entry at its published widths with its depth cut
    to ``layers`` (None: the whole model)."""
    import dataclasses

    from kaito_tpu_torch.models.registry import get_model_by_name

    md = get_model_by_name(model)
    if layers is None:
        return md
    return dataclasses.replace(md, arch=dataclasses.replace(md.arch, num_layers=layers))


def run_server_phase(flags, counted, label, burst=True, run_ahead_sweep=False,
                     profile=False, tp=1, shared=False, model="llama-3.1-8b-instruct",
                     layers=None, absent=()):
    """Serve ``model`` at full width (its depth cut to ``layers`` when
    given) with the server's command-line ``flags`` and drive the request
    mix (``burst=False`` leaves out the concurrent burst).  At ``tp`` > 1,
    or with ``layers``, the engine is built here (on a :func:`tp_mesh`, or
    with the cut metadata) and handed to ``make_server``.  Returns the
    launch counts of the kernel records ``counted``, zeroed just before
    the requests (those of ``absent``, zeroed with them, must stay 0), and
    the leg's statistics: among them the decode readings of
    :func:`decode_readings`, for an MLA model the plain decode
    attention's time (:func:`time_mla_decode`), and, at TP=1, where every
    decode window must be a replayed CUDA graph, those of the eager
    reference loop and its greedy tokens against the captured windows'
    (:func:`compare_eager`)."""
    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.kv_cache import kv_bytes
    from kaito_tpu_torch.engine.server import make_server, parse_args

    cfg, _ = parse_args(["--model", model, "--dtype", "bfloat16",
                         "--max-num-seqs", "8", "--seed", "0", *flags])
    md = cut_metadata(model, layers)
    t0 = time.perf_counter()
    if tp > 1 or layers is not None:
        mesh = tp_mesh(torch, tp, shared) if tp > 1 else None
        engine = InferenceEngine(cfg, device="cuda", metadata=md, mesh=mesh)
        if tp > 1 and not engine.comm_overlap:
            raise SmokeFailure(f"{label}: the comm-overlap gate did not engage")
        engine.start()
        server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
        if tp > 1:
            log(f"{label}: {mesh}; shards share one card: {mesh.shared}")
    else:
        server = make_server(None, cfg, host="127.0.0.1", port=0, device="cuda")
    engine = server.state.engine
    torch.cuda.synchronize()
    moe = (f", expert form {engine.model.moe_impl}" if engine.md.arch.num_experts
           else "")
    log(f"{label}: {model} ({md.arch.num_layers} layers) engine up in "
        f"{time.perf_counter() - t0:.1f}s: "
        f"{engine.model.param_bytes() / 2**30:.2f} GiB weights, KV "
        f"{cfg.kv_dtype} {kv_bytes(engine.cache) / 2**20:.1f} MiB{moe}, "
        f"{engine.sizing_report}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stats = {}
    try:
        for name in (*counted, *absent):
            fn, attr = _counter(name)
            setattr(fn, attr, 0)
        status, raw = _get(f"{base}/health")
        if status != 200 or json.loads(raw)["status"] != "ok":
            raise SmokeFailure(f"/health answered {status} {raw!r}")
        status, raw = _get(f"{base}/v1/models")
        if status != 200 or json.loads(raw)["data"][0]["id"] != engine.md.name:
            raise SmokeFailure(f"/v1/models answered {status} {raw!r}")
        status, _ = _get(f"{base}/debug/device")
        if status != 403:
            raise SmokeFailure(f"/debug/device with sampling off answered {status}")

        resp, _ = _completion(base, _prompt(60, 1), 16, logprobs=1)
        lps = resp["choices"][0]["logprobs"]["token_logprobs"]
        if len(lps) != 16 or not all(math.isfinite(x) and x <= 0 for x in lps):
            raise SmokeFailure(f"bad logprobs {lps}")
        n_chunks = _stream_chat(base, 16)
        log(f"completion + streamed chat ok ({n_chunks} SSE chunks)")
        if label == LEGS[0][1]:
            stats["seed"] = _http_seed_check(base, label)
        if label == LEGS[1][1]:
            # K5 and K1q under a grammar mask
            ch = _g_ok(base, "/v1/chat/completions", dict(
                messages=_G_CHAT, max_tokens=64, temperature=0.0, response_format={
                    "type": "json_schema", "json_schema": {"schema": _G_SCHEMA}}),
                label, "a json_schema chat")
            if ch["finish_reason"] != "stop" or \
                    set(json.loads(ch["message"]["content"])) != set(_G_SCHEMA["required"]):
                raise SmokeFailure(f"{label}: json_schema chat {ch}")
            stats["constrained"] = ch["message"]["content"]
            log(f"{label}: a json_schema chat under int4 weights and int8 KV: "
                f"{stats['constrained']}")

        if burst:
            stats.update(_burst(base, engine))
        # TTFT and decode rate of one request alone, each prompt new to
        # the prefix cache; then TTFT of a prompt the cache holds
        p = _prompt(200, 30)
        ttft = min(_completion(base, _prompt(200, 30 + i), 1)[1] for i in range(3))
        t_long = min(_completion(base, _prompt(200, 33 + i), 129)[1] for i in range(2))
        stats["warm"] = warm_ttft(base, engine, label)
        if tp == 1 and not engine.model.is_mla:
            stats["warm"]["context_attention"] = time_context_attention(
                engine, stats["warm"]["ttft_ms"], label)
        stats["routes"] = check_routes(base, engine, label)
        # inter-token gaps of one sequence alone, as the engine delivers them
        single = _itl(_timed_tokens(engine, p, 129))
        stats.update(ttft_ms=ttft * 1e3, decode_tok_s=128 / (t_long - ttft),
                     warm_ttft_ms=stats["warm"]["ttft_ms"],
                     prompt_tokens=200, run_ahead=engine.run_ahead,
                     tensor_parallel=tp, comm_overlap=engine.comm_overlap,
                     shared_card=bool(tp > 1 and engine.mesh.shared),
                     weights_gib=engine.model.param_bytes() / 2**30,
                     param_bytes=engine.model.param_bytes(),
                     sizing=dict(engine.sizing_report),
                     engine_cfg=dict(model=model, layers=layers,
                                     quantization=cfg.quantization,
                                     kv_dtype=cfg.kv_dtype, page_size=cfg.page_size),
                     kv_pages=engine.sizing_report.get("pages"),
                     kv_pool_mib=kv_bytes(engine.cache) / 2**20,
                     layers=md.arch.num_layers, single_stream=single)
        log(f"{label}: one sequence at run_ahead={engine.run_ahead}: "
            f"{single['decode_tok_s']:.2f} tok/s, ITL p50/p90/max "
            f"{single['itl_p50_ms']:.1f}/{single['itl_p90_ms']:.1f}/"
            f"{single['itl_max_ms']:.1f} ms")
        torch.cuda.synchronize()
        launches = {name: getattr(*_counter(name)) for name in counted}
        log(f"{label}: launches {launches}; decode steps "
            f"{engine.counters['decode_steps_total']}")
        stray = {name: getattr(*_counter(name)) for name in absent}
        if any(stray.values()):
            raise SmokeFailure(f"{label}: kernels of another path launched: {stray}")
        windows = engine.counters["decode_windows_total"]
        replays = engine.counters["decode_graph_replays_total"]
        if (tp == 1) != engine.window.capture or (tp == 1 and replays < windows):
            raise SmokeFailure(f"{label}: capture {engine.window.capture}, {windows} "
                               f"decode windows, {replays} graph replays")
        stats["decode"] = decode_readings(engine, p, label,
                                          n=5 if tp > 1 else 17)
        ceiling = _HOST_CALLS_CEILING.get(label)
        if ceiling is not None and stats["decode"]["host_calls_per_step"] > ceiling:
            raise SmokeFailure(f"{label}: {stats['decode']['host_calls_per_step']:.3f} "
                               f"host calls a decode step, above {ceiling}")
        if engine.model.is_mla:
            stats["mla_decode_attention"] = time_mla_decode(engine, label)
        if run_ahead_sweep:
            stats["run_ahead_sweep"] = sweep_run_ahead(engine)
        if profile:
            stats["profile"] = profile_request(engine, base)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    if tp == 1:
        del server, engine
        _release_card(torch)
        stats["eager"] = compare_eager(cfg, p, label, md)
    return launches, stats


# host launch/copy calls a decode step on these legs when decode windows
# were first captured (PERF.md section 5): the tracer, the timeline and
# the prefix cache add none
_HOST_CALLS_CEILING = {"phase 4, bf16": 2.75, "phase 5, int8 weights": 2.75,
                   "phase 5, bf16, async dispatch": 1.65}


def warm_ttft(base, engine, label) -> dict:
    """TTFT of a 200-byte prompt the prefix cache holds: one cold run of
    16 tokens commits its whole pages, then the minimum over three
    1-token repeats, with the prompt tokens each took from the cache
    (192 at page 64), then one 16-token repeat whose greedy text must be
    the cold run's.  Without a tree (MLA) the repeats read 0 cached
    tokens; with one, a repeat that reads 0 fails the leg."""
    c = engine.counters
    pw = _prompt(200, 40)
    cold = _completion(base, pw, 16)[0]["choices"][0]["text"]
    c0 = c["prefix_cached_tokens_total"]
    ttft = min(_completion(base, pw, 1)[1] for _ in range(3))
    cached = (c["prefix_cached_tokens_total"] - c0) / 3
    warm = _completion(base, pw, 16)[0]["choices"][0]["text"]
    tree = engine.prefix_cache is not None
    if tree == engine.model.is_mla:
        raise SmokeFailure(f"{label}: prefix cache tree {tree} with MLA "
                           f"{engine.model.is_mla}")
    if tree and not cached:
        raise SmokeFailure(f"{label}: a repeated prompt read no cached tokens")
    if warm != cold:
        raise SmokeFailure(f"{label}: a warm run's greedy text differs from the "
                           f"cold run's: {warm!r} != {cold!r}")
    log(f"{label}: warm TTFT {ttft * 1e3:.1f} ms ({cached:.0f} of the prompt's "
        f"tokens cached a request, tree {'on' if tree else 'off (MLA)'}); warm "
        f"greedy text equal to the cold run's")
    return dict(ttft_ms=ttft * 1e3, cached_tokens_per_request=cached, tree=tree)


def time_context_attention(engine, warm_ms, label) -> dict:
    """The plain ``attention.paged_context_attention`` (no kernel in
    either package) at one layer of the serving pool, as a warm 200-token
    prompt runs it: the 8-token suffix padded to its bucket, at position
    192 over 4 pages (int8 pages with their scales for an int8 pool).
    Card ms a layer (CUDA events), and all layers' share of the warm
    TTFT."""
    import torch

    from kaito_tpu_torch.engine import attention as attn

    m, c, a, ps = engine.model, engine.cache, engine.md.arch, engine.cfg.page_size
    T = engine._bucket(8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, T, a.num_heads, a.head_dim, generator=gen,
                    device="cuda").to(m.dtype)
    # the history's 4 pages, as the model passes them (history_pages)
    pt = torch.arange(1, 5, dtype=torch.int32, device="cuda")[None]
    start = torch.tensor([192], dtype=torch.int32, device="cuda")
    lens = torch.tensor([8], dtype=torch.int32, device="cuda")

    def call():
        return attn.paged_context_attention(
            q, c.k, c.v, pt, start, lens, scale=m._scale, layer=0,
            k_scale=c.k_scale, v_scale=c.v_scale)

    if not torch.isfinite(call()[0, :8].float()).all():
        raise SmokeFailure(f"{label}: context attention gave non-finite values")
    ms, host = time_ms(call, iters=10)
    layers = a.num_layers
    res = dict(card_ms_per_layer=ms, host_ms_per_layer=host, bucket=T,
               layers=layers, share_of_warm_ttft=ms * layers / warm_ms)
    log(f"{label}: plain context attention (bucket {T}, 8 tokens at 192 over 4 "
        f"pages), one layer: {ms:.4f} card ms ({host:.3f} host ms); x{layers} "
        f"layers = {100 * res['share_of_warm_ttft']:.1f}% of the warm TTFT")
    return res


def check_routes(base, engine, label) -> dict:
    """``/metrics`` parses, its histograms are cumulative and its token
    counters equal the engine's (every request so far came over HTTP);
    a request sent with an ``X-Request-Id`` has its span tree at
    ``/debug/trace?trace_id=`` and engine steps inside its span at
    ``/debug/timeline``; ``/debug/slo`` answers.  With QoS and ITL off,
    ``/metrics`` holds no ``tenant`` label and no ITL family."""
    from kaito_tpu_torch.utils.promtext import (check_histograms,
                                                parse_exposition)

    rid = "smoke-" + re.sub(r"[^A-Za-z0-9]+", "-", label).strip("-")
    req = urllib.request.Request(f"{base}/v1/completions", data=json.dumps(dict(
        prompt=_prompt(60, 41), max_tokens=8, temperature=0.0,
        ignore_eos=True)).encode(), headers={"Content-Type": "application/json",
                                             "X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.status != 200 or r.headers.get("X-Request-Id") != rid:
            raise SmokeFailure(f"{label}: X-Request-Id not echoed: {r.headers}")
    status, raw = _get(f"{base}/metrics")
    if status != 200:
        raise SmokeFailure(f"{label}: /metrics answered {status}")
    samples = parse_exposition(raw.decode())
    hists = check_histograms(samples)
    values = {n: v for n, lbl, v in samples if not lbl}
    # QoS and ITL off (every leg of phases 4-8): no per-tenant series and
    # no ITL family, as before either was ported
    qos_itl = [f"{n}{lbl}" for n, lbl, _ in samples if "tenant=" in lbl
               or n.startswith(("kaito:inter_token_latency_seconds",
                                "kaito:itl_stalls_total"))]
    if qos_itl:
        raise SmokeFailure(f"{label}: QoS/ITL series with both off: {qos_itl[:5]}")
    c = engine.counters
    for fam, key in (("kaito:prompt_tokens_total", "prompt_tokens_total"),
                     ("kaito:generation_tokens_total", "generation_tokens_total"),
                     ("kaito:prefix_cached_tokens_total",
                      "prefix_cached_tokens_total")):
        if values.get(fam) != c[key]:
            raise SmokeFailure(f"{label}: {fam} {values.get(fam)} != engine {c[key]}")
    status, raw = _get(f"{base}/debug/trace?trace_id={rid}")
    events = json.loads(raw)["traceEvents"] if status == 200 else []
    spans = {e["name"]: e for e in events if e["ph"] == "X"}
    if status != 200 or not {"queue.wait", "admit", "prefill.chunk", "decode",
                             "request"} <= set(spans):
        raise SmokeFailure(f"{label}: /debug/trace?trace_id={rid} answered {status} "
                           f"with spans {sorted(spans)}")
    r0 = spans["request"]["ts"]
    r1 = r0 + spans["request"]["dur"]
    status, raw = _get(f"{base}/debug/timeline")
    steps = [e for e in json.loads(raw)["traceEvents"]
             if e["name"] == "engine.step"] if status == 200 else []
    inside = [e for e in steps if r0 <= e["ts"] <= r1]
    if not inside:
        raise SmokeFailure(f"{label}: /debug/timeline ({status}, {len(steps)} steps) "
                           f"has no step inside request {rid}")
    status, raw = _get(f"{base}/debug/slo")
    if status != 200 or "alerts" not in json.loads(raw):
        raise SmokeFailure(f"{label}: /debug/slo answered {status}")
    res = dict(metric_samples=len(samples), histograms=len(hists),
               trace_spans=len(spans), steps_in_request=len(inside),
               timeline_steps=len(steps))
    log(f"{label}: /metrics {len(samples)} samples, {len(hists)} cumulative "
        f"histograms, token counters equal the engine's; trace {rid}: "
        f"{sorted(spans)}, {len(inside)} timeline steps inside it")
    return res


def time_mla_decode(engine, label) -> dict:
    """The plain MLA decode attention (``TransformerLM.mla_decode_attention``
    over ``attention.mla_paged_decode_attention``: the JAX package's
    einsums, no kernel) at one layer of the serving
    engine's latent pool, eight sequences of :data:`K1_LENGTHS` over the
    full page-table width the decode window passes (int8 pages with their
    scales for an int8 pool): card ms a layer (CUDA events) against the
    bound over the latent bytes gathered at the full width and at the
    live lengths, each with the kv_b weights, the queries and the output
    read or written once, and the operations of the absorbed form at that
    width."""
    import torch

    m, c, a = engine.model, engine.cache, engine.md.arch
    H, B, pmax, ps = a.num_heads, len(K1_LENGTHS), engine.pages_per_seq, \
        engine.cfg.page_size
    dn, dr, dv, dl = (a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim,
                      a.kv_lora_rank)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pt = torch.randint(1, c.k.shape[1], (B, pmax), generator=gen, device="cuda",
                       dtype=torch.int32)
    lengths = torch.tensor(K1_LENGTHS, dtype=torch.int32, device="cuda")
    qn = torch.randn(B, H, dn, generator=gen, device="cuda").to(m.dtype)
    qr = torch.randn(B, H, dr, generator=gen, device="cuda").to(m.dtype)

    def call():
        return m.mla_decode_attention(c, qn, qr, pt, lengths, layer=0)

    out = call()
    if not torch.isfinite(out.float()).all():
        raise SmokeFailure(f"{label}: MLA decode attention gave non-finite values")
    ms, host = time_ms(call, iters=10)
    tok_bytes = (dl + dr) * c.k.element_size()
    fixed = (dl * H * (dn + dv) + qn.numel() + qr.numel() + B * H * dv) * 2
    res = {"card_ms": ms, "host_ms": host, "sequences": B, "heads": H,
           "table_width_tokens": pmax * ps, "live_tokens": int(sum(K1_LENGTHS))}
    for what, tokens in (("full_width", B * pmax * ps), ("live", sum(K1_LENGTHS))):
        nbytes = fixed + tokens * tok_bytes \
            + (B * pmax * 4 if c.k_scale is not None else 0)
        flops = 2 * H * (B * dn * dl + tokens * (dl + dr) + tokens * dl + B * dl * dv)
        res[what] = dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops)),
                         bytes=nbytes, flops=flops)
    log(f"{label}: plain MLA decode attention, one layer, {B} sequences (live "
        f"{res['live_tokens']} tokens, table width {res['table_width_tokens']}): "
        f"{ms:.4f} card ms ({host:.3f} host ms); bound full width "
        f"{res['full_width']['bound_ms']:.4f} ms ({res['full_width']['bound_by']}), "
        f"live {res['live']['bound_ms']:.4f} ms ({res['live']['bound_by']})")
    return res


@contextlib.contextmanager
def _card_profile():
    """torch.profiler over the host and the card, holding the process-wide
    profiler lock that the engine's device profiler and ``/start_profile``
    take too (one trace at a time).  The trace asks the profiler to
    detach CUPTI when it stops (``TEARDOWN_CUPTI=1``, set around it):
    left attached, CUPTI makes every later kernel launch of the process
    cost the host more (``tools/cupti_probe.py``: 9.5 us before a trace,
    13.8-14.4 us after, 7.9 us after with the teardown; PERF.md),
    and the host-bound phases after the traced legs pay it."""
    from torch.profiler import ProfilerActivity, profile

    from kaito_tpu_torch.engine.devprof import PROFILE_LOCK

    before = os.environ.get("TEARDOWN_CUPTI")
    os.environ["TEARDOWN_CUPTI"] = "1"
    try:
        with PROFILE_LOCK, profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
            yield prof
    finally:
        if before is None:
            os.environ.pop("TEARDOWN_CUPTI", None)
        else:
            os.environ["TEARDOWN_CUPTI"] = before


def _api_calls(prof) -> dict:
    """Host-side launch and copy calls of a profile (the CUDA runtime and
    driver events the profiler records), by name."""
    calls = {}
    for e in prof.key_averages():
        k = e.key
        if k.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
                         "cudaMemset")):
            calls[k] = calls.get(k, 0) + e.count
    return calls


def _profiled_request(engine, prompt, n, grammar=None, adapter=""):
    """(host launch and copy calls, device kernels, decode steps, decode
    windows) of one greedy request of ``n`` tokens straight to the
    serving engine (under ``grammar``, through ``adapter`` when given)."""
    import torch

    c = engine.counters
    steps0, windows0 = c["decode_steps_total"], c["decode_windows_total"]
    with _card_profile() as prof:
        _timed_tokens(engine, prompt, n, grammar, adapter)
        torch.cuda.synchronize()
    kernels = sum(r[1] for r in _device_rows(prof))
    return (_api_calls(prof), kernels, c["decode_steps_total"] - steps0,
            c["decode_windows_total"] - windows0)


def decode_readings(engine, prompt, label, grammar=None, adapter="", n=17) -> dict:
    """One sequence's decode as the engine runs it (under ``grammar``,
    through ``adapter`` when given): the host's launch and copy calls a
    decode step and a decode window, and the device's kernels a step (a
    profiled ``n``-token request less a profiled 1-token one, over their n - 1
    decode steps), and, for a captured engine, its captures, graph pool
    and each graph's kernel nodes."""
    calls1, k1, s1, w1 = _profiled_request(engine, prompt, 1, grammar, adapter)
    calls17, k17, s17, w17 = _profiled_request(engine, prompt, n, grammar, adapter)
    steps, windows = max(s17 - s1, 1), max(w17 - w1, 1)
    host = {k: calls17.get(k, 0) - calls1.get(k, 0)
            for k in set(calls1) | set(calls17)}
    res = dict(host_calls_per_step=sum(host.values()) / steps,
               host_calls_per_window=sum(host.values()) / windows,
               host_calls_by_name={k: v / steps for k, v in host.items() if v},
               device_kernels_per_step=(k17 - k1) / steps, profiled_steps=steps,
               profiled_windows=windows)
    msg = (f"{label}: a decode step (one sequence, run_ahead={engine.run_ahead}): "
           f"{res['host_calls_per_step']:.1f} host launch/copy calls "
           f"{res['host_calls_by_name']}, {res['device_kernels_per_step']:.1f} "
           f"device kernels; {res['host_calls_per_window']:.1f} host calls a "
           f"decode window ({steps} steps in {windows} windows)")
    if engine.window is not None and engine.window.capture:
        w = engine.window.stats()
        res.update(captures=w["captures"], replays=w["replays"],
                   graph_pool_mib=w["pool_bytes"] / 2**20,
                   graphs=[dict(K=g["K"], key=g["key"], kernel_nodes=g["nodes"]["kernel"],
                                nodes=g["nodes"], wrapper_kernels=g["launches"])
                           for g in w["graphs"]])
        msg += (f"; {w['captures']} captures, graph pool "
                f"{res['graph_pool_mib']:.1f} MiB, kernel nodes a window "
                + ", ".join(f"K={g['K']}: {g['kernel_nodes']}" for g in res["graphs"]))
    log(msg)
    return res


# the greedy batch that holds the captured windows against the eager
# loop: (prompt bytes, salt), 24 tokens each, submitted together
_BATCH = ((60, 71), (130, 72), (200, 73), (330, 74))


def greedy_batch(engine) -> list:
    """The greedy tokens of :data:`_BATCH`, submitted together to a fresh
    engine (not started) and driven step by step, so any two engines see
    one schedule and one page pool: an int8 page keeps the scale its
    last owner grew (as in the JAX package), so int8-KV output depends
    on what the pool served before."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    reqs = [engine.submit(engine.tokenizer.encode(_prompt(n, salt)), SamplingParams(
        max_tokens=24, temperature=0.0, ignore_eos=True)) for n, salt in _BATCH]
    for _ in range(5000):
        engine.step()
        if all(r.finish_reason for r in reqs):
            break
    if not all(r.finish_reason == "length" for r in reqs):
        raise SmokeFailure(f"greedy batch did not finish: "
                           f"{[r.finish_reason for r in reqs]}")
    return [list(r.output_tokens) for r in reqs]


def compare_eager(cfg, prompt, label, metadata=None) -> dict:
    """The greedy batch of a fresh engine of ``cfg`` (captured windows)
    against that of the same engine with the eager reference decode loop
    (same config, ``metadata``, seed and weights); then the eager engine's
    one-sequence decode: tok/s, ITL and launches a step."""
    import dataclasses

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine

    eng = InferenceEngine(cfg, device="cuda", metadata=metadata)
    got = greedy_batch(eng)
    del eng
    _release_card(torch)
    ref = InferenceEngine(dataclasses.replace(cfg, async_dispatch=False),
                          device="cuda", metadata=metadata, _eager_decode=True)
    try:
        want = greedy_batch(ref)
        if got != want:
            diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise SmokeFailure(f"{label}: captured windows' greedy tokens differ from "
                               f"the eager loop's for prompts {diff}: {got} != {want}")
        ref.start()
        # the eager loop's depth is cut (9 tokens alone, 4 profiled
        # decode steps) to keep the whole script inside its time limit
        single = _itl(_timed_tokens(ref, prompt, 9))
        res = dict(single_stream=single, greedy_batch_equal=True,
                   decode=decode_readings(ref, prompt, label + " (eager reference)",
                                          n=5))
    finally:
        ref.stop()
    log(f"{label}: eager reference loop: greedy batch equal; one sequence "
        f"{single['decode_tok_s']:.2f} tok/s, ITL p50/p90/max "
        f"{single['itl_p50_ms']:.1f}/{single['itl_p90_ms']:.1f}/"
        f"{single['itl_max_ms']:.1f} ms")
    del ref
    _release_card(torch)
    return res


def _burst(base, engine):
    """A long decode in flight, then four concurrent 120-400-token
    prompts and one 700-token prompt (a continuation chunk), arriving
    at once: the engine admits none of them until all five are queued,
    in this order, so they stage together and the first two prompts'
    prefill forms a pack.  Left to the HTTP threads' timing, the first
    prompt could be admitted a step before the second and prefill alone,
    and then no two fresh prompts fit one prefill budget."""
    results, errors = {}, []

    def run(key, prompt, n):
        try:
            results[key] = _completion(base, prompt, n)
        except Exception as e:   # reported below; the phase fails
            errors.append(f"{key}: {e!r}")

    bg = threading.Thread(target=run, args=("bg", _prompt(40, 2), 96))
    bg.start()
    time.sleep(0.5)
    burst = [threading.Thread(target=run, args=(f"c{i}", _prompt(n, 10 + i), 32))
             for i, n in enumerate((120, 250, 330, 400))]
    burst.append(threading.Thread(target=run, args=("long", _prompt(700, 20), 32)))
    t_burst = time.perf_counter()
    engine._admit_new = lambda: False         # admission held: the loop decodes on
    try:
        for t in burst:
            queued = engine.counters["requests_total"]
            t.start()
            deadline = time.monotonic() + 60
            while (engine.counters["requests_total"] == queued and t.is_alive()
                   and time.monotonic() < deadline):
                time.sleep(0.001)
    finally:
        del engine._admit_new
        engine._wake.set()
    for t in burst + [bg]:
        t.join(timeout=600)
    t_burst = time.perf_counter() - t_burst
    if errors or len(results) != 6:
        raise SmokeFailure(f"concurrent requests failed: {errors}")
    packs = engine.counters["prefill_packed_steps_total"]
    log(f"burst of 5 ok in {t_burst:.2f}s; packed prefill dispatches {packs}")
    return dict(burst_s=t_burst, burst_completion_tokens=32 * 5,
                packed_prefill_dispatches=packs)


def _release_card(torch):
    """Drop a finished leg's engine (its cycles included) and hand the
    cached blocks back, so the next leg sizes its pool from a free card."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"card memory after release: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated")


# the CUDA context: total - free - reserved right after this process's
# first allocation (main, before the build)
CONTEXT_BYTES = 0


def _launch_us(torch, n=2000, rounds=3) -> float:
    """Median host microseconds of an eager launch (``x.add_(1)``)."""
    x = torch.zeros(1024, device="cuda")
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1)
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[rounds // 2]


def _os_threads() -> dict:
    """{tid: (name, CPU ticks)} of this process's OS threads."""
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                stat = f.read()
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        out[tid] = (name, int(fields[11]) + int(fields[12]))
    return out


def _process_ticks() -> dict:
    """{pid: (name, CPU ticks)} of every process this machine shows."""
    out = {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat.rsplit(")", 1)[1].split()
        out[pid] = (name, int(fields[11]) + int(fields[12]))
    return out


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:"))
    return kb / 2**20


def _children() -> list:
    """Process ids of this process's live children."""
    kids = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/children") as f:
                kids += f.read().split()
        except OSError:
            pass
    return kids


def _phase_start(torch, label, deep=False) -> dict:
    """The start of phase ``label``: hand back what the phases before it
    left that can go, then log what is still there.  When none of the
    port's CUDA graph holders is alive, cuBLAS's workspaces go (one per
    stream a finished engine ran a matmul on, 32 MiB each, counted as
    allocated; a captured matmul would keep using its workspace), then
    the caching allocator's free blocks.  Logged: Python and OS threads,
    engines whose loop still runs and engines or HTTP servers still
    reachable, the graph holders (and their graphs), child processes,
    device memory, the host cost of a launch and of a pure-Python loop;
    with ``deep``, also the largest live CUDA tensors with the types that
    hold them, and the CPU each OS thread and each process of the machine
    took over one second."""
    import socketserver

    from kaito_tpu_torch.engine.decode_graph import StaticGraphs
    from kaito_tpu_torch.engine.engine import InferenceEngine

    gc.collect()
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1e3
    objs = gc.get_objects()
    engines = [o for o in objs if isinstance(o, InferenceEngine)]
    servers = [o for o in objs if isinstance(o, socketserver.BaseServer)]
    holders = [o for o in objs if isinstance(o, StaticGraphs)]
    before = torch.cuda.memory_allocated()
    if not holders:
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sum(i * i for i in range(200_000))
    py_ms = (time.perf_counter() - t0) * 1e3
    names: dict = {}
    for t in threading.enumerate():
        key = re.sub(r"\d+", "N", t.name)
        names[key] = names.get(key, 0) + 1
    res = dict(
        threads=len(threading.enumerate()), thread_names=names,
        os_threads=len(os.listdir("/proc/self/task")), children=_children(),
        engines=len(engines),
        engines_running=sum(bool(e._thread and e._thread.is_alive()) for e in engines),
        servers=len(servers),
        servers_open=sum(getattr(getattr(sv, "socket", None), "fileno", lambda: -1)()
                         != -1 for sv in servers),
        graph_holders=len(holders), graphs=sum(len(h.graphs) for h in holders),
        released_mib=(before - torch.cuda.memory_allocated()) / 2**20,
        gc_objects=len(objs), gc_full_ms=gc_ms, py_loop_ms=py_ms,
        allocated_gib=torch.cuda.memory_allocated() / 2**30,
        reserved_gib=torch.cuda.memory_reserved() / 2**30, rss_gib=_rss_gib(),
        launch_us=_launch_us(torch))
    if deep:
        tensors = []
        for o in objs:
            try:
                if isinstance(o, torch.Tensor) and o.is_cuda:
                    tensors.append(o)
            except Exception:       # a half-built object
                continue
        tensors.sort(key=lambda t: -t.untyped_storage().nbytes())
        res["cuda_tensors"] = len(tensors)
        res["cuda_tensor_gib"] = sum(t.untyped_storage().nbytes()
                                     for t in tensors) / 2**30
        top = []
        for t in tensors[:6]:
            refs = [type(r).__name__ + (f"({len(r)})" if isinstance(r, (dict, list)) else "")
                    for r in gc.get_referrers(t) if r is not objs and r is not tensors]
            top.append(dict(shape=list(t.shape), dtype=str(t.dtype),
                            mib=t.untyped_storage().nbytes() / 2**20, held_by=refs[:4]))
        res["largest_cuda_tensors"] = top
        del tensors
        before, procs = _os_threads(), _process_ticks()
        time.sleep(1.0)
        after, procs_after = _os_threads(), _process_ticks()
        for key, a, b in (("os_thread_ticks_1s", before, after),
                          ("process_ticks_1s", procs, procs_after)):
            busy = {f"{b[k][0]}:{k}": b[k][1] - a[k][1]
                    for k in b if k in a and b[k][1] > a[k][1]}
            res[key] = dict(sorted(busy.items(), key=lambda kv: -kv[1])[:8])
    del objs, engines, servers, holders
    log(f"{label}: left in the process: {res}")
    return res


def profile_request(engine, base):
    """torch.profiler over one 200-token prefill alone
    (:func:`_profile_prefill`), then over one request alone (200-token
    prompt, 33 output tokens): wall time, device busy time, kernel
    launches and the kernels that take the most device time."""
    import torch

    _completion(base, _prompt(200, 50), 8)           # warm
    prefill = _profile_prefill(base)
    prefill_warm = _profile_prefill(base, warm=True)
    steps0 = engine.counters["decode_steps_total"]
    with _card_profile() as prof:
        t0 = time.perf_counter()
        _completion(base, _prompt(200, 51), 33)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()   # the trace holds every kernel the request ran
    steps = engine.counters["decode_steps_total"] - steps0
    rows = _device_rows(prof)
    busy = sum(r[2] for r in rows)
    flash = sum(r[2] for r in rows if "flash" in r[0])
    log(f"profile: flash prefill kernels (K2, K3) {flash:.3f} device ms in "
        f"{sum(r[1] for r in rows if 'flash' in r[0])} launches")
    quant = sum(r[2] for r in rows if "quant_matmul" in r[0])
    res = dict(wall_ms=wall * 1e3, device_busy_ms=busy, flash_device_ms=flash,
               quant_matmul_device_ms=quant,
               device_idle_share=1.0 - busy / (wall * 1e3),
               kernel_launches=sum(r[1] for r in rows), decode_steps=steps,
               prefill=prefill, prefill_warm=prefill_warm,
               top=[dict(name=k[:80], count=c, ms=ms) for k, c, ms in rows[:12]])
    log(f"profile: wall {res['wall_ms']:.1f} ms, device busy {busy:.1f} ms, "
        f"{res['kernel_launches']} kernel launches, {steps} decode steps")
    for r in res["top"]:
        log(f"  {r['ms']:8.2f} ms  x{r['count']:5d}  {r['name']}")
    return res


def _device_rows(prof):
    """(kernel name, launches, device ms) of every kernel in a profile."""
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0 and "CPU" not in str(getattr(e, "device_type", "")):
            rows.append((e.key, e.count, dev / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def _profile_prefill(base, warm=False):
    """torch.profiler over one 200-token prompt answered with one token:
    the prefill alone (``warm``: a repeat of a prompt the prefix cache
    holds, its 8-token suffix prefilled over 192 cached tokens).  Its
    wall time (the request's TTFT under the profiler), device busy time,
    host launch and copy calls, the kernels that take the most device
    time, and the device time and launches of the quantized matmul
    kernels (K4/K5, with any split-K reduction) by kernel name."""
    import torch

    prompt = _prompt(200, 53 if warm else 52)
    if warm:
        _completion(base, prompt, 1)
    with _card_profile() as prof:
        t0 = time.perf_counter()
        _completion(base, prompt, 1)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    quant = [r for r in rows if "quant_matmul" in r[0]]
    what = "warm (192 cached)" if warm else "cold"
    res = dict(wall_ms=wall * 1e3, device_busy_ms=sum(r[2] for r in rows),
               host_calls=sum(_api_calls(prof).values()),
               kernel_launches=sum(r[1] for r in rows),
               top=[dict(name=k[:80], count=c, ms=ms) for k, c, ms in rows[:8]],
               quant_matmul_device_ms=sum(r[2] for r in quant),
               quant_matmul_launches=sum(r[1] for r in quant),
               quant_matmul_kernels=[dict(name=k[:100], count=c, ms=ms)
                                     for k, c, ms in quant])
    log(f"profile, one 200-token prefill, {what}: wall {res['wall_ms']:.1f} ms, device "
        f"busy {res['device_busy_ms']:.2f} ms, {res['kernel_launches']} kernels, "
        f"{res['host_calls']} host launch/copy calls, quant matmul "
        f"{res['quant_matmul_device_ms']:.3f} ms in {res['quant_matmul_launches']} launches")
    for r in res["top"]:
        log(f"  {r['ms']:8.3f} ms  x{r['count']:5d}  {r['name']}")
    return res


def _timed_tokens(engine, prompt: str, n: int, grammar=None,
                  adapter: str = "") -> list[float]:
    """Submit one greedy request (under ``grammar``, through ``adapter``
    when given) straight to the serving engine and stamp the host clock
    as each token is delivered (the moment the server could stream it)."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    req = engine.submit(engine.tokenizer.encode(prompt), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True, grammar=grammar),
        adapter=adapter)
    stamps = [time.perf_counter() for _ in req.stream()]
    if len(stamps) != n:
        raise SmokeFailure(f"asked {n} tokens, got {len(stamps)}")
    return stamps


def _quantile(xs, f):
    xs = sorted(xs)
    i = f * (len(xs) - 1)
    lo = int(math.floor(i))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (i - lo)


def _itl(stamps) -> dict:
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return dict(decode_tok_s=len(gaps) / (stamps[-1] - stamps[0]),
                itl_p50_ms=_quantile(gaps, 0.5), itl_p90_ms=_quantile(gaps, 0.9),
                itl_max_ms=max(gaps))


def pick_run_ahead(single: dict) -> int:
    """The smallest fused window whose single-stream median decode rate
    beats K=1's by more than the larger of the two interquartile ranges;
    1 when none does."""
    def iqr(v):
        return _quantile(v, 0.75) - _quantile(v, 0.25)

    base = single[1]
    for k in sorted(single):
        if k == 1:
            continue
        gain = _quantile(single[k], 0.5) - _quantile(base, 0.5)
        if gain > max(iqr(base), iqr(single[k])):
            return k
    return 1


def sweep_run_ahead(engine, values=(1, 2, 4, 8, 16), reps=6):
    """Decode rate and inter-token latency per fused-window size K,
    ``reps`` rounds with the order of the sizes reversed every other
    round, on two workloads through the serving engine: one sequence
    alone (200-token prompt, 129 tokens; tokens/s over its 128 decode
    gaps, and the gaps' p50/p90/max), and 8 concurrent requests of 128
    tokens (aggregate tokens/s, prefill included)."""
    single = {k: [] for k in values}
    itl = {k: [] for k in values}
    conc = {k: [] for k in values}
    errors = []

    def run(i):
        try:
            _timed_tokens(engine, _prompt(64, 40 + i), 128)
        except Exception as e:   # reported below; the sweep fails
            errors.append(repr(e))

    for rep in range(reps):
        for k in (values if rep % 2 == 0 else values[::-1]):
            engine.run_ahead = k
            r = _itl(_timed_tokens(engine, _prompt(200, 60 + rep), 129))
            single[k].append(r["decode_tok_s"])
            itl[k].append(r)
            ths = [threading.Thread(target=run, args=(i,)) for i in range(8)]
            t0 = time.perf_counter()
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            conc[k].append(8 * 128 / (time.perf_counter() - t0))
            if errors:
                raise SmokeFailure(f"sweep requests failed: {errors}")
    pick = pick_run_ahead(single)
    for k in values:
        med = {f: _quantile([r[f] for r in itl[k]], 0.5)
               for f in ("itl_p50_ms", "itl_p90_ms", "itl_max_ms")}
        log(f"run_ahead={k}: single " + " ".join(f"{x:.2f}" for x in single[k])
            + f" tok/s (median {_quantile(single[k], 0.5):.2f}, IQR "
            f"{_quantile(single[k], 0.75) - _quantile(single[k], 0.25):.2f}); "
            f"ITL median of p50/p90/max {med['itl_p50_ms']:.1f}/"
            f"{med['itl_p90_ms']:.1f}/{med['itl_max_ms']:.1f} ms; concurrent8 "
            + " ".join(f"{x:.1f}" for x in conc[k]) + " tok/s")
    log(f"run_ahead pick (smallest K beating K=1 by more than the IQR): {pick}")
    return dict(single=single, itl=itl, concurrent8=conc, pick=pick)


# ---------------------------------------------------------------------------
# Phase 9: multi-tenant QoS, deadlines, ITL, prompt scoring and n > 1
# ---------------------------------------------------------------------------

# tests/test_qos.py's document: "acme" guaranteed, everyone else
# best-effort with a queue budget of 4
QOS_DOC = json.dumps({
    "classes": {"guaranteed": {"priority": 100, "weight": 8},
                "best-effort": {"priority": 0, "weight": 1, "max_queue_len": 4}},
    "tenants": {"acme": "guaranteed"}, "default_class": "best-effort"})
QOS_FLAGS = ["--qos-config", QOS_DOC, "--itl", "--kv-shed-threshold", "0.95",
             "--max-queue-len", "64"]
QOS_LEG = ("qos-bf16", "phase 9, bf16, QoS + deadlines + ITL + scoring")
# best-effort flood threads: each holds at most one request, so with 8
# slots it takes more than 8 + 4 of them to pass the tenant's queue
# budget of 4 (tests/test_qos.py's ten outran the JAX test server's
# smaller batch)
FLOOD_THREADS = 16
# a served greedy continuation's bf16 logprobs (prefill, then replayed
# decode windows) against the same tokens scored by one cache-less bf16
# forward: the two sum in different orders
SCORE_BF16_ATOL = 0.1


def _http(base, path, body, headers=None, timeout=600):
    """(status, headers, body) of one POST, an HTTP error included."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _acme_ttft(base, salt) -> float:
    """TTFT of one streamed acme chat request of 16 tokens (its first
    event comes with its first token); fails unless it completes."""
    req = urllib.request.Request(f"{base}/v1/chat/completions", data=json.dumps(dict(
        messages=[{"role": "user", "content": _prompt(200, salt)}], max_tokens=16,
        temperature=0.0, ignore_eos=True, stream=True)).encode(),
        headers={"Content-Type": "application/json", "X-Kaito-Tenant": "acme",
                 "X-Request-Id": f"acme-{salt}"})
    t0 = time.perf_counter()
    first, done, finish = None, False, None
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if not line.startswith(b"data:"):
                continue
            if first is None:
                first = time.perf_counter() - t0
            if b"[DONE]" in line:
                done = True
                break
            ch = json.loads(line[5:]).get("choices") or [{}]
            finish = ch[0].get("finish_reason") or finish
    if not done or finish != "length":
        raise SmokeFailure(f"acme request {salt} did not complete: done {done}, "
                           f"finish {finish}")
    return first


def _ttft_parts(base, salt) -> dict:
    """Where one acme request's TTFT went, from its spans (ms): queue
    wait, staged until its first prefill dispatch, its prefill chunks,
    and submit to first token on the engine's clock."""
    sp = _spans(base, f"acme-{salt}")
    req, adm = sp["request"][0], sp["admit"][0]
    chunks = sorted(sp["prefill.chunk"], key=lambda a: a["ts_ms"])
    return dict(queue_ms=sp["queue.wait"][0]["dur_ms"],
                staged_ms=chunks[0]["queue_wait"] * 1e3,
                prefill_ms=sum(c["dur_ms"] for c in chunks),
                prefill_pack=max(c.get("pack", 1) for c in chunks),
                engine_ttft_ms=sp["decode"][0]["ts_ms"] - req["ts_ms"],
                preemptions=req["preemptions"], cached_tokens=adm["cached_tokens"])


def _wait_idle(engine, what, limit=300.0):
    deadline = time.monotonic() + limit
    while engine.num_running or engine.num_waiting or any(
            s.request is not None for s in engine.slots):
        if time.monotonic() > deadline:
            raise SmokeFailure(f"engine not idle after {what}")
        time.sleep(0.01)


def _wait_running(engine, n, what, limit=120.0):
    deadline = time.monotonic() + limit
    while engine.num_running < n:
        if time.monotonic() > deadline:
            raise SmokeFailure(f"{what}: {engine.num_running} of {n} slots decoding")
        time.sleep(0.002)


def _spans(base, rid) -> dict:
    status, raw = _get(f"{base}/debug/trace?trace_id={rid}")
    if status != 200:
        raise SmokeFailure(f"/debug/trace?trace_id={rid} answered {status}")
    out: dict = {}
    for e in json.loads(raw)["traceEvents"]:
        if e["ph"] == "X":
            out.setdefault(e["name"], []).append(dict(
                e["args"], ts_ms=e["ts"] / 1e3, dur_ms=e["dur"] / 1e3))
    return out


def _label(lbl, name):
    m = re.search(name + r'="([^"]*)"', lbl)
    return m.group(1) if m else None


def _labelled(samples, family) -> dict:
    """{tenant: value} of a per-tenant family."""
    return {_label(lbl, "tenant"): v for n, lbl, v in samples if n == family}


def _hist_quantile(samples, family, q) -> float:
    """Upper bucket edge holding quantile ``q`` of a histogram family."""
    buckets = sorted((float(_label(lbl, "le")), v) for n, lbl, v in samples
                     if n == family + "_bucket")
    total = buckets[-1][1]
    return next(le for le, cum in buckets if cum >= q * total)


def _flood(base, threads, stop, out):
    """The best-effort flood, in a process of its own (as the JAX test's
    clients are, beside its server): ``threads`` threads of tenant
    "free" send 24-token requests until ``stop`` is set, pausing 50 ms
    after each 429; ``out`` gets (served, shed, errors)."""
    served, sheds, errors = [], [], []

    def run():
        while not stop.is_set():
            status, hdrs, raw = _http(base, "/v1/completions", dict(
                prompt="qos overload probe " * 3, max_tokens=24, temperature=0.0,
                ignore_eos=True), {"X-Kaito-Tenant": "free"})
            if status == 200:
                served.append(1)
            elif status == 429 and hdrs.get("Retry-After"):
                sheds.append(1)
                stop.wait(0.05)
            else:
                errors.append(f"{status} {raw[:200]!r}")
                return

    ths = [threading.Thread(target=run) for _ in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    out.put((len(served), len(sheds), errors))


def qos_overload(base, engine, label) -> dict:
    """tests/test_qos.py:542-618 on the card: acme's TTFT alone (five
    streamed requests after two warm-ups), then under a best-effort
    flood of 24-token requests from ``FLOOD_THREADS`` threads of another
    process, six more.  acme always completes and is never shed; the
    flood takes 429s, each with a Retry-After; the per-tenant shed
    counters say so; acme's loaded TTFT p50 holds max(2x its unloaded
    p50, it + 0.25 s)."""
    import multiprocessing

    for i in range(2):
        _acme_ttft(base, 900 + i)
    baseline = [_acme_ttft(base, 902 + i) for i in range(5)]
    pre0 = engine.counters["preemptions_total"]
    ctx = multiprocessing.get_context("spawn")
    stop, out = ctx.Event(), ctx.Queue()
    proc = ctx.Process(target=_flood, args=(base, FLOOD_THREADS, stop, out))
    proc.start()
    try:
        # the flood fills the slots and the queue
        deadline = time.monotonic() + 60
        while engine.num_waiting_for("free") < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(1.0)
        loaded = [_acme_ttft(base, 910 + i) for i in range(6)]
    finally:
        stop.set()
        try:
            n_served, n_shed, errors = out.get(timeout=300)
        finally:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    served, sheds = [1] * n_served, [1] * n_shed
    _wait_idle(engine, "the flood")
    # where acme's TTFT went, alone and under the flood (medians, ms)
    parts = {}
    for key, salts in (("alone", range(902, 907)), ("loaded", range(910, 916))):
        rows = [_ttft_parts(base, s) for s in salts]
        parts[key] = {k: _quantile([r[k] for r in rows], 0.5) for k in rows[0]}
    log(f"{label}: acme's TTFT by span (medians, ms): alone {parts['alone']}; "
        f"under the flood {parts['loaded']}")
    preemptions = engine.counters["preemptions_total"] - pre0
    b50, l50 = _quantile(baseline, 0.5), _quantile(loaded, 0.5)
    status, raw = _get(f"{base}/metrics")
    from kaito_tpu_torch.utils.promtext import parse_exposition

    samples = parse_exposition(raw.decode())
    shed_by = _labelled(samples, "kaito:requests_shed_total")
    served_by = _labelled(samples, "kaito:requests_served_total")
    log(f"{label}: acme TTFT p50 alone {b50 * 1e3:.1f} ms ({', '.join(f'{x * 1e3:.1f}' for x in baseline)}), "
        f"under a {FLOOD_THREADS}-thread best-effort flood {l50 * 1e3:.1f} ms "
        f"({', '.join(f'{x * 1e3:.1f}' for x in loaded)}); flood: {len(served)} served, "
        f"{len(sheds)} shed (429 + Retry-After); preemptions {preemptions}; shed by "
        f"tenant {shed_by}, served by tenant {served_by}")
    if errors:
        raise SmokeFailure(f"{label}: flood requests failed: {errors[:3]}")
    if not sheds:
        raise SmokeFailure(f"{label}: the flood never outran the best-effort budget")
    if shed_by.get("free", 0) < len(sheds) or shed_by.get("acme", 0.0) != 0.0:
        raise SmokeFailure(f"{label}: per-tenant sheds {shed_by}, {len(sheds)} seen")
    if l50 > max(2 * b50, b50 + 0.25):
        raise SmokeFailure(f"{label}: acme's loaded TTFT p50 {l50 * 1e3:.1f} ms above "
                           f"max(2 x {b50 * 1e3:.1f}, {b50 * 1e3:.1f} + 250) ms")
    return dict(acme_ttft_alone_ms=[x * 1e3 for x in baseline],
                acme_ttft_loaded_ms=[x * 1e3 for x in loaded],
                acme_ttft_p50_alone_ms=b50 * 1e3, acme_ttft_p50_loaded_ms=l50 * 1e3,
                flood_threads=FLOOD_THREADS, flood_served=len(served),
                flood_shed=len(sheds), preemptions=preemptions,
                shed_by_tenant=shed_by, served_by_tenant=served_by,
                ttft_parts=parts)


def _free_batch(base, engine, n, tokens, salt, tag):
    """``n`` best-effort requests of ``tokens`` tokens in threads, each
    with the X-Request-Id ``{tag}-{i}``, each sent once the one before
    has left the queue (the tenant's queue budget is 4): (threads, their
    results)."""
    results = {}

    def run(i):
        results[i] = _http(base, "/v1/completions", dict(
            prompt=_prompt(100, salt + i), max_tokens=tokens, temperature=0.0,
            ignore_eos=True), {"X-Kaito-Tenant": "free", "X-Request-Id": f"{tag}-{i}"})

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        queued = engine.counters["requests_total"]
        t.start()
        deadline = time.monotonic() + 60
        while (engine.counters["requests_total"] == queued
               or engine.num_waiting_for("free")) and time.monotonic() < deadline:
            time.sleep(0.001)
    return threads, results


def _all_served(threads, results, tokens, what):
    for t in threads:
        t.join(timeout=600)
    bad = {i: r[0] for i, r in results.items() if r[0] != 200 or json.loads(
        r[2])["usage"]["completion_tokens"] != tokens}
    if bad or len(results) != len(threads):
        raise SmokeFailure(f"{what}: requests not served whole: {bad}")


def qos_slot_preemption(base, engine, label) -> dict:
    """Every slot held by a best-effort decode: one acme request takes a
    slot from them and completes unpreempted; a best-effort request
    shows a ``preempt`` span, and all of them finish every token."""
    n = len(engine.slots)
    threads, results = _free_batch(base, engine, n, 200, 950, "free-held")
    _wait_running(engine, n, f"{label}: slot preemption")
    t0 = time.perf_counter()
    status, _, raw = _http(base, "/v1/completions", dict(
        prompt=_prompt(100, 960), max_tokens=16, temperature=0.0, ignore_eos=True),
        {"X-Kaito-Tenant": "acme", "X-Request-Id": "acme-claims-a-slot"})
    dt = time.perf_counter() - t0
    if status != 200 or json.loads(raw)["usage"]["completion_tokens"] != 16:
        raise SmokeFailure(f"{label}: acme request answered {status} {raw[:200]!r}")
    _all_served(threads, results, 200, f"{label}: held slots")
    acme = _spans(base, "acme-claims-a-slot")["request"][0]
    preempted = [i for i in range(n) if "preempt" in _spans(base, f"free-held-{i}")]
    log(f"{label}: with {n} best-effort decodes holding every slot, acme's 16 tokens "
        f"took {dt * 1e3:.1f} ms, {acme['preemptions']} preemptions; best-effort "
        f"requests preempted: {preempted}, all {n} served whole")
    if acme["preemptions"] != 0 or not preempted:
        raise SmokeFailure(f"{label}: acme preemptions {acme['preemptions']}, "
                           f"best-effort preempted {preempted}")
    return dict(acme_ms=dt * 1e3, acme_preemptions=acme["preemptions"],
                best_effort_preempted=preempted)


def qos_deadlines(base, engine, label) -> dict:
    """A request queued behind a full batch with "timeout": 0.05 answers
    408 and burns no prompt token; a 400-token decode with "timeout": 1.0
    answers 408 cut mid-decode; every page comes back."""
    c = engine.counters
    _wait_idle(engine, "the slot check")
    avail0, exp0 = engine.allocator.available, c["requests_expired_total"]
    n = len(engine.slots)
    threads, results = _free_batch(base, engine, n, 160, 970, "fill")
    _wait_running(engine, n, f"{label}: deadline fill")
    p0 = c["prompt_tokens_total"]
    t0 = time.perf_counter()
    status, _, raw = _http(base, "/v1/completions", dict(
        prompt=_prompt(100, 980), max_tokens=8, temperature=0.0, ignore_eos=True,
        timeout=0.05), {"X-Kaito-Tenant": "free"})
    queued_ms = (time.perf_counter() - t0) * 1e3
    err = json.loads(raw).get("error", {})
    if status != 408 or err.get("type") != "deadline_exceeded":
        raise SmokeFailure(f"{label}: a queued request past its deadline answered "
                           f"{status} {raw[:200]!r}")
    if c["requests_expired_total"] != exp0 + 1 or c["prompt_tokens_total"] != p0:
        raise SmokeFailure(f"{label}: expired {c['requests_expired_total'] - exp0}, "
                           f"prompt tokens grew by {c['prompt_tokens_total'] - p0}")
    _all_served(threads, results, 160, f"{label}: deadline fill")
    _wait_idle(engine, "the deadline fill")
    t0 = time.perf_counter()
    status, _, raw = _http(base, "/v1/completions", dict(
        prompt=_prompt(100, 981), max_tokens=400, temperature=0.0, ignore_eos=True,
        timeout=1.0), {"X-Kaito-Tenant": "acme", "X-Request-Id": "cut-at-1s"})
    cut_ms = (time.perf_counter() - t0) * 1e3
    _wait_idle(engine, "the cut request")
    tokens = _spans(base, "cut-at-1s")["decode"][0]["tokens"]
    if status != 408 or not 0 < tokens < 400:
        raise SmokeFailure(f"{label}: the 1 s decode answered {status} after "
                           f"{tokens} tokens")
    if engine.allocator.available != avail0:
        raise SmokeFailure(f"{label}: {engine.allocator.available} pages free after "
                           f"the deadlines, {avail0} before")
    log(f"{label}: deadlines: a request queued behind {n} decodes answered 408 in "
        f"{queued_ms:.1f} ms (timeout 50 ms; no prompt token spent); a 400-token "
        f"decode with timeout 1 s answered 408 in {cut_ms:.1f} ms after {tokens} "
        f"tokens; {avail0} pages free before and after")
    return dict(queued_408_ms=queued_ms, cut_408_ms=cut_ms, cut_tokens=tokens,
                pages_free=avail0)


def qos_scoring(base, engine, label) -> dict:
    """``echo`` scoring of a 1000- and a 4000-byte prompt, twice each (a
    bucket's first call also meets its GEMM shapes for the first time):
    one K2 launch a layer each, every value finite and <= 0, None first; then a served
    greedy continuation's logprobs against the same tokens scored."""
    from kaito_tpu_torch.engine.engine import SamplingParams
    from kaito_tpu_torch.engine.ops.flash_prefill import flash_prefill_attention_cuda

    _wait_idle(engine, "the deadlines")
    layers = engine.md.arch.num_layers
    res = {}
    for nbytes, call in ((1000, 1), (4000, 1), (1000, 2), (4000, 2)):
        k2 = flash_prefill_attention_cuda.launches
        t0 = time.perf_counter()
        status, _, raw = _http(base, "/v1/completions", dict(
            prompt=_prompt(nbytes, 995), max_tokens=0, echo=True, logprobs=1),
            {"X-Kaito-Tenant": "acme"})
        ms = (time.perf_counter() - t0) * 1e3
        launched = flash_prefill_attention_cuda.launches - k2
        body = json.loads(raw)
        if status != 200:
            raise SmokeFailure(f"{label}: scoring {nbytes} bytes answered {status} "
                               f"{raw[:200]!r}")
        lps = body["choices"][0]["logprobs"]["token_logprobs"]
        n = body["usage"]["prompt_tokens"]
        if lps[0] is not None or len(lps) != n or not all(
                math.isfinite(x) and x <= 0 for x in lps[1:]):
            raise SmokeFailure(f"{label}: bad scores of {nbytes} bytes: {lps[:4]}")
        if launched != layers:
            raise SmokeFailure(f"{label}: scoring {n} tokens launched K2 {launched} "
                               f"times, not {layers}")
        key = f"{nbytes}_bytes_call{call}"
        res[key] = dict(tokens=n, bucket=max(128, -(-n // 128) * 128), ms=ms,
                        k2_launches=launched, mean_logprob=sum(lps[1:]) / (n - 1))
        log(f"{label}: scored a {nbytes}-byte prompt ({n} tokens, bucket "
            f"{res[key]['bucket']}, call {call}) over HTTP in {ms:.1f} ms, K2 "
            f"{launched} launches")
    ptoks = engine.tokenizer.encode(_prompt(200, 996))
    req = engine.submit(ptoks, SamplingParams(max_tokens=16, temperature=0.0,
                                              ignore_eos=True, logprobs=True))
    out = list(req.stream())
    scored = engine.score_prompt(ptoks + out)[len(ptoks):len(ptoks) + 16]
    d = max(abs(a - b) for a, b in zip(scored, req.output_logprobs))
    log(f"{label}: a served greedy continuation's 16 logprobs (mean "
        f"{sum(req.output_logprobs) / 16:.4f}) against the same tokens scored: max "
        f"diff {d:.4f} (bf16 tolerance {SCORE_BF16_ATOL})")
    if len(out) != 16 or d > SCORE_BF16_ATOL:
        raise SmokeFailure(f"{label}: scored continuation off by {d:.4f}")
    res["served_vs_scored_max_diff"] = d
    res["greedy_mean_logprob"] = sum(req.output_logprobs) / 16
    return res


def qos_choices(base, engine, label, submitted) -> dict:
    """``n``: four greedy choices against n=1's; four sampled choices
    whose usage is the sum of theirs; n=2 with stream is 400.  Tokens
    are compared as ids, from the engine requests the server made
    (``submitted``): most of a synthetic model's ids decode to no text
    under the byte tokenizer.  A greedy choice equals n=1's tokens up to
    the first position, if any, where the two picked different tokens
    whose logprobs lie within the bf16 tolerance: a near-tie that the
    choices' other prefill batch decides otherwise (the synthetic
    weights' distribution is flat; fp32 choices equal the JAX server's
    on the CPU)."""
    body = dict(prompt=_prompt(60, 997), max_tokens=16, temperature=0.0,
                ignore_eos=True, logprobs=1)
    out, toks, lps = {}, {}, {}
    for key, extra in (("one", {}), ("greedy4", {"n": 4}),
                       ("sampled4", {"n": 4, "temperature": 0.8, "seed": 11})):
        k0 = len(submitted)
        status, _, raw = _http(base, "/v1/completions", dict(body, **extra))
        if status != 200:
            raise SmokeFailure(f"{label}: n {extra} answered {status} {raw[:200]!r}")
        out[key] = json.loads(raw)
        toks[key] = [list(r.output_tokens) for r in submitted[k0:]]
        lps[key] = [list(r.output_logprobs) for r in submitted[k0:]]
    ref, ref_lp = toks["one"][0], lps["one"][0]
    ties = []
    for t, lp in zip(toks["greedy4"], lps["greedy4"]):
        k = next((i for i, (a, b) in enumerate(zip(t, ref)) if a != b), None)
        if len(t) != 16 or (k is not None and abs(lp[k] - ref_lp[k]) > SCORE_BF16_ATOL):
            raise SmokeFailure(f"{label}: n=4 greedy tokens {toks['greedy4']} against "
                               f"n=1's {ref}")
        ties.append(None if k is None else (k, abs(lp[k] - ref_lp[k])))
    if len(toks["greedy4"]) != 4 or out["greedy4"]["usage"]["completion_tokens"] != 64:
        raise SmokeFailure(f"{label}: n=4 greedy usage {out['greedy4']['usage']}")
    sampled = out["sampled4"]
    per = [len(c["logprobs"]["tokens"]) for c in sampled["choices"]]
    if [c["index"] for c in sampled["choices"]] != [0, 1, 2, 3] or \
            sampled["usage"]["completion_tokens"] != sum(per) or \
            [len(t) for t in toks["sampled4"]] != per:
        raise SmokeFailure(f"{label}: n=4 sampled usage {sampled['usage']}, choices {per}")
    status, _, _ = _http(base, "/v1/completions", dict(body, n=2, stream=True))
    if status != 400:
        raise SmokeFailure(f"{label}: n=2 with stream answered {status}")
    distinct = len({tuple(t) for t in toks["sampled4"]})
    log(f"{label}: n=4 greedy against n=1's tokens, (first differing position, "
        f"logprob gap) a choice: {ties}; n=4 at temperature 0.8: usage "
        f"{sampled['usage']['completion_tokens']} = {per}, {distinct} distinct token "
        f"sequences; n=2 + stream 400")
    return dict(greedy_near_ties=ties, sampled_distinct=distinct)


@contextlib.contextmanager
def _gc_pauses(label):
    """Garbage collections while the block runs, by generation: count,
    total and longest ms (each one holds every Python thread), logged on
    exit; yields the dict it fills."""
    out = {f"gen{g}": {"count": 0, "total_ms": 0.0, "max_ms": 0.0} for g in range(3)}
    started = {}

    def cb(phase, info):
        g = info["generation"]
        if phase == "start":
            started[g] = time.perf_counter()
        elif g in started:
            ms = (time.perf_counter() - started.pop(g)) * 1e3
            c = out[f"gen{g}"]
            c["count"] += 1
            c["total_ms"] += ms
            c["max_ms"] = max(c["max_ms"], ms)

    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)
        log(f"{label}: garbage collections {out}")


def run_qos_phase(label) -> tuple[dict, dict]:
    """Phase 9: Llama-3.1-8B at full width in bf16 behind the QoS
    document, ITL on, KV shedding at 0.95 and a queue of 64 (the server's
    own flags), through :func:`qos_overload`, :func:`qos_slot_preemption`,
    :func:`qos_deadlines`, the ITL count, :func:`qos_scoring` and
    :func:`qos_choices`.  Returns the launches of K1, K2 and K3, zeroed
    just before the requests, and the readings."""
    import torch

    from kaito_tpu_torch.engine.server import make_server, parse_args
    from kaito_tpu_torch.utils.promtext import check_histograms, parse_exposition

    counted = ("paged_decode_attention", "flash_prefill_attention",
               "flash_prefill_packed")
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16", "--max-num-seqs",
                         "8", "--seed", "0", *QOS_FLAGS])
    t0 = time.perf_counter()
    server = make_server(None, cfg, host="127.0.0.1", port=0, device="cuda")
    engine = server.state.engine
    if engine.qos is None or engine.itl_hist is None:
        raise SmokeFailure(f"{label}: QoS {engine.qos}, ITL {engine.itl_hist}")
    log(f"{label}: engine up in {time.perf_counter() - t0:.1f}s; QoS classes "
        f"{sorted(engine.qos.classes)}, ITL on, kv_shed_threshold "
        f"{cfg.kv_shed_threshold}, max_queue_len {cfg.max_queue_len}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    # every request the leg submits, for the ITL count
    submitted = []
    submit = engine.submit

    def recording(*a, **kw):
        req = submit(*a, **kw)
        submitted.append(req)
        return req

    engine.submit = recording
    stats = {}
    try:
        for name in counted:
            fn, attr = _counter(name)
            setattr(fn, attr, 0)
        with _gc_pauses(label + ", acme alone and under the flood") as pauses:
            stats["overload"] = qos_overload(base, engine, label)
        stats["overload"]["gc"] = pauses
        stats["slot_preemption"] = qos_slot_preemption(base, engine, label)
        stats["deadlines"] = qos_deadlines(base, engine, label)
        # the ITL recorder beside the client's own stamps of one sequence
        gaps, observe = [], engine.itl_observer
        engine.itl_observer = lambda g, t: (gaps.append(g), observe(g, t))
        single = _itl(_timed_tokens(engine, _prompt(200, 990), 129))
        engine.itl_observer = observe
        stats["scoring"] = qos_scoring(base, engine, label)
        stats["choices"] = qos_choices(base, engine, label, submitted)
        _wait_idle(engine, "the leg")
        torch.cuda.synchronize()
        launches = {name: getattr(*_counter(name)) for name in counted}
        want = sum(max(0, len(r.output_tokens) - 1) for r in submitted)
        count = engine.itl_hist.count
        status, raw = _get(f"{base}/metrics")
        samples = parse_exposition(raw.decode())
        check_histograms(samples)
        status, raw = _get(f"{base}/debug/slo")
        slo = json.loads(raw)
        fast = slo["sli"]["fast"]
        stalls = engine.counters["itl_stalls_total"]
        hist = {q: _hist_quantile(samples, "kaito:inter_token_latency_seconds", q)
                for q in (0.5, 0.99)}
        mine = sorted(g * 1e3 for g in gaps)
        stats["itl"] = dict(
            count=count, tokens_minus_one=want, requests=len(submitted),
            stalls=stalls, slo_itl_p50_ms=fast["itl_p50_s"] * 1e3,
            slo_itl_p99_ms=fast["itl_p99_s"] * 1e3,
            hist_p50_le_ms=hist[0.5] * 1e3, hist_p99_le_ms=hist[0.99] * 1e3,
            one_sequence_engine=dict(gaps=len(gaps), p50_ms=_quantile(mine, 0.5),
                                     p99_ms=_quantile(mine, 0.99), max_ms=mine[-1]),
            one_sequence_client=single)
        log(f"{label}: ITL: kaito:inter_token_latency_seconds count {count} over "
            f"{len(submitted)} requests (their tokens - 1: {want}), {stalls} stalls "
            f"above {cfg.slo_itl_p99_ms:.0f} ms; /debug/slo fast window p50/p99 "
            f"{fast['itl_p50_s'] * 1e3:.2f}/{fast['itl_p99_s'] * 1e3:.2f} ms, "
            f"histogram buckets <= {hist[0.5] * 1e3:.0f}/{hist[0.99] * 1e3:.0f} ms; one "
            f"sequence alone: engine stamps p50/p99/max {_quantile(mine, 0.5):.2f}/"
            f"{_quantile(mine, 0.99):.2f}/{mine[-1]:.2f} ms over {len(gaps)} gaps, "
            f"client stamps p50/p90/max {single['itl_p50_ms']:.2f}/"
            f"{single['itl_p90_ms']:.2f}/{single['itl_max_ms']:.2f} ms")
        if count != want or len(gaps) != 128:
            raise SmokeFailure(f"{label}: ITL count {count}, tokens - 1 {want}; "
                               f"{len(gaps)} gaps of one 129-token sequence")
        if "itl_p99" not in slo["burn_rates"] or "acme" not in slo.get("tenants", {}):
            raise SmokeFailure(f"{label}: /debug/slo lacks itl_p99 or the tenants: "
                               f"{sorted(slo)}")
        fams = {n for n, _, _ in samples}
        for fam in ("kaito:inter_token_latency_seconds_count", "kaito:itl_stalls_total",
                    "kaito:requests_shed_total", "kaito:requests_served_total",
                    "kaito:slo_tenant_ttft_p50_seconds", "kaito:slo_itl_p99_seconds"):
            if fam not in fams:
                raise SmokeFailure(f"{label}: /metrics lacks {fam}")
        windows = engine.counters["decode_windows_total"]
        replays = engine.counters["decode_graph_replays_total"]
        if replays < windows:
            raise SmokeFailure(f"{label}: {windows} decode windows, {replays} replays")
        stats.update(launches=launches, decode_windows=windows, graph_replays=replays,
                     preemptions_total=engine.counters["preemptions_total"],
                     expired_total=engine.counters["requests_expired_total"],
                     shed_total=engine.counters["requests_shed_total"])
        log(f"{label}: launches {launches}; {windows} decode windows, {replays} "
            f"graph replays")
    finally:
        del engine.submit
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    return launches, stats


# ---------------------------------------------------------------------------
# Phase 10: speculative decoding at full width
# ---------------------------------------------------------------------------

SPEC_LEG = ("spec-bf16", "phase 10, bf16 speculation: n-gram and draft model")
_DRAFT = "llama-3.2-1b-instruct"
# bf16 greedy streams of two paths (a verify window's [B, W] forward
# against decode steps) sum in different orders: on the flat synthetic
# distribution they may part at a near-tie, where both picks' logprobs
# must agree within this (as the `n` check of phase 9)
SPEC_TIE_ATOL = 0.1
_SPEC_TEXTS = ("The cat sat on the mat. ", "one two three four five ",
               "abc def ghi jkl ", "Kubernetes operators serve models. ")


def _spec_prompts(engine) -> list[list[int]]:
    """Four repetitive prompts (a sentence repeated to ~240 bytes)."""
    return [engine.tokenizer.encode(t * (240 // len(t))) for t in _SPEC_TEXTS]


def _spec_batch(engine, prompts, params) -> list:
    """``prompts`` submitted together to a fresh (not started) engine with
    ``params`` each, driven step by step; the finished requests."""
    reqs = [engine.submit(list(p), sp) for p, sp in zip(prompts, params)]
    for _ in range(20000):
        engine.step()
        if all(r.finish_reason for r in reqs):
            break
    if not all(r.finish_reason == "length" for r in reqs):
        raise SmokeFailure(f"batch did not finish: {[r.finish_reason for r in reqs]}")
    return reqs


def _greedy_params(n, k=1):
    from kaito_tpu_torch.engine.engine import SamplingParams

    return [SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True,
                           logprobs=True) for _ in range(k)]


def _same_or_tie(got, want, label) -> list[int]:
    """Each request's tokens against the reference's: equal, or equal up
    to a near-tie (at the first divergence both picks' logprobs within
    SPEC_TIE_ATOL).  Returns the equal prefix lengths."""
    prefix = []
    for g, w in zip(got, want):
        a, b = g.output_tokens, w.output_tokens
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
        if j < len(a):
            d = abs(g.output_logprobs[j] - w.output_logprobs[j])
            if d > SPEC_TIE_ATOL:
                raise SmokeFailure(f"{label}: greedy tokens part from the plain "
                                   f"engine's at {j} ({a[j]} vs {b[j]}), logprobs "
                                   f"{g.output_logprobs[j]:.4f} vs "
                                   f"{w.output_logprobs[j]:.4f}: not a near-tie")
        prefix.append(j)
    return prefix


def _seed_check(engine, prompt, label) -> dict:
    """A seeded sampled request (seed 7) twice, alone, on the same slot:
    equal tokens; seed 8: others.  The prompt is cut under one page, so
    no run takes it from the prefix cache (a cached prefill sums in
    another order, and a bf16 draw may then part at a near-tie)."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    prompt = prompt[:engine.cfg.page_size - 8]

    def run(seed):
        sp = SamplingParams(max_tokens=24, temperature=0.8, seed=seed, ignore_eos=True)
        return _spec_batch(engine, [prompt], [sp])[0].output_tokens

    a, b, c = run(7), run(7), run(8)
    if a != b or a == c:
        raise SmokeFailure(f"{label}: seed 7 gave {a} then {b}; seed 8 gave {c}")
    log(f"{label}: seed 7 twice: the same 24 tokens; seed 8: others")
    return dict(seed_reproduces=True, seeds_differ=True)


def _alone(engine, prompt_text, n=129) -> dict:
    """One greedy sequence alone through the started engine: ms a token
    after the first, and its tokens a target forward (a decode window
    of K steps is K forwards, a verify round one)."""
    c = engine.counters
    steps = c["decode_steps_total"]
    engine.start()
    try:
        stamps = _timed_tokens(engine, prompt_text, n)
    finally:
        engine.stop()
    return dict(ms_per_token=(stamps[-1] - stamps[0]) * 1e3 / (n - 1),
                tokens_per_target_forward=(n - 1) / (c["decode_steps_total"] - steps))


def _profile_rounds(engine, prompt, steps=8) -> dict:
    """Host launch/copy calls and device kernels a scheduler step of one
    sequence decoding alone (its prefill done first), profiled over
    ``steps`` steps, with how many of them were verify rounds."""
    import torch

    from kaito_tpu_torch.engine.engine import SamplingParams

    req = engine.submit(list(prompt), SamplingParams(max_tokens=steps * 6 + 8,
                                                     temperature=0.0, ignore_eos=True))
    while not req.output_tokens:
        engine.step()
    c = engine.counters
    r0, d0, t0 = c["spec_steps_total"], c["decode_steps_total"], len(req.output_tokens)
    torch.cuda.synchronize()
    with _card_profile() as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    calls = _api_calls(prof)
    kernels = sum(r[1] for r in _device_rows(prof))
    res = dict(steps=steps, verify_rounds=c["spec_steps_total"] - r0,
               target_forwards=c["decode_steps_total"] - d0,
               tokens=len(req.output_tokens) - t0,
               host_calls_per_step=sum(calls.values()) / steps,
               host_calls_by_name={k: v / steps for k, v in calls.items()},
               device_kernels_per_step=kernels / steps)
    while not req.finish_reason:
        engine.step()
    return res


def _verify_ms(engine, label) -> dict:
    """Card ms of one replay of each captured verify graph from its last
    inputs (CUDA events), and of the plain context attention at one
    layer at that width.  Run last: a replay rewrites its rows' window."""
    import torch

    from kaito_tpu_torch.engine import attention as attn

    v = engine.spec_verify
    res = {}
    for (width, rnd, lora, gcap), g in v.graphs.items():
        grammar = "" if gcap is None else f" grammar {gcap}"
        adapters = " adapters" if lora else ""
        res[f"width {width} random {rnd}{adapters}{grammar}"] = time_ms(
            g.graph.replay, iters=10)[0]
    m, c, a = engine.model, engine.cache, engine.md.arch
    width = max(w for w, *_ in v.graphs)
    B, W = v.B, v.W
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, W, a.num_heads, a.head_dim, generator=gen,
                    device="cuda").to(m.dtype)
    pt = torch.arange(1, 1 + B * width, dtype=torch.int32, device="cuda").reshape(B, width)
    start = torch.full((B,), width * engine.cfg.page_size - W, dtype=torch.int32,
                       device="cuda")
    lens = torch.full((B,), W, dtype=torch.int32, device="cuda")
    ctx, _ = time_ms(lambda: attn.paged_context_attention(
        q, c.k, c.v, pt, start, lens, scale=m._scale, layer=0), iters=10)
    res["context_attention_ms_per_layer"] = ctx
    res["context_attention_width"] = width
    res["layers"] = a.num_layers
    log(f"{label}: verify graph replays (card ms) {res}")
    return res


def _spec_engine_stats(engine, label) -> dict:
    c = engine.counters
    v = engine.spec_verify.stats()
    res = dict(verify_captures=v["captures"], verify_replays=v["replays"],
               verify_eager=c["spec_verify_eager_total"],
               verify_graphs=[dict(key=g["key"], kernel_nodes=g["nodes"]["kernel"],
                                   replays=g["replays"]) for g in v["graphs"]],
               counters={k: n for k, n in c.items() if k.startswith("spec_")},
               decode_steps=c["decode_steps_total"],
               decode_graph_replays=c["decode_graph_replays_total"])
    if res["verify_eager"] or res["verify_replays"] != c["spec_steps_total"]:
        raise SmokeFailure(f"{label}: {c['spec_steps_total']} verify rounds, "
                           f"{res['verify_replays']} graph replays, "
                           f"{res['verify_eager']} eager")
    if engine.spec_draft is not None:
        s = engine.spec_draft.scan.stats()
        k1 = "paged_decode_attention_cuda.launches"
        res.update(scan_captures=s["captures"], scan_replays=s["replays"],
                   scan_graphs=[dict(key=g["key"], kernel_nodes=g["nodes"]["kernel"],
                                     replays=g["replays"], k1_per_replay=g["launches"]
                                     .get(k1, 0)) for g in s["graphs"]])
        res["k1_launches_on_draft_scan"] = sum(g["replays"] * g["k1_per_replay"]
                                               for g in res["scan_graphs"])
        if s["replays"] != c["spec_draft_steps_total"] or \
                res["k1_launches_on_draft_scan"] <= 0:
            raise SmokeFailure(f"{label}: {c['spec_draft_steps_total']} draft "
                               f"rounds, scan {s}")
    return res


def _check_spec_metrics(engine, cfg, label) -> dict:
    """``/metrics`` of a server over ``engine``: the kaito:spec_* series
    equal the engine's counters."""
    from kaito_tpu_torch.engine.server import make_server
    from kaito_tpu_torch.utils.promtext import parse_exposition

    server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, raw = _get(f"http://127.0.0.1:{server.server_address[1]}/metrics")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if status != 200:
        raise SmokeFailure(f"{label}: /metrics answered {status}")
    got = {n + lbl: v for n, lbl, v in parse_exposition(raw.decode())
           if n.startswith("kaito:spec_")}
    c = engine.counters
    want = {'kaito:spec_proposed_tokens_total{mode="ngram"}':
            c["spec_proposed_tokens_total"],
            'kaito:spec_proposed_tokens_total{mode="draft"}':
            c["spec_draft_proposed_tokens_total"],
            'kaito:spec_accepted_tokens_total{mode="ngram"}':
            c["spec_accepted_tokens_total"],
            'kaito:spec_accepted_tokens_total{mode="draft"}':
            c["spec_draft_accepted_tokens_total"],
            "kaito:spec_depth": engine.spec_depth}
    if got != {k: float(v) for k, v in want.items()}:
        raise SmokeFailure(f"{label}: /metrics {got} against the counters {want}")
    log(f"{label}: /metrics kaito:spec_* equal the counters: {got}")
    return got


def run_spec_phase(label) -> tuple[dict, dict]:
    """Phase 10: Llama-3.1-8B at full width in bf16 (phase 4's config,
    synthetic weights from seed 0), three engines sharing one copy of the
    weights: the plain engine (the yardstick, and the seed repair under
    graph replay), n-gram speculation (4 tokens, min match 2) and the
    synthetic ``llama-3.2-1b-instruct`` draft (k=4).  Greedy batches of
    four repetitive prompts against the plain engine's; the draft's
    controller falls back and probes; sampled and seeded requests;
    verify rounds as graph replays; ms per token alone; ``/metrics``.
    Returns the launches of K1, K2 and K3 over the spec engines' runs and
    the readings."""
    import dataclasses

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.server import parse_args

    counted = ("paged_decode_attention", "flash_prefill_attention",
               "flash_prefill_packed")
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16",
                         "--max-num-seqs", "8", "--seed", "0"])
    stats: dict = {}
    t0 = time.perf_counter()
    plain = InferenceEngine(cfg, device="cuda")
    log(f"{label}: plain engine up in {time.perf_counter() - t0:.1f}s")
    prompts = _spec_prompts(plain)
    text = _SPEC_TEXTS[0] * (240 // len(_SPEC_TEXTS[0]))
    want = _spec_batch(plain, prompts, _greedy_params(64, 4))
    stats["plain"] = dict(seed=_seed_check(plain, prompts[1], label + ", plain"),
                          decode_graph_replays=plain.counters["decode_graph_replays_total"])
    if plain.counters["decode_graph_replays_total"] < plain.counters["decode_windows_total"]:
        raise SmokeFailure(f"{label}: the plain engine's windows were not all replays")
    # the seed repair's cost: kernel nodes of a sampled window against a
    # greedy one of the same K (the key's first gate is "any random row")
    graphs = plain.window.stats()["graphs"]
    stats["plain"]["window_kernel_nodes"] = {
        f"K={g['K']} {'sampled' if g['key'].startswith('((True') else 'greedy'}":
        g["nodes"]["kernel"] for g in graphs}
    log(f"{label}: decode window kernel nodes {stats['plain']['window_kernel_nodes']}")
    stats["plain"].update(_alone(plain, text))
    params = plain.model.param_tree()
    del plain
    _release_card(torch)
    launches = {}
    for name in counted:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)

    for mode, extra in (("ngram", dict(speculative_ngram=4, speculative_min_match=2)),
                        ("draft", dict(speculative_draft=_DRAFT, speculative_draft_k=4))):
        lbl = f"{label}, {mode}"
        t0 = time.perf_counter()
        spec_cfg = dataclasses.replace(cfg, **extra)
        eng = InferenceEngine(spec_cfg, params=params, device="cuda")
        log(f"{lbl}: engine up in {time.perf_counter() - t0:.1f}s"
            + (f", draft {eng.spec_draft.model.param_bytes() / 2**30:.2f} GiB + KV "
               f"{2 * eng.spec_draft.cache.k.nbytes / 2**30:.2f} GiB"
               if eng.spec_draft is not None else ""))
        c = eng.counters
        ctl = eng.spec_ctl
        seen = {"ngram": 0, "probe": 0}
        if ctl is not None:
            # the controller's fallbacks and probes, as they happen
            observe, tick = ctl.observe, ctl.note_fallback_round

            def observing(i, p, a, observe=observe, ctl=ctl):
                before = ctl.mode(i)
                observe(i, p, a)
                seen["ngram"] += before == "draft" and ctl.mode(i) == "ngram"

            def ticking(i, tick=tick, ctl=ctl):
                before = ctl.mode(i)
                tick(i)
                seen["probe"] += before == "ngram" and ctl.mode(i) == "draft"

            ctl.observe, ctl.note_fallback_round = observing, ticking
        got = _spec_batch(eng, prompts, _greedy_params(64, 4))
        steps = c["decode_steps_total"]
        emitted = c["generation_tokens_total"] - len(prompts)
        prefix = _same_or_tie(got, want, lbl)
        res = dict(greedy_equal_prefix=prefix, greedy_tokens=64, batch_forwards=steps,
                   batch_tokens_per_forward_a_sequence=emitted / len(prompts) / steps)
        log(f"{lbl}: greedy batch against the plain engine: equal prefixes {prefix} "
            f"of 64; {emitted} tokens of 4 sequences in {steps} target forwards "
            f"({res['batch_tokens_per_forward_a_sequence']:.3f} a forward and "
            f"sequence); counters "
            f"{ {k: n for k, n in c.items() if k.startswith('spec_')} }")
        if mode == "ngram" and c["spec_accepted_tokens_total"] <= 0:
            raise SmokeFailure(f"{lbl}: no n-gram proposal was accepted")
        if mode == "draft":
            res["fallbacks"], res["probes"] = seen["ngram"], seen["probe"]
            if not seen["ngram"] or not seen["probe"]:
                raise SmokeFailure(f"{lbl}: the controller fell back {seen['ngram']} "
                                   f"times and probed {seen['probe']} times")
            sampled = _spec_batch(eng, prompts, [SamplingParams(
                max_tokens=32, temperature=0.8, ignore_eos=True) for _ in prompts])
            if any(len(r.output_tokens) != 32 for r in sampled):
                raise SmokeFailure(f"{lbl}: a temperature-0.8 request lost tokens")
            res["seed"] = _seed_check(eng, prompts[1], lbl)
            log(f"{lbl}: controller fell back {seen['ngram']} times, probed "
                f"{seen['probe']} times; a temperature-0.8 batch of 4 x 32 tokens "
                f"complete; acceptance {c['spec_draft_accepted_tokens_total']} of "
                f"{c['spec_draft_proposed_tokens_total']}")
            res["metrics"] = _check_spec_metrics(eng, spec_cfg, lbl)
        res["rounds"] = _profile_rounds(eng, prompts[0])
        log(f"{lbl}: one sequence, a scheduler step: {res['rounds']}")
        res["engine"] = _spec_engine_stats(eng, lbl)
        log(f"{lbl}: {res['engine']}")
        res.update(_alone(eng, text))
        log(f"{lbl}: one sequence alone {res['ms_per_token']:.3f} ms a token, "
            f"{res['tokens_per_target_forward']:.3f} tokens a target forward; the "
            f"plain engine {stats['plain']['ms_per_token']:.3f} ms")
        if mode == "ngram" and res["tokens_per_target_forward"] <= 1.0:
            raise SmokeFailure(f"{lbl}: {res['tokens_per_target_forward']:.3f} tokens "
                               f"a target forward alone")
        res["verify_ms"] = _verify_ms(eng, lbl)
        stats[mode] = res
        del eng
        _release_card(torch)
    torch.cuda.synchronize()
    launches = {name: getattr(*_counter(name)) for name in counted}
    log(f"{label}: launches {launches}")
    return launches, stats


GRAMMAR_LEG = ("grammar-bf16", "phase 11, bf16 structured output and tool calling")
# finite languages, so a synthetic model's output ends with EOS
_G_SCHEMA = {"type": "object",
             "properties": {"color": {"enum": ["red", "green", "blue"]},
                            "ok": {"type": "boolean"}, "size": {"enum": [1, 2, 3]}},
             "required": ["color", "ok", "size"]}
_G_REGEX = "(yes|no), [a-z]{2,8}\\."
_G_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"enum": ["Paris", "Rome"]}},
                   "required": ["city"]}}},
    {"type": "function", "function": {
        "name": "set_alarm",
        "parameters": {"type": "object", "properties": {"on": {"type": "boolean"}},
                       "required": ["on"]}}}]
# an unbounded language of lowercase words: the timed sequence and the
# speculation batches, whose prompts repeat words of it
_G_WORDS = "([a-z]+ )*"
_G_CHAT = [{"role": "user", "content": "What is the weather in Paris?"}]


def _g_specs():
    """The phase's grammars by name, as the server would compile them."""
    from kaito_tpu_torch.engine.grammar import (GrammarSpec, canonical_schema,
                                                tool_envelope_schema)

    return {"json_schema": GrammarSpec("json_schema", canonical_schema(_G_SCHEMA)),
            "json_object": GrammarSpec("json_object", ""),
            "regex": GrammarSpec("regex", _G_REGEX),
            "words": GrammarSpec("regex", _G_WORDS),
            "tool envelope": GrammarSpec("json_schema", canonical_schema(
                tool_envelope_schema(_G_TOOLS)))}


def _g_walks(g, tokens, eos) -> bool:
    """Every token allowed from the state before it, EOS only where the
    automaton accepts; True when the walk ended with EOS."""
    st = 0
    for t in tokens:
        if not g.allows(st, t):
            raise SmokeFailure(f"token {t} not allowed in state {st}: {tokens}")
        if t == eos:
            return True
        st = g.advance(st, t)
    return False


def _g_call(base, path, body):
    status, _, raw = _http(base, path, body)
    return status, raw


def _g_ok(base, path, body, label, what):
    status, raw = _g_call(base, path, body)
    if status != 200:
        raise SmokeFailure(f"{label}: {what} answered {status}: {raw[:300]!r}")
    return json.loads(raw)["choices"][0]


def _g_http(base, label) -> dict:
    """The structured-output surface over HTTP: JSON schema and regex on
    both endpoints (finite languages: the content parses and matches, and
    finishes ``stop``), ``json_object`` (unbounded: its text must be a
    prefix the automaton accepts), forced, named and ``auto`` tool calls,
    streamed and not, and a seeded constrained sampled request twice."""
    import re

    res = {}
    ch = _g_ok(base, "/v1/chat/completions", dict(
        messages=_G_CHAT, max_tokens=64, temperature=0.0, response_format={
            "type": "json_schema", "json_schema": {"name": "c", "schema": _G_SCHEMA}}),
        label, "a json_schema chat")
    obj = json.loads(ch["message"]["content"])
    if ch["finish_reason"] != "stop" or set(obj) != set(_G_SCHEMA["required"]) \
            or obj["color"] not in ("red", "green", "blue") \
            or not isinstance(obj["ok"], bool) or obj["size"] not in (1, 2, 3):
        raise SmokeFailure(f"{label}: json_schema chat {ch}")
    res["json_schema_chat"] = ch["message"]["content"]
    ch = _g_ok(base, "/v1/completions", dict(
        prompt="A JSON answer: ", max_tokens=64, temperature=0.0, response_format={
            "type": "json_schema", "json_schema": {"schema": _G_SCHEMA}}),
        label, "a json_schema completion")
    if ch["finish_reason"] != "stop" or set(json.loads(ch["text"])) != \
            set(_G_SCHEMA["required"]):
        raise SmokeFailure(f"{label}: json_schema completion {ch}")
    res["json_schema_completion"] = ch["text"]
    for path, body in (("/v1/completions", dict(prompt="The answer is ")),
                       ("/v1/chat/completions", dict(messages=_G_CHAT))):
        ch = _g_ok(base, path, dict(body, max_tokens=32, temperature=0.0,
                                    response_format={"type": "regex",
                                                     "regex": _G_REGEX}),
                   label, f"a regex request on {path}")
        text = ch.get("text", ch.get("message", {}).get("content"))
        if ch["finish_reason"] != "stop" or not re.fullmatch(_G_REGEX, text):
            raise SmokeFailure(f"{label}: regex on {path}: {ch}")
        res[f"regex {path}"] = text
    for path, body in (("/v1/completions", dict(prompt="An object: ")),
                       ("/v1/chat/completions", dict(messages=_G_CHAT))):
        ch = _g_ok(base, path, dict(body, max_tokens=48, temperature=0.0,
                                    response_format={"type": "json_object"}),
                   label, f"a json_object request on {path}")
        text = ch.get("text", ch.get("message", {}).get("content"))
        if not text.startswith("{") or (ch["finish_reason"] == "stop"
                                        and not isinstance(json.loads(text), dict)):
            raise SmokeFailure(f"{label}: json_object on {path}: {ch}")
        res[f"json_object {path}"] = (ch["finish_reason"], len(text))
    for choice, name in (("required", None), ({"type": "function", "function": {
            "name": "set_alarm"}}, "set_alarm")):
        ch = _g_ok(base, "/v1/chat/completions", dict(
            messages=_G_CHAT, tools=_G_TOOLS, tool_choice=choice, max_tokens=64,
            temperature=0.0), label, f"tool_choice {choice}")
        calls = ch["message"].get("tool_calls") or []
        if ch["finish_reason"] != "tool_calls" or len(calls) != 1 or \
                (name and calls[0]["function"]["name"] != name) or \
                not isinstance(json.loads(calls[0]["function"]["arguments"]), dict):
            raise SmokeFailure(f"{label}: tool_choice {choice}: {ch}")
        res[f"tool {name or 'required'}"] = calls[0]["function"]
    # streamed forced call: the argument deltas accumulate to what parses
    status, raw = _g_call(base, "/v1/chat/completions", dict(
        messages=_G_CHAT, tools=_G_TOOLS, tool_choice="required", max_tokens=64,
        temperature=0.0, stream=True))
    events = [json.loads(line[6:]) for line in raw.decode().splitlines()
              if line.startswith("data: {")]
    deltas = [e["choices"][0]["delta"] for e in events]
    calls = [d["tool_calls"][0] for d in deltas if "tool_calls" in d]
    args = "".join(c["function"].get("arguments", "") for c in calls)
    if status != 200 or not calls or calls[0]["function"].get("name") not in (
            "get_weather", "set_alarm") or not isinstance(json.loads(args), dict) \
            or events[-1]["choices"][0]["finish_reason"] != "tool_calls":
        raise SmokeFailure(f"{label}: streamed tool call {status} {deltas}")
    res["tool stream"] = dict(deltas=len(calls), name=calls[0]["function"]["name"],
                              arguments=args)
    for stream in (False, True):
        status, raw = _g_call(base, "/v1/chat/completions", dict(
            messages=_G_CHAT, tools=_G_TOOLS, max_tokens=16, temperature=0.0,
            stream=stream))
        if status != 200:
            raise SmokeFailure(f"{label}: auto tool choice (stream {stream}) {status}")
    res["tool auto"] = "200 streamed and not"

    def seeded(seed):
        ch = _g_ok(base, "/v1/completions", dict(
            prompt="Words: ", max_tokens=24, temperature=0.8, seed=seed, logprobs=1,
            response_format={"type": "regex", "regex": _G_WORDS}), label,
            "a seeded constrained request")
        if not re.fullmatch(r"([a-z]+ )*[a-z]*", ch["text"]):
            raise SmokeFailure(f"{label}: seeded constrained text {ch['text']!r}")
        return ch["text"], tuple(ch["logprobs"]["token_logprobs"])

    a, b, c = seeded(7), seeded(7), seeded(8)
    if a != b or a == c:
        raise SmokeFailure(f"{label}: seed 7 gave {a[0]!r} then {b[0]!r}; seed 8 "
                           f"{c[0]!r}")
    res["seeded"] = a[0]
    log(f"{label}: over HTTP: {res}")
    return res


def _g_taxonomy(base, engine, cfg, label) -> dict:
    """400 for structural mistakes, 422 invalid_grammar_error for what the
    compiler rejects, and 400 structured_output_disabled from a server over
    the same engine with ``--no-structured-output``."""
    import dataclasses

    from kaito_tpu_torch.engine.server import make_server

    cases = (("/v1/completions", dict(prompt="x", response_format={"type": "yaml"}),
              400, "invalid_request_error"),
             ("/v1/completions", dict(prompt="x", tool_choice="auto"), 400,
              "invalid_request_error"),
             ("/v1/chat/completions", dict(messages=_G_CHAT, tools=_G_TOOLS,
                                           tool_choice="required",
                                           response_format={"type": "json_object"}),
              400, "invalid_request_error"),
             ("/v1/completions", dict(prompt="x", response_format={
                 "type": "regex",
                 "regex": "a{64}b{64}c{64}d{64}e{64}f{64}g{64}h{64}i{9}"}),
              422, "invalid_grammar_error"),
             ("/v1/chat/completions", dict(messages=_G_CHAT, response_format={
                 "type": "json_schema", "json_schema": {"schema": {"type": "tuple"}}}),
              422, "invalid_grammar_error"),
             ("/v1/completions", dict(prompt="x", kv_transfer={"source_url": "x"}),
              403, "invalid_request_error"))
    got = []
    for path, body, code, etype in cases:
        status, raw = _g_call(base, path, body)
        t = json.loads(raw)["error"]["type"] if status != 200 else None
        if (status, t) != (code, etype):
            raise SmokeFailure(f"{label}: {body} answered {status} {t}, not {code} "
                               f"{etype}")
        got.append(status)
    off = make_server(engine, dataclasses.replace(cfg, structured_output=False),
                      host="127.0.0.1", port=0, device="cuda")
    thread = threading.Thread(target=off.serve_forever, daemon=True)
    thread.start()
    try:
        obase = f"http://127.0.0.1:{off.server_address[1]}"
        for path, body in (("/v1/completions", dict(prompt="x", response_format={
                "type": "json_object"})), ("/v1/chat/completions", dict(
                    messages=_G_CHAT, tools=_G_TOOLS, tool_choice="required"))):
            status, raw = _g_call(obase, path, body)
            t = json.loads(raw)["error"]["type"] if status != 200 else None
            if (status, t) != (400, "structured_output_disabled"):
                raise SmokeFailure(f"{label}: --no-structured-output answered "
                                   f"{status} {t}")
            got.append(status)
    finally:
        off.shutdown()
        off.server_close()
        thread.join(timeout=30)
    log(f"{label}: error taxonomy {got} (400s, 422 invalid_grammar_error, 403 "
        f"kv_transfer with P/D off, 400 structured_output_disabled)")
    return dict(statuses=got)


def _g_metrics(base, prefix="kaito:grammar_") -> dict:
    """{series: value} of the ``/metrics`` families named ``prefix``*."""
    from kaito_tpu_torch.utils.promtext import parse_exposition

    status, raw = _get(f"{base}/metrics")
    if status != 200:
        raise SmokeFailure(f"/metrics answered {status}")
    return {n + lbl: v for n, lbl, v in parse_exposition(raw.decode())
            if n.startswith(prefix)}


def _g_batch(engine, prompts, grammars, n=48) -> list:
    """``prompts`` submitted together to a not-started engine, greedy, each
    under its grammar (None: unconstrained), driven step by step."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    reqs = [engine.submit(engine.tokenizer.encode(p), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True, logprobs=True, grammar=g))
        for p, g in zip(prompts, grammars)]
    for _ in range(20000):
        engine.step()
        if all(r.finish_reason for r in reqs):
            break
    if not all(r.finish_reason == "length" for r in reqs):
        raise SmokeFailure(f"batch did not finish: {[r.finish_reason for r in reqs]}")
    return reqs


def _g_window_ms(engine) -> dict:
    """Card ms of one replay of each captured K=4 window with all eight
    rows active at position 1024 (CUDA events); run last: a replay
    writes KV into the pool and moves the window's carry."""
    import numpy as np

    w, S = engine.window, len(engine.slots)
    pps = engine.pages_per_seq
    pages = (1 + np.arange(S * pps, dtype=np.int32) % (engine._num_pages - 1)).reshape(
        S, pps)
    res = {}
    for (K, key), g in list(w.graphs.items()):
        if K != 4:
            continue
        w.upload({"last_tokens": np.full(S, 65, np.int32),
                  "positions": np.full(S, 1024, np.int32),
                  "active": np.ones(S, bool), "left": np.full(S, 10**6, np.int32),
                  "page_tables": pages, "gstate": engine._gram_state * 0})
        res["constrained" if key[-1] is not None else "unconstrained"] = time_ms(
            g.graph.replay, iters=10)[0]
    return res


def _g_time_uploads(engine) -> list:
    """Time each grammar table upload: the engine's refresh runs between
    two synchronizations of the card (host clock), and each call that
    uploaded appends (ms, rows written).  Readings of the smoke only:
    the engine itself never waits on an upload."""
    import torch

    times, inner = [], engine._refresh_grammar_device

    def timed():
        ds = engine.grammar_device_stats
        n = ds["uploads"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        if ds["uploads"] != n:
            times.append(((time.perf_counter() - t0) * 1e3, ds["last_upload_rows"]))

    engine._refresh_grammar_device = timed
    return times


def _g_room(engine) -> dict:
    """What the card can spare a larger grammar table (free memory and
    the allocator's cached blocks, less the engine's headroom) and the
    largest capacity, a power of two rows, that a growth from the
    current table can take: past it a constrained admission waits for
    live rows to come free, or fails."""
    room, V = engine._grammar_room(), engine.md.arch.vocab_size
    cap = engine._gram_table.capacity
    while (2 * cap) * V * 8 <= room:
        cap *= 2
    return dict(room_mib=room / 2**20, max_rows=cap, max_mib=cap * V * 8 / 2**20,
                max_states_per_grammar=engine.grammar_cache.max_states)


def _g_growth(engine, grammars, uploads, label) -> dict:
    """A constrained request decodes (the words grammar, 64 tokens) while
    requests under other grammars arrive: enough rows live at once that
    the table doubles mid-stream.  The graphs of the old table must be
    dropped, the device table must equal the host's, and the request's
    output must walk its automaton."""
    import torch

    from kaito_tpu_torch.engine.engine import SamplingParams
    from kaito_tpu_torch.engine.grammar import GrammarSpec

    tok, ds = engine.tokenizer, engine.grammar_device_stats
    tbl = engine._gram_table
    cap0, dropped0 = tbl.capacity, ds["graphs_dropped"]
    # the live rows must pass the capacity: json_object's, then 61-row ones
    churn = [grammars["json_object"]]
    letters = iter("abcdefg")
    while 1 + grammars["words"].n_states + sum(g.n_states for g in churn) <= cap0:
        churn.append(engine.grammar_cache.get(
            GrammarSpec("regex", f"{next(letters)}{{60}}"), tok))
    if len(churn) >= len(engine.slots):
        raise SmokeFailure(f"{label}: a {cap0}-row table needs {len(churn)} live grammars")
    main = engine.submit(tok.encode(_prompt(100, 90)), SamplingParams(
        max_tokens=64, temperature=0.0, ignore_eos=True, grammar=grammars["words"]))
    others = []
    for step in range(20000):
        if main.finish_reason and all(r.finish_reason for r in others):
            break
        engine.step()
        if step == 4:
            if main.finish_reason or not main.output_tokens:
                raise SmokeFailure(f"{label}: the constrained request is not decoding")
            others = [engine.submit(tok.encode("x"), SamplingParams(
                max_tokens=40, temperature=0.0, ignore_eos=True, grammar=g))
                for g in churn]
    _g_walks(grammars["words"], main.output_tokens, tok.eos_token_id)
    tbl = engine._gram_table
    res = dict(capacity=(cap0, tbl.capacity), live_grammars=len(churn) + 1,
               graphs_dropped=ds["graphs_dropped"] - dropped0,
               upload_ms=uploads[-1][0], upload_rows=uploads[-1][1],
               mib=(engine._gmask.nbytes + engine._gtrans.nbytes) / 2**20)
    if tbl.capacity <= cap0 or res["graphs_dropped"] <= 0:
        raise SmokeFailure(f"{label}: the table did not grow mid-stream: {res}")
    if not (torch.equal(engine._gmask.cpu(), torch.from_numpy(tbl.mask)) and
            torch.equal(engine._gtrans.cpu(), torch.from_numpy(tbl.trans))):
        raise SmokeFailure(f"{label}: the device table differs from the host's")
    log(f"{label}: mixed batch: the unconstrained rows equal their unconstrained "
        f"run, the constrained ones walk their automata; the table grew while a "
        f"constrained slot decoded {res}")
    return res


def run_grammar_phase(label) -> tuple[dict, dict]:
    """Phase 11: Llama-3.1-8B at full width in bf16 (phase 4's config,
    synthetic weights from seed 0, the prefix cache off so a batch reruns
    exactly), served over HTTP under grammars; then, on the engine
    stepped directly, a mixed batch against its unconstrained run, a
    table growth while a constrained slot decodes, the window readings;
    then n-gram and draft speculation (the weights shared) against the
    plain engine's constrained batch.  Returns the launches of K1, K2 and
    K3 over the phase and the readings."""
    import dataclasses

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server, parse_args

    counted = ("paged_decode_attention", "flash_prefill_attention",
               "flash_prefill_packed")
    for name in counted:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16", "--max-num-seqs",
                         "8", "--seed", "0", "--no-enable-prefix-caching"])
    engine = InferenceEngine(cfg, device="cuda")
    server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stats: dict = {}
    specs = _g_specs()
    try:
        if _g_metrics(base):
            raise SmokeFailure(f"{label}: kaito:grammar_* before any constrained "
                               f"request")
        grammars, compile_ms = {}, {}
        for name, spec in specs.items():
            g = grammars[name] = engine.grammar_cache.get(spec, engine.tokenizer)
            compile_ms[name] = dict(ms=g.compile_seconds * 1e3, states=g.n_states)
        stats["compile"] = compile_ms
        log(f"{label}: grammar compile ms (byte tokenizer, {engine.md.arch.vocab_size}"
            f"-column rows) {compile_ms}")
        uploads = _g_time_uploads(engine)
        engine.start()
        stats["http"] = _g_http(base, label)
        ds = engine.grammar_device_stats
        stats["table"] = dict(
            capacity=engine._gram_table.capacity,
            mib=(engine._gmask.nbytes + engine._gtrans.nbytes) / 2**20,
            uploads=ds["uploads"], upload_mib=ds["upload_bytes"] / 2**20,
            first_upload_ms=uploads[0][0], first_upload_rows=uploads[0][1],
            last_upload_ms=uploads[-1][0], last_upload_rows=uploads[-1][1],
            **_g_room(engine))
        log(f"{label}: grammar table on the card after the HTTP checks {stats['table']}")
        stats["taxonomy"] = _g_taxonomy(base, engine, cfg, label)
        after = _g_metrics(base)
        families = {k.split("{")[0].removesuffix("_bucket").removesuffix("_sum")
                    .removesuffix("_count") for k in after}
        want = {"kaito:grammar_compile_seconds", "kaito:grammar_cache_hits_total",
                "kaito:grammar_cache_misses_total", "kaito:grammar_cache_evictions_total",
                "kaito:grammar_requests_total", "kaito:grammar_cache_entries"}
        if families != want or after["kaito:grammar_cache_hits_total"] <= 0:
            raise SmokeFailure(f"{label}: /metrics grammar family {after}")
        stats["metrics"] = {k: v for k, v in after.items() if "bucket" not in k}
        log(f"{label}: /metrics kaito:grammar_* absent before, then {stats['metrics']}")
        # one sequence alone: ms a token under the unbounded grammar against plain
        p = _prompt(200, 30)
        plain = _itl(_timed_tokens(engine, p, 129))
        words = _itl(_timed_tokens(engine, p, 129, grammars["words"]))
        stats["alone"] = dict(plain_ms_per_token=1e3 / plain["decode_tok_s"],
                              constrained_ms_per_token=1e3 / words["decode_tok_s"])
        log(f"{label}: one sequence alone: {stats['alone']}")
        stats["decode"] = decode_readings(engine, p, label)
        stats["decode_constrained"] = decode_readings(engine, p, label + ", constrained",
                                                      grammars["words"])
        engine.stop()

        tok = engine.tokenizer
        eos = tok.eos_token_id
        # a mixed batch: four unconstrained rows beside four constrained
        prompts = [_prompt(120, 80 + i) for i in range(8)]
        alone = _g_batch(engine, prompts, [None] * 8)
        mixed_g = [None] * 4 + [grammars[n] for n in ("json_schema", "regex", "words",
                                                      "tool envelope")]
        mixed = _g_batch(engine, prompts, mixed_g)
        for i in range(4):
            if mixed[i].output_tokens != alone[i].output_tokens:
                raise SmokeFailure(f"{label}: unconstrained row {i} of the mixed "
                                   f"batch changed")
        for r, g in zip(mixed[4:], mixed_g[4:]):
            _g_walks(g, r.output_tokens, eos)
        stats["growth"] = _g_growth(engine, grammars, uploads, label)
        if engine.counters["decode_graph_replays_total"] < \
                engine.counters["decode_windows_total"]:
            raise SmokeFailure(f"{label}: a decode window was not a graph replay")
        want_batch = _g_batch(engine, _g_spec_prompts(), _g_spec_grammars(grammars))
        w = engine.window.stats()
        stats["window_nodes"] = {
            f"K={g['K']} {'unconstrained' if g['key'].endswith('None)') else 'constrained'}"
            f" {g['key']}": g["nodes"]["kernel"] for g in w["graphs"]}
        stats["window_ms"] = _g_window_ms(engine)
        log(f"{label}: window kernel nodes {stats['window_nodes']}; one K=4 replay "
            f"(card ms, 8 rows at 1024) {stats['window_ms']}")
        params = engine.model.param_tree()
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    del server, engine
    _release_card(torch)
    for mode, extra in (("ngram", dict(speculative_ngram=4, speculative_min_match=2)),
                        ("draft", dict(speculative_draft=_DRAFT, speculative_draft_k=4))):
        lbl = f"{label}, {mode}"
        eng = InferenceEngine(dataclasses.replace(cfg, **extra), params=params,
                              device="cuda")
        gs = {n: eng.grammar_cache.get(s, eng.tokenizer) for n, s in specs.items()}
        got = _g_batch(eng, _g_spec_prompts(), _g_spec_grammars(gs))
        prefix = _same_or_tie(got, want_batch, lbl)
        for r, g in zip(got, _g_spec_grammars(gs)):
            _g_walks(g, r.output_tokens, eng.tokenizer.eos_token_id)
        c = eng.counters
        res = dict(greedy_equal_prefix=prefix,
                   counters={k: n for k, n in c.items() if k.startswith("spec_")},
                   engine=_spec_engine_stats(eng, lbl))
        keys = [g["key"] for g in res["engine"]["verify_graphs"]]
        if c["spec_steps_total"] <= 0 or not any(not k.endswith("None)") for k in keys):
            raise SmokeFailure(f"{lbl}: no verify round under a grammar: {keys}")
        if mode == "draft" and not any(not g["key"].endswith("None)")
                                       for g in res["engine"]["scan_graphs"]):
            raise SmokeFailure(f"{lbl}: no draft scan under a grammar")
        log(f"{lbl}: constrained greedy batch against the plain engine's: equal "
            f"prefixes {prefix} of 48; {res}")
        stats[mode] = res
        del eng
        _release_card(torch)
    torch.cuda.synchronize()
    launches = {name: getattr(*_counter(name)) for name in counted}
    log(f"{label}: launches {launches}")
    return launches, stats


_G_SPEC_TEXTS = ("abc def ghi jkl ", "one two three four five ", "the cat sat on the mat ")


def _g_spec_prompts() -> list[str]:
    """Four prompts of repeated lowercase words (~240 bytes): n-gram
    proposals the words grammar allows; the fourth asks for JSON."""
    return [t * (240 // len(t)) for t in _G_SPEC_TEXTS] + ["A JSON answer: "]


def _g_spec_grammars(grammars) -> list:
    return [grammars["words"]] * 3 + [grammars["json_schema"]]


# ---------------------------------------------------------------------------
# Phase 12: multi-LoRA serving
# ---------------------------------------------------------------------------

ADAPTER_LEG = ("adapter-bf16", "phase 12, bf16 multi-LoRA (4 slots, rmax 16)")
ADAPTER_EXACT_LEG = ("adapter-fp32", "phase 12, fp32 multi-LoRA on tiny-llama-real")
# the full-width leg's adapters: (name, rank, alpha); ad-1 at alpha/r = 1.5,
# ad-4 only loaded to force an eviction
_A_ADAPTERS = (("ad-0", 16, 16), ("ad-1", 16, 24), ("ad-2", 16, 32), ("ad-3", 8, 16),
               ("ad-4", 16, 16))
# the mixed batch: each of two prompts under the base and three adapters
_A_PROMPTS = ((96, 121), (150, 122))
_A_MIXED = ("", "ad-0", "ad-1", "ad-3")


def _a_write(torch, engine, root, name, r, alpha, seed, device) -> str:
    """An adapter for every site of ``engine``'s model, written by the
    port's own ``save_adapter``: A ~ N(0, 1/in) and B ~ N(0, 1/(4r))
    drawn on ``device`` from ``seed``, stored in the model's dtype."""
    from kaito_tpu_torch.tuning.lora import ALL_TARGETS, LoraConfig, save_adapter

    model = engine.model
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tree = {}
    for g in model.groups:
        stack = {}
        for t, (i, o) in model.lora_specs().get(g.name, {}).items():
            a = torch.randn((g.count, i, r), generator=gen, device=device) / math.sqrt(i)
            b = torch.randn((g.count, r, o), generator=gen, device=device) * (
                0.5 / math.sqrt(r))
            stack[f"{t}_lora_a"] = a.to(model.dtype)
            stack[f"{t}_lora_b"] = b.to(model.dtype)
        tree[g.name] = stack
    path = os.path.join(root, name)
    save_adapter(path, tree, LoraConfig(r=r, alpha=alpha, targets=ALL_TARGETS),
                 engine.md.name)
    return path


def _a_http(base, method, path, body=None):
    """(status, parsed body) of one request, an HTTP error included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _a_batch(engine, rows, n=32) -> list:
    """``rows`` ((prompt text, adapter)) submitted together to a
    not-started engine, greedy with logprobs, driven step by step."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    reqs = [engine.submit(engine.tokenizer.encode(p), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True, logprobs=True), adapter=a)
        for p, a in rows]
    for _ in range(20000):
        engine.step()
        if all(r.finish_reason for r in reqs):
            break
    if not all(r.finish_reason == "length" for r in reqs):
        raise SmokeFailure(f"batch did not finish: {[r.finish_reason for r in reqs]}")
    return reqs


def _a_captures(engine) -> int:
    """Graphs captured so far by every StaticGraphs of the engine."""
    c = engine.counters
    return sum(v for k, v in c.items() if k.endswith("_captures_total"))


def _a_window_ms(engine, lanes) -> dict:
    """Card ms of one replay of each captured K=4 window, eight rows
    active at position 1024: the base window with every lane 0, the
    adapter window with ``lanes`` (CUDA events; run last: a replay
    writes KV and moves the carry)."""
    import numpy as np

    w, S = engine.window, len(engine.slots)
    pps = engine.pages_per_seq
    pages = (1 + np.arange(S * pps, dtype=np.int32) % (engine._num_pages - 1)).reshape(
        S, pps)
    res = {}
    for (K, key), g in list(w.graphs.items()):
        if K != 4 or key[-1] is not None:
            continue
        lora = bool(key[-2])
        w.upload({"last_tokens": np.full(S, 65, np.int32),
                  "positions": np.full(S, 1024, np.int32),
                  "active": np.ones(S, bool), "left": np.full(S, 10**6, np.int32),
                  "page_tables": pages,
                  "slot_adapters": np.asarray(lanes if lora else [0] * S, np.int32)})
        ms = time_ms(g.graph.replay, iters=10)[0]
        res["adapters" if lora else "base"] = dict(window_ms=ms, step_ms=ms / 4,
                                                   kernel_nodes=g.nodes["kernel"])
    return res


def run_adapter_phase(label) -> tuple[dict, dict]:
    """Phase 12, full width: Llama-3.1-8B in bf16 (phase 4's config, the
    prefix cache off), ``--adapter-slots 4 --adapter-rmax 16``.  Five
    adapters on all seven targets written on the card by the port's own
    ``save_adapter``; four hot-loaded over ``POST /v1/adapters`` while a
    base request decodes, then served by the ``model`` field.  On the
    engine stepped directly: a mixed batch of 8 (two prompts under the
    base and three adapters) against each row alone (phase 10's near-tie
    rule), every adapter stream apart from the base's, every window a
    replay; a load that evicts, a fault back in and a DELETE, with the
    graph count and the lanes' addresses unchanged and the batch
    rerunning to the same tokens.  Returns the launches of K1, K2 and K3
    and the readings."""
    import shutil
    import tempfile

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server, parse_args

    counted = ("paged_decode_attention", "flash_prefill_attention",
               "flash_prefill_packed")
    for name in counted:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16", "--max-num-seqs",
                         "8", "--seed", "0", "--no-enable-prefix-caching",
                         "--adapter-slots", "4", "--adapter-rmax", "16"])
    t_leg = t0 = time.perf_counter()
    engine = InferenceEngine(cfg, device="cuda")
    cache = engine.adapter_cache
    stats: dict = dict(slot_table_mib=cache.table_bytes / 2**20,
                       engine_up_s=time.perf_counter() - t0,
                       kv_pages=engine._num_pages)
    log(f"{label}: engine up in {stats['engine_up_s']:.1f}s; slot table "
        f"{stats['slot_table_mib']:.1f} MiB (4 slots + the base lane, rmax 16); "
        f"{engine._num_pages} KV pages")
    root = tempfile.mkdtemp(prefix="kaito-lora-")
    server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        paths = {name: _a_write(torch, engine, root, name, r, alpha, 40 + i, "cuda")
                 for i, (name, r, alpha) in enumerate(_A_ADAPTERS)}
        stats["write_s_each"] = (time.perf_counter() - t0) / len(paths)
        stats["artifact_mib"] = {n: os.path.getsize(os.path.join(p, "adapter.msgpack"))
                                 / 2**20 for n, p in paths.items()}
        engine.start()
        if _a_http(base, "GET", "/v1/adapters")[1]["resident"]:
            raise SmokeFailure(f"{label}: adapters resident before any load")
        if "kaito:adapter_resident 0" not in _get(base + "/metrics")[1].decode():
            raise SmokeFailure(f"{label}: no kaito:adapter_* family with the cache on")
        # hot-loads while a base request decodes
        bg: dict = {}

        def base_traffic():
            bg["resp"], bg["s"] = _completion(base, _prompt(200, 120), 256)

        traffic = threading.Thread(target=base_traffic)
        traffic.start()
        time.sleep(1.0)
        load_ms = {}
        for name, *_ in _A_ADAPTERS[:4]:
            t0 = time.perf_counter()
            status, body = _a_http(base, "POST", "/v1/adapters",
                                   {"name": name, "source": paths[name]})
            load_ms[name] = (time.perf_counter() - t0) * 1e3
            if status != 200 or body.get("loaded") != name:
                raise SmokeFailure(f"{label}: POST {name} answered {status} {body}")
        busy_during = engine.num_running
        traffic.join()
        if "resp" not in bg:
            raise SmokeFailure(f"{label}: the base request failed during the loads")
        stats["post_load_ms"] = load_ms
        log(f"{label}: POST /v1/adapters hot-load ms {load_ms} ({busy_during} base "
            f"sequence(s) decoding); artifacts MiB {stats['artifact_mib']}")
        snap = _a_http(base, "GET", "/v1/adapters")[1]
        if sorted(e["name"] for e in snap["resident"]) != ["ad-0", "ad-1", "ad-2",
                                                           "ad-3"]:
            raise SmokeFailure(f"{label}: snapshot {snap}")
        models = [m["id"] for m in _a_http(base, "GET", "/v1/models")[1]["data"]]
        if models[1:] != ["ad-0", "ad-1", "ad-2", "ad-3"]:
            raise SmokeFailure(f"{label}: /v1/models {models}")
        # one completion by each model field: the logprobs of its tokens
        # tell the adapters apart (the byte tokenizer's text may be empty)
        lps = {a: tuple(_completion(base, _prompt(96, 121), 16, logprobs=1,
                                    **({"model": a} if a else {}))[0]["choices"][0][
                                        "logprobs"]["token_logprobs"])
               for a in _A_MIXED}
        if len(set(lps.values())) != len(lps):
            raise SmokeFailure(f"{label}: an adapter's completion equals another's "
                               f"{lps}")
        # readings of one sequence alone: base against an adapter
        p = _prompt(200, 30)
        alone = {}
        for a in ("", "ad-1"):
            alone["adapter" if a else "base"] = dict(
                ms_per_token=1e3 / _itl(_timed_tokens(engine, p, 129, adapter=a))[
                    "decode_tok_s"],
                decode=decode_readings(engine, p, f"{label}, {a or 'base'}",
                                       adapter=a))
        stats["alone"] = {k: dict(ms_per_token=v["ms_per_token"],
                                  device_kernels_per_step=v["decode"][
                                      "device_kernels_per_step"],
                                  host_calls_per_step=v["decode"]["host_calls_per_step"])
                          for k, v in alone.items()}
        log(f"{label}: one sequence alone {stats['alone']}")
        engine.stop()

        # the mixed batch of 8 against each row alone
        rows = [(_prompt(n, salt), a) for a in _A_MIXED for n, salt in _A_PROMPTS]
        mixed = _a_batch(engine, rows)
        solo = [_a_batch(engine, [row])[0] for row in rows]
        prefix = _same_or_tie(mixed, solo, label + ", mixed batch vs solo")
        for j, (_, a) in enumerate(rows):
            if a and mixed[j].output_tokens == mixed[j % 2].output_tokens:
                raise SmokeFailure(f"{label}: row {j} ({a}) streams the base's tokens")
        c = engine.counters
        if c["decode_graph_replays_total"] < c["decode_windows_total"]:
            raise SmokeFailure(f"{label}: a decode window was not a graph replay")
        stats["mixed"] = dict(equal_prefix_vs_solo=prefix, tokens=32, rows=len(rows))
        log(f"{label}: mixed batch of {len(rows)} against each row alone: equal "
            f"prefixes {prefix} of 32; every adapter stream apart from the base's")
        # churn: a load that evicts, a fault back in, a DELETE; ad-2 is
        # touched first, so the load evicts ad-0 (the least recent) and the
        # batch's rerun faults it back in
        _a_batch(engine, [(rows[0][0], "ad-2")], n=4)
        before = _a_captures(engine)
        ptrs = {k: t.data_ptr() for k, t in engine.model.lora["dense"].items()}
        status, body = _a_http(base, "POST", "/v1/adapters",
                               {"name": "ad-4", "source": paths["ad-4"]})
        evicted = cache.snapshot()["host_tier"]
        if status != 200 or evicted != ["ad-0"]:
            raise SmokeFailure(f"{label}: POST ad-4 {status} {body}, host tier "
                               f"{evicted}")
        faults = cache.faults_total
        again = _a_batch(engine, rows)
        if cache.faults_total <= faults:
            raise SmokeFailure(f"{label}: no fault back in ({cache.snapshot()})")
        status, body = _a_http(base, "DELETE", "/v1/adapters/ad-4")
        if status != 200:
            raise SmokeFailure(f"{label}: DELETE ad-4 answered {status} {body}")
        third = _a_batch(engine, rows)
        after = _a_captures(engine)
        moved = [k for k, t in engine.model.lora["dense"].items()
                 if t.data_ptr() != ptrs[k]]
        if after != before or moved:
            raise SmokeFailure(f"{label}: graphs captured {before} before the churn, "
                               f"{after} after; lanes moved {moved}")
        for j, (x, y, z) in enumerate(zip(mixed, again, third)):
            if not x.output_tokens == y.output_tokens == z.output_tokens:
                raise SmokeFailure(f"{label}: row {j} changed across the churn")
        snap = cache.snapshot()
        stats["churn"] = dict(captures=after, evicted=evicted,
                              loads=snap["loads_total"],
                              evictions=snap["evictions_total"],
                              faults=snap["faults_total"], hits=snap["hits_total"])
        log(f"{label}: load (evicting {evicted}), fault back in, DELETE: graphs "
            f"captured {before} before and {after} after, lanes in place, the batch "
            f"reruns to the same tokens; {stats['churn']}")
        launches = {name: getattr(*_counter(name)) for name in counted}
        # card ms of a K=4 window step, eight rows: base, and the batch's lanes
        lanes = [engine.adapter_index.get(a, 0) for a in _A_MIXED for _ in _A_PROMPTS]
        stats["window"] = _a_window_ms(engine, lanes)
        stats["window_graphs"] = {g["key"]: g["nodes"]["kernel"]
                                  for g in engine.window.stats()["graphs"]
                                  if g["K"] == 4}
        log(f"{label}: one K=4 window, 8 rows at 1024 (lanes {lanes}): "
            f"{stats['window']}")
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
        shutil.rmtree(root, ignore_errors=True)
    del server, engine, cache
    _release_card(torch)
    stats["phase_s"] = time.perf_counter() - t_leg
    log(f"{label}: launches {launches}; {stats['phase_s']:.1f}s")
    return launches, stats


def run_adapter_exact_phase(label) -> dict:
    """Phase 12, exact: ``tiny-llama-real`` (its checkpoint) in fp32 with
    ``--adapter-slots 2`` and three adapters (seeded, written by the
    port's ``save_adapter``) on the card and on the CPU.  A mixed batch
    (two prompts under the base and two adapters) equals each row alone
    token for token on the card, and the CPU engine's tokens; an
    evict -> fault round trip leaves the faulted adapter's lane bit-equal
    and its greedy stream unchanged."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import parse_args

    t_leg = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kaito-lora-")
    cfg, _ = parse_args(["--model", "tiny-llama-real", "--weights-dir",
                         os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                         "--dtype", "float32", "--max-model-len", "256",
                         "--max-num-seqs", "8", "--no-enable-prefix-caching",
                         "--adapter-slots", "2", "--adapter-rmax", "8"])
    try:
        cpu = InferenceEngine(cfg, device="cpu")
        for i, (name, r, alpha) in enumerate((("ex-a", 4, 6), ("ex-b", 8, 8),
                                              ("ex-c", 2, 4))):
            _a_write(torch, cpu, root, name, r, alpha, 60 + i, "cpu")
        cfg = dataclasses.replace(cfg, adapters_dir=root)
        cpu = InferenceEngine(cfg, device="cpu")
        card = InferenceEngine(cfg, device="cuda")
        if sorted(card.adapter_index) != ["ex-b", "ex-c"] or \
                card.adapter_cache.snapshot()["host_tier"] != ["ex-a"]:
            raise SmokeFailure(f"{label}: boot residency {card.adapter_snapshot()}")
        rows = [(_prompt(n, salt), a) for a in ("", "ex-b", "ex-c")
                for n, salt in ((40, 131), (90, 132))]
        mixed = [r.output_tokens for r in _a_batch(card, rows, n=24)]
        solo = [_a_batch(card, [row], n=24)[0].output_tokens for row in rows]
        on_cpu = [r.output_tokens for r in _a_batch(cpu, rows, n=24)]
        if not mixed == solo == on_cpu:
            raise SmokeFailure(f"{label}: mixed {mixed}, solo {solo}, CPU {on_cpu}")
        for j in range(2, len(rows)):
            if mixed[j] == mixed[j % 2]:
                raise SmokeFailure(f"{label}: row {j} streams the base's tokens")
        # ex-b's lane and stream; ex-c is touched, so ex-a faults in
        # evicting ex-b (the least recent), then ex-b faults back in
        ac = card.adapter_cache
        lane = {k: t[:, ac.name_to_slot["ex-b"]].clone()
                for k, t in card.model.lora["dense"].items()}
        first = _a_batch(card, [rows[2]], n=24)[0].output_tokens
        _a_batch(card, [(rows[0][0], "ex-c")], n=8)
        _a_batch(card, [(rows[0][0], "ex-a")], n=8)
        if "ex-b" in ac.name_to_slot:
            raise SmokeFailure(f"{label}: ex-b was not evicted {ac.snapshot()}")
        back = _a_batch(card, [rows[2]], n=24)[0].output_tokens
        s = ac.name_to_slot["ex-b"]
        same = all(torch.equal(t[:, s], lane[k]) for k, t in card.model.lora["dense"]
                   .items())
        if not same or back != first:
            raise SmokeFailure(f"{label}: after evict -> fault ex-b's lane equal "
                               f"{same}, stream {back} vs {first}")
        res = dict(rows=len(rows), tokens=24, mixed_equals_solo_and_cpu=True,
                   fault_round_trip_exact=True, faults=ac.faults_total)
        log(f"{label}: the mixed batch of {len(rows)} equals each row alone and the "
            f"CPU engine, token for token; evict -> fault leaves ex-b's lane "
            f"bit-equal and its stream unchanged ({res})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del card, cpu
    _release_card(torch)
    res["phase_s"] = time.perf_counter() - t_leg
    log(f"{label}: {res['phase_s']:.1f}s")
    return res


FAMILIES_LEG = ("families-bf16", "phase 13, bf16 dense families (phi-3-mini-128k "
                "longrope, gemma-3-4b, phi-2)")
FAMILIES_EXACT_LEG = ("families-fp32", "phase 13, fp32 phi-3 fused checkpoint with "
                      "longrope")
_FAMILY_KERNELS = ("paged_decode_attention", "flash_prefill_attention",
                   "flash_prefill_packed")
# the long phi-3 prompt: ~4000 byte tokens, decoded past position 4096
_LONG_BYTES, _LONG_TOKENS = 4000, 160
# decode logprobs past the switch against a fresh prefill of the same
# tokens, bf16: K1 over pages written one decode step at a time against
# K2 over the whole row sum in other orders (phase 9's bound for a
# served continuation against its scoring)
_SWITCH_LOGPROB_ATOL = 0.1


def _phi3_128k_config(orig=4096, seed=16):
    """Phi-3-mini-128k-instruct's published widths (hidden 3072, 32
    layers, 32 heads of 96, intermediate 8192, vocab 32064) as a HF
    config dict, with longrope factor lists (48 values each, made from
    ``seed``) and ``original_max_position_embeddings`` ``orig``: the
    published lists are not in the repository."""
    import random

    rng = random.Random(seed)
    return {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
            "vocab_size": 32064, "hidden_size": 3072, "num_hidden_layers": 32,
            "num_attention_heads": 32, "num_key_value_heads": 32,
            "intermediate_size": 8192, "max_position_embeddings": 131072,
            "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "hidden_act": "silu",
            "tie_word_embeddings": False,
            "rope_scaling": {"type": "longrope",
                             "short_factor": [1.0 + 0.05 * rng.random() for _ in range(48)],
                             "long_factor": [1.0 + 40.0 * rng.random() for _ in range(48)],
                             "original_max_position_embeddings": orig}}


def _greedy_run(engine, tokens, n):
    """Greedy tokens and their logprobs of one request driven step by
    step on an engine that is not started."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    req = engine.submit(list(tokens), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True, logprobs=True))
    for _ in range(20000):
        engine.step()
        if req.finish_reason:
            break
    if req.finish_reason != "length":
        raise SmokeFailure(f"greedy run did not finish: {req.finish_reason}")
    return list(req.output_tokens), [float(x) for x in req.output_logprobs]


def _longrope_switch(engine, md, label) -> dict:
    """phi-3-mini-128k across its original length: the selected table at
    positions 4095 and 4096 (short, then long), then a ~4000-token prompt
    decoded greedily past position 4096 in the captured windows (every
    window a replay), and the decode logprobs from 4096 on against a
    fresh prefill (``score_prompt``) over the same tokens."""
    import torch

    from kaito_tpu_torch.engine.engine import SamplingParams

    model = engine.model
    short, long, orig, short_m, long_m = model._longrope
    inv, ms = model._rope_select(torch.tensor([[int(orig) - 1, int(orig)]],
                                              dtype=torch.int32, device="cuda"))
    if not (torch.equal(inv[0, 0], short) and torch.equal(inv[0, 1], long)
            and torch.equal(ms.flatten().cpu(), torch.tensor([short_m, long_m]))):
        raise SmokeFailure(f"{label}: the tables at {int(orig) - 1} and {int(orig)} "
                           f"are not short then long")
    prompt = engine.tokenizer.encode(_prompt(_LONG_BYTES, 91))
    n0 = len(prompt)
    if not n0 < orig < n0 + _LONG_TOKENS:
        raise SmokeFailure(f"{label}: a {n0}-token prompt and {_LONG_TOKENS} tokens "
                           f"do not cross {orig}")
    c = engine.counters
    w0, r0 = c["decode_windows_total"], c["decode_graph_replays_total"]
    t0 = time.perf_counter()
    req = engine.submit(prompt, SamplingParams(max_tokens=_LONG_TOKENS, temperature=0.0,
                                               ignore_eos=True, logprobs=True))
    stamps = [time.perf_counter() for _ in req.stream()]
    windows = c["decode_windows_total"] - w0
    replays = c["decode_graph_replays_total"] - r0
    if len(stamps) != _LONG_TOKENS or windows < 1 or replays < windows:
        raise SmokeFailure(f"{label}: {len(stamps)} tokens, {windows} windows, "
                           f"{replays} replays")
    toks = list(req.output_tokens)
    lps = [float(x) for x in req.output_logprobs]
    scored = engine.score_prompt(prompt + toks)
    # token i of the output sits at position n0 + i
    past = [i for i in range(_LONG_TOKENS) if n0 + i >= orig]
    diff = max(abs(lps[i] - scored[n0 + i]) for i in past)
    before = max(abs(lps[i] - scored[n0 + i]) for i in range(_LONG_TOKENS)
                 if n0 + i < orig)
    log(f"{label}: a {n0}-token prompt decoded {_LONG_TOKENS} greedy tokens across "
        f"position {int(orig)} in {windows} captured windows (TTFT "
        f"{(stamps[0] - t0) * 1e3:.1f} ms); decode logprobs against a fresh prefill: "
        f"max diff {diff:.4f} past the switch ({len(past)} tokens), {before:.4f} "
        f"before it")
    if diff > _SWITCH_LOGPROB_ATOL:
        raise SmokeFailure(f"{label}: decode logprobs past {int(orig)} differ from a "
                           f"fresh prefill by {diff}")
    return dict(prompt_tokens=n0, tokens=_LONG_TOKENS, crossed_at=int(orig),
                windows=windows, replays=replays, ttft_ms=(stamps[0] - t0) * 1e3,
                logprob_diff_past_switch=diff, logprob_diff_before_switch=before,
                tokens_after_switch=len(past), output=toks)


def _family_phase(name, md, label) -> tuple[dict, dict]:
    """Serve ``md`` at full width in bf16 on phase 4's config (page 64,
    8 sequences, 512 prefill tokens, the prefix cache on) over HTTP: a
    completion with logprobs, a streamed chat, the burst of phase 4 (a
    prefill pack and a continuation chunk), cold TTFT and decode tok/s
    of one request alone, and the decode readings.  phi-3-mini-128k also
    runs :func:`_longrope_switch`; gemma-3 scores a 1100-token prompt
    (its local layers' window of 1024 cuts K2) and decodes past 1024
    (the window cuts K1).  Returns the launches of K1, K2 and K3, zeroed
    just before the requests, and the readings."""
    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.kv_cache import kv_bytes
    from kaito_tpu_torch.engine.server import make_server, parse_args

    cfg, _ = parse_args(["--model", name, "--dtype", "bfloat16", "--max-num-seqs", "8",
                         "--seed", "0"])
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, device="cuda", metadata=md)
    engine.start()
    server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
    a = md.arch
    log(f"{label}: {md.name} (hidden {a.hidden_size}, {a.num_layers} layers, "
        f"{a.num_heads}/{a.num_kv_heads} heads of {a.head_dim}) engine up in "
        f"{time.perf_counter() - t0:.1f}s: {engine.model.param_bytes() / 2**30:.2f} GiB "
        f"weights, KV {kv_bytes(engine.cache) / 2**20:.1f} MiB, {engine.sizing_report}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stats = dict(model=md.name, head_dim=a.head_dim, layers=a.num_layers,
                 weights_gib=engine.model.param_bytes() / 2**30)
    try:
        for kname in _FAMILY_KERNELS:
            fn, attr = _counter(kname)
            setattr(fn, attr, 0)
        resp, _ = _completion(base, _prompt(60, 1), 16, logprobs=1)
        lps = resp["choices"][0]["logprobs"]["token_logprobs"]
        if len(lps) != 16 or not all(math.isfinite(x) and x <= 0 for x in lps):
            raise SmokeFailure(f"{label}: bad logprobs {lps}")
        _stream_chat(base, 16)
        stats.update(_burst(base, engine))
        p = _prompt(200, 30)
        ttft = min(_completion(base, _prompt(200, 30 + i), 1)[1] for i in range(2))
        t_long = _completion(base, _prompt(200, 33), 129)[1]
        stats.update(ttft_ms=ttft * 1e3, decode_tok_s=128 / (t_long - ttft),
                     prompt_tokens=200)
        if engine.model._longrope is not None:
            stats["longrope"] = _longrope_switch(engine, md, label)
        if a.sliding_window:
            k2 = _counter("flash_prefill_attention")
            n_k2 = getattr(*k2)
            long_prompt = engine.tokenizer.encode(_prompt(1100, 92))
            scores = engine.score_prompt(long_prompt)
            if getattr(*k2) - n_k2 != a.num_layers or not all(
                    math.isfinite(x) for x in scores[1:]):
                raise SmokeFailure(f"{label}: scoring a {len(long_prompt)}-token prompt")
            req = engine.submit(long_prompt, SamplingParams(
                max_tokens=24, temperature=0.0, ignore_eos=True))
            if len(list(req.stream())) != 24:
                raise SmokeFailure(f"{label}: a decode past the window stopped short")
            stats["window_cut"] = dict(prompt_tokens=len(long_prompt),
                                       window=a.sliding_window, scored=True,
                                       decoded=24)
            log(f"{label}: scored a {len(long_prompt)}-token prompt (one K2 a layer, "
                f"window {a.sliding_window}) and decoded 24 tokens past it")
        torch.cuda.synchronize()
        launches = {k: getattr(*_counter(k)) for k in _FAMILY_KERNELS}
        windows = engine.counters["decode_windows_total"]
        replays = engine.counters["decode_graph_replays_total"]
        if not engine.window.capture or replays < windows:
            raise SmokeFailure(f"{label}: {windows} decode windows, {replays} replays")
        stats["decode"] = decode_readings(engine, p, label)
        log(f"{label}: {md.name}: TTFT {stats['ttft_ms']:.1f} ms (200-byte prompt, "
            f"alone), decode {stats['decode_tok_s']:.1f} tok/s (one sequence); "
            f"launches {launches}")
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    del server, engine
    _release_card(torch)
    if "longrope" in stats:
        # the captured windows' tokens against the eager loop's, same weights
        ref = InferenceEngine(cfg, device="cuda", metadata=md, _eager_decode=True)
        prompt = ref.tokenizer.encode(_prompt(_LONG_BYTES, 91))
        want, _ = _greedy_run(ref, prompt, _LONG_TOKENS)
        del ref
        _release_card(torch)
        got = stats["longrope"].pop("output")
        if got != want:
            first = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
            raise SmokeFailure(f"{label}: captured windows part from the eager loop at "
                               f"token {first}")
        stats["longrope"]["eager_equal"] = True
        log(f"{label}: the eager reference loop gives the captured windows' "
            f"{_LONG_TOKENS} tokens across the switch")
    return launches, stats


def run_families_phase(label) -> tuple[dict, dict]:
    """Phase 13: phi-3-mini-128k-instruct (built through ``autogen`` from
    :func:`_phi3_128k_config`), gemma-3-4b-instruct and phi-2 at full
    width, each by :func:`_family_phase`.  Returns each kernel's
    launches summed over the three and the readings by model."""
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config

    t_leg = time.perf_counter()
    phi3 = metadata_from_hf_config("microsoft/Phi-3-mini-128k-instruct",
                                   _phi3_128k_config(),
                                   name="phi-3-mini-128k-instruct")
    res, total = {}, {k: 0 for k in _FAMILY_KERNELS}
    for name, md in (("phi-3-mini-128k-instruct", phi3),
                     ("gemma-3-4b-instruct", cut_metadata("gemma-3-4b-instruct", None)),
                     ("phi-2", cut_metadata("phi-2", None))):
        launches, res[name] = _family_phase(name, md, f"{label}: {name}")
        res[name]["launches"] = launches
        for k, n in launches.items():
            if n <= 0:
                raise SmokeFailure(f"{label}: {k} never launched serving {name}")
            total[k] += n
    res["phase_s"] = time.perf_counter() - t_leg
    log(f"{label}: {res['phase_s']:.1f}s")
    return total, res


_EXACT_PHI3 = {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
               "vocab_size": 512, "hidden_size": 384, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 4,
               "intermediate_size": 512, "max_position_embeddings": 4096,
               "rms_norm_eps": 1e-5, "tie_word_embeddings": False}


def _fused_checkpoint(model, path):
    """``model``'s parameters as a HF checkpoint with phi-3's fused
    ``qkv_proj`` and ``gate_up_proj`` tensors, written by the port's own
    ``write_safetensors`` (the card has no ``safetensors`` package)."""
    import torch

    from kaito_tpu_torch.engine.weights import _LAYER_MAP, write_safetensors

    tree = model.param_tree()
    V = model.arch.vocab_size
    sd = {"model.embed_tokens.weight": tree["embed"][:V],
          "model.norm.weight": tree["final_norm"], "lm_head.weight": tree["lm_head"][:V]}
    for g in model.groups:
        p = tree[g.name]
        for j in range(g.count):
            pre = f"model.layers.{g.start + j}."
            sd[pre + "self_attn.qkv_proj.weight"] = torch.cat(
                [p[k][j].t() for k in ("q", "k", "v")])
            sd[pre + "mlp.gate_up_proj.weight"] = torch.cat(
                [p[k][j].t() for k in ("gate", "up")])
            for key, t in p.items():
                if key in ("q", "k", "v", "gate", "up"):
                    continue
                suffix, transpose = _LAYER_MAP[key]
                sd[pre + suffix] = t[j].t() if transpose else t[j]
    write_safetensors(os.path.join(path, "model.safetensors"),
                      {k: v.contiguous() for k, v in sd.items()})
    return sorted(sd)


def run_families_exact_phase(label) -> dict:
    """Phase 13, exact: a tiny phi-3 (hidden 384, 4 heads of 96, 2
    layers) with longrope factor lists and an original length of 48,
    weights drawn on the CPU from seed 5 and written as a fused
    checkpoint (``qkv_proj``, ``gate_up_proj``); served in fp32 from that
    checkpoint by an engine on the card and one on the CPU: two prompts
    (40 and 60 tokens, the second prefilled across 48, the first decoded
    across it), 24 greedy tokens each, equal token for token, logprobs
    within 2e-3."""
    import random
    import shutil
    import tempfile

    import torch

    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config

    t_leg = time.perf_counter()
    rng = random.Random(5)
    cfg_json = dict(_EXACT_PHI3, rope_scaling={
        "type": "longrope", "original_max_position_embeddings": 48,
        "short_factor": [1.0 + 0.1 * rng.random() for _ in range(48)],
        "long_factor": [1.0 + 8.0 * rng.random() for _ in range(48)]})
    md = metadata_from_hf_config("test/phi3-fused", cfg_json, name="phi3-fused-test")
    root = tempfile.mkdtemp(prefix="kaito-phi3-")
    try:
        src = TransformerLM(md.arch, dtype=torch.float32, device="cpu")
        src.init_params(seed=5)
        names = _fused_checkpoint(src, root)
        del src
        cfg = EngineConfig(model=md.name, weights_dir=root, max_model_len=256,
                           page_size=16, max_num_seqs=4, dtype="float32",
                           kv_dtype="float32", seed=0)
        prompts = [[(7 * i) % 500 + 3 for i in range(40)],
                   [(13 * i) % 500 + 3 for i in range(60)]]
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = InferenceEngine(cfg, device=dev, metadata=md)
            if eng.model._longrope is None:
                raise SmokeFailure(f"{label}: longrope tables missing on {dev}")
            reqs = [eng.submit(p, SamplingParams(max_tokens=24, temperature=0.0,
                                                 ignore_eos=True, logprobs=True))
                    for p in prompts]
            for _ in range(2000):
                eng.step()
                if all(r.finish_reason for r in reqs):
                    break
            runs[dev] = ([list(r.output_tokens) for r in reqs],
                         [[float(x) for x in r.output_logprobs] for r in reqs])
            del eng
        (ct, cl), (pt, pl) = runs["cuda"], runs["cpu"]
        diff = max(abs(x - y) for a, b in zip(cl, pl) for x, y in zip(a, b))
        if ct != pt or diff > 2e-3:
            raise SmokeFailure(f"{label}: card {ct} / CPU {pt}, logprob diff {diff}")
        res = dict(checkpoint_tensors=len(names), fused=True, prompts=[40, 60],
                   tokens=24, crossed_at=48, tokens_equal=True, max_logprob_diff=diff)
        log(f"{label}: a fused phi-3 checkpoint ({len(names)} tensors) served on the "
            f"card equals the CPU engine token for token across position 48; "
            f"logprobs within {diff:.2e}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _release_card(torch)
    res["phase_s"] = time.perf_counter() - t_leg
    return res


DEVPROF_LEG = ("devprof-bf16", "phase 14, bf16 device profiling")
OFFLOAD_LEG = ("offload-bf16", "phase 14, bf16 host KV tier")
_P14_KERNELS = ("paged_decode_attention", "flash_prefill_attention",
                "flash_prefill_packed")
# kernel names that must never be left in "other": the port's attention
# kernels (K1/K1q, K2/K3), its quantized matmuls and the library GEMMs
_CLASSIFIED = ("decode_tc_kernel", "decode_fp32_kernel", "flash_kernel",
               "flash_tc_kernel", "quant_matmul_", "nvjet", "gemm", "cutlass", "xmma")
_DP_SEQS, _DP_TOKENS = 8, 256
# the host tier's leg: 8 prompts of ~1500 tokens decoding 256 each need
# 8 x 28 pages of 64; 160 pages hold about six of them
_OFF_PROMPT, _OFF_TOKENS, _OFF_PAGES = 1500, 256, 160
_RESTORE_TOKENS = 1600


def _devprof_load(base, poll: bool, n_tokens: int = _DP_TOKENS) -> tuple[float, dict]:
    """:data:`_DP_SEQS` concurrent greedy completions of ``n_tokens``
    tokens over HTTP while this thread polls ``/debug/device`` (``poll``)
    and keeps every window it sees, by its stamp.  Returns the wall
    seconds and the windows."""
    errors: list = []

    def one(i):
        try:
            _completion(base, _prompt(80, 140 + i), n_tokens)
        except Exception as e:   # raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(_DP_SEQS)]
    windows: dict = {}
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        if poll:
            status, raw = _get(f"{base}/debug/device")
            if status != 200:
                raise SmokeFailure(f"/debug/device answered {status} with sampling on")
            for w in json.loads(raw)["ring"]:
                windows[w["ts"]] = w
        time.sleep(0.2)
    wall = time.perf_counter() - t0
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return wall, windows


def _decode_only(w) -> bool:
    """A sampler window with device slices in which only decodes ran."""
    return (w["n_slices"] > 0 and w["phase_pct"]["decode"] > 0
            and w["phase_pct"]["prefill"] == 0 and w["phase_pct"]["prefill_packed"] == 0)


def _busy_split(w) -> dict:
    """A window's busy device time by bucket, in % of busy."""
    busy = 100.0 - w["bucket_pct"]["idle"]
    return {b: 100.0 * v / busy for b, v in w["bucket_pct"].items() if b != "idle"}


def _check_windows(windows, label) -> dict:
    """Every captured window's buckets sum to 100; in every window with
    only decodes live, decode holds >= 95% of the busy time, matmul is the
    largest busy bucket and attention is above 0.  Returns the newest
    decode-only window's split."""
    full = [w for w in windows.values() if w["n_slices"] > 0]
    if not full:
        raise SmokeFailure(f"{label}: no window captured any device slice")
    for w in full:
        total = sum(w["bucket_pct"].values())
        if abs(total - 100.0) > 0.01:
            raise SmokeFailure(f"{label}: a window's buckets sum to {total}")
    decode_only = [w for w in full if _decode_only(w)]
    if not decode_only:
        raise SmokeFailure(f"{label}: no window held decodes alone "
                           f"({len(full)} windows with slices)")
    for w in decode_only:
        split = _busy_split(w)
        busy = 100.0 - w["bucket_pct"]["idle"]
        share = 100.0 * w["phase_pct"]["decode"] / busy
        top = max((b for b in split if b != "other"), key=split.get)
        if share < 95.0 or max(split, key=split.get) != "matmul" \
                or w["bucket_pct"]["attention"] <= 0:
            raise SmokeFailure(f"{label}: decode-only window: decode {share:.2f}% of "
                               f"busy, split {split}, largest {top}")
    last = max(decode_only, key=lambda w: w["ts"])
    res = dict(windows=len(windows), windows_with_slices=len(full),
               decode_only_windows=len(decode_only),
               decode_share_of_busy_pct=[100.0 * w["phase_pct"]["decode"]
                                         / (100.0 - w["bucket_pct"]["idle"])
                                         for w in decode_only],
               decode_step_split_pct_of_busy=_busy_split(last),
               decode_window=last)
    log(f"{label}: {len(full)} windows with slices, {len(decode_only)} with decodes "
        f"alone; the newest: idle {last['bucket_pct']['idle']:.2f}% of "
        f"{last['wall_us'] / 1e3:.1f} ms, busy split "
        + ", ".join(f"{b} {v:.2f}%" for b, v in res["decode_step_split_pct_of_busy"].items())
        + f"; decode {res['decode_share_of_busy_pct'][-1]:.2f}% of busy, "
        f"{last['window_tokens']:.0f} tokens in {last['capture_s']:.3f} s, matmul "
        f"{last['matmul_pct_of_peak_flops']:.2f}% of peak FLOP/s, weights "
        f"{last['hbm_pct_of_peak']:.2f}% of peak HBM")
    return res


def _check_device_gauges(base, label) -> dict:
    """The ``kaito:device_*`` gauges equal the last window of
    ``/debug/device`` (read between two reads of it that agree)."""
    from kaito_tpu_torch.utils.promtext import parse_exposition

    for _ in range(20):
        d1 = json.loads(_get(f"{base}/debug/device")[1])
        samples = parse_exposition(_get(f"{base}/metrics")[1].decode())
        d2 = json.loads(_get(f"{base}/debug/device")[1])
        if d1["windows_total"] == d2["windows_total"] and d1["last"] == d2["last"] \
                and d1["windows_skipped"] == d2["windows_skipped"]:
            break
    else:
        raise SmokeFailure(f"{label}: /debug/device kept moving")
    last = d1["last"]
    got = {}
    for n, lbl, v in samples:
        if n == "kaito:device_bucket_pct":
            got[("bucket", lbl)] = v
        elif n == "kaito:device_phase_pct":
            got[("phase", lbl)] = v
        elif n.startswith("kaito:device_") and not lbl:
            got[n] = v
    want = {"kaito:device_comm_pct": last["comm_pct"],
            "kaito:device_comm_compute_overlap_pct": last["comm_compute_overlap_pct"],
            "kaito:device_copy_overlap_pct": last["copy_overlap_pct"],
            "kaito:device_idle_pct": last["bucket_pct"]["idle"],
            "kaito:device_phase_attributed_pct": last["phase_attributed_pct"],
            "kaito:device_matmul_pct_of_peak_flops": last["matmul_pct_of_peak_flops"],
            "kaito:device_hbm_pct_of_peak": last["hbm_pct_of_peak"],
            "kaito:device_windows_total": d1["windows_total"],
            "kaito:device_windows_skipped_total": d1["windows_skipped"],
            "kaito:device_window_errors_total": d1["parse_errors"]}
    want.update({("bucket", f'{{bucket="{b}"}}'): v
                 for b, v in last["bucket_pct"].items()})
    want.update({("phase", f'{{phase="{p}"}}'): v for p, v in last["phase_pct"].items()})
    bad = {k: (got.get(k), v) for k, v in want.items()
           if got.get(k) is None or not math.isclose(got[k], v, rel_tol=1e-9,
                                                     abs_tol=1e-9)}
    if bad:
        raise SmokeFailure(f"{label}: kaito:device_* against the last window: {bad}")
    log(f"{label}: {len(want)} kaito:device_* series equal the last window "
        f"({d1['windows_total']} windows, {d1['windows_skipped']} skipped)")
    return dict(device_series=len(want), windows_total=d1["windows_total"],
                windows_skipped=d1["windows_skipped"], parse_errors=d1["parse_errors"])


def _after_a_window(dp, label, timeout_s: float = 60.0) -> None:
    """Return as the sampler ends a window (taken, skipped or failed): it
    then waits ``interval_s`` before it asks for the next one."""
    def ended():
        return dp.windows_total + dp.windows_skipped + dp.parse_errors

    n0 = ended()
    deadline = time.monotonic() + timeout_s
    while ended() == n0:
        if time.monotonic() > deadline:
            raise SmokeFailure(f"{label}: the sampler ended no window in {timeout_s:.0f} s")
        time.sleep(0.002)


def _manual_trace(base, server, engine, label) -> dict:
    """``/start_profile {"seconds": 2}`` answers 200 and a second start
    409; four prompts sent together and one alone prefill and decode 2
    tokens each inside the trace; a sampler window meanwhile is skipped
    (the trace starts as the sampler ends a window, so that its next ask,
    ``interval_s`` later, falls inside the trace: a trace started while a
    window is open waits for it and may then end while the sampler still
    folds that window, and no window of the sampler's would fall inside);
    the trace written under ``KAITO_PROFILE_DIR`` holds K1's
    ``decode_tc_kernel``, and no K1-K3, quant matmul or GEMM slice of it
    is classified ``other`` (each bucket's top names logged); then
    ``/stop_profile`` on the idle profiler answers 409."""
    import tempfile

    from kaito_tpu_torch.engine.devprof import classify, parse_torch_trace, read_trace

    prof_dir = tempfile.mkdtemp(prefix="kaito-profile-")
    os.environ["KAITO_PROFILE_DIR"] = prof_dir
    dp = engine.devprof
    _after_a_window(dp, label)
    skipped0 = dp.windows_skipped
    status, _, raw = _http(base, "/start_profile", {"seconds": 2})
    if status != 200 or json.loads(raw).get("auto_stop_seconds") != 2:
        raise SmokeFailure(f"{label}: /start_profile answered {status} {raw[:200]!r}")
    status, _, _ = _http(base, "/start_profile", {})
    if status != 409:
        raise SmokeFailure(f"{label}: a second /start_profile answered {status}")
    # two tokens each: a prefill and one decode step (a trace of 2 s of
    # steady decode would hold ~500k kernel events)
    burst = [threading.Thread(target=_completion, args=(base, _prompt(120 + 40 * i,
                                                                     150 + i), 2),
                              daemon=True) for i in range(4)]
    for t in burst:
        t.start()
    for t in burst:
        t.join()
    _completion(base, _prompt(300, 155), 2)
    for _ in range(300):
        if not server.state.trace.active:
            break
        time.sleep(0.05)
    if server.state.trace.active:
        raise SmokeFailure(f"{label}: the trace did not stop itself after 2 s")
    if dp.windows_skipped <= skipped0:
        raise SmokeFailure(f"{label}: no sampler window was skipped during the trace")
    status, _, _ = _http(base, "/stop_profile", {})
    if status != 409:
        raise SmokeFailure(f"{label}: /stop_profile on an idle profiler answered {status}")
    files = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)
             if f.endswith(".trace.json")]
    if len(files) != 1:
        raise SmokeFailure(f"{label}: {files} under KAITO_PROFILE_DIR")
    slices = parse_torch_trace(read_trace(files[0]))
    by_bucket: dict = {}
    wrong = set()
    for s in slices:
        b = classify(s.op_name, s.name)
        names = by_bucket.setdefault(b, {})
        names[s.name[:90]] = names.get(s.name[:90], 0.0) + s.dur_us
        if b == "other" and any(k in s.name.lower() for k in _CLASSIFIED):
            wrong.add(s.name[:120])
    if not any("decode_tc_kernel" in s.name for s in slices):
        raise SmokeFailure(f"{label}: the trace holds no decode_tc_kernel event")
    if wrong:
        raise SmokeFailure(f"{label}: classified other: {sorted(wrong)[:6]}")
    top = {b: sorted(n.items(), key=lambda kv: -kv[1])[:4] for b, n in by_bucket.items()}
    for b, names in top.items():
        log(f"{label}: trace, {b}: " + "; ".join(f"{n} {us / 1e3:.3f} ms"
                                                 for n, us in names))
    res = dict(trace_bytes=os.path.getsize(files[0]), trace_slices=len(slices),
               skipped_during_trace=dp.windows_skipped - skipped0,
               top_names_ms={b: [(n, us / 1e3) for n, us in names]
                             for b, names in top.items()})
    log(f"{label}: /start_profile 200 then 409, auto-stop after 2 s, /stop_profile "
        f"409 idle; trace {res['trace_bytes'] / 2**20:.1f} MiB, {len(slices)} device "
        f"slices, none of K1-K3 / GEMMs in other; {res['skipped_during_trace']} "
        f"sampler windows skipped")
    os.remove(files[0])
    return res


def _windows_are_harmless(cfg, params, label) -> dict:
    """The greedy batch of :func:`greedy_batch` on a fresh engine with a
    profiler window around every scheduler step (the first steps capture
    the decode graphs inside windows), against the same batch on a fresh
    engine without: token for token equal, one schedule, same weights."""
    import dataclasses

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine

    plain = InferenceEngine(dataclasses.replace(cfg, devprof_interval_s=0.0),
                            params=params, device="cuda")
    want = greedy_batch(plain)
    del plain
    _release_card(torch)
    engine = InferenceEngine(cfg, params=params, device="cuda")
    dp, step = engine.devprof, engine.step
    inside = {"windows": 0, "captures": 0}

    def windowed():
        captures = engine.counters["decode_graph_captures_total"]
        win = dp._open()
        try:
            return step()
        finally:
            if win is not None:
                dp._close(win)
                inside["windows"] += 1
                inside["captures"] += (engine.counters["decode_graph_captures_total"]
                                       - captures)

    engine.step = windowed
    got = greedy_batch(engine)
    del engine
    _release_card(torch)
    if got != want or not inside["windows"] or not inside["captures"]:
        raise SmokeFailure(f"{label}: greedy batch with a profiler window around every "
                           f"step {got} against {want}; {inside}")
    log(f"{label}: a profiler window around each of {inside['windows']} steps, "
        f"{inside['captures']} graph captures inside them: the greedy batch equals an "
        f"engine's without")
    return dict(greedy_batch_equal=True, **inside)


def run_devprof_phase(label) -> tuple[dict, dict, dict]:
    """Phase 14, device profiling: Llama-3.1-8B at full width in bf16
    (phase 4's config, synthetic weights from seed 0) served with
    ``--devprof-interval-s 0.5 --devprof-window-s 0.25``: eight
    concurrent 256-token greedy completions while ``/debug/device`` is
    polled (:func:`_check_windows`), the ``kaito:device_*`` gauges
    against the last window, the manual trace (:func:`_manual_trace`);
    then the same completions on an engine with sampling off, sharing
    the weights (tok/s of both), and :func:`_windows_are_harmless`.
    Returns the launches of K1-K3 over the leg, the readings and
    the weights (the host tier's leg reuses them)."""
    import dataclasses

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server, parse_args

    t_leg = time.perf_counter()
    for name in _P14_KERNELS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16", "--max-num-seqs",
                         "8", "--seed", "0", "--devprof-interval-s", "0.5",
                         "--devprof-window-s", "0.25"])
    stats: dict = {}
    params = None
    for mode in ("on", "off"):
        mcfg = cfg if mode == "on" else dataclasses.replace(cfg, devprof_interval_s=0.0)
        t0 = time.perf_counter()
        engine = InferenceEngine(mcfg, params=params, device="cuda")
        if params is None:
            params = engine.model.param_tree()
        engine.start()
        server = make_server(engine, mcfg, host="127.0.0.1", port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        log(f"{label}, sampling {mode}: engine up in {time.perf_counter() - t0:.1f}s")
        try:
            # the graphs the load replays, captured before it: a window
            # over a capture is skipped
            _devprof_load(base, poll=False, n_tokens=16)
            c = engine.counters
            captures0 = c["decode_graph_captures_total"]
            skipped0 = engine.devprof.windows_skipped if mode == "on" else 0
            if mode == "on":
                # the warm-up's windows (the first prefills and captures)
                # are logged apart from the load's
                warm = [round(a + b, 4) for a, b in engine.devprof.holds_recent]
                engine.devprof.holds_recent.clear()
                log(f"{label}: the warm-up's windows holding the engine thread "
                    f"(start + stop): {warm} s")
            wall, windows = _devprof_load(base, poll=mode == "on")
            for _ in range(2 if mode == "on" else 0):
                # the sampler's cadence is its own: another round if no
                # window fell inside the decodes
                if any(_decode_only(w) for w in windows.values()):
                    break
                windows.update(_devprof_load(base, poll=True)[1])
            if mode == "on":
                stats["load_windows_skipped"] = engine.devprof.windows_skipped - skipped0
                stats["load_captures"] = c["decode_graph_captures_total"] - captures0
                log(f"{label}: during the load {stats['load_captures']} graphs captured, "
                    f"{stats['load_windows_skipped']} sampler windows skipped")
            stats[f"tok_s_sampling_{mode}"] = _DP_SEQS * _DP_TOKENS / wall
            log(f"{label}, sampling {mode}: {_DP_SEQS} x {_DP_TOKENS} greedy tokens in "
                f"{wall:.3f} s: {stats[f'tok_s_sampling_{mode}']:.1f} tok/s")
            if mode == "on":
                stats["windows"] = _check_windows(windows, label)
                stats["gauges"] = _check_device_gauges(base, label)
                dp = engine.devprof
                h = dp.capture_hist
                n = max(h._total, 1)
                stats["window_seconds"] = dict(
                    windows=h._total, mean_capture_to_summary_s=h._sum / n,
                    mean_stop_s=dp.stop_s_total / n,
                    capture_s=sorted({w["capture_s"] for w in windows.values()}))
                log(f"{label}: {h._total} windows open {stats['window_seconds']['capture_s']} s;"
                    f" each {stats['window_seconds']['mean_capture_to_summary_s']:.3f} s "
                    f"from opening to its summary, of which "
                    f"{stats['window_seconds']['mean_stop_s']:.3f} s stopping the profiler"
                    f" on the engine thread")
                # each window's hold of the engine thread, starting and
                # stopping the profiler (ROADMAP item 53: a window covers
                # one dispatch, a decode window of the engine's own K steps)
                holds = list(dp.holds_recent)
                stops = [a + b for a, b in holds]
                stats["window_seconds"]["start_stop_s"] = holds
                stats["window_seconds"]["hold_s_median"] = _quantile(stops, 0.5) \
                    if stops else None
                log(f"{label}: each window's seconds holding the engine thread during "
                    f"the load (start, stop): {[(round(a, 4), round(b, 4)) for a, b in holds]}"
                    f" (median of the sums {stats['window_seconds']['hold_s_median']})")
                if not stops or max(stops) > 1.0:
                    raise SmokeFailure(f"{label}: a window held the engine thread "
                                       f"{max(stops, default=0):.3f} s (limit 1.0 s)")
                stats["trace"] = _manual_trace(base, server, engine, label)
            else:
                status, _ = _get(f"{base}/debug/device")
                if status != 403:
                    raise SmokeFailure(f"{label}: /debug/device with sampling off "
                                       f"answered {status}")
            if engine.counters["decode_graph_replays_total"] < \
                    engine.counters["decode_windows_total"]:
                raise SmokeFailure(f"{label}, sampling {mode}: a decode window was "
                                   f"not a graph replay")
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
        del engine, server
        _release_card(torch)
    log(f"{label}: sampling on against off on {card_line()}: "
        f"{stats['tok_s_sampling_on']:.1f} against {stats['tok_s_sampling_off']:.1f} "
        f"tok/s ({100 * stats['tok_s_sampling_on'] / stats['tok_s_sampling_off']:.1f}%)")
    stats["harmless"] = _windows_are_harmless(cfg, params, label)
    torch.cuda.synchronize()
    launches = {name: getattr(*_counter(name)) for name in _P14_KERNELS}
    log(f"{label}: launches {launches}")
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats, params


def _offload_run(engine, prompts, label) -> tuple[list, dict]:
    """The prompts submitted together to ``engine`` (not started), 256
    greedy tokens each, stepped to the end.  Every restore is bracketed
    by two synchronizations and timed, and must leave the pool tensors'
    addresses as they were; so is every spill.  Returns the requests and
    the readings."""
    import torch

    from kaito_tpu_torch.engine.engine import SamplingParams

    k, v = engine.cache.k, engine.cache.v
    ptrs = (k.data_ptr(), v.data_ptr())
    timed = {"restore": [], "spill": []}

    def bracket(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if engine.cache.k is not k or (k.data_ptr(), v.data_ptr()) != ptrs:
                raise SmokeFailure(f"{label}: a {kind} replaced the pool tensors")
            if kind == "spill" or got:
                slot = args[1] if kind == "restore" else args[0]
                timed[kind].append((int(engine.slots[slot].position), ms))
            return got
        return run

    if engine.host_kv is not None:
        engine._spill_slot = bracket("spill", engine._spill_slot)
        engine._try_restore = bracket("restore", engine._try_restore)
    reqs = [engine.submit(list(p), SamplingParams(
        max_tokens=_OFF_TOKENS, temperature=0.0, ignore_eos=True, logprobs=True))
        for p in prompts]
    t0 = time.perf_counter()
    for _ in range(100000):
        engine.step()
        if all(r.finish_reason for r in reqs):
            break
    wall = time.perf_counter() - t0
    if not all(r.finish_reason == "length" for r in reqs):
        raise SmokeFailure(f"{label}: {[r.finish_reason for r in reqs]}")
    c = engine.counters
    if c["decode_graph_replays_total"] < c["decode_windows_total"]:
        raise SmokeFailure(f"{label}: a decode window was not a graph replay")
    if engine.allocator.available != engine.allocator.num_pages - 1:
        raise SmokeFailure(f"{label}: {engine.allocator.num_pages - 1 - engine.allocator.available}"
                           f" pages did not come back")
    return reqs, dict(wall_s=wall, restores=timed["restore"], spills=timed["spill"],
                      **{key: c[key] for key in (
                          "preemptions_total", "host_kv_spilled_pages_total",
                          "host_kv_restored_pages_total", "prefill_tokens_total",
                          "prefill_steps_total", "decode_windows_total",
                          "decode_graph_replays_total")})


def run_offload_phase(label, params=None) -> tuple[dict, dict]:
    """Phase 14, the host KV tier: Llama-3.1-8B at full width in bf16
    (phase 4's config at ``--max-model-len 2048``, the weights of the
    device-profiling leg when given), its pool cut to
    :data:`_OFF_PAGES` pages of 64 so that eight ~1500-token prompts
    decoding 256 tokens each cannot all stay resident, with an 8 GiB host
    tier and without one: preemptions, spills and restores happen, fewer
    prefill tokens are computed with the tier, the greedy tokens equal
    the tier-off engine's up to a near-tie, every restore leaves the
    pool's addresses and every window is a replay, every page returns, K1
    and K2 launch.  Logged: each restore's and spill's card ms (between
    two synchronizations) by the sequence's length, against the
    recompute prefill of a 1600-token prompt.  Then the exact leg
    (:func:`_offload_exact`).  Returns the launches and readings."""
    import dataclasses

    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.server import parse_args

    t_leg = time.perf_counter()
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16", "--max-num-seqs",
                         "8", "--seed", "0", "--max-model-len", "2048",
                         "--max-pages", str(_OFF_PAGES)])
    for name in _P14_KERNELS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
    stats: dict = {}
    runs = {}
    for mode, tier in (("on", 8 << 30), ("off", 0)):
        lbl = f"{label}, tier {mode}"
        t0 = time.perf_counter()
        engine = InferenceEngine(dataclasses.replace(cfg, host_kv_offload_bytes=tier),
                                 params=params, device="cuda")
        if params is None:
            params = engine.model.param_tree()
        log(f"{lbl}: engine up in {time.perf_counter() - t0:.1f}s, "
            f"{engine.allocator.num_pages} pages")
        prompts = [engine.tokenizer.encode(_prompt(_OFF_PROMPT, 160 + i))
                   for i in range(8)]
        # a short prompt alone first: the fresh-prefill kernel (K2; a
        # ~1500-token prompt prefills in 512-token chunks over its pages)
        # and the first captures
        _spec_batch(engine, [engine.tokenizer.encode(_prompt(200, 159))],
                    _greedy_params(8))
        reqs, res = _offload_run(engine, prompts, lbl)
        runs[mode] = reqs
        if mode == "off":
            # the recompute of a 1600-token sequence: a fresh chunk and
            # three continuation chunks, timed between two synchronizations
            req = engine.submit(engine.tokenizer.encode(_prompt(_RESTORE_TOKENS, 199)),
                                SamplingParams(max_tokens=1, temperature=0.0,
                                               ignore_eos=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while not req.finish_reason:
                engine.step()
            torch.cuda.synchronize()
            res["recompute_prefill_ms"] = (time.perf_counter() - t0) * 1e3
            res["recompute_prefill_tokens"] = len(req.prompt_tokens)
        stats[mode] = res
        log(f"{lbl}: {res['wall_s']:.2f} s; preemptions {res['preemptions_total']}, "
            f"spilled {res['host_kv_spilled_pages_total']} / restored "
            f"{res['host_kv_restored_pages_total']} pages, prefill tokens "
            f"{res['prefill_tokens_total']} in {res['prefill_steps_total']} dispatches")
        del engine
        _release_card(torch)
    on, off = stats["on"], stats["off"]
    if min(on["preemptions_total"], on["host_kv_spilled_pages_total"],
           on["host_kv_restored_pages_total"]) < 1:
        raise SmokeFailure(f"{label}: the tier was not exercised: {on}")
    if on["prefill_tokens_total"] >= off["prefill_tokens_total"]:
        raise SmokeFailure(f"{label}: {on['prefill_tokens_total']} prefill tokens with "
                           f"the tier, {off['prefill_tokens_total']} without")
    stats["greedy_equal_prefix"] = _same_or_tie(runs["on"], runs["off"], label)
    near = min(on["restores"], key=lambda r: abs(r[0] - _RESTORE_TOKENS))
    stats["restore_near_1600"] = dict(tokens=near[0], ms=near[1])
    log(f"{label}: restores (tokens, card ms) {on['restores']}; spills {on['spills']}; "
        f"the restore of {near[0]} tokens {near[1]:.2f} ms against a "
        f"{off['recompute_prefill_tokens']}-token recompute prefill "
        f"{off['recompute_prefill_ms']:.2f} ms; greedy prefixes "
        f"{stats['greedy_equal_prefix']} of {_OFF_TOKENS}")
    torch.cuda.synchronize()
    launches = {name: getattr(*_counter(name)) for name in _P14_KERNELS}
    log(f"{label}: launches {launches}")
    stats["exact"] = _offload_exact(label)
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats


def _offload_exact(label) -> dict:
    """``tiny-llama-real`` in fp32 and with int8 KV (``tests/test_host_offload.py``'s
    pair: two sequences overrunning a 9-page pool, the tier on) on the
    card and on the CPU: tokens equal, logprobs within 2e-3 (for int8 KV
    the CPU engine's same run, ROADMAP queue 3), a restore on both."""
    import torch

    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams

    res = {}
    for kv in ("float32", "int8"):
        cfg = EngineConfig(model="tiny-llama-real",
                           weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                           max_model_len=256, page_size=16, max_num_seqs=2, max_pages=10,
                           dtype="float32", kv_dtype=kv, prefill_buckets=(32, 64, 128),
                           seed=0, enable_prefix_caching=False,
                           host_kv_offload_bytes=256 << 20)
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = InferenceEngine(cfg, device=dev)
            reqs = [eng.submit([40, 41, 42] * 11, SamplingParams(
                        max_tokens=100, temperature=0.0, ignore_eos=True, logprobs=True)),
                    eng.submit([50, 51, 52] * 11, SamplingParams(
                        max_tokens=40, temperature=0.0, ignore_eos=True, logprobs=True))]
            for _ in range(4000):
                eng.step()
                if all(r.finish_reason for r in reqs):
                    break
            if eng.counters["host_kv_restored_pages_total"] < 1:
                raise SmokeFailure(f"{label}, exact {kv}: no restore on {dev}")
            runs[dev] = ([list(r.output_tokens) for r in reqs],
                         [[float(x) for x in r.output_logprobs] for r in reqs])
            del eng
        (ct, cl), (pt, pl) = runs["cuda"], runs["cpu"]
        diff = max(abs(x - y) for a, b in zip(cl, pl) for x, y in zip(a, b))
        if ct != pt or diff > 2e-3:
            raise SmokeFailure(f"{label}, exact {kv}: card {ct} / CPU {pt}, logprob "
                               f"diff {diff}")
        res[kv] = dict(tokens_equal=True, max_logprob_diff=diff)
        log(f"{label}, exact tiny-llama-real {kv} KV: card = CPU token for token "
            f"across a spill and a restore, logprobs within {diff:.2e}")
    _release_card(torch)
    return res


PD_LEG = ("pd-bf16", "phase 15, bf16 P/D hand-off, the KV pool and its disk tier")
# two engines on one card share the weights; each pool 240 pages of 64
# (15360 tokens, 1.9 GiB in bf16); prompts of ~200 (prefilled whole,
# through K2), ~1500 and ~3000 tokens (in 512-token chunks)
_PD_PAGES, _PD_PROMPTS, _PD_TOKENS = 240, (200, 1500, 3000), 32
# the second server's store holds one published ~1500-byte prompt (5
# pages of 8 MiB at Llama-3.1-8B's widths), not two
_PD_STORE_BYTES = 60 << 20


def _pd_serve(cfg, params):
    """A started engine on the card and its HTTP server: (engine, server,
    base URL)."""
    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server

    engine = InferenceEngine(cfg, params=params, device="cuda")
    engine.start()
    server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return engine, server, f"http://127.0.0.1:{server.server_address[1]}"


def _pd_close(*pairs):
    for engine, server, _ in pairs:
        server.shutdown()
        server.server_close()
        engine.stop()


class _PDWatch:
    """Records, on the engines' own threads, what P/D and the pool move:
    the device slab the prefill engine's last hand-off export and its
    last pool publish gathered (clones), and for each import the decode
    pool's pages gathered right after it, with the import's card ms
    between two synchronizations; the bytes and seconds of each pull."""

    def __init__(self, torch, pre, dec):
        import kaito_tpu_torch.engine.engine as em
        from kaito_tpu_torch.engine import pd

        self.torch, self.em, self.pd = torch, em, pd
        self.exports, self.published, self.imports, self.pulls = [], [], [], []
        self._stage, self._import = em.stage_export, em.import_arrays
        self._pre, self._dec = pre, dec
        watch = self

        def stage(cache, pages, **kw):
            exp = watch._stage(cache, pages, **kw)
            if cache is watch._pre.cache:
                slabs = [[t.clone() for t in exp.device_slabs()]]
                if kw.get("first_token", -1) >= 0:
                    watch.exports = slabs
                else:
                    watch.published = slabs
            return exp

        def imp(cache, pages, *arrs, **kw):
            if cache is not watch._dec.cache:
                return watch._import(cache, pages, *arrs, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            watch._import(cache, pages, *arrs, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = [t for t in pd._gather_canonical(cache, pages) if t is not None]
            watch.imports = [(len(pages), ms, got)]

        em.stage_export, em.import_arrays = stage, imp
        note = dec.pd_costs.note_transfer

        def pulled(nbytes, seconds):
            watch.pulls.append((nbytes, seconds))
            note(nbytes, seconds)
        dec.pd_costs.note_transfer = pulled

    def close(self):
        self.em.stage_export, self.em.import_arrays = self._stage, self._import

    def check_equal(self, label, published=False):
        """The last import's pages (and scales) equal the last export's
        slab (``published``: the last pool publish's) byte for byte."""
        want = (self.published if published else self.exports)[-1]
        n_pages, ms, got = self.imports[-1]
        want = [t[:, :n_pages] for t in want]
        if len(got) != len(want) or not all(
                self.torch.equal(a, b) for a, b in zip(got, want)):
            raise SmokeFailure(f"{label}: the imported pages differ from the prefill "
                               f"pool's")
        return n_pages, ms


def _pd_prefill(base, text, **extra):
    t0 = time.perf_counter()
    status, raw = _post(f"{base}/pd/prefill", dict(prompt=text, **extra))
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise SmokeFailure(f"/pd/prefill answered {status}: {raw[:300]!r}")
    return json.loads(raw), ms


def _pd_decode(base, src, text, hs, wire, n, **extra):
    """A completion of ``n`` greedy tokens continuing the staged prefill
    ``hs`` of ``src`` over ``wire`` ("http" or "auto"): (tokens,
    logprobs)."""
    kv = dict(source_url=src, req_id=hs["req_id"], prompt_tokens=hs["prompt_tokens"],
              first_token=hs["first_token"], wire=wire, force=True)
    status, raw = _post(f"{base}/v1/completions", dict(
        prompt=text, max_tokens=n, temperature=0.0, ignore_eos=True, logprobs=1,
        kv_transfer=kv, **extra))
    ch = json.loads(raw)["choices"][0]
    return ch["logprobs"]["tokens"], ch["logprobs"]["token_logprobs"]


def _stream_ttft(base, path, body, headers=None) -> tuple[float, list]:
    """(ms to the first event, the parsed events; "[DONE]" as itself) of
    a streamed request.  The port's server opens a stream with its first
    token, and the RAG server relays the upstream's events as they come,
    so the first event stands for the first token (whose text the byte
    tokenizer may decode to nothing on a synthetic model's vocabulary)."""
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    t0 = time.perf_counter()
    ttft, events = None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[6:]
            if data == b"[DONE]":
                events.append("[DONE]")
                continue
            if ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
            events.append(json.loads(data))
    return ttft, events


def _content(events) -> str:
    """The text a stream's events carry (completion or chat chunks)."""
    return "".join(c.get("text") or (c.get("delta") or {}).get("content") or ""
                   for e in events if e != "[DONE]" for c in e.get("choices") or [])


def _greedy_stream(text, n) -> dict:
    return dict(prompt=text, max_tokens=n, temperature=0.0, ignore_eos=True,
                stream=True)


def _pd_exact(label) -> dict:
    """The four sections of ``tiny-llama-real`` through P/D on the card,
    over the HTTP wire and the colocated device path: every golden
    prompt prefilled on one server and decoded on the other, the pages
    equal byte for byte; tokens exact and logprobs within 2e-3 of the
    goldens (the first token's comes from the prefill role), for
    ``kv_int8`` of a CPU pair's same runs."""
    import torch

    from kaito_tpu_torch.engine.config import EngineConfig

    golden = json.load(open(os.path.join(REPO, "tests", "testdata",
                                         "goldens_tiny-llama-real.json")))
    res = {}
    for sec, (quant, kv) in GOLDEN_MODES.items():
        cfg = EngineConfig(model="tiny-llama-real",
                           weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                           dtype="float32", kv_dtype=kv, quantization=quant,
                           max_model_len=512, max_num_seqs=2, prefill_buckets=(64, 128),
                           seed=0, pd_enabled=True)
        runs = {}
        for dev in ("cuda", "cpu") if sec == "kv_int8" else ("cuda",):
            pairs = []
            for _ in range(2):
                from kaito_tpu_torch.engine.engine import InferenceEngine
                from kaito_tpu_torch.engine.server import make_server

                eng = InferenceEngine(cfg, device=dev)
                eng.start()
                srv = make_server(eng, cfg, host="127.0.0.1", port=0, device=dev)
                threading.Thread(target=srv.serve_forever, daemon=True).start()
                pairs.append((eng, srv, f"http://127.0.0.1:{srv.server_address[1]}"))
            (pre, _, a), (dec, _, b) = pairs
            watch = _PDWatch(torch, pre, dec) if dev == "cuda" else None
            finished = _finished_requests(dec)
            try:
                out = []
                for p in golden["prompts"]:
                    for wire in ("http", "auto"):
                        staged = pre.submit(list(p["prompt_tokens"]), _pd_params(1),
                                            export_kv=True)
                        list(staged.stream())
                        hs = dict(req_id=staged.req_id, first_token=staged.output_tokens[0],
                                  prompt_tokens=list(p["prompt_tokens"]))
                        n = len(p[sec]["greedy_tokens"])
                        _pd_decode(b, a, "x", hs, wire, n)
                        r = finished[-1]
                        if watch is not None:
                            watch.check_equal(f"{label}, exact {sec} {wire}")
                        out.append((list(r.output_tokens), list(r.output_logprobs)))
                runs[dev] = out
            finally:
                if watch is not None:
                    watch.close()
                _pd_close(*pairs)
        want = runs.get("cpu") or [
            (p[sec]["greedy_tokens"], p[sec]["logprobs"])
            for p in golden["prompts"] for _ in ("http", "auto")]
        diff = 0.0
        for (gt, gl), (wt, wl) in zip(runs["cuda"], want):
            if list(gt) != list(wt):
                raise SmokeFailure(f"{label}, exact {sec}: tokens {gt} against {wt}")
            diff = max([diff] + [abs(x - y) for x, y in zip(gl[1:], wl[1:])])
        if diff > 2e-3:
            raise SmokeFailure(f"{label}, exact {sec}: logprobs part by {diff}")
        res[sec] = diff
        log(f"{label}, exact tiny-llama-real {sec} through P/D (HTTP wire and device "
            f"path): tokens exact, logprobs within {diff:.2e} of "
            f"{'a CPU pair' if sec == 'kv_int8' else 'the goldens'}")
    _release_card(torch)
    return res


def run_pd_phase(label) -> tuple[dict, dict]:
    """Phase 15, KV movement: Llama-3.1-8B at full width in bf16 (phase 4's
    config at ``--max-model-len 4096``, synthetic weights from seed 0,
    :data:`_PD_PAGES` pages a pool) on two HTTP servers in this process
    sharing one weight tree, both ``--pd-enabled`` and with the KV pool,
    the second with a disk tier in a temp dir.  P/D: prompts of ~1500 and
    ~3000 tokens prefilled on the first and decoded on the second, over
    the HTTP wire (forced past the break-even) and the colocated device
    path: the decode pool's pages equal the prefill pool's byte for byte,
    the decode engine runs no prefill for them and captures no graph
    again, the greedy tokens equal the second engine's own monolithic run
    of the prompt up to a near-tie.  The pool: a prompt the first
    published is fetched by the second through the ``X-Kaito-KV-Fetch``
    headers; a second publish on the second, whose store holds one
    entry, demotes the first to disk, and a repeat hits the disk tier:
    each imports pages equal to the publisher's byte for byte, and its
    greedy tokens equal the cold run's up to a near-tie.
    Then the exact legs (:func:`_pd_exact`).  Logged beside the card:
    the prefill role's ms, the meta handshake's, wire bytes and GB/s,
    the import's card ms against a recompute prefill, the device path's
    copy ms, and TTFT warm through a fetch and a disk hit against cold."""
    import dataclasses
    import tempfile

    import torch

    from kaito_tpu_torch.engine.kv_pool import pool_key, prompt_pool_blocks
    from kaito_tpu_torch.engine.server import parse_args

    t_leg = time.perf_counter()
    for name in _P14_KERNELS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
    cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16", "--max-num-seqs",
                         "8", "--seed", "0", "--max-model-len", "4096", "--max-pages",
                         str(_PD_PAGES), "--pd-enabled", "--kv-pool"])
    tmp = tempfile.mkdtemp(prefix="kaito-pd-")
    stats: dict = {}
    t0 = time.perf_counter()
    A = _pd_serve(cfg, None)
    params = A[0].model.param_tree()
    B = _pd_serve(dataclasses.replace(cfg, kv_pool_bytes=_PD_STORE_BYTES,
                                      kv_pool_disk_bytes=4 << 30,
                                      kv_pool_disk_dir=tmp), params)
    (pre, _, a), (dec, _, b) = A, B
    log(f"{label}: two servers up in {time.perf_counter() - t0:.1f}s, "
        f"{pre.allocator.num_pages} + {dec.allocator.num_pages} pages")
    watch = _PDWatch(torch, pre, dec)
    prefills = []
    orig_adv = dec._advance_prefills

    def timed_prefills():
        # a recompute's prefill rounds, each between two synchronizations
        torch.cuda.synchronize()
        t = time.perf_counter()
        did = orig_adv()
        torch.cuda.synchronize()
        if did:
            prefills.append((time.perf_counter() - t) * 1e3)
        return did
    try:
        texts = [_prompt(n, 300 + i) for i, n in enumerate(_PD_PROMPTS)]
        finished = _finished_requests(dec)
        # the first server's first prefills pay the library's first calls
        # and its first decode windows their captures (cold TTFT below is
        # a cold cache, not a cold engine)
        for salt, n in ((290, 200), (291, 1500)):
            _completion(a, _prompt(n, salt), _PD_TOKENS)
        mono = {}
        for text in texts:
            # the decode engine's own monolithic run: the reference, and
            # the graphs a lone sequence replays, captured before the
            # hand-offs
            _completion(b, text, _PD_TOKENS, logprobs=1)
            mono[text] = finished[-1]
        # the pool, first (a freshly started replica has measured no
        # link yet, so no measured break-even vetoes the fetch): A
        # publishes, B fetches through the router's headers
        c = dec.counters
        text = _prompt(1500, 340)
        finished_a = _finished_requests(pre)
        # a stream carries no logprobs: the engines' requests keep them,
        # for the near-tie rule
        _keep_logprobs(pre, "submit")
        _keep_logprobs(dec, "submit", "submit_with_kv_prefix")
        cold_ms, events = _stream_ttft(a, "/v1/completions",
                                       _greedy_stream(text, _PD_TOKENS))
        want_text = _content(events)
        cold = finished_a[-1]
        blocks = prompt_pool_blocks(text, cfg.page_size)
        key = next((pool_key(blocks[:n]) for n in range(len(blocks), 0, -1)
                    if pre.kv_pool.has(pool_key(blocks[:n]))), None)
        if key is None:
            raise SmokeFailure(f"{label}: the first server published nothing")
        watch.imports = []
        fetch_ms, events = _stream_ttft(
            b, "/v1/completions", _greedy_stream(text, _PD_TOKENS),
            headers={"X-Kaito-KV-Fetch": a, "X-Kaito-KV-Fetch-Key": key})
        got = _content(events)
        fetch_req = finished[-1]
        if len(watch.imports) != 1:
            raise SmokeFailure(f"{label}: the pool fetch made {len(watch.imports)} imports")
        fetch_pages = watch.check_equal(f"{label}, pool fetch", published=True)[0]
        if c["kv_pool_fetches_total"] != 1 or c["kv_pool_fetch_failures_total"]:
            raise SmokeFailure(f"{label}: pool fetches {c['kv_pool_fetches_total']}, "
                               f"failures {c['kv_pool_fetch_failures_total']}")
        fetched = c["kv_pool_fetched_tokens_total"]
        if fetched <= 0 or fetched % cfg.page_size or not dec.kv_pool.has(key):
            raise SmokeFailure(f"{label}: fetched {fetched} tokens, held "
                               f"{dec.kv_pool.has(key)}")
        # a second publish on B, whose store holds one entry, demotes the
        # fetched prefix to disk
        _completion(b, _prompt(1500, 341), 4)
        deadline = time.monotonic() + 60
        while not dec.kv_tier.has(key) and time.monotonic() < deadline:
            time.sleep(0.05)
        if dec.kv_pool.has(key) or not dec.kv_tier.has(key):
            raise SmokeFailure(f"{label}: the fetched prefix was not demoted to disk")
        watch.imports = []
        disk_ms, events = _stream_ttft(b, "/v1/completions",
                                       _greedy_stream(text, _PD_TOKENS))
        got_disk = _content(events)
        disk_req = finished[-1]
        if c["kv_tier_disk_hits_total"] != 1:
            raise SmokeFailure(f"{label}: disk hits {c['kv_tier_disk_hits_total']}")
        if len(watch.imports) != 1:
            raise SmokeFailure(f"{label}: the disk hit made {len(watch.imports)} imports")
        # the disk slab is the fetched prefix demoted: the publisher's pages
        disk_pages = watch.check_equal(f"{label}, disk hit", published=True)[0]
        # the continuation through either equals the cold run's, or parts
        # at a near-tie (the rule of the P/D rows below)
        agree = _same_or_tie([fetch_req, disk_req], [cold, cold],
                             f"{label}, pool fetch and disk hit against the cold run")
        stats["pool"] = dict(cold_ttft_ms=cold_ms, fetch_ttft_ms=fetch_ms,
                             disk_ttft_ms=disk_ms, fetched_tokens=fetched,
                             fetch_pages=fetch_pages, disk_pages=disk_pages,
                             equal_prefix=agree, fetch_text_equal=got == want_text,
                             disk_text_equal=got_disk == want_text,
                             disk_entries=len(dec.kv_tier))
        log(f"{label}: the pool fetch imported {fetch_pages} pages and the disk hit "
            f"{disk_pages}, equal to the publisher's byte for byte; tokens equal to the "
            f"cold run's for {agree} of {_PD_TOKENS}")
        log(f"{label}: TTFT cold {cold_ms:.1f} ms, through a pool fetch of {fetched} "
            f"tokens {fetch_ms:.1f} ms, through a disk hit {disk_ms:.1f} ms")
        pd_rows = []
        for wire in ("http", "auto"):
            for text in texts:
                hs, prefill_ms = _pd_prefill(a, text, temperature=0.0)
                meta_ms = None
                if wire == "http":
                    t = time.perf_counter()
                    status, raw = _get(f"{a}/pd/kv/{hs['req_id']}/meta")
                    meta_ms = (time.perf_counter() - t) * 1e3
                    if status != 200:
                        raise SmokeFailure(f"{label}: meta answered {status}")
                    # the handshake started the drain to host: its wall,
                    # apart from the pull's
                    t = time.perf_counter()
                    pre.kv_exports.get(hs["req_id"]).wait_all()
                    drain_ms = (time.perf_counter() - t) * 1e3
                before = (c["prefill_steps_total"], c["decode_graph_captures_total"],
                          c["pd_device_handoffs_total"], len(watch.pulls))
                _pd_decode(b, a, text, hs, wire, _PD_TOKENS)
                got = finished[-1]
                if (c["prefill_steps_total"], c["decode_graph_captures_total"]) != \
                        before[:2]:
                    raise SmokeFailure(f"{label}, {wire}: the decode engine prefilled "
                                       f"or captured: {before} -> {c}")
                if wire == "auto" and c["pd_device_handoffs_total"] != before[2] + 1:
                    raise SmokeFailure(f"{label}: no colocated device hand-off")
                if wire == "http" and len(watch.pulls) != before[3] + 1:
                    raise SmokeFailure(f"{label}: no pull over the wire")
                n_pages, import_ms = watch.check_equal(f"{label}, {wire}")
                if got.output_tokens[0] != mono[text].output_tokens[0]:
                    raise SmokeFailure(f"{label}, {wire}: the prefill role's first token "
                                       f"{got.output_tokens[0]} is not the monolithic "
                                       f"run's {mono[text].output_tokens[0]}")
                j = _same_or_tie([got], [mono[text]], f"{label}, {wire}")[0]
                row = dict(wire=wire, prompt_tokens=len(hs["prompt_tokens"]),
                           pages=n_pages, prefill_role_ms=prefill_ms,
                           import_card_ms=import_ms, equal_prefix=j)
                if wire == "http":
                    nbytes, sec = watch.pulls[-1]
                    row.update(meta_ms=meta_ms, drain_ms=drain_ms, wire_bytes=nbytes,
                               wire_gb_s=nbytes / sec / 1e9)
                pd_rows.append(row)
                log(f"{label}: {row}")
        stats["pd"] = pd_rows
        # a recompute prefill of a fresh prompt of each length on the
        # decode engine, its rounds between two synchronizations
        dec._advance_prefills = timed_prefills
        for i, n in enumerate(_PD_PROMPTS):
            prefills.clear()
            _completion(b, _prompt(n, 320 + i), 1)
            stats.setdefault("recompute_prefill_ms", []).append(sum(prefills))
        dec._advance_prefills = orig_adv
        log(f"{label}: recompute prefill card ms {stats['recompute_prefill_ms']} for "
            f"{list(_PD_PROMPTS)} tokens")
    finally:
        watch.close()
        _pd_close(A, B)
    del A, B, pre, dec
    _release_card(torch)
    torch.cuda.synchronize()
    launches = {name: getattr(*_counter(name)) for name in _P14_KERNELS}
    log(f"{label}: launches {launches}")
    stats["exact"] = _pd_exact(label)
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats


def _finished_requests(engine) -> list:
    """A list the engine appends each request it finishes to."""
    done, trace = [], engine._finish_trace

    def keep(req):
        done.append(req)
        trace(req)
    engine._finish_trace = keep
    return done


def _keep_logprobs(engine, *entries):
    """Make each of ``engine``'s submit ``entries`` keep its request's
    logprobs (the engine computes them either way)."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    for name in entries:
        fn = getattr(engine, name)

        def keep(*args, _fn=fn, **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, SamplingParams):
                    a.logprobs = True
            return _fn(*args, **kw)
        setattr(engine, name, keep)


def _pd_params(n):
    from kaito_tpu_torch.engine.engine import SamplingParams

    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True, logprobs=True)


_TP2 = ["--tensor-parallel-size", "2", "--comm-overlap"]
_LLAMA, _GPT_OSS, _DEEPSEEK = "llama-3.1-8b-instruct", "gpt-oss-20b", "deepseek-v3-0324"


TRAIN_LEG = ("train-bf16", "phase 16, bf16 fine-tuning at full width (LoRA, QLoRA, full)")
TRAIN_EXACT_LEG = ("train-fp32", "phase 16, fp32 fine-tuning exact against the CPU")
_TRAIN_WORDS = ("river", "stone", "light", "north", "amber", "cedar", "violet", "harbor",
                "signal", "meadow", "copper", "lantern", "orbit", "thistle", "quartz",
                "willow")
# (run, model, method, batch, sequence length): the 8B runs share the
# seeded base (each draws it anew), QLoRA at B=4 x T=512 takes the dequant
# product (2048 rows), at B=1 x T=256 the K4 wrapper under autograd
TRAIN_RUNS = (("lora", _LLAMA, "lora", 4, 512),
              ("qlora", _LLAMA, "qlora", 4, 512),
              ("qlora-short", _LLAMA, "qlora", 1, 256),
              ("full", _DRAFT, "full", 4, 512))
TRAIN_STEPS = 8
TRAIN_EXACT_STEPS = 5
# the exact leg: (model, method, batch, sequence length, serve the adapter)
TRAIN_EXACT_RUNS = (("tiny-llama-real", "lora", 2, 64, True),
                    ("tiny-llama-real", "qlora", 1, 64, False),
                    ("tiny-moe-real", "lora", 2, 64, True))
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_STEP_REL, TRAIN_LOGPROB_ATOL = 1e-4, 1e-3, 1e-2, 2e-3


def _train_data(root, n, chars, seed) -> str:
    """A seeded instruction/response jsonl of ``n`` records of about
    ``chars`` bytes each (byte tokens: the card machine has no tokenizer
    files)."""
    import random

    rng = random.Random(seed)
    path = os.path.join(root, f"data-{seed}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "train.jsonl"), "w") as f:
        for _ in range(n):
            words = []
            while sum(len(w) + 1 for w in words) < chars // 2:
                words.append(rng.choice(_TRAIN_WORDS))
            text = " ".join(words)
            f.write(json.dumps({"instruction": f"Reverse: {text}",
                                "response": " ".join(reversed(words))}) + "\n")
    return path


@contextlib.contextmanager
def _grad_guard():
    """Fail if ``quant_matmul_cuda`` is called with an ``x`` that needs a
    gradient under grad mode (outside ``QuantMatmulFn``, whose forward
    runs with grad mode off), or if the flash prefill kernel launches."""
    import torch

    from kaito_tpu_torch.engine.ops import flash_prefill
    from kaito_tpu_torch.engine.ops import quant_matmul as qm

    real = qm.quant_matmul_cuda
    counters = {k: v for k, v in vars(real).items() if k.startswith("launches")}
    flash0 = flash_prefill.flash_prefill_attention_cuda.launches

    def guarded(x, w, w_next=None):
        if x.requires_grad and torch.is_grad_enabled():
            raise SmokeFailure("quant_matmul_cuda called on an x that needs a gradient "
                               "outside QuantMatmulFn")
        return real(x, w, w_next)

    # the wrapper counts its launches on the module's name for it: the
    # guard holds the counters meanwhile and hands them back
    vars(guarded).update(counters)
    qm.quant_matmul_cuda = guarded
    try:
        yield
    finally:
        qm.quant_matmul_cuda = real
        for k in counters:
            setattr(real, k, getattr(guarded, k))
    n = flash_prefill.flash_prefill_attention_cuda.launches - flash0
    if n:
        raise SmokeFailure(f"the flash prefill kernel launched {n} times in training")


def _per_layer_ok(torch, name, t) -> bool:
    """Every layer's slice of a stacked leaf (``group/name``), or a
    top-level leaf whole, finite and not all zero."""
    t = t.float()
    rows = t.flatten(1) if "/" in name else t.reshape(1, -1)
    return bool(torch.isfinite(rows).all()) and bool((rows.abs().amax(1) > 0).all())


def _train_run(torch, run, model, method, B, T, data_dir, label) -> dict:
    """One full-width run through ``Trainer`` (8 steps, no output dir),
    then one more forward and backward: every trainable leaf's gradient
    finite and non-zero in every layer, every B moved."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.tuning import dataset as ds
    from kaito_tpu_torch.tuning.lora import LoraConfig
    from kaito_tpu_torch.tuning.train_step import loss_and_grads
    from kaito_tpu_torch.tuning.trainer import TrainConfig, Trainer

    cfg = TrainConfig(model=model, method=method, data_dir=data_dir, output_dir="",
                      lora=LoraConfig(r=8, alpha=16), batch_size=B, max_seq_len=T,
                      max_steps=TRAIN_STEPS, warmup_steps=2, checkpoint_every=0,
                      dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_gib = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    k4 = qm.quant_matmul_cuda.launches_int8
    k4w = qm.quant_matmul_cuda.launches_int8_wide
    stamps, losses, norms, tps = [time.perf_counter()], [], [], []

    def on_step(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(m["loss"])
        norms.append(float(m["grad_norm"]))
        tps.append(m["tokens_per_second"])

    with _grad_guard():
        tr.train(on_step=on_step)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses + norms):
            raise SmokeFailure(f"{label} {run}: losses {losses}, grad norms {norms}")
        data, _ = ds.build_examples(tr.tokenizer, ds.DatasetConfig(data_dir=data_dir,
                                                                   max_seq_len=T))
        b = next(ds.batches(data, B, seed=cfg.seed))
        batch = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        _, grads = loss_and_grads(tr.model, batch, tr.state.params)
    k4_n = qm.quant_matmul_cuda.launches_int8 - k4
    k4w_n = qm.quant_matmul_cuda.launches_int8_wide - k4w
    bad = [n for n, g in zip(tr.train_names, grads) if not _per_layer_ok(torch, n, g)]
    unmoved = [n for n, p in zip(tr.train_names, tr.state.params)
               if n.endswith("_lora_b") and not _per_layer_ok(torch, n, p.detach())]
    if bad or unmoved:
        raise SmokeFailure(f"{label} {run}: gradients zero or not finite in a layer of "
                           f"{bad}; B leaves that did not move {unmoved}")
    if method == "qlora" and B * T <= 256 and k4_n <= 0:
        raise SmokeFailure(f"{label} {run}: K4 never launched at {B * T} rows")
    ms = sorted((stamps[i + 1] - stamps[i]) * 1e3 for i in range(2, TRAIN_STEPS))
    res = dict(model=model, method=method, batch=B, seq=T, setup_s=setup_s,
               setup_peak_gib=setup_gib, losses=losses, grad_norms=norms,
               step_ms_median_3_8=(ms[2] + ms[3]) / 2, step_ms_3_8=ms,
               tokens_per_s=tps[-1], peak_gib=peak_gib,
               trainable_leaves=len(tr.train_names),
               trainable_params=sum(p.numel() for p in tr.state.params),
               k4_launches=k4_n, k4_wide_launches=k4w_n)
    log(f"{label} {run} ({model}, {method}, B={B}, T={T}): loss by step "
        f"{[round(x, 4) for x in losses]}; median step {res['step_ms_median_3_8']:.1f} "
        f"ms (steps 3-8), {res['tokens_per_s']:.0f} tokens/s, peak "
        f"{res['peak_gib']:.2f} GiB training ({setup_gib:.2f} GiB setting up in "
        f"{setup_s:.1f} s), K4 launches {k4_n} ({k4w_n} wide); every "
        f"trainable leaf's gradient finite and non-zero in every layer")
    del tr, grads, batch
    return res


def run_train_phase(label) -> tuple[dict, dict]:
    """Phase 16 at full width: LoRA and QLoRA (B=4 x T=512 and B=1 x
    T=256) on Llama-3.1-8B, full fine-tuning on Llama-3.2-1B, synthetic
    bf16 weights from seed 0, 8 steps each through ``Trainer``."""
    import shutil
    import tempfile

    import torch

    t_leg = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kaito-train-")
    stats, launches = {}, {"quant_matmul_int8": 0, "quant_matmul_int8_wide": 0}
    try:
        for run, model, method, B, T in TRAIN_RUNS:
            data = _train_data(root, 48 if B > 1 else 24, T + T // 4, seed=B * 1000 + T)
            stats[run] = _train_run(torch, run, model, method, B, T, data, label)
            launches["quant_matmul_int8"] += stats[run]["k4_launches"]
            launches["quant_matmul_int8_wide"] += stats[run]["k4_wide_launches"]
            _release_card(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats


def _close_leaves(torch, label, names, got, want, nu, lr_sum) -> tuple[float, float]:
    """The card's leaves against the CPU's, measured in the summed
    learning rates (Adam moves an element about the learning rate a step,
    whatever its gradient): in every leaf 99% of the elements within 1%
    of ``lr_sum`` and every element within 25%, except where the
    gradient is at the rounding level of the leaf's largest (second
    moment below 1e-10 of the largest), where Adam's step may take either
    sign.  Adam divides each gradient's rounding by the element's own
    summed history, which cancels where the gradient changes sign, so a
    few elements stray past 1%.  Returns (the largest difference, the
    largest share of a leaf past 1%)."""
    worst = frac = 0.0
    for n, a, b, v in zip(names, got, want, nu):
        d = (a.detach().cpu().float() - b.detach().float()).abs() / lr_sum
        v = v.cpu().float()
        stray = d > TRAIN_STEP_REL
        far = (d > 25 * TRAIN_STEP_REL) & (v >= 1e-10 * v.max())
        if bool(far.any()) or float(stray.float().mean()) > 1e-2:
            raise SmokeFailure(f"{label}: leaf {n} differs from the CPU's by up to "
                               f"{float(d.max()):.3e} of the summed learning rates, "
                               f"{float(stray.float().mean()):.2e} of it past "
                               f"{TRAIN_STEP_REL}")
        worst = max(worst, float(d.max()))
        frac = max(frac, float(stray.float().mean()))
    return worst, frac


def _serve_logprob(torch, tr, root, model, wdir, prompt) -> tuple[float, float]:
    """The trained adapter saved by ``save_adapter`` and served by a card
    engine (boot-time adapter): (logprob of its first greedy token, the
    same token's logprob from ``forward_train`` at the prompt's last
    position)."""
    import dataclasses

    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
    from kaito_tpu_torch.engine.server import parse_args
    from kaito_tpu_torch.tuning.lora import save_adapter

    save_adapter(os.path.join(root, "tuned"), tr.model.param_tree(), tr.cfg.lora, model)
    cfg, _ = parse_args(["--model", model, "--weights-dir", wdir, "--dtype", "float32",
                         "--max-model-len", "256", "--max-num-seqs", "4",
                         "--no-enable-prefix-caching", "--adapter-slots", "2",
                         "--adapter-rmax", str(tr.cfg.lora.r)])
    eng = InferenceEngine(dataclasses.replace(cfg, adapters_dir=root), device="cuda")
    tokens = eng.tokenizer.encode(prompt)
    req = eng.submit(tokens, SamplingParams(max_tokens=1, temperature=0.0,
                                            ignore_eos=True, logprobs=True),
                     adapter="tuned")
    for _ in range(1000):
        eng.step()
        if req.finish_reason:
            break
    if req.finish_reason != "length":
        raise SmokeFailure(f"the adapter's request did not finish: {req.finish_reason}")
    tok, lp = req.output_tokens[0], float(req.output_logprobs[0])
    with torch.no_grad():
        logits = tr.model.forward_train(torch.tensor([tokens], device="cuda"))
    ref = float(torch.log_softmax(logits[0, -1], -1)[tok])
    del eng
    return lp, ref


def run_train_exact_phase(label) -> dict:
    """Phase 16, exact: tiny-llama-real (LoRA, and QLoRA at 64 rows, which
    runs K4 under autograd) and tiny-moe-real (LoRA) in fp32 from their
    checkpoints, 5 steps from the same weights and factors on the CPU and
    on the card: losses, grad norms and final trainable leaves equal; the
    LoRA runs' adapters served by a card engine give their first token's
    logprob as ``forward_train`` does."""
    import shutil
    import tempfile

    import torch

    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.weights import load_safetensors_params
    from kaito_tpu_torch.models import get_model_by_name
    from kaito_tpu_torch.tuning.lora import LoraConfig
    from kaito_tpu_torch.tuning.optim import warmup_cosine_decay_schedule
    from kaito_tpu_torch.tuning.trainer import TrainConfig, Trainer

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.detach().clone()
                for k, v in tree.items()}

    t_leg = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kaito-train-exact-")
    res = {}
    try:
        for model, method, B, T, serve in TRAIN_EXACT_RUNS:
            run = f"{model} {method} B={B} T={T}"
            wdir = os.path.join(REPO, "checkpoints", model)
            base = TransformerLM(get_model_by_name(model).arch, torch.float32, "cpu")
            tree = load_safetensors_params(base, wdir)
            cfg = TrainConfig(model=model, method=method,
                              data_dir=_train_data(root, 24, T, seed=T + B),
                              output_dir="", lora=LoraConfig(r=8, alpha=16),
                              batch_size=B, max_seq_len=T, max_steps=TRAIN_EXACT_STEPS,
                              warmup_steps=2, learning_rate=1e-3, checkpoint_every=0,
                              dtype="float32")
            cpu = Trainer(cfg, device="cpu", params=tree)
            card = Trainer(cfg, device="cuda", params=clone(cpu.model.param_tree()))
            got, want = [], []
            cpu.train(on_step=lambda s, m: want.append((m["loss"], float(m["grad_norm"]))))
            k4 = qm.quant_matmul_cuda.launches_int8
            with _grad_guard():
                card.train(on_step=lambda s, m: got.append((m["loss"],
                                                            float(m["grad_norm"]))))
            k4_n = qm.quant_matmul_cuda.launches_int8 - k4
            if method == "qlora" and k4_n <= 0:
                raise SmokeFailure(f"{label} {run}: K4 never launched")
            if len(got) != TRAIN_EXACT_STEPS or not all(x > 0 for x, _ in want):
                raise SmokeFailure(f"{label} {run}: steps {got}, CPU {want}")
            for (gl, gn), (wl, wn) in zip(got, want):
                if abs(gl - wl) > TRAIN_LOSS_RTOL * abs(wl) or \
                        abs(gn - wn) > TRAIN_NORM_RTOL * abs(wn):
                    raise SmokeFailure(f"{label} {run}: card (loss, grad norm) {got}, "
                                       f"CPU {want}")
            schedule = warmup_cosine_decay_schedule(
                0.0, cfg.learning_rate, cfg.warmup_steps,
                max(cfg.max_steps, cfg.warmup_steps + 1))
            lr_sum = sum(float(schedule(c)) for c in range(TRAIN_EXACT_STEPS))
            worst, frac = _close_leaves(torch, f"{label} {run}", card.train_names,
                                  card.state.params, cpu.state.params,
                                  card.state.opt_state[1][0]["nu"], lr_sum)
            entry = dict(losses_card=[x for x, _ in got], losses_cpu=[x for x, _ in want],
                         grad_norms_card=[x for _, x in got],
                         grad_norms_cpu=[x for _, x in want],
                         leaf_max_diff_over_lr_sum=worst,
                         leaf_share_past_1pct=frac, k4_launches=k4_n)
            if serve:
                lp, ref = _serve_logprob(torch, card, root, model, wdir,
                                         "Reverse: river stone light")
                if abs(lp - ref) > TRAIN_LOGPROB_ATOL:
                    raise SmokeFailure(f"{label} {run}: the served adapter's first "
                                       f"logprob {lp}, forward_train's {ref}")
                entry.update(served_logprob=lp, forward_train_logprob=ref)
            res[run] = entry
            log(f"{label} {run}: losses card {entry['losses_card']} CPU "
                f"{entry['losses_cpu']}; leaves within {worst:.2e} of the summed "
                f"learning rates ({frac:.2e} of a leaf past 1%); "
                f"K4 launches {k4_n}"
                + (f"; served logprob {entry['served_logprob']:.6f} vs forward_train "
                   f"{entry['forward_train_logprob']:.6f}" if serve else ""))
            del cpu, card
            _release_card(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_leg
    log(f"{label}: {res['phase_s']:.1f}s")
    return res


RAG_LEG = ("rag-bf16", "phase 17, the RAG service: Qwen3-8B fp32 embedder over a "
           "Llama-3.1-8B bf16 upstream")
RAG_EXACT_LEG = ("rag-fp32", "phase 17, fp32 embedder on tiny-llama-real exact against "
                 "the CPU")
# the embedder: Qwen3-Embedding-8B's architecture (qwen3-8b's widths,
# 36 layers) uncut in fp32, ~32.8 GB beside the upstream's ~16 GB
_RAG_EMBED, _RAG_PAGES, _RAG_WINDOW = "qwen3-8b", 240, 1024
_RAG_DOCS, _RAG_QUERIES, _RAG_CHAT_TOKENS = 64, 16, 32
_RAG_WORDS = ("vector", "index", "cluster", "kernel", "latency", "replica", "tenant",
              "adapter", "operator", "gateway", "shard", "window", "prefix", "token",
              "schema", "budget", "router", "storage", "policy", "signal")
_RAG_USER = "Which documents talk about the kernel budget of a replica?"
# phase 17's guardrails policy: a reply longer than 20 characters is blocked;
# the guarded chats ask for letters (most of the synthetic model's tokens
# decode to no text under the byte tokenizer)
_RAG_POLICY = "output_scanners:\n  - type: max_length\n    max_chars: 20\nstream_window: 8\n"
_RAG_LETTERS = {"type": "regex", "regex": "[a-z]{40}"}
_RAG_EXACT_TEXTS = 24


def _rag_docs(n, seed) -> list[str]:
    """``n`` seeded documents of 200-1000 bytes of words."""
    import random

    rng = random.Random(seed)
    out = []
    for i in range(n):
        size = rng.randint(200, 1000)
        words = [f"doc{i}"]
        while len(" ".join(words)) < size:
            words.append(rng.choice(_RAG_WORDS))
        out.append(" ".join(words)[:size])
    return out


def _rag_token_lens() -> list[int]:
    """The embedder's token counts (cut at 256) of phase 17's first query
    of other words, then of its documents: the byte tokenizer's, which
    the embedder falls back to with no tokenizer files.  Phase 2 calls
    this, before the server phases: ``load_tokenizer`` would first
    import ``transformers`` where it is installed."""
    from kaito_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    texts = [_rag_docs(1, seed=71)[0][:80]] + _rag_docs(_RAG_DOCS, seed=17)
    return [min(len(tok.encode(t)), 256) for t in texts]


def _rag_post(url, body) -> tuple[int, dict]:
    status, raw = _post(url, body)
    return status, json.loads(raw)


@contextlib.contextmanager
def _no_plain_prefill_attention():
    """Fail if the plain differentiable ``attention.prefill_attention``
    (the training attention) runs: every cache-less forward on the card
    goes through the flash prefill kernel."""
    from kaito_tpu_torch.engine import attention

    real, calls = attention.prefill_attention, []

    def guarded(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    attention.prefill_attention = guarded
    try:
        yield
    finally:
        attention.prefill_attention = real
    if calls:
        raise SmokeFailure(f"the plain prefill_attention ran {len(calls)} times")


class _EmbedWatch:
    """Times each forward of a ``LocalTorchEmbedder`` between two
    synchronizations, on the thread that runs it: (rows, ms)."""

    def __init__(self, torch, embedder):
        self.forwards, real = [], embedder._forward

        def timed(tokens, lens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(tokens, lens)
            torch.cuda.synchronize()
            self.forwards.append((int(tokens.shape[0]), (time.perf_counter() - t0) * 1e3))
            return out
        embedder._forward = timed


def _rag_serve(cfg):
    """A started RAG server on the card, its persisted indexes loaded:
    (server, base URL)."""
    from kaito_tpu_torch.rag.app import make_server

    server = make_server(cfg, host="127.0.0.1", port=0, device="cuda")
    server.svc.lifecycle.startup()
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _retrieve_all(base, queries, label) -> tuple[list, list]:
    """(hits, ms) of one ``/retrieve`` (top 5) per query."""
    hits, ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        status, body = _rag_post(base + "/retrieve",
                                 {"index_name": "docs", "query": q, "top_k": 5})
        ms.append((time.perf_counter() - t0) * 1e3)
        if status != 200 or len(body["results"]) != 5:
            raise SmokeFailure(f"{label}: /retrieve answered {status} {body}")
        hits.append([(h["doc_id"], h["score"]) for h in body["results"]])
    return hits, ms


def run_rag_phase(label) -> tuple[dict, dict]:
    """Phase 17, the RAG service at full width: the port's RAG server
    (``EMBEDDING_MODEL_ID=qwen3-8b``, Qwen3-Embedding-8B's architecture
    uncut in fp32, synthetic weights from seed 0, built first) fronting
    the port's OpenAI server on Llama-3.1-8B in bf16 (phase 4's config,
    :data:`_RAG_PAGES` pages of 64), both in this process.  Indexing 64
    seeded documents in two calls (K2's launches rise by 36 a forward),
    16 retrievals (a query equal to a document's text finds it first, a
    metadata filter excludes what it names), chats streamed and not with
    the retrieved context injected (the upstream's reply carries its
    ``max_tokens``), a ``MaxLength`` guardrails policy that ends a stream
    and a reply with the block message, ``/metrics`` counting this phase,
    and a second RAG service loading the persisted index that retrieves
    the same ids and scores.  Logged beside the card: the embed ms a
    forward and its rows, documents/s, ``/retrieve`` p50, a chat's TTFT
    through the RAG server against the same injected prompt sent
    straight to the upstream, and the peak GiB."""
    import shutil
    import socket
    import tempfile

    import torch

    from kaito_tpu_torch.engine.server import make_server, parse_args
    from kaito_tpu_torch.rag.config import RAGConfig

    t_leg = time.perf_counter()
    k2 = _counter("flash_prefill_attention")
    for name in _P14_KERNELS:
        fn, attr = _counter(name)
        setattr(fn, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp(prefix="kaito-rag-")
    policy = os.path.join(root, "policy.yaml")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        up_port = s.getsockname()[1]
    rcfg = RAGConfig(llm_inference_url=f"http://127.0.0.1:{up_port}",
                     llm_context_window=_RAG_WINDOW, embedding_model_id=_RAG_EMBED,
                     persist_dir=os.path.join(root, "persist"),
                     guardrails_policy_file=policy)
    stats: dict = {}
    rag = upstream = None
    try:
        with _no_plain_prefill_attention():
            t0 = time.perf_counter()
            rag, base = _rag_serve(rcfg)
            emb = rag.svc.embedder._inner
            torch.cuda.synchronize()
            stats["embedder"] = dict(model=emb.model_name, layers=emb.model.arch.num_layers,
                                     gib=emb.model.param_bytes() / 2**30,
                                     setup_s=time.perf_counter() - t0)
            if emb.model_name != _RAG_EMBED or emb.model.dtype != torch.float32:
                raise SmokeFailure(f"{label}: embedder {emb.model_name} {emb.model.dtype}")
            watch = _EmbedWatch(torch, emb)
            cfg, _ = parse_args(["--model", _LLAMA, "--dtype", "bfloat16",
                                 "--max-num-seqs", "8", "--seed", "0", "--max-pages",
                                 str(_RAG_PAGES)])
            t0 = time.perf_counter()
            upstream = make_server(None, cfg, host="127.0.0.1", port=up_port,
                                   device="cuda")
            threading.Thread(target=upstream.serve_forever, daemon=True).start()
            up = f"http://127.0.0.1:{up_port}"
            log(f"{label}: embedder {_RAG_EMBED} fp32 "
                f"{stats['embedder']['gib']:.2f} GiB up in "
                f"{stats['embedder']['setup_s']:.1f}s; upstream up in "
                f"{time.perf_counter() - t0:.1f}s, "
                f"{upstream.state.engine.allocator.num_pages} pages")
            stats.update(_rag_drive(torch, rag, base, up, watch, k2, policy, label))
            status, body = _rag_post(base + "/persist", {})
            if status != 200 or body["persisted"] != ["docs"]:
                raise SmokeFailure(f"{label}: /persist answered {status} {body}")
            # a second service loads the persisted index at its start (the
            # first one's embedder released first: two 8B fp32 models and
            # the upstream do not fit one card)
            rag.shutdown()
            rag.server_close()
            rag = emb = watch = None
            _release_card(torch)
            rag, base2 = _rag_serve(rcfg)
            hits2, _ = _retrieve_all(base2, stats.pop("queries"), label)
            worst = max(abs(a[1] - b[1]) for h1, h2 in zip(stats["hits"], hits2)
                        for a, b in zip(h1, h2))
            if [[d for d, _ in h] for h in hits2] != [[d for d, _ in h]
                                                       for h in stats.pop("hits")]:
                raise SmokeFailure(f"{label}: the reloaded index retrieves other ids")
            if worst > 1e-6:
                raise SmokeFailure(f"{label}: reloaded scores differ by {worst:.2e}")
            stats["reload_max_score_diff"] = worst
            log(f"{label}: a second service loaded the persisted index: the same "
                f"ids, scores within {worst:.1e}")
        torch.cuda.synchronize()
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for srv in (rag, upstream):
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        if upstream is not None:
            upstream.state.engine.stop()
        rag = upstream = None
        shutil.rmtree(root, ignore_errors=True)
        _release_card(torch)
    launches = {name: getattr(*_counter(name)) for name in _P14_KERNELS}
    stats["phase_s"] = time.perf_counter() - t_leg
    log(f"{label}: launches {launches}; peak {stats['peak_gib']:.2f} GiB")
    return launches, stats


def _rag_drive(torch, rag, base, up, watch, k2, policy, label) -> dict:
    """The requests of :func:`run_rag_phase` against one RAG server
    ``base`` over the upstream ``up``."""
    from kaito_tpu_torch.rag.llm_client import inject_context
    from kaito_tpu_torch.rag.vector_store import doc_id_for

    res: dict = {}
    docs = _rag_docs(_RAG_DOCS, seed=17)
    metas = [{"group": i % 4, "i": i} for i in range(_RAG_DOCS)]
    half = _RAG_DOCS // 2
    n0, f0 = getattr(*k2), len(watch.forwards)
    calls = []
    for part in (slice(0, half), slice(half, None)):
        t0 = time.perf_counter()
        status, body = _rag_post(base + "/index", {
            "index_name": "docs", "documents": [
                {"text": t, "metadata": m} for t, m in zip(docs[part], metas[part])]})
        calls.append((time.perf_counter() - t0) * 1e3)
        if status != 200 or body["doc_ids"] != [doc_id_for(t) for t in docs[part]]:
            raise SmokeFailure(f"{label}: /index answered {status} {body}")
    fwd = watch.forwards[f0:]
    n_k2 = getattr(*k2) - n0
    layers = rag.svc.embedder._inner.model.arch.num_layers
    if n_k2 != layers * len(fwd) or sum(r for r, _ in fwd) != _RAG_DOCS:
        raise SmokeFailure(f"{label}: {n_k2} K2 launches over {len(fwd)} forwards of "
                           f"{[r for r, _ in fwd]} rows")
    res["index"] = dict(forwards=fwd, call_ms=calls, k2_launches=n_k2,
                        docs_per_s=_RAG_DOCS / (sum(ms for _, ms in fwd) / 1e3))
    log(f"{label}: indexed {_RAG_DOCS} documents in two calls ({calls[0]:.0f}, "
        f"{calls[1]:.0f} ms): forwards (rows, card ms) "
        f"{[(r, round(ms, 1)) for r, ms in fwd]}, {res['index']['docs_per_s']:.1f} "
        f"documents/s, K2 {n_k2} launches ({layers} a forward)")
    # one forward of 64 rows, the most a chunk holds
    emb = rag.svc.embedder._inner
    emb.embed(docs)
    res["chunk64"] = watch.forwards[-1]
    log(f"{label}: one forward of {res['chunk64'][0]} rows {res['chunk64'][1]:.1f} ms "
        f"({res['chunk64'][0] / res['chunk64'][1] * 1e3:.1f} documents/s)")
    status, raw = _get(f"{base}/indexes")
    body = json.loads(raw)
    if status != 200 or body != {"indexes": [{"name": "docs", "documents": _RAG_DOCS}]}:
        raise SmokeFailure(f"{label}: /indexes answered {status} {body}")
    # 16 queries: 8 documents' own texts, 8 of other words
    rng_words = _rag_docs(_RAG_QUERIES // 2, seed=71)
    exact = list(range(0, _RAG_DOCS, _RAG_DOCS // (_RAG_QUERIES // 2)))
    queries = [docs[i] for i in exact] + [w[:80] for w in rng_words]
    hits, ms = _retrieve_all(base, queries, label)
    for i, h in zip(exact, hits):
        if h[0][0] != doc_id_for(docs[i]) or h[0][1] < 1.0 - 1e-6:
            raise SmokeFailure(f"{label}: the text of document {i} retrieves {h[0]} first")
    status, body = _rag_post(base + "/retrieve", {
        "index_name": "docs", "query": docs[0], "top_k": 8,
        "metadata_filter": {"group": 1}})
    got = body.get("results", [])
    if status != 200 or not got or any(r["metadata"]["group"] != 1 for r in got) \
            or any(r["doc_id"] == doc_id_for(docs[0]) for r in got):
        raise SmokeFailure(f"{label}: the filtered retrieve answered {status} {got}")
    res["retrieve_ms"] = ms
    res["retrieve_p50_ms"] = _quantile(ms, 0.5)
    res["queries"], res["hits"] = queries, hits
    log(f"{label}: {len(queries)} retrievals, p50 {res['retrieve_p50_ms']:.1f} ms "
        f"(max {max(ms):.1f}); each document's own text finds it first (score 1); "
        f"the group filter keeps {len(got)} of group 1 only")
    # chat, not streamed then streamed, the retrieved context injected
    chat = {"index_name": "docs", "messages": [{"role": "user", "content": _RAG_USER}],
            "max_tokens": _RAG_CHAT_TOKENS, "temperature": 0.0, "ignore_eos": True}
    status, body = _rag_post(base + "/v1/chat/completions", chat)
    ctx = body.get("retrieved_context") or []
    if status != 200 or body["usage"]["completion_tokens"] != _RAG_CHAT_TOKENS \
            or body["choices"][0]["finish_reason"] != "length" or not ctx:
        raise SmokeFailure(f"{label}: the chat answered {status} {str(body)[:400]}")
    injected = inject_context(chat["messages"], ctx, _RAG_WINDOW)
    res["chat"] = dict(contexts=len(ctx), prompt_tokens=body["usage"]["prompt_tokens"])
    direct = {"messages": injected, "max_tokens": _RAG_CHAT_TOKENS, "temperature": 0.0,
              "ignore_eos": True, "stream": True}
    rag_ttft, up_ttft = [], []
    for _ in range(3):
        t, events = _stream_ttft(base, "/v1/chat/completions", dict(chat, stream=True))
        if t is None or events[-1] != "[DONE]" or not any(
                c.get("finish_reason") == "length" for e in events[:-1]
                for c in e.get("choices") or []):
            raise SmokeFailure(f"{label}: the streamed chat ended {events[-3:]}")
        rag_ttft.append(t)
        replies = [_content(events)]
        t, events = _stream_ttft(up, "/v1/chat/completions", direct)
        if t is None or events[-1] != "[DONE]":
            raise SmokeFailure(f"{label}: the upstream's stream ended {events[-3:]}")
        up_ttft.append(t)
        # both warm, the same prompt: the same greedy reply unless a
        # near-tie of the flat synthetic distribution parts them
        replies.append(_content(events))
    res["ttft_ms"] = dict(rag=rag_ttft, upstream=up_ttft)
    res["same_reply_as_upstream"] = replies[0] == replies[1]
    log(f"{label}: chat ({len(ctx)} contexts, {res['chat']['prompt_tokens']} prompt "
        f"tokens, {_RAG_CHAT_TOKENS} tokens, warm prefix): TTFT through the RAG "
        f"server {[round(x, 1) for x in rag_ttft]} ms, the same injected prompt "
        f"straight to the upstream {[round(x, 1) for x in up_ttft]} ms; the same "
        f"reply: {res['same_reply_as_upstream']}")
    # guardrails: a policy shorter than the reply blocks it
    with open(policy, "w") as f:
        f.write(_RAG_POLICY)
    rag.svc.reload_guardrails()
    guarded = dict(chat, response_format=_RAG_LETTERS)
    _, events = _stream_ttft(base, "/v1/chat/completions", dict(guarded, stream=True))
    last = events[-2]["choices"][0] if len(events) >= 2 else {}
    if events[-1] != "[DONE]" or last.get("finish_reason") != "content_filter" or \
            not last["delta"]["content"].startswith("Response blocked"):
        raise SmokeFailure(f"{label}: the guarded stream ended {events[-3:]}")
    status, body = _rag_post(base + "/v1/chat/completions", guarded)
    if status != 200 or body["choices"][0]["finish_reason"] != "content_filter":
        raise SmokeFailure(f"{label}: the guarded reply answered {status} {body}")
    log(f"{label}: the MaxLength policy ended the stream with {last['delta']['content']!r}")
    # /metrics: this phase's counts
    m = _g_metrics(base, "kaito_rag:")
    n_ret = len(queries) + 1
    want = {"kaito_rag:documents_indexed_total": _RAG_DOCS,
            "kaito_rag:documents": _RAG_DOCS, "kaito_rag:indexes": 1,
            'kaito_rag:requests_total{route="index",status="200"}': 3,
            'kaito_rag:requests_total{route="retrieve",status="200"}': n_ret,
            'kaito_rag:requests_total{route="chat",status="200"}': 6,
            "kaito_rag:retrieval_requests_total": n_ret + 6,
            "kaito_rag:embedding_texts_total": _RAG_DOCS + n_ret + 6,
            'kaito_rag:llm_requests_total{mode="sync"}': 2,
            'kaito_rag:llm_requests_total{mode="stream"}': 4,
            "kaito_rag:guardrails_blocked_total": 2,
            "kaito_rag:guardrails_policy_reloads_total": 1,
            "kaito_rag:guardrails_enabled": 1}
    bad = {k: (m.get(k), v) for k, v in want.items() if m.get(k) != v}
    if bad:
        raise SmokeFailure(f"{label}: /metrics (read, wanted) {bad}")
    log(f"{label}: /metrics carries {len({k.split('{')[0] for k in m})} kaito_rag "
        f"series names with this phase's counts")
    return res


def run_rag_exact_phase(label) -> dict:
    """Phase 17, exact: ``LocalTorchEmbedder`` on ``tiny-llama-real``'s
    checkpoint on the card and on the CPU: the same 24 texts (the empty
    text, one past 256 bytes and non-ASCII among them) give vectors
    within atol 1e-5, a row with no token at all gives the zero vector on
    both, K2 launches 4 times a forward (no plain attention), and an
    index over each retrieves the same top-5 ids for 8 queries."""
    import numpy as np
    import torch

    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.weights import load_safetensors_params
    from kaito_tpu_torch.models import get_model_by_name
    from kaito_tpu_torch.rag.embeddings import LocalTorchEmbedder
    from kaito_tpu_torch.rag.vector_store import VectorIndex

    t_leg = time.perf_counter()
    md = get_model_by_name("tiny-llama-real")
    tree = load_safetensors_params(
        TransformerLM(md.arch, dtype=torch.float32, device="cpu"),
        os.path.join(REPO, "checkpoints", "tiny-llama-real"))
    k2 = _counter("flash_prefill_attention")
    with _no_plain_prefill_attention():
        cpu = LocalTorchEmbedder(md.name, device="cpu", params=tree)
        card = LocalTorchEmbedder(md.name, device="cuda", params=tree)
        texts = (["", "naïve café — 東京 🚀", "x" * 400]
                 + _rag_docs(_RAG_EXACT_TEXTS - 3, seed=5))
        n0 = getattr(*k2)
        got, want = card.embed(texts), cpu.embed(texts)
        n_k2 = getattr(*k2) - n0
        err = float(np.abs(got - want).max())
        # a row of no token (no BOS): K2 sees no visible key there
        toks = torch.zeros((2, card.max_len), dtype=torch.int32)
        toks[1, :3] = torch.tensor([256, 72, 105])
        lens = torch.tensor([0, 3], dtype=torch.int32)
        with torch.inference_mode():
            z_card = card._forward(toks.cuda(), lens.cuda()).cpu()
            z_cpu = cpu._forward(toks, lens)
        err_empty = float((z_card - z_cpu).abs().max())
        if err > 1e-5 or err_empty > 1e-5 or not torch.isfinite(z_card).all() \
                or float(z_card[0].abs().max()) != 0.0:
            raise SmokeFailure(f"{label}: card against CPU {err:.2e}, no-token rows "
                               f"{err_empty:.2e} ({z_card[0, :4].tolist()})")
        if n_k2 != md.arch.num_layers:
            raise SmokeFailure(f"{label}: {n_k2} K2 launches for one forward")
        ids = []
        for emb in (card, cpu):
            ix = VectorIndex("exact", emb)
            ix.add_documents(texts)
            ids.append([[h["doc_id"] for h in ix.retrieve(q, top_k=5)]
                        for q in texts[3:11]])
        if ids[0] != ids[1]:
            raise SmokeFailure(f"{label}: top-5 ids differ between the card and the CPU")
    res = dict(max_abs_err=err, no_token_row_err=err_empty, k2_launches=n_k2,
               phase_s=time.perf_counter() - t_leg)
    log(f"{label}: {len(texts)} texts, card against CPU max |diff| {err:.2e} (atol "
        f"1e-5), no-token row {err_empty:.1e} (zero on both), K2 {n_k2} launches a "
        f"forward; 8 queries' top-5 ids equal; {res['phase_s']:.1f} s")
    return res

STARTUP_LEG = ("startup-int8", "phase 18, TinyLlama-1.1B from the operator's command "
               "line: config file, streamed weights, int8")
_TINYLLAMA = "TinyLlama/TinyLlama-1.1B-Chat-v1.0"
# what the port's operator must render for phase 18's Workspace
_STARTUP_COMMAND = ["python", "-m", "kaito_tpu_torch.engine.server", "--model", _TINYLLAMA,
                    "--port", "5000", "--max-model-len", "2048", "--quantization", "int8",
                    "--kaito-config-file", "/mnt/config/inference_config.yaml"]
# the ConfigMap's inference_config.yaml
_STARTUP_CONFIG = ("vllm:\n  max-num-seqs: 4\n  served-model-name: tinyllama-chat\n"
                   "  quantization: int8\n")
_STARTUP_COUNTED = ("paged_decode_attention", "flash_prefill_attention",
                    "flash_prefill_packed", "quant_matmul_int8", "quant_matmul_int8_wide")
_STARTUP_ABSENT = ("paged_decode_attention_int8kv", "quant_matmul_int4")


def _hf_checkpoint(model, path) -> int:
    """``model``'s parameters as a HF checkpoint (one
    ``model.safetensors``, HF names, [out, in] projections) written by
    the port's own ``write_safetensors``; its size in bytes."""
    from kaito_tpu_torch.engine.weights import _LAYER_MAP, write_safetensors

    tree = model.param_tree()
    V = model.arch.vocab_size
    sd = {"model.embed_tokens.weight": tree["embed"][:V],
          "model.norm.weight": tree["final_norm"], "lm_head.weight": tree["lm_head"][:V]}
    for g in model.groups:
        for key, t in tree[g.name].items():
            suffix, transpose = _LAYER_MAP[key]
            for j in range(g.count):
                sd[f"model.layers.{g.start + j}.{suffix}"] = t[j].t() if transpose else t[j]
    out = os.path.join(path, "model.safetensors")
    write_safetensors(out, {k: v.contiguous() for k, v in sd.items()})
    return os.path.getsize(out)


def _range_server(root):
    """A file server over ``root`` on 127.0.0.1 that answers ``Range``
    (206 with the span, read from disk), as a blob store does; the stdlib
    ``SimpleHTTPRequestHandler`` ignores it.  (server, base URL, log of
    (path, range))."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen = []

    class Ranges(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            path = os.path.join(root, self.path.lstrip("/"))
            rng = self.headers.get("Range")
            seen.append((self.path, rng))
            if not os.path.isfile(path):
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            size = os.path.getsize(path)
            start, end = 0, size
            if rng:
                a, _, b = rng.split("=", 1)[1].partition("-")
                start, end = int(a), min(int(b) + 1 if b else size, size)
            with open(path, "rb") as f:
                f.seek(start)
                body = f.read(end - start)
            self.send_response(206 if rng else 200)
            if rng:
                self.send_header("Content-Range", f"bytes {start}-{end - 1}/{size}")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Ranges)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}/", seen


class _StdoutTee:
    """Standard output passed through, its text kept."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed_chat(base, content, n) -> dict:
    """One streamed chat of ``n`` greedy tokens: TTFT (ms to the first
    event) and decode tokens/s after it."""
    t0 = time.perf_counter()
    ttft, events = _stream_ttft(base, "/v1/chat/completions", dict(
        messages=[{"role": "user", "content": content}], max_tokens=n,
        temperature=0.0, ignore_eos=True, stream=True,
        stream_options={"include_usage": True}))
    total_ms = (time.perf_counter() - t0) * 1e3
    usage = next((e["usage"] for e in reversed(events)
                  if e != "[DONE]" and e.get("usage")), {})
    if events[-1] != "[DONE]" or usage.get("completion_tokens") != n:
        raise SmokeFailure(f"streamed chat asked {n} tokens: usage {usage}, last "
                           f"event {events[-1]!r}")
    return dict(ttft_ms=ttft, total_ms=total_ms, prompt_tokens=usage["prompt_tokens"],
                tok_s=(n - 1) / ((total_ms - ttft) / 1e3))


def _chats_together(engine, base, prompts, n, label) -> tuple[list, int]:
    """One streamed chat of ``n`` greedy tokens a prompt, all admitted by
    ``engine`` in one scheduler step (a packed prefill: K3): the engine
    admits nothing new until each has been queued.  (Each chat's
    :func:`_timed_chat` reading, the packed prefill dispatches.)"""
    results, errors = {}, []

    def run(i):
        try:
            results[i] = _timed_chat(base, prompts[i], n)
        except Exception as e:   # reported below; the phase fails
            errors.append(repr(e))

    packs = engine.counters["prefill_packed_steps_total"]
    group = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    engine._admit_new = lambda: False     # admitted together
    try:
        for t in group:
            queued = engine.counters["requests_total"]
            t.start()
            deadline = time.monotonic() + 60
            while (engine.counters["requests_total"] == queued and t.is_alive()
                   and time.monotonic() < deadline):
                time.sleep(0.001)
    finally:
        del engine._admit_new
        engine._wake.set()
    for t in group:
        t.join(timeout=300)
    if errors or len(results) != len(prompts):
        raise SmokeFailure(f"{label}: concurrent chats failed: {errors}")
    return ([results[i] for i in range(len(prompts))],
            engine.counters["prefill_packed_steps_total"] - packs)


def render_startup_workspace(label) -> dict:
    """The port's operator on phase 18's Workspace: the catalog's
    TinyLlama on ``a3-highgpu-1g`` with ``kaito-tpu.io/quantization:
    int8`` and an ``inference.config`` ConfigMap, reconciled by the
    port's ``WorkspaceReconciler`` with its Karpenter provisioner over
    ``FakeCloud`` until ``InferenceReady``.  Checks the StatefulSet's
    engine container (:data:`_STARTUP_COMMAND`, ``nvidia.com/gpu: "1"``
    requested and limited, a node selector the fake node's labels
    satisfy) and returns its command, its env (the variables with a
    value) and the node's labels."""
    from kaito_tpu_torch.api import InferenceSpec, ObjectMeta, ResourceSpec, Workspace
    from kaito_tpu_torch.api.meta import condition_true
    from kaito_tpu_torch.controllers.runtime import Store
    from kaito_tpu_torch.controllers.workspace import WorkspaceReconciler
    from kaito_tpu_torch.provision import FakeCloud, KarpenterTPUProvisioner

    store = Store()
    cloud = FakeCloud(store)
    rec = WorkspaceReconciler(store, KarpenterTPUProvisioner(store))
    store.create(Workspace(
        ObjectMeta(name="tinyllama", annotations={"kaito-tpu.io/quantization": "int8"}),
        resource=ResourceSpec(instance_type="a3-highgpu-1g"),
        inference=InferenceSpec(preset=_TINYLLAMA, config="inference-config")))
    for _ in range(10):
        rec.reconcile_key("default", "tinyllama")
        cloud.tick()
        ws = store.get("Workspace", "default", "tinyllama")
        if condition_true(ws.status.conditions, "InferenceReady"):
            break
    else:
        raise SmokeFailure(f"{label}: the Workspace never became ready: "
                           f"{[(c.type, c.status, c.message) for c in ws.status.conditions]}")
    pod = store.get("StatefulSet", "default", "tinyllama").spec["template"]["spec"]
    c = pod["containers"][0]
    if c["command"] != _STARTUP_COMMAND:
        raise SmokeFailure(f"{label}: the operator rendered {c['command']}")
    one = {"nvidia.com/gpu": "1"}
    if c["resources"] != {"requests": one, "limits": one}:
        raise SmokeFailure(f"{label}: the operator asked for {c['resources']}")
    nodes = store.list("Node")
    if len(nodes) != 1 or any(nodes[0].metadata.labels.get(k) != v
                              for k, v in pod["nodeSelector"].items()):
        raise SmokeFailure(f"{label}: node selector {pod['nodeSelector']} against "
                           f"nodes {[n.metadata.labels for n in nodes]}")
    env = {e["name"]: e["value"] for e in c["env"] if "value" in e}
    log(f"{label}: the port's operator rendered {c['command']}, resources "
        f"{c['resources']}, env {env}, node selector {pod['nodeSelector']}")
    return dict(command=c["command"], env=env, node=dict(nodes[0].metadata.labels),
                resources=c["resources"], node_selector=dict(pod["nodeSelector"]))


def _serve_argv(command, port, conf, weights) -> list:
    """The rendered engine command's argv with the pod's port and config
    path mapped to this process's, and ``--weights-dir`` added."""
    argv = list(command[3:])
    argv[argv.index("--port") + 1] = str(port)
    argv[argv.index("--kaito-config-file") + 1] = conf
    return argv + ["--weights-dir", weights]


def run_startup_phase(label) -> tuple[dict, dict]:
    """Phase 18: the port's server started as the operator starts a pod
    of the catalog's ``TinyLlama/TinyLlama-1.1B-Chat-v1.0``, at full width
    (22 layers, hidden 2048, 32 heads over 4 KV heads of 64, intermediate
    5632), from the command line and env the port's operator renders
    (:func:`render_startup_workspace`: ``--model <id> --port 5000
    --max-model-len 2048 --quantization int8 --kaito-config-file
    /mnt/config/inference_config.yaml``), its port and config path
    mapped to this process's (the file: ``vllm:`` max-num-seqs 4, a
    served model name, ``quantization: int8``) and ``--weights-dir
    http://127.0.0.1:W/`` added, through ``start_server``, the first half
    of ``main``, with the container's env applied while it runs.  The weights: bf16 drawn on the card from
    seed 0, written under HF names in one file and served by a local
    range server.  While they stream and quantize, ``/health`` (polled
    every 20 ms) answers 503 ``loading``, ``/metrics`` carries
    ``kaito:engine_loading 1`` and a POST answers 503; then ``/health``
    200 and ``/v1/models`` the file's name.  The tree the engine streamed
    equals the disk loader's on the same file tensor by tensor and bit
    for bit, and no shard read was unranged.  Four streamed chats of 64
    greedy tokens: one alone (a 200-token prompt: K2 and the wide K4
    path), then three admitted together (a packed prefill: K3); ``/ui``
    answers the page and one chat goes through the standalone UI proxy.
    K1, K2, K3 and K4 (decode rows and wide path) are zeroed just before
    ``start_server`` and must each have launched; K1q and K5 must not.
    Returns (launches, statistics)."""
    import contextlib
    import shutil
    import tempfile

    import torch

    from kaito_tpu_torch.engine import streaming
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.server import start_server
    from kaito_tpu_torch.engine.weights import load_safetensors_params
    from kaito_tpu_torch.models.hub import install_default_fetcher
    from kaito_tpu_torch.models.registry import get_model_by_name
    from kaito_tpu_torch.ui import PAGE
    from kaito_tpu_torch.ui import make_server as make_ui_server

    t_leg = time.perf_counter()
    offline = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"      # the catalog answers; nothing is fetched
    root = tempfile.mkdtemp(prefix="kaito-tinyllama-")
    weights = server = engine = None
    stats: dict = {}
    real_stream = streaming.stream_safetensors_params
    try:
        install_default_fetcher()
        pod = render_startup_workspace(label)
        arch = get_model_by_name(_TINYLLAMA).arch
        widths = (arch.num_layers, arch.hidden_size, arch.num_heads, arch.num_kv_heads,
                  arch.head_dim, arch.intermediate_size, arch.vocab_size)
        if widths != (22, 2048, 32, 4, 64, 5632, 32000):
            raise SmokeFailure(f"{label}: {_TINYLLAMA} resolved to {widths}")
        src = TransformerLM(arch, dtype=torch.bfloat16, device="cuda")
        src.init_params(seed=0)
        t0 = time.perf_counter()
        stats["checkpoint_bytes"] = _hf_checkpoint(src, root)
        stats["checkpoint_write_s"] = time.perf_counter() - t0
        del src
        _release_card(torch)
        weights, wurl, seen = _range_server(root)
        conf = os.path.join(root, "inference_config.yaml")
        with open(conf, "w") as f:
            f.write(_STARTUP_CONFIG)
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        argv = _serve_argv(pod["command"], port, conf, wurl)
        log(f"{label}: {stats['checkpoint_bytes'] / 2**30:.2f} GiB checkpoint written "
            f"in {stats['checkpoint_write_s']:.1f}s; serving with {argv}")

        streamed: dict = {}

        def keep(model, location, reader=None):
            streamed["tree"] = real_stream(model, location, reader)
            return streamed["tree"]

        streaming.stream_safetensors_params = keep
        for name in (*_STARTUP_COUNTED, *_STARTUP_ABSENT):
            fn, attr = _counter(name)
            setattr(fn, attr, 0)
        built: dict = {}

        def build():
            try:
                built["server"], _ = start_server(argv)
            except Exception as e:   # reported below; the phase fails
                built["error"] = e

        tee = _StdoutTee(sys.stdout)
        loading = {"health_503": 0, "metrics_gauge": False, "post_503": False}
        t_load = time.perf_counter()
        saved_env = {k: os.environ.get(k) for k in pod["env"]}
        os.environ.update(pod["env"])
        try:
            with contextlib.redirect_stdout(tee):
                loader = threading.Thread(target=build)
                loader.start()
                while loader.is_alive():
                    try:
                        status, raw = _get(f"{base}/health")
                    except (urllib.error.URLError, ConnectionError, OSError):
                        status = None
                    if status == 503 and json.loads(raw)["status"] == "loading":
                        loading["health_503"] += 1
                        if not loading["metrics_gauge"]:
                            _, m = _get(f"{base}/metrics")
                            loading["metrics_gauge"] = b"kaito:engine_loading 1\n" in m
                            try:
                                _post(f"{base}/v1/completions", {"prompt": "x",
                                                                 "max_tokens": 1})
                            except urllib.error.HTTPError as e:
                                loading["post_503"] = e.code == 503
                    time.sleep(0.02)
                loader.join()
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        stats["load_s"] = time.perf_counter() - t_load
        streaming.stream_safetensors_params = real_stream
        if "error" in built:
            raise SmokeFailure(f"{label}: start_server failed: {built['error']!r}")
        server = built["server"]
        engine = server.state.engine
        threading.Thread(target=server.serve_forever, daemon=True).start()
        stats["loading"] = loading
        if not (loading["health_503"] and loading["metrics_gauge"] and loading["post_503"]):
            raise SmokeFailure(f"{label}: the loading stub was not seen: {loading}")
        line = next((ln for ln in "".join(tee.text).splitlines()
                     if ln.startswith("KAITO_WEIGHTS_STREAM_RESULT ")), None)
        if line is None:
            raise SmokeFailure(f"{label}: no KAITO_WEIGHTS_STREAM_RESULT line")
        stats["stream"] = json.loads(line.split(" ", 1)[1])
        unranged = [p for p, r in seen if p.endswith(".safetensors") and r is None]
        if unranged:
            raise SmokeFailure(f"{label}: whole-shard reads {unranged}")
        status, raw = _get(f"{base}/health")
        if status != 200 or json.loads(raw)["status"] != "ok":
            raise SmokeFailure(f"{label}: /health after the load {status} {raw!r}")
        status, raw = _get(f"{base}/v1/models")
        if json.loads(raw)["data"][0]["id"] != "tinyllama-chat":
            raise SmokeFailure(f"{label}: /v1/models {raw!r}")
        cfg = engine.cfg
        if (cfg.max_num_seqs, cfg.quantization, cfg.max_model_len,
                cfg.tensor_parallel) != (4, "int8", 2048, 1):
            raise SmokeFailure(f"{label}: the config file did not take: {cfg}")
        stats.update(rendered=pod, param_bytes=engine.model.param_bytes(),
                     sizing=dict(engine.sizing_report),
                     engine_cfg=dict(model=_TINYLLAMA, layers=None,
                                     quantization=cfg.quantization,
                                     kv_dtype=cfg.kv_dtype, page_size=cfg.page_size))
        log(f"{label}: loaded in {stats['load_s']:.1f}s ({loading['health_503']} "
            f"loading answers); stream {stats['stream']}; "
            f"{engine.model.param_bytes() / 2**30:.2f} GiB int8 weights, "
            f"{engine.sizing_report}")

        disk = load_safetensors_params(engine.model, root)
        got = streamed.pop("tree")
        n_tensors = 0
        for key, want in disk.items():
            pairs = (want.items() if isinstance(want, dict) else [("", want)])
            for sub, w in pairs:
                g = got[key][sub] if sub else got[key]
                if g.dtype != w.dtype or not torch.equal(g, w):
                    raise SmokeFailure(f"{label}: streamed {key}.{sub} differs from "
                                       f"the disk loader's")
                n_tensors += 1
        if set(got) != set(disk):
            raise SmokeFailure(f"{label}: streamed tree keys {sorted(got)} != "
                               f"{sorted(disk)}")
        del disk, got
        stats["tree_tensors_equal"] = n_tensors

        stats["alone"] = _timed_chat(base, _prompt(170, 40), 64)
        stats["together"], stats["packed_prefill_dispatches"] = _chats_together(
            engine, base, [_prompt(90 + 10 * i, 41 + i) for i in range(3)], 64, label)

        status, page = _get(f"{base}/ui")
        if status != 200 or page != PAGE.encode():
            raise SmokeFailure(f"{label}: /ui answered {status}")
        proxy = make_ui_server(base, host="127.0.0.1", port=0)
        threading.Thread(target=proxy.serve_forever, daemon=True).start()
        try:
            _, raw = _post(f"http://127.0.0.1:{proxy.server_address[1]}"
                           "/v1/chat/completions", dict(
                               messages=[{"role": "user", "content": "hello"}],
                               max_tokens=8, temperature=0.0, ignore_eos=True))
        finally:
            proxy.shutdown()
            proxy.server_close()
        if json.loads(raw)["usage"]["completion_tokens"] != 8:
            raise SmokeFailure(f"{label}: the UI proxy relayed {raw[:200]!r}")
        torch.cuda.synchronize()
        launches = {name: getattr(*_counter(name)) for name in _STARTUP_COUNTED}
        stray = {name: getattr(*_counter(name)) for name in _STARTUP_ABSENT}
        if any(stray.values()):
            raise SmokeFailure(f"{label}: kernels of another path launched: {stray}")
        log(f"{label}: launches {launches}; packed prefill dispatches "
            f"{stats['packed_prefill_dispatches']}")
    finally:
        streaming.stream_safetensors_params = real_stream
        if offline is None:
            os.environ.pop("HF_HUB_OFFLINE", None)
        else:
            os.environ["HF_HUB_OFFLINE"] = offline
        if server is not None:
            server.shutdown()
            server.server_close()
            engine.stop()
        if weights is not None:
            weights.shutdown()
            weights.server_close()
        shutil.rmtree(root, ignore_errors=True)
    del server, engine
    _release_card(torch)
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats


SKU_LABEL = "phase 19, the SKU catalog and the estimator against the card"


def run_sku_phase(torch, legs, label, whole) -> dict:
    """Phase 19 (no model of its own): the card's identity through the
    catalog's BYO lookup, and the estimator's GPU half against the
    engines phases 4, 5 and 18 sized (``legs``: their statistics, each
    with its ``sizing`` report, ``param_bytes`` and ``engine_cfg``; in a
    whole run all four must be there).  Returns the readings."""
    from kaito_tpu_torch.estimator.estimator import (
        CUDA_CONTEXT_BYTES, engine_weight_bytes, gpu_page_bytes, max_kv_tokens)
    from kaito_tpu_torch.sku.catalog import (
        LABEL_GPU_COUNT, LABEL_GPU_MEMORY, LABEL_GPU_PRODUCT,
        get_gpu_config_from_node_labels, machine_chip)

    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    labels = {LABEL_GPU_PRODUCT: torch.cuda.get_device_name(0).replace(" ", "-"),
              LABEL_GPU_MEMORY: str(props.total_memory // 2**20),
              LABEL_GPU_COUNT: str(torch.cuda.device_count())}
    spec = get_gpu_config_from_node_labels(labels)
    if spec is None or spec.chip.generation != "h100-80gb":
        raise SmokeFailure(f"{label}: labels {labels} resolved to {spec}")
    rel = abs(spec.chip.hbm_bytes - props.total_memory) / props.total_memory
    if rel > 0.01:
        raise SmokeFailure(f"{label}: the entry's {spec.chip.hbm_bytes} bytes against "
                           f"the card's {props.total_memory}")
    out = dict(labels=labels, entry=spec.chip.generation, entry_bytes=spec.chip.hbm_bytes,
               card_bytes=props.total_memory, memory_rel_diff=rel,
               context_bytes=CONTEXT_BYTES, estimator_context_bytes=CUDA_CONTEXT_BYTES,
               legs={})
    log(f"{label}: {labels} -> {spec.chip.generation} ({spec.chip.hbm_bytes} bytes, the "
        f"card {props.total_memory}: {rel:.2e} apart); CUDA context at the start "
        f"{CONTEXT_BYTES} bytes, the estimator's {CUDA_CONTEXT_BYTES}")
    card = machine_chip("a3-highgpu-1g")
    for leg in (LEGS[0][1], LEGS[1][1], LEGS[2][1], STARTUP_LEG[1]):
        s = legs.get(leg)
        if s is None:
            if whole:
                raise SmokeFailure(f"{label}: no sizing from {leg}")
            continue
        ec, rep = s["engine_cfg"], s["sizing"]
        if rep.get("source") != "measured":
            raise SmokeFailure(f"{label}: {leg} sized its pool by {rep}")
        md = cut_metadata(ec["model"], ec["layers"])
        quant = ec["quantization"] or ""
        el = 1 if ec["kv_dtype"] == "int8" else 2
        est_w = engine_weight_bytes(md, quant)
        page = gpu_page_bytes(md, el, ec["page_size"])
        room = max(rep["free_after_weights_bytes"] - rep["reserve_bytes"], 0)
        measured = room // page * ec["page_size"]
        est = max_kv_tokens(md, card, 1, kv_dtype_bytes=el, quantization=quant)
        row = dict(param_bytes=s["param_bytes"], estimated_weight_bytes=est_w,
                   weight_ratio=est_w / s["param_bytes"], measured_kv_tokens=measured,
                   estimated_kv_tokens=est, kv_ratio=est / measured if measured else None,
                   device_total_bytes=rep["device_total_bytes"],
                   non_weight_bytes_at_sizing=rep["device_total_bytes"]
                   - rep["free_after_weights_bytes"] - s["param_bytes"])
        out["legs"][leg] = row
        log(f"{label}: {leg}: weights {est_w} estimated, {s['param_bytes']} held "
            f"(x{row['weight_ratio']:.4f}); KV tokens {est} estimated for one card, "
            f"{measured} in the measured free memory (x{row['kv_ratio']:.4f}); "
            f"{row['non_weight_bytes_at_sizing']} bytes neither free nor weights at "
            f"sizing")
        if est_w < s["param_bytes"]:
            raise SmokeFailure(f"{label}: {leg}: the estimator counts {est_w} weight "
                               f"bytes, the engine holds {s['param_bytes']}")
        if est > measured:
            raise SmokeFailure(f"{label}: {leg}: the estimator promises {est} KV tokens, "
                               f"the measured free memory holds {measured}")
    out["phase_s"] = time.perf_counter() - t0
    return out


MANAGER_LEG = ("manager-int8", "phase 20, the operator's manager scaling a served "
               "TinyLlama InferenceSet: fleet telemetry and the autoscaler, int8")
# phase 20's short clocks, set on its own objects (the defaults: sustain
# 30 s, scrapes every 10 s, stabilization 30 s, cooldown 60 s).  The
# engines' SLO burn rolls over a fixed 300 s window, so on this timescale
# the first chat's capture would hold the burn watermark: it is set out of
# reach, as the JAX closed-loop test sets it.
_MANAGER_FLEET = dict(sustain_s=3.0, min_samples=2, burn_hi=1e9, burn_lo=1e9)
_MANAGER_INTERVAL_S = 1.0
_MANAGER_AUTOSCALE = dict(enabled=True, min_replicas=1, max_replicas=2, warm_pool=0,
                          scale_up_stabilization_s=2.0, scale_up_cooldown_s=2.0)
_MANAGER_GATES = "enableInferenceSetController=true,autoscaler=true"
_MANAGER_BURST = 24          # concurrent 64-token chats, against max-num-seqs 4
_MANAGER_CONTROLLERS = ("WorkspaceReconciler", "InferenceSetReconciler",
                        "RAGEngineReconciler", "DriftReconciler", "AutoscalerController")
# the fleet's folded samples held against the server's own /metrics at idle
_FLEET_HELD = ("active_slots", "slots_total", "waiting", "kv_usage", "occupancy",
               "requests_total", "gen_tokens_total")
# threads the manager, its fleet plane and a KubeStore start
_MANAGER_THREADS = ("fleet-telemetry", "fleet-scrape", "manager-metrics", "watch-")


@contextlib.contextmanager
def _loopback_only():
    """Name lookups of anything but the loopback refused while the phase
    runs: the second replica's Service name (``tinyllama-1``), which the
    fleet scrapes, is not served, and no lookup may leave the machine.
    Yields the names refused."""
    import socket

    real, refused = socket.getaddrinfo, []

    def guard(host, *a, **kw):
        if host not in ("127.0.0.1", "localhost", "::1"):
            refused.append(host)
            raise socket.gaierror(socket.EAI_NONAME, f"{host}: not resolved here")
        return real(host, *a, **kw)

    socket.getaddrinfo = guard
    try:
        yield refused
    finally:
        socket.getaddrinfo = real


def _pod_of(store, name) -> dict:
    """The engine container, node selector and tolerations of a child
    Workspace's StatefulSet, its name written as ``<set>``."""
    pod = store.get("StatefulSet", "default", name).spec["template"]["spec"]
    return json.loads(json.dumps(dict(
        container=pod["containers"][0], node_selector=pod["nodeSelector"],
        tolerations=pod.get("tolerations"))).replace(name, "<set>"))


def _check_epp_gate(label) -> dict:
    """Host only: a GPU InferenceSet under the Gateway API gate, in a
    manager of its own, renders its InferencePool and the port's picker
    (``kaito_tpu_torch.runtime.epp`` from the GPU image, one
    ``--backend`` for its replica) and no ``EPPUnavailable``."""
    from kaito_tpu_torch.api import (InferenceSet, InferenceSetSpec, InferenceSpec,
                                     ObjectMeta, ResourceSpec)
    from kaito_tpu_torch.api.inferenceset import WorkspaceTemplate
    from kaito_tpu_torch.controllers.manager import Manager
    from kaito_tpu_torch.controllers.runtime import Store
    from kaito_tpu_torch.sku.catalog import GPU_IMAGE

    store = Store()
    mgr = Manager(store=store, feature_gates=_SERVICES_GATES)
    store.create(InferenceSet(ObjectMeta(name="gw"), InferenceSetSpec(
        replicas=1, template=WorkspaceTemplate(
            resource=ResourceSpec(instance_type="a3-highgpu-1g"),
            inference=InferenceSpec(preset=_TINYLLAMA)))))
    mgr.resync()
    live = store.get("InferenceSet", "default", "gw")
    cond = next(c for c in live.status.conditions if c.type == "InferenceSetReady")
    pool = store.try_get("InferencePool", "default", "gw-pool")
    dep = store.try_get("Deployment", "default", "gw-epp")
    c = dep.spec["template"]["spec"]["containers"][0] if dep is not None else {}
    if (cond.reason == "EPPUnavailable" or pool is None
            or pool.spec["extensionRef"]["name"] != "gw-epp"
            or c.get("command", [])[:3] != _EPP_MODULE or c.get("image") != GPU_IMAGE
            or c["command"].count("--backend") != 1):
        raise SmokeFailure(f"{label}: a GPU set under the Gateway API gate: {cond}; "
                           f"pool {pool and pool.spec}; picker {c}")
    log(f"{label}: a GPU InferenceSet under gatewayAPIInferenceExtension: {cond.reason}; "
        f"its pool names gw-epp, which runs {c['command']} from {c['image']}")
    return dict(reason=cond.reason, command=c["command"], image=c["image"])


def _create_rag(store, iset_name) -> None:
    """Host only: a RAGEngine on ``a3-highgpu-1g`` with a local embedder
    (the served model's id) whose LLM is the set's first replica's
    Service, for the phase's manager to reconcile."""
    from kaito_tpu_torch.api import ObjectMeta, RAGEngine, RAGEngineSpec, ResourceSpec
    from kaito_tpu_torch.api.ragengine import (EmbeddingSpec, InferenceServiceSpec,
                                               LocalEmbedding)

    svc = store.get("Service", "default", f"{iset_name}-0")
    store.create(RAGEngine(ObjectMeta(name="rag"), RAGEngineSpec(
        compute=ResourceSpec(instance_type="a3-highgpu-1g"),
        embedding=EmbeddingSpec(local=LocalEmbedding(model_id=_TINYLLAMA)),
        inference_service=InferenceServiceSpec(
            url=f"http://{svc.metadata.name}:{svc.spec['ports'][0]['port']}"))))


def _check_rag(label, store) -> dict:
    """The RAGEngine :func:`_create_rag` made, as the phase's manager
    rendered it: the port's RAG app on one ``nvidia.com/gpu``, its env
    read by the port's ``RAGConfig.from_env`` into the Service's URL and
    the embedder's id."""
    from kaito_tpu_torch.rag.config import RAGConfig

    c = store.get("Deployment", "default", "rag").spec["template"]["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in c["env"]}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = RAGConfig.from_env()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    llm = store.get("RAGEngine", "default", "rag").spec.inference_service.url
    one = {"nvidia.com/gpu": "1"}
    if (c["command"][:3] != ["python", "-m", "kaito_tpu_torch.rag.app"]
            or c["resources"] != {"requests": one, "limits": one}
            or cfg.llm_inference_url != llm or cfg.embedding_model_id != _TINYLLAMA):
        raise SmokeFailure(f"{label}: the RAGEngine rendered {c['command']}, "
                           f"{c['resources']}, env {env}")
    log(f"{label}: the RAGEngine on a3-highgpu-1g runs {c['command']} on "
        f"{c['resources']['limits']}; its env reads into LLM URL {cfg.llm_inference_url}, "
        f"embedder {cfg.embedding_model_id}")
    return dict(command=c["command"], resources=c["resources"], llm=cfg.llm_inference_url)


def run_manager_phase(label) -> tuple[dict, dict]:
    """Phase 20: the port's operator closes its loop on the card.  The
    port's ``Manager`` (gates :data:`_MANAGER_GATES`) over the in-memory
    store, with the Karpenter provisioner over ``FakeCloud`` (nodes only:
    no fake kubelet), its metrics server on 127.0.0.1:0, its fleet plane
    scraping every :data:`_MANAGER_INTERVAL_S` s under
    :data:`_MANAGER_FLEET`.  An InferenceSet of the catalog's TinyLlama
    on ``a3-highgpu-1g`` (int8 by annotation, phase 18's config map), one
    replica, autoscaling 1-2 (:data:`_MANAGER_AUTOSCALE`).  Resynced until
    the child Workspace's StatefulSet is rendered; its engine container
    (command, env, resources) and node selector must equal phase 18's
    Workspace's, names apart.  The phase serves that pod as phase 18 does
    (weights written and streamed again), sets the fleet's scrape-URL
    annotation on the child to the server, and marks the StatefulSet
    ready once ``/health`` (the rendered readiness probe) answers 200.
    One 64-token chat alone (K2; the windows captured), then idle: two
    scrapes or more, the signal nominal, ``spec.replicas`` 1, and the
    fleet's folded :data:`_FLEET_HELD` equal to the server's own
    ``/metrics``.  Then :data:`_MANAGER_BURST` clients chat 64 tokens in
    a loop until the second child's StatefulSet is rendered: the signal
    must leave nominal within ``sustain_s + 4 * interval`` of the burst,
    the autoscaler take ``spec.replicas`` to 2, and the second child's pod
    equal the first's, names apart (it is not served).  After it: every
    enabled controller counted ``result="ok"`` reconciles on the
    manager's ``/metrics`` and none ``"error"``, the fleet's gauges are in
    that exposition, K1-K4 launched and K1q/K5 did not; the host-only
    checks of :func:`_check_epp_gate` and :func:`_check_rag`.  Every thread
    and server the phase starts is stopped.  Returns (launches,
    statistics)."""
    import shutil
    import tempfile

    import torch

    from kaito_tpu_torch.api import (InferenceSet, InferenceSetSpec, InferenceSpec,
                                     ObjectMeta, ResourceSpec)
    from kaito_tpu_torch.api.inferenceset import AutoscalePolicy, WorkspaceTemplate
    from kaito_tpu_torch.controllers.manager import Manager
    from kaito_tpu_torch.controllers.metrics import start_manager_server
    from kaito_tpu_torch.controllers.runtime import Store, update_with_retry
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.server import start_server
    from kaito_tpu_torch.models.hub import install_default_fetcher
    from kaito_tpu_torch.models.registry import get_model_by_name
    from kaito_tpu_torch.provision import FakeCloud
    from kaito_tpu_torch.runtime.fleet import (ANNOTATION_SCRAPE_URL, FleetPolicy,
                                               parse_replica_metrics)
    from kaito_tpu_torch.utils.promtext import parse_exposition, parse_labels

    t_leg = time.perf_counter()
    offline = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="kaito-manager-")
    name, key = "tinyllama", ("InferenceSet", "default", "tinyllama")
    stats: dict = dict(policy=dict(fleet=dict(_MANAGER_FLEET, interval_s=_MANAGER_INTERVAL_S),
                                   autoscale=_MANAGER_AUTOSCALE, gates=_MANAGER_GATES,
                                   burst=_MANAGER_BURST))
    mgr = msrv = server = engine = weights = None
    stop_burst = threading.Event()
    clients: list = []
    with _loopback_only() as refused:
        try:
            install_default_fetcher()
            stats["epp_gate"] = _check_epp_gate(label)
            want = render_startup_workspace(label)
            store = Store()
            cloud = FakeCloud(store, kubelet=False)
            mgr = Manager(store=store, feature_gates=_MANAGER_GATES)
            mgr.fleet.policy = FleetPolicy(**_MANAGER_FLEET)
            mgr.fleet.interval_s = _MANAGER_INTERVAL_S
            msrv = start_manager_server(mgr.metrics, host="127.0.0.1", port=0,
                                        fleet=mgr.fleet)
            murl = f"http://127.0.0.1:{msrv.server_address[1]}"
            log(f"{label}: gates {_MANAGER_GATES}; fleet {mgr.fleet.policy.to_dict()}, "
                f"interval {mgr.fleet.interval_s} s, freshness {mgr.fleet.freshness_s} s; "
                f"autoscale {_MANAGER_AUTOSCALE}; manager on {murl}")
            store.create(InferenceSet(ObjectMeta(name=name), InferenceSetSpec(
                replicas=1, autoscale=AutoscalePolicy(**_MANAGER_AUTOSCALE),
                template=WorkspaceTemplate(
                    resource=ResourceSpec(instance_type="a3-highgpu-1g"),
                    inference=InferenceSpec(preset=_TINYLLAMA, config="inference-config"),
                    annotations={"kaito-tpu.io/quantization": "int8"}))))
            served = {"url": None, "ready": False}

            def turn():
                """One control-plane turn: resync, the cloud's nodes, and
                the kubelet's part for the served replica."""
                mgr.resync()
                cloud.tick()
                if served["url"] and not served["ready"]:
                    ss = store.get("StatefulSet", "default", f"{name}-0")
                    probe = ss.spec["template"]["spec"]["containers"][0][
                        "readinessProbe"]["httpGet"]["path"]
                    if _get(served["url"] + probe)[0] == 200:
                        def ready(o):
                            o.status["readyReplicas"] = 1
                        update_with_retry(store, "StatefulSet", "default", f"{name}-0",
                                          ready)
                        served["ready"] = True

            for _ in range(12):
                turn()
                if store.try_get("StatefulSet", "default", f"{name}-0") is not None:
                    break
            else:
                raise SmokeFailure(f"{label}: no StatefulSet for {name}-0")
            first = _pod_of(store, f"{name}-0")
            c = first["container"]
            env = {e["name"]: e["value"] for e in c["env"] if "value" in e}
            phase18 = json.loads(json.dumps(want).replace("tinyllama", "<set>"))
            if (c["command"] != phase18["command"] or env != phase18["env"]
                    or c["resources"] != phase18["resources"]
                    or first["node_selector"] != phase18["node_selector"]):
                raise SmokeFailure(f"{label}: the set's child renders {c['command']}, "
                                   f"{env}, {c['resources']}, {first['node_selector']}; "
                                   f"phase 18's Workspace {phase18}")
            log(f"{label}: {name}-0 renders phase 18's pod, names apart: {c['command']}")

            arch = get_model_by_name(_TINYLLAMA).arch
            src = TransformerLM(arch, dtype=torch.bfloat16, device="cuda")
            src.init_params(seed=0)
            t0 = time.perf_counter()
            stats["checkpoint_bytes"] = _hf_checkpoint(src, root)
            stats["checkpoint_write_s"] = time.perf_counter() - t0
            del src
            _release_card(torch)
            weights, wurl, _ = _range_server(root)
            conf = os.path.join(root, "inference_config.yaml")
            with open(conf, "w") as f:
                f.write(_STARTUP_CONFIG)
            port = _free_port()
            base = f"http://127.0.0.1:{port}"
            for kname in (*_STARTUP_COUNTED, *_STARTUP_ABSENT):
                fn, attr = _counter(kname)
                setattr(fn, attr, 0)
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            t0 = time.perf_counter()
            try:
                server, _ = start_server(_serve_argv(c["command"], port, conf, wurl))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            stats["load_s"] = time.perf_counter() - t0
            engine = server.state.engine
            threading.Thread(target=server.serve_forever, daemon=True,
                             name="phase20-replica").start()

            def annotate(o):
                o.metadata.annotations[ANNOTATION_SCRAPE_URL] = base
            update_with_retry(store, "Workspace", "default", f"{name}-0", annotate)
            served["url"] = base
            _create_rag(store, name)
            mgr.fleet.start()
            deadline = time.monotonic() + 30
            while store.get("InferenceSet", "default", name).status.ready_replicas < 1:
                if time.monotonic() > deadline:
                    raise SmokeFailure(f"{label}: the set never counted its replica ready")
                turn()
                time.sleep(0.1)
            # the RAGEngine's Deployment marked ready as the fake kubelet
            # marks one: no RAG pod runs in this phase
            def rag_ready(o):
                o.status["readyReplicas"] = 1
            update_with_retry(store, "Deployment", "default", "rag", rag_ready)
            log(f"{label}: served {name}-0 at {base} (checkpoint written in "
                f"{stats['checkpoint_write_s']:.1f} s, loaded in {stats['load_s']:.1f} s); "
                f"StatefulSet ready after /health answered")

            stats["alone"] = _timed_chat(base, _prompt(170, 40), 64)
            log(f"{label}: one chat alone: {stats['alone']}")

            def fleet_sample():
                """The fleet's last sample of the served replica, and its age."""
                snap = mgr.fleet.snapshot()["fleet"].get("InferenceSet/default/" + name)
                rep = (snap or {}).get("replicas", {}).get(f"{name}-0") or {}
                return rep.get("values", {}), rep.get("age_s")

            def direct():
                return parse_replica_metrics(_get(base + "/metrics")[1].decode())

            uptimes, held = set(), None
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                turn()
                vals, _ = fleet_sample()
                if "uptime_s" in vals:
                    uptimes.add(vals["uptime_s"])
                sig = mgr.fleet.signal(key)
                if len(uptimes) >= 3 and sig is not None:
                    d = direct()
                    vals, _ = fleet_sample()
                    pair = {k: (vals.get(k), d.get(k)) for k in _FLEET_HELD}
                    if all(a == b for a, b in pair.values()):
                        held = pair
                        break
                time.sleep(0.25)
            sig = mgr.fleet.signal(key)
            live = store.get("InferenceSet", "default", name)
            stats["idle"] = dict(scrapes=len(uptimes), held=held,
                                 state=sig[0] if sig else None,
                                 replicas=live.spec.replicas)
            if held is None or sig is None or sig[0] != "nominal" or live.spec.replicas != 1:
                raise SmokeFailure(f"{label}: idle: {stats['idle']}, fleet "
                                   f"{fleet_sample()[0]}, direct {direct()}")
            log(f"{label}: idle after {len(uptimes)} scrapes: signal {sig[0]}, "
                f"spec.replicas 1; fleet against /metrics (fleet, direct): {held}")

            failures = []

            def client(i):
                n = 0
                while not stop_burst.is_set():
                    try:
                        _timed_chat(base, _prompt(90 + 10 * (i % 8), 1000 + 97 * i + n), 64)
                    except Exception as e:   # counted; the phase fails on any
                        failures.append(repr(e))
                        return
                    n += 1

            transitions = [(0.0, sig[0])]
            samples = []
            marks: dict = {}
            t_burst = time.perf_counter()
            clients[:] = [threading.Thread(target=client, args=(i,), name=f"phase20-{i}")
                          for i in range(_MANAGER_BURST)]
            for t in clients:
                t.start()
            last_log = -1.0
            while True:
                now = time.perf_counter() - t_burst
                if now > 60:
                    raise SmokeFailure(f"{label}: no second replica 60 s into the burst: "
                                       f"transitions {transitions}, marks {marks}")
                turn()
                sig = mgr.fleet.signal(key)
                if sig is not None and sig[0] != transitions[-1][1]:
                    transitions.append((now, sig[0]))
                    log(f"{label}: +{now:.2f} s signal {sig[0]} ({sig[2].reason}: "
                        f"{sig[2].message}; recommended {sig[2].recommended_replicas})")
                live = store.get("InferenceSet", "default", name)
                if live.spec.replicas >= 2 and "replicas_2" not in marks:
                    marks["replicas_2"] = now
                    log(f"{label}: +{now:.2f} s spec.replicas {live.spec.replicas}")
                if store.try_get("Workspace", "default", f"{name}-1") is not None:
                    marks.setdefault("child_1", now)
                if store.try_get("StatefulSet", "default", f"{name}-1") is not None:
                    marks["child_1_rendered"] = now
                    break
                if now - last_log >= 1.0:
                    last_log = now
                    vals, age = fleet_sample()
                    d = direct()
                    row = dict(t=round(now, 2), age_s=age, state=sig[0] if sig else None,
                               fleet={k: vals.get(k) for k in _FLEET_HELD[:5]},
                               direct={k: d.get(k) for k in _FLEET_HELD[:5]})
                    samples.append(row)
                    log(f"{label}: {row}")
                time.sleep(0.25)
            stop_burst.set()
            for t in clients:
                t.join(timeout=120)
            if failures or any(t.is_alive() for t in clients):
                raise SmokeFailure(f"{label}: burst chats failed: {failures[:3]}")
            stats.update(transitions=transitions, samples=samples, marks=marks)
            left = next((t for t, st in transitions if st != "nominal"), None)
            window = _MANAGER_FLEET["sustain_s"] + 4 * _MANAGER_INTERVAL_S
            if left is None or left > window:
                raise SmokeFailure(f"{label}: the signal left nominal at {left} s, "
                                   f"window {window} s: {transitions}")
            second = _pod_of(store, f"{name}-1")
            first = _pod_of(store, f"{name}-0")
            if second != first:
                raise SmokeFailure(f"{label}: {name}-1 renders {second}, {name}-0 {first}")
            log(f"{label}: burst of {_MANAGER_BURST}: signal left nominal at +{left:.2f} s "
                f"(window {window} s), spec.replicas 2 at +{marks['replicas_2']:.2f} s, "
                f"{name}-1 rendered at +{marks['child_1_rendered']:.2f} s, its pod equal "
                f"to {name}-0's, names apart")

            turn()
            stats["rag"] = _check_rag(label, store)
            text = _get(murl + "/metrics")[1].decode()
            counts: dict = {}
            for mname, lab, v in parse_exposition(text):
                if mname == "kaito:controller_reconcile_total":
                    lb = parse_labels(lab)
                    counts.setdefault(lb["controller"], {})[lb["result"]] = v
            stats["reconciles"] = counts
            missing = [ctl for ctl in _MANAGER_CONTROLLERS
                       if counts.get(ctl, {}).get("ok", 0) <= 0]
            errors = {ctl: r["error"] for ctl, r in counts.items() if r.get("error")}
            gauges = {mname for mname, lab, _ in parse_exposition(text)
                      if mname.startswith("kaito:fleet_") and f'name="{name}"' in lab}
            stats["fleet_gauges"] = sorted(gauges)
            if missing or errors or not {"kaito:fleet_signal_state",
                                         "kaito:fleet_queue_depth",
                                         "kaito:fleet_replicas_reporting"} <= gauges:
                raise SmokeFailure(f"{label}: reconciles {counts}, fleet gauges "
                                   f"{sorted(gauges)}")
            log(f"{label}: reconciles by controller and result {counts}; "
                f"{len(gauges)} kaito:fleet_* families for the set")
            torch.cuda.synchronize()
            launches = {k: getattr(*_counter(k)) for k in _STARTUP_COUNTED}
            stray = {k: getattr(*_counter(k)) for k in _STARTUP_ABSENT}
            if any(stray.values()) or not all(launches.values()):
                raise SmokeFailure(f"{label}: launches {launches}, absent {stray}")
            log(f"{label}: launches {launches}; {stray} (none); names the fleet could "
                f"not resolve: {sorted(set(refused))}")
            stats["unresolved"] = sorted(set(refused))
        finally:
            stop_burst.set()
            for t in clients:
                t.join(timeout=120)
            if offline is None:
                os.environ.pop("HF_HUB_OFFLINE", None)
            else:
                os.environ["HF_HUB_OFFLINE"] = offline
            if mgr is not None:
                mgr.fleet.stop()
            if msrv is not None:
                msrv.shutdown()
                msrv.server_close()
            if server is not None:
                server.shutdown()
                server.server_close()
                engine.stop()
            if weights is not None:
                weights.shutdown()
                weights.server_close()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and any(
                    t.name.startswith(_MANAGER_THREADS) for t in threading.enumerate()):
                time.sleep(0.05)
            shutil.rmtree(root, ignore_errors=True)
    left = sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(_MANAGER_THREADS + ("phase20-",)))
    if left:
        raise SmokeFailure(f"{label}: threads left running: {left}")
    del server, engine, mgr
    _release_card(torch)
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats


SERVICES_LEG = ("services-int8", "phase 21, the runtime services: two TinyLlama replicas "
                "behind the port's picker and round-robin front, failover, the health and "
                "benchmark probes, the HF fallback on the card")
_SERVICES_GATES = "enableInferenceSetController=true,gatewayAPIInferenceExtension=true"
_EPP_MODULE = ["python", "-m", "kaito_tpu_torch.runtime.epp"]
_SERVICES_PAGES = 512        # each replica's --max-pages (64-token pages): both on one card
# affinity traffic: sessions of a system prefix of their own and turns of
# greedy tokens; a prefix spans six 256-char picker blocks (page 64 x 4)
_SESSIONS, _TURNS, _TURN_TOKENS, _SYSTEM_CHARS = 8, 4, 32, 1536
_FAILOVER_REQUESTS = 8
_GPT2 = "openai-community/gpt2"
_GPT2_WIDTHS = (12, 768, 12, 50257)   # GPT2Config()'s n_layer, n_embd, n_head, vocab
_FALLBACK_ATOL = 1e-3


def render_services_set(label) -> dict:
    """Host only: the port's manager (gates :data:`_SERVICES_GATES`) over
    ``FakeCloud`` on phase 18's TinyLlama as an InferenceSet of two
    replicas on ``a3-highgpu-1g`` (int8, phase 18's config map).  Each
    child's engine container must run :data:`_STARTUP_COMMAND` on one
    ``nvidia.com/gpu`` with the port's benchmark probe as its startup
    probe; the pool's ``extensionRef`` names a Deployment running the
    port's picker from the GPU image over the two replicas' Services,
    and no ``EPPUnavailable`` is recorded.  Returns the child's command
    and env and the picker's command."""
    from kaito_tpu_torch.api import (InferenceSet, InferenceSetSpec, InferenceSpec,
                                     ObjectMeta, ResourceSpec)
    from kaito_tpu_torch.api.inferenceset import WorkspaceTemplate
    from kaito_tpu_torch.controllers.manager import Manager
    from kaito_tpu_torch.controllers.runtime import Store
    from kaito_tpu_torch.provision import FakeCloud
    from kaito_tpu_torch.sku.catalog import GPU_IMAGE

    store = Store()
    mgr = Manager(store=store, feature_gates=_SERVICES_GATES)
    cloud = FakeCloud(store)
    store.create(InferenceSet(ObjectMeta(name="tinyllama"), InferenceSetSpec(
        replicas=2, template=WorkspaceTemplate(
            resource=ResourceSpec(instance_type="a3-highgpu-1g"),
            inference=InferenceSpec(preset=_TINYLLAMA, config="inference-config"),
            annotations={"kaito-tpu.io/quantization": "int8"}))))
    names = ("tinyllama-0", "tinyllama-1")
    for _ in range(12):
        mgr.resync()
        cloud.tick()
        if all(store.try_get("StatefulSet", "default", n) for n in names) \
                and store.try_get("Deployment", "default", "tinyllama-epp"):
            break
    else:
        raise SmokeFailure(f"{label}: the set rendered "
                           f"{[(o.kind, o.metadata.name) for o in store.list('StatefulSet')]}")
    pods = [store.get("StatefulSet", "default", n).spec["template"]["spec"]["containers"][0]
            for n in names]
    one = {"nvidia.com/gpu": "1"}
    probe = ["python", "-m", "kaito_tpu_torch.runtime.benchmark_probe"]
    for c in pods:
        if (c["command"] != _STARTUP_COMMAND or c["resources"] != {"requests": one,
                                                                   "limits": one}
                or c["startupProbe"].get("exec", {}).get("command") != probe):
            raise SmokeFailure(f"{label}: a replica renders {c['command']}, "
                               f"{c['resources']}, startup probe {c['startupProbe']}")
    ref = store.get("InferencePool", "default", "tinyllama-pool").spec["extensionRef"]["name"]
    epp = store.get("Deployment", "default", ref).spec["template"]["spec"]["containers"][0]
    backends = [epp["command"][i + 1] for i, a in enumerate(epp["command"]) if a == "--backend"]
    if (epp["command"][:3] != _EPP_MODULE or epp["image"] != GPU_IMAGE
            or backends != [f"http://{n}:5000" for n in names]
            or store.events.events(reason="EPPUnavailable")):
        raise SmokeFailure(f"{label}: the pool names {ref}, which runs {epp['command']} "
                           f"from {epp['image']}")
    log(f"{label}: the port's operator rendered two replicas of {pods[0]['command']} "
        f"(startup probe {probe}) and {ref}: {epp['command']} from {epp['image']}")
    return dict(command=pods[0]["command"],
                env={e["name"]: e["value"] for e in pods[0]["env"] if "value" in e},
                epp=epp["command"], image=epp["image"])


def render_fallback_workspace(label, config) -> list:
    """Host only: the port's ``WorkspaceReconciler`` on a Workspace of
    :data:`_GPT2` (its config served by a fetcher of this phase's, as the
    hub serves it) on ``a3-highgpu-1g``: a ``runtime: transformers``
    preset, whose engine container must run the port's HF fallback with
    ``--device cuda`` on one ``nvidia.com/gpu``.  Returns its command."""
    from kaito_tpu_torch.api import InferenceSpec, ObjectMeta, ResourceSpec, Workspace
    from kaito_tpu_torch.controllers.runtime import Store
    from kaito_tpu_torch.controllers.workspace import WorkspaceReconciler
    from kaito_tpu_torch.models import registry
    from kaito_tpu_torch.provision import FakeCloud, KarpenterTPUProvisioner

    saved = registry._config_fetcher
    registry.set_config_fetcher(lambda hf_id: config if hf_id == _GPT2 else None)
    try:
        store = Store()
        cloud = FakeCloud(store)
        rec = WorkspaceReconciler(store, KarpenterTPUProvisioner(store))
        store.create(Workspace(ObjectMeta(name="gpt2"),
                               resource=ResourceSpec(instance_type="a3-highgpu-1g"),
                               inference=InferenceSpec(preset=_GPT2)))
        for _ in range(8):
            rec.reconcile_key("default", "gpt2")
            cloud.tick()
            if store.try_get("StatefulSet", "default", "gpt2") is not None:
                break
        else:
            ws = store.get("Workspace", "default", "gpt2")
            raise SmokeFailure(f"{label}: the fallback Workspace: "
                               f"{[(c.type, c.reason, c.message) for c in ws.status.conditions]}")
    finally:
        registry.set_config_fetcher(saved)
    c = store.get("StatefulSet", "default", "gpt2").spec["template"]["spec"]["containers"][0]
    one = {"nvidia.com/gpu": "1"}
    if (c["command"][:3] != ["python", "-m", "kaito_tpu_torch.runtime.hf_fallback"]
            or c["command"][-2:] != ["--device", "cuda"]
            or c["resources"] != {"requests": one, "limits": one}):
        raise SmokeFailure(f"{label}: the fallback renders {c['command']}, {c['resources']}")
    log(f"{label}: a runtime: transformers preset renders {c['command']} on "
        f"{c['resources']['limits']}")
    return c["command"]


def _gpt2_checkpoint(path, out) -> None:
    """Thread body: GPT-2 at ``GPT2Config()``'s published widths, drawn
    from seed 0 and saved to ``path`` (``safe_serialization`` only where
    ``safetensors`` imports), then the port's fallback on the CPU and its
    logits for fixed ids; ``out`` gets the readings, or ``error``."""
    try:
        import torch

        t0 = time.perf_counter()
        from transformers import GPT2Config, GPT2LMHeadModel
        from transformers.utils import logging as hf_logging

        from kaito_tpu_torch.runtime.hf_fallback import FallbackState

        out["transformers_import_s"] = time.perf_counter() - t0
        hf_logging.disable_progress_bar()    # its monitor thread outlives the phase
        for mod in ("safetensors", "huggingface_hub"):
            try:
                out[mod] = importlib.import_module(mod).__version__
            except ImportError:
                out[mod] = None
        cfg = GPT2Config()
        out["widths"] = (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.vocab_size)
        t0 = time.perf_counter()
        torch.manual_seed(0)
        GPT2LMHeadModel(cfg).save_pretrained(path, safe_serialization=bool(out["safetensors"]))
        out["write_s"] = time.perf_counter() - t0
        with open(os.path.join(path, "config.json")) as f:
            out["config"] = json.load(f)
        cpu = FallbackState(path, max_model_len=cfg.n_positions, device="cpu")
        ids = torch.tensor([list(range(1000, 1064))])
        with torch.no_grad():
            out["cpu_logits"] = cpu.model(ids).logits
        out["ids"] = ids
    except Exception as e:   # reported by the phase, which fails
        out["error"] = repr(e)


def _child(argv, log_path, env=None):
    """A child process of this repository's Python, its output in a file."""
    f = open(log_path, "w")
    try:
        return subprocess.Popen([sys.executable, *argv[1:]], cwd=REPO, stdout=f,
                                stderr=subprocess.STDOUT, env={**os.environ, **(env or {})})
    finally:
        f.close()


def _wait_answering(proc, url, log_path, label, limit=120.0) -> float:
    """Seconds until ``url`` answers 200 (the child's log in the failure)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit:
        if proc.poll() is not None:
            break
        try:
            if _get(url)[0] == 200:
                return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(0.1)
    with open(log_path) as f:
        tail = f.read()[-3000:]
    raise SmokeFailure(f"{label}: {url} never answered (exit {proc.poll()}): {tail}")


def _samples(url) -> dict:
    """``{(family, labels): value}`` of a server's ``/metrics``."""
    from kaito_tpu_torch.utils.promtext import parse_exposition

    return {(n, lb): v for n, lb, v in parse_exposition(_get(url + "/metrics")[1].decode())}


def _front_leg(front, engines, urls, salt, label) -> dict:
    """:data:`_SESSIONS` sessions of :data:`_TURNS` streamed greedy chat
    turns through ``front``, one request at a time: each session a
    system prefix of its own, each turn the conversation so far.  Which
    replica served each turn (the one whose ``requests_total`` moved),
    TTFT, prompt tokens and the replicas' cached-token deltas."""
    import random

    cached0 = sum(e.counters["prefix_cached_tokens_total"] for e in engines)
    served, ttfts, prompt_tokens = [], [], 0
    for s in range(_SESSIONS):
        rng = random.Random(salt + s)
        system = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ")
                         for _ in range(_SYSTEM_CHARS))
        messages = [{"role": "system", "content": system}]
        turns = []
        for t in range(_TURNS):
            messages.append({"role": "user", "content": f"turn {t} of session {salt + s}"})
            before = [e.counters["requests_total"] for e in engines]
            ttft, events = _stream_ttft(front, "/v1/chat/completions", dict(
                messages=messages, max_tokens=_TURN_TOKENS, temperature=0.0,
                ignore_eos=True, stream=True, stream_options={"include_usage": True}))
            usage = next(e["usage"] for e in reversed(events)
                         if e != "[DONE]" and e.get("usage"))
            moved = [i for i, e in enumerate(engines)
                     if e.counters["requests_total"] != before[i]]
            if usage["completion_tokens"] != _TURN_TOKENS or len(moved) != 1:
                raise SmokeFailure(f"{label}: session {s} turn {t}: usage {usage}, "
                                   f"replicas moved {moved}")
            turns.append(urls[moved[0]])
            ttfts.append(ttft)
            prompt_tokens += usage["prompt_tokens"]
            messages.append({"role": "assistant", "content": _content(events)})
        served.append(turns)
    cached = sum(e.counters["prefix_cached_tokens_total"] for e in engines) - cached0
    return dict(served=served, ttft_ms=ttfts, ttft_p50_ms=_quantile(ttfts, 0.5),
                prompt_tokens=prompt_tokens, cached_tokens=cached,
                cached_share=cached / prompt_tokens)


def run_services_phase(label) -> tuple[dict, dict]:
    """Phase 21: the runtime services around the engine on the card,
    under :func:`_loopback_only`.

    Two TinyLlama-1.1B int8 replicas at full width, served through
    ``start_server`` from the argv and env the port's operator renders
    for a GPU InferenceSet of two replicas (:func:`render_services_set`),
    each with ``--max-pages`` :data:`_SERVICES_PAGES` and the same
    checkpoint (written once from seed 0, read from disk).  The picker
    runs as a child process from the rendered Deployment's command, its
    ``--backend`` URLs rewritten to the two loopback ports; the port's
    ``dp_router`` as another over the same replicas.  Each replica's
    first chat captures its windows, and three chats admitted together
    on the first launch K3.  Then :func:`_front_leg` through the picker
    and through the round robin: every picker session's turns 2-4 reach
    the replica of its turn 1, the picker counts ``_SESSIONS * (_TURNS -
    1)`` affinity hits, and its cached-token share is at least the round
    robin's (TTFT p50 of each logged, not gated).  The same prompt on
    either replica gives the same greedy tokens.  Replica B stopped,
    :data:`_FAILOVER_REQUESTS` requests through each front all answer 200
    from A and each front's breaker for B is not closed;
    ``runtime.health --role leader`` exits 0 for A and 1 for B; the
    benchmark probe (``--duration 10 --input-len 512 --output-len 64``)
    exits 0 with ``generation_tokens > 0``.  K1-K4 launched in the
    replicas and K1q/K5 did not.  Each front, sent SIGTERM, drains and
    exits 0.  Last, the HF fallback: GPT-2 at ``GPT2Config()``'s widths
    from seed 0 (:func:`_gpt2_checkpoint`, from the phase's start on a
    thread), served as a child from the command the operator renders for
    its Workspace (:func:`render_fallback_workspace`) with ``KAITO_OFFLINE=1``:
    ``/health`` names a CUDA device, one chat and one SSE stream are
    answered, and the port's fallback on the card gives the CPU's logits
    for the same ids within :data:`_FALLBACK_ATOL`.  Returns (launches,
    statistics)."""
    import shutil
    import signal
    import tempfile

    import torch

    from kaito_tpu_torch.engine.kv_cache import kv_bytes
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.server import start_server
    from kaito_tpu_torch.models.hub import install_default_fetcher
    from kaito_tpu_torch.models.registry import get_model_by_name

    t_leg = time.perf_counter()
    offline = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    root = tempfile.mkdtemp(prefix="kaito-services-")
    gpt2_dir = os.path.join(root, "gpt2")
    stats: dict = dict(sessions=_SESSIONS, turns=_TURNS, turn_tokens=_TURN_TOKENS,
                       system_chars=_SYSTEM_CHARS, max_pages=_SERVICES_PAGES)
    gpt2: dict = {}
    writer = threading.Thread(target=_gpt2_checkpoint, args=(gpt2_dir, gpt2),
                               name="phase21-gpt2", daemon=True)
    replicas, children = [], {}
    child_env = {"HF_HUB_OFFLINE": "1", "TRANSFORMERS_OFFLINE": "1", "KAITO_OFFLINE": "1"}
    with _loopback_only() as refused:
        try:
            writer.start()
            install_default_fetcher()
            pod = render_services_set(label)
            arch = get_model_by_name(_TINYLLAMA).arch
            src = TransformerLM(arch, dtype=torch.bfloat16, device="cuda")
            src.init_params(seed=0)
            stats["checkpoint_bytes"] = _hf_checkpoint(src, root)
            del src
            _release_card(torch)
            conf = os.path.join(root, "inference_config.yaml")
            with open(conf, "w") as f:
                f.write(_STARTUP_CONFIG)
            for kname in (*_STARTUP_COUNTED, *_STARTUP_ABSENT):
                fn, attr = _counter(kname)
                setattr(fn, attr, 0)
            saved = {k: os.environ.get(k) for k in pod["env"]}
            os.environ.update(pod["env"])
            try:
                for i in range(2):
                    port = _free_port()
                    t0 = time.perf_counter()
                    server, _ = start_server(_serve_argv(pod["command"], port, conf, root)
                                             + ["--max-pages", str(_SERVICES_PAGES)])
                    threading.Thread(target=server.serve_forever, daemon=True,
                                     name=f"phase21-replica-{i}").start()
                    replicas.append((server, server.state.engine,
                                     f"http://127.0.0.1:{port}"))
                    eng = server.state.engine
                    stats[f"replica_{i}"] = dict(
                        load_s=time.perf_counter() - t0, pages=eng.sizing_report["pages"],
                        kv_gib=kv_bytes(eng.cache) / 2**30,
                        weights_gib=eng.model.param_bytes() / 2**30)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            engines = [e for _, e, _ in replicas]
            urls = [u for _, _, u in replicas]
            log(f"{label}: replicas {urls}: " + "; ".join(
                f"{stats[f'replica_{i}']['pages']} pages, "
                f"{stats[f'replica_{i}']['kv_gib']:.2f} GiB KV, "
                f"{stats[f'replica_{i}']['weights_gib']:.2f} GiB weights, loaded in "
                f"{stats[f'replica_{i}']['load_s']:.1f} s" for i in range(2)))

            # the fronts: the picker from its rendered command, the round robin
            argv = list(pod["epp"])
            backends = iter(urls)
            argv = [next(backends) if i and argv[i - 1] == "--backend" else a
                    for i, a in enumerate(argv)]
            fronts = {}
            for name, cmd in (("picker", argv), ("dp_router", [
                    "python", "-m", "kaito_tpu_torch.runtime.dp_router",
                    "--backend", urls[0], "--backend", urls[1], "--port", "5000"])):
                port = _free_port()
                cmd[cmd.index("--port") + 1] = str(port)
                path = os.path.join(root, f"{name}.log")
                children[name] = (_child(cmd, path), path)
                fronts[name] = f"http://127.0.0.1:{port}"
            for name, (proc, path) in children.items():
                _wait_answering(proc, fronts[name] + "/router/stats", path, label, 60)
            log(f"{label}: picker {argv} and round robin at {fronts}")

            # each replica's windows captured; three chats packed on A (K3)
            stats["warm"] = [_timed_chat(u, _prompt(170, 60 + i), 64)
                             for i, u in enumerate(urls)]
            stats["together"], stats["packed_prefill_dispatches"] = _chats_together(
                engines[0], urls[0], [_prompt(90 + 10 * i, 70 + i) for i in range(3)],
                64, label)

            writer.join(timeout=120)
            if "error" in gpt2 or writer.is_alive():
                raise SmokeFailure(f"{label}: the GPT-2 checkpoint: {gpt2.get('error')}")
            if gpt2["widths"] != _GPT2_WIDTHS:
                raise SmokeFailure(f"{label}: GPT2Config() gave {gpt2['widths']}")
            cmd = render_fallback_workspace(label, gpt2["config"])
            fport = _free_port()
            cmd[cmd.index("--model") + 1] = gpt2_dir
            cmd[cmd.index("--port") + 1] = str(fport)
            fpath = os.path.join(root, "hf_fallback.log")
            t_fallback = time.perf_counter()
            children["hf_fallback"] = (_child(cmd, fpath, child_env), fpath)
            log(f"{label}: GPT-2 {gpt2['widths']} written in {gpt2['write_s']:.1f} s "
                f"(transformers imported in {gpt2['transformers_import_s']:.1f} s; "
                f"safetensors {gpt2['safetensors']}, huggingface_hub "
                f"{gpt2['huggingface_hub']}); serving {cmd}")

            time.sleep(1.5)      # the picker's first scrape: kaito:kv_page_size
            stats["picker"] = _front_leg(fronts["picker"], engines, urls, 1000, label)
            stats["round_robin"] = _front_leg(fronts["dp_router"], engines, urls, 2000,
                                              label)
            pm = _samples(fronts["picker"])
            hits = pm.get(("kaito:epp_affinity_hits_total", ""), 0)
            stats["picker"].update(
                affinity_hits=hits,
                affinity_misses=pm.get(("kaito:epp_affinity_misses_total", ""), 0),
                picks={u: pm.get(("kaito:epp_picks_total", f'{{backend="{u}"}}'), 0)
                       for u in urls})
            strays = [(s, turns) for s, turns in enumerate(stats["picker"]["served"])
                      if len(set(turns)) != 1]
            if (strays or hits != _SESSIONS * (_TURNS - 1)
                    or stats["picker"]["cached_share"] < stats["round_robin"]["cached_share"]):
                raise SmokeFailure(f"{label}: affinity: sessions off their replica {strays}, "
                                   f"hits {hits}, cached share picker "
                                   f"{stats['picker']['cached_share']:.4f} against round "
                                   f"robin {stats['round_robin']['cached_share']:.4f}")
            for name in ("picker", "round_robin"):
                s = stats[name]
                log(f"{label}: {name}: cached {s['cached_tokens']} of {s['prompt_tokens']} "
                    f"prompt tokens ({s['cached_share']:.4f}), TTFT p50 "
                    f"{s['ttft_p50_ms']:.1f} ms, sessions' replicas "
                    f"{[sorted(set(t)) for t in s['served']]}")
            log(f"{label}: picker counters: affinity hits {hits}, misses "
                f"{stats['picker']['affinity_misses']}, picks {stats['picker']['picks']}")

            # greedy determinism across the replicas
            traces = [e._finish_trace for e in engines]
            done = [_finished_requests(e) for e in engines]
            try:
                for u in urls:
                    _completion(u, _prompt(300, 80), 24)
            finally:
                for e, trace in zip(engines, traces):
                    e._finish_trace = trace
            pair = [list(d[-1].output_tokens) for d in done]
            if pair[0] != pair[1] or len(pair[0]) != 24:
                raise SmokeFailure(f"{label}: greedy tokens differ: {pair}")
            stats["greedy_equal"] = len(pair[0])

            # failover: B stopped
            server_b, engine_b, url_b = replicas.pop()
            server_b.shutdown()
            server_b.server_close()
            engine_b.stop()
            url_a = urls[0]
            failover = {}
            b_label = f'{{backend="{url_b}"}}'
            t_stop = time.perf_counter()
            for name, front in fronts.items():
                before = engines[0].counters["requests_total"]
                codes = [_post(f"{front}/v1/completions", dict(
                    prompt=_prompt(120, 90 + i), max_tokens=8, temperature=0.0,
                    ignore_eos=True))[0] for i in range(_FAILOVER_REQUESTS)]
                failover[name] = dict(
                    codes=codes, served_by_a=engines[0].counters["requests_total"] - before)
            # a front's /health prober (every 2 s, the rendered default)
            # opens B's breaker if no request found B down first
            for name, front in fronts.items():
                deadline = time.monotonic() + 10
                while True:
                    m = _samples(front)
                    breaker = m.get(("kaito:router_backend_breaker_state", b_label))
                    if breaker or time.monotonic() > deadline:
                        break
                    time.sleep(0.2)
                f = failover[name]
                f.update(breaker_b=breaker, breaker_open_after_s=time.perf_counter() - t_stop,
                         failures_b=m.get(("kaito:router_backend_failures_total", b_label), 0),
                         forwarded_a=m.get(("kaito:router_requests_forwarded_total",
                                            f'{{backend="{url_a}"}}'), 0))
                if (f["codes"] != [200] * _FAILOVER_REQUESTS
                        or f["served_by_a"] != _FAILOVER_REQUESTS or not breaker):
                    raise SmokeFailure(f"{label}: failover through {name}: {f}")
            stats["failover"] = failover
            log(f"{label}: replica B stopped: {failover}")
            rcs = {}
            for name, url in (("A", url_a), ("B", url_b)):
                out = subprocess.run([sys.executable, "-m", "kaito_tpu_torch.runtime.health",
                                      "--role", "leader", "--base-url", url], cwd=REPO,
                                     capture_output=True, text=True, timeout=60)
                rcs[name] = (out.returncode, out.stdout.strip())
            if rcs["A"][0] != 0 or rcs["B"][0] != 1:
                raise SmokeFailure(f"{label}: runtime.health: {rcs}")
            stats["health"] = rcs
            log(f"{label}: runtime.health --role leader: {rcs}")

            sink = os.path.join(root, "benchmark.sink")
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "kaito_tpu_torch.runtime.benchmark_probe",
                                  "--base-url", url_a, "--duration", "10", "--input-len",
                                  "512", "--output-len", "64", "--sink", sink], cwd=REPO,
                                 capture_output=True, text=True, timeout=180)
            wall = time.perf_counter() - t0
            line = open(sink).read().strip() if os.path.exists(sink) else ""
            if out.returncode != 0 or not line.startswith("KAITO_BENCHMARK_RESULT"):
                raise SmokeFailure(f"{label}: the benchmark probe exited {out.returncode}: "
                                   f"{line!r} {out.stderr[-2000:]}")
            result = json.loads(line[len("KAITO_BENCHMARK_RESULT"):])
            if result["generation_tokens"] <= 0:
                raise SmokeFailure(f"{label}: the benchmark probe: {result}")
            stats["probe"] = dict(result, wall_s=wall,
                                  tok_s=result["generation_tokens"] / result["elapsed_s"])
            log(f"{label}: benchmark probe on A, {wall:.1f} s: {result}")

            torch.cuda.synchronize()
            launches = {k: getattr(*_counter(k)) for k in _STARTUP_COUNTED}
            stray = {k: getattr(*_counter(k)) for k in _STARTUP_ABSENT}
            if any(stray.values()) or not all(launches.values()):
                raise SmokeFailure(f"{label}: launches {launches}, absent {stray}")
            log(f"{label}: launches {launches}; {stray} (none)")

            drained = {}
            for name in fronts:
                proc, _ = children.pop(name)
                proc.send_signal(signal.SIGTERM)
                drained[name] = proc.wait(timeout=40)
            if any(drained.values()):
                raise SmokeFailure(f"{label}: fronts after SIGTERM exited {drained}")
            stats["drained"] = drained
            for server, engine, _ in replicas:
                server.shutdown()
                server.server_close()
                engine.stop()
            replicas.clear()
            _release_card(torch)

            # the HF fallback, last
            fproc, fpath = children["hf_fallback"]
            furl = f"http://127.0.0.1:{fport}"
            _wait_answering(fproc, furl + "/health", fpath, label, 180)
            health = json.loads(_get(furl + "/health")[1])
            try:
                t0 = time.perf_counter()
                status, raw = _post(furl + "/v1/chat/completions", dict(
                    messages=[{"role": "user", "content": "hello"}], max_tokens=32,
                    temperature=0.0, ignore_eos=True))
                chat_s = time.perf_counter() - t0
                chat = json.loads(raw)
                ttft, events = _stream_ttft(furl, "/v1/completions", dict(
                    prompt="hello", max_tokens=16, temperature=0.0, ignore_eos=True,
                    stream=True))
            except (urllib.error.URLError, ConnectionError, OSError, ValueError) as e:
                with open(fpath) as f:
                    raise SmokeFailure(f"{label}: the fallback: {e!r}; its log: "
                                       f"{f.read()[-3000:]}") from None
            with open(fpath) as f:
                ready = re.search(r"fallback runtime ready in ([0-9.]+)s", f.read())
            if (not health.get("device", "").startswith("cuda") or status != 200
                    or chat["usage"]["completion_tokens"] != 32 or events[-1] != "[DONE]"
                    or len(events) != 18 or ready is None):
                raise SmokeFailure(f"{label}: the fallback: health {health}, chat {status} "
                                   f"{chat.get('usage')}, {len(events)} events, ready {ready}")
            from kaito_tpu_torch.runtime.hf_fallback import FallbackState

            gpu = FallbackState(gpt2_dir, max_model_len=1024, device="cuda")
            with torch.no_grad():
                logits = gpu.model(gpt2["ids"].cuda()).logits.cpu()
            err = (logits - gpt2["cpu_logits"]).abs().max().item()
            del gpu
            if not err <= _FALLBACK_ATOL:
                raise SmokeFailure(f"{label}: fallback logits on the card against the CPU: "
                                   f"max abs error {err}")
            stats["fallback"] = dict(
                health=health, load_s=float(ready.group(1)),
                to_health_s=time.perf_counter() - t_fallback,
                chat_tok_s=32 / chat_s, stream_ttft_ms=ttft, logits_max_abs_err=err,
                transformers_import_s=gpt2["transformers_import_s"],
                safetensors=gpt2["safetensors"], huggingface_hub=gpt2["huggingface_hub"])
            log(f"{label}: the fallback on {health['device']}: loaded in "
                f"{stats['fallback']['load_s']} s; a 32-token chat {32 / chat_s:.1f} tok/s; "
                f"SSE TTFT {ttft:.1f} ms; logits against the CPU max abs {err:.3g}")
            stats["unresolved"] = sorted(set(refused))
        finally:
            if offline is None:
                os.environ.pop("HF_HUB_OFFLINE", None)
            else:
                os.environ["HF_HUB_OFFLINE"] = offline
            for proc, _ in children.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=30)
            for server, engine, _ in replicas:
                server.shutdown()
                server.server_close()
                engine.stop()
            writer.join(timeout=120)
            shutil.rmtree(root, ignore_errors=True)
    del replicas
    _release_card(torch)
    stats["phase_s"] = time.perf_counter() - t_leg
    return launches, stats


_GQA_ATTENTION = ("paged_decode_attention", "paged_decode_attention_int8kv",
                  "flash_prefill_attention", "flash_prefill_packed")
# the server legs of phases 4-8: (name for --leg, label, model, server
# flags, counters that must grow, burst, tensor-parallel degree, the
# depth the model is cut to (None: whole), counters that must stay 0)
LEGS = (("bf16", "phase 4, bf16", _LLAMA, [],
         ("paged_decode_attention", "flash_prefill_attention", "flash_prefill_packed"),
         True, 1, None, ()),
        ("int4-kv8", "phase 5, int4 weights + int8 KV", _LLAMA,
         ["--quantization", "int4", "--kv-cache-dtype", "int8"],
         ("quant_matmul_int4", "quant_matmul_int4_wide",
          "paged_decode_attention_int8kv"), True, 1, None, ()),
        ("int8", "phase 5, int8 weights", _LLAMA, ["--quantization", "int8"],
         ("quant_matmul_int8", "quant_matmul_int8_wide"), False, 1, None, ()),
        ("bf16-async", "phase 5, bf16, async dispatch", _LLAMA, ["--async-dispatch"],
         ("paged_decode_attention", "flash_prefill_attention", "flash_prefill_packed"),
         True, 1, None, ()),
        # TP >= 2 decodes eagerly (ROADMAP item 35), 5600-9100 host launches
        # a step at 32 layers: the TP legs keep every width and 4 layers
        # (and profile 4 decode steps), which keeps the whole run well
        # inside its time limit
        ("tp2-int4-kv8", "phase 6, TP=2 int4 weights + int8 KV, comm overlap "
         "(4 of 32 layers)", _LLAMA,
         ["--quantization", "int4", "--kv-cache-dtype", "int8", *_TP2],
         ("quant_matmul_int4_pf", "quant_matmul_int4", "paged_decode_attention_int8kv",
          "flash_prefill_attention", "flash_prefill_packed"), True, 2, 4, ()),
        ("tp2-int8", "phase 6, TP=2 int8 weights, comm overlap (4 of 32 layers)",
         _LLAMA, ["--quantization", "int8", *_TP2],
         ("quant_matmul_int8_pf", "paged_decode_attention"), False, 2, 4, ()),
        ("moe-bf16", "phase 7, gpt-oss-20b MoE, bf16", _GPT_OSS, [],
         ("paged_decode_attention", "flash_prefill_attention", "flash_prefill_packed"),
         True, 1, None, ()),
        # DeepSeek-V3 at its published widths, 61 layers cut to the 3 dense
        # and 2 MoE layers (1.34 TB in bf16 whole; 53 GB so)
        ("mla-bf16", "phase 8, DeepSeek-V3 MLA + MoE (5 of 61 layers), bf16",
         _DEEPSEEK, [], (), True, 1, 5, _GQA_ATTENTION),
        # 3 dense + 1 MoE layer: every call widens the int8 expert stack
        # whole (ROADMAP item 36; 7.5 GB a projection), and the window's
        # graph pool keeps that room, so one MoE layer keeps the peak low
        ("mla-int8-kv8", "phase 8, DeepSeek-V3 (4 of 61 layers), int8 weights + "
         "int8 KV", _DEEPSEEK, ["--quantization", "int8", "--kv-cache-dtype", "int8"],
         ("quant_matmul_int8", "quant_matmul_int8_wide"), True, 1, 4, _GQA_ATTENTION))


def _watchdog(seconds: float) -> None:
    """Fail the run (exit 1, no result) if it has not finished in time:
    a hung request must not hold the card until an outer limit."""
    def fire():
        log(f"FAIL: not finished after {seconds:.0f}s")
        os._exit(1)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep-run-ahead", action="store_true",
                    help="also sweep decode_run_ahead at full width")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width request of each server "
                         "leg with torch.profiler")
    ap.add_argument("--phase2-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks) and print "
                         "the kernel records without launches; no result line")
    ap.add_argument("--first-leg-only", action="store_true",
                    help="skip the goldens (phase 3) and every server leg after "
                         "phase 4's bf16 one; no result line")
    ap.add_argument("--leg", choices=[name for name, *_ in LEGS] + [
                        QOS_LEG[0], SPEC_LEG[0], GRAMMAR_LEG[0], ADAPTER_LEG[0],
                        ADAPTER_EXACT_LEG[0], FAMILIES_LEG[0], FAMILIES_EXACT_LEG[0],
                        DEVPROF_LEG[0], OFFLOAD_LEG[0], PD_LEG[0], TRAIN_LEG[0],
                        TRAIN_EXACT_LEG[0], RAG_LEG[0], RAG_EXACT_LEG[0],
                        STARTUP_LEG[0], MANAGER_LEG[0], SERVICES_LEG[0]],
                    help="build the kernels and run this one server leg alone "
                         "(phases 2 and 3 skipped; with --profile, the quickest "
                         "reading of its TTFT and prefill device time); no result "
                         "line")
    ap.add_argument("--time-limit", type=float, default=1100.0,
                    help="seconds after which the run fails")
    args = ap.parse_args(argv)
    _watchdog(args.time_limit)
    global T_START
    T_START = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs a card")
        return 2
    try:
        import kaito_tpu_torch
    except ImportError as e:
        log(f"FAIL: the kaito_tpu_torch package is not beside this script: {e}")
        return 2
    pkg = os.path.dirname(os.path.abspath(kaito_tpu_torch.__file__))
    if os.path.dirname(pkg) != REPO:
        log(f"FAIL: kaito_tpu_torch imported from {pkg}, not from this checkout")
        return 2
    try:
        # fp32 matmuls in full fp32 (the goldens' precision), not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
        global CONTEXT_BYTES
        torch.zeros(1, device="cuda")
        free, total = torch.cuda.mem_get_info()
        CONTEXT_BYTES = total - free - torch.cuda.memory_reserved()
        log(f"CUDA context: {CONTEXT_BYTES} bytes ({CONTEXT_BYTES / 2**20:.1f} MiB) of "
            f"{total} on {card}")
        from kaito_tpu_torch.ops import build

        t0 = time.perf_counter()
        logs = build.build_all(ptxas_verbose=True)
        log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
        for name, text in logs.items():
            for line in text.splitlines():
                if any(w in line for w in ("entry function", "registers", "spill",
                                           "setmaxnreg", "arning")):
                    log(f"  {name}: {line.strip()}")

        records: dict = {}
        alone = args.first_leg_only or args.leg is not None
        with torch.no_grad():
            if args.leg is None:
                check_decode(torch, records, logs)
                check_flash(torch, records)
                check_families(torch, records, logs)
                check_quant_matmul(torch, records, logs)
                check_quant_matmul_deepseek(torch, records)
                check_quant_matmul_tinyllama(torch, records)
                check_quant_matmul_pf(torch, records)
                check_quant_graph(torch, records)
            if args.phase2_only:
                print(card)
                print(json.dumps({"kernels": [records[k[0]] for k in KERNELS]}))
                return 0
            golden_err = {} if alone else {
                sec: check_goldens(sec) for sec in GOLDEN_MODES}
            for sec in () if alone else GOLDEN_MODES:
                golden_err[f"{sec} warm"] = check_goldens(sec, warm=True)
            for sec in () if alone else GOLDEN_MODES:
                golden_err[f"{sec} async"] = check_goldens(sec, async_on=True)
            for sec in () if alone else GOLDEN_MODES:
                golden_err[f"{sec} n-gram"] = check_goldens(sec, spec="ngram")
            if not alone:
                golden_err["fp32 draft"] = check_goldens("fp32", spec="draft")
            for sec in () if alone else GOLDEN_MODES:
                golden_err[f"tiny-moe-real {sec}"] = check_goldens(
                    sec, model="tiny-moe-real")
            if not alone:
                golden_err["tiny-moe-real fp32 async"] = check_goldens(
                    "fp32", async_on=True, model="tiny-moe-real")
            for sec in () if alone else GOLDEN_MODES:
                golden_err[f"tiny MLA {sec}"] = check_mla_tiny(sec)
            if not alone:
                golden_err["fp32 TP=2 overlap=True async"] = check_goldens(
                    "fp32", 2, True, async_on=True)
            for tp, sections in () if alone else TP_GOLDENS:
                for sec in sections:
                    for ov in (False, True):
                        golden_err[f"{sec} TP={tp} overlap={ov}"] = check_goldens(
                            sec, tp, ov)
            _release_card(torch)
            # with two cards or more, each TP leg runs on the first two and
            # again with both shards on the first, so one run compares a real
            # ring hop with none
            placements = ((", two cards", False), (", one card", True)) \
                if torch.cuda.device_count() >= 2 else (("", True),)
            legs = [(label + where, model, flags, counted, burst, tp, shared, layers,
                     absent)
                    for name, label, model, flags, counted, burst, tp, layers, absent
                    in LEGS if args.leg in (None, name)
                    for where, shared in (placements if tp > 1 else (("", False),))]
            if args.first_leg_only:
                legs = legs[:1]
            stats = {}
            for i, (label, model, flags, counted, burst, tp, shared, layers,
                    absent) in enumerate(legs):
                _phase_start(torch, label, deep=i == 0)
                launches, stats[label] = run_server_phase(
                    flags, counted, label, burst=burst,
                    run_ahead_sweep=args.sweep_run_ahead and i == 0,
                    profile=args.profile, tp=tp, shared=shared, model=model,
                    layers=layers, absent=absent)
                _release_card(torch)
                for name in launches:
                    if launches[name] <= 0:
                        raise SmokeFailure(f"{name} never launched in {label}")
                    if alone:
                        continue
                    wide = next((w for w in WIDE_COUNTERS if w[0] == name), None)
                    rec = records[wide[1] if wide else name]
                    key = "launches_wide" if wide else "launches"
                    if key not in rec:
                        rec[key] = launches[name]
                    else:
                        rec.setdefault(key + "_by_leg", {})[label] = launches[name]
                log(f"{label} on {card}: TTFT {stats[label]['ttft_ms']:.1f} ms "
                    f"({stats[label]['prompt_tokens']}-token prompt, alone), decode "
                    f"{stats[label]['decode_tok_s']:.1f} tok/s (one sequence)")
            if args.leg in (None, QOS_LEG[0]) and not args.first_leg_only:
                name, label = QOS_LEG
                _phase_start(torch, label, deep=True)
                launches, stats[label] = run_qos_phase(label)
                _release_card(torch)
                for kname, n in launches.items():
                    if n <= 0 and kname != "flash_prefill_packed":
                        raise SmokeFailure(f"{kname} never launched in {label}")
                    if not alone:
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                o = stats[label]["overload"]
                log(f"{label} on {card}: acme TTFT p50 {o['acme_ttft_p50_alone_ms']:.1f} "
                    f"ms alone, {o['acme_ttft_p50_loaded_ms']:.1f} ms under the flood")
            if args.leg in (None, SPEC_LEG[0]) and not args.first_leg_only:
                name, label = SPEC_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_spec_phase(label)
                _release_card(torch)
                for kname, n in launches.items():
                    if n <= 0 and kname != "flash_prefill_packed":
                        raise SmokeFailure(f"{kname} never launched in {label}")
                    if not alone:
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: ms a token alone: plain "
                    f"{s['plain']['ms_per_token']:.3f}, n-gram "
                    f"{s['ngram']['ms_per_token']:.3f}, draft "
                    f"{s['draft']['ms_per_token']:.3f}; tokens a target forward: "
                    f"n-gram {s['ngram']['tokens_per_target_forward']:.3f}, draft "
                    f"{s['draft']['tokens_per_target_forward']:.3f}")
            if args.leg in (None, GRAMMAR_LEG[0]) and not args.first_leg_only:
                name, label = GRAMMAR_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_grammar_phase(label)
                _release_card(torch)
                for kname, n in launches.items():
                    if n <= 0:
                        raise SmokeFailure(f"{kname} never launched in {label}")
                    if not alone:
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: ms a token alone: plain "
                    f"{s['alone']['plain_ms_per_token']:.3f}, constrained "
                    f"{s['alone']['constrained_ms_per_token']:.3f}; grammar table "
                    f"{s['growth']['mib']:.1f} MiB after growth; one K=4 window "
                    f"(card ms) {s['window_ms']}")
            if args.leg in (None, ADAPTER_LEG[0]) and not args.first_leg_only:
                name, label = ADAPTER_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_adapter_phase(label)
                for kname, n in launches.items():
                    if n <= 0:
                        raise SmokeFailure(f"{kname} never launched in {label}")
                    if not alone:
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: ms a token alone: base "
                    f"{s['alone']['base']['ms_per_token']:.3f}, adapter "
                    f"{s['alone']['adapter']['ms_per_token']:.3f}; POST hot-load ms "
                    f"{s['post_load_ms']}; one K=4 window of 8 rows {s['window']}")
            if args.leg in (None, ADAPTER_EXACT_LEG[0]) and not args.first_leg_only:
                name, label = ADAPTER_EXACT_LEG
                _phase_start(torch, label, deep=False)
                stats[label] = run_adapter_exact_phase(label)
            if args.leg in (None, FAMILIES_LEG[0]) and not args.first_leg_only:
                name, label = FAMILIES_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_families_phase(label)
                if not alone:
                    for kname, n in launches.items():
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                log(f"{label} on {card}: " + "; ".join(
                    f"{m}: TTFT {s['ttft_ms']:.1f} ms, {s['decode_tok_s']:.1f} tok/s, "
                    f"{s['decode']['device_kernels_per_step']:.1f} device kernels a step"
                    for m, s in stats[label].items() if isinstance(s, dict)))
            if args.leg in (None, FAMILIES_EXACT_LEG[0]) and not args.first_leg_only:
                name, label = FAMILIES_EXACT_LEG
                _phase_start(torch, label, deep=False)
                stats[label] = run_families_exact_phase(label)
            params14 = None
            for leg, must in ((DEVPROF_LEG, ("paged_decode_attention",
                                             "flash_prefill_attention")),
                              (OFFLOAD_LEG, ("paged_decode_attention",
                                             "flash_prefill_attention"))):
                if args.leg not in (None, leg[0]) or args.first_leg_only:
                    continue
                name, label = leg
                _phase_start(torch, label)
                if leg is DEVPROF_LEG:
                    launches, stats[label], params14 = run_devprof_phase(label)
                else:
                    launches, stats[label] = run_offload_phase(label, params14)
                    params14 = None
                _release_card(torch)
                for kname in must:
                    if launches[kname] <= 0:
                        raise SmokeFailure(f"{kname} never launched in {label}")
                if not alone:
                    for kname, n in launches.items():
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                log(f"{label} on {card}: {stats[label]['phase_s']:.1f} s")
            if args.leg in (None, PD_LEG[0]) and not args.first_leg_only:
                name, label = PD_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_pd_phase(label)
                _release_card(torch)
                for kname in ("paged_decode_attention", "flash_prefill_attention"):
                    if launches[kname] <= 0:
                        raise SmokeFailure(f"{kname} never launched in {label}")
                if not alone:
                    for kname, n in launches.items():
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                log(f"{label} on {card}: {stats[label]['phase_s']:.1f} s")
            if args.leg in (None, TRAIN_LEG[0]) and not args.first_leg_only:
                name, label = TRAIN_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_train_phase(label)
                _release_card(torch)
                if launches["quant_matmul_int8"] <= 0:
                    raise SmokeFailure(f"quant_matmul_int8 never launched in {label}")
                if not alone:
                    rec = records["quant_matmul_int8"]
                    rec.setdefault("launches_by_leg", {})[label] = \
                        launches["quant_matmul_int8"]
                    rec.setdefault("launches_wide_by_leg", {})[label] = \
                        launches["quant_matmul_int8_wide"]
                log(f"{label} on {card}: " + "; ".join(
                    f"{run}: median step {s['step_ms_median_3_8']:.1f} ms, "
                    f"{s['tokens_per_s']:.0f} tokens/s, peak {s['peak_gib']:.2f} GiB"
                    for run, s in stats[label].items() if isinstance(s, dict))
                    + f"; {stats[label]['phase_s']:.1f} s")
            if args.leg in (None, TRAIN_EXACT_LEG[0]) and not args.first_leg_only:
                name, label = TRAIN_EXACT_LEG
                _phase_start(torch, label, deep=False)
                stats[label] = run_train_exact_phase(label)
                _release_card(torch)
            if args.leg in (None, RAG_LEG[0]) and not args.first_leg_only:
                name, label = RAG_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_rag_phase(label)
                if launches["flash_prefill_attention"] <= 0:
                    raise SmokeFailure(f"flash_prefill_attention never launched in {label}")
                if not alone:
                    for kname, n in launches.items():
                        records[kname].setdefault("launches_by_leg", {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: embed {s['chunk64'][1]:.1f} ms a forward of "
                    f"{s['chunk64'][0]} rows, {s['index']['docs_per_s']:.1f} documents/s "
                    f"indexing; /retrieve p50 {s['retrieve_p50_ms']:.1f} ms; chat TTFT "
                    f"through RAG {_quantile(s['ttft_ms']['rag'], 0.5):.1f} ms against "
                    f"{_quantile(s['ttft_ms']['upstream'], 0.5):.1f} ms straight; peak "
                    f"{s['peak_gib']:.2f} GiB; {s['phase_s']:.1f} s")
            if args.leg in (None, RAG_EXACT_LEG[0]) and not args.first_leg_only:
                name, label = RAG_EXACT_LEG
                _phase_start(torch, label, deep=False)
                stats[label] = run_rag_exact_phase(label)
                _release_card(torch)
            if args.leg in (None, STARTUP_LEG[0]) and not args.first_leg_only:
                name, label = STARTUP_LEG
                _phase_start(torch, label, deep=True)
                launches, stats[label] = run_startup_phase(label)
                for kname, n in launches.items():
                    if n <= 0:
                        raise SmokeFailure(f"{kname} never launched in {label}")
                    if not alone:
                        wide = next((w for w in WIDE_COUNTERS if w[0] == kname), None)
                        key = "launches_wide_by_leg" if wide else "launches_by_leg"
                        records[wide[1] if wide else kname].setdefault(
                            key, {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: stream {s['stream']['seconds']} s, "
                    f"{s['stream']['bytes']} bytes, {s['stream']['mib_per_s']} MiB/s; "
                    f"load {s['load_s']:.1f} s; TTFT alone {s['alone']['ttft_ms']:.1f} ms "
                    f"({s['alone']['prompt_tokens']}-token prompt), "
                    f"{s['alone']['tok_s']:.1f} tok/s; three together: TTFT "
                    + ", ".join(f"{r['ttft_ms']:.1f}" for r in s["together"])
                    + " ms, " + ", ".join(f"{r['tok_s']:.1f}" for r in s["together"])
                    + f" tok/s; {s['phase_s']:.1f} s")
                stats[SKU_LABEL] = run_sku_phase(torch, stats, SKU_LABEL, whole=not alone)
                log(f"{SKU_LABEL} on {card}: " + "; ".join(
                    f"{leg}: weights x{r['weight_ratio']:.4f}, KV tokens "
                    f"x{r['kv_ratio']:.4f}" for leg, r in stats[SKU_LABEL]["legs"].items())
                    + f"; {stats[SKU_LABEL]['phase_s']:.1f} s")
            if args.leg in (None, MANAGER_LEG[0]) and not args.first_leg_only:
                name, label = MANAGER_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_manager_phase(label)
                _phase_start(torch, f"after {label}", deep=False)
                if not alone:
                    for kname, n in launches.items():
                        wide = next((w for w in WIDE_COUNTERS if w[0] == kname), None)
                        key = "launches_wide_by_leg" if wide else "launches_by_leg"
                        records[wide[1] if wide else kname].setdefault(
                            key, {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: signal out of nominal +"
                    f"{next(t for t, st in s['transitions'] if st != 'nominal'):.2f} s, "
                    f"spec.replicas 2 +{s['marks']['replicas_2']:.2f} s, second child "
                    f"rendered +{s['marks']['child_1_rendered']:.2f} s after the burst; "
                    f"load {s['load_s']:.1f} s; {s['phase_s']:.1f} s")
            if args.leg in (None, SERVICES_LEG[0]) and not args.first_leg_only:
                name, label = SERVICES_LEG
                _phase_start(torch, label, deep=False)
                launches, stats[label] = run_services_phase(label)
                _phase_start(torch, f"after {label}", deep=False)
                if not alone:
                    for kname, n in launches.items():
                        wide = next((w for w in WIDE_COUNTERS if w[0] == kname), None)
                        key = "launches_wide_by_leg" if wide else "launches_by_leg"
                        records[wide[1] if wide else kname].setdefault(
                            key, {})[label] = n
                s = stats[label]
                log(f"{label} on {card}: cached-token share picker "
                    f"{s['picker']['cached_share']:.4f} / round robin "
                    f"{s['round_robin']['cached_share']:.4f}; TTFT p50 "
                    f"{s['picker']['ttft_p50_ms']:.1f} / {s['round_robin']['ttft_p50_ms']:.1f} "
                    f"ms; probe {s['probe']['tok_s']:.1f} tok/s; fallback loaded in "
                    f"{s['fallback']['load_s']} s, {s['fallback']['chat_tok_s']:.1f} tok/s; "
                    f"{s['phase_s']:.1f} s")
        if alone:
            print(json.dumps({"server_legs": stats}))
            return 0
        log(f"golden logprob diffs {golden_err}")
        log(f"whole run: {time.perf_counter() - T_START:.1f}s")
        print(json.dumps({"server_legs": stats,
                          "golden_max_logprob_diff": golden_err}))
        print(card)
        print(json.dumps({"kernels": [records[k[0]] for k in KERNELS]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:
        log("FAIL:\n" + traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(main())
