"""HF transformers fallback runtime for long-tail architectures.

The counterpart of the reference's text-generation runtime
(``presets/workspace/inference/text-generation/inference_api.py``): the
first-party JAX engine covers the catalog's model families; anything
else (an architecture the engine has no layer implementation for)
serves through HuggingFace ``transformers`` on torch behind the SAME
OpenAI surface, so every model the reference can serve has a serving
path here too.  The workload generator selects this runtime from the
preset's ``runtime: transformers`` (``models/autogen`` flips it for
unsupported architectures).

Deliberately small: stdlib HTTP, greedy/temperature sampling loop,
local-files-only model loading (zero-egress parity), byte-level
tokenizer fallback when the checkpoint ships no tokenizer.

The port's own copy of ``kaito_tpu/runtime/hf_fallback.py``, on a
device: ``--device`` (default ``cuda``, raising without a card, as
every entry point of the port does) holds the model and every input;
``/health`` names it.  fp32, ``local_files_only`` first and
``KAITO_OFFLINE=1`` as in the JAX module; the byte-level fallback is
the port's own ``engine/tokenizer.py``, also taken when the checkpoint's
tokenizer loads with an empty vocabulary (transformers 5 for a
checkpoint without tokenizer files).
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger(__name__)


class FallbackState:
    def __init__(self, model_path: str, max_model_len: int = 2048,
                 served_name: str = "", device: str = "cuda"):
        import os

        import torch

        from kaito_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.torch = torch
        t0 = time.monotonic()
        # local first (ModelMirror PVC / pre-warmed cache); when absent
        # and egress is allowed, download like the reference's
        # text-generation runtime does at startup (KAITO_OFFLINE=1
        # forces the zero-egress behavior)
        offline = os.environ.get("KAITO_OFFLINE", "") == "1"
        try:
            self.model = AutoModelForCausalLM.from_pretrained(
                model_path, local_files_only=True, dtype=torch.float32)
        except OSError:
            if offline:
                raise
            logger.info("no local copy of %s; downloading", model_path)
            self.model = AutoModelForCausalLM.from_pretrained(
                model_path, dtype=torch.float32)
        self.model.to(self.device).eval()
        try:
            self.tokenizer = AutoTokenizer.from_pretrained(
                model_path, local_files_only=True)
            if not self.tokenizer.encode("a"):
                # transformers 5 builds an empty tokenizer for a checkpoint
                # without tokenizer files, where 4.x raised: every prompt
                # would encode to no ids
                raise OSError(f"empty tokenizer vocabulary at {model_path}")
        except Exception:
            from kaito_tpu_torch.engine.tokenizer import ByteTokenizer

            logger.warning("no tokenizer files at %s; byte-level fallback",
                           model_path)
            self.tokenizer = ByteTokenizer()
        self.max_model_len = max_model_len
        self.served_name = served_name or model_path.rstrip("/").rsplit(
            "/", 1)[-1]
        self.lock = threading.Lock()   # one generation step at a time
        # counters get hit from concurrent handler threads outside the
        # generation lock; they need their own
        self.counters_lock = threading.Lock()
        self.counters = {"requests_total": 0, "generation_tokens_total": 0}
        self.load_s = time.monotonic() - t0
        logger.info("fallback runtime ready in %.1fs (%s on %s)",
                    self.load_s, self.served_name, self.device)

    def stream_tokens(self, token_ids: list[int], max_tokens: int,
                      temperature: float, seed: int = 0,
                      ignore_eos: bool = False):
        """Yield generated token ids one at a time; the generator's
        ``finish`` attribute-carrier is returned via StopIteration
        value ("stop" on EOS, "length" on cutoff).  The EOS token
        itself is never emitted (OpenAI semantics)."""
        torch = self.torch
        eos = getattr(self.tokenizer, "eos_token_id", None)
        gen = torch.Generator(self.device).manual_seed(seed or 0)
        ids = torch.tensor([token_ids], dtype=torch.long, device=self.device)
        finish = "length"
        try:
            past = None
            cur = ids
            for _ in range(max_tokens):
                # lock per STEP, never across a yield: the consumer does
                # network I/O between tokens, and a stalled SSE client
                # must not stall every other request
                with self.lock, torch.no_grad():
                    res = self.model(cur, past_key_values=past,
                                     use_cache=True)
                past = res.past_key_values
                logits = res.logits[0, -1]
                if temperature and temperature > 0.0:
                    probs = torch.softmax(logits / temperature, dim=-1)
                    nxt = int(torch.multinomial(probs, 1, generator=gen))
                else:
                    nxt = int(torch.argmax(logits))
                if eos is not None and nxt == eos and not ignore_eos:
                    finish = "stop"
                    break
                with self.counters_lock:
                    self.counters["generation_tokens_total"] += 1
                yield nxt
                cur = torch.tensor([[nxt]], dtype=torch.long, device=self.device)
        finally:
            # counted even when the consumer disconnects mid-stream
            with self.counters_lock:
                self.counters["requests_total"] += 1
        return finish

    def generate(self, token_ids: list[int], max_tokens: int,
                 temperature: float, seed: int = 0,
                 ignore_eos: bool = False) -> tuple[list[int], str]:
        """Collect stream_tokens: (tokens, finish_reason)."""
        out: list[int] = []
        it = self.stream_tokens(token_ids, max_tokens, temperature,
                                seed=seed, ignore_eos=ignore_eos)
        while True:
            try:
                out.append(next(it))
            except StopIteration as s:
                return out, s.value or "length"


def make_fallback_server(state: FallbackState, host: str = "0.0.0.0",
                         port: int = 5000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code: int, body: dict):
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok",
                                 "runtime": "transformers-fallback",
                                 "device": str(state.device)})
            elif self.path == "/v1/models":
                self._json(200, {"object": "list", "data": [
                    {"id": state.served_name, "object": "model",
                     "owned_by": "kaito-tpu-fallback"}]})
            elif self.path == "/metrics":
                with state.counters_lock:
                    snapshot = dict(state.counters)
                lines = [f"kaito:{k} {v}" for k, v in snapshot.items()]
                data = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "invalid JSON"})
            chat = self.path == "/v1/chat/completions"
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                return self._json(404, {"error": f"no route {self.path}"})
            if chat:
                messages = body.get("messages") or []
                apply = getattr(state.tokenizer, "apply_chat_template", None)
                try:
                    prompt = apply(messages, tokenize=False,
                                   add_generation_prompt=True)
                except Exception:
                    prompt = "".join(
                        f"<|{m.get('role', 'user')}|>\n"
                        f"{m.get('content', '')}\n" for m in messages
                    ) + "<|assistant|>\n"
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
            toks = state.tokenizer.encode(prompt)
            max_tokens = int(body.get("max_tokens", 16))
            if len(toks) + max_tokens > state.max_model_len:
                return self._json(400, {"error": {
                    "message": f"prompt+max_tokens exceeds "
                               f"{state.max_model_len}",
                    "type": "invalid_request_error"}})
            if body.get("stream"):
                return self._stream(chat, toks, max_tokens, body)
            out, finish = state.generate(
                toks, max_tokens, float(body.get("temperature", 1.0)),
                seed=int(body.get("seed", 0) or 0),
                ignore_eos=bool(body.get("ignore_eos", False)))
            text = state.tokenizer.decode(out)
            rid = f"cmpl-{uuid.uuid4().hex[:20]}"
            usage = {"prompt_tokens": len(toks),
                     "completion_tokens": len(out),
                     "total_tokens": len(toks) + len(out)}
            if chat:
                self._json(200, {
                    "id": rid, "object": "chat.completion",
                    "model": state.served_name,
                    "choices": [{"index": 0, "finish_reason": finish,
                                 "message": {"role": "assistant",
                                             "content": text}}],
                    "usage": usage})
            else:
                self._json(200, {
                    "id": rid, "object": "text_completion",
                    "model": state.served_name,
                    "choices": [{"index": 0, "text": text,
                                 "finish_reason": finish}],
                    "usage": usage})

        def _stream(self, chat: bool, toks: list[int], max_tokens: int,
                    body: dict):
            """SSE streaming (OpenAI chunk shape), one token per event."""
            rid = f"cmpl-{uuid.uuid4().hex[:20]}"
            obj = "chat.completion.chunk" if chat else "text_completion"
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def emit(payload: dict):
                self.wfile.write(b"data: " + json.dumps(payload).encode()
                                 + b"\n\n")
                self.wfile.flush()

            it = state.stream_tokens(
                toks, max_tokens, float(body.get("temperature", 1.0)),
                seed=int(body.get("seed", 0) or 0),
                ignore_eos=bool(body.get("ignore_eos", False)))
            finish = "length"
            out_toks: list[int] = []
            prev_text = ""
            try:
                if chat:
                    # OpenAI chat streams open with the role delta
                    emit({"id": rid, "object": obj,
                          "model": state.served_name,
                          "choices": [{"index": 0, "finish_reason": None,
                                       "delta": {"role": "assistant"}}]})
                while True:
                    try:
                        tok = next(it)
                    except StopIteration as s:
                        finish = s.value or "length"
                        break
                    out_toks.append(tok)
                    # incremental full-sequence decode: per-id decode
                    # garbles multi-byte codepoints / SentencePiece
                    # space markers (see engine token_surface_forms)
                    text = state.tokenizer.decode(out_toks)
                    piece, prev_text = text[len(prev_text):], text
                    if chat:
                        choice = {"index": 0, "finish_reason": None,
                                  "delta": {"content": piece}}
                    else:
                        choice = {"index": 0, "finish_reason": None,
                                  "text": piece}
                    emit({"id": rid, "object": obj,
                          "model": state.served_name, "choices": [choice]})
                final = {"index": 0, "finish_reason": finish}
                if chat:
                    final["delta"] = {}
                else:
                    final["text"] = ""
                emit({"id": rid, "object": obj, "model": state.served_name,
                      "choices": [final]})
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass     # client went away mid-stream
            finally:
                it.close()

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaito-tpu-hf-fallback")
    ap.add_argument("--model", required=True,
                    help="local checkpoint dir or cached HF id")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-model-len", type=int, default=2048)
    ap.add_argument("--served-model-name", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda raises without a card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    state = FallbackState(args.model, max_model_len=args.max_model_len,
                          served_name=args.served_model_name, device=args.device)
    srv = make_fallback_server(state, host=args.host, port=args.port)
    logger.info("fallback runtime serving %s on %s:%d", state.served_name,
                args.host, args.port)
    srv.serve_forever()


if __name__ == "__main__":
    main()
