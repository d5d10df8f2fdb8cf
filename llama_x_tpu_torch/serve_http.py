"""HTTP serving front end: OpenAI-style /v1/completions and /v1/chat/completions (with
SSE streaming) over the port's generation (port of tools/serve_http.py).

One process, one model, the standard library's ``http.server``:

- ``prompt`` may be a string or a list of strings: a list runs as ONE ragged batch.
- ``temperature`` / ``top_k`` / ``top_p`` / ``min_p`` / ``max_tokens`` map onto the
  sampler; ``n`` returns n samples per prompt (replicated rows of one batch); ``stop``
  (a string or a list) cuts each completion at its first stop sequence.
- Weights: ``--model`` (a local HF checkpoint directory), ``--resume`` (a run of the
  port's trainers; int8 / LoRA / DoRA tensors serve as they are) or ``--geometry``
  (random weights at a published width); the int8 KV cache with ``--kv_dtype int8``;
  speculative decoding with ``--draft_model`` / ``--draft_resume`` and ``--gamma``.
- CONCURRENT requests COALESCE: a worker thread takes every queued request with the same
  sampling signature into one ragged batch and splits the rows back. Prompt length rounds
  up to ``--prompt_multiple``, max_tokens to ``--tokens_multiple`` and the batch to a power
  of two, as the JAX server buckets its compiled shapes (here they only bound the shapes
  a card sees).
- ``--continuous N``: continuous batching over N slots (serve/continuous.py, with
  ``--prefix_cache`` and ``--prefill_chunk``; with a draft, serve/speculative.py): each row
  joins the running batch at a chunk boundary and leaves when done.

    python -m llama_x_tpu_torch.serve_http --geometry tiny --device cpu --port 8000
    python -m llama_x_tpu_torch.serve_http --model /data/llama31-8b --tokenizer llama3 \\
        --tokenizer_path /data/llama31-8b/original/tokenizer.model --continuous 8 --prefill_chunk 512
    curl -s localhost:8000/v1/completions -d '{"prompt": "2+2=", "max_tokens": 16}'

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch


def next_multiple(x: int, n: int) -> int:
    return (x + n - 1) // n * n


def next_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def stream_safe(text: str) -> str:
    """Hold back a possibly incomplete trailing character: a partial UTF-8 sequence
    decodes to U+FFFD characters that merge into one real character once the rest
    arrives, and a streamed delta must only ever extend the text (the final flush sends
    whatever never completed)."""
    n = 0
    while text and text[-1] == "�" and n < 3:
        text = text[:-1]
        n += 1
    return text


class _Request:
    """One client request in the coalescing queue."""

    def __init__(self, rows, max_tokens, sig, stream_q=None):
        self.rows = rows  # token-id lists
        self.max_tokens = max_tokens
        self.sig = sig  # (temperature, top_k, top_p, min_p, eos_id): batchable iff equal
        self.stream_q = stream_q  # queue.Queue of per-row text deltas; None = one answer
        self.event = threading.Event()
        self.texts = self.counts = self.reasons = None
        self.queue_ms = self.ttft_ms = None  # the slowest row's wait for a slot and first token (continuous)
        self.error = None

    def usage(self, completion_tokens: int, t0: float) -> dict:
        """A non-streaming answer's ``usage``: the tokens, the wall since ``t0`` and, from the
        rows' times where the scheduler served them, ``queue_ms`` and ``ttft_ms``."""
        out = {"completion_tokens": completion_tokens, "wall_seconds": round(time.perf_counter() - t0, 3)}
        if self.queue_ms is not None:
            out.update(queue_ms=round(self.queue_ms, 3), ttft_ms=round(self.ttft_ms, 3))
        return out


class _Tagged:
    """Routes one row's token deltas into a request's shared queue as (row, item)."""

    def __init__(self, q, i):
        self.q, self.i = q, i

    def put(self, item):
        self.q.put((self.i, item))


class Engine:
    """Model + tokenizer + a coalescing worker (or a continuous scheduler): one batch on
    the device at a time, shared by every queued request of the same sampling signature.
    ``_preloaded`` / ``_preloaded_draft``: models built by the caller (tests, the chip
    smoke), used in place of the flags' sources. ``generate_calls`` counts batches."""

    def __init__(self, args, _preloaded=None, _preloaded_draft=None):
        from llama_x_tpu_torch.data.tokenizers import get_tokenizer
        from llama_x_tpu_torch.generate_cli import load_source
        from llama_x_tpu_torch.utils.device import resolve_device

        self.args = args
        self.tok = get_tokenizer(args.tokenizer, args.tokenizer_path)
        self.model = _preloaded if _preloaded is not None else load_source(
            args.model, args.resume, args.geometry, args, resolve_device(args.device))
        self.config = self.model.config
        self.device = self.model.device
        self.draft_model = _preloaded_draft
        if self.draft_model is None and (args.draft_model or args.draft_resume):
            self.draft_model = load_source(args.draft_model, args.draft_resume, None, args, self.device)
        if self.draft_model is not None and self.draft_model.config.vocab_size != self.config.vocab_size:
            raise ValueError("the draft and the target must share the tokenizer's vocabulary")
        self.gamma = args.gamma
        self.cache_dtype = torch.int8 if args.kv_dtype == "int8" else torch.bfloat16
        self.seed = args.seed
        self.generate_calls = 0

        self.sched = None
        if args.continuous:
            common = dict(n_slots=args.continuous, chunk_size=args.decode_chunk or 16,
                          prompt_multiple=args.prompt_multiple, cache_dtype=self.cache_dtype,
                          pad_id=self.tok.pad_id, seed=args.seed)
            if self.draft_model is not None:
                from llama_x_tpu_torch.serve.speculative import SpeculativeScheduler

                # chunk_size counts ROUNDS (each up to gamma + 1 tokens a row): keep a chunk
                # about decode_chunk tokens long
                common["chunk_size"] = max(1, common["chunk_size"] // (self.gamma + 1))
                self.sched = SpeculativeScheduler(self.model, self.draft_model, gamma=self.gamma, **common)
            else:
                from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

                self.sched = ContinuousScheduler(self.model, **common, prefix_cache=args.prefix_cache,
                                                 prefill_chunk=args.prefill_chunk)
        self._queue: list[_Request] = []
        self._cond = threading.Condition()
        self._worker = threading.Thread(target=self._run_worker, daemon=True)
        self._worker.start()

    # ---- client side -----------------------------------------------------------

    def encode_chat(self, messages) -> list[int]:
        """Chat messages -> prompt ids: the Llama-3 instruct template where the tokenizer
        has one, else a role-prefixed plain transcript."""
        if not messages or not all(isinstance(m, dict) and m.get("role") and isinstance(m.get("content"), str)
                                   for m in messages):
            raise ValueError("messages must be [{role, content}, ...]")
        if hasattr(self.tok, "apply_chat_template"):
            return self.tok.apply_chat_template(messages)
        text = "".join(f"{m['role']}: {m['content'].strip()}\n" for m in messages)
        return self.tok(text + "assistant:", add_bos=True)

    @property
    def chat_eos_id(self) -> int:
        return getattr(self.tok, "eot_id", self.tok.eos_id)

    def submit(self, rows: list[list[int]], max_tokens: int, temperature: float, top_k: int, top_p: float,
               min_p: float = 0.0, eos_id: int | None = None, stream_q=None) -> _Request:
        """Queue pre-tokenized rows for the worker (or the scheduler). Does not block."""
        longest = max(len(r) for r in rows)
        if longest >= self.config.max_seq_len:
            raise ValueError(f"longest prompt ({longest} tokens) fills the {self.config.max_seq_len} cache")
        sig = (temperature, top_k, top_p, min_p, self.tok.eos_id if eos_id is None else eos_id)
        req = _Request(rows, max_tokens, sig, stream_q=stream_q)
        if self.sched is not None:
            return self._submit_continuous(req)
        with self._cond:
            self._queue.append(req)
            self._cond.notify()
        return req

    def _submit_continuous(self, req: _Request) -> _Request:
        """Each row becomes a tenant of the scheduler; a collector thread assembles the
        request's answer from the rows' token streams."""
        temperature, top_k, top_p, min_p, eos_id = req.sig
        mux: queue.Queue = queue.Queue()
        handles = [self.sched.submit(row, req.max_tokens, sampling=(temperature, top_k, top_p, min_p), eos_id=eos_id,
                                     stream_q=_Tagged(mux, i)) for i, row in enumerate(req.rows)]
        threading.Thread(target=self._collect_continuous, args=(req, handles, mux, eos_id), daemon=True).start()
        return req

    def _collect_continuous(self, req: _Request, handles, mux, eos_id: int):
        """texts / counts / reasons (and text deltas for a streaming request) from the
        scheduler's per-row token streams."""
        try:
            n = len(handles)
            toks: list[list[int]] = [[] for _ in range(n)]
            prev = [""] * n
            live = n
            while live:
                i, item = mux.get()
                if item is None:
                    live -= 1
                    continue
                toks[i].extend(item)
                if req.stream_q is not None:
                    text = stream_safe(self.tok.decode([t for t in toks[i] if t not in (self.tok.pad_id, eos_id)]))
                    deltas = [""] * n
                    deltas[i] = text[len(prev[i]):]
                    prev[i] = text
                    if any(deltas):
                        req.stream_q.put(deltas)
            for h in handles:
                h.event.wait()
                if h.error is not None:
                    raise h.error
            kept = [[t for t in h.tokens if t not in (self.tok.pad_id, eos_id)] for h in handles]
            req.texts = [self.tok.decode(k) for k in kept]
            if req.stream_q is not None:  # what stream_safe held back
                finals = [t[len(p):] for t, p in zip(req.texts, prev)]
                if any(finals):
                    req.stream_q.put(finals)
            req.counts = [len(k) for k in kept]
            req.reasons = [h.finish_reason for h in handles]
            req.queue_ms = max(h.t_slot - h.t_submit for h in handles) / 1e6
            req.ttft_ms = max(h.t_first - h.t_submit for h in handles) / 1e6
        except Exception as e:  # delivered to the waiter
            req.error = e
        finally:
            if req.stream_q is not None:
                req.stream_q.put(None)
            req.event.set()

    def complete(self, prompts: list[str], max_tokens: int, temperature: float, top_k: int, top_p: float,
                 min_p: float = 0.0):
        """Tokenize, queue, wait -> (texts, counts, reasons) per row; a reason is "stop"
        (the model emitted eos) or "length"."""
        req = self.run([self.tok(p, add_bos=True) for p in prompts], max_tokens, temperature, top_k, top_p, min_p)
        return req.texts, req.counts, req.reasons

    def run(self, rows: list[list[int]], max_tokens: int, temperature: float, top_k: int, top_p: float,
            min_p: float = 0.0, eos_id: int | None = None) -> _Request:
        """Queue pre-tokenized rows and wait -> the finished request (its error raised)."""
        req = self.submit(rows, max_tokens, temperature, top_k, top_p, min_p, eos_id)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req

    # ---- worker side -----------------------------------------------------------

    def _run_worker(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
            if self.args.batch_window_ms:  # let a burst arrive, so that it shares one batch
                time.sleep(self.args.batch_window_ms / 1e3)
            with self._cond:
                sig = self._queue[0].sig
                group = [r for r in self._queue if r.sig == sig]
                self._queue = [r for r in self._queue if r.sig != sig]
            try:
                with torch.inference_mode():
                    self._run_batch(group, sig)
            except Exception as e:  # delivered to every waiter
                for r in group:
                    r.error = e
            finally:
                for r in group:
                    if r.stream_q is not None:
                        r.stream_q.put(None)
                    r.event.set()

    def _run_batch(self, group: list[_Request], sig):
        from llama_x_tpu_torch.models import generate as gen_mod
        from llama_x_tpu_torch.models import speculative as spec_mod

        temperature, top_k, top_p, min_p, eos_id = sig
        rows = [r for req in group for r in req.rows]
        speculative = self.draft_model is not None
        P = next_multiple(max(len(r) for r in rows), self.args.prompt_multiple)
        slack = (self.gamma + 1) if speculative else 0
        P = min(P, self.config.max_seq_len - slack - 1)
        budget = self.config.max_seq_len - P - slack
        if speculative:
            budget = min(budget, self.draft_model.config.max_seq_len - P - self.gamma)
        if budget < 1:
            raise ValueError(f"prompts of length {max(len(r) for r in rows)} leave no decode budget")
        n_new = min(next_multiple(max(req.max_tokens for req in group), self.args.tokens_multiple), budget)
        B = next_pow2(len(rows))

        padded = torch.full((B, P), self.tok.pad_id, dtype=torch.long)
        lens = torch.ones(B, dtype=torch.long)  # filler rows: 1-token prompts, output dropped
        padded[:, 0] = rows[0][0]
        for i, r in enumerate(rows):
            padded[i, : len(r)] = torch.tensor(r[:P])
            lens[i] = min(len(r), P)
        padded, lens = padded.to(self.device), lens.to(self.device)

        self.seed += 1
        self.generate_calls += 1
        common = dict(max_new_tokens=n_new, generator=torch.Generator(device=self.device).manual_seed(self.seed),
                      temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p, eos_id=eos_id,
                      pad_id=self.tok.pad_id, prompt_lens=lens, cache_dtype=self.cache_dtype)
        streaming = [req for req in group if req.stream_q is not None]
        chunked = (streaming or self.args.decode_chunk > 0) and not speculative

        def push_deltas(out, prev_texts):
            """Each streaming request's rows' new text since the last chunk."""
            at = 0
            for req in group:
                if req.stream_q is not None:
                    deltas = []
                    for i, row in enumerate(out[at: at + len(req.rows), : req.max_tokens].tolist()):
                        text = self.tok.decode([t for t in row if t not in (self.tok.pad_id, eos_id)])
                        prev = prev_texts.setdefault(req, [""] * len(req.rows))
                        deltas.append(text[len(prev[i]):])
                        prev[i] = text
                    if any(deltas):
                        req.stream_q.put(deltas)
                at += len(req.rows)

        if chunked:
            # resumable decode: stops once every row is done, streams text per chunk
            prev_texts: dict = {}
            blocks = []
            for block in gen_mod.generate_stream(self.model, padded, chunk_size=self.args.decode_chunk or 16, **common):
                blocks.append(block.cpu())
                if streaming:
                    push_deltas(torch.cat(blocks, dim=1), prev_texts)
            out = torch.cat(blocks, dim=1)
            if out.shape[1] < n_new:  # stopped early: the missing columns are pad
                out = torch.cat([out, torch.full((B, n_new - out.shape[1]), self.tok.pad_id, dtype=out.dtype)], dim=1)
        else:
            if speculative:
                out, _ = spec_mod.generate_speculative(self.model, self.draft_model, padded, gamma=self.gamma,
                                                       **common)
            else:
                out = gen_mod.generate(self.model, padded, **common)
            out = torch.as_tensor(out).cpu()
            if streaming:  # no chunk stream on this path: one final delta
                push_deltas(out, {})

        at = 0
        for req in group:
            texts, counts, reasons = [], [], []
            for row in out[at: at + len(req.rows), : req.max_tokens].tolist():
                toks = [int(t) for t in row if t not in (self.tok.pad_id, eos_id)]
                texts.append(self.tok.decode(toks))
                counts.append(len(toks))
                reasons.append("stop" if eos_id in row else "length")  # eos inside the window
            req.texts, req.counts, req.reasons = texts, counts, reasons
            at += len(req.rows)


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # access logs to stderr, not stdout
            print(f"{self.address_string()} {fmt % a}", file=sys.stderr)

        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok", "model": f"llama-x-tpu torch ({engine.config.num_layers}L)",
                                  "device": str(engine.device), "speculative": engine.draft_model is not None})
            else:
                self._reply(404, {"error": "unknown path"})

        def _sse_event(self, obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        def _stream(self, rows, sampling, chat: bool, eos_id=None):
            """SSE answer: one event per chunk with per-choice text deltas, then a finish
            event and the OpenAI "[DONE]" terminator."""
            q: queue.Queue = queue.Queue()
            req = engine.submit(rows, eos_id=eos_id, stream_q=q, **sampling)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            obj = "chat.completion.chunk" if chat else "text_completion.chunk"
            while True:
                deltas = q.get()
                if deltas is None:
                    break
                self._sse_event({"object": obj, "choices": [
                    {"index": i, **({"delta": {"content": d}} if chat else {"text": d})}
                    for i, d in enumerate(deltas) if d]})
            req.event.wait()
            if req.error is not None:
                self._sse_event({"error": f"{type(req.error).__name__}: {req.error}"})
            else:
                self._sse_event({"object": obj, "choices": [
                    {"index": i, "finish_reason": fr, **({"delta": {}} if chat else {"text": ""})}
                    for i, fr in enumerate(req.reasons)]})
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

        @staticmethod
        def _parse_sampling(req):
            return dict(max_tokens=int(req.get("max_tokens", 64)), temperature=float(req.get("temperature", 0.0)),
                        top_k=int(req.get("top_k", 0)), top_p=float(req.get("top_p", 1.0)),
                        min_p=float(req.get("min_p", 0.0)))

        @staticmethod
        def _apply_stop(texts, reasons, stop):
            cut, creas = [], []
            for t, fr in zip(texts, reasons):
                idxs = [t.index(sq) for sq in stop if sq in t]
                cut.append(t[: min(idxs)] if idxs else t)
                creas.append("stop" if idxs else fr)
            return cut, creas

        def do_POST(self):
            try:
                req = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0))))
                if self.path in ("/v1/completions", "/completions"):
                    self._completions(req)
                elif self.path in ("/v1/chat/completions", "/chat/completions"):
                    self._chat(req)
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as e:  # the client gets the error
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

        def _completions(self, req):
            prompt = req.get("prompt", "")
            prompts = prompt if isinstance(prompt, list) else [prompt]
            if not prompts or not all(isinstance(p, str) and p for p in prompts):
                raise ValueError("prompt required")
            n = int(req.get("n", 1))
            if not 1 <= n <= 64:
                raise ValueError("n must be in [1, 64]")
            stop = req.get("stop") or []
            stop = [stop] if isinstance(stop, str) else list(stop)
            sampling = self._parse_sampling(req)
            if req.get("stream"):
                self._stream([engine.tok(p, add_bos=True) for p in prompts * n], sampling, chat=False)
                return
            t0 = time.perf_counter()
            r = engine.run([engine.tok(p, add_bos=True) for p in prompts * n], **sampling)
            texts, counts, reasons = r.texts, r.counts, r.reasons
            if stop:
                texts, reasons = self._apply_stop(texts, reasons, stop)
            self._reply(200, {
                "object": "text_completion",
                "choices": [{"index": i, "text": t, "finish_reason": fr}
                            for i, (t, fr) in enumerate(zip(texts, reasons))],
                "usage": r.usage(sum(counts), t0),
            })

        def _chat(self, req):
            rows = [engine.encode_chat(req.get("messages"))]
            stop = req.get("stop") or []
            stop = [stop] if isinstance(stop, str) else list(stop)
            sampling = self._parse_sampling(req)
            if req.get("stream"):
                self._stream(rows, sampling, chat=True, eos_id=engine.chat_eos_id)
                return
            t0 = time.perf_counter()
            r = engine.run(rows, eos_id=engine.chat_eos_id, **sampling)
            texts, reasons = r.texts, r.reasons
            if stop:
                texts, reasons = self._apply_stop(texts, reasons, stop)
            self._reply(200, {
                "object": "chat.completion",
                "choices": [{"index": 0, "message": {"role": "assistant", "content": texts[0]},
                             "finish_reason": reasons[0]}],
                "usage": r.usage(r.counts[0], t0),
            })

    return Handler


def build_parser() -> argparse.ArgumentParser:
    from llama_x_tpu_torch.generate_cli import GEOMETRIES

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--model", help="a local HF checkpoint directory")
    src.add_argument("--resume", help="a run directory of the port's trainers (QLoRA tensors serve as they are)")
    src.add_argument("--geometry", choices=sorted(GEOMETRIES), help="random weights at this width, from --seed")
    draft = parser.add_mutually_exclusive_group()
    draft.add_argument("--draft_resume", help="a draft run directory: serve with speculative decoding")
    draft.add_argument("--draft_model", help="a draft HF checkpoint directory")
    parser.add_argument("--gamma", type=int, default=4, help="draft tokens per verify pass")
    parser.add_argument("--tokenizer", default="byte", choices=["llama2", "llama3", "byte"])
    parser.add_argument("--tokenizer_path")
    parser.add_argument("--quantize", choices=["int8"], help="int8 rowwise weights (--model, --geometry)")
    parser.add_argument("--dynamic_int8_act", action="store_true", help="int8 x int8 projections (an int8 base)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max_seq_len", type=int, default=0, help="KV cache length (0: the model's; 4096 random)")
    parser.add_argument("--kv_dtype", default="bf16", choices=["bf16", "int8"])
    parser.add_argument("--tokens_multiple", type=int, default=32, help="max_new_tokens rounds up to this")
    parser.add_argument("--prompt_multiple", type=int, default=64,
                        help="prompt length rounds up to this (coalescing); the prefix cache's alignment")
    parser.add_argument("--batch_window_ms", type=int, default=5, help="how long the worker waits for more requests")
    parser.add_argument("--continuous", type=int, default=0,
                        help="continuous batching over this many decode slots: requests join and leave the running "
                        "batch at chunk boundaries (0 = coalescing batches). With a draft the chunk step is "
                        "speculative rounds.")
    parser.add_argument("--prefix_cache", type=int, default=0,
                        help="with --continuous: keep K/V of up to this many aligned prompt prefixes and prefill only "
                        "the suffix of a prompt that shares one (0 = off)")
    parser.add_argument("--prefill_chunk", type=int, default=0,
                        help="with --continuous: admissions prefill this many prompt tokens per step, between the "
                        "co-tenants' decode chunks (0 = one prefill per admission)")
    parser.add_argument("--decode_chunk", type=int, default=32,
                        help="decode in chunks of this many tokens: streams SSE deltas and stops once every row is "
                        "done (0 = one generate() per batch; streaming requests force chunks)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    engine = Engine(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    mode = f"speculative gamma={engine.gamma}" if engine.draft_model is not None else "plain"
    print(f"serving on {args.host}:{server.server_address[1]} (POST /v1/completions, {mode}, {engine.device})",
          file=sys.stderr, flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
