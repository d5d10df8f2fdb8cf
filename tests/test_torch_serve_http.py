"""The port's HTTP serving front end (serve_http.py) on the CPU: the cases of
tests/test_serve_http.py for the port's ``Engine`` (coalescing, shape bucketing,
finish_reason, speculative == plain, chunked == one-shot, continuous == one-shot,
streaming), the server over loopback (an in-process ``ThreadingHTTPServer`` on
127.0.0.1, port 0), the greedy answers of the JAX server's ``Engine`` on the same
weights, and the import rule for the modules of serving.

Greedy texts are compared exactly (fp32 tiny models)."""

import importlib
import json
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu_torch import serve_http
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
gen_mod = importlib.import_module("llama_x_tpu_torch.models.generate")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
DRAFT = dict(num_layers=1, embed_dim=32, num_heads=2, num_kv_heads=2, head_dim=16, intermediate_dim=64)


@pytest.fixture(scope="module")
def weights():
    """The JAX server test's tiny model (vocab 512 holds the byte tokenizer's ids) and a
    1-layer draft, as (JAX params, JAX config, port model) each."""
    out = []
    for seed, extra in ((0, {}), (1, DRAFT)):
        kw = dict(max_seq_len=128, vocab_size=512, **extra)
        params = jllama.init(jax.random.PRNGKey(seed), jllama.tiny_config(**kw), dtype=jnp.float32)
        out.append((params, jllama.tiny_config(**kw),
                    params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**kw), device="cpu")))
    return out


def _engine(weights, draft=False, extra_args=()):
    args = serve_http.build_parser().parse_args([
        "--geometry", "tiny", "--device", "cpu", "--tokenizer", "byte", "--prompt_multiple", "16",
        "--tokens_multiple", "8", "--batch_window_ms", "300", *extra_args])
    return serve_http.Engine(args, _preloaded=weights[0][2], _preloaded_draft=weights[1][2] if draft else None)


def test_engine_coalesces_concurrent_requests(weights):
    """Two requests within the batching window share ONE generate call, and each row
    equals a solo run of its prompt."""
    eng = _engine(weights)
    results = {}

    def go(name, prompt):
        results[name] = eng.complete([prompt], max_tokens=6, **GREEDY)

    threads = [threading.Thread(target=go, args=a) for a in (("a", "hello"), ("b", "a much longer prompt"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert eng.generate_calls == 1
    assert eng.complete(["hello"], max_tokens=6, **GREEDY)[0] == results["a"][0]


def test_engine_buckets_shapes_and_reports_finish_reason(weights, monkeypatch):
    """Prompt lengths and max_tokens inside one bucket give one shape; "stop" iff eos
    came inside the requested window."""
    eng = _engine(weights, extra_args=("--decode_chunk", "0"))
    shapes = []
    orig = gen_mod.generate

    def spy(model, prompt, **kw):
        shapes.append((tuple(prompt.shape), kw["max_new_tokens"]))
        return orig(model, prompt, **kw)

    monkeypatch.setattr(gen_mod, "generate", spy)
    eng.complete(["hi"], max_tokens=3, **GREEDY)
    eng.complete(["a longer one"], max_tokens=7, **GREEDY)
    assert shapes[0] == shapes[1] == ((1, 16), 8)

    eos = eng.tok.eos_id

    def fake(model, prompt, *, max_new_tokens, **kw):
        out = torch.full((prompt.shape[0], max_new_tokens), 65, dtype=torch.long)
        out[0, 2] = eos
        out[0, 3:] = eng.tok.pad_id
        return out

    monkeypatch.setattr(gen_mod, "generate", fake)
    _, counts, reasons = eng.complete(["stops early", "runs to length"], max_tokens=6, **GREEDY)
    assert reasons == ["stop", "length"] and counts == [2, 6]


@pytest.mark.parametrize("variant", [
    ("--decode_chunk", "4"),
    ("--continuous", "2", "--decode_chunk", "4"),
    ("--continuous", "2", "--decode_chunk", "4", "--prefill_chunk", "16", "--prefix_cache", "2"),
    ("--continuous", "2", "--decode_chunk", "4", "--prefix_cache", "2"),
    ("draft", "--gamma", "3"),
    ("draft", "--gamma", "8", "--continuous", "2", "--decode_chunk", "9"),
])
def test_engine_variants_match_one_shot(weights, variant):
    """Chunked decode, continuous batching (with chunked prefill and the prefix cache),
    speculative serving (one-shot, and continuous at gamma 8): the greedy texts, counts
    and reasons of a two-prompt request equal the one-shot ``generate`` path's."""
    prompts = ["continuous batching", "a second, longer prompt to batch and batch again"]
    want = _engine(weights, extra_args=("--decode_chunk", "0")).complete(prompts, max_tokens=9, **GREEDY)
    draft = variant[0] == "draft"
    eng = _engine(weights, draft=draft, extra_args=variant[1:] if draft else variant)
    got = eng.complete(prompts, max_tokens=9, **GREEDY)
    assert got == want
    again = eng.complete([prompts[1] + " again"], max_tokens=5, **GREEDY)  # a prefix hit where the cache is on
    assert again == _engine(weights, extra_args=("--decode_chunk", "0")).complete([prompts[1] + " again"],
                                                                                  max_tokens=5, **GREEDY)


def test_engine_continuous_late_join_streams(weights):
    """A request submitted while another is mid-decode joins the running batch; both
    equal their solo answers, and the first one's SSE deltas concatenate to its text."""
    eng = _engine(weights, extra_args=("--continuous", "2", "--decode_chunk", "2"))
    q: queue.Queue = queue.Queue()
    ra = eng.submit([eng.tok("streaming row", add_bos=True)], max_tokens=14, stream_q=q, **GREEDY)
    first = q.get(timeout=300)
    rb = eng.submit([eng.tok("late joiner", add_bos=True)], max_tokens=6, **GREEDY)
    assert rb.event.wait(timeout=300) and rb.error is None
    assert ra.event.wait(timeout=300) and ra.error is None
    pieces = "".join(first)
    while (d := q.get(timeout=60)) is not None:
        pieces += "".join(d)
    assert pieces == ra.texts[0]
    assert eng.complete(["late joiner"], max_tokens=6, **GREEDY)[0] == rb.texts


def test_engine_streaming_and_early_exit(weights, monkeypatch):
    """Per-chunk text deltas concatenate to the final text; once every row emitted its
    stop token, no further decode chunk runs."""
    eng = _engine(weights, extra_args=("--decode_chunk", "3"))
    q: queue.Queue = queue.Queue()
    req = eng.submit([eng.tok("streaming test", add_bos=True)], max_tokens=10, stream_q=q, **GREEDY)
    pieces = []
    while (d := q.get(timeout=120)) is not None:
        pieces.append(d[0])
    req.event.wait()
    assert req.error is None and len(pieces) >= 2 and "".join(pieces) == req.texts[0]

    eng = _engine(weights, extra_args=("--decode_chunk", "4", "--tokens_multiple", "64"))
    text0 = eng.complete(["early exit"], max_tokens=2, **GREEDY)[0][0]
    eos_id = eng.tok(text0)[-1]
    calls = []
    orig = gen_mod.decode_chunk
    monkeypatch.setattr(gen_mod, "decode_chunk", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    req = eng.submit([eng.tok("early exit", add_bos=True)], max_tokens=64, eos_id=eos_id, **GREEDY)
    req.event.wait()
    assert req.error is None and req.reasons[0] == "stop" and len(calls) <= 2


def test_engine_chat_fallback_template_and_eos(weights):
    eng = _engine(weights)
    ids = eng.encode_chat([{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}])
    assert ids[0] == eng.tok.bos_id
    assert eng.tok.decode(ids[1:]) == "system: be brief\nuser: hi\nassistant:"
    assert eng.chat_eos_id == eng.tok.eos_id
    req = eng.submit([ids], max_tokens=6, eos_id=eng.chat_eos_id, **GREEDY)
    req.event.wait()
    assert req.error is None and isinstance(req.texts[0], str)


def test_engine_answers_what_the_jax_engine_answers(weights):
    """The same weights through the JAX server's ``Engine`` and the port's: the greedy
    texts, counts and reasons of a two-prompt request are equal."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from serve_http import Engine as JEngine
        from serve_http import build_parser as jparser
    finally:
        sys.path.remove(str(REPO / "tools"))
    jargs = jparser().parse_args(["--model", "unused", "--tokenizer", "byte", "--prompt_multiple", "16",
                                  "--tokens_multiple", "8", "--batch_window_ms", "0", "--decode_chunk", "0"])
    params, jcfg, _ = weights[0]
    theirs = JEngine(jargs, _preloaded=(params, jcfg.replace(attn_impl="xla")))
    prompts = ["the same weights", "on two frameworks"]
    assert _engine(weights).complete(prompts, max_tokens=7, **GREEDY) == theirs.complete(prompts, max_tokens=7,
                                                                                          **GREEDY)


def test_http_server_over_loopback(weights):
    """/health, /v1/completions (one prompt, a batch, n, stop, an error) and
    /v1/chat/completions, plain and streamed (SSE ending in [DONE], the deltas equal to
    the plain answer), each answer with a finish_reason."""
    eng = _engine(weights, extra_args=("--continuous", "2", "--decode_chunk", "4", "--prefill_chunk", "16"))
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(eng))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(payload, path="/v1/completions"):
        req = urllib.request.Request(f"{base}{path}", json.dumps(payload).encode(), {"Content-Type": "application/json"})
        try:
            return json.load(urllib.request.urlopen(req, timeout=240))
        except urllib.error.HTTPError as e:  # a 400 carries a JSON error
            return json.load(e)

    def stream(payload, path):
        req = urllib.request.Request(f"{base}{path}", json.dumps({**payload, "stream": True}).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=240) as resp:
            assert resp.headers["Content-Type"].startswith("text/event-stream")
            lines = [ln for ln in resp.read().decode().splitlines() if ln.startswith("data: ")]
        assert lines[-1] == "data: [DONE]"
        return [json.loads(ln[6:]) for ln in lines[:-1]]

    try:
        health = json.load(urllib.request.urlopen(f"{base}/health", timeout=10))
        assert health["status"] == "ok" and health["device"] == "cpu"
        one = post({"prompt": "2+2=", "max_tokens": 6})
        assert len(one["choices"]) == 1 and one["choices"][0]["finish_reason"] in ("stop", "length")
        batch = post({"prompt": ["2+2=", "a longer prompt here"], "max_tokens": 6, "temperature": 0.5})
        assert [c["index"] for c in batch["choices"]] == [0, 1]
        assert len(post({"prompt": "2+2=", "max_tokens": 6, "n": 2, "temperature": 0.9})["choices"]) == 2
        assert len(post({"prompt": "2+2=", "max_tokens": 6, "stop": ["\x00"]})["choices"]) == 1
        assert "error" in post({"max_tokens": 4})
        chat = post({"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6}, "/v1/chat/completions")
        assert chat["choices"][0]["message"]["role"] == "assistant"
        assert chat["choices"][0]["finish_reason"] in ("stop", "length")
        events = stream({"prompt": "2+2=", "max_tokens": 6}, "/v1/completions")
        assert "".join(c.get("text", "") for e in events for c in e["choices"]) == one["choices"][0]["text"]
        assert events[-1]["choices"][0]["finish_reason"] == one["choices"][0]["finish_reason"]
        events = stream({"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6}, "/v1/chat/completions")
        text = "".join(c["delta"].get("content", "") for e in events for c in e["choices"])
        assert text == chat["choices"][0]["message"]["content"] and events[-1]["choices"][0]["finish_reason"]
    finally:
        server.shutdown()
        server.server_close()
        eng.sched.close()


def test_the_serving_modules_import_no_jax():
    """Importing the serving, speculative, HF and export modules and both command lines
    pulls in neither JAX nor the JAX package."""
    code = ("import sys; import llama_x_tpu_torch.serve.continuous, llama_x_tpu_torch.serve.speculative, "
            "llama_x_tpu_torch.models.speculative, llama_x_tpu_torch.models.hf, llama_x_tpu_torch.serve_http, "
            "llama_x_tpu_torch.export_checkpoint, llama_x_tpu_torch.generate_cli; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'llama_x_tpu', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip() == "[]"


def test_serve_http_main_answers_from_a_subprocess(tmp_path):
    """``python -m llama_x_tpu_torch.serve_http --geometry tiny --device cpu --port 0``: the
    command line builds its model, binds a free loopback port, prints it, and answers
    /health and a completion."""
    import os
    import re
    import signal

    env = dict(os.environ, PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}".rstrip(":"))
    proc = subprocess.Popen([sys.executable, "-m", "llama_x_tpu_torch.serve_http", "--geometry", "tiny", "--device",
                             "cpu", "--host", "127.0.0.1", "--port", "0", "--max_seq_len", "256", "--continuous", "2"],
                            cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        port = re.search(r"127\.0\.0\.1:(\d+)", line)
        assert port, line
        base = f"http://127.0.0.1:{port.group(1)}"
        assert json.load(urllib.request.urlopen(f"{base}/health", timeout=60))["status"] == "ok"
        req = urllib.request.Request(f"{base}/v1/completions", json.dumps({"prompt": "2+2=", "max_tokens": 5}).encode(),
                                     {"Content-Type": "application/json"})
        answer = json.load(urllib.request.urlopen(req, timeout=120))
        assert answer["choices"][0]["finish_reason"] in ("stop", "length")
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
