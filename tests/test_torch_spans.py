"""The span recorder (utils/spans.py) and the spans of the serving path, on the CPU.

Held: spans nest under the span open on their thread and carry their request's id; the
bound keeps the newest spans and counts the dropped; a disabled recorder records nothing
and waits for no device (no span, no device interval, no synchronize); ``to_trace_ns``
puts a span on a ``torch.profiler`` trace's clock within 0.5 ms; a scheduler with chunked
prefill and the prefix cache stamps every request submit <= slot <= first <= done and
turns it into its two spans, one ``serve.prefill_chunk`` span a prefill dispatch and one
``serve.admit`` span an admission; rows left at the scheduler's close end as spans too;
the tokens are the same with the recorder on and off (plain and speculative);
``DeviceClock`` places each interval on the host clock through its anchor, keeps a slow
launch's cut, and reads only the intervals whose work has run (fake events: a CUDA event
exists only on the card); each graph replay of the worker is a ``device.replay`` interval
named after its graph, under the worker span that launched it; the HTTP server's usage
carries the slowest row's queue wait and first-token time."""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import pytest
import torch

from llama_x_tpu_torch import serve_http
from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.serve import continuous as tcont
from llama_x_tpu_torch.serve.speculative import SpeculativeScheduler
from llama_x_tpu_torch.utils import spans

torch.set_num_threads(2)
TIMEOUT = 300
GREEDY = (0.0, 0, 1.0, 0.0)


@pytest.fixture(scope="module")
def models():
    cfg = llama.tiny_config(max_seq_len=128)
    draft = llama.tiny_config(max_seq_len=128, num_layers=1)
    return (llama.init(cfg, seed=0, dtype=torch.float32, device="cpu"),
            llama.init(draft, seed=1, dtype=torch.float32, device="cpu"))


def _ids(seed, n, V=256):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, V, (n,), generator=g).tolist()


def _serve(sched, waves):
    """(ids, max_tokens, sampling) rows in waves, each wave waiting for the last -> the
    handles; the scheduler closed."""
    handles = []
    try:
        for wave in waves:
            rows = [sched.submit(ids, n, sampling=s) for ids, n, s in wave]
            for r in rows:
                assert r.event.wait(timeout=TIMEOUT) and r.error is None, r.error
            handles += rows
    finally:
        sched.close()
    return handles


def _of(rows):
    """The kept spans of these rows' requests, by request id and name."""
    ids = {r.id for r in rows}
    out = {}
    for s in spans.snapshot():
        if s.request in ids and s.name.startswith("request."):
            out.setdefault(s.request, {})[s.name] = s
    return out


class FakeEvent:
    """A CUDA event's interface on a fake device whose clock runs a second ahead of the
    host's (``spans.now``): an event runs when the stream reaches it, at the host's time or
    when the work queued before it ends (``busy_until``, host ns), whichever is later;
    ``done``: whether it has run."""

    OFFSET = 10**9
    busy_until = 0

    def __init__(self):
        self.t, self.done = None, True

    def record(self):
        self.t = max(spans.now(), FakeEvent.busy_until) + self.OFFSET

    def query(self):
        return self.done

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


def test_spans_nest_under_the_open_span_of_their_thread():
    rec = spans.Recorder()
    with rec.span("outer", request=7, slot=3) as outer:
        with rec.span("inner", bytes=12) as inner:
            pass
        rec.record("given", 1, 2, parent=outer.id, request=7)

    def other():
        with rec.span("elsewhere"):
            pass

    t = threading.Thread(target=other)
    with rec.span("open"):
        t.start()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    got = {s.name: s for s in rec.snapshot()}
    assert got["inner"].parent == outer.id and got["outer"].parent is None and got["given"].parent == outer.id
    assert got["elsewhere"].parent is None and got["elsewhere"].thread != got["open"].thread  # another thread's stack
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert (got["outer"].request, got["given"].request, got["inner"].request) == (7, 7, None)
    assert got["outer"].attrs == {"slot": 3} and got["inner"].attrs == {"bytes": 12}
    assert len({s.id for s in rec.snapshot()}) == 5 and got["inner"].thread == threading.get_ident()


def test_the_bound_keeps_the_newest_and_counts_the_dropped():
    rec = spans.Recorder(capacity=4)
    for i in range(10):
        rec.record(f"s{i}", i, i + 1)
    assert [s.name for s in rec.snapshot()] == ["s6", "s7", "s8", "s9"] and rec.lost == 6
    assert spans.RECORDER.spans.maxlen == spans.CAPACITY == 65536


def test_a_disabled_recorder_records_nothing():
    syncs = []
    clock = spans.DeviceClock(event=FakeEvent, synchronize=lambda: syncs.append(1))
    clock.bind()
    before = {s.id for s in spans.snapshot()}
    try:
        with spans.on_device("device.copy"):  # no anchor yet: no interval
            pass
        assert not clock.pending
        clock.settle()
        assert syncs == [1]
        spans.enable(False)
        assert not spans.RECORDER.on
        with spans.span("off", x=1):
            with spans.on_device("device.copy"):
                pass
        spans.record("off.given", 1, 2)
        clock.collect()
        clock.settle()
        assert not clock.pending and syncs == [1]  # off: the device is not waited for
    finally:
        spans.enable(True)
        clock.unbind()
    assert spans.RECORDER.on and {s.id for s in spans.snapshot()} <= before


def test_to_trace_ns_puts_a_span_on_the_profilers_clock():
    """A ``record_function`` range inside a program span, under a CPU profiler: mapped by
    ``to_trace_ns``, the span holds the range's kineto times to within 0.5 ms, with the
    3 ms slept before and after the range between them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("program.outer") as outer:
            time.sleep(0.003)
            with record_function("bench.inner"):
                time.sleep(0.004)
            time.sleep(0.003)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "bench.inner"]
    lo, hi = spans.to_trace_ns(outer.start), spans.to_trace_ns(outer.end)
    assert lo - 0.5e6 <= ev.start_ns() and ev.end_ns() <= hi + 0.5e6
    # at least the 3 ms slept on either side, less 0.5 ms: an offset of the clocks beyond it fails
    assert lo + 2.5e6 <= ev.start_ns() and ev.end_ns() <= hi - 2.5e6


def test_every_request_is_stamped_in_order_and_ends_as_its_spans(models):
    """Chunked prefill (16 tokens) and the prefix cache on 2 slots: a first wave, then a wave
    whose prompts extend the first's (prefix hits). Each row: submit <= slot <= first <=
    done, its two spans under its id at those times; one ``serve.prefill_chunk`` span a
    prefill dispatch (at least one a row, under its id), one ``serve.admit`` span an
    admission."""
    tm, _ = models
    t0 = spans.now()
    sched = tcont.ContinuousScheduler(tm, n_slots=2, chunk_size=4, prompt_multiple=16, cache_dtype=torch.float32,
                                      prefill_chunk=16, prefix_cache=4)
    a, b = _ids(1, 40), _ids(2, 21)
    rows = _serve(sched, [[(a, 6, GREEDY), (b, 5, GREEDY), (_ids(3, 9), 3, GREEDY)],
                          [(a + _ids(4, 7), 4, GREEDY), (b + _ids(5, 3), 5, GREEDY)]])
    got = _of(rows)
    for r in rows:
        assert r.t_submit <= r.t_slot <= r.t_first <= r.t_done and r.scheduler == sched.id
        q, p = (got[r.id][f"request.{n}"] for n in ("queue", "prefill"))
        assert (q.start, q.end, p.start, p.end) == (r.t_submit, r.t_slot, r.t_slot, r.t_first)
        assert set(got[r.id]) == {"request.queue", "request.prefill"}
        assert all(s.attrs == {"reached": True, "scheduler": sched.id} for s in (q, p))
    assert sched.prefix_tokens_reused > 0
    worker = [s for s in spans.snapshot() if s.thread == sched.worker.ident and s.start >= t0]
    by_name = {}
    for s in worker:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["serve.prefill_chunk"]) == sched.prefill_dispatches
    assert len(by_name["serve.admit"]) == sched.admissions == len(rows)
    assert len(by_name["serve.install"]) == len(rows) and len(by_name["serve.dispatch"]) == sched.dispatches
    assert {s.request for s in by_name["serve.admit"]} == {r.id for r in rows}
    chunks = [s.request for s in by_name["serve.prefill_chunk"]]
    assert all(chunks.count(r.id) >= 1 for r in rows) and len(chunks) > len(rows)
    assert set(by_name) == {"serve.admit", "serve.prefill_chunk", "serve.install", "serve.dispatch",
                            "request.queue", "request.prefill"}  # the rows end on the worker
    assert all(s.parent is None for n in ("serve.admit", "serve.prefill_chunk", "serve.dispatch")
               for s in by_name[n])


def test_rows_left_at_close_end_as_spans():
    """One slot, three long rows, the scheduler closed at once: every row ends as spans; a row
    never taken into the slot has its queue span ended at the close, unreached."""
    model = llama.init(llama.tiny_config(max_seq_len=128), seed=0, dtype=torch.float32, device="cpu")
    sched = tcont.ContinuousScheduler(model, n_slots=1, chunk_size=2, prompt_multiple=16, cache_dtype=torch.float32)
    rows = [sched.submit(_ids(10 + i, 12), 60) for i in range(3)]
    sched.close()
    assert not sched.worker.is_alive()
    got = _of(rows)
    assert set(got) == {r.id for r in rows}
    last = got[rows[-1].id]["request.queue"]
    assert not last.attrs["reached"] and last.end == rows[-1].t_done
    assert rows[-1].t_slot is None and "request.prefill" not in got[rows[-1].id]


@pytest.mark.parametrize("kind", ["plain", "speculative"])
def test_the_tokens_are_the_same_with_the_recorder_on_and_off(models, kind):
    tm, dm = models
    waves = [[(_ids(20, 30), 9, GREEDY), (_ids(21, 12), 7, (0.8, 20, 0.9, 0.0))], [(_ids(22, 18), 6, GREEDY)]]
    tokens = {}
    for on in (True, False):
        t0 = spans.now()
        spans.enable(on)
        try:
            if kind == "plain":
                sched = tcont.ContinuousScheduler(tm, n_slots=2, chunk_size=4, prompt_multiple=16, seed=5,
                                                  cache_dtype=torch.float32, prefill_chunk=16, prefix_cache=2)
            else:
                sched = SpeculativeScheduler(tm, dm, gamma=3, n_slots=2, chunk_size=2, prompt_multiple=16, seed=5,
                                             cache_dtype=torch.float32)
            rows = _serve(sched, waves)
        finally:
            spans.enable(True)
        tokens[on] = [r.tokens for r in rows]
        mine = [s for s in spans.snapshot()
                if s.start >= t0 and (s.thread == sched.worker.ident or s.request in {r.id for r in rows})]
        assert bool(mine) == on
    assert tokens[True] == tokens[False] and all(tokens[True])


def test_device_intervals_land_on_the_host_clock_once_their_work_has_run(monkeypatch):
    """On a host clock that moves only when the test says: a block of copies launched over 2
    ms on an idle device; a replay whose launch takes 3 ms on an idle device and queues 5 ms
    of work: it starts when the launch returns, the 3 ms after its start event kept as its
    cut; a replay launched while 20 ms of work are queued: it starts when that work ends,
    with no cut. Each lies on the host clock (the fake device's runs a second ahead); an
    interval whose work has not run stays pending."""
    host = [10**12]
    monkeypatch.setattr(spans, "now", lambda: host[0])
    monkeypatch.setattr(FakeEvent, "busy_until", 0)
    t0, ms = host[0], 1_000_000
    clock = spans.DeviceClock(event=FakeEvent, synchronize=lambda: None)
    clock.bind()
    try:
        clock.settle()
        with spans.span("serve.dispatch") as outer:
            with spans.on_device("device.copy"):
                host[0] += 2 * ms
            with spans.span("step.idle") as idle:
                with spans.on_device("device.replay", one_launch=True, graph="g", key=(4,)):
                    host[0] += 3 * ms
                    FakeEvent.busy_until = host[0] + 5 * ms
            FakeEvent.busy_until = host[0] + 20 * ms
            with spans.span("step.busy") as busy:
                with spans.on_device("device.replay", one_launch=True, graph="g", key=(8,)):
                    FakeEvent.busy_until += 5 * ms
        last = clock.pending[-1][5]
        last.done = False  # the second replay's work has not run yet: it stays pending
        clock.collect()
        assert len(clock.pending) == 1
        last.done = True
        clock.collect()
        assert not clock.pending and len(clock.free) == 6
    finally:
        clock.unbind()
    mine = {s.parent: s for s in spans.snapshot() if s.parent in (outer.id, idle.id, busy.id)}
    copy, r_idle, r_busy = mine[outer.id], mine[idle.id], mine[busy.id]
    assert (copy.name, r_idle.name, r_busy.name) == ("device.copy", "device.replay", "device.replay")
    assert (copy.start, copy.end) == (t0, t0 + 2 * ms) and copy.attrs == {"stage": "serve.dispatch"}
    assert (r_idle.start, r_idle.end) == (t0 + 5 * ms, t0 + 10 * ms)
    assert (r_busy.start, r_busy.end) == (t0 + 25 * ms, t0 + 30 * ms)
    assert r_idle.attrs == {"graph": "g", "key": (4,), "stage": "serve.dispatch", "cut_ns": 3 * ms}
    assert r_busy.attrs["cut_ns"] == 0


class _StubGraph:
    def __init__(self, body, model, generator):
        self.body, self.model, self.generator = body, model, generator

    def replay(self):
        self.body(self.model, self.generator)


def test_a_replay_is_a_graph_replay_span_with_an_interval_a_replay(models, monkeypatch):
    """The runner's card path on CPU tensors (the capture stubbed) under a fake device clock:
    an admission, two decode chunks of 3 steps and a second admission of the first's key
    give a ``device.replay`` interval a replay (a capture runs its key's first step
    eagerly, with no interval), named after its graph and staged under the worker span that
    launched it; the admissions' fed inputs and the chunks' cleared cursor are
    ``device.copy`` intervals. The runners record no span of their own."""
    tm, _ = models

    def capture(self, model, name, buffers, body, own, draws):
        body(model, own)
        self.captures += 1
        return dg._Entry(dg.Captured(lambda: _StubGraph(body, model, own)), {t.data_ptr() for t in buffers})

    monkeypatch.setattr(dg, "on_card", lambda t: True)
    monkeypatch.setattr(dg.Runner, "_capture", capture)
    monkeypatch.setattr(FakeEvent, "busy_until", 0)
    state = tcont.init_state(tm.config, 2, torch.float32, "cpu")
    inputs = tcont.AdmitBuffers(tm, state[0])
    params = (torch.zeros(2), torch.zeros(2, dtype=torch.long), torch.ones(2), torch.zeros(2),
              torch.full((2,), -1, dtype=torch.long), torch.full((2,), 9, dtype=torch.long))
    clock = spans.DeviceClock(event=FakeEvent, synchronize=lambda: None)
    clock.bind()
    try:
        clock.settle()
        with spans.span("serve.admit") as admit:
            tcont.admit_row(tm, state, inputs, 1, _ids(30, 10), GREEDY, -1, prompt_multiple=16)
        dispatches = []
        for _ in range(2):
            with spans.span("serve.dispatch") as d:
                tcont.decode_rows(tm, state, 3, None, *params)
            dispatches.append(d)
        with spans.span("serve.install"):  # the admission's key again: replayed, not captured
            tcont.admit_row(tm, state, inputs, 0, _ids(31, 12), GREEDY, -1, prompt_multiple=16)
        clock.settle()
    finally:
        clock.unbind()
    mine = [s for s in spans.snapshot() if s.start >= admit.start and s.thread == threading.get_ident()]
    ids = {s.id: s for s in mine}
    replays = [s for s in mine if s.name == "device.replay"]
    assert [(s.attrs["graph"], ids[s.parent].name) for s in replays] == (
        [("decode_rows step", "serve.dispatch")] * 5 + [("admit_row", "serve.install")])
    assert [sum(s.parent == d.id for s in replays) for d in dispatches] == [2, 3]
    assert all(s.attrs["stage"] == ids[s.parent].name and s.attrs["cut_ns"] >= 0 for s in replays)
    copies = [s for s in mine if s.name == "device.copy"]
    assert copies and all(ids[s.parent].name.startswith("serve.") for s in copies)
    assert {s.attrs["stage"] for s in copies} == {"serve.admit", "serve.dispatch", "serve.install"}
    assert not [s for s in mine if s.name.startswith("graph.")]


def test_http_usage_carries_the_slowest_rows_queue_wait_and_first_token():
    args = serve_http.build_parser().parse_args([
        "--geometry", "tiny", "--device", "cpu", "--tokenizer", "byte", "--max_seq_len", "128", "--continuous", "2",
        "--decode_chunk", "4", "--prompt_multiple", "16"])
    eng = serve_http.Engine(args)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(eng))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/completions"
        body = json.dumps({"prompt": "spans", "max_tokens": 4, "n": 3}).encode()
        req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
        usage = json.load(urllib.request.urlopen(req, timeout=TIMEOUT))["usage"]
    finally:
        server.shutdown()
        eng.sched.close()
    assert 0 <= usage["queue_ms"] <= usage["ttft_ms"] <= usage["wall_seconds"] * 1e3 + 1
    assert usage["completion_tokens"] > 0
