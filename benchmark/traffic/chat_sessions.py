"""Traffic kind ``chat_sessions``: an open loop of multi-turn chat sessions from
independent users, served by the program's continuous-batching scheduler in process.

The mix's parameters (a ``benchmark/traffic/<mix>.json`` of this kind): sessions start
at ``session_rate`` a second (exponential gaps); each has 1 to ``max_turns`` turns
(geometric with mean ``turns_mean`` before the cap); the next turn of a session is due
an exponential ``turn_gap_mean_s`` after the last one was due. A first turn's prompt is
lognormal (``prompt_median``, ``prompt_sigma``) in [``prompt_min``, ``prompt_max``]; a
later turn's prompt is the previous prompt, that turn's logged answer (seeded tokens of
its ``max_tokens``, as a replayed trace holds them) and a new user part, lognormal
(``user_median``, ``user_sigma``) in [``user_min``, ``user_max``]; a session ends before
its prompt would pass ``prompt_cap``. ``max_tokens`` is lognormal (``answer_median``,
``answer_sigma``) in [``answer_min``, ``answer_max``]; decoding is greedy with no stop
token, so every request runs to its ``max_tokens``.

Each quantity is drawn from a fixed set of quantiles of its distribution, in an order
drawn from the mix's ``schedule_seed``: every run seed offers the same sessions, arrivals
and lengths, and draws their token ids. (With the order drawn from the run's seed, the
95th-percentile TTFT of six seeds spread by half its median, while two runs of one seed
agreed within a few percent: the order changed the work in the window.) Requests due
within the window are sent and measured; each is timed from its due time. A traced run
goes on sending past the window's end and, once every request of the window is answered,
profiles the worker's last iterations under that load: from the parked worker, through
``trace_seconds`` of serving, to the scheduler's close (about a second in all), so that
the profiler delays no request of the window. What it reads is that stretch after the
window, not the window.

A sender thread submits each request at its due time and the scheduler's worker thread
delivers its tokens to the request's ``Recorder``; neither records a profiler range, and
the traced stretch holds the device's activity alone. The profiler starts while the worker
is parked (``parked``) and stops after the worker has ended: traced runs that started or
stopped it under the worker's graph replays hung on the card.
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time

import numpy as np


TAIL_S = 5.0  # the schedule runs this far past the window
TRACE_LOAD_S = 90.0  # a traced run's load after that, while the window's requests finish and the stretch is traced


def _quantiles(n: int, inv_cdf, lo=None, hi=None, cast=int) -> list:
    out = []
    for i in range(n):
        v = inv_cdf((i + 0.5) / n)
        if lo is not None:
            v = min(max(v, lo), hi)
        out.append(cast(round(v)) if cast is int else cast(v))
    return out


def _lognormal(median: float, sigma: float):
    d = statistics.NormalDist(np.log(median), sigma)
    return lambda p: float(np.exp(d.inv_cdf(p)))


def _exponential(mean: float):
    return lambda p: -mean * np.log(1.0 - p)


def _geometric(mean: float, cap: int):
    q = 1.0 - 1.0 / mean  # P(turns > k) = q^k

    def inv(p):
        k = 1
        while k < cap and p >= 1.0 - q**k:
            k += 1
        return k
    return inv


def generate(mix: dict, cfg: dict, seed: int, seconds: float) -> list[dict]:
    """The requests due in [0, ``seconds`` + ``TAIL_S``), in due order: {session, turn, due (s
    from the window's start), prompt (token ids), max_tokens}. The schedule comes from the
    mix's ``schedule_seed``, the token ids from ``seed``."""
    rng = np.random.default_rng(mix["schedule_seed"])
    ids = np.random.default_rng(int(seed) % (2**63))
    vocab = cfg["vocab_size"]
    seconds = seconds + TAIL_S
    n = max(1, int(round(mix["session_rate"] * seconds)))
    gaps = rng.permutation(_quantiles(n, _exponential(1.0 / mix["session_rate"]), cast=float))
    starts = np.cumsum(gaps) - gaps[0]
    turns = rng.permutation(_quantiles(n, _geometric(mix["turns_mean"], mix["max_turns"])))
    n_turns = int(sum(turns))
    firsts = rng.permutation(_quantiles(n, _lognormal(mix["prompt_median"], mix["prompt_sigma"]),
                                        mix["prompt_min"], mix["prompt_max"]))
    users = rng.permutation(_quantiles(n_turns, _lognormal(mix["user_median"], mix["user_sigma"]),
                                       mix["user_min"], mix["user_max"]))
    answers = rng.permutation(_quantiles(n_turns, _lognormal(mix["answer_median"], mix["answer_sigma"]),
                                         mix["answer_min"], mix["answer_max"]))
    turn_gaps = rng.permutation(_quantiles(n_turns, _exponential(mix["turn_gap_mean_s"]), cast=float))
    out, k = [], 0
    for s in range(n):
        due, prompt = float(starts[s]), ids.integers(0, vocab, int(firsts[s])).tolist()
        for t in range(int(turns[s])):
            if t:
                due += float(turn_gaps[k])
                answer = ids.integers(0, vocab, int(answers[k - 1])).tolist()
                user = ids.integers(0, vocab, int(users[k])).tolist()
                prompt = prompt + answer + user
            if len(prompt) > mix["prompt_cap"] or due >= seconds:
                k += int(turns[s]) - t
                break
            out.append(dict(session=s, turn=t, due=due, prompt=prompt, max_tokens=int(answers[k])))
            k += 1
    out.sort(key=lambda r: r["due"])
    return out


class Recorder:
    """The client end of a request's stream (``RowHandle.stream_q``): the arrival time and
    size of every delivery, and the time the stream closed."""

    def __init__(self):
        self.arrivals: list[tuple[float, int]] = []
        self.closed: float | None = None

    def put(self, item) -> None:
        now = time.perf_counter()
        if item is None:
            self.closed = now
        else:
            self.arrivals.append((now, len(item)))


@contextlib.contextmanager
def parked(sched, settle: float):
    """The scheduler's worker held at the top of its loop (its condition's lock taken, then
    ``settle`` seconds for the iteration it is in to end): the profiler starts and stops only
    while no other thread launches work. A profiler started or stopped under the worker's
    graph replays hung on the card."""
    with sched.cond:
        time.sleep(settle)
        yield


def percentile(values, q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = q * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (v[i + 1] - v[i]) * (x - i)


def run(ctx) -> dict:
    import torch

    from benchmark import port, weights
    from benchmark.trace import Window, span
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    cfg, mix, eng = ctx.cfg, ctx.mix, ctx.workload["engine"]
    requests = [r for r in generate(mix, cfg, ctx.seed, ctx.seconds) if ctx.trace or r["due"] < ctx.seconds]
    if ctx.trace:  # the load goes on past the schedule's tail while the traced stretch waits its turn
        more = generate(dict(mix, schedule_seed=mix["schedule_seed"] + 1), cfg, ctx.seed, TRACE_LOAD_S)
        requests += [dict(r, due=r["due"] + ctx.seconds + TAIL_S) for r in more]
    with span("bench.warmup"):
        model = port.build(cfg, weights.draw(cfg, ctx.seed, ctx.device), dict(dynamic_int8_act=True))
        sched = ContinuousScheduler(model, n_slots=eng["n_slots"], chunk_size=eng["chunk_size"],
                                    prompt_multiple=eng["prompt_multiple"], cache_dtype=torch.int8,
                                    prefill_chunk=eng["prefill_chunk"], prefix_cache=eng["prefix_cache"],
                                    seed=int(ctx.seed) % (2**63))
        # one prompt whose chunks start at every 512 up to the cache's end reaches every graph
        # key of the traffic: the first chunk, each continuation's kv bound, the install, the step
        rng = np.random.default_rng([int(ctx.seed) % (2**63), 1])
        warm = rng.integers(0, cfg["vocab_size"], eng["warmup_prompt"]).tolist()
        row = sched.submit(warm, eng["warmup_tokens"])
        row.event.wait()
        if row.error is not None:
            raise RuntimeError("the warm-up request failed") from row.error
        ctx.sync()

    def captures() -> int:
        runners = (dg.stats(model), sched.inputs.runner.stats(), dg.prefill_stats(model))
        return sum(r["captures"] for r in runners)

    ctx.setup_done()
    ctx.reset_peak()
    due = sum(r["due"] < ctx.seconds for r in requests)  # in due order: the window's come first
    recs = [Recorder() for _ in requests]
    rows: list = [None] * len(requests)
    sent = [None] * len(requests)
    stop = threading.Event()
    caps0, reused0 = captures(), sched.prefix_tokens_reused
    t0 = time.perf_counter()
    t_end = t0 + ctx.seconds

    def sender():
        for i, r in enumerate(requests):
            if stop.wait(max(0.0, t0 + r["due"] - time.perf_counter())):
                return
            sent[i] = time.perf_counter()
            rows[i] = sched.submit(r["prompt"], r["max_tokens"], stream_q=recs[i])

    thread = threading.Thread(target=sender, daemon=True)
    thread.start()
    time.sleep(max(0.0, t_end - time.perf_counter()))
    queued_at_end = len(sched.queue) + len(sched.admitting)
    caps1, reused1 = captures(), sched.prefix_tokens_reused
    deadline = time.perf_counter() + ctx.drain_seconds
    for row_ in rows[:due]:  # every request of the window answered, a minute past the close at most
        while row_ is None and time.perf_counter() < deadline:
            time.sleep(0.01)
        if row_ is not None:
            row_.event.wait(timeout=max(0.0, deadline - time.perf_counter()))
    traced = None
    if ctx.trace:
        # started with the worker parked, stopped once it has ended: a profiler started or
        # stopped while the worker replays graphs hung on the card
        traced = Window(host=False)
        with parked(sched, eng["park_seconds"]):
            traced.__enter__()
        time.sleep(eng["trace_seconds"])
    stop.set()
    thread.join()
    ctx.program_done()
    sched.close()
    if traced is not None:
        traced.__exit__(None, None, None)

    ttft, tpot, late, failed = [], [], [], 0
    delivered = 0
    admitted_prompt, prefilled, decoded, sampled = 0, [], [], 0
    done = []
    due = sum(r["due"] < ctx.seconds for r in requests)  # in due order: the window's come first
    for i, (r, rec, row) in enumerate(zip(requests[:due], recs, rows)):
        late.append((sent[i] - t0 - r["due"]) * 1e3)
        ok = row is not None and row.error is None and row.event.is_set() and len(row.tokens) == r["max_tokens"]
        if not rec.arrivals or not ok:
            failed += 1
            ttft.append(float("inf"))
            continue
        done.append((r, list(row.tokens)))
        first = rec.arrivals[0][0]
        ttft.append((first - t0 - r["due"]) * 1e3)
        n = sum(k for _, k in rec.arrivals)
        if n >= 2:
            tpot.append((rec.arrivals[-1][0] - first) / (n - 1) * 1e3)
        P, k = len(r["prompt"]), 0
        for t, m in rec.arrivals:
            for _ in range(m):
                if t <= t_end:
                    delivered += 1
                    if k == 0:
                        admitted_prompt += P
                        prefilled.append((0, P))
                    else:
                        decoded.append(P + k - 1)
                    sampled += 1
                k += 1
    window = ctx.seconds
    e2e = dict(ttft_p95_ms=percentile(ttft, 0.95), tpot_p95_ms=percentile(tpot, 0.95),
               serve_tokens_per_s=delivered / window)
    obs = dict(cfg=cfg, engine=eng, ttft_ms=ttft, late_ms=late, captures=caps1 - caps0,
               reused=reused1 - reused0, admitted_prompt=admitted_prompt, prefilled=prefilled, decoded=decoded,
               sampled=sampled, window_s=window, queued_at_end=queued_at_end,
               trace=None if traced is None else dict(summary=traced.summary))
    ctx.log(f"chat: {due} requests due in {window} s ({due / window:.3f}/s), {failed} failed, "
            f"{queued_at_end} queued or admitting at the window's end, captures in the window {caps1 - caps0}")
    del sched, model
    ctx.free()
    with span("bench.reference"):
        checks, extra = judge(ctx, done)
    return dict(e2e=e2e, obs=obs, checks=checks, attempted=due, failed=failed, extra=extra)


def judge(ctx, done: list) -> tuple[list, dict]:
    """The widest gap by which a served token's logit lies below the reference's best, over a
    sample of the finished requests drawn from the seed, the longest among them; with
    ``ctx.control`` also the control's: at each of those positions the gap of the token the
    reference at 4 bits puts first."""
    import torch

    from benchmark import weights
    from benchmark.reference import model as ref

    ref.no_tf32()
    eng = ctx.workload["engine"]
    rng = np.random.default_rng([int(ctx.seed) % (2**63), 2])
    order = sorted(range(len(done)), key=lambda i: -(len(done[i][0]["prompt"]) + len(done[i][1])))
    pick = order[:1] + sorted(rng.permutation(order[1:])[:eng["check_requests"] - 1].tolist())
    w = ref.Weights(ctx.cfg, weights.draw(ctx.cfg, ctx.seed, ctx.device))
    bits8 = dict(act=8, grad=None, kv=8)
    bits4 = dict(act=4, grad=None, kv=4)
    widest, control, served = 0.0, 0.0, 0
    for i in pick:
        r, toks = done[i]
        seq = torch.tensor(r["prompt"] + toks[:-1], device=ctx.device)
        at = torch.arange(len(r["prompt"]) - 1, len(seq), device=ctx.device)
        want = torch.tensor(toks, device=ctx.device)
        lg = ref.logits(ctx.cfg, w, seq, at, bits8)
        best = lg.max(dim=-1).values
        widest = max(widest, float((best - lg.gather(1, want[:, None])[:, 0]).max()))
        served += len(toks)
        if ctx.control:
            lc = ref.logits(ctx.cfg, w, seq, at, bits4)
            control = max(control, float((best - lg.gather(1, lc.argmax(dim=-1)[:, None])[:, 0]).max()))
        del lg
    ctx.log(f"chat check: {len(pick)} requests, {served} served tokens judged")
    extra = {"control": {"logit_gap": control}} if ctx.control else {}
    return [("logit_gap", widest, ctx.limits["logit_gap"])], extra
