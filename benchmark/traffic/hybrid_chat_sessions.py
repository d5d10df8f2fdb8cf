"""Traffic kind ``hybrid_chat_sessions``: ``chat_sessions``' open loop of multi-turn chat
sessions (the same mix parameters, generator, client and traced stretch), served by the
program's continuous-batching scheduler in process over a hybrid decoder of Mamba-2,
attention and MLP blocks (``models/nemotron_h.py``), built from ``benchmark/weights_hybrid.py``
by ``benchmark/port_hybrid.py`` and judged against ``benchmark/reference/nemotron_h.py``.

The engine (the cell's ``engine``) is ``chat_sessions``': slots, decode chunk, buckets,
prefill chunk, prefix-cache entries, the warm-up request, the traced stretch and the number
of finished requests the reference judges. A follow-up turn that starts with an earlier
turn's prompt restores that prompt's K/V and its SSM and conv states at P0 from the prefix
cache, and prefills the rest alone.

Besides the chat kind's observations it keeps, for the per-layer metrics, the scheduler's
state counters over the window and the state-space kernels' counts over the traced stretch
(K8's launches, positions scanned, fresh launches and snapshots taken; K9's launches and the
lanes it stepped).

The judge reads three numbers: ``logit_gap`` (``chat_sessions``' over the requests ``pick``
reads); ``state_gap``, the prefix cache's snapshot (SSM and conv) of its longest prefix at the
run's end against the reference's states after those tokens (a served token's logit moves
little with the SSM state under random weights and D = 1; the state itself shows a wrong
snapshot or a reset); and ``lane_gap``, a finished row's decode lanes at the first Mamba-2
block, head by head, against the exact recurrence over the program's own inputs to that block
(its in_proj's xBC and dt rows for the row's tokens, computed once the scheduler has closed):
the int8 rounding of the projections, which every deeper number carries, is left out, so the
precision of the state that the decode steps keep shows (``--control`` also reads the
recurrence with the state rounded to bfloat16 after each decode step, ``state_control``,
which has to fail it).

``FAULTS`` plant errors under the timed path that the judge has to see: a state reset at
every prefill chunk (each chunk starts from a zero state), the snapshot taken at the wrong
offset (after the first position of the chunk that holds P0), and the D x skip term dropped
(D zeroed in every Mamba-2 block).

A checkout whose program has no hybrid decoder fails at once, at its import.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from benchmark.traffic.chat_sessions import TAIL_S, TRACE_LOAD_S, Recorder, generate, percentile

__all__ = ["FAULTS", "generate", "judge", "pick", "run"]


def _state_reset():
    from llama_x_tpu_torch.serve import continuous

    real = continuous._span
    continuous._span = lambda state, inputs, fresh: real(state, inputs, True)

    def undo():
        continuous._span = real
    return undo


def _snapshot_offset():
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    real = ContinuousScheduler._snap_at
    ContinuousScheduler._snap_at = lambda self, ids, start, end: min(real(self, ids, start, end), 1)

    def undo():
        ContinuousScheduler._snap_at = real
    return undo


def _d_dropped():
    from benchmark import port_hybrid

    real = port_hybrid.build

    def build(*args, **kw):
        model = real(*args, **kw)
        for blk in model.layers:
            if blk.kind == "M":
                blk.mixer.D.data = blk.mixer.D.data.clone().zero_()
        return model

    port_hybrid.build = build

    def undo():
        port_hybrid.build = real
    return undo


FAULTS = {"state_reset": _state_reset, "snapshot_offset": _snapshot_offset, "d_dropped": _d_dropped}


def _ssd_counts(sched) -> dict:
    from llama_x_tpu_torch.ops import ssd

    return dict(scan=ssd.ssd_scan.launches, scanned=ssd.ssd_scan.scanned.launches, fresh=ssd.ssd_scan.fresh.launches,
                step=ssd.ssd_step.launches, lanes=ssd.lanes_stepped(), snapshots=sched.state_snapshots)


def _state_counts(sched) -> dict:
    return dict(snapshots=sched.state_snapshots, restores=sched.prefix_state_hits, bytes=sched.state_bytes_copied)


def _probe(sched):
    """The prefix-cache entry with the longest prefix at the run's end: its tokens and its
    snapshot on the host, one (SSM [H, P, N], conv [K - 1, C]) a Mamba-2 block, which the judge
    holds against the reference's states after those tokens; None where the cache holds none."""
    if not sched.prefixes:
        return None
    key = max(sched.prefixes, key=len)
    (_, snap), _, _ = sched.prefixes[key]
    return list(key), list(zip(*(t.cpu() for t in snap)))


def _lane_probe(sched, rows: list):
    """Of the rows whose slot no row has taken since, the finished one with the longest answer:
    its tokens (the prompt and the answer but its last token, which no decode step read), its
    prompt's length and its slot's lanes at the first Mamba-2 block (SSM [H, P, N], conv
    [K - 1, C]) on the host; None where there is none. Read with the worker paused: no row is
    taken into a slot meanwhile, and a finished row's lanes stay as its last step left them."""
    last = {}
    for row in rows:
        if row is not None and row.slot is not None and (row.slot not in last or row.t_slot > last[row.slot].t_slot):
            last[row.slot] = row
    done = [r for r in last.values() if r.event.is_set() and r.error is None and len(r.tokens) == r.max_tokens]
    if not done:
        return None
    row = max(done, key=lambda r: len(r.tokens))
    ssm, conv = sched.state[7:]
    return row.ids + row.tokens[:-1], len(row.ids), (ssm[0, row.slot].cpu(), conv[0, row.slot].cpu())


def _lane_inputs(model, lane):
    """``lane`` (``_lane_probe``'s) with the program's own inputs to its first block, a Mamba-2
    block, over the row's tokens: the in_proj's xBC [S, C] and dt [S, H] columns on the host;
    None where there is no lane or the first block is not a Mamba-2 block."""
    import torch

    from llama_x_tpu_torch.models import llama, nemotron_h

    if lane is None or model.layers[0].kind != "M":
        return None
    c, blk = model.config, model.layers[0]
    with torch.inference_mode():
        x = llama.embed(model, torch.tensor([lane[0]], device=model.device))
        proj = nemotron_h.apply_linear(blk.norm(x), blk.mixer.in_proj, dynamic_int8_act=c.dynamic_int8_act)[0]
    di, C = c.d_inner, c.conv_dim
    return (*lane, proj[:, di:di + C].cpu(), proj[:, di + C:].cpu())


def run(ctx) -> dict:
    import torch

    from llama_x_tpu_torch.models import nemotron_h  # noqa: F401 (a program without the hybrid stops here)

    from benchmark import port_hybrid, weights_hybrid
    from benchmark.trace import Window, span
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    cfg, mix, eng = ctx.cfg, ctx.mix, ctx.workload["engine"]
    requests = [r for r in generate(mix, cfg, ctx.seed, ctx.seconds) if ctx.trace or r["due"] < ctx.seconds]
    if ctx.trace:  # the load goes on past the schedule's tail while the traced stretch waits its turn
        more = generate(dict(mix, schedule_seed=mix["schedule_seed"] + 1), cfg, ctx.seed, TRACE_LOAD_S)
        requests += [dict(r, due=r["due"] + ctx.seconds + TAIL_S) for r in more]
    with span("bench.warmup"):
        model = port_hybrid.build(cfg, weights_hybrid.draw(cfg, ctx.seed, ctx.device), dict(dynamic_int8_act=True))
        sched = ContinuousScheduler(model, n_slots=eng["n_slots"], chunk_size=eng["chunk_size"],
                                    prompt_multiple=eng["prompt_multiple"], cache_dtype=torch.int8,
                                    prefill_chunk=eng["prefill_chunk"], prefix_cache=eng["prefix_cache"],
                                    seed=int(ctx.seed) % (2**63))
        # one prompt whose chunks start at every prefill chunk up to the mix's longest reaches
        # every graph key of the traffic: the first chunk, each continuation's kv bound, the
        # install, the step
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
    caps0, reused0, state0 = captures(), sched.prefix_tokens_reused, _state_counts(sched)
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
    caps1, reused1, state1 = captures(), sched.prefix_tokens_reused, _state_counts(sched)
    deadline = time.perf_counter() + ctx.drain_seconds
    for row_ in rows[:due]:  # every request of the window answered, a minute past the close at most
        while row_ is None and time.perf_counter() < deadline:
            time.sleep(0.01)
        if row_ is not None:
            row_.event.wait(timeout=max(0.0, deadline - time.perf_counter()))
    with sched.paused():
        lane = _lane_probe(sched, rows)
    traced = counts0 = held = None
    if ctx.trace:
        # started with the worker held at the top of its loop (not after a fixed settle, which
        # an iteration of several prefill chunks and a decode chunk outlasts: the profiler then
        # starts under its launches, and the trace's records and the counters part), stopped
        # once it has ended
        traced = Window(host=False)
        asked = time.perf_counter()
        with sched.paused():
            held = time.perf_counter() - asked  # the rest of the worker's iteration in flight
            traced.__enter__()
            counts0 = _ssd_counts(sched)
        time.sleep(eng["trace_seconds"])
    stop.set()
    thread.join()
    ctx.program_done()
    sched.close()
    ssd_counts = None
    if traced is not None:
        traced.__exit__(None, None, None)
        counts1 = _ssd_counts(sched)
        ssd_counts = {k: counts1[k] - counts0[k] for k in counts0}

    ttft, tpot, late, failed = [], [], [], 0
    delivered = 0
    admitted_prompt, prefilled, decoded, sampled = 0, [], [], 0
    done = []
    for i, (r, rec, row) in enumerate(zip(requests[:due], recs, rows)):
        late.append((sent[i] - t0 - r["due"]) * 1e3)
        ok = row is not None and row.error is None and row.event.is_set() and len(row.tokens) == r["max_tokens"]
        if not rec.arrivals or not ok:
            failed += 1
            ttft.append(float("inf"))
            continue
        done.append((dict(r, reused=row.reused), list(row.tokens)))
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
               state={k: state1[k] - state0[k] for k in state0}, ssd=ssd_counts,
               trace=None if traced is None else dict(summary=traced.summary))
    ctx.log(f"hybrid chat: {due} requests due in {window} s ({due / window:.3f}/s), {failed} failed, "
            f"{queued_at_end} queued or admitting at the window's end, captures in the window {caps1 - caps0}, "
            f"state copies in the window {obs['state']}, state-space kernels in the traced stretch {ssd_counts}"
            + ("" if held is None else f" (started {held:.3f} s after it was asked for, at the top of the worker's loop)"))
    probe, lane = _probe(sched), _lane_inputs(model, lane)
    del sched, model
    ctx.free()
    with span("bench.reference"):
        checks, extra = judge(ctx, done, probe, lane)
    return dict(e2e=e2e, obs=obs, checks=checks, attempted=due, failed=failed, extra=extra)


def pick(done: list, n: int, seed: int) -> list[int]:
    """The requests the judge reads: the longest finished one, then ``n`` - 1 drawn from the
    seed, half of them (rounded up) among those that restored a prefix's snapshot where there are
    such (the path a wrong snapshot would spoil; the rest among the others, each group topping
    up the other), in submit order."""
    rng = np.random.default_rng([int(seed) % (2**63), 2])
    order = sorted(range(len(done)), key=lambda i: -(len(done[i][0]["prompt"]) + len(done[i][1])))
    hits = rng.permutation([i for i in order[1:] if done[i][0].get("reused")]).tolist()
    rest = rng.permutation([i for i in order[1:] if not done[i][0].get("reused")]).tolist()
    k = min(len(hits), max(-(-(n - 1) // 2), n - 1 - len(rest)))
    return order[:1] + sorted(hits[:k] + rest[:n - 1 - k])


def _rel(got, want) -> float:
    return float((got.to(want.device).float() - want).norm() / want.norm())


def state_gap(got, want) -> float:
    """The widest relative distance ||got - want|| / ||want|| over the Mamba-2 blocks and over
    each block's SSM and conv states (``got``, ``want``: one (SSM, conv) pair a block)."""
    return max(_rel(g, w) for pg, pw in zip(got, want) for g, w in zip(pg, pw))


def lane_gap(got, want) -> float:
    """The widest relative distance between one block's states (``got``, ``want``: (SSM
    [H, P, N], conv [K - 1, C])), the SSM state's head by head."""
    (ssm, conv), (ref, ref_conv) = got, want
    heads = (ssm.to(ref.device).float() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    return max(float(heads.max()), _rel(conv, ref_conv))


def judge(ctx, done: list, probe=None, lane=None) -> tuple[list, dict]:
    """``chat_sessions.judge`` over the hybrid's reference: the widest gap by which a served
    token's logit lies below the reference's best, over the requests ``pick`` reads
    (``logit_gap``); the states the prefix cache kept for ``probe``'s tokens against the
    reference's after them (``state_gap``); ``lane``'s decode lanes against the exact
    recurrence over its in_proj rows (``lane_gap``); NaN, which fails, where the run kept no
    snapshot or no lane. With ``ctx.control`` also the readings of the control (the reference
    at 4 bits against it at 8) and of the state-precision control (``state_control``: the
    state rounded to bfloat16 after each decode step)."""
    import torch

    from benchmark import weights_hybrid
    from benchmark.reference import nemotron_h as ref

    ref.no_tf32()
    picked = pick(done, ctx.workload["engine"]["check_requests"], ctx.seed)
    tensors = weights_hybrid.draw(ctx.cfg, ctx.seed, ctx.device)
    seqs, ats, wants, starts = [], [], [], []
    for i in picked:
        r, toks = done[i]
        seqs.append(torch.tensor(r["prompt"] + toks[:-1], device=ctx.device))
        ats.append(torch.arange(len(r["prompt"]) - 1, len(seqs[-1]), device=ctx.device))
        wants.append(torch.tensor(toks, device=ctx.device))
        starts.append(len(r["prompt"]))
    keep = []
    if probe is not None:
        seqs.append(torch.tensor(probe[0], device=ctx.device))
        ats.append(torch.tensor([len(probe[0]) - 1], device=ctx.device))
        starts.append(None)
        keep = [len(seqs) - 1]
    lane_rows = None
    if lane is not None:
        w0 = {n: tensors[n][0].float() for n in ("conv_w", "conv_b", "A_log", "dt_bias", "D")}
        lane_rows = (ctx.cfg, w0, lane[3].to(ctx.device).float(), lane[4].to(ctx.device).float())
        lane_want = ref.mamba_state(*lane_rows)

    lgs, states = ref.logits(ctx.cfg, tensors, seqs, ats, dict(act=8, kv=8), keep)
    widest = 0.0
    for lg, want in zip(lgs, wants):
        best = lg.max(dim=-1).values
        widest = max(widest, float((best - lg.gather(1, want[:, None])[:, 0]).max()))
    gaps = dict(state_gap=state_gap(probe[1], states[keep[0]]) if keep else float("nan"),
                lane_gap=lane_gap(lane[2], lane_want) if lane_rows else float("nan"))
    extra = {}
    if ctx.control:
        for name, bits, lanes_from in (("control", dict(act=4, kv=4), None),
                                       ("state_control", dict(act=8, kv=8, state=torch.bfloat16), starts)):
            lcs, cstates = ref.logits(ctx.cfg, tensors, seqs, ats, bits, keep, lanes_from)
            gap = 0.0
            for lg, lc in zip(lgs[:len(wants)], lcs):
                best = lg.max(dim=-1).values
                gap = max(gap, float((best - lg.gather(1, lc.argmax(dim=-1)[:, None])[:, 0]).max()))
            extra[name] = dict(logit_gap=gap, state_gap=state_gap(cstates[keep[0]], states[keep[0]]) if keep
                               else float("nan"))
            del lcs, cstates
        if lane_rows:
            extra["state_control"]["lane_gap"] = lane_gap(ref.mamba_state(*lane_rows, lane[1], torch.bfloat16),
                                                          lane_want)
    ctx.log(f"hybrid chat check: {len(picked)} requests ({sum(bool(done[i][0]['reused']) for i in picked)} restored a "
            f"snapshot), {sum(len(w) for w in wants)} served tokens judged; the snapshot of a "
            f"{len(probe[0]) if probe else 0}-token prefix against the reference's states; the lanes of a row of "
            f"{lane[1] if lane else 0} + {len(lane[0]) - lane[1] + 1 if lane else 0} tokens against the recurrence")
    return [("logit_gap", widest, ctx.limits["logit_gap"]), ("state_gap", gaps["state_gap"], ctx.limits["state_gap"]),
            ("lane_gap", gaps["lane_gap"], ctx.limits["lane_gap"])], extra
