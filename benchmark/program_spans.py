"""The program's own spans (``llama_x_tpu_torch/utils/spans.py``) over a chat run's window,
for the readers of the chat cell's program metrics.

The requests: the newest scheduler's, in submit order, its first (the set-up's warm-up)
left out; the next ``len(obs["late_ms"])`` are the window's, in due order, as the sender
submits them. The pairing is checked: for the window requests whose TTFT is finite, the
sender's lateness, the request's queue wait (``request.queue``) and prefill
(``request.prefill``) and its delivery (what is left: the steps from the sender's clock to
the row's ``submit`` stamp and from its first-token stamp to the client's clock) add up to
the harness's TTFT. Each part of a delivery is the time between two adjacent statements of
one thread on one clock, so a right pairing never reads one below 0; a host that stalls a
thread there (a GIL switch, a core taken by another process) stretches it by milliseconds.
A pairing off by a request is off for nearly every request after it by the difference of
two requests' TTFTs, hundreds of milliseconds either way. So the pairing holds where no
delivery reads below ``-PAIRING_MS`` and their median reads within ``PAIRING_MS`` of 0;
every run logs the median, how many read above ``PAIRING_MS`` and the widest. Where it
fails, every reader returns None and says why on standard error.

The window: from the first window request's submit less its lateness (it is due at 0) for
``window_s``. The device intervals are the worker's ``device.*`` spans (on the card only):
each graph replay and each block of plain copies, on the host clock, with the worker span
it ran under as its ``stage``. A replay's interval starts no earlier than the host's return
from its launch; ``cut_ns`` is what that left out after its start event, and the replay's
device time lies between the interval's length and that length plus ``cut_ns``
(``utils/spans.py:DeviceClock``).

A program without the recorder (an older checkout) has no spans: every reader returns None.
"""

from __future__ import annotations

import json
import math
import statistics
import sys

PAIRING_MS = 2.0
PREFILL_STAGES = ("serve.admit", "serve.prefill_chunk", "serve.install")
DECODE_STEP = "decode_rows step"


def log(msg: str) -> None:
    print(f"program spans: {msg}", file=sys.stderr, flush=True)


def _snapshot():
    try:
        from llama_x_tpu_torch.utils import spans
    except ImportError:
        return None, 0
    return spans.snapshot(), spans.dropped()


def _ms(span, reached: bool) -> float:
    return (span.end - span.start) / 1e6 if span is not None and reached else float("inf")


def window_requests(obs: dict, snap=None) -> list[dict] | None:
    """[{submit (ns), queue_ms, prefill_ms}] of the window's requests in due order, or None
    (no recorder, too few requests, or a pairing that does not hold)."""
    if snap is None:
        snap, lost = _snapshot()
        if snap is None:
            log("the program has no span recorder")
            return None
        if lost:
            log(f"the recorder dropped {lost} spans")
    reqs: dict = {}
    for s in snap:
        if s.name.startswith("request."):
            reqs.setdefault(s.request, {})[s.name] = s
    queues = [r["request.queue"] for r in reqs.values() if "request.queue" in r]
    if not queues:
        log("no request spans")
        return None
    newest = max(q.attrs.get("scheduler") or 0 for q in queues)
    mine = sorted((q for q in queues if q.attrs.get("scheduler") == newest), key=lambda q: q.start)
    n = len(obs["late_ms"])
    if not n or len(mine) < 1 + n:
        log(f"{len(mine)} requests of scheduler {newest}; the warm-up and {n} window requests expected")
        return None
    out, delivery = [], []
    for q, late, ttft in zip(mine[1:1 + n], obs["late_ms"], obs["ttft_ms"]):
        p = reqs[q.request].get("request.prefill")
        queue_ms = _ms(q, q.attrs.get("reached"))
        prefill_ms = _ms(p, p is not None and p.attrs.get("reached"))
        if math.isfinite(ttft):
            delivery.append(ttft - late - queue_ms - prefill_ms)
        out.append(dict(submit=q.start, queue_ms=queue_ms, prefill_ms=prefill_ms))
    if not delivery:
        log("no window request has a finite TTFT")
        return None
    mid = statistics.median(delivery)
    say = (f"deliveries of {len(delivery)} window requests with a TTFT: median {mid:.3f} ms, "
           f"{sum(d > PAIRING_MS for d in delivery)} above {PAIRING_MS} ms, from {min(delivery):.3f} to "
           f"{max(delivery):.3f} ms")
    if min(delivery) < -PAIRING_MS or abs(mid) > PAIRING_MS:
        log(f"the pairing does not hold: {say}")
        return None
    log(say)
    return out


def window(obs: dict, reqs: list[dict]) -> tuple[int, int]:
    lo = reqs[0]["submit"] - round(obs["late_ms"][0] * 1e6)
    return lo, lo + round(obs["window_s"] * 1e9)


def device_window(obs: dict):
    """(lo, hi, the worker's device intervals that overlap [lo, hi)) or None."""
    snap, lost = _snapshot()
    if snap is None:
        log("the program has no span recorder")
        return None
    reqs = window_requests(obs, snap)
    if reqs is None:
        return None
    lo, hi = window(obs, reqs)
    dev = [s for s in snap if s.name.startswith("device.") and s.end > lo and s.start < hi]
    if not dev:
        log("no device intervals in the window (they are timed on the card only)")
        return None
    return lo, hi, dev


def _clipped(s, lo: int, hi: int, cut: bool = False) -> int:
    """The interval's time inside [lo, hi); with ``cut``, from its start event on."""
    start = s.start - s.attrs.get("cut_ns", 0) if cut else s.start
    return max(0, min(s.end, hi) - max(start, lo))


def decode_step_ms(obs: dict) -> float | None:
    got = device_window(obs)
    if got is None:
        return None
    lo, hi, dev = got
    steps = [(s.end - s.start) / 1e6 for s in dev
             if s.name == "device.replay" and s.attrs.get("graph") == DECODE_STEP and lo <= s.start and s.end <= hi]
    return statistics.median(steps) if steps else None


def prefill_device_share(obs: dict) -> float | None:
    """The prefill stages' share of the worker's device time in the window, in %, from the
    intervals as kept. Logs the device seconds by stage, and the bounds on the share that
    the replays' ``cut_ns`` leave: each replay's device time taken at its interval or at
    the interval plus its cut, whichever moves the share most either way."""
    got = device_window(obs)
    if got is None:
        return None
    lo, hi, dev = got
    by_stage: dict = {}
    for s in dev:
        k = s.attrs.get("stage")
        kept, full = by_stage.get(k, (0, 0))
        by_stage[k] = (kept + _clipped(s, lo, hi), full + _clipped(s, lo, hi, cut=True))
    pre = [sum(v[i] for k, v in by_stage.items() if k in PREFILL_STAGES) for i in (0, 1)]
    rest = [sum(v[i] for k, v in by_stage.items() if k not in PREFILL_STAGES) for i in (0, 1)]
    if not pre[0] + rest[0]:
        return None
    log("window device seconds by stage (as kept, with the launches' cut): " + json.dumps(
        {str(k): [v[0] / 1e9, v[1] / 1e9] for k, v in sorted(by_stage.items(), key=lambda kv: -kv[1][0])}))
    low, high = 100.0 * pre[0] / (pre[0] + rest[1]), 100.0 * pre[1] / (pre[1] + rest[0])
    log(f"prefill_device_share.chat between {low:.3f}% and {high:.3f}% for the launches' cut")
    return 100.0 * pre[0] / (pre[0] + rest[0])
