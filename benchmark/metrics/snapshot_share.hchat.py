"""snapshot_share.hchat: the device time of the hybrid's state copies in the window (the
worker's ``serve.snapshot`` and ``serve.restore`` intervals: a snapshot's copy out of the
admission buffers and a prefix hit's copy into the slot's lanes) over all of the worker's
device time there (those and its ``device.*`` intervals: graph replays and plain copies), in
%. Paired and windowed as ``benchmark/program_spans.py`` pairs the chat metrics."""

from benchmark import program_spans as ps

SOURCE, UNIT, LAYER, MOVES = "program_counter", "%", "scheduler prefix cache", "ttft_p95_ms"
STATE = ("serve.snapshot", "serve.restore")


def read(obs: dict):
    snap, lost = ps._snapshot()
    if snap is None:
        ps.log("the program has no span recorder")
        return None
    reqs = ps.window_requests(obs, snap)
    if reqs is None:
        return None
    lo, hi = ps.window(obs, reqs)
    dev = [s for s in snap if (s.name.startswith("device.") or s.name in STATE) and s.end > lo and s.start < hi]
    total = sum(ps._clipped(s, lo, hi) for s in dev)
    state = sum(ps._clipped(s, lo, hi) for s in dev if s.name in STATE)
    if not total:
        ps.log("no device intervals in the window (they are timed on the card only)")
        return None
    ps.log(f"state copies in the window: {state / 1e9:.6f} s of {total / 1e9:.6f} s of the worker's device time")
    return 100.0 * state / total
