"""queue_wait_p95_ms.chat: the 95th percentile over the window's requests of their wait for
a slot (the program's ``request.queue`` span: from ``submit`` to the worker taking the row
into a slot); a request never taken counts as infinite."""

import math

from benchmark.program_spans import window_requests
from benchmark.traffic.chat_sessions import percentile

SOURCE, UNIT, LAYER, MOVES = "program_counter", "ms", "scheduler", "ttft_p95_ms"


def read(obs: dict):
    reqs = window_requests(obs)
    if not reqs:
        return None
    v = percentile([r["queue_ms"] for r in reqs], 0.95)
    return v if math.isfinite(v) else None
