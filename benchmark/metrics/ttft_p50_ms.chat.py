"""ttft_p50_ms.chat: the median time to first token over the requests due in the window,
from the due time to the first token's arrival at the client."""

import math

from benchmark.traffic.chat_sessions import percentile

SOURCE, UNIT, LAYER, MOVES = "host_clock", "ms", "scheduler", "ttft_p95_ms"


def read(obs: dict):
    v = percentile(obs["ttft_ms"], 0.5)
    return v if math.isfinite(v) else None
