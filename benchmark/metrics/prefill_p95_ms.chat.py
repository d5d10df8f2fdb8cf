"""prefill_p95_ms.chat: the 95th percentile over the window's requests of the time from
their slot to their first token (the program's ``request.prefill`` span: the admission, or
the chunked prefill with the decode chunks interleaved between its chunks, and the
install); a request that never reached its first token counts as infinite."""

import math

from benchmark.program_spans import window_requests
from benchmark.traffic.chat_sessions import percentile

SOURCE, UNIT, LAYER, MOVES = "program_counter", "ms", "scheduler", "ttft_p95_ms"


def read(obs: dict):
    reqs = window_requests(obs)
    if not reqs:
        return None
    v = percentile([r["prefill_ms"] for r in reqs], 0.95)
    return v if math.isfinite(v) else None
