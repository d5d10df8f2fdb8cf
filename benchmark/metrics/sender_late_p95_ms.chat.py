"""sender_late_p95_ms.chat: the 95th percentile of how late the load generator sent a
request after its due time."""

from benchmark.traffic.chat_sessions import percentile

SOURCE, UNIT, LAYER, MOVES = "host_clock", "ms", "load generator", "ttft_p95_ms"


def read(obs: dict):
    return percentile(obs["late_ms"], 0.95) if obs["late_ms"] else None
