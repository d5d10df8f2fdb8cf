"""idle_share.chat: the share of the traced stretch after the window (``chat_sessions``:
the worker's last iterations under the load sent past the window, up to the scheduler's
close; from its first device record to its last) in which no operation ran on the
device, in %."""

from benchmark.trace import idle_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "device", "tpot_p95_ms"


def read(obs: dict):
    return idle_share(obs)
