"""torch_pass_share.chat: device time of kernels that are not the port's own over all
device time of the traced stretch after the window (``chat_sessions``: the worker's last
iterations under the load sent past the window, up to the scheduler's close), in %."""

from benchmark.trace import pass_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "model passes", "tpot_p95_ms"


def read(obs: dict):
    return pass_share(obs)
