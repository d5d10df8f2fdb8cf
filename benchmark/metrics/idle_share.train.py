"""idle_share.train: the share of the traced training step in which no operation ran on
the device, in %."""

from benchmark.trace import idle_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "device", "train_tokens_per_s"


def read(obs: dict):
    return idle_share(obs)
