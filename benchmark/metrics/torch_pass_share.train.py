"""torch_pass_share.train: device time of kernels that are not the port's own (PyTorch's
passes around them) over all device time of the traced training step, in %."""

from benchmark.trace import pass_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "model passes", "train_tokens_per_s"


def read(obs: dict):
    return pass_share(obs)
