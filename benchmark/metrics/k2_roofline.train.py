"""k2_roofline.train: K2, csrc/flash_attention.cu: the least time of the traced training step's calls of
``flash_attention`` (benchmark/roofline.py) over their device time, in %."""

from benchmark.roofline import train_kernel_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "kernels", "train_tokens_per_s"


def read(obs: dict):
    return train_kernel_share(obs, "flash_attention")
