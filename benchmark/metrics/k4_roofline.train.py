"""k4_roofline.train: K4, csrc/int8_mm_kn.cu: the least time of the traced training step's calls of
``int8_mm_dequant`` (benchmark/roofline.py) over their device time, in %."""

from benchmark.roofline import train_kernel_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "kernels", "train_tokens_per_s"


def read(obs: dict):
    return train_kernel_share(obs, "int8_mm_dequant")
