"""k5_roofline.train: K5, csrc/flash_attention_bwd.cu (its dq and dkv kernels): the least
time of the traced training step's calls of ``flash_attention_bwd`` (benchmark/roofline.py)
over their device time, in %."""

from benchmark.roofline import train_kernel_share

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "kernels", "train_tokens_per_s"


def read(obs: dict):
    return train_kernel_share(obs, "flash_attention_bwd")
