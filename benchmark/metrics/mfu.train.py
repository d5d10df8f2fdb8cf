"""mfu.train: the traced training step's useful operations (benchmark/mfu.py) at the H100's
peaks by precision, over the mean host-clock time of the window's other steps, in %."""

from benchmark import mfu

SOURCE, UNIT, LAYER, MOVES = "host_clock", "%", "whole step", "train_tokens_per_s"


def read(obs: dict):
    t = obs.get("trace")
    if not t or not obs.get("step_s"):
        return None
    ops = mfu.train_step_ops(obs["cfg"], obs["engine"]["lora_rank"], t["docs"], obs["mix"]["seq_len"], t["labels"])
    return mfu.share(ops, obs["step_s"])
