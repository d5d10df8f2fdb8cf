"""mfu.chat: the useful operations of every token prefilled (the reused prefix left out, in
proportion) and decoded in the window, attention over each one's live context, at the
H100's peaks by precision, over the window, in %."""

from benchmark import mfu

SOURCE, UNIT, LAYER, MOVES = "host_clock", "%", "whole step", "tpot_p95_ms"


def read(obs: dict):
    if not obs["sampled"]:
        return None
    pre = mfu.serve_ops(obs["cfg"], obs["prefilled"], [], 0)
    kept = 1.0 - obs["reused"] / obs["admitted_prompt"] if obs["admitted_prompt"] else 1.0
    dec = mfu.serve_ops(obs["cfg"], [], obs["decoded"], obs["sampled"])
    ops = {p: pre[p] * kept + dec[p] for p in dec}
    return mfu.share(ops, obs["window_s"])
