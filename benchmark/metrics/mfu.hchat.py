"""mfu.hchat: the useful operations of every token prefilled (the reused prefix left out, in
proportion) and decoded in the window by the hybrid, at the H100's peaks by precision
(``benchmark/mfu_hybrid.py``: int8 projections, bf16 attention and head, the f32 SSD
recurrence), over the window, in %."""

from benchmark import mfu_hybrid

SOURCE, UNIT, LAYER, MOVES = "host_clock", "%", "whole step", "tpot_p95_ms"


def read(obs: dict):
    if not obs["sampled"] or "hybrid_override_pattern" not in obs["cfg"]:
        return None
    pre = mfu_hybrid.serve_ops(obs["cfg"], obs["prefilled"], [], 0)
    kept = 1.0 - obs["reused"] / obs["admitted_prompt"] if obs["admitted_prompt"] else 1.0
    dec = mfu_hybrid.serve_ops(obs["cfg"], [], obs["decoded"], obs["sampled"])
    return mfu_hybrid.share({p: pre[p] * kept + dec[p] for p in dec}, obs["window_s"])
