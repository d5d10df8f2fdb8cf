"""Useful operations of served tokens of a hybrid (Nemotron-H) cell, by precision, and their
share of the H100's peaks (pure arithmetic, no torch): ``benchmark/mfu.py``'s accounting for
the hybrid's blocks.

Every projection on int8 (``dynamic_int8_act``: in_proj and out_proj of the Mamba-2 blocks,
q / k / v / o of the attention blocks, up and down of the MLP blocks), 2 operations a weight
a token, at 1979 TOP/s; attention over each query's live context and the head on bf16 at 989
TFLOP/s; the SSD recurrence, 4 operations a state element a token and head (its update and its
output), on float32 at 67 TFLOP/s. The conv, the norms and the gates are not counted. The
least time is the sum of each precision's operations over its peak.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_OPS_PER_S
from benchmark.roofline_hybrid import F32_OPS_PER_S
from benchmark.weights_hybrid import dims, projections

PEAKS = {**PEAK_OPS_PER_S, "f32": F32_OPS_PER_S}


def trunk_params(cfg: dict) -> int:
    """Weights of every block's int8 projections."""
    pat = cfg["hybrid_override_pattern"]
    return sum(pat.count(kind) * sum(n * k for _, n, k in projs) for kind, projs in projections(cfg).items())


def serve_ops(cfg: dict, prefilled: list[tuple[int, int]], decoded: list[int], sampled: int) -> dict:
    """{precision: operations} of serving, as ``mfu.serve_ops`` counts a decoder's: ``prefilled``
    (start, end) position ranges run through the trunk, ``decoded`` the positions fed to decode
    steps, ``sampled`` the positions whose logits the head computed."""
    d, pat = dims(cfg), cfg["hybrid_override_pattern"]
    tokens = sum(b - a for a, b in prefilled) + len(decoded)
    ctx = sum((b * (b + 1) - a * (a + 1)) // 2 for a, b in prefilled) + sum(p + 1 for p in decoded)
    int8 = 2.0 * trunk_params(cfg) * tokens
    bf16 = 4.0 * pat.count("*") * ctx * d["hq"] * d["hd"] + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * sampled
    f32 = 4.0 * pat.count("M") * tokens * d["H"] * d["P"] * d["N"]
    return {"int8": int8, "bf16": bf16, "f32": f32}


def share(ops: dict[str, float], seconds: float) -> float | None:
    """Least time over ``seconds``, in %."""
    if seconds <= 0:
        return None
    return 100.0 * sum(v / PEAKS[p] for p, v in ops.items()) / seconds
