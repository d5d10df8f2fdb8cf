"""Useful operations of a training step and of served tokens, by precision, and their
share of the H100's peaks (pure arithmetic, no torch).

QLoRA accounting (the JAX package's ``bench.py``, rewritten with the H100's peaks): a
frozen int8 weight counts 4 operations a token (the forward and the input gradient; no
weight gradient exists), a LoRA weight 6, attention 3 x its forward over the (query,
key) pairs the document mask keeps, the frozen head 4 a parameter over the positions
the loss covers; the recompute of activation checkpointing is not useful work and is
not counted. With ``dynamic_int8_act`` / ``dynamic_int8_bwd`` / ``int8_head`` the
frozen products run on int8 and count at 1979 TOP/s; LoRA and attention at bf16's
989 TFLOP/s. The least time is the sum of each precision's operations over its peak,
and the share is that least time over the time taken.
"""

from __future__ import annotations

from benchmark.roofline import PEAK_OPS_PER_S, causal_pairs, projections


def trunk_params(cfg: dict) -> int:
    """Weights of the layers' seven projections (what the int8 base holds)."""
    return cfg["num_hidden_layers"] * sum(n * k for _, n, k in projections(cfg))


def lora_params(cfg: dict, rank: int) -> int:
    return cfg["num_hidden_layers"] * sum(rank * (n + k) for _, n, k in projections(cfg))


def least_seconds(ops: dict[str, float]) -> float:
    return sum(v / PEAK_OPS_PER_S[p] for p, v in ops.items())


def train_step_ops(cfg: dict, rank: int, rows: list[list[int]], seq_len: int, label_positions: int) -> dict:
    """{precision: operations} of one optimizer step over ``rows`` (each microbatch's
    document lengths, one row of ``seq_len`` positions) with ``label_positions`` positions
    under the loss in the whole step."""
    hq, hd, L = cfg["num_attention_heads"], cfg["head_dim"], cfg["num_hidden_layers"]
    positions = seq_len * len(rows)
    int8 = 4.0 * trunk_params(cfg) * positions + 4.0 * cfg["hidden_size"] * cfg["vocab_size"] * label_positions
    pairs = sum(causal_pairs(docs) for docs in rows)
    bf16 = 6.0 * lora_params(cfg, rank) * positions + 12.0 * L * pairs * hq * hd
    return {"int8": int8, "bf16": bf16}


def serve_ops(cfg: dict, prefilled: list[tuple[int, int]], decoded: list[int], sampled: int) -> dict:
    """{precision: operations} of serving: ``prefilled`` holds (start, end) position ranges
    run through the trunk (a prefix reused from the cache is not among them), ``decoded``
    the positions of the tokens fed to decode steps, ``sampled`` the positions whose logits
    the head computed. Projections on int8 (``dynamic_int8_act``), attention over each
    query's live context and the head on bf16."""
    hq, hd, L = cfg["num_attention_heads"], cfg["head_dim"], cfg["num_hidden_layers"]
    tokens = sum(b - a for a, b in prefilled) + len(decoded)
    # a query at position p attends over p + 1 keys
    ctx = sum((b * (b + 1) - a * (a + 1)) // 2 for a, b in prefilled) + sum(p + 1 for p in decoded)
    int8 = 2.0 * trunk_params(cfg) * tokens
    bf16 = 4.0 * L * ctx * hq * hd + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * sampled
    return {"int8": int8, "bf16": bf16}


def share(ops: dict[str, float], seconds: float) -> float | None:
    """Least time over ``seconds``, in %."""
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ops) / seconds
