"""The least time of each kernel call on one H100, from its shape and mask alone.

Pure arithmetic (no torch): the benchmark's yardstick, kept apart from the program.
A call's least time is the larger of its bytes, each input read once and each output
written once, over the HBM bandwidth, and its operations over the peak rate of its
precision. A roofline share is that least time over the device time the trace gives
the same calls; it cannot pass 1 unless the operations or bytes are counted too high
or the time leaves out part of the work.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 1979 TOP/s int8,
3.35 TB/s HBM3, at the 700 W power limit.

Kernels, by the names the port gives them (``llama_x_tpu_torch/ops/launches.py``):
K1 ``int8_mm_dequant_nt`` (a [M, K] int8 x b [N, K] int8, fp32 row and column scales,
out [M, N]), K4 ``int8_mm_dequant`` (a [M, K] x b [K, N], the KN form), K2
``flash_attention`` (q [B, S, Hq, D], k / v [B, S, Hkv, D] bf16, out bf16 and the f32
log-sum-exp), K5 ``flash_attention_bwd`` (reads q, k, v, out, dout, lse; writes dq, dk,
dv), K3 ``decode_attention`` (one query row a sequence over the cache).
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}
BF16, F32, I8 = 2, 4, 1


@dataclass(frozen=True)
class Bound:
    """A call's operations, their precision and its bytes; ``seconds`` is its least time."""

    ops: float
    precision: str
    nbytes: float

    @property
    def by_ops(self) -> float:
        return self.ops / PEAK_OPS_PER_S[self.precision]

    @property
    def by_bytes(self) -> float:
        return self.nbytes / HBM_BYTES_PER_S

    @property
    def seconds(self) -> float:
        return max(self.by_ops, self.by_bytes)

    @property
    def bound_by(self) -> str:
        return "operations" if self.by_ops >= self.by_bytes else "bytes"


def int8_mm_nt(M: int, N: int, K: int, out_bytes: int = BF16) -> Bound:
    """K1: a [M, K] x b [N, K] int8 with fp32 row / column scales -> [M, N]."""
    return Bound(2.0 * M * N * K, "int8", M * K * I8 + N * K * I8 + (M + N) * F32 + M * N * out_bytes)


def int8_mm_kn(M: int, N: int, K: int, out_bytes: int = BF16) -> Bound:
    """K4: a [M, K] x b [K, N] int8 -> [M, N]; the same bytes and operations as K1."""
    return int8_mm_nt(M, N, K, out_bytes)


def causal_pairs(lengths) -> int:
    """The (query, key) pairs a causal mask keeps over documents of these lengths, each
    attending within itself: sum of n (n + 1) / 2."""
    return sum(n * (n + 1) // 2 for n in lengths)


def flash_fwd(B: int, S: int, Hq: int, Hkv: int, D: int, pairs: int) -> Bound:
    """K2 over ``pairs`` kept (query, key) pairs of every row together, each head: QK^T and
    PV, 2 operations a multiply-add. Bytes: q, k, v read, out written (bf16), the f32
    log-sum-exp written."""
    ops = 4.0 * pairs * D * Hq
    nbytes = B * S * D * BF16 * (2 * Hq + 2 * Hkv) + B * S * Hq * F32
    return Bound(ops, "bf16", nbytes)


def flash_bwd(B: int, S: int, Hq: int, Hkv: int, D: int, pairs: int) -> Bound:
    """K5: the scores again, dP, dV, dQ, dK: five products over the kept pairs (2.5 x the
    forward). Bytes: q, k, v, out, dout and lse read; dq, dk, dv written."""
    ops = 10.0 * pairs * D * Hq
    nbytes = B * S * D * BF16 * (4 * Hq + 4 * Hkv) + B * S * Hq * F32
    return Bound(ops, "bf16", nbytes)


def decode_attention(lens, Hq: int, Hkv: int, D: int, int8_cache: bool = False, sq: int = 1) -> Bound:
    """K3: ``sq`` query rows of each sequence over its ``lens`` cached positions. Bytes: the
    live cache read once (int8 with an f32 scale a row, or bf16), q read and out written."""
    row = D * I8 + F32 if int8_cache else D * BF16
    kv = sum(lens) * Hkv * row * 2
    q_out = len(lens) * sq * Hq * D * BF16 * 2
    ops = 4.0 * sum(lens) * sq * Hq * D
    return Bound(ops, "bf16", kv + q_out)


def share(bounds, device_seconds: float) -> float | None:
    """Least time of ``bounds`` over the device time of the same calls, in %; None where
    the trace holds no time for them (a kernel off the path reads nothing)."""
    if not device_seconds or device_seconds <= 0:
        return None
    return 100.0 * sum(b.seconds for b in bounds) / device_seconds


# ---------------------------------------------------------------------------
# the calls of one QLoRA training step (models/llama.py under remat "full", the
# fused chunked CE over the int8 head), by kernel
# ---------------------------------------------------------------------------


def projections(cfg: dict) -> list[tuple[str, int, int]]:
    """(name, N out, K in) of a layer's seven int8 projections."""
    d, hd, nh, nkv, f = (cfg["hidden_size"], cfg["head_dim"], cfg["num_attention_heads"],
                         cfg["num_key_value_heads"], cfg["intermediate_size"])
    return [("wq", nh * hd, d), ("wk", nkv * hd, d), ("wv", nkv * hd, d), ("wo", d, nh * hd),
            ("w1", f, d), ("w3", f, d), ("w2", d, f)]


def train_step_calls(cfg: dict, rows: list[list[int]], seq_len: int, ce_chunks: int) -> dict[str, list[Bound]]:
    """Every kernel call of one optimizer step, by kernel name: ``rows`` holds the
    document lengths of each microbatch's one row of ``seq_len`` positions (microbatch 1,
    accumulation ``len(rows)``). Per microbatch and layer: K1 runs each projection in the
    forward and again in the recompute, K4 each input gradient (but the first layer's
    q / k / v, whose input is the frozen embedding: no gradient flows there), K2 the
    forward and the recompute, K5 once; the head adds K1 twice a CE chunk (logits,
    recomputed in the backward) and K4 once (dH, f32 out)."""
    L, V, d = cfg["num_hidden_layers"], cfg["vocab_size"], cfg["hidden_size"]
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    M = seq_len
    calls: dict[str, list[Bound]] = {"int8_mm_dequant_nt": [], "int8_mm_dequant": [], "flash_attention": [],
                                     "flash_attention_bwd": []}
    rows_ce = M // ce_chunks
    for docs in rows:
        pairs = causal_pairs(docs)
        for layer in range(L):
            for name, n, k in projections(cfg):
                calls["int8_mm_dequant_nt"] += [int8_mm_nt(M, n, k)] * 2
                if layer or name not in ("wq", "wk", "wv"):
                    calls["int8_mm_dequant"].append(int8_mm_kn(M, k, n))
            calls["flash_attention"] += [flash_fwd(1, M, hq, hkv, hd, pairs)] * 2
            calls["flash_attention_bwd"].append(flash_bwd(1, M, hq, hkv, hd, pairs))
        calls["int8_mm_dequant_nt"] += [int8_mm_nt(rows_ce, V, d, F32)] * (2 * ce_chunks)
        calls["int8_mm_dequant"] += [int8_mm_kn(rows_ce, d, V, F32)] * ce_chunks
    return calls


def train_kernel_share(obs: dict, kernel: str) -> float | None:
    """A kernel's roofline share over the traced training step: the least time of the
    step's calls (``train_step_calls``) over the device time of the kernel's records. None
    where the step made no such call, or where the launch counter or the trace's records
    disagree with the calls counted here (the path changed, or the trace lost records)."""
    t = obs.get("trace")
    if not t or not t.get("summary"):
        return None
    s = t["summary"]
    calls = train_step_calls(obs["cfg"], t["docs"], obs["mix"]["seq_len"], obs["engine"]["fused_ce_chunks"])[kernel]
    if not calls or s["launched"].get(kernel) != len(calls) or s["group_records"].get(kernel) != len(calls):
        return None
    return share(calls, s["group_s"][kernel])
