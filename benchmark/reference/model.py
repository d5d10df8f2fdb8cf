"""The plain reference: the decoder, its QLoRA training step and its served logits in
plain PyTorch and float32, with TF32 off. It imports nothing of the program, and no
JAX: it reads the inputs the benchmark draws (``benchmark/weights.py``) and works out
again whatever the program derives from them.

The architecture as Mistral publishes it (and as ``models/llama.py`` computes it):
pre-RMSNorm blocks, RoPE at ``rope_theta`` on adjacent feature pairs (the original
checkpoints' layout; Hugging Face permutes the projections into halves instead),
grouped-query attention (query head h reads kv head h // (Hq / Hkv)), SwiGLU, an untied
head. Under a document mask a position attends to the earlier positions of its own
document; RoPE runs over the packed row's positions.

The precision each configuration states, computed here exactly (in float32 in place
of the integer sums): ``act_bits`` rows of every projection's input quantized
symmetrically by their absmax (``dynamic_int8_act``) against the stored int8 rows and
their scales; ``grad_bits`` the input gradient's rows, the weight scale folded in
before the rounding (``dynamic_int8_bwd``); the head quantized per vocabulary row and
its hidden rows and loss gradient rows likewise (``int8_head``); ``kv_bits`` each
cached key and value row of one head. LoRA, norms, RoPE, attention and the loss run in
float32. The control is the same code with 4 bits where the configuration states 8.
"""

from __future__ import annotations

import math

import torch

NAMES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """Rows of ``x`` (its last axis) rounded to ``bits``-bit symmetric integers at
    absmax / (2^(bits-1) - 1), half to even, and scaled back; ``None`` leaves x as it is."""
    if bits is None:
        return x
    qmax = float(2 ** (bits - 1) - 1)
    s = x.abs().amax(dim=-1, keepdim=True) / qmax
    return torch.round(x / s.clamp(min=1e-12)) * s


class QLinear(torch.autograd.Function):
    """x @ (w * s)^T over an int8 base held as float (``w`` the integers, ``s`` [out] the row
    scales), the input's rows rounded to ``act_bits``; the input gradient's rows, scaled
    by ``s`` first, rounded to ``grad_bits``. No gradient for the frozen base."""

    @staticmethod
    def forward(ctx, x, w, s, act_bits, grad_bits):
        ctx.save_for_backward(w, s)
        ctx.grad_bits = grad_bits
        return (fake_quant(x, act_bits) @ w.T) * s

    @staticmethod
    def backward(ctx, g):
        w, s = ctx.saved_tensors
        return fake_quant(g * s, ctx.grad_bits) @ w, None, None, None, None


class HeadLoss(torch.autograd.Function):
    """Mean cross-entropy over the positions whose label is not -100, the logits from the
    head quantized per vocabulary row (``head``: integers, ``s`` their scales) and the
    hidden rows rounded to ``bits``; the backward rounds each row of the loss gradient
    times ``s`` to ``bits`` (the int8 head's three products)."""

    @staticmethod
    def forward(ctx, x, head, s, labels, bits):
        logits = (fake_quant(x, bits) @ head.T) * s
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, safe[:, None])[:, 0]
        n = valid.sum().clamp(min=1)
        dl = torch.softmax(logits, dim=-1)
        dl[torch.arange(len(safe), device=x.device), safe] -= 1.0
        dl *= valid[:, None].float()
        ctx.save_for_backward(head, s, dl, n)
        ctx.bits = bits
        return torch.where(valid, lse - gold, torch.zeros_like(lse)).sum() / n

    @staticmethod
    def backward(ctx, g):
        head, s, dl, n = ctx.saved_tensors
        return fake_quant(dl * s, ctx.bits) @ head * (g / n), None, None, None, None


def quantize_rows(w: torch.Tensor, bits: int):
    """A float matrix's rows as integers and their scales (the int8 head's rounding)."""
    qmax = float(2 ** (bits - 1) - 1)
    s = w.abs().amax(dim=1) / qmax
    return torch.round(w / s.clamp(min=1e-12)[:, None]), s


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def rope_table(n: int, head_dim: int, theta: float, device) -> torch.Tensor:
    """(cos, sin) [n, head_dim / 2] of positions 0..n-1."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [S, H, D]: feature pairs (2j, 2j + 1) rotated by position."""
    e, o = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([e * c - o * s, o * c + e * s], dim=-1).reshape(x.shape)


def attention(q, k, v, docs) -> torch.Tensor:
    """q [S, Hq, D], k / v [S, Hkv, D]; ``docs``: the lengths of consecutive documents that
    cover the row; causal within each document."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    outs, start = [], 0
    for n in docs:
        qs = q[start:start + n].reshape(n, Hkv, g, D)
        ks, vs = k[start:start + n], v[start:start + n]
        sc = torch.einsum("qhgd,khd->hgqk", qs, ks) / math.sqrt(D)
        mask = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("hgqk,khd->qhgd", p, vs).reshape(n, Hq * D))
        start += n
    return torch.cat(outs, dim=0)


class Weights:
    """The drawn tensors (``weights.draw``), read layer by layer as float32."""

    def __init__(self, cfg: dict, tensors: dict):
        self.cfg, self.t = cfg, tensors

    def layer(self, i: int) -> dict:
        return {n: (self.t[f"{n}.int8"][i].float(), self.t[f"{n}.scale"][i].float()) for n in NAMES}

    def lora(self, i: int) -> dict | None:
        if "wq.lora_a" not in self.t:
            return None
        return {n: (self.t[f"{n}.lora_a"][i].float(), self.t[f"{n}.lora_b"][i].float()) for n in NAMES}


def layer_forward(cfg: dict, h, w: dict, lora: dict | None, cos, sin, docs, bits: dict):
    """One block on the rows ``h`` [S, D] (float32)."""
    eps = float(cfg["rms_norm_eps"])
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    S = h.shape[0]

    def proj(name, x):
        y = QLinear.apply(x, *w[name], bits["act"], bits["grad"])
        if lora is not None:
            a, b = lora[name]
            y = y + (x @ a) @ b * bits["lora_scale"]
        return y

    x = rms_norm(h, eps)
    q = rope(proj("wq", x).reshape(S, hq, hd), cos, sin)
    k = rope(proj("wk", x).reshape(S, hkv, hd), cos, sin)
    v = proj("wv", x).reshape(S, hkv, hd)
    if bits.get("kv") is not None:
        k, v = fake_quant(k, bits["kv"]), fake_quant(v, bits["kv"])
    h = h + proj("wo", attention(q, k, v, docs))
    x = rms_norm(h, eps)
    return h + proj("w2", torch.nn.functional.silu(proj("w1", x)) * proj("w3", x))


def trunk_rows(cfg: dict, weights: Weights, tokens: torch.Tensor, docs, bits: dict, keep: bool = False):
    """The final hidden rows [S, D] of one row of ``tokens``; with ``keep`` also every
    layer's input (for the backward, layer by layer)."""
    cos, sin = rope_table(tokens.shape[0], cfg["head_dim"], float(cfg["rope_theta"]), tokens.device)
    h = weights.t["embed"][tokens.long()].float()
    kept = []
    with torch.no_grad():
        for i in range(cfg["num_hidden_layers"]):
            if keep:
                kept.append(h)
            h = layer_forward(cfg, h, weights.layer(i), weights.lora(i), cos, sin, docs, bits)
    return h, kept, (cos, sin)


def logits(cfg: dict, weights: Weights, tokens: torch.Tensor, at: torch.Tensor, bits: dict) -> torch.Tensor:
    """Float32 logits [len(at), V] at positions ``at`` of one causal sequence ``tokens``,
    the head in bf16 as stored (serving reads it unquantized)."""
    h, _, _ = trunk_rows(cfg, weights, tokens, [tokens.shape[0]], bits)
    x = rms_norm(h[at], float(cfg["rms_norm_eps"]))
    return x @ weights.t["head"].float().T


def loss_and_grads(cfg: dict, weights: Weights, tokens, labels, docs, bits: dict):
    """(loss, {leaf name: gradient}) of one packed row under the int8 head's loss; the
    LoRA factors are the only leaves. The backward runs layer by layer from each layer's
    kept input."""
    eps = float(cfg["rms_norm_eps"])
    h, kept, (cos, sin) = trunk_rows(cfg, weights, tokens, docs, bits, keep=True)
    head, s = quantize_rows(weights.t["head"].float(), bits["head"])
    hf = h.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = HeadLoss.apply(rms_norm(hf, eps), head, s, labels.long(), bits["head"])
        (g,) = torch.autograd.grad(loss, [hf])
    del head, s
    grads = {}
    for i in reversed(range(cfg["num_hidden_layers"])):
        lora = {n: tuple(t.detach().requires_grad_(True) for t in ab) for n, ab in weights.lora(i).items()}
        x = kept[i].detach().requires_grad_(True)
        with torch.enable_grad():
            out = layer_forward(cfg, x, weights.layer(i), lora, cos, sin, docs, bits)
            leaves = [t for n in NAMES for t in lora[n]]
            g, *gl = torch.autograd.grad(out, [x] + leaves, g)
        for j, n in enumerate(NAMES):
            grads[f"{i}.{n}.lora_a"], grads[f"{i}.{n}.lora_b"] = gl[2 * j], gl[2 * j + 1]
    return float(loss.detach()), grads


def leaf_names(cfg: dict) -> list[str]:
    return [f"{i}.{n}.{ab}" for i in range(cfg["num_hidden_layers"]) for n in NAMES for ab in ("lora_a", "lora_b")]


def adapter(tensors: dict, name: str) -> torch.Tensor:
    i, n, ab = name.split(".")
    return tensors[f"{n}.{ab}"][int(i)]


def train_steps(cfg: dict, tensors: dict, batches, bits: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, on_step=None):
    """AdamW steps (fp32 moments, each factor kept in bf16 as the configuration stores it,
    one rounding a step) over ``batches``: each a list of microbatches (tokens, labels,
    docs), the gradient the mean of theirs. ``tensors`` is updated in place. Returns the
    losses and each step's gradients; ``on_step(i, micro_grads)`` sees each step's
    per-microbatch (loss, gradients)."""
    weights = Weights(cfg, tensors)
    names = leaf_names(cfg)
    mu = {n: torch.zeros_like(adapter(tensors, n), dtype=torch.float32) for n in names}
    nu = {n: torch.zeros_like(m) for n, m in mu.items()}
    losses, steps = [], []
    for t, micro in enumerate(batches, start=1):
        per = [loss_and_grads(cfg, weights, *mb, bits) for mb in micro]
        if on_step is not None:
            on_step(t, per)
        losses.append(sum(l for l, _ in per) / len(per))
        grads = {n: sum(g[n] for _, g in per) / len(per) for n in names}
        steps.append(grads)
        c1 = float(torch.tensor(1 - b1**t, dtype=torch.float64).float())
        c2 = float(torch.tensor(1 - b2**t, dtype=torch.float64).float())
        for n in names:
            mu[n].mul_(b1).add_(grads[n] * (1 - b1))
            nu[n].mul_(b2).add_(grads[n] * (1 - b2) * grads[n])
            p = adapter(tensors, n)
            update = (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + eps)
            p.copy_((p.float() - lr * update).to(p.dtype))
    return losses, steps
