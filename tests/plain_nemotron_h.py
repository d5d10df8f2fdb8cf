"""A plain float32 Nemotron-H forward for the tests: no JAX, nothing of the port. The SSD
recurrence runs position by position (S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t
+ D x_t), not in chunks; attention is causal GQA with no rotary embedding; the MLP is
down(relu(up x)^2).

``weights``: {"embed" [V, D], "norm" [D], "head" [V, D], "layers": [per block: {"kind": "M",
"*" or "-", "norm" [D], and the mixer's tensors}]}, every tensor float32: a Mamba block's
"in_proj" [2 d_inner + 2 G N + H, D], "conv_w" [C, K], "conv_b" [C], "A_log", "dt_bias", "D"
[H], "gate_norm" [d_inner], "out_proj" [D, d_inner]; an attention block's "wq", "wk", "wv",
"wo"; an MLP block's "up", "down" (PyTorch's [out, in] layout).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def mamba(cfg: dict, w: dict, h: torch.Tensor) -> torch.Tensor:
    """h [S, D] -> [S, D] from a zero state."""
    S = h.shape[0]
    H, P, G, N = cfg["mamba_heads"], cfg["mamba_head_dim"], cfg["n_groups"], cfg["ssm_state"]
    di = H * P
    proj = h @ w["in_proj"].T
    z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * G * N], proj[:, 2 * di + 2 * G * N:]
    K = w["conv_w"].shape[1]
    pad = torch.cat([torch.zeros(K - 1, xbc.shape[1]), xbc], dim=0)
    conv = w["conv_b"] + sum(w["conv_w"][:, k] * pad[k:k + S] for k in range(K))
    act = F.silu(conv)
    x = act[:, :di].reshape(S, H, P)
    Bm = act[:, di:di + G * N].reshape(S, G, N)
    Cm = act[:, di + G * N:].reshape(S, G, N)
    dtv = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    state = torch.zeros(H, P, N)
    rep = H // G
    y = torch.empty(S, H, P)
    for t in range(S):
        Bh = Bm[t].repeat_interleave(rep, dim=0)
        Ch = Cm[t].repeat_interleave(rep, dim=0)
        state = torch.exp(dtv[t] * A)[:, None, None] * state + (dtv[t][:, None] * x[t])[:, :, None] * Bh[:, None, :]
        y[t] = torch.einsum("hpn,hn->hp", state, Ch) + w["D"][:, None] * x[t]
    g = y.reshape(S, di) * F.silu(z)
    g = g.reshape(S, G, di // G)
    g = (g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + cfg["eps"])).reshape(S, di) * w["gate_norm"]
    return g @ w["out_proj"].T


def attention(cfg: dict, w: dict, h: torch.Tensor) -> torch.Tensor:
    S = h.shape[0]
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = (h @ w["wq"].T).reshape(S, hkv, hq // hkv, hd)
    k = (h @ w["wk"].T).reshape(S, hkv, hd)
    v = (h @ w["wv"].T).reshape(S, hkv, hd)
    sc = torch.einsum("qhgd,khd->hgqk", q, k) / math.sqrt(hd)
    sc = sc.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    out = torch.einsum("hgqk,khd->qhgd", torch.softmax(sc, dim=-1), v).reshape(S, hq * hd)
    return out @ w["wo"].T


def forward(cfg: dict, weights: dict, tokens: list[int]) -> torch.Tensor:
    """Logits [S, V] of one sequence."""
    h = weights["embed"][torch.tensor(tokens)]
    for w in weights["layers"]:
        x = rms_norm(h, w["norm"], cfg["eps"])
        if w["kind"] == "M":
            h = h + mamba(cfg, w, x)
        elif w["kind"] == "*":
            h = h + attention(cfg, w, x)
        else:
            h = h + torch.relu(x @ w["up"].T).square() @ w["down"].T
    return rms_norm(h, weights["norm"], cfg["eps"]) @ weights["head"].T


def greedy(cfg: dict, weights: dict, prompt: list[int], n: int) -> list[int]:
    """``n`` greedy tokens after ``prompt``, each from a full forward of the sequence so far."""
    seq = list(prompt)
    for _ in range(n):
        seq.append(int(forward(cfg, weights, seq)[-1].argmax()))
    return seq[len(prompt):]
