"""The inputs a hybrid (Nemotron-H) cell's model is made of, drawn from the seed on the device
in the form they are stored in, as ``benchmark/weights.py`` draws a decoder's: each
projection's int8 rows and per-row bf16 scales ``(0.5 + u) / (73.6 sqrt(fan_in))``, bf16
embeddings and head; and each Mamba-2 block's conv (bf16, U(-0.5, 0.5): PyTorch's Conv1d init
at a fan-in of 4), ``A_log`` (log U(1, 16)), ``dt_bias`` (the inverse softplus of a dt
log-uniform in [time_step_min, time_step_max], floored at time_step_floor) and ``D`` (ones),
in f32. Norms are ones and are not drawn. Both sides take them from here: the program is
built over them (``benchmark/port_hybrid.py``) and the plain reference draws them again from
the same seed (``benchmark/reference/nemotron_h.py``).
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import INT8_STD


def dims(cfg: dict) -> dict:
    """The widths the configuration implies."""
    H, P, G, N = cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"], cfg["ssm_state_size"]
    di = H * P
    return dict(H=H, P=P, G=G, N=N, d_inner=di, conv_dim=di + 2 * G * N, K=cfg["conv_kernel"],
                hq=cfg["num_attention_heads"], hkv=cfg["num_key_value_heads"], hd=cfg["attention_head_dim"])


def projections(cfg: dict) -> dict[str, list[tuple[str, int, int]]]:
    """{block kind: [(name, N out, K in)]} of the int8 projections."""
    d, D = dims(cfg), cfg["hidden_size"]
    return {"M": [("in_proj", 2 * d["d_inner"] + 2 * d["G"] * d["N"] + d["H"], D), ("out_proj", D, d["d_inner"])],
            "*": [("wq", d["hq"] * d["hd"], D), ("wk", d["hkv"] * d["hd"], D), ("wv", d["hkv"] * d["hd"], D),
                  ("wo", D, d["hq"] * d["hd"])],
            "-": [("up", cfg["intermediate_size"], D), ("down", D, cfg["intermediate_size"])]}


def draw(cfg: dict, seed: int, device) -> dict:
    """{name: tensor}: per projection ``<p>.int8`` [L_kind, out, in] and ``<p>.scale``
    [L_kind, out] (L_kind: the blocks of its kind), ``conv_w`` [L_M, C, K], ``conv_b`` [L_M, C],
    ``A_log``, ``dt_bias``, ``D`` [L_M, H], ``embed`` and ``head`` [V, D]."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63))
    pat, D, V = cfg["hybrid_override_pattern"], cfg["hidden_size"], cfg["vocab_size"]
    d = dims(cfg)
    bf16 = torch.bfloat16
    out: dict[str, torch.Tensor] = {}
    for kind, projs in projections(cfg).items():
        L = pat.count(kind)
        for name, n, k in projs:
            out[f"{name}.int8"] = torch.randint(-127, 128, (L, n, k), dtype=torch.int8, device=dev, generator=gen)
            u = torch.rand((L, n), device=dev, generator=gen)
            out[f"{name}.scale"] = ((0.5 + u) / (INT8_STD * k**0.5)).to(bf16)
    LM, H = pat.count("M"), d["H"]
    out["conv_w"] = (torch.rand((LM, d["conv_dim"], d["K"]), device=dev, generator=gen) - 0.5).to(bf16)
    out["conv_b"] = (torch.rand((LM, d["conv_dim"]), device=dev, generator=gen) - 0.5).to(bf16)
    out["A_log"] = torch.log(1.0 + 15.0 * torch.rand((LM, H), device=dev, generator=gen))
    lo, hi = math.log(cfg["time_step_min"]), math.log(cfg["time_step_max"])
    dt = torch.exp(lo + (hi - lo) * torch.rand((LM, H), device=dev, generator=gen)).clamp(min=cfg["time_step_floor"])
    out["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    out["D"] = torch.ones((LM, H), device=dev)
    out["embed"] = torch.randn((V, D), device=dev, generator=gen).to(bf16)
    out["head"] = (torch.randn((V, D), device=dev, generator=gen) / D**0.5).to(bf16)
    return out
