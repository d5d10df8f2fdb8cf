"""The hybrid system under test, built over the benchmark's inputs: the port's
``nemotron_h.Hybrid`` with its modules holding the tensors of ``benchmark/weights_hybrid.py`` as
they are (int8 rows and scales, the conv, A_log, dt_bias, D, bf16 embeddings and head). Only
the configuration's values reach the port; nothing here computes a forward pass."""

from __future__ import annotations

import torch

from benchmark.weights_hybrid import dims, projections


def hybrid_config(cfg: dict, **overrides):
    """The port's ``HybridConfig`` for a Nemotron-H configuration file."""
    from llama_x_tpu_torch.models import nemotron_h

    if cfg.get("tie_word_embeddings") or cfg.get("sliding_window") or cfg.get("attention_bias"):
        raise ValueError(f"{cfg['name']}: the port's hybrid has an untied head, no sliding window, no bias")
    d = dims(cfg)
    return nemotron_h.HybridConfig(
        embed_dim=cfg["hidden_size"], pattern=cfg["hybrid_override_pattern"], head_dim=d["hd"], num_heads=d["hq"],
        num_kv_heads=d["hkv"], intermediate_dim=cfg["intermediate_size"], mamba_heads=d["H"], mamba_head_dim=d["P"],
        ssm_state=d["N"], n_groups=d["G"], conv_kernel=d["K"], max_seq_len=cfg["max_position_embeddings"],
        vocab_size=cfg["vocab_size"], norm_eps=float(cfg["layer_norm_epsilon"]), **overrides)


def build(cfg: dict, tensors: dict, config_overrides: dict | None = None):
    """The port's hybrid over ``tensors`` (``weights_hybrid.draw``), each block's linears views
    of the stacked tensors, everything frozen."""
    from llama_x_tpu_torch.models import llama, nemotron_h
    from llama_x_tpu_torch.ops.linear import Linear

    config = hybrid_config(cfg, **(config_overrides or {}))
    dev = tensors["embed"].device
    D, eps = cfg["hidden_size"], float(cfg["layer_norm_epsilon"])
    projs = projections(cfg)
    seen = {kind: 0 for kind in projs}

    def lin(name, i):
        return Linear(int_data=tensors[f"{name}.int8"][i], scale=tensors[f"{name}.scale"][i])

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=dev)

    layers = []
    for kind in cfg["hybrid_override_pattern"]:
        i = seen[kind]
        seen[kind] += 1
        q = [lin(name, i) for name, _, _ in projs[kind]]
        if kind == "M":
            mixer = nemotron_h.Mamba(q[0], tensors["conv_w"][i], tensors["conv_b"][i], tensors["A_log"][i],
                                     tensors["dt_bias"][i], tensors["D"][i], ones(config.d_inner), q[1])
        elif kind == "*":
            mixer = llama.Attention(*q)
        else:
            mixer = nemotron_h.MLP(*q)
        layers.append(nemotron_h.Block(kind, llama.RMSNorm(ones(D), eps), mixer))
    model = nemotron_h.Hybrid(config, tensors["embed"], layers, llama.RMSNorm(ones(D), eps),
                              Linear(weight=tensors["head"]))
    for p in model.parameters():
        p.requires_grad_(False)
    return model
