"""The system under test, built over the benchmark's inputs: the port's ``Llama`` with
``models/llama.py``'s modules holding the tensors of ``benchmark/weights.py`` as they
are (int8 rows and scales, bf16 embeddings, head and LoRA factors). Only the
configuration's values reach the port; nothing here computes a forward pass."""

from __future__ import annotations

import torch

from benchmark.roofline import projections


def llama_config(cfg: dict, **overrides):
    """The port's ``LlamaConfig`` for a configuration file: RMSNorm, RoPE at ``rope_theta``
    without the Llama-3.1 rescale, grouped-query attention, SwiGLU, an untied head."""
    from llama_x_tpu_torch.models import llama

    if cfg.get("tie_word_embeddings") or cfg.get("sliding_window"):
        raise ValueError(f"{cfg['name']}: the port's decoder has no tied head and no sliding window")
    return llama.LlamaConfig(
        embed_dim=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"], head_dim=cfg["head_dim"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        intermediate_dim=cfg["intermediate_size"], max_seq_len=cfg["max_position_embeddings"],
        vocab_size=cfg["vocab_size"], rope_base=float(cfg["rope_theta"]), is_llama3_1=False,
        norm_eps=float(cfg["rms_norm_eps"]), tied_embeddings=False, **overrides)


def build(cfg: dict, tensors: dict, config_overrides: dict | None = None, lora_scale: float = 1.0):
    """The port's model over ``tensors`` (``weights.draw``), each layer's linears views of
    the stacked tensors; with LoRA factors among them, attached to every projection as
    the adapter, trainable, everything else frozen (int8 rows, scales, norms, embeddings,
    head)."""
    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.ops.linear import Linear

    config = llama_config(cfg, **(config_overrides or {}))
    dev = tensors["embed"].device
    D, eps = cfg["hidden_size"], float(cfg["rms_norm_eps"])
    lora = "wq.lora_a" in tensors

    def lin(name, i):
        m = Linear(int_data=tensors[f"{name}.int8"][i], scale=tensors[f"{name}.scale"][i])
        if lora:
            m.set("lora_a", tensors[f"{name}.lora_a"][i], requires_grad=True)
            m.set("lora_b", tensors[f"{name}.lora_b"][i], requires_grad=True)
            m.set("lora_scale", torch.tensor(lora_scale, dtype=torch.float32, device=dev))
        return m

    def norm():
        return llama.RMSNorm(torch.ones(D, dtype=torch.bfloat16, device=dev), eps)

    names = [p for p, _, _ in projections(cfg)]
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        q, k, v, o, w1, w3, w2 = (lin(n, i) for n in names)
        layers.append(llama.Block(norm(), llama.Attention(q, k, v, o), norm(), llama.FeedForward(w1, w2, w3)))
    model = llama.Llama(config, tensors["embed"], layers, norm(), Linear(weight=tensors["head"]))
    for n, p in model.named_parameters():
        p.requires_grad_(lora and n.rpartition(".")[2] in ("lora_a", "lora_b"))
    if lora:
        model.config = model.config.replace(frozen_head=True)
    return model
