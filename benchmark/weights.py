"""The inputs a cell's model is made of, drawn from the seed on the device in the form
they are stored in: each projection's int8 rows and per-row bf16 scales, bf16
embeddings and head, bf16 LoRA factors. Both sides take them from here: the program
is built over them (``benchmark/port.py``) and the plain reference draws them again from
the same seed (``benchmark/reference``), so the reference reads nothing the program made.

A few large calls on one ``torch.Generator``: one tensor of every layer's rows a
projection, in a fixed order, so the same seed on the same kind of device gives the
same bits. Scales: ``(0.5 + u) / (73.6 sqrt(fan_in))``, u uniform, so that a row's
dequantized standard deviation is about 1 / sqrt(fan_in) (a layer keeps the scale of
its input) and no two rows share a scale. LoRA: A ~ N(0, 1 / in), B ~ N(0, 0.02^2): an
adapter some way into its training, every factor with a gradient from the first step.
"""

from __future__ import annotations

import torch

from benchmark.roofline import projections

LORA_B_STD = 0.02
INT8_STD = 73.6  # the standard deviation of integers uniform over [-127, 127]


def draw(cfg: dict, seed: int, device, lora_rank: int = 0) -> dict:
    """{name: tensor}: per projection ``<p>.int8`` [L, out, in], ``<p>.scale`` [L, out] (and
    with ``lora_rank`` ``<p>.lora_a`` [L, in, r], ``<p>.lora_b`` [L, r, out]), ``embed``
    and ``head`` [V, D] bf16."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63))
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    bf16 = torch.bfloat16
    out: dict[str, torch.Tensor] = {}
    for name, n, k in projections(cfg):
        out[f"{name}.int8"] = torch.randint(-127, 128, (L, n, k), dtype=torch.int8, device=dev, generator=gen)
        u = torch.rand((L, n), device=dev, generator=gen)
        out[f"{name}.scale"] = ((0.5 + u) / (INT8_STD * k**0.5)).to(bf16)
    out["embed"] = torch.randn((V, D), device=dev, generator=gen).to(bf16)
    out["head"] = (torch.randn((V, D), device=dev, generator=gen) / D**0.5).to(bf16)
    if lora_rank:
        for name, n, k in projections(cfg):
            out[f"{name}.lora_a"] = (torch.randn((L, k, lora_rank), device=dev, generator=gen) / k**0.5).to(bf16)
            out[f"{name}.lora_b"] = (torch.randn((L, lora_rank, n), device=dev, generator=gen) * LORA_B_STD).to(bf16)
    return out
