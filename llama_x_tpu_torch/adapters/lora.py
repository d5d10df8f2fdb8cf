"""LoRA / DoRA adapters and the rules for what trains (port of
llama_x_tpu/adapters/lora.py).

The JAX package adds adapter leaves to a param tree and freezes by a boolean mask;
here the adapter tensors are attached to each ``Linear`` in place and freezing is each
parameter's ``requires_grad``. Applied to the layers only: embeddings and the LM head
stay untouched.

Math: lora_a ~ kaiming_normal(a=sqrt(5)) over fan_in, lora_b = 0, scale = alpha / rank,
so the adapted model equals the base model at the start; DoRA adds m = the base
weight's norm per output feature, and ops/linear.py rescales by m / ||W + B A s|| with
the norm taken without gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from llama_x_tpu_torch.adapters.quantize import _map_linears
from llama_x_tpu_torch.ops.linear import Linear, _dequant_kernel

_ADAPTER_TRAINABLE = ("lora_a", "lora_b", "m")


def apply_linear_adapter(module: nn.Module, adapter: str | None, generator: torch.Generator, rank: int = 8,
                         alpha: float = 8.0, dtype=torch.bfloat16) -> nn.Module:
    """Attach lora_a / lora_b / lora_scale (+ m for "dora") to every linear under
    ``module``, in place, drawing lora_a from ``generator`` (on the weights' device).
    adapter in {None, "lora", "dora"}. The adapter tensors require grad."""
    if adapter is None or rank <= 0:
        return module
    if adapter not in ("lora", "dora"):
        raise ValueError(f"unknown adapter {adapter!r}")

    def add_adapter(lin: Linear, path: str) -> None:
        if lin.lora_a is not None:
            raise ValueError(f"{path} already has an adapter")
        base = lin.int_data if lin.int_data is not None else lin.weight
        fan_out, fan_in = base.shape
        dev = base.device
        # kaiming_normal(a=sqrt(5)): gain = sqrt(2 / (1 + 5)), std = gain / sqrt(fan_in)
        std = (2.0 / 6.0) ** 0.5 / fan_in**0.5
        a = torch.randn(fan_in, rank, device=dev, generator=generator) * std
        lin.set("lora_a", a.to(dtype), requires_grad=True)
        lin.set("lora_b", torch.zeros(rank, fan_out, dtype=dtype, device=dev), requires_grad=True)
        lin.set("lora_scale", torch.tensor(alpha / rank, dtype=torch.float32, device=dev))
        if adapter == "dora":
            m = torch.linalg.vector_norm(_dequant_kernel(lin), dim=0)  # [out], over the in axis
            lin.set("m", m.to(dtype), requires_grad=True)

    return _map_linears(module, add_adapter)


def tree_path(name: str) -> str:
    """A parameter's or buffer's module path ("layers.3.attention.wq.weight") as the
    JAX param tree names it ("layers/attention/wq/kernel": layers are stacked there, a
    linear's float base is its ``kernel``)."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    if parts == ["tok_embeddings"]:
        return "tok_embeddings/weight"
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


def set_trainable(model: nn.Module, freeze_prefixes: tuple[str, ...] = ()) -> tuple[int, int]:
    """Set every parameter's ``requires_grad`` by the JAX package's ``trainable_mask``
    rules and return the (trainable, frozen) element counts, buffers counted as frozen:
    - an int8 base and its scale: frozen (integer tensors are buffers anyway);
    - lora_scale: a constant, frozen; lora_a / lora_b / m: trainable;
    - weight / bias of a linear that has an adapter: frozen;
    - any tensor whose tree path (``tree_path``) equals a freeze prefix or starts with
      it followed by "/" or ".": frozen, whatever else it is;
    - everything else: trainable."""
    linears = {name: mod for name, mod in model.named_modules() if isinstance(mod, Linear)}
    n_train = n_frozen = 0
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        lin = linears.get(owner)
        path = tree_path(name)
        if any(path == pre or path.startswith(pre + "/") or path.startswith(pre + ".") for pre in freeze_prefixes):
            frozen = True
        elif lin is not None and leaf == "scale" and lin.int_data is not None:
            frozen = True
        elif leaf == "lora_scale":
            frozen = True
        elif leaf in _ADAPTER_TRAINABLE:
            frozen = False
        elif lin is not None and lin.lora_a is not None and leaf in ("weight", "bias"):
            frozen = True
        else:
            frozen = False
        p.requires_grad_(not frozen)
        if frozen:
            n_frozen += p.numel()
        else:
            n_train += p.numel()
    n_frozen += sum(b.numel() for name, b in model.named_buffers() if name.rpartition(".")[2] == "int_data")
    return n_train, n_frozen
