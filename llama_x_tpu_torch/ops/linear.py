"""The linear every projection goes through (port of llama_x_tpu/ops/linear.py).

In the JAX package a linear is a param dict whose leaves say what it is; here it is
a ``Linear`` module holding the same tensors, each optional:

  weight    [out, in]          plain float base (PyTorch's layout; the JAX kernel is its transpose)
  int_data  [out, in] int8     rowwise-quantized base, with scale [out]
  bias      [out]
  lora_a    [in, r], lora_b [r, out], lora_scale []   LoRA adapter
  m         [out]                                      DoRA magnitude

``apply_linear`` keeps the JAX order: base, + LoRA delta, DoRA rescale by
m / ||W + B A s|| (a column norm taken without gradient), + bias. So a QLoRA
fine-tune (int8 base + LoRA leaves) serves as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from llama_x_tpu_torch.ops.int8 import int8_linear


class Linear(nn.Module):
    """One projection's tensors (applied by ``apply_linear``). Float tensors are
    parameters, frozen unless ``set`` is told otherwise (serving takes no gradient;
    training marks the adapter tensors, adapters/lora.py); integer tensors are buffers."""

    _NAMES = ("weight", "int_data", "scale", "bias", "lora_a", "lora_b", "lora_scale", "m")

    def __init__(self, **tensors: torch.Tensor | None):
        super().__init__()
        unknown = set(tensors) - set(self._NAMES)
        if unknown:
            raise TypeError(f"unknown linear tensors {sorted(unknown)}")
        if ("weight" in tensors) == ("int_data" in tensors):
            raise ValueError("a linear holds exactly one base: weight or int_data")
        for name in self._NAMES:
            self.set(name, tensors.get(name))

    def set(self, name: str, t: torch.Tensor | None, requires_grad: bool = False) -> None:
        """Attach (or, with None, remove) one of the linear's tensors."""
        for store in (self._parameters, self._buffers, self.__dict__):
            store.pop(name, None)
        if t is None:
            self.__dict__[name] = None
        elif t.is_floating_point():
            self.register_parameter(name, nn.Parameter(t, requires_grad=requires_grad))
        else:
            self.register_buffer(name, t)


def _base_matmul(x: torch.Tensor, lin: Linear, dynamic_int8_act: bool, dynamic_int8_bwd: bool) -> torch.Tensor:
    if lin.int_data is not None:
        return int8_linear(x, lin.int_data, lin.scale, dynamic_int8_act, dynamic_int8_bwd)
    return torch.nn.functional.linear(x, lin.weight.to(x.dtype))


def _dequant_kernel(lin: Linear) -> torch.Tensor:
    """Base weight as float [in, out] (for the DoRA norm)."""
    if lin.int_data is not None:
        return (lin.int_data.float() * lin.scale.float()[:, None]).T
    return lin.weight.float().T


def _finish_linear(lin: Linear, out: torch.Tensor, delta: torch.Tensor | None) -> torch.Tensor:
    """+LoRA delta, DoRA rescale, +bias, in that order."""
    if delta is not None:
        out = out + delta
    if lin.m is not None:
        with torch.no_grad():
            d_w = lin.lora_a.float() @ lin.lora_b.float() * lin.lora_scale.float()
            norm = torch.linalg.vector_norm(_dequant_kernel(lin) + d_w, dim=0)  # [out]
        out = out * (lin.m.float() / norm).to(out.dtype)
    if lin.bias is not None:
        out = out + lin.bias.to(out.dtype)
    return out


def _lora_delta(x_a: torch.Tensor, lin: Linear, dtype: torch.dtype) -> torch.Tensor:
    return (x_a @ lin.lora_b.to(dtype)) * lin.lora_scale.to(dtype)


def apply_linear(x: torch.Tensor, lin: Linear, *, dynamic_int8_act: bool = False,
                 dynamic_int8_bwd: bool = False) -> torch.Tensor:
    out = _base_matmul(x, lin, dynamic_int8_act, dynamic_int8_bwd)
    delta = None
    if lin.lora_a is not None:
        delta = _lora_delta(x @ lin.lora_a.to(x.dtype), lin, x.dtype)
    return _finish_linear(lin, out, delta)


def apply_linear_grouped(x: torch.Tensor, lins, *, dynamic_int8_act: bool = False,
                         dynamic_int8_bwd: bool = False) -> tuple[torch.Tensor, ...]:
    """Several linears on the SAME input, their LoRA A-projections fused into one
    concatenated GEMM (x is read once); exact, since each output column of a matmul
    reads only its own weight column."""
    outs = [_base_matmul(x, lin, dynamic_int8_act, dynamic_int8_bwd) for lin in lins]
    lora_is = [i for i, lin in enumerate(lins) if lin.lora_a is not None]
    deltas: dict[int, torch.Tensor] = {}
    if len(lora_is) >= 2:
        xa = x @ torch.cat([lins[i].lora_a.to(x.dtype) for i in lora_is], dim=1)
        off = 0
        for i in lora_is:
            r = lins[i].lora_a.shape[1]
            deltas[i] = _lora_delta(xa[..., off:off + r], lins[i], x.dtype)
            off += r
    elif lora_is:
        i = lora_is[0]
        deltas[i] = _lora_delta(x @ lins[i].lora_a.to(x.dtype), lins[i], x.dtype)
    return tuple(_finish_linear(lin, out, deltas.get(i)) for i, (lin, out) in enumerate(zip(lins, outs)))
