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

Two things exist for the remat policies (models/llama.py). ``save=(store, name)``
makes the base product a named point of a checkpointed region (ops/remat.py): its
output is kept on the first pass and handed back on the recompute, so the GEMM runs
once. ``linear_vjp`` is the direct backward of ``apply_linear``: dx and the gradients of
the linear's trainable tensors from (x, g) without the base forward product. The JAX
package calls ``jax.vjp`` on the linear there and lets XLA drop the replayed forward;
PyTorch drops nothing, so the replay gets the base output handed in as a placeholder
that no gradient reads.

A linear that ``parallel/sharding.py:shard_params`` placed on a mesh holds its shards, and
the functions here add what GSPMD adds (``parallel/tensor.py``): every tensor sharded over
"fsdp" is gathered just before use (differentiably: its gradient comes back reduce-scattered;
the int8 base inside ``int8_linear``, again in its backward). Under tp a column-parallel
linear (``tp_kind`` "col": out over "tp") reads its input through ``copy_to_tp`` (its
input gradient is a partial sum over the local output features), and its LoRA rank-r
activation too (``lora_a`` is whole over "tp", ``lora_b`` sharded on out); a row-parallel
linear ("row": in over "tp") sums its base partial and its adapter partial (``lora_a``
sharded on in) in one ``reduce_from_tp`` of its whole output, reads its whole ``lora_b``
through ``copy_to_tp`` and gathers its DoRA ``m`` over "tp"; DoRA's column norm there sums
its squares over "tp" before the square root.
"""

from __future__ import annotations

import torch
from torch import nn

from llama_x_tpu_torch.ops.int8 import int8_linear
from llama_x_tpu_torch.ops.remat import run_saved
from llama_x_tpu_torch.parallel.mesh import all_reduce
from llama_x_tpu_torch.parallel.tensor import (Placement, copy_to_tp, gather, gather_now, placement, reduce_from_tp,
                                               tp_kind, whole_shape)


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


class _FloatLinear(torch.autograd.Function):
    """x @ w.T for a float base at a named point of a checkpointed region, or where the
    output is known already: with ``preset`` the forward returns it and no product runs;
    the backward is the linear's own (dx = g w, dw = g^T x). Both passes of a region go
    through this Function, so that they save the same tensors in the same order."""

    @staticmethod
    def forward(ctx, x, w, preset):
        ctx.save_for_backward(x, w)
        return torch.nn.functional.linear(x, w) if preset is None else preset[0].detach()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g.matmul(w) if ctx.needs_input_grad[0] else None
        gw = g.reshape(-1, g.shape[-1]).t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def _mesh(place: Placement | None):
    return None if place is None else place.mesh


def _t(lin: Linear, name: str, place: Placement | None, axes=("fsdp",)):
    """One of the linear's tensors, gathered over ``axes`` where it is sharded there."""
    t = getattr(lin, name)
    return t if t is None else gather(t, _mesh(place), axes)


def _base_matmul(x: torch.Tensor, lin: Linear, dynamic_int8_act: bool, dynamic_int8_bwd: bool,
                 save=None, preset: torch.Tensor | None = None) -> torch.Tensor:
    """The base product (a row-parallel linear's partial sum). ``save=(store, name)``: a
    named point of a checkpointed region; ``preset``: the output, handed in (no product runs)."""

    named = save is not None and save[1] in save[0].names
    place = placement(lin)

    def base(kept):
        if lin.int_data is not None:
            return int8_linear(x, lin.int_data, lin.scale, dynamic_int8_act, dynamic_int8_bwd, kept, place)
        w = _t(lin, "weight", place).to(x.dtype)
        if named or kept is not None:
            return _FloatLinear.apply(x, w, None if kept is None else (kept,))
        return torch.nn.functional.linear(x, w)

    return base(preset) if preset is not None else run_saved(save, base)


def _dequant_kernel(lin: Linear, place: Placement | None = None) -> torch.Tensor:
    """Base weight as float [in, out] (for the DoRA norm), whole over "fsdp"."""
    mesh = _mesh(place)
    if lin.int_data is not None:
        return (gather_now(lin.int_data, mesh).float() * gather_now(lin.scale, mesh).float()[:, None]).T
    return gather_now(lin.weight, mesh).float().T


def _finish_linear(lin: Linear, out: torch.Tensor, delta: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor:
    """+LoRA delta, (row-parallel: the sum over "tp"), DoRA rescale, +bias, in that order."""
    place = placement(lin)
    kind = tp_kind(place)
    if kind == "row":  # one all-reduce covers the base partial and the adapter partial
        out = reduce_from_tp(out if delta is None else out + delta.to(out.dtype), place.mesh).to(dtype)
    elif delta is not None:
        out = out + delta
    if lin.m is not None:
        with torch.no_grad():
            a, b = gather_now(lin.lora_a, _mesh(place)), gather_now(lin.lora_b, _mesh(place))
            d_w = a.float() @ b.float() * lin.lora_scale.float()
            w = _dequant_kernel(lin, place) + d_w
            if kind == "row":  # the in axis is split over "tp": its squares sum there
                norm = torch.sqrt(all_reduce(place.mesh, w.square().sum(dim=0), "tp"))
            else:
                norm = torch.linalg.vector_norm(w, dim=0)  # [out], over the in axis
        m = _t(lin, "m", place, ("fsdp", "tp") if kind == "row" else ("fsdp",))
        out = out * (m.float() / norm).to(out.dtype)
    if lin.bias is not None:
        out = out + _t(lin, "bias", place, ("fsdp", "tp") if kind == "row" else ("fsdp",)).to(out.dtype)
    return out


def _lora_delta(x_a: torch.Tensor, lin: Linear, dtype: torch.dtype) -> torch.Tensor:
    place = placement(lin)
    b = _t(lin, "lora_b", place)
    if tp_kind(place) == "row":
        b = copy_to_tp(b, place.mesh)  # whole over "tp", fed by a partial: its gradient sums over "tp"
    return (x_a @ b.to(dtype)) * lin.lora_scale.to(dtype)


def _lora_a(lins, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([_t(lin, "lora_a", placement(lin)).to(x.dtype) for lin in lins], dim=1)


def apply_linear(x: torch.Tensor, lin: Linear, *, dynamic_int8_act: bool = False,
                 dynamic_int8_bwd: bool = False, save=None, base_out: torch.Tensor | None = None) -> torch.Tensor:
    return _apply(x, (lin,), dynamic_int8_act, dynamic_int8_bwd, save, base_out)[0]


def apply_linear_grouped(x: torch.Tensor, lins, *, dynamic_int8_act: bool = False,
                         dynamic_int8_bwd: bool = False, save=None) -> tuple[torch.Tensor, ...]:
    """Several linears on the SAME input, their LoRA A-projections fused into one
    concatenated GEMM (x is read once); exact, since each output column of a matmul
    reads only its own weight column. ``save`` names every base product of the group."""
    return _apply(x, tuple(lins), dynamic_int8_act, dynamic_int8_bwd, save, None)


def _apply(x, lins, dynamic_int8_act, dynamic_int8_bwd, save, base_out):
    kinds = {tp_kind(placement(lin)) for lin in lins}
    if len(kinds) > 1:
        raise ValueError(f"a group of linears mixes tensor-parallel roles {kinds}")
    kind = kinds.pop()
    mesh = placement(lins[0]).mesh if kind else None
    xb = copy_to_tp(x, mesh) if kind == "col" else x  # the base products' input
    outs = [_base_matmul(xb, lin, dynamic_int8_act, dynamic_int8_bwd, save, base_out) for lin in lins]
    lora_is = [i for i, lin in enumerate(lins) if lin.lora_a is not None]
    deltas: dict[int, torch.Tensor] = {}
    if lora_is:
        xa = x @ _lora_a([lins[i] for i in lora_is], x)
        if kind == "col":
            xa = copy_to_tp(xa, mesh)  # whole over "tp", feeding the tp-sharded lora_b
        off = 0
        for i in lora_is:
            r = lins[i].lora_a.shape[1]
            deltas[i] = _lora_delta(xa[..., off:off + r] if len(lora_is) > 1 else xa, lins[i], x.dtype)
            off += r
    return tuple(_finish_linear(lin, out, deltas.get(i), x.dtype) for i, (lin, out) in enumerate(zip(lins, outs)))


def linear_vjp(lin: Linear, x: torch.Tensor, g: torch.Tensor, *, dynamic_int8_act: bool = False,
               dynamic_int8_bwd: bool = False) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The backward of ``apply_linear(x, lin)`` against the cotangent ``g``, without the
    base forward product: (dx, {tensor name: gradient} for the linear's trainable
    tensors). The adapter path is replayed (rank-r products) and the base product's
    output is a zero placeholder: the int8 and float bases' backwards read g and the
    weights only, and the additions after it read nothing. DoRA's rescale does read the
    output, so a linear with ``m`` runs its base product again."""
    named = [(n, p) for n, p in lin.named_parameters() if p.requires_grad]
    base = lin.int_data if lin.int_data is not None else lin.weight
    # the product's width: whole over "fsdp" (gathered before use), this rank's over "tp"
    out_features = whole_shape(base, _mesh(placement(lin)))[0]
    placeholder = None if lin.m is not None else x.new_zeros(*x.shape[:-1], out_features)
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        out = apply_linear(xg, lin, dynamic_int8_act=dynamic_int8_act, dynamic_int8_bwd=dynamic_int8_bwd,
                           base_out=placeholder)
        grads = torch.autograd.grad(out, [xg] + [p for _, p in named], g, allow_unused=True)
    return grads[0], {n: gp for (n, _), gp in zip(named, grads[1:]) if gp is not None}
