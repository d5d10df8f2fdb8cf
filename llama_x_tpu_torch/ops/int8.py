"""int8 rowwise quantization and the quantized linear with its gradient.

Port of llama_x_tpu/ops/int8.py:
- rowwise / colwise symmetric quantization: fp32 math, scale = absmax / 127
  clipped at 1e-12, round half to even (``torch.round``, as ``jnp.rint``);
- ``int8_linear``: x [..., in] @ dequant(W).T with W = {int_data [out, in], scale
  [out]}. Weight-only by default; with ``dynamic_int8_act`` the activations are
  quantized rowwise too and the product runs through the NT int8 GEMM kernel
  (ops/int8_mm.py) with the weight in its stored layout;
- ``preset``: the product's output kept from an earlier forward on the same input (a
  remat policy's named save) or a placeholder (``ops/linear.py:linear_vjp``); the
  forward then returns it and launches nothing, and the backward is the same;
- its gradient (a ``torch.autograd.Function``, the JAX custom_vjp): never a weight
  or scale gradient, the int8 base is frozen by construction; grad_x = (g * scale) @
  int_data in g's dtype, or with ``dynamic_int8_bwd`` the weight scale is folded
  into g BEFORE g is quantized rowwise (the scale multiplies the contraction dim, so
  it cannot live in the epilogue; this rounding of g is the only lossy step) and the
  product runs through the KN int8 GEMM kernel against the same stored int_data,
  read as [K = out, N = in], with ones as the column scale;
- ``place`` (a sharded linear, parallel/sharding.py): the weight and scale given are this
  rank's shards; each pass gathers what is sharded over "fsdp" just before its product
  (the forward, and again the backward, whose KN GEMM reads the int8 weight) and keeps only
  the shards between them. Under tp the int8 rounding sees whole rows as GSPMD does: a
  row-parallel linear's activations (its input dimension over "tp") and a column-parallel
  one's scaled gradient (its output dimension over "tp") take their rowwise absmax over
  "tp" (``quantize_int8_rowwise`` given the mesh). A row-parallel product returns its partial
  sum dequantized in f32 (the sum over "tp" comes after, ops/linear.py); a
  column-parallel input gradient is this rank's partial, summed by ``copy_to_tp``.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.ops import int8_mm
from llama_x_tpu_torch.parallel.mesh import Mesh, all_reduce
from llama_x_tpu_torch.parallel.tensor import Placement, gather_now, tp_rows


def quantize_int8_rowwise(x: torch.Tensor, mesh: Mesh | None = None, axis: str = "tp"):
    """x [R, C] float -> (int8 [R, C], scale [R] in x's dtype). ``mesh``: x's columns are
    this rank's part of rows sharded over ``axis``, and a row's absmax is taken over the
    whole row (a max all-reduce of the [R] absmax before the rounding), so that the codes
    are the unsharded ones, as GSPMD sees the whole row."""
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    if mesh is not None:
        amax = all_reduce(mesh, amax, axis, op="max")
    scale = amax / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[:, None]).to(torch.int8)
    return q, scale.to(x.dtype)


def quantize_int8_colwise(x: torch.Tensor):
    """x [R, C] float -> (int8 [R, C], scale [C] in x's dtype)."""
    xf = x.float()
    scale = xf.abs().amax(dim=0) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[None, :]).to(torch.int8)
    return q, scale.to(x.dtype)


def _gathered(place: Placement | None, *ts):
    """``ts`` whole over "fsdp" where the linear is sharded there."""
    return ts if place is None else tuple(gather_now(t, place.mesh) for t in ts)


def _forward(x: torch.Tensor, int_data: torch.Tensor, scale: torch.Tensor, dynamic_int8_act: bool,
             place: Placement | None = None):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    row = tp_rows(place, "row")
    if dynamic_int8_act:
        x_i8, x_scale = quantize_int8_rowwise(x2, row)
        out = int8_mm.int8_mm_dequant_nt(x_i8, int_data, x_scale, scale,
                                         out_dtype=x.dtype if row is None else torch.float32)
    else:
        out = (x2 @ int_data.to(x.dtype).T) * scale.to(x.dtype)
    return out.reshape(*lead, int_data.shape[0])


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, int_data, scale, dynamic_int8_act, dynamic_int8_bwd, preset, place):
        ctx.save_for_backward(int_data, scale)
        ctx.x_dtype, ctx.dynamic_int8_bwd, ctx.place = x.dtype, dynamic_int8_bwd, place
        if preset is not None:
            return preset[0].detach()
        return _forward(x, *_gathered(place, int_data, scale), dynamic_int8_act, place)

    @staticmethod
    def backward(ctx, g):
        int_data, scale = _gathered(ctx.place, *ctx.saved_tensors)
        g = g.to(ctx.x_dtype)  # a row-parallel product's f32 output carries the activations' gradient
        if ctx.dynamic_int8_bwd:
            lead = g.shape[:-1]
            g2 = g.reshape(-1, g.shape[-1])
            g_i8, g_scale = quantize_int8_rowwise(g2 * scale.to(g2.dtype), tp_rows(ctx.place, "col"))
            ones = torch.ones(int_data.shape[1], dtype=torch.float32, device=g.device)
            gx = int8_mm.int8_mm_dequant(g_i8, int_data, g_scale, ones, out_dtype=ctx.x_dtype)
            gx = gx.reshape(*lead, int_data.shape[1])
        else:
            gx = ((g * scale.to(g.dtype)) @ int_data.to(g.dtype)).to(ctx.x_dtype)
        return gx, None, None, None, None, None, None


def int8_linear(x: torch.Tensor, int_data: torch.Tensor, scale: torch.Tensor, dynamic_int8_act: bool = False,
                dynamic_int8_bwd: bool = False, preset: torch.Tensor | None = None, place: Placement | None = None):
    """x [..., in] -> [..., out] through the int8 base, in x's dtype (a row-parallel product's
    partial sum in f32 with ``dynamic_int8_act``); differentiable in x only. With ``preset``
    (the output, known already) no product runs."""
    # the preset crosses into the Function inside a tuple: autograd then leaves it alone
    return _Int8Linear.apply(x, int_data, scale, dynamic_int8_act, dynamic_int8_bwd,
                             None if preset is None else (preset,), place)
