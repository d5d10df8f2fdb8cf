"""int8 rowwise quantization and the quantized linear with its gradient.

Port of llama_x_tpu/ops/int8.py:
- rowwise / colwise symmetric quantization: fp32 math, scale = absmax / 127
  clipped at 1e-12, round half to even (``torch.round``, as ``jnp.rint``);
- ``int8_linear``: x [..., in] @ dequant(W).T with W = {int_data [out, in], scale
  [out]}. Weight-only by default; with ``dynamic_int8_act`` the activations are
  quantized rowwise too and the product runs through the NT int8 GEMM kernel
  (ops/int8_mm.py) with the weight in its stored layout;
- its gradient (a ``torch.autograd.Function``, the JAX custom_vjp): never a weight
  or scale gradient, the int8 base is frozen by construction; grad_x = (g * scale) @
  int_data in g's dtype, or with ``dynamic_int8_bwd`` the weight scale is folded
  into g BEFORE g is quantized rowwise (the scale multiplies the contraction dim, so
  it cannot live in the epilogue; this rounding of g is the only lossy step) and the
  product runs through the KN int8 GEMM kernel against the same stored int_data,
  read as [K = out, N = in], with ones as the column scale.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.ops import int8_mm


def quantize_int8_rowwise(x: torch.Tensor):
    """x [R, C] float -> (int8 [R, C], scale [R] in x's dtype)."""
    xf = x.float()
    scale = xf.abs().amax(dim=1) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[:, None]).to(torch.int8)
    return q, scale.to(x.dtype)


def quantize_int8_colwise(x: torch.Tensor):
    """x [R, C] float -> (int8 [R, C], scale [C] in x's dtype)."""
    xf = x.float()
    scale = xf.abs().amax(dim=0) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[None, :]).to(torch.int8)
    return q, scale.to(x.dtype)


def _forward(x: torch.Tensor, int_data: torch.Tensor, scale: torch.Tensor, dynamic_int8_act: bool):
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if dynamic_int8_act:
        x_i8, x_scale = quantize_int8_rowwise(x2)
        out = int8_mm.int8_mm_dequant_nt(x_i8, int_data, x_scale, scale, out_dtype=x.dtype)
    else:
        out = (x2 @ int_data.to(x.dtype).T) * scale.to(x.dtype)
    return out.reshape(*lead, int_data.shape[0])


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, int_data, scale, dynamic_int8_act, dynamic_int8_bwd):
        ctx.save_for_backward(int_data, scale)
        ctx.x_dtype, ctx.dynamic_int8_bwd = x.dtype, dynamic_int8_bwd
        return _forward(x, int_data, scale, dynamic_int8_act)

    @staticmethod
    def backward(ctx, g):
        int_data, scale = ctx.saved_tensors
        if ctx.dynamic_int8_bwd:
            lead = g.shape[:-1]
            g2 = g.reshape(-1, g.shape[-1])
            g_i8, g_scale = quantize_int8_rowwise(g2 * scale.to(g2.dtype))
            ones = torch.ones(int_data.shape[1], dtype=torch.float32, device=g.device)
            gx = int8_mm.int8_mm_dequant(g_i8, int_data, g_scale, ones, out_dtype=ctx.x_dtype)
            gx = gx.reshape(*lead, int_data.shape[1])
        else:
            gx = ((g * scale.to(g.dtype)) @ int_data.to(g.dtype)).to(ctx.x_dtype)
        return gx, None, None, None, None


def int8_linear(x: torch.Tensor, int_data: torch.Tensor, scale: torch.Tensor, dynamic_int8_act: bool = False,
                dynamic_int8_bwd: bool = False):
    """x [..., in] -> [..., out] through the int8 base, in x's dtype; differentiable
    in x only."""
    return _Int8Linear.apply(x, int_data, scale, dynamic_int8_act, dynamic_int8_bwd)
