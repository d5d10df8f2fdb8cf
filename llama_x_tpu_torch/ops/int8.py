"""int8 rowwise quantization and the quantized linear with its gradient.

Port of llama_x_tpu/ops/int8.py:
- rowwise / colwise symmetric quantization: fp32 math, scale = absmax / 127
  clipped at 1e-12, round half to even (``torch.round``, as ``jnp.rint``). On a CUDA tensor
  the rowwise form is one kernel, K7 (``quantize_rows``, ``csrc/quantize_rows.cu``; two
  launches where the rows are split over a mesh), bit for bit with the plain chain on the card
  (``quantize_rows_plain``), where PyTorch takes the scale as absmax times the f32 reciprocal
  of 127;
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

from llama_x_tpu_torch.ops import int8_mm, launches
from llama_x_tpu_torch.parallel.mesh import Mesh, all_reduce
from llama_x_tpu_torch.parallel.tensor import Placement, gather_now, tp_rows
from llama_x_tpu_torch.utils import build

# K7's plan (csrc/quantize_rows.cu, which holds a thread's loads in registers and picks the
# group of threads a row): a row streams at most QUANTIZE_SPANS spans of a group's loads, or
# one span where the rows are fewer than the SMs (decode: every row's loads in flight at
# once). On the H100 up to three spans ran the training shapes at 0.74-0.89 of the bytes'
# bound (PERF.md §6).
QUANTIZE_SPANS = 3
_QUANTIZE_DTYPES = (torch.bfloat16, torch.float32)
_WHOLE, _ABSMAX, _CODES = 0, 1, 2  # the kernel's passes (csrc/quantize_rows.cu: Pass)


def quantize_int8_rowwise(x: torch.Tensor, mesh: Mesh | None = None, axis: str = "tp",
                          col_scale: torch.Tensor | None = None, scale_dtype=None):
    """x [R, C] float -> (int8 [R, C], scale [R] in ``scale_dtype``, by default x's dtype).
    ``col_scale`` [C] in x's dtype: the rows of x * col_scale are quantized, the product
    rounded to x's dtype. ``mesh``: x's columns are this rank's part of rows sharded over
    ``axis``, and a row's absmax is taken over the whole row (a max all-reduce of the [R]
    absmax before the rounding), so that the codes are the unsharded ones, as GSPMD sees the
    whole row. K7 on a CUDA tensor (which raises on what it does not take), the plain chain
    on the CPU."""
    if x.is_cuda:
        return quantize_rows(x.contiguous(), col_scale, scale_dtype, mesh=mesh, axis=axis)
    return quantize_rows_plain(x, col_scale, scale_dtype, mesh=mesh, axis=axis)


def quantize_rows_plain(x: torch.Tensor, col_scale: torch.Tensor | None = None, scale_dtype=None,
                        mesh: Mesh | None = None, axis: str = "tp"):
    """K7's plain version, on any device, as ``quantize_int8_rowwise``."""
    if col_scale is not None:
        x = x * col_scale
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    if mesh is not None:
        amax = all_reduce(mesh, amax, axis, op="max")
    scale = amax / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[:, None]).to(torch.int8)
    return q, scale.to(scale_dtype or x.dtype)


def quantize_rows_plan(R: int, C: int, itemsize: int, aligned: bool, sms: int = int8_mm.H100_SMS) -> tuple[int, int]:
    """K7's (elements a load, spans a row) for R rows of C elements of ``itemsize`` bytes on a
    card of ``sms`` SMs: 16-byte loads where x and the column scale start 16-byte aligned
    (``aligned``) and C is a whole number of them, else single elements; QUANTIZE_SPANS spans,
    or one for fewer rows than SMs."""
    vec = 16 // itemsize if aligned and C % (16 // itemsize) == 0 else 1
    return vec, 1 if R < sms else QUANTIZE_SPANS


def quantize_rows(x: torch.Tensor, col_scale: torch.Tensor | None = None, scale_dtype=None,
                  mesh: Mesh | None = None, axis: str = "tp"):
    """K7: x [R, C] bf16 or f32 on the card, contiguous, times ``col_scale`` [C] in x's dtype
    where given -> (int8 [R, C], scale [R] in ``scale_dtype``: x's dtype by default, or f32).
    One launch; with ``mesh`` two, the absmax pass and the codes pass, with the max all-reduce
    of the absmax over ``axis`` between them. Raises on anything else: the plain version takes
    CPU tensors."""
    if x.dtype not in _QUANTIZE_DTYPES:
        raise TypeError(f"quantize_rows takes bfloat16 or float32 rows, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quantize_rows takes [R, C] rows with C > 0, got {tuple(x.shape)}")
    R, C = x.shape
    if not x.is_contiguous():
        raise ValueError(f"quantize_rows needs contiguous rows, got strides {x.stride()}: make x contiguous first")
    if col_scale is not None and (col_scale.dtype != x.dtype or col_scale.shape != (C,)
                                  or not col_scale.is_contiguous()):
        raise ValueError(f"col_scale must be a contiguous [{C}] {x.dtype} vector, got {tuple(col_scale.shape)} "
                         f"{col_scale.dtype}")
    scale_dtype = scale_dtype or x.dtype
    if scale_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"the scale of {x.dtype} rows is {x.dtype} or float32, not {scale_dtype}")
    if not (x.is_cuda and (col_scale is None or col_scale.device == x.device)):
        raise ValueError("quantize_rows runs on CUDA tensors of one device; the plain version takes the others")
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scale = torch.empty(R, dtype=scale_dtype, device=x.device)
    if R == 0:
        return q, scale
    f32_scale = scale_dtype == torch.float32
    if mesh is None:
        _launch(_WHOLE, x, col_scale, q, scale, None, f32_scale)
    else:
        amax = torch.empty(R, dtype=torch.float32, device=x.device)
        _launch(_ABSMAX, x, col_scale, None, None, amax, f32_scale)
        _launch(_CODES, x, col_scale, q, scale, all_reduce(mesh, amax, axis, op="max").contiguous(), f32_scale)
    return q, scale


def _launch(pass_: int, x, col_scale, q, scale, amax, f32_scale: bool) -> None:
    """One launch of K7's ``pass_`` over x's rows, which ``quantize_rows`` has checked."""
    R, C = x.shape
    aligned = x.data_ptr() % 16 == 0 and (col_scale is None or col_scale.data_ptr() % 16 == 0)
    vec, spans = quantize_rows_plan(R, C, x.element_size(), aligned, int8_mm._sm_count(x.device))
    lib = build.load_library()
    launches.add(quantize_rows)
    ptr = [None if t is None else t.data_ptr() for t in (col_scale, q, scale, amax)]
    build.check(lib.lxt_quantize_rows(x.data_ptr(), *ptr, R, C, int(x.dtype == torch.float32), int(f32_scale), vec,
                                      spans, pass_, torch.cuda.current_stream(x.device).cuda_stream), "quantize_rows")


launches.counted("quantize_rows", quantize_rows, r"quantize_rows_kernel")


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
            g_i8, g_scale = quantize_int8_rowwise(g2, tp_rows(ctx.place, "col"), col_scale=scale.to(g2.dtype))
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
