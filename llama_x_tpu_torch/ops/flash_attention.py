"""Flash attention with MaskInfo masking, forward (kernel K2,
``csrc/flash_attention.cu``) and backward (kernel K5, ``csrc/flash_attention_bwd.cu``).

Port of llama_x_tpu/ops/flash_attention.py. Forward (``_fwd_kernel`` through
``flash_fwd_with_lse`` and ``flash_attention``): online softmax in fp32 with exp2,
scale*log2e folded into q (one f32 multiply, one rounding to q's dtype), masked
logits -1e30, the l == 0 guard, and a natural-log lse [B, Hq, S, 1] beside the
output. Backward (``_bwd_dkv_kernel`` through ``_bwd`` and ``flash_bwd_from_res``):
the identical fold of q, p = exp2(s - lse*log2e), p rounded to the input dtype before
the dV product, ds = p * (dp - delta) * ln2 rounded before the dk and dq products,
f32 accumulation, dq scaled once at the end, dk / dv summed over the GQA group. The
mask is built in the kernels from ``causal``, ``segment_ids`` / ``kv_segment_ids``
and ``prefix_len`` and equals ops/attention.py's ``make_attention_mask``. The TPU's
block-alignment gate is not copied: the kernels mask a ragged S themselves. Dropout
and the ring offsets come later; ``dropout_rate > 0`` raises.

``flash_attention`` and ``flash_fwd_with_lse`` are differentiable: a
``torch.autograd.Function`` saves q, k, v, out, lse and its backward is
``flash_bwd_from_res``. On CPU tensors the wrappers run ``flash_fwd_plain`` /
``flash_bwd_plain``; on CUDA tensors they launch the kernels or raise (head_dim must be
64 or 128, dtype bfloat16, and the mask must carry no explicit positions or kv_len).
"""

from __future__ import annotations

import math

import torch

from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask
from llama_x_tpu_torch.utils import build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _check_mask(mi: MaskInfo) -> None:
    if mi.q_positions is not None or mi.kv_positions is not None or mi.kv_len is not None:
        raise ValueError("flash attention takes causal/segment/prefix masks only (no positions or kv_len)")


def flash_fwd_plain(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None):
    """Plain version of the kernel's arithmetic: q [B, S, Hq, D], k/v [B, S, Hkv, D]
    (model layout) -> (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S, 1] f32)."""
    mi = mask_info or MaskInfo(causal=False)
    _check_mask(mi)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)  # the wrapper-side fold of the JAX kernel
    qf = qs.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())  # base-2 logits [B, Hkv, g, Sq, Skv]
    mask = make_attention_mask(mi, Sq, Skv, B, device=q.device)
    if mask is not None:
        s = torch.where(mask[:, :, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log2(torch.clamp(l, min=1e-30))) * _LN2
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return out, lse.reshape(B, Hq, Sq, 1)


def _check_qkv(q, k, v):
    """What both kernels take: bf16 self-attention operands on one card, head_dim 64 or
    128, Hq a multiple of Hkv. Returns them contiguous."""
    B, S, Hq, D = q.shape
    if k.shape[:2] != (B, S) or k.shape != v.shape or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (self-attention, same S)")
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in (64, 128):
        raise ValueError(f"the flash kernels take head_dim 64 or 128, got {D}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernels take bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")
    return q, k, v


def _mask_operands(mi: MaskInfo, B: int, S: int, dev):
    """(qseg [B, S], kseg [B, S], prefix [B]) as int32 on ``dev``, None where absent."""
    def ids(x):
        return None if x is None else x.to(device=dev, dtype=torch.int32).expand(B, S).contiguous()

    qseg = ids(mi.segment_ids)
    kseg = ids(mi.kv_segment_ids if mi.kv_segment_ids is not None else mi.segment_ids)
    prefix = None if mi.prefix_len is None else mi.prefix_len.to(device=dev, dtype=torch.int32).reshape(B).contiguous()
    return qseg, kseg, prefix


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, mi: MaskInfo, scale: float):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    q, k, v = _check_qkv(q, k, v)
    _check_mask(mi)
    dev = q.device
    qseg, kseg, prefix = _mask_operands(mi, B, S, dev)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S, 1), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return out, lse
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    flash_fwd_with_lse.launches += 1
    build.check(
        lib.lxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg), _ptr(prefix),
            out.data_ptr(), lse.data_ptr(),
            B, S, Hq, Hkv, D, int(bool(mi.causal)), float(scale * _LOG2E), stream,
        ),
        "flash_attention",
    )
    return out, lse


def _forward_impl(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None):
    """(out, lse) without autograd: the kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask_info, scale)
    mi = mask_info or MaskInfo(causal=False)
    return _launch(q, k, v, mi, 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)


def flash_bwd_plain(q, k, v, out, lse, do, mask_info: MaskInfo | None = None, scale: float | None = None):
    """Plain version of the backward kernel's arithmetic, rounding points included:
    model-layout q/out/do [B, S, Hq, D], k/v [B, S, Hkv, D], lse [B, Hq, S, 1] f32 ->
    (dq, dk, dv) in the inputs' layouts and dtypes."""
    mi = mask_info or MaskInfo(causal=False)
    _check_mask(mi)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    fold = scale * _LOG2E
    qs = (q.float() * fold).to(q.dtype)  # the forward's fold, bit for bit
    qf = qs.reshape(B, Sq, Hkv, group, D).float()
    dof = do.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())  # base-2 logits [B, Hkv, g, Sq, Skv]
    p = torch.exp2(s - lse.reshape(B, Hkv, group, Sq, 1) * _LOG2E)
    mask = make_attention_mask(mi, Sq, Skv, B, device=q.device)
    if mask is not None:
        p = torch.where(mask[:, :, None], p, torch.zeros_like(p))
    delta = (do.float() * out.float()).sum(dim=-1)  # [B, Sq, Hq]
    delta = delta.reshape(B, Sq, Hkv, group).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = (p * (dp - delta) * _LN2).to(q.dtype).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * fold
    return dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_tolerance(ref: torch.Tensor) -> tuple[float, float]:
    """(atol, rtol) that holds one of the backward kernel's outputs to its plain version,
    per element: |got - ref| <= atol + rtol |ref| with rtol = 2^-7 and atol = 2^-5 rms(ref).

    Both sides round p and ds to bf16 at the same places, but their logits are f32 sums in
    another order, so now and then a p or ds falls on the other side of a bf16 rounding,
    and the two final casts to bf16 can land one ulp apart: 2^-7 |ref|. One flipped ds
    moves its whole dq row and dk row by 2^-8 of that one term, and a row that sees few
    keys (the start of a packed document) has terms far above the output's rms; the rms
    term covers those. Readings on one H100 at B 1, S 4096, 32/8 heads, D 128, as the
    largest excess over 2^-7 |ref| in units of rms(ref): causal 2^-6.7 and 2^-7.0 (two
    seeds), prefix-LM 2000 2^-7.8, 8 packed documents 2^-5.7 (dq: 2.598e-03 where
    rms(ref) is 0.137). A mask one position off, a lost GQA group member or a missing ln2
    moves elements by rms(ref) or more, 32 times the limit."""
    return 2**-5 * float(ref.float().pow(2).mean().sqrt()), 2**-7


def _launch_bwd(q, k, v, out, lse, do, mi: MaskInfo, scale: float):
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    q, k, v = _check_qkv(q, k, v)
    _check_mask(mi)
    if out.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (B, Hq, S, 1):
        raise ValueError(f"out {tuple(out.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise TypeError(f"the flash backward takes bfloat16 out/do and float32 lse, got {out.dtype}/{do.dtype}/{lse.dtype}")
    dev = q.device
    do, lse = do.contiguous(), lse.contiguous()
    if do.data_ptr() % 16:
        raise ValueError("do must be 16-byte aligned")
    # delta = rowsum(dO * O) in f32, laid out like lse ([B, Hq, S]); plain tensor code,
    # as it is outside the TPU kernel too
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    qseg, kseg, prefix = _mask_operands(mi, B, S, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk, dv
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    flash_bwd_from_res.launches += 1
    build.check(
        lib.lxt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(qseg), _ptr(kseg), _ptr(prefix), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, Hq, Hkv, D, int(bool(mi.causal)), float(scale * _LOG2E),
            0.0, 0, 0, 0,  # dropout_rate, seed and the TPU plan's (bq, bk) that would key it: not ported yet
            stream,
        ),
        "flash_attention_bwd",
    )
    return dq, dk, dv


def flash_bwd_from_res(q, k, v, out, lse, do, mask_info: MaskInfo | None = None, scale: float | None = None,
                       dropout_rate: float = 0.0):
    """(dq, dk, dv) from the forward's saved (out, lse): the kernel on CUDA tensors,
    its plain version on CPU tensors. The counterpart of ``flash_fwd_with_lse``."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout in the flash kernels is not ported yet (slice 2b)")
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, mask_info, scale)
    mi = mask_info or MaskInfo(causal=False)
    return _launch_bwd(q, k, v, out, lse, do, mi, 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)


flash_bwd_from_res.launches = 0


class _FlashAttention(torch.autograd.Function):
    """out, lse = flash forward; the backward runs from the saved q, k, v, out, lse.
    lse carries no gradient (as in the JAX custom_vjp, which returns out alone)."""

    @staticmethod
    def forward(ctx, q, k, v, mask_info, scale):
        out, lse = _forward_impl(q, k, v, mask_info, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_info, ctx.scale = mask_info, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_from_res(q, k, v, out, lse, do, ctx.mask_info, ctx.scale)
        return dq, dk, dv, None, None


def flash_fwd_with_lse(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None,
                       dropout_rate: float = 0.0):
    """Model-layout [B, S, H, D] in and out, plus the fp32 natural-log lse
    [B, Hq, S, 1]; differentiable in q, k, v. The kernels on CUDA tensors, their plain
    versions on CPU tensors."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout in the flash kernels is not ported yet (slice 2b)")
    return _FlashAttention.apply(q, k, v, mask_info, scale)


flash_fwd_with_lse.launches = 0


def flash_attention(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None,
                    dropout_rate: float = 0.0):
    """Flash attention over the model's [B, S, H, D] layout (output only)."""
    return flash_fwd_with_lse(q, k, v, mask_info, scale, dropout_rate)[0]
