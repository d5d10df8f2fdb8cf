"""Ring attention: exact attention over a sequence split across the "cp" axis of the mesh
(port of llama_x_tpu/ops/ring_attention.py).

Each rank holds its shard of S_local positions of q, k and v. The k / v shards (with their
segment ids) travel the ring, one step per rank: at step s rank r holds the block of rank
(r - s) mod cp and attends its resident q to it, and the blocks' partial softmaxes merge
exactly in log-sum-exp space (``_merge``: lse = logaddexp(lse_a, lse_b), out = out_a
e^(lse_a - lse) + out_b e^(lse_b - lse)). Masks use global positions: the q shard starts at
r * S_local, the block at its source's start; the prefix lengths are global.

Two paths, as in the JAX package:
- ``impl="flash"`` (on CUDA tensors, and asked for on the CPU): ``_RingFlash``, the
  counterpart of ``_make_ring_flash``. Its forward is cp steps of K2's ring form
  (``flash_fwd_ring``: bf16 out and f32 lse of one block) merged in f32; its backward is cp
  steps of K5's offsets form (``flash_bwd_ring``) with the FINAL merged out and lse and one
  delta = rowsum(dO * out), so p = exp(s - lse) is each block's exact share. The kernels add
  f32 dq into a resident accumulator and f32 dk / dv into accumulators that travel the ring
  WITH their kv block, so after cp steps block and gradient are home together. On CPU
  tensors the two block calls run their plain versions. The two loops are plain functions
  (``ring_fwd_with_lse``, ``ring_bwd_from_res``), which the int8-residual attention
  (models/llama.py:attention_q8) calls too, on its own residuals.
- ``impl="xla"`` (the default on CPU tensors): the plain ring of ``_block_attention`` and
  ``_merge`` in f32, differentiable by autograd through ``_Rotate`` (the ring's send as an
  autograd function whose backward sends the gradient the other way).
The lse merge stays plain PyTorch on both, as the JAX package leaves it to XLA. The next
block's exchange is started before the current block's kernel and waited for after it, so
the transfer overlaps the compute (with gloo the host copies do not).

The JAX package's TPU gate (``ring_flash_supported``) is not copied: on CUDA tensors the
kernels take head_dim 64 or 128, bf16 and no positions or kv_len, and raise otherwise.
"""

from __future__ import annotations

import math

import torch

from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask
from llama_x_tpu_torch.parallel.mesh import Mesh, RingExchange

_NEG_INF = -1e30


def _block_attention(q, k, v, mask, scale):
    """(out f32 [B, Sq, Hq, D], lse f32 [B, Sq, Hq]) of one block: q [B, Sq, Hq, D], k / v
    [B, Skv, Hkv, D], mask [B, 1, Sq, Skv] bool or None; GQA by head grouping, normalized
    per block so that the merge is a convex combination. A fully masked row has lse about
    -1e30: its merge weight underflows to 0."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    qf = q.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if mask is not None:
        s = torch.where(mask[:, :, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lse = m[..., 0] + torch.log(torch.clamp(l, min=1e-30))  # [B, Hkv, group, Sq]
    out = out / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, Hq, D), lse.permute(0, 3, 1, 2).reshape(B, Sq, Hq)


def _merge(out_a, lse_a, out_b, lse_b):
    """Log-sum-exp merge of two normalized partial attentions (associative)."""
    lse = torch.logaddexp(lse_a, lse_b)
    return out_a * torch.exp(lse_a - lse)[..., None] + out_b * torch.exp(lse_b - lse)[..., None], lse


class _Rotate(torch.autograd.Function):
    """The ring's send: every rank passes ``tensors`` to the next rank of the axis and
    takes its predecessor's; the backward passes the gradients back the other way. Integer
    tensors (segment ids) ride along without a gradient."""

    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        out = RingExchange(mesh, tensors, axis).wait()
        ctx.mark_non_differentiable(*[o for o in out if not o.is_floating_point()])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        floats = [(g if g is not None else torch.zeros(s, dtype=d, device=dev))
                  for g, (s, d, dev) in zip(grads, ctx.like) if d.is_floating_point]
        back = iter(RingExchange(ctx.mesh, floats, ctx.axis, reverse=True).wait())
        return (None, None, *[next(back) if d.is_floating_point else None for _, d, _ in ctx.like])


def _positions(S: int, start: int, device) -> torch.Tensor:
    return start + torch.arange(S, dtype=torch.int32, device=device)


def _ring_plain(q, k, v, mi: MaskInfo, scale: float, mesh: Mesh, axis: str):
    """The plain ring (the JAX ``impl="xla"`` path)."""
    n, my = mesh.axis_size(axis), mesh.index(axis)
    B, S, Hq, D = q.shape
    seg = mi.segment_ids
    kv_seg = seg
    out = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, S, Hq), _NEG_INF, dtype=torch.float32, device=q.device)
    q_pos = _positions(S, my * S, q.device)
    for step in range(n):
        kv_idx = (my - step) % n
        bmi = MaskInfo(causal=mi.causal, segment_ids=seg, kv_segment_ids=kv_seg if seg is not None else None,
                       prefix_len=mi.prefix_len, q_positions=q_pos, kv_positions=_positions(S, kv_idx * S, q.device))
        blk_out, blk_lse = _block_attention(q, k, v, make_attention_mask(bmi, S, S, B, device=q.device), scale)
        out, lse = _merge(out, lse, blk_out, blk_lse)
        if step < n - 1:  # the last block need not travel home
            if seg is None:
                k, v = _Rotate.apply(mesh, axis, k, v)
            else:
                k, v, kv_seg = _Rotate.apply(mesh, axis, k, v, kv_seg)
    return out.to(q.dtype)


def _block_mask(mi: MaskInfo, kv_seg) -> MaskInfo:
    """One block's MaskInfo for the kernels' ring form: local q segment ids, the block's."""
    return MaskInfo(causal=mi.causal, segment_ids=mi.segment_ids,
                    kv_segment_ids=kv_seg if mi.segment_ids is not None else None, prefix_len=mi.prefix_len)


def ring_fwd_with_lse(q, k, v, mi: MaskInfo, scale: float, mesh: Mesh, axis: str):
    """The ring's forward: cp steps of K2's ring form, each block's (out, lse) merged in f32
    as it arrives. q [B, S_local, Hq, D], k / v [B, S_local, Hkv, D] -> (out in q's dtype,
    the merged natural-log lse [B, Hq, S_local, 1] f32). No autograd: ``_RingFlash`` and the
    int8-residual attention (models/llama.py:attention_q8) call it."""
    n, my = mesh.axis_size(axis), mesh.index(axis)
    B, S, Hq, D = q.shape
    out = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hq, S, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    blk = [k, v] + ([mi.segment_ids] if mi.segment_ids is not None else [])
    for step in range(n):
        kv_idx = (my - step) % n
        nxt = RingExchange(mesh, blk, axis) if step < n - 1 else None
        o_b, l_b = fa.flash_fwd_ring(q, blk[0], blk[1], _block_mask(mi, blk[2] if len(blk) > 2 else None),
                                     my * S, kv_idx * S, scale)
        lse_new = torch.logaddexp(lse, l_b)
        w_a, w_b = (torch.exp(x - lse_new).transpose(1, 2) for x in (lse, l_b))  # [B, S, Hq, 1]
        out = out * w_a + o_b.float() * w_b
        lse = lse_new
        if nxt is not None:
            blk = nxt.wait()
    return out.to(q.dtype), lse


def ring_bwd_from_res(q, k, v, out, lse, do, mi: MaskInfo, scale: float, mesh: Mesh, axis: str):
    """The ring's backward from the forward's residuals: cp steps of K5's offsets form with
    the final ``out`` and ``lse`` and one delta = rowsum(dO * out), computed here from the
    ``out`` handed in. dq adds up in place; the f32 dk / dv accumulators travel the ring with
    their kv block, so after cp steps both are home. Returns (dq, dk, dv) of this rank's
    shard in q's / k's / v's dtypes."""
    n, my = mesh.axis_size(axis), mesh.index(axis)
    S = q.shape[1]
    do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [B, Hq, S], once per ring
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = [torch.zeros(k.shape, dtype=torch.float32, device=q.device) for _ in range(2)]
    blk = [k, v] + ([mi.segment_ids] if mi.segment_ids is not None else [])
    for step in range(n):
        kv_idx = (my - step) % n
        nxt = RingExchange(mesh, blk, axis) if step < n - 1 else None
        fa.flash_bwd_ring(q, blk[0], blk[1], out, lse, do, delta, (dq, *dkv),
                          _block_mask(mi, blk[2] if len(blk) > 2 else None), my * S, kv_idx * S, scale)
        # the dk / dv accumulators travel with their block: after n steps both are home
        dkv = RingExchange(mesh, dkv, axis, tag=1).wait()
        if nxt is not None:
            blk = nxt.wait()
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """Ring attention on K2's ring form (forward) and K5's offsets form (backward)."""

    @staticmethod
    def forward(ctx, q, k, v, mi: MaskInfo, scale: float, mesh: Mesh, axis: str):
        out, lse = ring_fwd_with_lse(q, k, v, mi, scale, mesh, axis)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mi, ctx.scale, ctx.mesh, ctx.axis = mi, scale, mesh, axis
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_bwd_from_res(q, k, v, out, lse, do, ctx.mi, ctx.scale, ctx.mesh, ctx.axis)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, mask_info: MaskInfo | None = None,
                   scale: float | None = None, axis_name: str = "cp", impl: str = "auto") -> torch.Tensor:
    """Exact attention over a sequence split across ``axis_name``. q / k / v: this rank's
    shard [B, S_local, H, D] (the same S_local on every rank); ``mask_info.segment_ids``: the
    local shard's ids (the kv blocks' ride the ring with k / v), ``prefix_len`` the global
    lengths. Returns the local output shard.

    impl: "auto" runs the kernels on CUDA tensors and the plain ring on CPU tensors;
    "flash" the ring on K2 / K5 (their plain versions on CPU tensors); "xla" the plain ring
    (CPU tensors only: on the card the ring runs the kernels or raises)."""
    mi = mask_info or MaskInfo(causal=False)
    if mi.q_positions is not None or mi.kv_positions is not None or mi.kv_len is not None:
        raise ValueError("decode metadata is not context-parallel")
    if mi.kv_segment_ids is not None:
        raise ValueError("ring attention takes the local shard's segment_ids only (the kv blocks' travel the ring)")
    if impl == "auto":
        impl = "flash" if q.is_cuda else "xla"
    if impl not in ("flash", "xla"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'xla', got {impl!r}")
    if impl == "xla" and q.is_cuda:
        raise ValueError("the plain ring (impl='xla') runs on CPU tensors; on the card the ring runs the kernels")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "xla":
        return _ring_plain(q, k, v, mi, scale, mesh, axis_name)
    return _RingFlash.apply(q, k, v, mi, float(scale), mesh, axis_name)
