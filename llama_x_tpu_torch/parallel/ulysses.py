"""Ulysses sequence parallelism: all-to-all head scatter over the "cp" axis (port of
llama_x_tpu/parallel/ulysses.py).

Where ring attention keeps q resident and passes k / v around the ring, Ulysses
redistributes once each way:

    [B, S/n, H, D]  --all_to_all(heads -> sequence)-->  [B, S, H/n, D]
    attention over the FULL sequence with the FULL mask (K2 / K5 in their normal form)
    [B, S, H/n, D]  --all_to_all(sequence -> heads)-->  [B, S/n, H, D]

It needs Hq % n == 0; GQA kv heads are first repeated up to lcm(Hkv, n) (``_kv_repeat``),
which keeps every q head with its kv head. Each all-to-all is a ``torch.autograd.Function``
whose backward is the other one. The rank-local view (see parallel/context.py): the
segment ids come in as the local shard's and are gathered over the axis, since every rank
attends over the whole sequence after the scatter; the prefix lengths are global.
"""

from __future__ import annotations

import math

import torch

from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.parallel.mesh import Mesh, all_gather, all_to_all


def _kv_repeat(Hq: int, Hkv: int, n: int) -> int | None:
    """Smallest g such that the g-fold replicated kv heads (Hkv * g) split evenly over the
    axis (n | Hkv * g) while keeping the GQA grouping (Hkv * g | Hq); None when the geometry
    cannot be head-scattered (ring attention is then the context-parallel path)."""
    m = math.lcm(Hkv, n)
    return m // Hkv if Hq % m == 0 else None


def ulysses_supported(S: int, Hq: int, Hkv: int, n: int, mi: MaskInfo) -> bool:
    """True when the head scatter covers this call (training / prefill attention; decode
    metadata never reaches context parallelism)."""
    return (
        mi.q_positions is None
        and mi.kv_positions is None
        and mi.kv_len is None
        and S % n == 0
        and Hq % n == 0
        and _kv_repeat(Hq, Hkv, n) is not None
    )


def _heads_to_seq(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """[B, S/n, H, D] -> [B, S, H/n, D]: head slice i goes to rank i, sequence block j comes from rank j."""
    n = mesh.axis_size(axis)
    B, S_l, H, D = x.shape
    parts = x.reshape(B, S_l, n, H // n, D).permute(2, 0, 1, 3, 4)
    return all_to_all(mesh, parts.contiguous(), axis).permute(1, 0, 2, 3, 4).reshape(B, n * S_l, H // n, D)


def _seq_to_heads(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """[B, S, H/n, D] -> [B, S/n, H, D], the inverse of ``_heads_to_seq``."""
    n = mesh.axis_size(axis)
    B, S, Hn, D = x.shape
    parts = x.reshape(B, n, S // n, Hn, D).permute(1, 0, 2, 3, 4)
    return all_to_all(mesh, parts.contiguous(), axis).permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hn, D)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _heads_to_seq(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(ctx.mesh, g.contiguous(), ctx.axis), None, None


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _seq_to_heads(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(ctx.mesh, g.contiguous(), ctx.axis), None, None


def _prepare(q, k, mi: MaskInfo, mesh: Mesh, axis: str) -> tuple[int, MaskInfo]:
    """(g, the whole sequence's MaskInfo): the checks, the kv repeat ``g`` and the segment ids
    gathered over the axis (every rank attends over the whole sequence after the scatter)."""
    if mi.q_positions is not None or mi.kv_positions is not None or mi.kv_len is not None:
        raise ValueError("decode metadata is not context-parallel")
    n = mesh.axis_size(axis)
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % n:
        raise ValueError(f"Ulysses needs num_heads ({Hq}) divisible by the {axis} axis ({n})")
    g = _kv_repeat(Hq, Hkv, n)
    if g is None:
        raise ValueError(f"no kv replication factor for Hq={Hq}, Hkv={Hkv}, n={n}")
    seg = None if mi.segment_ids is None else all_gather(mesh, mi.segment_ids, axis, dim=1)
    return g, MaskInfo(causal=mi.causal, segment_ids=seg, prefix_len=mi.prefix_len)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, mask_info: MaskInfo | None = None,
                      scale: float | None = None, axis_name: str = "cp") -> torch.Tensor:
    """q [B, S_local, Hq, D], k / v [B, S_local, Hkv, D]: this rank's shard of a sequence
    split over ``axis_name``; ``mask_info.segment_ids`` the local shard's ids, ``prefix_len``
    the global lengths. Returns the local output shard. The local attention is the flash
    forward / backward (the kernels on CUDA tensors, their plain versions on CPU tensors).
    Raises when the head geometry cannot be scattered: ``ulysses_supported`` routes such
    models to ring attention."""
    g, full = _prepare(q, k, mask_info or MaskInfo(causal=False), mesh, axis_name)
    if g > 1:
        # the local GQA grouping (q head j -> kv head j // group') then reproduces the global
        # h -> h // (Hq / Hkv) exactly
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    q, k, v = (_HeadsToSeq.apply(t, mesh, axis_name) for t in (q, k, v))
    out = fa.flash_attention(q, k, v, full, scale)
    return _SeqToHeads.apply(out, mesh, axis_name)


# ---------------------------------------------------------------------------
# forward and backward as plain functions, for a caller that keeps its own residuals (the
# int8-residual attention, models/llama.py:attention_q8). The residuals stay in the local
# rows [B, S_local, H, D], as the caller holds q / k / v and the output; only the lse is in
# the head shard's layout [B, Hq / n, S, 1], as the flash forward gave it.
# ---------------------------------------------------------------------------


def ulysses_fwd_with_lse(q, k, v, mi: MaskInfo, scale: float, mesh: Mesh, axis: str):
    """heads -> sequence for q / k / v (k / v repeated g times first), the flash forward
    over the whole sequence, sequence -> heads for the output. Returns (out [B, S_local, Hq, D]
    in q's dtype, lse [B, Hq / n, S, 1] f32, the whole sequence's MaskInfo), what
    ``ulysses_bwd_from_res`` takes besides the local rows. No autograd."""
    g, full = _prepare(q, k, mi, mesh, axis)
    if g > 1:
        k, v = (torch.repeat_interleave(t, g, dim=2) for t in (k, v))
    q, k, v = (_heads_to_seq(mesh, t.contiguous(), axis) for t in (q, k, v))
    out, lse = fa.flash_fwd_with_lse(q, k, v, full, scale)
    return _seq_to_heads(mesh, out, axis), lse, full


def ulysses_bwd_from_res(q, k, v, out, lse, do, full: MaskInfo, scale: float, mesh: Mesh, axis: str):
    """(dq, dk, dv) of the local rows from the local q / k / v / out / do and the forward's
    lse and MaskInfo (``ulysses_fwd_with_lse``): heads -> sequence for the five, the flash
    backward from them, sequence -> heads for the three gradients, and dk / dv summed over
    their g repeated copies (what autograd of the repeat does in ``ulysses_attention``)."""
    Hkv = k.shape[2]
    g = _kv_repeat(q.shape[2], Hkv, mesh.axis_size(axis))
    if g > 1:
        k, v = (torch.repeat_interleave(t, g, dim=2) for t in (k, v))
    q, k, v, out, do = (_heads_to_seq(mesh, t.contiguous(), axis) for t in (q, k, v, out, do))
    grads = fa.flash_bwd_from_res(q, k, v, out, lse, do, full, scale)
    dq, dk, dv = (_seq_to_heads(mesh, t.contiguous(), axis) for t in grads)
    if g > 1:
        B, S, _, D = dk.shape
        dk, dv = (t.reshape(B, S, Hkv, g, D).sum(dim=3) for t in (dk, dv))
    return dq, dk, dv
