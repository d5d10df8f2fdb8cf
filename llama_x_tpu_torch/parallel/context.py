"""Context parallelism: the sequence split over the mesh's "cp" axis (port of
llama_x_tpu/parallel/context.py).

The JAX package hands ``context_parallel_attention`` the full q / k / v and a mesh, and
``shard_map`` gives each device its S/cp slice (a global view). The port is rank-local:
every rank is a process that already holds its contiguous slice of the sequence, positions
[r * S_local, (r + 1) * S_local) for cp rank r, of q, k, v and of the segment ids, with the
prefix lengths replicated; the attention returns the local output slice. The numbers are
the same. The model splits its sequence once, after the embeddings (and the modality stems),
with ``shard_sequence``, runs RoPE at the global positions (``sequence_start``), and
normalizes its loss over the axis (``loss_share``).
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.ops.cross_entropy import IGNORE_INDEX
from llama_x_tpu_torch.ops.ring_attention import ring_attention
from llama_x_tpu_torch.parallel.mesh import Mesh, all_reduce


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                               mask_info: MaskInfo | None = None, scale: float | None = None,
                               axis_name: str = "cp", impl: str = "auto") -> torch.Tensor:
    """q [B, S_local, Hq, D], k / v [B, S_local, Hkv, D]: this rank's slice of the sequence.
    Takes causal, segment-id (the local slice's) and prefix-LM (global lengths) masks, no
    decode metadata. Returns the local output slice (ring attention)."""
    mi = mask_info or MaskInfo(causal=False)
    if mi.q_positions is not None or mi.kv_positions is not None or mi.kv_len is not None:
        raise ValueError("decode metadata is not context-parallel")
    return ring_attention(q, k, v, mesh, mi, scale, axis_name=axis_name, impl=impl)


def seq_shard(x: torch.Tensor | None, mesh: Mesh) -> torch.Tensor | None:
    """This rank's contiguous slice of ``x`` along dim 1 (the sequence); raises when the
    length does not divide by the cp axis."""
    n = mesh.axis_size("cp")
    if x is None or n == 1:
        return x
    S = x.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} must divide by the cp axis ({n})")
    S_l = S // n
    return x.narrow(1, mesh.index("cp") * S_l, S_l)


def shard_sequence(mesh: Mesh, x: torch.Tensor, mask_info: MaskInfo, labels: torch.Tensor | None):
    """(x, mask_info, labels) of this rank's slice: x [B, S, D] and the labels [B, S] (aligned
    to positions: label t is the target at position t, so a slice loses none at its
    boundary) and segment ids cut along the sequence; prefix lengths stay global."""
    seg = seq_shard(mask_info.segment_ids, mesh)
    return seq_shard(x, mesh), mask_info._replace(segment_ids=seg), seq_shard(labels, mesh)


def sequence_start(mesh: Mesh, S_local: int) -> int:
    """The global position of this rank's first row."""
    return mesh.index("cp") * S_local


def loss_share(mesh: Mesh, loss: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean loss over the cp axis: ``loss`` is the mean over the
    local labels that are not ignored; the share is their sum over the axis' count, so the
    shares add up to the mean over the whole sequence."""
    n = (labels != IGNORE_INDEX).sum()
    total = all_reduce(mesh, n, "cp")
    return loss * (n.float() / total.clamp(min=1).float())
