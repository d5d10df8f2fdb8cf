"""The step batch's data-parallel split (port of llama_x_tpu/parallel/sharding.py:
``batch_sharding``).

Batch leaves are [accum, mb, ...] (the trainers' contract): the microbatch axis is split
over dp, and the accumulation axis stays whole (it runs in order). Each rank keeps its
contiguous block of mb / dp rows. The sequence is split over cp later, inside the model,
after the embeddings and the stems (parallel/context.py: ``shard_sequence``), with the
labels, segment ids and prefix lengths beside it. ``param_specs`` / ``shard_params`` (fsdp
and tp parameter sharding) belong to slice 5b.
"""

from __future__ import annotations

from llama_x_tpu_torch.parallel.mesh import Mesh


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every [accum, mb, ...] leaf of ``batch``; raises when mb does not
    divide by the dp axis."""
    n = mesh.axis_size("dp")
    if n == 1:
        return batch
    i = mesh.index("dp")
    out = {}
    for k, v in batch.items():
        mb = v.shape[1]
        if mb % n:
            raise ValueError(f"microbatch {mb} of {k!r} must divide by the dp axis ({n})")
        out[k] = v[:, i * (mb // n):(i + 1) * (mb // n)]
    return out
