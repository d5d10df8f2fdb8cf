"""What GSPMD inserts around a sharded parameter, written out (the port's own module: the
JAX package declares placements in ``parallel/sharding.py`` and lets XLA add these).

A sharded tensor carries its placement as two attributes that ``shard_params`` sets:
``shard_spec`` (one mesh axis or None per dimension, in the tensor's own layout) and
``full_shape`` (its shape unsharded). The functions below read them.

- ``copy_to_tp``: identity forward, all-reduce over "tp" backward. It stands for the
  implicit all-reduce of the gradient of a tensor replicated over "tp" that feeds a
  tp-sharded product: the input of a column-parallel linear (``P(None, "tp")`` out of a
  replicated activation), the rank-r activation ``x @ lora_a`` before the sharded
  ``lora_b``, a row-parallel linear's replicated ``lora_b``.
- ``reduce_from_tp``: all-reduce over "tp" forward, identity backward. It stands for the
  psum GSPMD inserts after a contraction over a tp-sharded dimension (a row-parallel
  linear ``P("tp", ...)`` on its input, the vocabulary-parallel embedding's lookup).
- ``gather``: a sharded tensor whole along the dimensions sharded over the named axes
  (an fsdp ``all-gather`` before use, ZeRO-3); its backward gives each rank its slice of
  the gradient, summed over "fsdp" (the reduce-scatter GSPMD pairs with that gather) and
  taken as it is over "tp" (every tp rank holds the whole gradient already).
- ``vocab_parallel_embedding``: the lookup in a ``P("tp", ...)`` embedding: ids outside
  this rank's rows give 0, then the sum over "tp".

The placement is decoded here and nowhere else: ``placement`` / ``tp_kind`` / ``tp_rows``
(a linear's mesh and tp role), ``sharded_axes``, ``stage_local`` and ``whole_shape`` (a
tensor's), ``shard_grad`` (a whole gradient cut back to a shard, ``gather``'s backward).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from llama_x_tpu_torch.parallel.mesh import AXES, Mesh, all_gather, all_reduce, reduce_scatter, shard_bounds


def spec_of(t: torch.Tensor) -> tuple | None:
    return getattr(t, "shard_spec", None)


def mesh_of(module) -> Mesh | None:
    """The mesh ``shard_params`` placed ``module`` on, or None."""
    return getattr(module, "mesh", None)


def tp_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.axis_size("tp")


class Placement(NamedTuple):
    """A sharded linear's mesh and its tensor-parallel role ("col", "row" or None)."""

    mesh: Mesh
    kind: str | None


def placement(module) -> Placement | None:
    """The mesh and tp role ``shard_params`` gave a linear, or None (a whole linear)."""
    mesh = mesh_of(module)
    return None if mesh is None else Placement(mesh, getattr(module, "tp_kind", None))


def tp_kind(place: Placement | None) -> str | None:
    """"col" / "row" where the linear's tp role needs collectives (tp above 1)."""
    return place.kind if place is not None and tp_size(place.mesh) > 1 else None


def tp_rows(place: Placement | None, kind: str) -> Mesh | None:
    """The mesh whose "tp" axis splits the rows that a linear of role ``kind`` quantizes
    (a row-parallel linear's input, a column-parallel one's output), where it does."""
    return place.mesh if tp_kind(place) == kind else None


def sharded_axes(t: torch.Tensor, mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes (above size 1) a tensor is sharded over, in the order of ``AXES``."""
    spec = spec_of(t) or ()
    return tuple(a for a in AXES if a in spec and mesh.axis_size(a) > 1)


def stage_local(t: torch.Tensor) -> bool:
    """Whether a pipeline stage alone holds ``t`` (its gradient is not summed over "pp")."""
    return getattr(t, "pp_local", False)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, "tp"), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(mesh, x, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    return x if tp_size(mesh) == 1 else _CopyToTp.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    return x if tp_size(mesh) == 1 else _ReduceFromTp.apply(x, mesh)


def _gathered_dims(t: torch.Tensor, mesh: Mesh | None, axes) -> list[tuple[int, str]]:
    spec = spec_of(t)
    if spec is None or mesh is None:
        return []
    return [(d, a) for d, a in enumerate(spec) if a in axes and mesh.axis_size(a) > 1]


def gather_now(t: torch.Tensor, mesh: Mesh | None, axes=("fsdp",), like: torch.Tensor | None = None) -> torch.Tensor:
    """``t`` whole along its dimensions sharded over ``axes`` (every axis: ``AXES``), no
    gradient; ``like``: the sharded tensor whose placement ``t`` has (a gradient, a moment)."""
    like = t if like is None else like
    out = t
    for d, a in _gathered_dims(like, mesh, axes):
        out = all_gather(mesh, out.detach(), a, d, total=like.full_shape[d])
    return out


def local_slice(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's ``shard_bounds`` slice of a whole tensor along ``dim`` over ``axis``."""
    lo, hi = shard_bounds(t.shape[dim], mesh.axis_size(axis), mesh.index(axis))
    return t.narrow(dim, lo, hi - lo)


def whole_shape(t: torch.Tensor, mesh: Mesh | None, axes=("fsdp",)) -> tuple[int, ...]:
    """``t``'s shape once ``gather(t, mesh, axes)`` has made it whole over ``axes``."""
    shape = list(t.shape)
    for d, _ in _gathered_dims(t, mesh, axes):
        shape[d] = t.full_shape[d]
    return tuple(shape)


def local_part(t: torch.Tensor, mesh: Mesh | None, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of a whole tensor ``t`` placed as the sharded tensor ``like``."""
    for d, a in _gathered_dims(like, mesh, AXES):
        t = local_slice(t, mesh, a, d)
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dims, full):
        ctx.mesh, ctx.dims = mesh, dims
        for d, a in dims:
            t = all_gather(mesh, t, a, d, total=full[d])
        return t

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.dims), None, None, None


def _scatter(g: torch.Tensor, mesh: Mesh, dims) -> torch.Tensor:
    for d, a in reversed(dims):
        g = reduce_scatter(mesh, g, a, d) if a == "fsdp" else local_slice(g, mesh, a, d).contiguous()
    return g


def shard_grad(g: torch.Tensor, like: torch.Tensor, mesh: Mesh | None, axes=("fsdp",)) -> torch.Tensor:
    """The gradient ``g`` of ``gather(like, mesh, axes)`` cut back to ``like``'s placement:
    what ``gather``'s backward gives, for a caller that gathered outside autograd."""
    return _scatter(g, mesh, _gathered_dims(like, mesh, axes))


def gather(t: torch.Tensor, mesh: Mesh | None, axes=("fsdp",)) -> torch.Tensor:
    """``t`` whole along its dimensions sharded over ``axes``, differentiable (see the module
    docstring); ``t`` itself where nothing is sharded over them."""
    dims = _gathered_dims(t, mesh, axes)
    if not dims:
        return t
    if not t.requires_grad or not torch.is_grad_enabled():
        return gather_now(t, mesh, axes)
    return _Gather.apply(t, mesh, dims, t.full_shape)


def vocab_parallel_embedding(tokens: torch.Tensor, weight: torch.Tensor, mesh: Mesh, vocab: int) -> torch.Tensor:
    """Rows of a [V, D] embedding whose vocabulary is sharded over "tp" (``weight`` is this
    rank's [V_local, D] rows, whole over D): ids outside the shard give 0, and the sum over
    "tp" gives every id its row."""
    lo, hi = shard_bounds(vocab, mesh.axis_size("tp"), mesh.index("tp"))
    inside = (tokens >= lo) & (tokens < hi)
    if hi == lo:  # an empty last shard of a vocabulary that does not divide
        return reduce_from_tp(weight.new_zeros((*tokens.shape, weight.shape[1])), mesh)
    x = torch.nn.functional.embedding(torch.where(inside, tokens - lo, torch.zeros_like(tokens)), weight)
    return reduce_from_tp(torch.where(inside[..., None], x, torch.zeros_like(x)), mesh)

