"""Per-tensor sharding rules and the batch split (port of llama_x_tpu/parallel/sharding.py).

The rule table is the JAX package's ``_RULES``, matched on the JAX tree path of each of the
port's tensors (``adapters/lora.py:tree_path``): Megatron-style tp over attention heads,
the FFN hidden dimension and the vocabulary, ZeRO-3 fsdp over the other large dimension,
LoRA's ``lora_a`` on the base's input dimension and ``lora_b`` on its output dimension,
norms and stems replicated. With ``pp`` the stacked layer axis of every ``layers/`` tensor
is sharded over "pp" (stage s holds layers [s·L/P, (s+1)·L/P)).

``param_specs(model, pp)`` gives each tensor's spec as JAX would see it on the stacked
tree, but in the port's layout: a layer tensor's spec leads with the layer axis, and a
float base ``weight [out, in]`` (the JAX ``kernel [in, out]`` transposed) has its two
entries swapped, as the JAX rules swap them for ``int_data``. ``shard_params(model, mesh)``
keeps on each rank only its slice of every tensor (uneven dimensions cut as GSPMD cuts
them: ``parallel/mesh.py:shard_bounds``), drops the layers of other pipeline stages, and
marks the placement that model code reads (``parallel/tensor.py``): each sharded tensor's
``shard_spec`` / ``full_shape``, each linear's ``tp_kind`` ("col": wq, wk, wv, w1, w3;
"row": wo, w2) and the mesh on the model and its linears. It is idempotent.
``full_state_dict`` is the way back (every tensor whole, for a checkpoint), and
``load_full_state_dict`` loads whole tensors into a sharded model, each rank taking its
slices.

Batch leaves are [accum, mb, ...] (the trainers' contract): the microbatch axis is split
over the batch axes (dp, fsdp) and the accumulation axis stays whole (it runs in order).
Each rank keeps its contiguous block of mb / (dp·fsdp) rows. The sequence is split over cp
later, inside the model (parallel/context.py: ``shard_sequence``).
"""

from __future__ import annotations

import re

import torch
from torch import nn

from llama_x_tpu_torch.parallel.mesh import AXES, Mesh, shard_bounds
from llama_x_tpu_torch.parallel.tensor import gather_now, local_part

# (path regex, spec for the unstacked trailing dims): the JAX package's table
_RULES: list[tuple[str, tuple]] = [
    (r"tok_embeddings/weight$", ("tp", "fsdp")),
    (r"(attention/w[qkv]|feed_forward/w[13])/kernel$", ("fsdp", "tp")),
    (r"(attention/wo|feed_forward/w2)/kernel$", ("tp", "fsdp")),
    # int8: int_data is [out, in] = kernel transposed -> swap the kernel spec
    (r"(attention/w[qkv]|feed_forward/w[13])/int_data$", ("tp", "fsdp")),
    (r"(attention/wo|feed_forward/w2)/int_data$", ("fsdp", "tp")),
    (r"(attention/w[qkv]|feed_forward/w[13])/scale$", ("tp",)),
    (r"(attention/wo|feed_forward/w2)/scale$", ("fsdp",)),
    # LoRA: a maps the input dim (shard like kernel dim 0), b maps the output dim
    (r"(attention/w[qkv]|feed_forward/w[13])/lora_a$", ("fsdp", None)),
    (r"(attention/w[qkv]|feed_forward/w[13])/lora_b$", (None, "tp")),
    (r"(attention/wo|feed_forward/w2)/lora_a$", ("tp", None)),
    (r"(attention/wo|feed_forward/w2)/lora_b$", (None, "fsdp")),
    (r"/m$", ("tp",)),
    (r"output/kernel$", ("fsdp", "tp")),
]
COLUMN = ("wq", "wk", "wv", "w1", "w3")  # column-parallel: out over tp
ROW = ("wo", "w2")  # row-parallel: in over tp


def _spec_for(name: str, ndim: int, pp: bool = False) -> tuple:
    """The JAX ``_spec_for`` on a JAX tree path, padded with None to ``ndim`` entries."""
    layer_axis = "pp" if (pp and name.startswith("layers/")) else None
    for pattern, spec in _RULES:
        if re.search(pattern, name):
            extra = ndim - len(spec)
            if extra > 0:  # the stacked layer axis (+ any other leading axes)
                spec = (layer_axis, *([None] * (extra - 1)), *spec)
            return spec + (None,) * (ndim - len(spec))
    if pp and name.startswith("layers/") and ndim > 0:
        return (layer_axis,) + (None,) * (ndim - 1)
    return (None,) * ndim


def _tree_path(name: str) -> str:
    from llama_x_tpu_torch.adapters.lora import tree_path

    return tree_path(name)


def _tensors(model: nn.Module) -> dict[str, torch.Tensor]:
    """Every persistent tensor of the model (parameters and buffers) by module path."""
    return model.state_dict(keep_vars=True)


def param_specs(model: nn.Module, pp: bool = False) -> dict[str, tuple]:
    """{module path: spec} for every tensor of ``model`` (see the module docstring): a layer
    tensor's spec leads with its stacked layer axis (None, or "pp" with ``pp``)."""
    return {name: _stacked_spec(name, t.ndim, pp) for name, t in _tensors(model).items()}


def _stacked_spec(name: str, ndim: int, pp: bool) -> tuple:
    path = _tree_path(name)
    spec = _spec_for(path, ndim + (1 if name.startswith("layers.") else 0), pp)
    if path.endswith("/kernel") and ndim == 2:  # weight [out, in] is the kernel transposed
        spec = spec[:-2] + spec[-2:][::-1]
    return spec


def _owner(model: nn.Module, name: str):
    mod_name, _, leaf = name.rpartition(".")
    return (model.get_submodule(mod_name) if mod_name else model), leaf


def _replace(module: nn.Module, leaf: str, t: torch.Tensor) -> None:
    """Put ``t`` in place of ``module``'s tensor ``leaf`` (a parameter keeps its
    ``requires_grad``)."""
    old = getattr(module, leaf)
    if isinstance(old, nn.Parameter):
        module._parameters[leaf] = nn.Parameter(t, requires_grad=old.requires_grad)
    else:
        module._buffers[leaf] = t


def stage_range(num_layers: int, mesh: Mesh | None) -> range:
    """The layers a rank holds: all of them, or its pipeline stage's [s·L/P, (s+1)·L/P)."""
    pp = 1 if mesh is None else mesh.axis_size("pp")
    if num_layers % pp:
        raise ValueError(f"num_layers {num_layers} must divide by the pp axis ({pp})")
    s = 0 if mesh is None else mesh.index("pp")
    return range(s * num_layers // pp, (s + 1) * num_layers // pp)


class RemoteBlock(nn.Module):
    """The place of a layer another pipeline stage holds (no tensors)."""


def stage_layers(model: nn.Module) -> range:
    """The layers this rank holds: all, or its pipeline stage's."""
    return stage_range(model.config.num_layers, getattr(model, "mesh", None))


def local_spec(name: str, ndim: int, pp: bool = False) -> tuple:
    """The placement of the tensor at module path ``name`` (``ndim`` dims as the port holds
    it): its ``param_specs`` entry without the stacked layer axis."""
    spec = _stacked_spec(name, ndim, pp)
    return spec[1:] if name.startswith("layers.") else spec


def local_bounds(spec: tuple, shape, mesh: Mesh) -> tuple[slice, ...]:
    """This rank's slice of a whole tensor of ``shape`` placed as ``spec``."""
    out = []
    for n, a in zip(shape, spec):
        if a is None or mesh.axis_size(a) == 1:
            out.append(slice(0, n))
        else:
            lo, hi = shard_bounds(n, mesh.axis_size(a), mesh.index(a))
            out.append(slice(lo, hi))
    return tuple(out)


def mark_placement(model: nn.Module, mesh: Mesh, full_shapes: dict[str, tuple]) -> nn.Module:
    """Record on a model that holds its local slices already (``shard_params``, or a loader
    that read only them) where each tensor lies: ``shard_spec`` / ``full_shape`` on each
    sharded tensor, ``pp_local`` on a pipeline stage's layer tensors, ``tp_kind`` and the mesh
    on each linear, the mesh on the model."""
    from llama_x_tpu_torch.ops.linear import Linear

    pp = mesh.axis_size("pp") > 1
    for name, t in _tensors(model).items():
        spec = local_spec(name, t.ndim, pp)
        if name.startswith("layers.") and pp:
            t.pp_local = True  # held by this stage alone (its gradient is not summed over pp)
        if any(a is not None and mesh.axis_size(a) > 1 for a in spec):
            t.shard_spec, t.full_shape = tuple(spec), tuple(full_shapes[name])
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            leaf = name.rpartition(".")[2]
            mod.tp_kind = "col" if leaf in COLUMN else "row" if leaf in ROW else None
            mod.mesh = mesh
    model.mesh = mesh
    return model


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep on this rank only its slices of ``model``'s tensors (in place; returns the model).
    A second call on the same mesh changes nothing; a model placed on another mesh raises."""
    placed = getattr(model, "mesh", None)
    if placed is not None:
        if placed.shape != mesh.shape or placed.rank != mesh.rank:
            raise ValueError(f"the model is placed on mesh {placed.shape} already")
        return model
    tp = mesh.axis_size("tp")
    c = model.config
    if c.num_kv_heads % tp or c.num_heads % tp:
        raise ValueError(f"num_heads {c.num_heads} and num_kv_heads {c.num_kv_heads} must divide by the tp axis ({tp}) "
                         "for head-sharded attention")
    pp = mesh.axis_size("pp") > 1
    keep = stage_range(c.num_layers, mesh)
    for i in range(c.num_layers):
        if i not in keep:
            model.layers[i] = RemoteBlock()
    full_shapes = {}
    for name, t in _tensors(model).items():
        full_shapes[name] = tuple(t.shape)
        spec = local_spec(name, t.ndim, pp)
        if any(a is not None and mesh.axis_size(a) > 1 for a in spec):
            module, leaf = _owner(model, name)
            _replace(module, leaf, t.detach()[local_bounds(spec, t.shape, mesh)].contiguous().clone())
    return mark_placement(model, mesh, full_shapes)


def full_state_dict(model: nn.Module, device="cpu") -> dict[str, torch.Tensor]:
    """Every tensor of ``model`` whole, on ``device``: each sharded tensor gathered over its
    axes, and under pp every stage's layers (each stage sends its own). Every rank of the
    mesh must call it; all of them get the same dict."""
    mesh = getattr(model, "mesh", None)
    own = {k: gather_now(v, mesh, AXES).detach().to(device) for k, v in _tensors(model).items()}
    if mesh is None or mesh.axis_size("pp") == 1:
        return own
    import torch.distributed as dist

    parts = [None] * mesh.axis_size("pp")
    dist.all_gather_object(parts, {k: v.cpu() for k, v in own.items() if k.startswith("layers.")},
                           group=mesh.group("pp"))
    for part in parts:
        own.update({k: v.to(device) for k, v in part.items()})
    return own


def load_full_state_dict(model: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Copy whole tensors into ``model`` (sharded or not), each rank taking its slices;
    raises where the names disagree."""
    mesh = getattr(model, "mesh", None)
    own = _tensors(model)
    wanted = set(state)
    if mesh is not None and mesh.axis_size("pp") > 1:
        held = set(stage_layers(model))
        wanted = {k for k in wanted if not k.startswith("layers.") or int(k.split(".")[1]) in held}
    if wanted != set(own):
        raise ValueError(f"checkpoint and model disagree on tensors: {sorted(wanted ^ set(own))[:8]}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(local_part(state[name], mesh, t))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every [accum, mb, ...] leaf of ``batch``; raises when mb does not
    divide by the batch axes (dp x fsdp)."""
    n = mesh.axis_size("dp+fsdp")
    if n == 1:
        return batch
    i = mesh.index("dp+fsdp")
    out = {}
    for k, v in batch.items():
        mb = v.shape[1]
        if mb % n:
            raise ValueError(f"microbatch {mb} of {k!r} must divide by the batch axes dp x fsdp ({n})")
        out[k] = v[:, i * (mb // n):(i + 1) * (mb // n)]
    return out

