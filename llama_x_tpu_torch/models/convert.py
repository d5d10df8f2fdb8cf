"""Carry a JAX param tree across to the port's model.

``params_from_jax(tree, config, device)`` takes the JAX package's param tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``): layers stacked
on a leading [L] axis, plain kernels [in, out], int8 bases ``int_data [out, in]`` +
``scale [out]``, and LoRA / DoRA leaves. It returns a ``Llama`` computing the same
function, so both sides can be held against each other on the same weights
(``jax.random`` and ``torch`` give different numbers from one seed). With
``freeze_prefixes`` (a tuple, possibly empty) the parameters also get the
``requires_grad`` that the JAX package's ``trainable_mask`` would give them.

A tree with an ``audio_embed`` stem (conv kernels [W, C_in, C_out], permuted to
PyTorch's [C_out, C_in, W]) gives a ``LlamaAudio``, one with a ``patch_embed`` stem
(``proj.kernel`` [fan_in, D], transposed into the ``nn.Linear``, ``proj.bias``,
``newline``) a ``LlamaVision``, and one with both a ``LlamaOmni``;
``freeze_prefixes=("audio_embed", ...)`` freezes a stem as the JAX mask does.

``named_tensors(model)`` is the way back: the model's tensors (or their gradients)
as numpy arrays under the JAX tree's path names, layers stacked again.
"""

from __future__ import annotations

import numpy as np
import torch

from llama_x_tpu_torch.adapters.lora import set_trainable, tree_path
from llama_x_tpu_torch.models.llama import Attention, Block, FeedForward, Llama, LlamaConfig, RMSNorm
from llama_x_tpu_torch.ops.linear import Linear
from llama_x_tpu_torch.utils.device import resolve_device

# JAX leaf name -> Linear tensor name (the plain kernel is transposed to [out, in])
_LEAVES = {"kernel": "weight", "int_data": "int_data", "scale": "scale", "bias": "bias",
           "lora_a": "lora_a", "lora_b": "lora_b", "lora_scale": "lora_scale", "m": "m"}


def to_tensor(a, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, read bit for bit) -> torch on device."""
    a = np.array(a)  # a writable, contiguous copy: torch takes numpy memory as is
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _linear(p: dict, layer: int | None, device) -> Linear:
    unknown = set(p) - set(_LEAVES)
    if unknown:
        raise ValueError(f"unknown linear leaves {sorted(unknown)}")
    tensors = {}
    for leaf, value in p.items():
        t = to_tensor(value if layer is None else np.asarray(value)[layer], device)
        tensors[_LEAVES[leaf]] = t.T.contiguous() if leaf == "kernel" else t
    return Linear(**tensors)


def _stem(p: dict, device):
    from llama_x_tpu_torch.models.audio import stem_from_tensors

    def conv(c):
        return to_tensor(c["kernel"], device).permute(2, 1, 0).contiguous(), to_tensor(c["bias"], device)

    return stem_from_tensors(*conv(p["conv1"]), *conv(p["conv2"]))


def _patch_embed(p: dict, device):
    from llama_x_tpu_torch.models.vision import PatchEmbed

    newline = to_tensor(p["newline"], device) if "newline" in p else None
    return PatchEmbed(to_tensor(p["proj"]["kernel"], device).T.contiguous(), to_tensor(p["proj"]["bias"], device),
                      newline)


def params_from_jax(tree: dict, config: LlamaConfig, device=None,
                    freeze_prefixes: tuple[str, ...] | None = None, audio_config=None, vision_config=None) -> Llama:
    dev = resolve_device(device)
    lp = tree["layers"]

    def norm(scale) -> RMSNorm:
        return RMSNorm(to_tensor(scale, dev), config.norm_eps)

    layers = []
    for i in range(config.num_layers):
        a, f = lp["attention"], lp["feed_forward"]
        layers.append(Block(
            norm(np.asarray(lp["attention_norm"]["scale"])[i]),
            Attention(*(_linear(a[n], i, dev) for n in ("wq", "wk", "wv", "wo"))),
            norm(np.asarray(lp["ffn_norm"]["scale"])[i]),
            FeedForward(*(_linear(f[n], i, dev) for n in ("w1", "w2", "w3"))),
        ))
    output = None if config.tied_embeddings else _linear(tree["output"], None, dev)
    parts = (config, to_tensor(tree["tok_embeddings"]["weight"], dev), layers, norm(tree["norm"]["scale"]), output)
    if "audio_embed" in tree and "patch_embed" in tree:
        from llama_x_tpu_torch.models.audio import AudioConfig
        from llama_x_tpu_torch.models.omni import LlamaOmni
        from llama_x_tpu_torch.models.vision import VisionConfig

        model = LlamaOmni(*parts, _stem(tree["audio_embed"], dev), _patch_embed(tree["patch_embed"], dev),
                          audio_config or AudioConfig(), vision_config or VisionConfig())
    elif "audio_embed" in tree:
        from llama_x_tpu_torch.models.audio import AudioConfig, LlamaAudio

        model = LlamaAudio(*parts, _stem(tree["audio_embed"], dev), audio_config or AudioConfig())
    elif "patch_embed" in tree:
        from llama_x_tpu_torch.models.vision import LlamaVision, VisionConfig

        model = LlamaVision(*parts, _patch_embed(tree["patch_embed"], dev), vision_config or VisionConfig())
    else:
        model = Llama(*parts)
    if freeze_prefixes is not None:
        set_trainable(model, tuple(freeze_prefixes))
    return model


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy, bfloat16 widened to float32 (numpy has no bfloat16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def named_tensors(model: Llama, grads: bool = False) -> dict[str, np.ndarray]:
    """{JAX tree path: numpy array} of the model's parameters and int8 buffers, the
    layers stacked on a leading axis and a linear's float base transposed back to
    ``kernel [in, out]``. ``grads=True`` gives the parameters' ``.grad`` instead
    (only where every layer has one)."""
    groups: dict[str, list] = {}
    tensors = list(model.named_parameters()) + [(n, b) for n, b in model.named_buffers() if n.endswith("int_data")]
    for name, t in tensors:
        value = t.grad if grads else t
        path = tree_path(name)
        if value is not None and path.endswith("/kernel"):
            value = value.permute(2, 1, 0) if value.ndim == 3 else value.T  # conv [W, C_in, C_out]; linear [in, out]
        groups.setdefault(path, []).append(value)
    out = {}
    for path, values in groups.items():
        if any(v is None for v in values):
            continue
        arrays = [to_numpy(v) for v in values]
        out[path] = np.stack(arrays) if path.startswith("layers/") else arrays[0]
    return out
