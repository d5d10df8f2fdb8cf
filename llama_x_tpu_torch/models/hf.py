"""HuggingFace Llama checkpoints: import and export (port of llama_x_tpu/models/hf.py).

- config: hidden_size -> embed_dim, optional head_dim, rope_theta -> rope_base,
  rope_scaling.rope_type == "llama3" -> is_llama3_1 with the checkpoint's own rescale
  parameters, tie_word_embeddings.
- keys: "model." stripped, the q/k/v/o projections, gate/up/down MLP and the two norms
  mapped to the port's module names; non-parameter buffers (rotary inv_freq, causal-mask
  biases) skipped; any other key is an error that lists them all.
- loading STREAMS from a local directory: safetensors through ``safe_open(framework="pt")``
  slices, ``.bin`` through ``torch.load(weights_only=True, mmap=True)``. One tensor at a
  time is read, converted to the target dtype and moved to the device, so no tensor of
  the whole model (nor a stack of layers) is ever held on the host; ``LOAD_STATS`` counts
  what was read. HF's linear layout [out, in] is the port's ``Linear.weight`` layout: no
  transpose. ``quantize="int8"`` makes each projection rowwise int8 on the device as it
  lands (adapters/quantize.py), so an int8 8B model never holds its float base whole.
- export (``save_llama_hf``): config.json + model.safetensors, written one tensor at a
  time; int8 bases dequantized and LoRA / DoRA merged into the exported weights
  (``merged_weight``, the JAX package's ``_merged_kernel``).

- a sharded load (``mesh``, the JAX ``load_llama(mesh=)``): each rank reads only its slice of
  each tensor (``parallel/sharding.py:local_spec``; safetensors slices straight from the file,
  ``.bin`` tensors through their mmap), skips the layers of other pipeline stages, and with
  ``quantize="int8"`` takes each row's absmax over the axis that splits the row before it
  rounds (``ops/int8.py:quantize_int8_rowwise`` given the mesh), so its int8 codes and scales are the
  unsharded load's slices. The model comes back placed on the mesh, as ``shard_params``
  leaves one.

Only local directories: a hub id raises (the port never downloads).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import torch

from llama_x_tpu_torch.models.llama import Attention, Block, FeedForward, Llama, LlamaConfig, RMSNorm
from llama_x_tpu_torch.ops.linear import Linear
from llama_x_tpu_torch.utils.device import resolve_device

# what the streaming loader read: bytes, the largest single read, the number of reads
LOAD_STATS = {"chunk_bytes": 0, "max_chunk_bytes": 0, "n_chunks": 0}

_LAYER_RE = re.compile(r"^model\.layers\.(\d+)\.(.+)$")
# non-parameter buffers that many published checkpoints carry
_SKIP_BUFFERS = re.compile(r"(rotary_emb\.inv_freq|\.attn\.(bias|masked_bias))$")
# HF suffix -> (module path in a Block, tensor)
_LAYER_MAP = {
    "self_attn.q_proj.weight": ("attention.wq", "weight"),
    "self_attn.k_proj.weight": ("attention.wk", "weight"),
    "self_attn.v_proj.weight": ("attention.wv", "weight"),
    "self_attn.o_proj.weight": ("attention.wo", "weight"),
    "mlp.gate_proj.weight": ("feed_forward.w1", "weight"),
    "mlp.up_proj.weight": ("feed_forward.w3", "weight"),
    "mlp.down_proj.weight": ("feed_forward.w2", "weight"),
    "input_layernorm.weight": ("attention_norm", "scale"),
    "post_attention_layernorm.weight": ("ffn_norm", "scale"),
}
_TOP = {"model.embed_tokens.weight": "tok_embeddings", "model.norm.weight": "norm", "lm_head.weight": "output"}
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float32: "F32", torch.float16: "F16"}


def _local_dir(path) -> Path:
    p = Path(path)
    if not p.is_dir():
        raise FileNotFoundError(f"{path}: not a local directory (the port loads HF checkpoints from disk only, "
                                f"and never downloads)")
    return p


def load_hf_config(path, **overrides) -> LlamaConfig:
    hf = json.loads((_local_dir(path) / "config.json").read_text())
    if hf["architectures"][0] != "LlamaForCausalLM":
        raise ValueError(f"{path}: not a LlamaForCausalLM checkpoint ({hf['architectures']})")
    config = LlamaConfig(
        embed_dim=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"],
        intermediate_dim=hf["intermediate_size"],
        vocab_size=hf["vocab_size"],
    )
    if "rope_theta" in hf:
        config = config.replace(rope_base=float(hf["rope_theta"]))
    if "rms_norm_eps" in hf:
        config = config.replace(norm_eps=float(hf["rms_norm_eps"]))
    rs = hf.get("rope_scaling")
    if rs is not None and rs.get("rope_type", rs.get("type")) == "llama3":
        # the checkpoint's own rescale: Llama-3.1 uses factor 8, Llama-3.2 factor 32
        config = config.replace(
            is_llama3_1=True,
            rope_scale_factor=float(rs.get("factor", 8.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_old_context_len=int(rs.get("original_max_position_embeddings", 8192)),
        )
    if hf.get("tie_word_embeddings", False):
        config = config.replace(tied_embeddings=True)
    return config.replace(**overrides)


class _TensorIndex:
    """key -> lazy reader over a set of safetensors / .bin files; each read is one tensor
    in its stored dtype, from disk (safetensors slices, mmap'd torch tensors)."""

    def __init__(self, files: list[Path]):
        self._safetensors, self._torch = {}, {}
        self.shapes: dict[str, tuple[int, ...]] = {}
        for path in files:
            if path.suffix == ".safetensors":
                from safetensors import safe_open

                f = safe_open(str(path), framework="pt")
                for k in f.keys():
                    self._safetensors[k] = f
                    self.shapes[k] = tuple(f.get_slice(k).get_shape())
            else:
                sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
                for k, v in sd.items():
                    self._torch[k] = v
                    self.shapes[k] = tuple(v.shape)

    def keys(self):
        return list(self.shapes)

    def read(self, key: str, index: tuple[slice, ...] | None = None) -> torch.Tensor:
        """The tensor ``key``, or its ``index`` slice (one slice per dimension)."""
        if key in self._safetensors:
            sl = self._safetensors[key].get_slice(key)
            t = sl[:] if index is None else sl[index]
        else:
            t = self._torch[key] if index is None else self._torch[key][index].contiguous()
        n = t.numel() * t.element_size()
        LOAD_STATS["chunk_bytes"] += n
        LOAD_STATS["max_chunk_bytes"] = max(LOAD_STATS["max_chunk_bytes"], n)
        LOAD_STATS["n_chunks"] += 1
        return t


def _weight_files(path: Path) -> list[Path]:
    for ext in (".safetensors", ".bin"):
        files = sorted(path.glob(f"*{ext}"))
        if files:
            return files
    raise RuntimeError(f"no weights (*.safetensors, *.bin) in {path}")


def load_llama(path, dtype=torch.bfloat16, device=None, quantize: str | None = None, mesh=None,
               **config_overrides) -> Llama:
    """A ``Llama`` from a local HF checkpoint directory, streamed tensor by tensor onto
    ``device`` in ``dtype``; ``quantize="int8"`` makes every projection rowwise int8 as it
    lands. ``mesh``: each rank reads only its slices (see the module docstring).
    ``config_overrides`` replace fields of the checkpoint's config (``max_seq_len`` and the
    training flags)."""
    from llama_x_tpu_torch.parallel import sharding
    from llama_x_tpu_torch.ops.int8 import quantize_int8_rowwise

    src = _local_dir(path)
    config = load_hf_config(src, **config_overrides)
    dev = resolve_device(device)
    index = _TensorIndex(_weight_files(src))
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantization method {quantize!r}")

    per_layer: dict[int, dict[str, str]] = {}
    top: dict[str, str] = {}
    unmapped = []
    for key in index.keys():
        if _SKIP_BUFFERS.search(key):
            continue
        m = _LAYER_RE.match(key)
        if m and m.group(2) in _LAYER_MAP:
            per_layer.setdefault(int(m.group(1)), {})[m.group(2)] = key
        elif key in _TOP:
            top[_TOP[key]] = key
        else:
            unmapped.append(key)
    if unmapped:
        raise ValueError(f"{path}: {len(unmapped)} checkpoint key(s) do not map onto the Llama modules: "
                         f"{sorted(unmapped)[:20]}" + (" ..." if len(unmapped) > 20 else ""))
    if sorted(per_layer) != list(range(config.num_layers)) or any(len(v) != len(_LAYER_MAP) for v in per_layer.values()):
        raise ValueError(f"{path}: the checkpoint's layers do not match num_layers={config.num_layers}")

    pp = mesh is not None and mesh.axis_size("pp") > 1
    full_shapes: dict[str, tuple] = {}

    def tensor(key: str, name: str) -> torch.Tensor:
        """The checkpoint's ``key`` as the port's tensor ``name``: whole, or this rank's slice."""
        shape = index.shapes[key]
        full_shapes[name] = shape
        if mesh is None:
            return index.read(key).to(device=dev, dtype=dtype)
        spec = sharding.local_spec(name, len(shape), pp)
        return index.read(key, sharding.local_bounds(spec, shape, mesh)).to(device=dev, dtype=dtype)

    def linear(key: str, name: str) -> Linear:
        w = tensor(key, name + ".weight")
        if quantize is None:
            return Linear(weight=w)
        full_shapes[name + ".int_data"] = full_shapes[name + ".weight"]
        full_shapes[name + ".scale"] = full_shapes[name + ".weight"][:1]
        # rowwise int8; under a mesh the row's absmax over the axis that splits its columns
        split = None if mesh is None else sharding.local_spec(name + ".int_data", 2, pp)[1]
        int_data, scale = quantize_int8_rowwise(w, mesh if split else None, split or "tp")
        return Linear(int_data=int_data, scale=scale.to(dtype))

    held = sharding.stage_range(config.num_layers, mesh)
    layers = []
    for i in range(config.num_layers):
        if i not in held:
            layers.append(sharding.RemoteBlock())
            continue
        k = per_layer[i]
        lin = {name.split(".")[1]: linear(k[suffix], f"layers.{i}.{name}")
               for suffix, (name, leaf) in _LAYER_MAP.items() if leaf == "weight"}
        layers.append(Block(
            RMSNorm(tensor(k["input_layernorm.weight"], f"layers.{i}.attention_norm.scale"), config.norm_eps),
            Attention(lin["wq"], lin["wk"], lin["wv"], lin["wo"]),
            RMSNorm(tensor(k["post_attention_layernorm.weight"], f"layers.{i}.ffn_norm.scale"), config.norm_eps),
            FeedForward(lin["w1"], lin["w2"], lin["w3"]),
        ))
    emb = tensor(top["tok_embeddings"], "tok_embeddings")
    output = None
    if not config.tied_embeddings:
        # a checkpoint without lm_head that does not declare tying: the head is a copy of the embedding
        output = Linear(weight=tensor(top["output"], "output.weight") if "output" in top else emb.clone())
        full_shapes.setdefault("output.weight", full_shapes["tok_embeddings"])
    model = Llama(config, emb, layers, RMSNorm(tensor(top["norm"], "norm.scale"), config.norm_eps), output)
    return model if mesh is None else sharding.mark_placement(model, mesh, full_shapes)


# ---------------------------------------------------------------------------
# export: the inverse of load_llama
# ---------------------------------------------------------------------------


def merged_weight(lin: Linear) -> torch.Tensor:
    """A linear's effective float weight [out, in] in f32: int8 dequantized, the LoRA delta
    (B A s, transposed to [out, in]) added, the DoRA rescale m / ||W + B A s|| (the norm
    over the input features of each output) applied (the JAX package's
    ``_merged_kernel`` in the port's layout)."""
    with torch.no_grad():
        if lin.int_data is not None:
            w = lin.int_data.float() * lin.scale.float()[:, None]
        else:
            w = lin.weight.float()
        if lin.lora_a is not None:
            w = w + (lin.lora_a.float() @ lin.lora_b.float() * lin.lora_scale.float()).T
        if lin.m is not None:
            w = w * (lin.m.float() / torch.linalg.vector_norm(w, dim=1))[:, None]
    return w


def _write_safetensors(path: Path, tensors: dict[str, tuple[tuple[int, ...], object]], dtype: torch.dtype):
    """Stream a safetensors file: tensors[name] = (shape, produce); produce() is called
    once per tensor at write time, so the host holds one tensor at a time."""
    item = torch.tensor([], dtype=dtype).element_size()
    header, offset = {}, 0
    for name, (shape, _) in tensors.items():
        n = item
        for s in shape:
            n *= s
        header[name] = {"dtype": _ST_DTYPES[dtype], "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode("utf-8")
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for name, (shape, produce) in tensors.items():
            t = produce().detach().to(device="cpu", dtype=dtype).contiguous()
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: {tuple(t.shape)} is not {shape}")
            f.write(t.view(torch.uint8).numpy().tobytes())


def save_llama_hf(model: Llama, out_dir, dtype=torch.bfloat16) -> Path:
    """Write an HF Llama checkpoint (config.json + model.safetensors) that ``load_llama``
    and ``transformers`` read: int8 bases dequantized, LoRA / DoRA merged. Modality stems
    have no HF form and are not written."""
    config = model.config
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    hf_config = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": config.embed_dim,
        "num_hidden_layers": config.num_layers,
        "head_dim": config.head_dim,
        "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "intermediate_size": config.intermediate_dim,
        "vocab_size": config.vocab_size,
        "max_position_embeddings": config.max_seq_len,
        "rms_norm_eps": config.norm_eps,
        "rope_theta": config.rope_base,
        "tie_word_embeddings": bool(config.tied_embeddings),
        "torch_dtype": {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}[dtype],
    }
    if config.is_llama3_1:
        hf_config["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": config.rope_scale_factor,
            "low_freq_factor": config.rope_low_freq_factor,
            "high_freq_factor": config.rope_high_freq_factor,
            "original_max_position_embeddings": config.rope_old_context_len,
        }
    (out_dir / "config.json").write_text(json.dumps(hf_config, indent=1))

    tensors: dict[str, tuple[tuple[int, ...], object]] = {}
    tensors["model.embed_tokens.weight"] = (tuple(model.tok_embeddings.shape), lambda: model.tok_embeddings)
    tensors["model.norm.weight"] = (tuple(model.norm.scale.shape), lambda: model.norm.scale)
    if not config.tied_embeddings:
        tensors["lm_head.weight"] = ((config.vocab_size, config.embed_dim), lambda: merged_weight(model.output))
    for i, blk in enumerate(model.layers):
        for suffix, (name, leaf) in _LAYER_MAP.items():
            mod = blk.get_submodule(name)
            if leaf == "scale":
                tensors[f"model.layers.{i}.{suffix}"] = (tuple(mod.scale.shape), lambda mod=mod: mod.scale)
            else:
                base = mod.int_data if mod.int_data is not None else mod.weight
                tensors[f"model.layers.{i}.{suffix}"] = (tuple(base.shape), lambda mod=mod: merged_weight(mod))
    _write_safetensors(out_dir / "model.safetensors", tensors, dtype)
    return out_dir
