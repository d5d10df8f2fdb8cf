"""Checkpoint save / resume of a training run (port of
llama_x_tpu/train/checkpoint.py, in the port's own file format).

Layout as in the JAX package: ``<dir>/step_<N>/`` per save plus a ``last`` pointer
file; ``restore_checkpoint`` loads a step directory into an existing ``TrainState``
(same model structure and optimizer), exactly: parameters, int8 buffers, optimizer
moments (fp32 or quantized), optimizer count and step all come back bit for bit. The
file is ``state.pt`` (``torch.save`` of plain tensors and ints). Reading the JAX
package's ``.npz`` / Orbax checkpoints comes with the HF import / export slice.

A sharded run (fsdp / tp / pp, parallel/sharding.py) saves what an unsharded run saves,
as the JAX package's Orbax checkpoints do: every rank takes part in gathering the whole
tensors (``full_state_dict``, the optimizer's ``state_dict``; under pp each stage's layers and
moments) and rank 0 alone writes them; every rank restores by reading the file and taking
its slices. So a run saved at tp 2 or fsdp 2 restores into a run without a mesh, and the
other way round. The optimizer's moments are kept by parameter name.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from llama_x_tpu_torch.parallel.sharding import full_state_dict, load_full_state_dict
from llama_x_tpu_torch.train.trainer import TrainState


def _point_last(ckpt_dir: Path, name: str) -> None:
    tmp = ckpt_dir / ".last.tmp"
    tmp.write_text(name)
    os.replace(tmp, ckpt_dir / "last")


def _optimizer_record(state: TrainState) -> dict:
    """The optimizer's state whole, its moments keyed by parameter name (every stage's)."""
    sd = state.optimizer.state_dict()
    names = [n for n, _ in state.trainable]
    rec = {"count": sd["count"], "mu": dict(zip(names, sd["mu"])), "nu": dict(zip(names, sd["nu"]))}
    mesh = getattr(state.model, "mesh", None)
    if mesh is not None and mesh.axis_size("pp") > 1:
        import torch.distributed as dist

        def cpu(x):
            return tuple(cpu(t) for t in x) if isinstance(x, tuple) else x.detach().cpu()

        parts = [None] * mesh.axis_size("pp")
        dist.all_gather_object(parts, {k: {n: cpu(v) for n, v in rec[k].items()} for k in ("mu", "nu")},
                               group=mesh.group("pp"))
        for part in parts:
            for k in ("mu", "nu"):
                rec[k].update(part[k])
    return rec


def save_checkpoint(ckpt_dir: str | Path | None, state: TrainState, step: int) -> Path | None:
    """Save ``state`` under ``ckpt_dir``/step_<step> and point ``last`` at it. Over a mesh every
    rank calls it (the tensors are gathered whole) and only the one given a ``ckpt_dir``
    (rank 0) writes."""
    record = {
        "step": state.step,
        "model": {k: v.detach().cpu() for k, v in full_state_dict(state.model).items()},
        "optimizer": _optimizer_record(state),
    }
    if ckpt_dir is None:
        return None
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step:08d}"
    if not path.exists():
        # the end-of-training save lands on the last interval save's step when
        # n_steps % ckpt_interval == 0: the bytes would be the same, so keep them
        path.mkdir()
        tmp = path / ".state.pt.tmp"
        torch.save(record, tmp)
        os.replace(tmp, path / "state.pt")
    _point_last(ckpt_dir, path.name)
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "last"
    if pointer.exists():
        p = ckpt_dir / pointer.read_text().strip()
        if p.exists():
            return p
    steps = sorted(ckpt_dir.glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(path: str | Path, state: TrainState) -> TrainState:
    """Load ``path`` (a step directory) into ``state``, in place; returns it. A sharded model
    takes its slices of the saved whole tensors (every rank of its mesh calls it)."""
    record = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    load_full_state_dict(state.model, record["model"])
    opt = record["optimizer"]
    names = [n for n, _ in state.trainable]
    state.optimizer.load_state_dict({"count": opt["count"], "mu": [opt["mu"][n] for n in names],
                                     "nu": [opt["nu"][n] for n in names]})
    state.step = int(record["step"])
    return state


def restore_model(path: str | Path, device=None):
    """The model of a training run, for evaluation: ``path`` is a run directory (its
    latest step) or a step directory inside one. The architecture comes from the run's
    model_config.json (decoder, and the audio and / or vision stem), the structure of
    each projection (int8 base, LoRA or DoRA and its rank) from the saved tensors, and
    every tensor from the step's ``state.pt``. Returns the model on ``device``."""
    from llama_x_tpu_torch.adapters.lora import apply_linear_adapter
    from llama_x_tpu_torch.adapters.quantize import quantize_linear
    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.models.audio import LlamaAudio, init_audio_stem
    from llama_x_tpu_torch.models.omni import LlamaOmni
    from llama_x_tpu_torch.models.vision import LlamaVision, init_patch_embed
    from llama_x_tpu_torch.train.cli import load_model_configs
    from llama_x_tpu_torch.utils.device import resolve_device

    path = Path(path)
    step_dir = latest_checkpoint(path) or path
    saved = load_model_configs(path) or load_model_configs(step_dir.parent)
    if saved is None:
        raise FileNotFoundError(f"no model_config.json in {path} or beside {step_dir}")
    config, audio_config, vision_config = saved
    tensors = torch.load(step_dir / "state.pt", map_location="cpu", weights_only=True)["model"]
    dev = resolve_device(device)
    dtype = tensors["tok_embeddings"].dtype
    model = llama.init(config, dtype=dtype, device=dev)  # the shapes; every value is overwritten below
    if any(k.endswith(".int_data") for k in tensors):
        quantize_linear(model.layers, "int8")
    lora_a = next((v for k, v in tensors.items() if k.endswith(".lora_a")), None)
    if lora_a is not None:
        kind = "dora" if any(k.endswith(".m") for k in tensors) else "lora"
        apply_linear_adapter(model.layers, kind, torch.Generator(device=dev), rank=lora_a.shape[1],
                             dtype=lora_a.dtype)
    gen = torch.Generator(device=dev)
    audio_stem = None if audio_config is None else init_audio_stem(config, audio_config, gen, dtype)
    patch_stem = None if vision_config is None else init_patch_embed(config, vision_config, gen, dtype)
    if audio_stem is not None and patch_stem is not None:
        model = LlamaOmni.from_llama(model, audio_stem, patch_stem, audio_config, vision_config)
    elif audio_stem is not None:
        model = LlamaAudio.from_llama(model, audio_stem, audio_config)
    elif patch_stem is not None:
        model = LlamaVision.from_llama(model, patch_stem, vision_config)
    model.load_state_dict(tensors)
    print(f"restored the step-{step_dir.name.rpartition('_')[2]} model from {step_dir}")
    return model
