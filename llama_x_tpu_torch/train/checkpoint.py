"""Checkpoint save / resume of a training run (port of
llama_x_tpu/train/checkpoint.py, in the port's own file format).

Layout as in the JAX package: ``<dir>/step_<N>/`` per save plus a ``last`` pointer
file; ``restore_checkpoint`` loads a step directory into an existing ``TrainState``
(same model structure and optimizer), exactly: parameters, int8 buffers, optimizer
moments (fp32 or quantized), optimizer count and step all come back bit for bit. The
file is ``state.pt`` (``torch.save`` of plain tensors and ints). Reading the JAX
package's ``.npz`` / Orbax checkpoints comes with the HF import / export slice.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from llama_x_tpu_torch.train.trainer import TrainState


def _point_last(ckpt_dir: Path, name: str) -> None:
    tmp = ckpt_dir / ".last.tmp"
    tmp.write_text(name)
    os.replace(tmp, ckpt_dir / "last")


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, step: int) -> Path:
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step:08d}"
    if not path.exists():
        # the end-of-training save lands on the last interval save's step when
        # n_steps % ckpt_interval == 0: the bytes would be the same, so keep them
        path.mkdir()
        record = {
            "step": state.step,
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
        }
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
    """Load ``path`` (a step directory) into ``state``, in place; returns it."""
    record = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    with torch.no_grad():
        own = state.model.state_dict()
        missing = set(own) ^ set(record["model"])
        if missing:
            raise ValueError(f"checkpoint and model disagree on tensors: {sorted(missing)[:8]}")
        for name, t in own.items():
            t.copy_(record["model"][name])
    state.optimizer.load_state_dict(record["optimizer"])
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
