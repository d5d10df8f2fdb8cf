"""What the learned-task entry points share (``wer_synthetic``, ``vision_synthetic``,
``omni_synthetic``, ``int8_bwd_quality``, ``int8_head_quality``; ports of the JAX
``tools/*.py`` of those names, which each spell it out).

Each tool trains a small model on a generated task with the production train step
(train/trainer.py), saves a checkpoint (train/checkpoint.py) and scores held-out samples
on the model restored from it, greedily through ``models/generate.py``. On the CPU the
model is the JAX tool's, in fp32 (heads of 32). The card's attention kernels take bf16 and
heads of 64 or 128, so there the same width and depth run with heads of 64 in bf16, the
optimizer state in fp32 (``task_heads``), and every result names the card.
"""

from __future__ import annotations

import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.models.generate import generate
from llama_x_tpu_torch.train.checkpoint import restore_model, save_checkpoint
from llama_x_tpu_torch.train.cli import device_batches, save_model_config
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step


def task_heads(embed_dim: int, device: torch.device) -> dict:
    """Head geometry and dtype: the JAX tools' heads of 32 (embed_dim / 32 query heads, half
    as many kv heads) in fp32 on the CPU; heads of 64 (embed_dim / 64 and half as many) in bf16
    on the card."""
    hd = 64 if device.type == "cuda" else 32
    return dict(head_dim=hd, num_heads=embed_dim // hd, num_kv_heads=embed_dim // (2 * hd),
                dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)


def device_record(device: torch.device) -> dict:
    """The device a result was taken on: the card's name and power limit as nvidia-smi
    prints them, or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu"}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": out.stdout.strip().partition("\n")[0]}


def launch_counts() -> dict:
    """The launch counters of the kernels a learned task runs (each wrapper counts the
    launches of its kernel, never its plain version): subtract two reads for a run's."""
    from llama_x_tpu_torch.ops import decode_attention as da
    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops import int8_mm as mm

    return {"K1 int8_mm_dequant_nt": mm.int8_mm_dequant_nt.launches, "K4 int8_mm_dequant": mm.int8_mm_dequant.launches,
            "K2 flash_attention": fa.flash_fwd_with_lse.launches, "K5 flash_attention_bwd": fa.flash_bwd_from_res.launches,
            "K3 decode_attention": da.decode_attention.launches}


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts().items()}


def encode_text(tok, text: str, text_len: int) -> tuple[np.ndarray, np.ndarray]:
    """bos + text + eos padded to ``text_len``, and its next-token labels (-100 on pads)."""
    ids = tok(text, add_bos=True, add_eos=True)
    tokens = np.full(text_len, tok.pad_id, np.int32)
    tokens[: len(ids)] = ids
    labels = np.full(text_len, -100, np.int32)
    labels[: len(ids) - 1] = ids[1:]
    return tokens, labels


def train(model, optimizer, loss_fn, batches, steps: int, log_every: int = 50) -> tuple[TrainState, list, float]:
    """``steps`` train steps over ``batches`` (step batches with a leading accumulation
    axis, prefetched onto the model's device). Returns (state, the losses read every
    ``log_every`` steps and at the last, train seconds)."""
    state = TrainState(model, optimizer)
    step_fn = make_train_step(loss_fn)
    data = device_batches(batches, model.device)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        metrics = step_fn(state, next(data))
        if step % log_every == 0 or step == steps - 1:
            losses.append(float(metrics["loss"]))
            print(f"step {step}: loss {losses[-1]:.4f}")
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return state, losses, time.perf_counter() - t0


def checkpoint_round_trip(out_dir: str | Path, state: TrainState, steps: int):
    """Save the trained state under ``out_dir``/step_<steps> beside the model config, and
    restore the model from there (what the evaluations' ``--resume`` does). A step directory
    left by an earlier run is removed first, since ``save_checkpoint`` keeps an existing one."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model = state.model
    save_model_config(out_dir, model.config, getattr(model, "audio_config", None),
                      getattr(model, "vision_config", None))
    shutil.rmtree(out_dir / f"step_{steps:08d}", ignore_errors=True)
    path = save_checkpoint(out_dir, state, steps)
    return restore_model(path, device=model.device)


def greedy_text(model, prefix: torch.Tensor, tok, max_new_tokens: int) -> str:
    """One greedy transcript / caption: bos after the modality ``prefix`` [1, T, D]
    (prefix-LM), pad and eos dropped."""
    bos = torch.full((1, 1), tok.bos_id, dtype=torch.long, device=model.device)
    out = generate(model, bos, max_new_tokens=max_new_tokens, eos_id=tok.eos_id, pad_id=tok.pad_id,
                   prefix_embeds=prefix, prefix_lm=True)
    return tok.decode([int(t) for t in out[0].tolist() if t not in (tok.pad_id, tok.eos_id)]).strip()
