"""Training quality of the int8 input gradients (``dynamic_int8_bwd``; port of
tools/int8_bwd_quality.py).

Trains the same copy-permutation task twice, with the same initial weights, data order
and optimizer: once with the input gradients through the frozen int8 base in float, once
through the int8 GEMM (the gradient quantized rowwise, K4 on the card). That rounding is
the only difference between the runs, so a cost in quality shows as a gap between the two
loss curves. The model is the QLoRA composition of the 8B runs (int8 base, LoRA, dynamic
int8 activations; embeddings, head and final norm frozen) at 8 layers of width 128, so
the noise compounds through depth. The task: predict tok[i+1] = (tok[i] * 3 + 7) % 512,
a fixed permutation the trunk has to learn.

    # on the card: K1 / K4 / K2 / K5, heads of 64 in bf16 (fp32 optimizer state)
    python -m llama_x_tpu_torch.int8_bwd_quality --steps 400
    # on the CPU: the JAX tool's model exactly (heads of 32, fp32)
    python -m llama_x_tpu_torch.int8_bwd_quality --device cpu

Writes ``<out>``: both curves, their largest gap, the tail means, the device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.adapters.lora import apply_linear_adapter, set_trainable
from llama_x_tpu_torch.adapters.quantize import quantize_linear
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.train import learned_task
from llama_x_tpu_torch.train.cli import device_batches
from llama_x_tpu_torch.train.optim import get_optimizer, trapezoid_schedule
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step, trainable_parameters
from llama_x_tpu_torch.utils.device import resolve_device

FREEZE = ("tok_embeddings", "output", "norm")
VOCAB = 512
TASK = "next = (tok*3+7) % V copy-permutation, 8-layer QLoRA (int8 base + LoRA)"


def make_config(device: torch.device, **flags) -> tuple[llama.LlamaConfig, torch.dtype]:
    """The JAX tool's QLoRA model (width 128, 8 layers, MLP 384) with ``task_heads``' heads;
    ``flags``: the config fields the two runs of a study differ in."""
    heads = learned_task.task_heads(128, device)
    dtype = heads.pop("dtype")
    return llama.LlamaConfig(embed_dim=128, num_layers=8, intermediate_dim=384, max_seq_len=128, vocab_size=VOCAB,
                             dynamic_int8_act=True, **heads, **flags), dtype


def make_model(config: llama.LlamaConfig, dtype: torch.dtype, device: torch.device, seed: int = 0) -> llama.Llama:
    """Random init from ``seed``, the int8 base, LoRA from ``seed + 1``, the freeze."""
    model = llama.init(config, seed=seed, dtype=dtype, device=device)
    quantize_linear(model.layers, "int8")
    apply_linear_adapter(model.layers, "lora", torch.Generator(device=device).manual_seed(seed + 1), dtype=dtype)
    set_trainable(model, FREEZE)
    return model


def copy_task_batches(n_next: int, seed: int = 42):
    """Step batches of 8 rows: a random first token and ``n_next`` more by the permutation;
    inputs all but the last, labels all but the first (the same stream for both runs)."""
    rng = np.random.default_rng(seed)
    while True:
        toks = [rng.integers(1, VOCAB, (1, 8, 1))]
        for _ in range(n_next):
            toks.append((toks[-1] * 3 + 7) % VOCAB)
        tokens = np.concatenate(toks, axis=-1).astype(np.int32)
        yield {"tokens": tokens[..., :-1], "labels": tokens[..., 1:].astype(np.int32)}


def loss_fn(model, mb):
    loss = llama.forward(model, mb["tokens"].long(), labels=mb["labels"])
    return loss, (mb["labels"] != -100).sum()


def run(model: llama.Llama, steps: int, n_next: int) -> list[float]:
    """The loss of every step of ``steps`` AdamW steps (trapezoid 3e-3, 10% warmup and
    decay, clipping at 1.0) on the copy task."""
    optimizer = get_optimizer("AdamW", trainable_parameters(model), trapezoid_schedule(3e-3, steps, 0.1, 0.1),
                              clip_grad_norm=1.0)
    state = TrainState(model, optimizer)
    step_fn = make_train_step(loss_fn)
    data = device_batches(copy_task_batches(n_next), model.device)
    losses = [step_fn(state, next(data))["loss"] for _ in range(steps)]
    return [float(x) for x in torch.stack(losses).cpu()]


def study(args, flag: str, n_next: int, labels: tuple[str, str], task: str = TASK, **fixed) -> dict:
    """Both runs (``flag`` off, then on; ``fixed``: the config both share) and the artifact at
    ``args.out``."""
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    curves, launches = [], []
    for on in (False, True):
        counts = learned_task.launch_counts()
        config, dtype = make_config(device, **{flag: on, **fixed})
        curves.append(run(make_model(config, dtype, device), args.steps, n_next))
        launches.append(learned_task.launches_since(counts))
    fp, q = curves
    tail = slice(-50, None)
    every = max(1, args.steps // 40)
    artifact = {
        "task": task,
        "steps": args.steps,
        f"final_loss_{labels[0]}": float(np.mean(fp[tail])),
        f"final_loss_{labels[1]}": float(np.mean(q[tail])),
        "first_loss": fp[0],
        "max_curve_gap": float(np.abs(np.asarray(fp) - np.asarray(q)).max()),
        f"curve_{labels[0]}": fp[::every],
        f"curve_{labels[1]}": q[::every],
        "wall_seconds": time.perf_counter() - t0,
        f"launches_{labels[0]}": launches[0],
        f"launches_{labels[1]}": launches[1],
        "model": {"head_dim": config.head_dim, "num_heads": config.num_heads, "num_kv_heads": config.num_kv_heads,
                  "dtype": str(dtype), "optimizer_state": "float32"},
        **learned_task.device_record(device),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(artifact, indent=1))
    print(json.dumps({k: v for k, v in artifact.items() if not k.startswith("curve")}, indent=1))
    return artifact


def parse_args(argv: list[str] | None, out: str) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--out", default=out)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv, "runs/torch_int8_bwd_quality/quality.json")
    return study(args, "dynamic_int8_bwd", 63, ("fp_bwd", "int8_bwd"))


if __name__ == "__main__":
    main()
