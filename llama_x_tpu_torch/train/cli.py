"""Shared trainer plumbing for the command-line entry point (port of
llama_x_tpu/train/cli.py, the part the text trainer reads): the common flags, model
construction with the quantize -> adapt -> freeze composition, optimizer set-up and
step-batch assembly.

Flags of the JAX trainer that belong to later slices of the port are accepted by the
parser and refused with the slice's name, never ignored: ``--mesh``,
``--pp_microbatches`` and ``--attn_impl ring|ulysses`` (sharding and context
parallelism), ``--model`` / ``--tokenizer`` / ``--resume`` from a HF checkpoint (HF
import), remat policies other than ``full`` (slice 2b).
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.adapters.lora import apply_linear_adapter, set_trainable
from llama_x_tpu_torch.adapters.quantize import quantize_linear
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.train.optim import get_optimizer, trapezoid_schedule
from llama_x_tpu_torch.train.trainer import trainable_parameters
from llama_x_tpu_torch.utils.device import resolve_device

REMAT_POLICIES = [
    "full", "dots", "dots_flash", "flash", "flash_qkv", "flash_proj", "flash_q8", "flash_q8s", "flash_qkv_q8",
    "flash_qkv_q8s", "flash_proj_q8", "flash_proj_q8s", "attn_q8", "attn_q8s",
]


def add_common_args(parser: argparse.ArgumentParser):
    parser.add_argument("--model", help="HF checkpoint (not ported yet: slice 3)")
    parser.add_argument("--tokenizer", default="byte")
    parser.add_argument("--adapter", choices=["lora", "dora"])
    parser.add_argument("--adapter_kwargs", type=json.loads, default=dict())
    parser.add_argument("--quantize", choices=["int8"])
    parser.add_argument("--quantize_kwargs", type=json.loads, default=dict(),
                        help='{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}')
    parser.add_argument("--freeze_prefixes", nargs="+", default=[])
    parser.add_argument("--activation_checkpointing", action="store_true")

    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--gradient_accumulation", type=int, default=1)

    parser.add_argument("--optim", default="AdamW", choices=["AdamW", "AdamW8bit", "AdamW4bit"])
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--warmup", type=float, default=0.0)
    parser.add_argument("--decay", type=float, default=0.0)
    parser.add_argument("--clip_grad_norm", type=float)

    parser.add_argument("--ckpt_interval", type=int, default=1000)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--run_name")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--skip_nonfinite", action="store_true", help="suppress updates on NaN/Inf grads")
    parser.add_argument("--resume", help="a run directory or step directory of this trainer's checkpoints")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])

    parser.add_argument("--mesh", type=json.loads, default=dict(), help="not ported yet: slice 5")
    parser.add_argument("--pp_microbatches", type=int, default=0, help="not ported yet: slice 5")
    parser.add_argument("--attn_impl", default="auto", choices=["auto", "flash", "ring", "ulysses"])
    parser.add_argument("--remat_policy", default="full", choices=REMAT_POLICIES)
    parser.add_argument("--fused_ce_chunks", type=int, default=0)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic samples with the byte tokenizer and a random model")
    parser.add_argument("--synthetic_task", default="random", choices=["random", "count"],
                        help="random: unlearnable smoke tokens; count: learnable counting sequences")
    parser.add_argument("--synthetic_config", type=json.loads, default=dict(),
                        help='geometry overrides for --synthetic, e.g. \'{"num_layers":8,"embed_dim":512}\'')
    parser.add_argument("--geometry", choices=["tiny", "1b", "8b"],
                        help="random weights at a published width, made on the device (as generate_cli has it); "
                             "default: the small --synthetic model")


def check_supported(args) -> None:
    """Refuse, by name, what later slices of the port bring."""
    later = []
    if args.mesh or args.pp_microbatches:
        later.append("--mesh / --pp_microbatches (sharded training: slice 5)")
    if args.attn_impl in ("ring", "ulysses"):
        later.append(f"--attn_impl {args.attn_impl} (context parallelism: slice 5)")
    if args.model:
        later.append("--model (HF import: slice 3)")
    if args.tokenizer != "byte":
        later.append(f"--tokenizer {args.tokenizer} (needs its model file: slice 2b)")
    if args.remat_policy != "full":
        later.append(f"--remat_policy {args.remat_policy} (named-save and int8-residual policies: slice 2b)")
    if not args.synthetic:
        later.append("real MetaMathQA data (tokenization needs files the repository does not hold: slice 2b); "
                     "pass --synthetic N")
    if later:
        raise NotImplementedError("not ported yet: " + "; ".join(later))


def make_save_dir(task: str, run_name: str | None) -> Path:
    name = f"{run_name or 'run'}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    d = Path("runs") / task / name
    d.mkdir(parents=True, exist_ok=True)
    return d


def save_model_config(save_dir: Path, config) -> None:
    """The model hyperparameters beside the checkpoints, so that a later reader can
    rebuild the architecture."""
    import dataclasses

    (Path(save_dir) / "model_config.json").write_text(json.dumps({"llama": dataclasses.asdict(config)}, indent=2))


def build_model_params(args, max_seq_len: int = 2048):
    """Random init -> quantize -> adapt -> freeze, in the JAX trainer's order, and
    ``frozen_head`` read off the head's actual ``requires_grad``. Returns the model;
    prints the trainable / frozen counts."""
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model

    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    overrides = dict(activation_checkpointing=args.activation_checkpointing, fused_ce_chunks=args.fused_ce_chunks,
                     remat_policy=args.remat_policy, max_seq_len=max_seq_len)
    quantize = args.quantize == "int8"
    if args.geometry:
        # weights drawn directly as int8 at a published width (an 8B base never exists in float)
        config = llama.LlamaConfig(**GEOMETRIES[args.geometry]).replace(**overrides)
        model = build_model(config, quantize, args.seed, device)
    else:
        geo = dict(embed_dim=256, num_layers=4, head_dim=32, num_heads=8, num_kv_heads=4, intermediate_dim=512,
                   vocab_size=512)
        geo.update(args.synthetic_config or {})
        config = llama.tiny_config(**geo).replace(**overrides)
        model = llama.init(config, seed=args.seed, dtype=dtype, device=device)
        if quantize:
            quantize_linear(model.layers, "int8")
    if quantize:
        kw = args.quantize_kwargs
        model.config = model.config.replace(
            dynamic_int8_act=bool(kw.get("dynamic_int8_act", False)),
            dynamic_int8_bwd=bool(kw.get("dynamic_int8_bwd", False)),
            int8_head=bool(kw.get("int8_head", False)),
        )
    if args.adapter:
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        apply_linear_adapter(model.layers, args.adapter, gen, dtype=dtype, **args.adapter_kwargs)
    n_train, n_frozen = set_trainable(model, tuple(args.freeze_prefixes))
    # frozen_head from the ACTUAL requires_grad, so that the fused-CE backward skips the
    # head's gradient exactly when the optimizer would never see it
    head_weight = model.tok_embeddings if model.config.tied_embeddings else model.output.weight
    model.config = model.config.replace(frozen_head=not head_weight.requires_grad)
    print(f"No. of trainable params: {n_train:,}")
    print(f"No. of non-trainable params: {n_frozen:,}")
    return model


def setup_optimizer(args, model):
    schedule = trapezoid_schedule(args.lr, args.n_steps, args.warmup, args.decay)
    optimizer = get_optimizer(args.optim, trainable_parameters(model), schedule, args.weight_decay,
                              args.clip_grad_norm)
    return optimizer, schedule


def assemble_step_batch(micro_batches: list[dict], pad_values: dict | None = None) -> dict:
    """Stack accumulation microbatches into [accum, mb, ...] numpy arrays, padding
    ragged sequence lengths up to the step's longest (the bucketed padding mode yields
    a few distinct lengths)."""
    pad_values = pad_values or {}
    out = {}
    for k in micro_batches[0].keys():
        arrs = [mb[k] for mb in micro_batches]
        max_len = max(a.shape[-1] for a in arrs)
        pv = pad_values.get(k, 0)
        arrs = [
            np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, max_len - a.shape[-1])], constant_values=pv)
            if a.shape[-1] != max_len else a
            for a in arrs
        ]
        out[k] = np.stack(arrs)
    return out
