"""Synthetic end-to-end image captioning through the whole training and evaluation loop
(port of tools/vision_synthetic.py).

A small Fuyu-style LlamaVision learns a task that needs the pixels: each canvas shows two
colored shapes and the caption names them ("red square blue circle"). Train and evaluation
draw from disjoint combinations (evaluation: the (color, shape) index quadruples summing
to 0 mod 4, data/vision.py:shapes_split), so a high exact match means the model reads each
shape and color from the image. The loop:

  train (train/trainer.py, prefix-LM image fusion, models/vision.py) -> save_checkpoint
  -> restore_model -> generate() greedy with the image prefix -> exact match and WER

    # on the card, the JAX artifact's recipe (heads of 64 in bf16: K2 / K5 train it, K2 / K3 decode it)
    python -m llama_x_tpu_torch.vision_synthetic --steps 4000 --lr 1e-3
    # on the CPU: the JAX tool's model exactly (heads of 32, fp32)
    python -m llama_x_tpu_torch.vision_synthetic --device cpu --steps 800

Writes ``<out_dir>/accuracy.json`` with the recipe, the head geometry, the dtype, the train
seconds and the device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.adapters.lora import set_trainable
from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
from llama_x_tpu_torch.data.vision import make_shapes_sample
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models import vision as vision_mod
from llama_x_tpu_torch.models.vision import LlamaVision, VisionConfig
from llama_x_tpu_torch.train import learned_task
from llama_x_tpu_torch.train.optim import get_optimizer, trapezoid_schedule
from llama_x_tpu_torch.train.trainer import trainable_parameters
from llama_x_tpu_torch.train.wer import wer
from llama_x_tpu_torch.utils.device import resolve_device

TEXT_LEN = 40  # bos + "magenta triangle magenta triangle" (33 bytes, the longest) + eos
IMAGE_SIZE = 48
PATCH_SIZE = 6  # 8x8 patches + 8 newline tokens = 72 image tokens


def batches(rng: np.random.Generator, tok: ByteTokenizer, batch_size: int, image_size: int):
    """Step batches of training canvases, with a leading accumulation axis of 1."""
    while True:
        images, tokens, labels = [], [], []
        for _ in range(batch_size):
            img, caption = make_shapes_sample(rng, image_size, split="train")
            t, lab = learned_task.encode_text(tok, caption, TEXT_LEN)
            images.append(img)
            tokens.append(t)
            labels.append(lab)
        yield {"images": np.stack(images)[None], "tokens": np.stack(tokens)[None], "labels": np.stack(labels)[None]}


def make_config(args, tok: ByteTokenizer, device: torch.device) -> tuple[llama.LlamaConfig, torch.dtype]:
    """The JAX tool's model at ``--embed_dim`` / ``--num_layers`` with ``task_heads``' heads."""
    heads = learned_task.task_heads(args.embed_dim, device)
    dtype = heads.pop("dtype")
    return llama.tiny_config(embed_dim=args.embed_dim, num_layers=args.num_layers, intermediate_dim=3 * args.embed_dim,
                             vocab_size=tok.vocab_size + 5, max_seq_len=512, **heads), dtype


def loss_fn(model, mb):
    loss = vision_mod.forward(model, mb["images"], mb["tokens"].long(), labels=mb["labels"], prefix_lm=True)
    return loss, (mb["labels"] != -100).sum()


def eval_captions(model: LlamaVision, tok: ByteTokenizer, rng: np.random.Generator, n_samples: int):
    """Greedy captions of held-out shape combinations: (exact match, WER, refs, hyps)."""
    refs, hyps = [], []
    for _ in range(n_samples):
        img, caption = make_shapes_sample(rng, model.vision_config.image_size, split="eval")
        with torch.inference_mode():
            prefix = vision_mod.patch_embed(model.patch_embed, model.vision_config,
                                            torch.from_numpy(img[None]).to(model.device),
                                            dtype=model.tok_embeddings.dtype)
        refs.append(caption)
        hyps.append(learned_task.greedy_text(model, prefix, tok, TEXT_LEN))
    exact = sum(r == h for r, h in zip(refs, hyps)) / max(len(refs), 1)
    return exact, wer(refs, hyps), refs, hyps


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--eval_samples", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", default="runs/torch_vision_synthetic")
    parser.add_argument("--patch_size", type=int, default=PATCH_SIZE)
    parser.add_argument("--image_size", type=int, default=IMAGE_SIZE)
    parser.add_argument("--embed_dim", type=int, default=256)
    parser.add_argument("--num_layers", type=int, default=4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--no_newline", action="store_true", help="drop the Fuyu row-newline tokens")
    parser.add_argument("--skip_save", action="store_true", help="sweep mode: no checkpoint round trip")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    tok = ByteTokenizer()
    config, dtype = make_config(args, tok, device)
    vision_config = VisionConfig(image_size=args.image_size, patch_size=args.patch_size, use_newline=not args.no_newline)
    model = LlamaVision.init(config, vision_config, seed=args.seed, dtype=dtype, device=device)
    set_trainable(model, ())
    # the decay phase sharpens held-out accuracy on this task (constant-lr runs plateau)
    optimizer = get_optimizer("AdamW", trainable_parameters(model), trapezoid_schedule(args.lr, args.steps, 0.05, 0.4),
                              weight_decay=args.weight_decay)

    counts = learned_task.launch_counts()
    exact_init, wer_init, _, _ = eval_captions(model, tok, np.random.default_rng(args.seed + 10_000),
                                               args.eval_samples)
    print(f"before training: exact_match {exact_init:.3f}  wer {wer_init:.3f}")
    state, losses, train_s = learned_task.train(
        model, optimizer, loss_fn, batches(np.random.default_rng(args.seed), tok, args.batch_size, args.image_size),
        args.steps)
    if args.skip_save:
        restored = model
    else:
        restored = learned_task.checkpoint_round_trip(args.out_dir, state, args.steps)
    exact_final, wer_final, refs, hyps = eval_captions(restored, tok, np.random.default_rng(args.seed + 10_000),
                                                       args.eval_samples)
    print(f"after {args.steps} steps: exact_match {exact_final:.3f}  wer {wer_final:.3f}")
    for r, h in list(zip(refs, hyps))[:4]:
        print(f"  ref: {r!r}  hyp: {h!r}")

    artifact = {
        "task": "synthetic two-shape captioning (6 colors x 4 shapes per side; eval combos disjoint from training: "
                "sum(indices) % 4 == 0 never trained on)",
        "exact_match_before": exact_init,
        "exact_match_after": exact_final,
        "wer_before": wer_init,
        "wer_after": wer_final,
        "steps": args.steps,
        "final_loss": losses[-1],
        "losses_every_50": losses,
        "train_seconds": train_s,
        "n_eval_samples": args.eval_samples,
        "restored_from_checkpoint": not args.skip_save,
        "launches": learned_task.launches_since(counts),
        "recipe": {
            "patch_size": args.patch_size, "image_size": args.image_size, "embed_dim": args.embed_dim,
            "num_layers": args.num_layers, "lr": args.lr, "weight_decay": args.weight_decay,
            "newline": not args.no_newline, "batch_size": args.batch_size, "schedule": "trapezoid 0.05 / 0.4",
        },
        "model": {"head_dim": config.head_dim, "num_heads": config.num_heads, "num_kv_heads": config.num_kv_heads,
                  "dtype": str(dtype), "optimizer_state": "float32"},
        **learned_task.device_record(device),
    }
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "accuracy.json").write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
