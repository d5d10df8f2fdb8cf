"""Synthetic end-to-end omni captioning: one small model, both modality prefixes, and a
caption that only reading both can produce (port of tools/omni_synthetic.py).

Each sample is (audio, image, text): the audio is two tones encoding two words (the
wer_synthetic scheme), the image one colored shape (the vision_synthetic rasterizer), and
the text "<tone-word> <tone-word> <color> <shape>": the first half is recoverable only
from the waveform, the second only from the pixels. Train and evaluation are disjoint on
the joint (audio, image) combination: quadruples with sum % 4 == 0 are evaluation only,
while every tone pair and every (color, shape) pair occurs in training. The loop:

  train (train/trainer.py, prefix-LM omni fusion, models/omni.py) -> save_checkpoint
  -> restore_model -> generate() greedy with the audio + image prefix -> WER and each
  half's accuracy

    # on the card (heads of 64 in bf16: K2 / K5 train it, K2 / K3 decode it); at the default
    # lr 2e-3 the bf16 model stops learning the image half (runs/torch_omni_synthetic/)
    python -m llama_x_tpu_torch.omni_synthetic --steps 3000 --lr 1e-3
    # on the CPU: the JAX tool's model exactly (heads of 32, fp32)
    python -m llama_x_tpu_torch.omni_synthetic --device cpu --steps 600

Writes ``<out_dir>/omni.json`` with the recipe, the head geometry, the dtype, the train
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
from llama_x_tpu_torch.data.vision import COLOR_NAMES, COLORS, SHAPES, _draw_shape
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models import omni as omni_mod
from llama_x_tpu_torch.models.audio import AudioConfig, audio_embed
from llama_x_tpu_torch.models.omni import LlamaOmni
from llama_x_tpu_torch.models.vision import VisionConfig, patch_embed
from llama_x_tpu_torch.train import learned_task
from llama_x_tpu_torch.train.optim import get_optimizer, trapezoid_schedule
from llama_x_tpu_torch.train.trainer import trainable_parameters
from llama_x_tpu_torch.train.wer import wer
from llama_x_tpu_torch.utils.device import resolve_device

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
FREQS = [220.0 * 2 ** (i / 2) for i in range(len(WORDS))]
TONE_SECS = 0.5
SR = 16_000
TEXT_LEN = 40
IMAGE_SIZE = 48
PATCH_SIZE = 6  # fine enough that a shape's geometry is resolved apart from its fill color


def make_sample(rng: np.random.Generator, split: str):
    """-> (waveform [T], image [H, W, 3], caption). The split is disjoint on the joint
    combination: (w1 + w2 + ci + si) % 4 == 0 is evaluation only. The caption's image half
    is drawn independently of its audio half, so scoring it still needs the pixels."""
    while True:
        w1, w2 = int(rng.integers(len(WORDS))), int(rng.integers(len(WORDS)))
        ci, si = int(rng.integers(len(COLOR_NAMES))), int(rng.integers(len(SHAPES)))
        if ((w1 + w2 + ci + si) % 4 == 0) == (split == "eval"):
            break
    t = np.arange(int(TONE_SECS * SR)) / SR
    wav = np.concatenate([np.sin(2 * np.pi * FREQS[i] * t) * 0.3 for i in (w1, w2)]).astype(np.float32)

    H = IMAGE_SIZE
    img = rng.standard_normal((H, H, 3)).astype(np.float32) * 0.05 - 0.5
    q = H // 4
    r = int(rng.integers(q // 2 + 1, q + 1))
    _draw_shape(img, SHAPES[si], COLORS[COLOR_NAMES[ci]], 2 * q + int(rng.integers(-4, 5)),
                2 * q + int(rng.integers(-4, 5)), r)
    return wav, img, f"{WORDS[w1]} {WORDS[w2]} {COLOR_NAMES[ci]} {SHAPES[si]}"


def batches(rng: np.random.Generator, tok: ByteTokenizer, batch_size: int):
    """Step batches of training samples, with a leading accumulation axis of 1."""
    while True:
        audio, images, tokens, labels = [], [], [], []
        for _ in range(batch_size):
            wav, img, caption = make_sample(rng, "train")
            t, lab = learned_task.encode_text(tok, caption, TEXT_LEN)
            audio.append(wav)
            images.append(img)
            tokens.append(t)
            labels.append(lab)
        yield {"audio": np.stack(audio)[None], "images": np.stack(images)[None], "tokens": np.stack(tokens)[None],
               "labels": np.stack(labels)[None]}


def make_config(tok: ByteTokenizer, device: torch.device) -> tuple[llama.LlamaConfig, torch.dtype]:
    """The JAX tool's model (embed 256, 4 layers, MLP 768) with ``task_heads``' heads."""
    heads = learned_task.task_heads(256, device)
    dtype = heads.pop("dtype")
    return llama.tiny_config(embed_dim=256, num_layers=4, intermediate_dim=768, vocab_size=tok.vocab_size + 5,
                             max_seq_len=512, **heads), dtype


def loss_fn(model, mb):
    loss = omni_mod.forward(model, mb["audio"], mb["images"], mb["tokens"].long(), labels=mb["labels"],
                            prefix_lm=True)
    return loss, (mb["labels"] != -100).sum()


def eval_model(model: LlamaOmni, tok: ByteTokenizer, rng: np.random.Generator, n_samples: int):
    """Greedy captions of held-out samples; each modality's half of the caption scored apart."""
    refs, hyps = [], []
    audio_hits = image_hits = 0
    dtype = model.tok_embeddings.dtype
    for _ in range(n_samples):
        wav, img, caption = make_sample(rng, "eval")
        with torch.inference_mode():
            pa = audio_embed(model.audio_embed, model.audio_config, torch.from_numpy(wav[None]).to(model.device),
                             dtype=dtype)
            pi = patch_embed(model.patch_embed, model.vision_config, torch.from_numpy(img[None]).to(model.device),
                             dtype=dtype)
        hyp = learned_task.greedy_text(model, torch.cat([pa, pi], dim=1), tok, TEXT_LEN)  # audio first
        refs.append(caption)
        hyps.append(hyp)
        rw, hw = caption.split(), hyp.split()
        audio_hits += len(hw) >= 2 and hw[:2] == rw[:2]
        image_hits += len(hw) >= 4 and hw[2:4] == rw[2:4]
    return {"wer": wer(refs, hyps), "audio_half_acc": audio_hits / n_samples,
            "image_half_acc": image_hits / n_samples}, refs, hyps


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--eval_samples", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", default="runs/torch_omni_synthetic")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    tok = ByteTokenizer()
    config, dtype = make_config(tok, device)
    model = LlamaOmni.init(config, AudioConfig(), VisionConfig(image_size=IMAGE_SIZE, patch_size=PATCH_SIZE),
                           seed=args.seed, dtype=dtype, device=device)
    set_trainable(model, ())
    optimizer = get_optimizer("AdamW", trainable_parameters(model), trapezoid_schedule(args.lr, args.steps, 0.05, 0.4),
                              weight_decay=0.01)

    counts = learned_task.launch_counts()
    before, _, _ = eval_model(model, tok, np.random.default_rng(args.seed + 10_000), args.eval_samples)
    print(f"before training: {before}")
    state, losses, train_s = learned_task.train(model, optimizer, loss_fn,
                                                batches(np.random.default_rng(args.seed), tok, args.batch_size),
                                                args.steps)
    restored = learned_task.checkpoint_round_trip(args.out_dir, state, args.steps)
    after, refs, hyps = eval_model(restored, tok, np.random.default_rng(args.seed + 10_000), args.eval_samples)
    print(f"after {args.steps} steps: {after}")
    for r, h in list(zip(refs, hyps))[:4]:
        print(f"  ref: {r!r}  hyp: {h!r}")

    artifact = {
        "task": "joint tone-pair ASR + single-shape captioning: caption halves are recoverable only from their own "
                "modality; eval JOINT (audio, image) combinations (sum of all indices % 4 == 0) never occur in "
                "training",
        "before": before,
        "after": after,
        "steps": args.steps,
        "final_loss": losses[-1],
        "losses_every_50": losses,
        "train_seconds": train_s,
        "n_eval_samples": args.eval_samples,
        "restored_from_checkpoint": True,
        "launches": learned_task.launches_since(counts),
        "recipe": {"lr": args.lr, "batch_size": args.batch_size, "weight_decay": 0.01,
                   "schedule": "trapezoid 0.05 / 0.4", "image_size": IMAGE_SIZE, "patch_size": PATCH_SIZE},
        "model": {"embed_dim": config.embed_dim, "num_layers": config.num_layers, "head_dim": config.head_dim,
                  "num_heads": config.num_heads, "num_kv_heads": config.num_kv_heads, "dtype": str(dtype),
                  "optimizer_state": "float32"},
        **learned_task.device_record(device),
    }
    (Path(args.out_dir) / "omni.json").write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
