"""Synthetic end-to-end WER: tone-to-word ASR through the whole training and evaluation
loop (port of tools/wer_synthetic.py).

A small LlamaAudio learns a task that needs the audio: each utterance is three pure tones
whose frequencies encode words, and the transcript names them. Train and evaluation draw
from disjoint combinations (evaluation: the triples whose index sum is 0 mod 4, which
training rejection-samples out), so a low WER means the model transcribes each tone from
the audio prefix rather than replaying triples it saw. The loop:

  train (train/trainer.py, prefix-LM audio fusion) -> save_checkpoint -> restore_model
  -> generate() greedy with the audio prefix (models/generate.py) -> train/wer.py

    # on the card (heads of 64 in bf16: K2 / K5 train it, K2 / K3 decode it)
    python -m llama_x_tpu_torch.wer_synthetic --steps 800
    # on the CPU: the JAX tool's model exactly (heads of 32, fp32)
    python -m llama_x_tpu_torch.wer_synthetic --device cpu --steps 300

Writes ``<out_dir>/wer.json``: WER before and after training, the steps, the recipe, the
head geometry, the dtype, the train seconds and the device (train/learned_task.py).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.adapters.lora import set_trainable
from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
from llama_x_tpu_torch.models import audio as audio_mod
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.audio import AudioConfig, LlamaAudio
from llama_x_tpu_torch.train import learned_task
from llama_x_tpu_torch.train.optim import get_optimizer
from llama_x_tpu_torch.train.trainer import trainable_parameters
from llama_x_tpu_torch.train.wer import wer
from llama_x_tpu_torch.utils.device import resolve_device

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
FREQS = [220.0 * 2 ** (i / 2) for i in range(len(WORDS))]  # 220 Hz to about 2.5 kHz, half octaves
TONE_SECS = 0.5
WORDS_PER_UTT = 3
SR = 16_000
TEXT_LEN = 32  # bos + "alpha bravo charlie" + eos fits with margin


def make_utterance(rng: np.random.Generator, split: str = "train"):
    """A random tone sequence -> (waveform [T], transcript). ``split`` partitions the 8^3
    combinations: "eval" keeps the triples with sum(idx) % 4 == 0, "train" rejects them."""
    while True:
        idx = rng.integers(0, len(WORDS), WORDS_PER_UTT)
        held_out = int(idx.sum()) % 4 == 0
        if held_out == (split == "eval"):
            break
    t = np.arange(int(TONE_SECS * SR)) / SR
    tones = [np.sin(2 * np.pi * FREQS[i] * t) * 0.3 for i in idx]
    return np.concatenate(tones).astype(np.float32), " ".join(WORDS[i] for i in idx)


def batches(rng: np.random.Generator, tok: ByteTokenizer, batch_size: int):
    """Step batches of training utterances, with a leading accumulation axis of 1."""
    while True:
        audio, tokens, labels = [], [], []
        for _ in range(batch_size):
            wav, text = make_utterance(rng, split="train")
            t, lab = learned_task.encode_text(tok, text, TEXT_LEN)
            audio.append(wav)
            tokens.append(t)
            labels.append(lab)
        yield {"audio": np.stack(audio)[None], "tokens": np.stack(tokens)[None], "labels": np.stack(labels)[None]}


def make_config(tok: ByteTokenizer, device: torch.device) -> tuple[llama.LlamaConfig, torch.dtype]:
    """The JAX tool's model (embed 256, 4 layers, MLP 768) with ``task_heads``' heads."""
    heads = learned_task.task_heads(256, device)
    dtype = heads.pop("dtype")
    return llama.tiny_config(embed_dim=256, num_layers=4, intermediate_dim=768, vocab_size=tok.vocab_size + 5,
                             max_seq_len=512, **heads), dtype


def loss_fn(model, mb):
    loss = audio_mod.forward(model, mb["audio"], mb["tokens"].long(), labels=mb["labels"], prefix_lm=True)
    return loss, (mb["labels"] != -100).sum()


def eval_wer(model: LlamaAudio, tok: ByteTokenizer, rng: np.random.Generator, n_utts: int):
    """Greedy transcripts of held-out tone sequences through ``generate``."""
    refs, hyps = [], []
    for _ in range(n_utts):
        wav, text = make_utterance(rng, split="eval")
        with torch.inference_mode():
            prefix = audio_mod.audio_embed(model.audio_embed, model.audio_config,
                                           torch.from_numpy(wav[None]).to(model.device),
                                           dtype=model.tok_embeddings.dtype)
        refs.append(text)
        hyps.append(learned_task.greedy_text(model, prefix, tok, TEXT_LEN))
    return wer(refs, hyps), refs, hyps


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--eval_utts", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out_dir", default="runs/torch_wer_synthetic")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    tok = ByteTokenizer()
    config, dtype = make_config(tok, device)
    model = LlamaAudio.init(config, AudioConfig(), seed=args.seed, dtype=dtype, device=device)
    set_trainable(model, ())
    optimizer = get_optimizer("AdamW", trainable_parameters(model), args.lr)

    counts = learned_task.launch_counts()
    wer_init, _, _ = eval_wer(model, tok, np.random.default_rng(args.seed + 10_000), args.eval_utts)
    print(f"WER before training: {wer_init:.3f}")
    state, losses, train_s = learned_task.train(model, optimizer, loss_fn,
                                                batches(np.random.default_rng(args.seed), tok, args.batch_size),
                                                args.steps)
    restored = learned_task.checkpoint_round_trip(args.out_dir, state, args.steps)
    wer_final, refs, hyps = eval_wer(restored, tok, np.random.default_rng(args.seed + 10_000), args.eval_utts)
    print(f"WER after {args.steps} steps: {wer_final:.3f}")
    for r, h in list(zip(refs, hyps))[:4]:
        print(f"  ref: {r!r}  hyp: {h!r}")

    artifact = {
        "task": "synthetic tone-sequence ASR (8 words x 3 tones; eval combos disjoint from training: "
                "sum(idx) % 4 == 0 never trained on)",
        "wer_before": wer_init,
        "wer_after": wer_final,
        "steps": args.steps,
        "final_loss": losses[-1],
        "losses_every_50": losses,
        "train_seconds": train_s,
        "n_eval_utts": args.eval_utts,
        "restored_from_checkpoint": True,
        "launches": learned_task.launches_since(counts),
        "recipe": {"lr": args.lr, "batch_size": args.batch_size, "optimizer": "AdamW", "seed": args.seed},
        "model": {"embed_dim": config.embed_dim, "num_layers": config.num_layers, "head_dim": config.head_dim,
                  "num_heads": config.num_heads, "num_kv_heads": config.num_kv_heads, "dtype": str(dtype),
                  "optimizer_state": "float32"},
        **learned_task.device_record(device),
    }
    out = Path(args.out_dir) / "wer.json"
    out.write_text(json.dumps(artifact, indent=1))
    print(json.dumps(artifact))
    return artifact


if __name__ == "__main__":
    main()
