"""Image-captioning evaluation (port of eval_vision.py): greedy captions from the
Fuyu-style image model, scored by exact match and word error rate.

    # offline, on the CPU: N samples of the shapes task's eval split, small random model
    python -m llama_x_tpu_torch.eval_vision --synthetic 8 --image_size 32 --patch_size 8 --device cpu
    # a trained run of train_vision (its model_config.json and latest checkpoint):
    python -m llama_x_tpu_torch.eval_vision --synthetic 32 --resume runs/vision/<run>
    python -m llama_x_tpu_torch.eval_vision --data_dir data/captions_val --resume runs/vision/<run> \\
        --tokenizer llama3 --tokenizer_path tokenizer.model

The shapes task's eval split holds combinations no training sample has
(data/vision.py:shapes_split), so a good score needs the pixels. Decoding runs on the
card unless ``--device cpu``: the prefill through K2 with the image prefix (K1 for an
int8 base), each new token through K3. ``--model``: text weights from a local HF
checkpoint directory with a fresh patch stem (models/hf.py), as the JAX evaluation has it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.data.tokenizers import ByteTokenizer, get_tokenizer
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models import vision as vision_mod
from llama_x_tpu_torch.models.generate import generate
from llama_x_tpu_torch.models.vision import LlamaVision, VisionConfig
from llama_x_tpu_torch.train.wer import wer


def decode_texts(out: torch.Tensor, tokenizer) -> list[str]:
    """Generated ids [B, N] -> one string per row, pad and eos dropped."""
    texts = []
    for row in out.cpu().tolist():
        toks = [t for t in row if t not in (tokenizer.pad_id, tokenizer.eos_id)]
        texts.append(tokenizer.decode(toks).strip())
    return texts


def caption_batch(model: LlamaVision, images: torch.Tensor, tokenizer, max_new_tokens: int, prefix_lm: bool):
    """images [B, H, W, C] -> greedy captions (list[str])."""
    with torch.inference_mode():
        prefix = vision_mod.patch_embed(model.patch_embed, model.vision_config, images.to(model.device),
                                        dtype=model.tok_embeddings.dtype)
    bos = torch.full((images.shape[0], 1), tokenizer.bos_id, dtype=torch.long, device=model.device)
    out = generate(model, bos, max_new_tokens=max_new_tokens, eos_id=tokenizer.eos_id, pad_id=tokenizer.pad_id,
                   prefix_embeds=prefix, prefix_lm=prefix_lm)
    return decode_texts(out, tokenizer)


def _caption_batched(model, images: list[np.ndarray], tokenizer, args) -> list[str]:
    """Batches of ``--eval_batch_size`` (the tail padded with blank canvases, whose
    captions are dropped), so every call has one shape."""
    B = max(1, args.eval_batch_size)
    hyps: list[str] = []
    for i in range(0, len(images), B):
        chunk = images[i : i + B]
        buf = np.zeros((B, *chunk[0].shape), np.float32)
        for j, im in enumerate(chunk):
            buf[j] = im
        texts = caption_batch(model, torch.from_numpy(buf), tokenizer, args.max_new_tokens, args.prefix_lm)
        hyps.extend(texts[: len(chunk)])
    return hyps


def _score(refs: list[str], hyps: list[str]) -> dict:
    exact = sum(r == h for r, h in zip(refs, hyps)) / max(len(refs), 1)
    return {"exact_match": exact, "wer": wer(refs, hyps), "n_samples": len(refs)}


def synthetic_model(vision_config: VisionConfig, device) -> LlamaVision:
    """The small random model of ``--synthetic`` without ``--resume``: the JAX
    evaluation's width and depth in bf16 from seed 0, with heads of 64 (4 query, 2 kv)
    where the JAX one has 8 / 4 of 32, since the card's attention kernels take head_dim 64
    or 128."""
    config = llama.tiny_config(embed_dim=256, num_layers=4, head_dim=64, num_heads=4, num_kv_heads=2,
                               intermediate_dim=512, vocab_size=512, max_seq_len=512)
    return LlamaVision.init(config, vision_config, seed=0, dtype=torch.bfloat16, device=device)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_dir", help="images with captions.jsonl / captions.tsv")
    parser.add_argument("--model", help="a local HF checkpoint directory (text weights; a fresh stem)")
    parser.add_argument("--tokenizer", default="byte", choices=["byte", "llama2", "llama3"])
    parser.add_argument("--tokenizer_path")
    parser.add_argument("--resume", help="a train_vision run directory (or a step directory inside one)")
    parser.add_argument("--max_samples", type=int, default=100)
    parser.add_argument("--max_new_tokens", type=int, default=64)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--patch_size", type=int, default=14)
    parser.add_argument("--prefix_lm", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0, help="N samples of the shapes task's eval split")
    parser.add_argument("--eval_batch_size", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.synthetic and not (args.data_dir and (args.resume or args.model)):
        raise ValueError("--data_dir needs --resume (a train_vision run) or --model; or pass --synthetic N")
    return args


def main(argv: list[str] | None = None) -> dict:
    from llama_x_tpu_torch.train.checkpoint import restore_model

    args = parse_args(argv)
    if args.resume:
        model = restore_model(args.resume, args.device)
    elif args.model:
        model = LlamaVision.from_hf(args.model, device=args.device, image_size=args.image_size,
                                    patch_size=args.patch_size, max_seq_len=4096)
    else:
        model = synthetic_model(VisionConfig(image_size=args.image_size, patch_size=args.patch_size), args.device)
    if args.synthetic:
        from llama_x_tpu_torch.data.vision import make_shapes_sample

        tokenizer = ByteTokenizer()
        rng = np.random.default_rng(args.seed)
        images, refs = [], []
        for _ in range(args.synthetic):
            img, caption = make_shapes_sample(rng, model.vision_config.image_size, split="eval")
            images.append(img)
            refs.append(caption)
        res = {**_score(refs, _caption_batched(model, images, tokenizer, args)), "synthetic": True}
    else:
        from llama_x_tpu_torch.data.vision import index_captions, load_image

        tokenizer = get_tokenizer(args.tokenizer, args.tokenizer_path)
        samples = index_captions(args.data_dir)[: args.max_samples]
        images = [load_image(Path(args.data_dir) / rel, model.vision_config.image_size) for rel, _ in samples]
        refs = [text.strip() for _, text in samples]
        res = _score(refs, _caption_batched(model, images, tokenizer, args))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
