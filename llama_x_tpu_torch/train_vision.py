"""Image-captioning SFT trainer for the Fuyu-style image model (port of train_vision.py,
BASELINE config 3): images on a static canvas -> patch-embed stem -> image tokens
prepended to the caption (optional prefix-LM attention) -> the train step (on the card
replays of its captured CUDA graphs: train/step_graph.py).

    # offline smoke on the CPU (synthetic coloured-shapes task, byte tokenizer, small model):
    python -m llama_x_tpu_torch.train_vision --synthetic 64 --n_steps 10 --image_size 32 --patch_size 8 --device cpu

    # a directory of images with captions.jsonl (or captions.tsv):
    python -m llama_x_tpu_torch.train_vision --dataset_dir data/captions --tokenizer llama3 \\
        --tokenizer_path tokenizer.model --prefix_lm

    # the 8B QLoRA step on the card: 224 canvas, patch 14 -> 272 image tokens + 32 caption tokens:
    python -m llama_x_tpu_torch.train_vision --synthetic 64 --geometry 8b --quantize int8 \\
        --quantize_kwargs '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}' \\
        --adapter lora --freeze_prefixes tok_embeddings output norm patch_embed --activation_checkpointing \\
        --fused_ce_chunks 4 --prefix_lm --batch_size 8 --n_steps 4 --log_interval 1 --ckpt_interval 0

Runs on the card unless ``--device cpu``. The weights are random (``--geometry`` or the
small model). ``--mesh`` runs under ``torch.distributed.run``: with ``'{"dp": D, "cp": C}'``
and ``--attn_impl ring|ulysses`` every rank runs the patch stem whole and keeps its slice
of the fused sequence; fsdp and tp shard the parameters; with a pp axis
(``--pp_microbatches``) the patch stem runs outside the pipeline and its image tokens enter
at stage 0, as the JAX trainer's pp branch has it.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.data.tokenizers import get_tokenizer
from llama_x_tpu_torch.data.vision import ImageCaptions, synthetic_shapes_batches
from llama_x_tpu_torch.models import vision as vision_mod
from llama_x_tpu_torch.models.vision import VisionConfig
from llama_x_tpu_torch.train.cli import (add_common_args, build_model_params, check_supported, place_model,
                                         pp_microbatch_count, prefetch, run_training, setup_mesh)
from llama_x_tpu_torch.train.validate import validate_model


def make_loss_fn(prefix_lm: bool, args=None, mesh=None):
    """The vision loss, or with a pp mesh axis the GPipe schedule with the patch stem's
    tokens as the prefix (the stem runs outside the pipeline)."""
    if mesh is None or mesh.axis_size("pp") == 1:
        def loss_fn(model, mb):
            loss = vision_mod.forward(model, mb["images"], mb["tokens"].long(), labels=mb["labels"],
                                      prefix_lm=prefix_lm)
            return loss, (mb["labels"] != -100).sum()

        return loss_fn
    from llama_x_tpu_torch.parallel.pipeline import pipeline_loss

    n_micro = pp_microbatch_count(args, mesh, args.batch_size // args.gradient_accumulation)

    def pp_loss_fn(model, mb):
        prefix = vision_mod.patch_embed(model.patch_embed, model.vision_config, mb["images"],
                                        dtype=model.tok_embeddings.dtype)
        loss = pipeline_loss(model, mb["tokens"].long(), mb["labels"], mesh, n_micro, prefix_embeds=prefix,
                             prefix_lm=prefix_lm, reduce_batch=False)
        return loss, (mb["labels"] != -100).sum()

    return pp_loss_fn


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(parser)
    parser.add_argument("--dataset_dir", help="images with a captions.jsonl or captions.tsv manifest")
    parser.add_argument("--image_size", type=int, default=224, help="static square canvas")
    parser.add_argument("--patch_size", type=int, default=14)
    parser.add_argument("--seq_len_multiple", type=int, default=32)
    parser.add_argument("--max_text_len", type=int, default=512)
    parser.add_argument("--prefix_lm", action="store_true", help="bidirectional attention over the image tokens")
    args = parser.parse_args(argv)
    check_supported(args, real_data=None)
    return args


def make_data(args, micro_bs: int, tokenizer):
    """The microbatch iterator: the synthetic shapes task (byte tokens) or ``ImageCaptions``."""
    if args.synthetic:
        return synthetic_shapes_batches(np.random.default_rng(args.seed), tokenizer, micro_bs, args.image_size,
                                        args.seq_len_multiple)
    ds = ImageCaptions(args.dataset_dir, tokenizer, image_size=args.image_size, seq_len_multiple=args.seq_len_multiple,
                       batch_size=micro_bs, max_text_len=args.max_text_len, seed=args.seed)
    print(f"Training dataset size: {len(ds.samples):,}")
    return prefetch(iter(ds), depth=4)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    vision_config = VisionConfig(image_size=args.image_size, patch_size=args.patch_size)
    # image tokens + the text budget: 224 / 14 -> 256 patches + 16 newlines = 272
    max_seq_len = vision_config.num_image_tokens() + args.max_text_len
    mesh = setup_mesh(args, "vision", max_seq_len)
    tokenizer = get_tokenizer("byte") if args.synthetic else get_tokenizer(args.tokenizer, args.tokenizer_path)
    model = build_model_params(args, max_seq_len=max_seq_len, vision_config=vision_config,
                               vocab_size=tokenizer.vocab_size)
    validate_model(model.config, mesh, args, modality="vision")
    place_model(model, mesh)
    data_iter = make_data(args, args.batch_size // args.gradient_accumulation, tokenizer)
    run_training(args, model, data_iter, make_loss_fn(args.prefix_lm, args, mesh), "vision",
                 vision_config=vision_config, mesh=mesh)


if __name__ == "__main__":
    main()
