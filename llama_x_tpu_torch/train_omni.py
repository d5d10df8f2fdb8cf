"""Mixed audio + image + text trainer for the omni early-fusion model (port of
train_omni.py, BASELINE config 5): audio tokens, then image tokens, then text, with
optional prefix-LM attention over every modality token.

    # offline smoke on the CPU (noise audio + shapes canvases + random text, small model):
    python -m llama_x_tpu_torch.train_omni --synthetic 64 --n_steps 10 --audio_duration 2 --image_size 32 \\
        --patch_size 8 --device cpu

    # a manifest.jsonl corpus (every record with text and audio and / or image):
    python -m llama_x_tpu_torch.train_omni --dataset_dir data/omni_corpus --tokenizer llama3 \\
        --tokenizer_path tokenizer.model --prefix_lm

    # the 8B QLoRA step on the card: 30 s -> 1500 audio tokens + 272 image tokens + 2324 text = 4096:
    python -m llama_x_tpu_torch.train_omni --synthetic 8 --geometry 8b --quantize int8 \\
        --quantize_kwargs '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}' \\
        --adapter lora --freeze_prefixes tok_embeddings output norm audio_embed patch_embed \\
        --activation_checkpointing --remat_policy flash_proj --fused_ce_chunks 4 --prefix_lm \\
        --audio_duration 30 --seq_len_multiple 2324 --max_text_len 2324 --n_steps 4 --log_interval 1 --ckpt_interval 0

Runs on the card unless ``--device cpu``. The weights are random (``--geometry`` or the
small model). ``--mesh`` runs under ``torch.distributed.run``: with ``'{"dp": D, "cp": C}'``
and ``--attn_impl ring|ulysses`` every rank runs both stems whole and keeps its slice of
the fused sequence; fsdp and tp shard the parameters; with a pp axis
(``--pp_microbatches``) both stems run outside the pipeline and their tokens (audio, then
image: ``omni.forward``'s order) enter at stage 0 as one prefix, as the JAX trainer's pp
branch has it.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.data.tokenizers import get_tokenizer
from llama_x_tpu_torch.data.vision import make_shapes_sample
from llama_x_tpu_torch.models import omni as omni_mod
from llama_x_tpu_torch.models.audio import AudioConfig
from llama_x_tpu_torch.models.vision import VisionConfig
from llama_x_tpu_torch.train.cli import (add_common_args, build_model_params, check_supported, place_model,
                                         pp_microbatch_count, prefetch, run_training, setup_mesh)
from llama_x_tpu_torch.train.validate import validate_model


def synthetic_omni_batches(rng, audio_config, micro_bs, audio_duration, image_size, seq_len_multiple, vocab):
    """Synthetic mixed batches: shapes canvases, then noise audio, then random text, drawn
    from ``rng`` in the JAX trainer's order."""
    T = int(audio_duration * audio_config.sample_rate)
    L = seq_len_multiple
    while True:
        images = np.stack([make_shapes_sample(rng, image_size, "train")[0] for _ in range(micro_bs)])
        audio = rng.standard_normal((micro_bs, T)).astype(np.float32) * 0.1
        tokens = rng.integers(1, vocab, (micro_bs, L)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
        labels[:, -1] = -100
        yield {"audio": audio, "images": images, "tokens": tokens, "labels": labels}


def make_loss_fn(prefix_lm: bool, args=None, mesh=None):
    """The omni loss, or with a pp mesh axis the GPipe schedule with both stems' tokens
    (audio, then image) as one prefix (the stems run outside the pipeline)."""
    if mesh is None or mesh.axis_size("pp") == 1:
        def loss_fn(model, mb):
            loss = omni_mod.forward(model, mb.get("audio"), mb.get("images"), mb["tokens"].long(),
                                    labels=mb["labels"], prefix_lm=prefix_lm)
            return loss, (mb["labels"] != -100).sum()

        return loss_fn
    import torch

    from llama_x_tpu_torch.models.audio import audio_embed
    from llama_x_tpu_torch.models.vision import patch_embed
    from llama_x_tpu_torch.parallel.pipeline import pipeline_loss

    n_micro = pp_microbatch_count(args, mesh, args.batch_size // args.gradient_accumulation)

    def pp_loss_fn(model, mb):
        dtype = model.tok_embeddings.dtype
        prefixes = []
        if "audio" in mb:
            prefixes.append(audio_embed(model.audio_embed, model.audio_config, mb["audio"], dtype=dtype))
        if "images" in mb:
            prefixes.append(patch_embed(model.patch_embed, model.vision_config, mb["images"], dtype=dtype))
        prefix = torch.cat(prefixes, dim=1) if prefixes else None
        loss = pipeline_loss(model, mb["tokens"].long(), mb["labels"], mesh, n_micro, prefix_embeds=prefix,
                             prefix_lm=prefix_lm, reduce_batch=False)
        return loss, (mb["labels"] != -100).sum()

    return pp_loss_fn


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(parser)
    parser.add_argument("--dataset_dir", help="a directory with manifest.jsonl (text plus audio and / or image)")
    parser.add_argument("--audio_duration", type=float, default=40.0)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--patch_size", type=int, default=14)
    parser.add_argument("--seq_len_multiple", type=int, default=128)
    parser.add_argument("--max_text_len", type=int, default=1024)
    parser.add_argument("--prefix_lm", action="store_true", help="bidirectional attention over all modality tokens")
    args = parser.parse_args(argv)
    check_supported(args, real_data=None)
    return args


def configs(args) -> tuple[AudioConfig, VisionConfig, int]:
    """(audio config, vision config, max_seq_len): audio tokens (50 a second) + image
    tokens + the text budget."""
    audio_config = AudioConfig()
    vision_config = VisionConfig(image_size=args.image_size, patch_size=args.patch_size)
    n_audio = audio_config.num_audio_tokens(int(args.audio_duration * audio_config.sample_rate))
    return audio_config, vision_config, n_audio + vision_config.num_image_tokens() + args.max_text_len


def make_data(args, audio_config: AudioConfig, micro_bs: int, vocab_size: int, tokenizer=None):
    """(microbatch iterator, has_audio): ``synthetic_omni_batches`` or ``OmniManifest``."""
    if args.synthetic:
        return synthetic_omni_batches(np.random.default_rng(args.seed), audio_config, micro_bs, args.audio_duration,
                                      args.image_size, args.seq_len_multiple, vocab_size), True
    from llama_x_tpu_torch.data.omni import OmniManifest

    ds = OmniManifest(args.dataset_dir, tokenizer, audio_duration=args.audio_duration, image_size=args.image_size,
                      seq_len_multiple=args.seq_len_multiple, batch_size=micro_bs,
                      sample_rate=audio_config.sample_rate, max_text_len=args.max_text_len, seed=args.seed)
    print(f"Training dataset size: {len(ds.records):,} (audio={ds.has_audio}, image={ds.has_image})")
    return prefetch(iter(ds), depth=4), ds.has_audio


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    audio_config, vision_config, max_seq_len = configs(args)
    mesh = setup_mesh(args, "omni", max_seq_len)
    tokenizer = None if args.synthetic else get_tokenizer(args.tokenizer, args.tokenizer_path)
    model = build_model_params(args, max_seq_len=max_seq_len, audio_config=audio_config, vision_config=vision_config,
                               vocab_size=None if tokenizer is None else tokenizer.vocab_size)
    validate_model(model.config, mesh, args, modality="omni")
    place_model(model, mesh)
    data_iter, has_audio = make_data(args, audio_config, args.batch_size // args.gradient_accumulation,
                                     model.config.vocab_size, tokenizer)
    run_training(args, model, data_iter, make_loss_fn(args.prefix_lm, args, mesh), "omni", audio_config=audio_config,
                 vision_config=vision_config,
                 audio_secs_per_step=args.audio_duration * args.batch_size if has_audio else 0.0, mesh=mesh)


if __name__ == "__main__":
    main()
