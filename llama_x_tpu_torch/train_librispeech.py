"""LibriSpeech-style ASR fine-tuning trainer (port of train_librispeech.py): audio
windows -> early-fusion ``LlamaAudio`` (audio tokens prepended to the text, optional
prefix-LM attention) -> the train step (on the card
replays of its captured CUDA graphs: train/step_graph.py).

    # offline smoke on the CPU (synthetic noise 'utterances', small random model):
    python -m llama_x_tpu_torch.train_librispeech --synthetic 64 --n_steps 10 --audio_duration 4 --device cpu

    # a LibriSpeech-layout directory (**/*.trans.txt beside .flac or .wav files):
    python -m llama_x_tpu_torch.train_librispeech --dataset_dir LibriSpeech/train-clean-100 \\
        --tokenizer llama2 --tokenizer_path tokenizer.model --prefix_lm --audio_duration 20

    # the 8B QLoRA step on the card: 40 s of audio -> 2000 audio tokens + 2096 text tokens:
    python -m llama_x_tpu_torch.train_librispeech --synthetic 8 --geometry 8b --quantize int8 \\
        --quantize_kwargs '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}' \\
        --adapter lora --freeze_prefixes tok_embeddings output norm audio_embed --activation_checkpointing \\
        --remat_policy flash_q8s --fused_ce_chunks 8 --prefix_lm --audio_duration 40 --seq_len_multiple 2096 \\
        --n_steps 4 --log_interval 1 --ckpt_interval 0

Runs on the card unless ``--device cpu``. The weights are random (``--geometry`` or the
small model, its vocabulary grown to the tokenizer's). ``--mesh`` runs under
``torch.distributed.run``: with ``'{"dp": D, "cp": C}'`` and ``--attn_impl ring|ulysses``
every rank runs the audio stem whole and keeps its slice of the fused sequence; fsdp and tp
shard the parameters; with a pp axis (``--pp_microbatches``) the stem runs outside the
pipeline, its tokens enter at stage 0 and its gradient is summed over the stages, as the
JAX trainer's pp branch has it.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.data.librispeech import LibriSpeechPacked
from llama_x_tpu_torch.data.tokenizers import get_tokenizer
from llama_x_tpu_torch.models import audio as audio_mod
from llama_x_tpu_torch.models.audio import AudioConfig
from llama_x_tpu_torch.train.cli import (add_common_args, build_model_params, check_supported, place_model,
                                         pp_microbatch_count, prefetch, run_training, setup_mesh)
from llama_x_tpu_torch.train.validate import validate_model

MAX_SEQ_LEN = 4096  # 40 s -> 2000 audio tokens + up to 2096 text tokens


def synthetic_audio_batches(rng, audio_config, micro_bs, audio_duration, seq_len_multiple, vocab):
    """Synthetic windows for offline smoke runs: the JAX trainer's numpy draws, in its order."""
    T = int(audio_duration * audio_config.sample_rate)
    L = seq_len_multiple
    while True:
        audio = rng.standard_normal((micro_bs, T)).astype(np.float32) * 0.1
        tokens = rng.integers(1, vocab, (micro_bs, L)).astype(np.int32)
        labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
        labels[:, -1] = -100
        yield {"audio": audio, "tokens": tokens, "labels": labels}


def make_loss_fn(prefix_lm: bool, args=None, mesh=None):
    """The audio loss, or with a pp mesh axis the GPipe schedule with the stem's tokens as
    the prefix (the stem runs outside the pipeline)."""
    if mesh is None or mesh.axis_size("pp") == 1:
        def loss_fn(model, mb):
            loss = audio_mod.forward(model, mb["audio"], mb["tokens"].long(), labels=mb["labels"],
                                     prefix_lm=prefix_lm)
            return loss, (mb["labels"] != -100).sum()

        return loss_fn
    from llama_x_tpu_torch.parallel.pipeline import pipeline_loss

    n_micro = pp_microbatch_count(args, mesh, args.batch_size // args.gradient_accumulation)

    def pp_loss_fn(model, mb):
        prefix = audio_mod.audio_embed(model.audio_embed, model.audio_config, mb["audio"],
                                       dtype=model.tok_embeddings.dtype)
        loss = pipeline_loss(model, mb["tokens"].long(), mb["labels"], mesh, n_micro, prefix_embeds=prefix,
                             prefix_lm=prefix_lm, reduce_batch=False)
        return loss, (mb["labels"] != -100).sum()

    return pp_loss_fn


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(parser)
    parser.add_argument("--dataset_dir", help="a LibriSpeech-layout directory (**/*.trans.txt, .flac or .wav)")
    parser.add_argument("--audio_duration", type=float, default=40.0)
    parser.add_argument("--seq_len_multiple", type=int, default=128)
    parser.add_argument("--prefix_lm", action="store_true", help="bidirectional attention over the audio prefix")
    parser.add_argument("--n_workers", type=int, default=4,
                        help="accepted as the JAX trainer accepts it; the loader is prefetched on a thread")
    args = parser.parse_args(argv)
    check_supported(args, real_data=None)
    audio_tokens = AudioConfig().num_audio_tokens(int(args.audio_duration * AudioConfig().sample_rate))
    if audio_tokens + args.seq_len_multiple > MAX_SEQ_LEN:
        raise ValueError(f"{audio_tokens} audio tokens + {args.seq_len_multiple} text tokens exceed the model's "
                         f"{MAX_SEQ_LEN} positions")
    return args


def make_data(args, audio_config: AudioConfig, micro_bs: int, vocab_size: int | None, tokenizer=None):
    """The microbatch iterator: ``synthetic_audio_batches`` over ``vocab_size``, or
    ``LibriSpeechPacked`` over ``--dataset_dir`` with ``tokenizer``."""
    if args.synthetic:
        return synthetic_audio_batches(np.random.default_rng(args.seed), audio_config, micro_bs, args.audio_duration,
                                       args.seq_len_multiple, vocab_size)
    ds = LibriSpeechPacked(args.dataset_dir, tokenizer, audio_duration=args.audio_duration,
                           seq_len_multiple=args.seq_len_multiple, batch_size=micro_bs,
                           sample_rate=audio_config.sample_rate, seed=args.seed)
    print(f"Training dataset size: {len(ds.samples):,} utterances")
    return prefetch(iter(ds), depth=4)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    audio_config = AudioConfig()
    mesh = setup_mesh(args, "audio", MAX_SEQ_LEN)
    tokenizer = None if args.synthetic else get_tokenizer(args.tokenizer, args.tokenizer_path)
    model = build_model_params(args, max_seq_len=MAX_SEQ_LEN, audio_config=audio_config,
                               vocab_size=None if tokenizer is None else tokenizer.vocab_size)
    validate_model(model.config, mesh, args, modality="audio")
    place_model(model, mesh)
    micro_bs = args.batch_size // args.gradient_accumulation
    data_iter = make_data(args, audio_config, micro_bs, model.config.vocab_size, tokenizer)
    run_training(args, model, data_iter, make_loss_fn(args.prefix_lm, args, mesh), "librispeech",
                 audio_config=audio_config,
                 audio_secs_per_step=args.audio_duration * args.batch_size, mesh=mesh)


if __name__ == "__main__":
    main()
