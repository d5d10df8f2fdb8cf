"""LibriSpeech-style ASR fine-tuning trainer (port of train_librispeech.py): audio
windows -> early-fusion ``LlamaAudio`` (audio tokens prepended to the text, optional
prefix-LM attention) -> the eager train step.

    # offline smoke on the CPU (synthetic noise 'utterances', small random model):
    python -m llama_x_tpu_torch.train_librispeech --synthetic 64 --n_steps 10 --audio_duration 4 --device cpu

    # the 8B QLoRA step on the card: 40 s of audio -> 2000 audio tokens + 2096 text tokens:
    python -m llama_x_tpu_torch.train_librispeech --synthetic 8 --geometry 8b --quantize int8 \\
        --quantize_kwargs '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}' \\
        --adapter lora --freeze_prefixes tok_embeddings output norm audio_embed --activation_checkpointing \\
        --remat_policy flash_q8s --fused_ce_chunks 8 --prefix_lm --audio_duration 40 --seq_len_multiple 2096 \\
        --n_steps 4 --log_interval 1 --ckpt_interval 0

Runs on the card unless ``--device cpu``. Real LibriSpeech data (``--dataset_dir``), HF
weights and meshes belong to later slices and raise by name.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.models import audio as audio_mod
from llama_x_tpu_torch.models.audio import AudioConfig
from llama_x_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from llama_x_tpu_torch.train.cli import (
    add_common_args,
    assemble_step_batch,
    build_model_params,
    check_supported,
    make_save_dir,
    save_model_config,
    setup_optimizer,
)
from llama_x_tpu_torch.train.metrics import RunLogger, Throughput, device_memory_stats
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

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


def make_loss_fn(prefix_lm: bool):
    def loss_fn(model, mb):
        loss = audio_mod.forward(model, mb["audio"], mb["tokens"].long(), labels=mb["labels"], prefix_lm=prefix_lm)
        return loss, (mb["labels"] != -100).sum()

    return loss_fn


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(parser)
    parser.add_argument("--dataset_dir", help="real LibriSpeech data (not ported yet: slice 4)")
    parser.add_argument("--audio_duration", type=float, default=40.0)
    parser.add_argument("--seq_len_multiple", type=int, default=128)
    parser.add_argument("--prefix_lm", action="store_true", help="bidirectional attention over the audio prefix")
    args = parser.parse_args(argv)
    if args.dataset_dir:
        raise NotImplementedError("--dataset_dir: real LibriSpeech data (flac decoding, packing, the llama "
                                  "tokenizers) is not ported yet (slice 4); pass --synthetic N")
    check_supported(args, real_data="LibriSpeech data (slice 4)")
    audio_tokens = AudioConfig().num_audio_tokens(int(args.audio_duration * AudioConfig().sample_rate))
    if audio_tokens + args.seq_len_multiple > MAX_SEQ_LEN:
        raise ValueError(f"{audio_tokens} audio tokens + {args.seq_len_multiple} text tokens exceed the model's "
                         f"{MAX_SEQ_LEN} positions")
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    audio_config = AudioConfig()
    model = build_model_params(args, max_seq_len=MAX_SEQ_LEN, audio_config=audio_config)
    config = model.config
    optimizer, schedule = setup_optimizer(args, model)
    micro_bs = args.batch_size // args.gradient_accumulation
    data_iter = synthetic_audio_batches(np.random.default_rng(args.seed), audio_config, micro_bs, args.audio_duration,
                                        args.seq_len_multiple, config.vocab_size)

    state = TrainState(model, optimizer)
    train_step = make_train_step(make_loss_fn(args.prefix_lm), skip_nonfinite=args.skip_nonfinite)
    if args.resume:
        path = latest_checkpoint(args.resume) or args.resume
        restore_checkpoint(path, state)
        print(f"resumed from {path} at step {state.step}")

    save_dir = make_save_dir("librispeech", args.run_name)
    save_model_config(save_dir, config, audio_config)
    logger = RunLogger(save_dir, config=vars(args))
    meter = Throughput()

    tok_acc, audio_acc = 0, 0.0  # tokens summed on the device between log points: no read-back every step
    while state.step < args.n_steps:
        step = state.step
        micro = [next(data_iter) for _ in range(args.gradient_accumulation)]
        metrics = train_step(state, assemble_step_batch(micro, pad_values={"labels": -100}))
        tok_acc = tok_acc + metrics["n_tokens"]
        audio_acc += args.audio_duration * args.batch_size
        if step % args.log_interval == 0:
            meter.update(int(tok_acc), audio_secs=audio_acc)
            tok_acc, audio_acc = 0, 0.0
            log = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(schedule(step)), **device_memory_stats(model.device)}
            if step > 0:
                log.update(meter.rates())
            logger.log(log, step)
            print(f"step {step}: loss {log['loss']:.4f}")
        if args.ckpt_interval > 0 and state.step % args.ckpt_interval == 0:
            save_checkpoint(save_dir, state, state.step)

    save_checkpoint(save_dir, state, state.step)
    logger.finish()


if __name__ == "__main__":
    main()
