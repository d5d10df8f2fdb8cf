"""Text-only SFT trainer on MetaMathQA-style data (port of train_metamathqa.py).

    # offline smoke on the CPU (small random model, synthetic data, byte tokenizer):
    python -m llama_x_tpu_torch.train_metamathqa --synthetic 512 --n_steps 20 --batch_size 8 \\
        --document_mask --device cpu

    # QLoRA steps at Llama-3.1-8B width on the card, through the int8 and flash kernels:
    python -m llama_x_tpu_torch.train_metamathqa --synthetic 64 --geometry 8b --quantize int8 \\
        --quantize_kwargs '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}' \\
        --adapter lora --freeze_prefixes tok_embeddings output norm --activation_checkpointing \\
        --fused_ce_chunks 8 --document_mask --max_seq_len 4096 --gradient_accumulation 2 --batch_size 2 \\
        --n_steps 4 --log_interval 1

Runs on the card unless ``--device cpu``. Real data, HF weights, meshes and the
``attn_q8`` remat policies belong to later slices and raise by name.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.data.metamathqa import get_metamathqa
from llama_x_tpu_torch.models import llama
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


def loss_fn(model, mb):
    loss = llama.forward(model, mb["inputs"].long(), segment_ids=mb.get("segment_ids"), labels=mb["labels"])
    return loss, (mb["labels"] != -100).sum()


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(parser)
    parser.add_argument("--document_mask", action="store_true")
    parser.add_argument("--max_seq_len", type=int, default=1024)
    parser.add_argument("--seq_len_multiple", type=int, default=256)
    args = parser.parse_args(argv)
    check_supported(args)
    return args


def make_data(args, vocab_size: int):
    """(iterator over microbatches, dataset size) of the ``--synthetic`` samples."""
    micro_bs = args.batch_size // args.gradient_accumulation
    if args.synthetic_task == "count":
        from llama_x_tpu_torch.data.synthetic import counting_tokens
        from llama_x_tpu_torch.data.tokenizers import get_tokenizer

        tokens_list = counting_tokens(args.synthetic, args.seed, args.max_seq_len // 2, get_tokenizer("byte"))
    else:
        rng = np.random.default_rng(args.seed)
        tokens_list = [
            rng.integers(1, vocab_size, rng.integers(16, args.max_seq_len // 2)).astype(np.int32)
            for _ in range(args.synthetic)
        ]
    return get_metamathqa("byte", args.document_mask, micro_bs, args.max_seq_len, args.seq_len_multiple,
                          tokens_list=tokens_list, seed=args.seed)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    model = build_model_params(args, max_seq_len=args.max_seq_len)
    config = model.config
    optimizer, schedule = setup_optimizer(args, model)
    data_iter, train_size = make_data(args, config.vocab_size)
    print(f"Training dataset size: {train_size:,}")

    state = TrainState(model, optimizer)
    train_step = make_train_step(loss_fn, skip_nonfinite=args.skip_nonfinite)
    if args.resume:
        path = latest_checkpoint(args.resume) or args.resume
        restore_checkpoint(path, state)
        print(f"resumed from {path} at step {state.step}")

    save_dir = make_save_dir("metamathqa", args.run_name)
    save_model_config(save_dir, config)
    logger = RunLogger(save_dir, config=vars(args))
    meter = Throughput()

    tok_acc = 0  # summed on the device between log points: no read-back every step
    while state.step < args.n_steps:
        step = state.step
        micro = [next(data_iter) for _ in range(args.gradient_accumulation)]
        metrics = train_step(state, assemble_step_batch(micro, pad_values={"labels": -100}))
        tok_acc = tok_acc + metrics["n_tokens"]
        if step % args.log_interval == 0:
            meter.update(int(tok_acc))
            tok_acc = 0
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
