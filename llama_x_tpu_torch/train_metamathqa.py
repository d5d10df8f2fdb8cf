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

    # context parallelism: two ranks, the sequence split over "cp", ring attention (CPU)
    python -m torch.distributed.run --standalone --nproc_per_node 2 -m llama_x_tpu_torch.train_metamathqa \
        --synthetic 64 --n_steps 4 --batch_size 2 --document_mask --max_seq_len 256 --device cpu \
        --mesh '{"cp": 2}' --attn_impl ring

    # parameter sharding and the pipeline (CPU): --mesh '{"fsdp": 2}', '{"tp": 2}', or GPipe
    python -m torch.distributed.run --standalone --nproc_per_node 4 -m llama_x_tpu_torch.train_metamathqa \
        --synthetic 64 --n_steps 4 --batch_size 4 --document_mask --max_seq_len 256 --device cpu \
        --mesh '{"dp": 2, "pp": 2}' --pp_microbatches 2

    # real MetaMathQA from its token cache metamathqa_<tokenizer>_s<max_seq_len>.npz in the
    # working directory (data/metamathqa.py: tokenize_metamathqa writes it); a trace of steps 5-6
    python -m llama_x_tpu_torch.train_metamathqa --max_seq_len 512 --n_steps 10 --batch_size 4 --profile

Runs on the card unless ``--device cpu``. Without ``--synthetic`` a missing token cache
raises, naming the file: the port downloads nothing.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.data.metamathqa import cache_path, get_metamathqa
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.train.cli import (add_common_args, build_model_params, check_supported, place_model,
                                         pp_microbatch_count, run_training, setup_mesh)
from llama_x_tpu_torch.train.validate import validate_model


def loss_fn(model, mb):
    loss = llama.forward(model, mb["inputs"].long(), segment_ids=mb.get("segment_ids"), labels=mb["labels"])
    return loss, (mb["labels"] != -100).sum()


def make_loss_fn(args, mesh):
    """``loss_fn``, or with a pp mesh axis the GPipe schedule over ``pp_microbatch_count``
    microbatches (parallel/pipeline.py): to the train step just another loss."""
    if mesh.axis_size("pp") == 1:
        return loss_fn
    from llama_x_tpu_torch.parallel.pipeline import pipeline_loss

    n_micro = pp_microbatch_count(args, mesh, args.batch_size // args.gradient_accumulation)

    def pp_loss_fn(model, mb):
        loss = pipeline_loss(model, mb["inputs"].long(), mb["labels"], mesh, n_micro,
                             segment_ids=mb.get("segment_ids"), reduce_batch=False)
        return loss, (mb["labels"] != -100).sum()

    return pp_loss_fn


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(parser)
    parser.add_argument("--document_mask", action="store_true")
    parser.add_argument("--max_seq_len", type=int, default=1024)
    parser.add_argument("--seq_len_multiple", type=int, default=256)
    args = parser.parse_args(argv)
    check_supported(args, real_data=cache_path(args.tokenizer, args.max_seq_len))
    return args


def make_data(args, vocab_size: int):
    """(iterator over microbatches, dataset size): the ``--synthetic`` samples, or the real
    samples of the token cache in the working directory (every rank of a mesh draws the same
    step batch, and ``shard_batch`` gives each its rows)."""
    micro_bs = args.batch_size // args.gradient_accumulation
    if not args.synthetic:
        return get_metamathqa(args.tokenizer, args.document_mask, micro_bs, args.max_seq_len, args.seq_len_multiple,
                              seed=args.seed)
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
    mesh = setup_mesh(args, "text", args.max_seq_len)
    model = build_model_params(args, max_seq_len=args.max_seq_len)
    validate_model(model.config, mesh, args)
    place_model(model, mesh)
    data_iter, train_size = make_data(args, model.config.vocab_size)
    print(f"Training dataset size: {train_size:,}")
    run_training(args, model, data_iter, make_loss_fn(args, mesh), "metamathqa", mesh=mesh)


if __name__ == "__main__":
    main()
