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

Runs on the card unless ``--device cpu``. Real data, a mesh with fsdp / pp / tp above 1
and the ``attn_q8`` remat policies belong to later slices and raise by name.
"""

from __future__ import annotations

import argparse

import numpy as np

from llama_x_tpu_torch.data.metamathqa import get_metamathqa
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.train.cli import add_common_args, build_model_params, check_supported, run_training, setup_mesh
from llama_x_tpu_torch.train.validate import validate_model


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
    mesh = setup_mesh(args, "text", args.max_seq_len)
    model = build_model_params(args, max_seq_len=args.max_seq_len)
    validate_model(model.config, mesh, args)
    data_iter, train_size = make_data(args, model.config.vocab_size)
    print(f"Training dataset size: {train_size:,}")
    run_training(args, model, data_iter, loss_fn, "metamathqa", mesh=mesh)


if __name__ == "__main__":
    main()
