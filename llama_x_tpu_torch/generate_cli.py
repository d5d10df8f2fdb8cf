"""Text generation from the command line (port of tools/generate_cli.py).

    python -m llama_x_tpu_torch.generate_cli --geometry 8b --quantize int8 \\
        --dynamic_int8_act --kv_dtype int8 --prompt "The capital of France is" --max_new_tokens 64
    python -m llama_x_tpu_torch.generate_cli --model /data/llama31-8b --tokenizer llama3 \\
        --tokenizer_path /data/llama31-8b/original/tokenizer.model --prompt "2+2=" --max_new_tokens 32
    python -m llama_x_tpu_torch.generate_cli --resume runs/metamathqa/<run> --draft_resume runs/metamathqa/<draft> \\
        --gamma 4 --prompt "2+2="
    echo "one prompt per line" | python -m llama_x_tpu_torch.generate_cli --geometry tiny --device cpu --stdin

Model sources (one of): ``--model`` a local HF checkpoint directory (models/hf.py,
streamed; ``--quantize int8`` makes it int8 as it loads), ``--resume`` a run of the port's
trainers (its model_config.json and latest checkpoint; int8 / LoRA / DoRA tensors serve as
they are), or ``--geometry`` (the default, 8b) for random weights made on the device from
``--seed`` at a published width. ``--draft_model`` / ``--draft_resume`` add a draft model:
speculative decoding with ``--gamma`` draft tokens a round. Text goes through
``--tokenizer`` (the offline byte tokenizer by default). Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops.linear import Linear
from llama_x_tpu_torch.utils.device import resolve_device

GEOMETRIES = {
    # CPU-sized smoke geometry (vocab holds the byte tokenizer's 259 ids)
    "tiny": dict(embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2,
                 intermediate_dim=128, vocab_size=512),
    # 1.1B-class
    "1b": dict(embed_dim=2048, num_layers=16, head_dim=128, num_heads=16,
               num_kv_heads=8, intermediate_dim=5632, vocab_size=32_000),
    # Llama-3.1-8B geometry
    "8b": dict(embed_dim=4096, num_layers=32, head_dim=128, num_heads=32,
               num_kv_heads=8, intermediate_dim=14336, vocab_size=128_256,
               rope_base=500_000.0, is_llama3_1=True),
}


def build_model(config: llama.LlamaConfig, quantize: bool, seed: int, device=None) -> llama.Llama:
    """Random weights made on the device from ``seed`` (as the serving bench makes
    them): each projection is drawn as rowwise int8 in [-127, 127] with scale
    0.02 / (73.3 sqrt(fan_in)), so the dequantized std is ~0.02 / sqrt(fan_in);
    embeddings and head are N(0, 0.02) in bf16, norms ones. ``quantize=False`` keeps
    the dequantized bf16 weights instead, so both builds from one seed compute the
    same function up to the int8 path's rounding."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D = config.num_layers, config.embed_dim
    HD, NH, NKV = config.head_dim, config.num_heads, config.num_kv_heads
    F, V = config.intermediate_dim, config.vocab_size
    bf16 = torch.bfloat16

    def qlin(fan_in, fan_out):
        int_data = torch.randint(-127, 128, (L, fan_out, fan_in), dtype=torch.int8, device=dev, generator=gen)
        scale = torch.full((L, fan_out), 0.02 / (73.3 * fan_in**0.5), dtype=bf16, device=dev)
        if quantize:
            return [Linear(int_data=int_data[i], scale=scale[i]) for i in range(L)]
        return [Linear(weight=(int_data[i].float() * scale[i].float()[:, None]).to(bf16)) for i in range(L)]

    def normal(shape):
        return (torch.randn(shape, device=dev, generator=gen) * 0.02).to(bf16)

    def norm():
        return llama.RMSNorm(torch.ones(D, dtype=bf16, device=dev), config.norm_eps)

    emb = normal((V, D))
    wq, wk, wv, wo = qlin(D, NH * HD), qlin(D, NKV * HD), qlin(D, NKV * HD), qlin(NH * HD, D)
    w1, w3, w2 = qlin(D, F), qlin(D, F), qlin(F, D)
    layers = [
        llama.Block(norm(), llama.Attention(wq[i], wk[i], wv[i], wo[i]),
                    norm(), llama.FeedForward(w1[i], w2[i], w3[i]))
        for i in range(L)
    ]
    output = None if config.tied_embeddings else Linear(weight=normal((V, D)))
    return llama.Llama(config, emb, layers, norm(), output)


def load_source(model_dir: str | None, resume: str | None, geometry: str | None, args, device) -> llama.Llama:
    """The model named by one of ``--model`` / ``--resume`` / ``--geometry`` (with the
    quantization, activation and cache-length flags of ``args``)."""
    if model_dir:
        model = llama.Llama.from_hf(model_dir, device=device, quantize=args.quantize)
    elif resume:
        from llama_x_tpu_torch.train.checkpoint import restore_model

        model = restore_model(resume, device)
    else:
        config = llama.LlamaConfig(**GEOMETRIES[geometry or "8b"], max_seq_len=args.max_seq_len or 4096)
        return build_model(config.replace(dynamic_int8_act=args.dynamic_int8_act), args.quantize == "int8", args.seed,
                           device)
    if args.max_seq_len:
        model.set_max_seq_len(args.max_seq_len)
    if args.dynamic_int8_act:
        model.config = model.config.replace(dynamic_int8_act=True)
    return model


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = parser.add_mutually_exclusive_group()
    src.add_argument("--model", help="a local HF checkpoint directory")
    src.add_argument("--resume", help="a run directory of the port's trainers (or a step directory inside one)")
    src.add_argument("--geometry", choices=sorted(GEOMETRIES), help="random weights at this width (default 8b)")
    draft = parser.add_mutually_exclusive_group()
    draft.add_argument("--draft_model", help="a local HF checkpoint directory of a draft model: speculative decoding")
    draft.add_argument("--draft_resume", help="a run directory of a draft model: speculative decoding")
    parser.add_argument("--gamma", type=int, default=4, help="draft tokens per verify pass")
    parser.add_argument("--tokenizer", default="byte", choices=["byte", "llama2", "llama3"])
    parser.add_argument("--tokenizer_path", help="local tokenizer.model of llama2 / llama3 (offline)")
    parser.add_argument("--quantize", choices=["int8"], help="int8 rowwise weights")
    parser.add_argument("--dynamic_int8_act", action="store_true",
                        help="int8 x int8 projections through the int8 GEMM kernel (an int8 base)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--prompt", action="append", default=[], help="repeatable")
    parser.add_argument("--stdin", action="store_true", help="read one prompt per stdin line")
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    parser.add_argument("--top_k", type=int, default=0)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--min_p", type=float, default=0.0, help="drop tokens with prob < min_p * top-token prob")
    parser.add_argument("--seed", type=int, default=0, help="weights and sampling noise")
    parser.add_argument("--max_seq_len", type=int, default=0,
                        help="KV cache length (0: 4096 for --geometry, the model's own otherwise)")
    parser.add_argument("--no_eos", action="store_true", help="ignore eos, always emit max_new_tokens")
    parser.add_argument("--kv_dtype", default="bf16", choices=["bf16", "int8"])
    parser.add_argument("--batch", action="store_true", help="all prompts in ONE ragged batch (not with a draft)")
    parser.add_argument("--template", choices=["alpaca"],
                        help="wrap each prompt in the training prompt template (alpaca: the MetaMathQA SFT format, "
                             "data/metamathqa.py)")
    parser.add_argument("--stream", action="store_true", help="print tokens as they decode (not with --batch or a draft)")
    return parser


def main(argv: list[str] | None = None) -> None:
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer
    from llama_x_tpu_torch.models.generate import generate, generate_stream

    parser = build_parser()
    args = parser.parse_args(argv)
    speculative = bool(args.draft_model or args.draft_resume)
    if args.stream and (args.batch or speculative):
        parser.error("--stream is plain per-prompt decoding (not combinable with --batch or a draft)")
    if args.batch and speculative:
        parser.error("--batch is for the plain path (not combinable with a draft)")
    if args.dynamic_int8_act and args.quantize != "int8" and not args.resume:
        parser.error("--dynamic_int8_act needs --quantize int8 (or a resumed int8 run)")

    prompts = list(args.prompt)
    if args.stdin:
        prompts += [line.rstrip("\n") for line in sys.stdin if line.strip()]
    if not prompts:
        parser.error("no prompts: pass --prompt (repeatable) or --stdin")
    if args.template == "alpaca":
        from llama_x_tpu_torch.data.metamathqa import PROMPT_TEMPLATE

        prompts = [PROMPT_TEMPLATE.format(query=p) for p in prompts]

    device = resolve_device(args.device)
    tok = get_tokenizer(args.tokenizer, args.tokenizer_path)
    model = load_source(args.model, args.resume, args.geometry, args, device)
    config = model.config
    draft = load_source(args.draft_model, args.draft_resume, None, args, device) if speculative else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cache_dtype = torch.int8 if args.kv_dtype == "int8" else torch.bfloat16
    eos_id = -1 if args.no_eos else tok.eos_id
    sample = dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
                  eos_id=eos_id, pad_id=tok.pad_id, cache_dtype=cache_dtype, generator=gen)

    def text_of(row) -> str:
        return tok.decode([int(t) for t in row if t not in (tok.pad_id, tok.eos_id)])

    if args.batch:
        ids_rows = [tok(p, add_bos=True) for p in prompts]
        P = max(len(r) for r in ids_rows)
        n_new = min(args.max_new_tokens, config.max_seq_len - P)
        if n_new <= 0:
            parser.error(f"longest prompt ({P} tokens) fills the {config.max_seq_len} cache")
        padded = torch.full((len(ids_rows), P), tok.pad_id, dtype=torch.long)
        for i, r in enumerate(ids_rows):
            padded[i, : len(r)] = torch.tensor(r)
        lens = torch.tensor([len(r) for r in ids_rows])
        t0 = time.perf_counter()
        rows = generate(model, padded.to(device), max_new_tokens=n_new, prompt_lens=lens.to(device), **sample).cpu()
        dt = time.perf_counter() - t0
        total = int((rows != tok.pad_id).sum())
        print(f"--- {len(prompts)} prompts in one ragged batch: {total} tokens ({total / dt:.1f} tok/s incl. "
              f"prefill) ---", file=sys.stderr)
        for prompt, row in zip(prompts, rows.tolist()):
            print(prompt + text_of(row))
        return

    for i, prompt in enumerate(prompts):
        ids = tok(prompt, add_bos=True)
        n_new = min(args.max_new_tokens, config.max_seq_len - len(ids))
        if draft is not None:
            n_new = min(n_new, config.max_seq_len - len(ids) - args.gamma - 1,
                        draft.config.max_seq_len - len(ids) - args.gamma)
        if n_new <= 0:
            parser.error(f"prompt ({len(ids)} tokens) fills the whole {config.max_seq_len} cache")
        prompt_t = torch.tensor([ids], device=device)
        t0 = time.perf_counter()
        spec = ""
        if draft is not None:
            from llama_x_tpu_torch.models.speculative import generate_speculative

            out, stats = generate_speculative(model, draft, prompt_t, max_new_tokens=n_new, gamma=args.gamma, **sample)
            row = out[0].tolist()
            spec = f", {stats['target_passes']} target passes"
            print(prompt + text_of(row))
        elif args.stream:
            print(prompt, end="", flush=True)
            row, text = [], ""
            for block in generate_stream(model, prompt_t, max_new_tokens=n_new, **sample):
                row += block[0].tolist()
                full = text_of(row)
                print(full[len(text):], end="", flush=True)
                text = full
            print(flush=True)
        else:
            row = generate(model, prompt_t, max_new_tokens=n_new, **sample)[0].tolist()
            print(prompt + text_of(row))
        dt = time.perf_counter() - t0
        n_out = sum(1 for t in row if t not in (tok.pad_id, tok.eos_id))
        print(f"--- prompt {i}: {len(ids)} tok prompt + {n_out} tok completion ({n_out / dt:.1f} tok/s incl. "
              f"prefill{spec}) ---", file=sys.stderr)


if __name__ == "__main__":
    main()
