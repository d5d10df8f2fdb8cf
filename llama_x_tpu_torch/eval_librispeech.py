"""LibriSpeech WER evaluation (port of eval_librispeech.py): greedy transcripts from the
early-fusion audio model, scored by word error rate.

    # offline, on the CPU: N synthetic 1 s utterances through a small random model
    python -m llama_x_tpu_torch.eval_librispeech --synthetic 4 --device cpu
    # a trained run of train_librispeech (its model_config.json and latest checkpoint):
    python -m llama_x_tpu_torch.eval_librispeech --data_dir LibriSpeech/dev-clean --resume runs/librispeech/<run> \\
        --tokenizer llama2 --tokenizer_path tokenizer.model

Decoding runs on the card unless ``--device cpu``: the prefill through K2 with the audio
prefix (K1 for an int8 base), each new token through K3. ``--model``: text weights from a
local HF checkpoint directory with a fresh audio stem (models/hf.py), as the JAX
evaluation has it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from llama_x_tpu_torch.data.tokenizers import ByteTokenizer, get_tokenizer
from llama_x_tpu_torch.eval_vision import decode_texts
from llama_x_tpu_torch.models import audio as audio_mod
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.audio import AudioConfig, LlamaAudio
from llama_x_tpu_torch.models.generate import generate
from llama_x_tpu_torch.train.wer import wer


def transcribe_batch(model: LlamaAudio, audio: torch.Tensor, tokenizer, max_new_tokens: int, prefix_lm: bool):
    """audio [B, T_samples] -> greedy transcripts (list[str])."""
    with torch.inference_mode():
        prefix = audio_mod.audio_embed(model.audio_embed, model.audio_config, audio.to(model.device),
                                       dtype=model.tok_embeddings.dtype)
    bos = torch.full((audio.shape[0], 1), tokenizer.bos_id, dtype=torch.long, device=model.device)
    out = generate(model, bos, max_new_tokens=max_new_tokens, eos_id=tokenizer.eos_id, pad_id=tokenizer.pad_id,
                   prefix_embeds=prefix, prefix_lm=prefix_lm)
    return decode_texts(out, tokenizer)


def _decode_batched(model, wavs: list, tokenizer, args, pad_to: int | None = None) -> list[str]:
    """Greedy transcripts of ``wavs`` (1-D float32 arrays) in batches of
    ``--eval_batch_size``, each zero-padded to ``pad_to`` samples (default: the longest)
    and the tail batch padded with silent rows whose transcripts are dropped, so every
    call has one shape."""
    B = max(1, args.eval_batch_size)
    T = pad_to if pad_to is not None else max(len(w) for w in wavs)
    hyps: list[str] = []
    for i in range(0, len(wavs), B):
        chunk = wavs[i : i + B]
        buf = np.zeros((B, T), np.float32)
        for j, wav in enumerate(chunk):
            buf[j, : len(wav)] = wav
        texts = transcribe_batch(model, torch.from_numpy(buf), tokenizer, args.max_new_tokens, args.prefix_lm)
        hyps.extend(texts[: len(chunk)])
    return hyps


def synthetic_model(device) -> LlamaAudio:
    """The small random model of ``--synthetic`` without ``--resume``: the JAX
    evaluation's width and depth in bf16 from seed 0, with heads of 64 (4 query, 2 kv)
    where the JAX one has 8 / 4 of 32, since the card's attention kernels take head_dim 64
    or 128."""
    config = llama.tiny_config(embed_dim=256, num_layers=2, head_dim=64, num_heads=4, num_kv_heads=2,
                               intermediate_dim=512, vocab_size=512, max_seq_len=512)
    return LlamaAudio.init(config, AudioConfig(), seed=0, dtype=torch.bfloat16, device=device)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--data_dir", help="a LibriSpeech-layout directory")
    parser.add_argument("--model", help="a local HF checkpoint directory (text weights; a fresh stem)")
    parser.add_argument("--tokenizer", default="byte", choices=["byte", "llama2", "llama3"])
    parser.add_argument("--tokenizer_path")
    parser.add_argument("--resume", help="a train_librispeech run directory (or a step directory inside one)")
    parser.add_argument("--max_utts", type=int, default=100)
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--audio_duration", type=float, default=20.0)
    parser.add_argument("--prefix_lm", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0, help="N synthetic utterances (offline smoke)")
    parser.add_argument("--eval_batch_size", type=int, default=8, help="utterances decoded per generate() call")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.synthetic and not (args.data_dir and (args.resume or args.model)):
        raise ValueError("--data_dir needs --resume (a train_librispeech run) or --model; or pass --synthetic N")
    return args


def main(argv: list[str] | None = None) -> dict:
    from llama_x_tpu_torch.train.checkpoint import restore_model

    args = parse_args(argv)
    if args.resume:
        model = restore_model(args.resume, args.device)
    elif args.model:
        model = LlamaAudio.from_hf(args.model, device=args.device, max_seq_len=4096)
    else:
        model = synthetic_model(args.device)
    if args.synthetic:
        tokenizer = ByteTokenizer()
        rng = np.random.default_rng(0)
        audio_all = rng.standard_normal((args.synthetic, 16_000)).astype(np.float32) * 0.1
        hyps = _decode_batched(model, list(audio_all), tokenizer, args)
        refs = ["synthetic reference text"] * args.synthetic
        res = {"wer": wer(refs, hyps), "n_utts": len(refs), "synthetic": True}
    else:
        from llama_x_tpu_torch.data.librispeech import index_librispeech, load_audio

        tokenizer = get_tokenizer(args.tokenizer, args.tokenizer_path)
        samples = index_librispeech(args.data_dir, tokenizer)[: args.max_utts]
        max_samples = int(args.audio_duration * model.audio_config.sample_rate)
        wavs, refs = [], []
        for audio_path, utt_tokens in samples:
            wav, sr = load_audio(f"{args.data_dir}/{audio_path}")
            if sr != model.audio_config.sample_rate:
                raise ValueError(f"{audio_path}: {sr} Hz, the model reads {model.audio_config.sample_rate} Hz")
            if len(wav) > max_samples:
                continue
            wavs.append(wav)
            refs.append(tokenizer.decode(list(utt_tokens)).strip())
        hyps = _decode_batched(model, wavs, tokenizer, args, pad_to=max_samples)
        res = {"wer": wer(refs, hyps), "n_utts": len(refs)}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
