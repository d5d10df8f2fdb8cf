"""Autoregressive decoding: prefill + KV-cache decode (port of
llama_x_tpu/models/generate.py).

- prefill: the prompt (optionally preceded by modality prefix embeddings, which
  attend bidirectionally with ``prefix_lm``) runs through the trunk once and writes
  K/V into the full-length cache; attention is over the fresh k/v (flash kernel).
- decode: a Python loop of single-token steps over the cache (decode kernel). The
  JAX package compiles the loop as one ``lax.scan``; CUDA graphs are later work.
- sampling: greedy (temperature 0) or temperature + top-k + min-p + top-p via
  Gumbel-max on the filtered logits, the noise drawn from a ``torch.Generator``.
  Greedy output equals the JAX package's token for token; sampled output follows
  the same law but cannot match JAX's random bits.
- eos: a ``done`` mask freezes finished rows to ``pad_id``.

``generate_stream`` yields token blocks as they decode and stops early once every
row is done; it draws the same noise in the same order as ``generate``, so the two
agree token for token on one generator seed.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops.attention import MaskInfo


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float = 1.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """Temperature + top-k + min-p + top-p: [..., V] logits -> f32 logits with the
    filtered-out tokens at -inf (softmax of the result is the sampling law).
    Caller guarantees temperature > 0."""
    logits = logits.float() / temperature
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if min_p > 0.0:
        cutoff = logits.amax(dim=-1, keepdim=True) + torch.log(torch.tensor(min_p))
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # the nucleus always includes the top token
        cutoff = torch.where(keep, sorted_logits, torch.tensor(float("inf"), device=logits.device))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def gumbel_argmax(filtered: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """argmax(filtered + Gumbel noise) over the last axis: one draw from
    softmax(filtered), the noise made from uniforms of the logits' shape."""
    u = torch.rand(filtered.shape, generator=generator, device=filtered.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return (filtered + gumbel).argmax(dim=-1)


def sample_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float = 1.0, min_p: float = 0.0,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64). temperature 0 -> argmax (no draw)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    return gumbel_argmax(filter_logits(logits, temperature, top_k, top_p, min_p), generator)


def _prefill(model: llama.Llama, prompt: torch.Tensor, *, generator, temperature, top_k, top_p, min_p, cache_dtype,
             prefix_embeds, prefix_lm, prompt_lens, max_new_tokens: int):
    """Prefill + first token -> (first [B], (kv_cache, last token, pos, done-less))."""
    config = model.config
    B, P = prompt.shape
    x = llama.embed(model, prompt)
    n_prefix = 0
    if prefix_embeds is not None:
        if prompt_lens is not None:
            raise ValueError("ragged prompts and modality prefixes do not combine")
        n_prefix = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    total_p = n_prefix + P
    if total_p + max_new_tokens > config.max_seq_len:
        raise ValueError(f"prefill {total_p} + {max_new_tokens} new tokens exceed max_seq_len {config.max_seq_len}")

    kv_cache = llama.init_kv_cache(config, B, dtype=cache_dtype, device=model.device,
                                    kv_heads=llama.local_kv_heads(model))
    pos = torch.arange(total_p, dtype=torch.int32, device=model.device)
    prefix = (torch.full((B,), n_prefix, dtype=torch.int32, device=model.device)
              if (prefix_lm and n_prefix) else None)
    h, kv_cache = llama.trunk(model, x, MaskInfo(causal=True, prefix_len=prefix), kv_cache, input_pos=pos,
                              prefill=True)
    if prompt_lens is None:
        h_last = h[:, -1:, :]
        pos0 = torch.tensor(total_p, dtype=torch.long, device=model.device)
    else:
        lens = prompt_lens.to(device=model.device, dtype=torch.long).reshape(-1).expand(B)
        h_last = h.gather(1, (lens - 1)[:, None, None].expand(B, 1, h.shape[-1]))
        pos0 = lens
    logits = llama.head(model, h_last)
    first = sample_logits(logits[:, 0], temperature, top_k, top_p, min_p, generator)
    return first, (kv_cache, first, pos0)


def _decode_steps(model: llama.Llama, state, n: int, *, generator, temperature, top_k, top_p, min_p, eos_id,
                  pad_id):
    """``n`` single-token decode steps from ``state`` = (kv_cache, tok [B], pos, done [B]);
    ``pos`` is a 0-d tensor (uniform rows) or [B] (ragged). The cache updates in place."""
    kv_cache, tok, pos, done = state
    ragged = pos.ndim == 1
    toks = []
    for _ in range(n):
        x = llama.embed(model, tok[:, None])
        if ragged:
            mask = MaskInfo(causal=True, q_positions=pos[:, None], kv_len=pos + 1)
            input_pos = pos[:, None]
        else:
            mask = MaskInfo(causal=True, q_positions=pos[None, None], kv_len=pos[None] + 1)
            input_pos = pos[None]
        h, kv_cache = llama.trunk(model, x, mask, kv_cache, input_pos=input_pos)
        nxt = sample_logits(llama.head(model, h)[:, 0], temperature, top_k, top_p, min_p, generator)
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        done = done | (nxt == eos_id)
        toks.append(nxt)
        tok, pos = nxt, pos + 1
    out = torch.stack(toks, dim=1) if toks else tok.new_zeros((tok.shape[0], 0))
    return out, (kv_cache, tok, pos, done)


@torch.inference_mode()
def generate(model: llama.Llama, prompt: torch.Tensor, *, max_new_tokens: int,
             generator: torch.Generator | None = None, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0,
             cache_dtype=torch.bfloat16, prefix_embeds: torch.Tensor | None = None, prefix_lm: bool = False,
             prompt_lens: torch.Tensor | None = None) -> torch.Tensor:
    """prompt [B, P] -> generated tokens [B, max_new_tokens] (int64).

    ``prompt_lens`` [B] makes the batch RAGGED: rows are right-padded to P, each
    row's first token comes from its own last valid position, and decode proceeds at
    per-row positions, overwriting that row's pad-slot K/V (the per-row kv_len mask
    hides every pad slot not yet overwritten). ``prefix_embeds`` [B, T, D] are
    early-fusion modality tokens put before the prompt."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    first, (kv_cache, tok, pos) = _prefill(
        model, prompt.to(model.device), generator=generator, cache_dtype=cache_dtype,
        prefix_embeds=prefix_embeds, prefix_lm=prefix_lm, prompt_lens=prompt_lens,
        max_new_tokens=max_new_tokens, **sample,
    )
    rest, _ = _decode_steps(model, (kv_cache, tok, pos, first == eos_id), max_new_tokens - 1,
                            generator=generator, eos_id=eos_id, pad_id=pad_id, **sample)
    return torch.cat([first[:, None], rest], dim=1)


@torch.inference_mode()
def prefill_start(model: llama.Llama, prompt: torch.Tensor, *, generator: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                  eos_id: int = -1, cache_dtype=torch.bfloat16, prefix_embeds: torch.Tensor | None = None,
                  prefix_lm: bool = False, prompt_lens: torch.Tensor | None = None, max_new_tokens: int = 0):
    """Prefill + the first token -> (first [B], decode state) for ``decode_chunk``.
    The state is (kv_cache, last token [B], pos, done [B])."""
    first, (kv_cache, tok, pos) = _prefill(
        model, prompt.to(model.device), generator=generator, temperature=temperature, top_k=top_k, top_p=top_p,
        min_p=min_p, cache_dtype=cache_dtype, prefix_embeds=prefix_embeds, prefix_lm=prefix_lm,
        prompt_lens=prompt_lens, max_new_tokens=max_new_tokens,
    )
    return first, (kv_cache, tok, pos, first == eos_id)


@torch.inference_mode()
def decode_chunk(model: llama.Llama, state, n_steps: int, *, generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                 eos_id: int = -1, pad_id: int = 0):
    """Run ``n_steps`` decode steps from ``state`` -> (tokens [B, n_steps], new state).
    The state's cache is updated in place."""
    return _decode_steps(model, state, n_steps, generator=generator, temperature=temperature, top_k=top_k,
                         top_p=top_p, min_p=min_p, eos_id=eos_id, pad_id=pad_id)


def generate_stream(model: llama.Llama, prompt: torch.Tensor, *, max_new_tokens: int, chunk_size: int = 16,
                    generator: torch.Generator | None = None, temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0,
                    cache_dtype=torch.bfloat16, prefix_embeds: torch.Tensor | None = None, prefix_lm: bool = False,
                    prompt_lens: torch.Tensor | None = None):
    """Yield token blocks [B, <= chunk_size] as they decode; stop once every row is
    done. The concatenated blocks equal ``generate`` with the same arguments and
    generator seed up to the step where every row finished."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    first, state = prefill_start(
        model, prompt, generator=generator, eos_id=eos_id, cache_dtype=cache_dtype, prefix_embeds=prefix_embeds,
        prefix_lm=prefix_lm, prompt_lens=prompt_lens, max_new_tokens=max_new_tokens, **sample,
    )
    yield first[:, None]
    at, n_steps = 0, max_new_tokens - 1
    while at < n_steps:
        if bool(state[3].all()):  # every row finished: skip the rest
            return
        n = min(chunk_size, n_steps - at)
        toks, state = decode_chunk(model, state, n, generator=generator, eos_id=eos_id, pad_id=pad_id, **sample)
        yield toks
        at += n
