"""Autoregressive decoding: prefill + KV-cache decode (port of
llama_x_tpu/models/generate.py).

- prefill: the prompt (optionally preceded by modality prefix embeddings, which
  attend bidirectionally with ``prefix_lm``) runs through the trunk once and writes
  K/V into the full-length cache; attention is over the fresh k/v (flash kernel). On the
  card the prefill and the first token are one replay of a graph captured per prompt shape
  (models/decode_graph.py: the prefill runner), as the JAX package jits ``prefill_start``.
- decode: single-token steps over the cache (decode kernel), each step on the card one
  replay of a captured CUDA graph (models/decode_graph.py), as the JAX package compiles
  the loop as one ``lax.scan``. ``eager=True`` launches the prefill and the steps op by op.
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

from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops.attention import MaskInfo


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float = 1.0,
                  min_p: float = 0.0) -> torch.Tensor:
    """Temperature + top-k + min-p + top-p: [..., V] logits -> f32 logits with the
    filtered-out tokens at -inf (softmax of the result is the sampling law).
    Caller guarantees temperature > 0."""
    logits = logits.float() / temperature
    neg_inf = float("-inf")  # a Python scalar: no host-to-device copy (a captured step takes none)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if min_p > 0.0:
        cutoff = logits.amax(dim=-1, keepdim=True) + float(torch.log(torch.tensor(min_p)))
        logits = torch.where(logits < cutoff, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # the nucleus always includes the top token
        cutoff = torch.where(keep, sorted_logits, float("inf"))
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


def _prefill_body(model: llama.Llama, generator, state: dg.DecodeState, inp: dg.PrefillInputs, *, n_prefix: int,
                  prefix_lm: bool, temperature, top_k, top_p, min_p, eos_id) -> None:
    """Prefill + first token over ``inp`` into ``state``, in place (the body a graph
    captures): the prompt's K/V into the cache, the first token sampled at each row's last
    valid position into ``tok``, and ``pos`` and ``done``."""
    B = inp.ids.shape[0]
    x = llama.embed(model, inp.ids)
    if inp.prefix is not None:
        x = torch.cat([inp.prefix, x], dim=1)
    total_p = x.shape[1]
    pos = torch.arange(total_p, dtype=torch.int32, device=x.device)
    prefix = torch.full((B,), n_prefix, dtype=torch.int32, device=x.device) if (prefix_lm and n_prefix) else None
    h, _ = llama.trunk(model, x, MaskInfo(causal=True, prefix_len=prefix), state.cache, input_pos=pos, prefill=True)
    if inp.lens is None:
        h_last = h[:, -1:, :]
        state.pos.fill_(total_p)
    else:
        h_last = h.gather(1, (inp.lens - 1)[:, None, None].expand(B, 1, h.shape[-1]))
        state.pos.copy_(inp.lens)
    first = sample_logits(llama.head(model, h_last)[:, 0], temperature, top_k, top_p, min_p, generator)
    state.tok.copy_(first)
    state.done.copy_(first == eos_id)


def _prefill(model: llama.Llama, prompt: torch.Tensor, *, generator, temperature, top_k, top_p, min_p, eos_id,
             cache_dtype, prefix_embeds, prefix_lm, prompt_lens, max_new_tokens: int, eager: bool):
    """Prefill + first token -> (first [B], decode state). The prompt's K/V go into the
    runner's buffer set for this batch shape (``eager``: into fresh buffers), written in
    place; every position a later step reads is written by this request first, so what
    the set held before is never read. On the card the prefill is one replay of the graph
    of its key (the prompt shape, the prefix length, ragged or not, the cache type,
    ``prefix_lm`` and the static sampling arguments) over the key's input buffers, into
    which the request's tensors are copied; ``eager``: launched op by op over them."""
    config = model.config
    B, P = prompt.shape
    ragged = prompt_lens is not None
    if not eager:
        dg.refuse_mesh(model, "generate step")
    n_prefix = 0
    if prefix_embeds is not None:
        if ragged:
            raise ValueError("ragged prompts and modality prefixes do not combine")
        n_prefix = prefix_embeds.shape[1]
    total_p = n_prefix + P
    if total_p + max_new_tokens > config.max_seq_len:
        raise ValueError(f"prefill {total_p} + {max_new_tokens} new tokens exceed max_seq_len {config.max_seq_len}")
    lens = None if not ragged else prompt_lens.to(device=model.device, dtype=torch.long).reshape(-1).expand(B)
    body = dict(n_prefix=n_prefix, prefix_lm=prefix_lm, eos_id=eos_id, temperature=temperature, top_k=top_k,
                top_p=top_p, min_p=min_p)
    name = "generate prefill"
    if eager:
        state = dg.new_state(model, B, ragged, cache_dtype)
        prefix = None if prefix_embeds is None else prefix_embeds.to(device=model.device,
                                                                     dtype=model.tok_embeddings.dtype)
        inp = dg.PrefillInputs(prompt, prefix, lens)
    else:
        state = dg.lease(model, (B, ragged, cache_dtype), lambda: dg.new_state(model, B, ragged, cache_dtype))
        inp = dg.prefill_inputs(model, (name, B, P, n_prefix, ragged), prompt, prefix_embeds, lens)
    dg.run(model, name, (*state.buffers(), *inp.buffers()), (P, ragged, cache_dtype, *body.values()),
           lambda m, gen: _prefill_body(m, gen, state, inp, **body), 1, generator, eager=eager,
           draws=temperature > 0.0, runner=dg.prefill_runner_of(model))
    return state.tok.clone(), state


def _step(model: llama.Llama, s: dg.DecodeState, generator, *, temperature, top_k, top_p, min_p, eos_id, pad_id):
    """One decode step over ``s``'s buffers, in place (the body a graph captures): the
    token at each row's position, its K/V into the cache, the next token sampled (pad_id
    once a row is done) into the ring at ``s.at``; tok, pos and done move on."""
    x = llama.embed(model, s.tok[:, None])
    if s.pos.ndim == 1:
        mask = MaskInfo(causal=True, q_positions=s.pos[:, None], kv_len=s.pos + 1)
        input_pos = s.pos[:, None]
    else:
        mask = MaskInfo(causal=True, q_positions=s.pos[None, None], kv_len=s.pos[None] + 1)
        input_pos = s.pos[None]
    h, _ = llama.trunk(model, x, mask, s.cache, input_pos=input_pos)
    nxt = sample_logits(llama.head(model, h)[:, 0], temperature, top_k, top_p, min_p, generator)
    nxt = torch.where(s.done, pad_id, nxt)
    s.done |= nxt == eos_id
    s.ring.index_copy_(1, s.at, nxt[:, None])
    s.at += 1
    s.tok.copy_(nxt)
    s.pos += 1


@torch.inference_mode()
def generate(model: llama.Llama, prompt: torch.Tensor, *, max_new_tokens: int,
             generator: torch.Generator | None = None, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0,
             cache_dtype=torch.bfloat16, prefix_embeds: torch.Tensor | None = None, prefix_lm: bool = False,
             prompt_lens: torch.Tensor | None = None, eager: bool = False) -> torch.Tensor:
    """prompt [B, P] -> generated tokens [B, max_new_tokens] (int64).

    ``prompt_lens`` [B] makes the batch RAGGED: rows are right-padded to P, each
    row's first token comes from its own last valid position, and decode proceeds at
    per-row positions, overwriting that row's pad-slot K/V (the per-row kv_len mask
    hides every pad slot not yet overwritten). ``prefix_embeds`` [B, T, D] are
    early-fusion modality tokens put before the prompt. ``eager``: the prefill and the
    decode steps launched op by op over fresh buffers instead of replayed from captured
    graphs."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    first, state = prefill_start(model, prompt, generator=generator, eos_id=eos_id, cache_dtype=cache_dtype,
                                 prefix_embeds=prefix_embeds, prefix_lm=prefix_lm, prompt_lens=prompt_lens,
                                 max_new_tokens=max_new_tokens, eager=eager, **sample)
    rest, _ = decode_chunk(model, state, max_new_tokens - 1, generator=generator, eos_id=eos_id, pad_id=pad_id,
                           eager=eager, **sample)
    return torch.cat([first[:, None], rest], dim=1)


@torch.inference_mode()
def prefill_start(model: llama.Llama, prompt: torch.Tensor, *, generator: torch.Generator | None = None,
                  temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
                  eos_id: int = -1, cache_dtype=torch.bfloat16, prefix_embeds: torch.Tensor | None = None,
                  prefix_lm: bool = False, prompt_lens: torch.Tensor | None = None, max_new_tokens: int = 0,
                  eager: bool = False):
    """Prefill + the first token -> (first [B], ``DecodeState``) for ``decode_chunk``. The
    state lives in the runner's buffers for this batch shape and cache type, which the
    next ``prefill_start`` of the same shape on the model reuses (the older state then
    refuses to decode). On the card the prefill replays the graph of its prompt shape
    (captured on the key's first call); ``eager``: launched op by op, in buffers of its
    own."""
    return _prefill(model, prompt.to(model.device), generator=generator, temperature=temperature, top_k=top_k,
                    top_p=top_p, min_p=min_p, eos_id=eos_id, cache_dtype=cache_dtype, prefix_embeds=prefix_embeds,
                    prefix_lm=prefix_lm, prompt_lens=prompt_lens, max_new_tokens=max_new_tokens, eager=eager)


@torch.inference_mode()
def decode_chunk(model: llama.Llama, state: dg.DecodeState, n_steps: int, *,
                 generator: torch.Generator | None = None, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0, eager: bool = False):
    """Run ``n_steps`` decode steps from ``state`` -> (tokens [B, n_steps], state). On the
    card each step is one replay of the step's captured graph (captured on the first call
    of these buffers and static arguments); ``eager``: the step launched op by op. The
    state is updated in place."""
    if state.slot is not None and state.lease != state.slot.lease:
        raise RuntimeError("decode_chunk: this state was superseded by a later prefill_start of the same batch "
                           "shape and cache type on this model (they share the graph's buffers); finish one "
                           "decode before starting the next, or start them with eager=True")
    if n_steps > state.ring.shape[1]:
        raise ValueError(f"{n_steps} steps exceed the model's {state.ring.shape[1]} positions")
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p, eos_id=eos_id, pad_id=pad_id)
    state.at.zero_()
    dg.run(model, "generate step", state.buffers(), tuple(sample.values()),
           lambda m, gen: _step(m, state, gen, **sample), n_steps, generator, eager=eager, draws=temperature > 0.0)
    return state.ring[:, :n_steps].clone(), state


def generate_stream(model: llama.Llama, prompt: torch.Tensor, *, max_new_tokens: int, chunk_size: int = 16,
                    generator: torch.Generator | None = None, temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0,
                    cache_dtype=torch.bfloat16, prefix_embeds: torch.Tensor | None = None, prefix_lm: bool = False,
                    prompt_lens: torch.Tensor | None = None, eager: bool = False):
    """Yield token blocks [B, <= chunk_size] as they decode; stop once every row is
    done. The concatenated blocks equal ``generate`` with the same arguments and
    generator seed up to the step where every row finished."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    first, state = prefill_start(
        model, prompt, generator=generator, eos_id=eos_id, cache_dtype=cache_dtype, prefix_embeds=prefix_embeds,
        prefix_lm=prefix_lm, prompt_lens=prompt_lens, max_new_tokens=max_new_tokens, eager=eager, **sample,
    )
    yield first[:, None]
    at, n_steps = 0, max_new_tokens - 1
    while at < n_steps:
        if bool(state.done.all()):  # every row finished: skip the rest
            return
        n = min(chunk_size, n_steps - at)
        toks, state = decode_chunk(model, state, n, generator=generator, eos_id=eos_id, pad_id=pad_id, eager=eager,
                                   **sample)
        yield toks
        at += n
