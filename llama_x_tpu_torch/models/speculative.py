"""Speculative decoding: draft-propose / target-verify generation (port of
llama_x_tpu/models/speculative.py).

Decode at small batch reads every target weight once a token. A cheap draft model
proposes ``gamma`` tokens one by one; the target scores all of them in ONE pass (gamma + 1
query positions over its cache, the same mask as a decode step with Sq > 1), so accepted
tokens share one read of the target's weights.

Greedy (temperature 0): accept the longest prefix with d_i == argmax of the target; the
first mismatch (or the bonus position after a full accept) emits the target's own token,
so a round emits a + 1 in [1, gamma + 1] tokens, all equal to the target's greedy decode.

Sampled (temperature > 0): rejection sampling. Draft token x_i ~ q_i is accepted with
probability min(1, p_i(x_i) / q_i(x_i)); the first rejection resamples from norm(max(p_a -
q_a, 0)); a full accept samples the bonus token from p_gamma. p and q are the filtered
distributions (``generate.filter_logits`` with the same temperature / top-k / top-p on
both models), so the emitted tokens are distributed as the target's ancestral sampling.

Cache rollback is free: rejected positions' K/V stay in the static cache, kv_len hides
them, and the next round overwrites them. The verify pass (Sq = gamma + 1) and the
draft's pair step (Sq = 2) read the cache through the decode kernel up to gamma 7, and
the verify through the flash kernel's offsets form from gamma 8, over a static bound on
kv_len (``verify_bound``), so that nothing is read back inside a round. Rows accept at their
own rate, so positions are per row; a row's emission is capped at its count, and finished
rows freeze (m = 0).

The JAX package compiles the prefills and the loop of rounds as one call (the rounds one
``while_loop``). Here the prefills with the first token, and each round, read and write only
static buffers (``SpecState``, the prompt's ``PrefillInputs``), and on the card each is one
replay of its captured CUDA graph (models/decode_graph.py). The host reads the rows' counts back once per
block of rounds: the fewest rounds that the live row nearest its count still needs.
``eager=True`` launches the same round op by op. Random draws come from a
``torch.Generator``: the law is the JAX package's, the bits are not.
"""

from __future__ import annotations

import dataclasses

import torch

from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.generate import filter_logits, gumbel_argmax, sample_logits
from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops.attention import MaskInfo


KV_BUCKET = 512  # positions: the verify's static kv bound is rounded up to a multiple


def verify_bound(config: llama.LlamaConfig, need: int, cache_dtype, gamma: int) -> int:
    """The verify's static kv bound over the target's cache (``llama.trunk``'s ``kv_bound``):
    ``need``, at least every row's kv_len in the verify, rounded up to ``KV_BUCKET`` and
    capped at max_seq_len where it sizes something (the int8 cache's dequantized prefix in
    the offsets form, gamma + 1 > MAX_SQ); max_seq_len where nothing reads it (a bf16 cache,
    a verify through the decode kernel), so that it splits no key."""
    S = config.max_seq_len
    if cache_dtype != torch.int8 or gamma + 1 <= da.MAX_SQ:
        return S
    return min(S, -(-need // KV_BUCKET) * KV_BUCKET)


@dataclasses.dataclass(eq=False)
class SpecState:
    """``generate_speculative``'s static buffers, each written in place (the JAX package's
    ``while_loop`` carry): the target's and the draft's caches, the output buffer [B, S_max]
    with each row's count ``n_out`` [B], ``done`` [B], the last two tokens ``prev`` / ``cur``
    [B], the position ``pos`` [B] (both caches hold [0, pos)), the count ``limit`` (0-d,
    max_new_tokens) and ``rounds`` (0-d), the rounds that started with a live row.
    ``slot`` / ``lease``: as ``decode_graph.DecodeState``'s."""

    t_cache: tuple
    d_cache: tuple
    buf: torch.Tensor
    n_out: torch.Tensor
    done: torch.Tensor
    prev: torch.Tensor
    cur: torch.Tensor
    pos: torch.Tensor
    limit: torch.Tensor
    rounds: torch.Tensor
    slot: SpecState | None = None
    lease: int = 0

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return (*dg.cache_tensors(self.t_cache), *dg.cache_tensors(self.d_cache), self.buf, self.n_out, self.done,
                self.prev, self.cur, self.pos, self.limit, self.rounds)


def new_spec_state(model: llama.Llama, draft_model: llama.Llama, batch: int, cache_dtype) -> SpecState:
    """Fresh buffers for ``batch`` rows on the model's device."""
    dev = model.device
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=dev)  # noqa: E731
    caches = [llama.init_kv_cache(m.config, batch, dtype=cache_dtype, device=dev, kv_heads=llama.local_kv_heads(m))
              for m in (model, draft_model)]
    return SpecState(*caches, zeros(batch, model.config.max_seq_len), zeros(batch),
                     torch.zeros(batch, dtype=torch.bool, device=dev), zeros(batch), zeros(batch), zeros(batch),
                     zeros(), zeros())


def _prefill(model: llama.Llama, prompt: torch.Tensor, cache, prompt_lens=None):
    """The prompt through the trunk once, writing ``cache`` in place -> (logits at each row's
    last valid position [B, V], per-row position [B]). Ragged rows (``prompt_lens``) are
    right-padded to P; their pad K/V stay hidden behind each row's kv_len until overwritten
    (the ragged ``generate``'s argument), as does what the cache held past P."""
    B, P = prompt.shape
    x = llama.embed(model, prompt)
    h, _ = llama.trunk(model, x, MaskInfo(causal=True), cache, input_pos=torch.arange(P, device=model.device),
                       prefill=True)
    if prompt_lens is None:
        h_last = h[:, -1:]
        row_pos = torch.full((B,), P, dtype=torch.long, device=model.device)
    else:
        row_pos = prompt_lens.to(device=model.device, dtype=torch.long).reshape(-1).expand(B)
        h_last = h.gather(1, (row_pos - 1)[:, None, None].expand(B, 1, h.shape[-1]))
    return llama.head(model, h_last)[:, 0], row_pos


def _start(model: llama.Llama, draft_model: llama.Llama, s: SpecState, inp: dg.PrefillInputs, generator, *,
           temperature, top_k, top_p, min_p, eos_id: int, pad_id: int) -> None:
    """Both prefills of ``inp``'s prompt, the first token and the fill of ``s`` for the first
    round, in place (the body a graph captures): the output buffer holds the first token and
    pad, (prev, cur) the last prompt token and the first token, pos each row's length."""
    first_logits, pos = _prefill(model, inp.ids, s.t_cache, inp.lens)
    _prefill(draft_model, inp.ids, s.d_cache, inp.lens)
    first = sample_logits(first_logits, temperature, top_k, top_p, min_p, generator)
    s.buf.fill_(pad_id)
    s.buf[:, 0] = first
    s.prev.copy_(inp.ids[:, -1] if inp.lens is None else inp.ids.gather(1, (pos - 1)[:, None])[:, 0])
    s.cur.copy_(first)
    s.pos.copy_(pos)
    s.n_out.fill_(1)
    s.done.copy_(first == eos_id)


def _draft_sample(logits, temperature, top_k, top_p, min_p, generator):
    """One draft token per row -> (tokens [B], q rows [B, V] or None when greedy)."""
    if temperature == 0.0:
        return logits.float().argmax(dim=-1), None
    f = filter_logits(logits, temperature, top_k, top_p, min_p)
    return gumbel_argmax(f, generator), torch.softmax(f, dim=-1)


def _draft_propose(model: llama.Llama, cache, prev, cur, pos, gamma: int, generator, temperature, top_k, top_p,
                   min_p):
    """gamma draft steps from per-row prev / cur / pos [B] -> (drafts [B, gamma], q_probs
    [B, gamma, V] or None when greedy). The cache updates in place.

    The FIRST step feeds [prev, cur] at positions pos - 1 and pos: after a full accept the
    draft cache has a hole at pos - 1 (the last draft token was sampled, never run, and the
    bonus token followed it); re-running prev fills it, and elsewhere rewrites the same
    K/V."""
    pair = torch.stack([prev, cur], dim=1)
    x = llama.embed(model, pair)
    ppos = pos[:, None] + torch.arange(-1, 1, device=pos.device)[None, :]
    h, _ = llama.trunk(model, x, MaskInfo(causal=True, q_positions=ppos, kv_len=pos + 1), cache, input_pos=ppos)
    tok, q = _draft_sample(llama.head(model, h[:, -1:])[:, 0], temperature, top_k, top_p, min_p, generator)
    drafts, qs, p = [tok], [q], pos + 1
    for _ in range(gamma - 1):
        x = llama.embed(model, tok[:, None])
        h, _ = llama.trunk(model, x, MaskInfo(causal=True, q_positions=p[:, None], kv_len=p + 1), cache,
                           input_pos=p[:, None])
        tok, q = _draft_sample(llama.head(model, h)[:, 0], temperature, top_k, top_p, min_p, generator)
        drafts.append(tok)
        qs.append(q)
        p = p + 1
    return torch.stack(drafts, dim=1), (None if qs[0] is None else torch.stack(qs, dim=1))


def _target_verify(model: llama.Llama, cache, cur, drafts, pos, gamma: int, kv_bound: int):
    """One target pass over [cur, d_1..d_gamma] at per-row positions pos..pos + gamma ->
    logits [B, gamma + 1, V]: logits[:, i] scores the token AFTER input i (the last is the
    bonus position of a full accept). The cache updates in place. The query positions are
    contiguous by construction and every kv_len (pos + gamma + 1) is at most ``kv_bound``
    (``verify_bound``): the trunk reads nothing back."""
    inputs = torch.cat([cur[:, None], drafts], dim=1)
    x = llama.embed(model, inputs)
    qpos = pos[:, None] + torch.arange(gamma + 1, device=pos.device)[None, :]
    h, _ = llama.trunk(model, x, MaskInfo(causal=True, q_positions=qpos, kv_len=pos + gamma + 1), cache,
                       input_pos=qpos, kv_bound=kv_bound)
    return llama.head(model, h)


def speculative_accept(drafts: torch.Tensor, q_probs: torch.Tensor, p_probs: torch.Tensor,
                       generator: torch.Generator | None = None):
    """The rejection-sampling step (Leviathan et al.; Chen et al.): drafts [..., gamma]
    drawn from the q rows [..., gamma, V], the target's rows p [..., gamma + 1, V] (the last
    is the bonus position) -> (emitted [..., gamma + 1], m [...]), m in [1, gamma + 1] valid
    tokens whose law is the target's ancestral sampling. Draft i is accepted iff u_i q_i(d_i)
    < p_i(d_i), u_i uniform on [0, 1); at the first rejection a the token is drawn from
    norm(max(p_a - q_a, 0)), and after a full accept from p_gamma. Leading axes are rows."""
    lead = drafts.shape[:-1]
    gamma = drafts.shape[-1]
    V = p_probs.shape[-1]
    d = drafts.reshape(-1, gamma)
    q = q_probs.reshape(-1, gamma, V).float()
    p = p_probs.reshape(-1, gamma + 1, V).float()
    B = d.shape[0]
    p_sel = p[:, :gamma].gather(2, d[..., None])[..., 0]
    q_sel = q.gather(2, d[..., None])[..., 0]
    u = torch.rand((B, gamma), generator=generator, device=d.device, dtype=torch.float32)
    accept = u * q_sel < p_sel  # u < p / q without the 0 / 0 hazard (q > 0 at a sampled token)
    a = torch.cat([accept, accept.new_zeros(B, 1)], dim=1).int().argmin(dim=1)  # the first rejection, or gamma
    q_pad = torch.cat([q, q.new_zeros(B, 1, V)], dim=1)  # a full accept: the residual IS p_gamma
    at = a[:, None, None].expand(B, 1, V)
    residual = torch.clamp(p.gather(1, at)[:, 0] - q_pad.gather(1, at)[:, 0], min=0.0)
    correction = gumbel_argmax(torch.log(residual), generator)
    idx = torch.arange(gamma + 1, device=d.device)[None, :]
    emitted = torch.where(idx < a[:, None], torch.cat([d, d.new_zeros(B, 1)], dim=1),
                          torch.where(idx == a[:, None], correction[:, None], torch.zeros_like(idx)))
    return emitted.reshape(*lead, gamma + 1), (a + 1).reshape(lead)


def _round(model: llama.Llama, draft_model: llama.Llama, s: SpecState, generator, *, gamma: int, kv_bound: int,
           temperature, top_k, top_p, min_p, eos_id: int, pad_id: int) -> None:
    """One round over ``s``'s buffers, in place (the body a graph captures): gamma draft
    steps, one verify pass, the acceptance; each live row emits m tokens into ``buf`` at
    ``n_out``, capped at its count (``limit - n_out``), and rows finished by count or eos
    freeze (m = 0: prev, cur and pos held; their draft and verify writes stay inside
    P + max_new_tokens + gamma, which the entry check bounds). A round that starts with no
    live row changes nothing the output reads and counts no round."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    live = (s.n_out < s.limit) & ~s.done
    s.rounds += live.any()
    drafts, q_probs = _draft_propose(draft_model, s.d_cache, s.prev, s.cur, s.pos, gamma, generator, **sample)
    t_logits = _target_verify(model, s.t_cache, s.cur, drafts, s.pos, gamma, kv_bound)
    if temperature == 0.0:
        targets = t_logits.float().argmax(dim=-1)  # [B, gamma + 1]
        match = torch.cat([drafts == targets[:, :gamma], torch.zeros_like(drafts[:, :1], dtype=torch.bool)], 1)
        emitted, m = targets, match.int().argmin(dim=1) + 1
    else:
        p_probs = torch.softmax(filter_logits(t_logits, temperature, top_k, top_p, min_p), dim=-1)
        emitted, m = speculative_accept(drafts, q_probs, p_probs, generator)
    idx = torch.arange(gamma + 1, device=m.device)[None, :]
    m = torch.where(live, torch.minimum(m, s.limit - s.n_out), torch.zeros_like(m))
    emitted = torch.where(idx < m[:, None], emitted, torch.full_like(emitted, pad_id))
    hit_eos = torch.zeros_like(s.done)
    if eos_id >= 0:
        live_eos = (emitted == eos_id) & (idx < m[:, None])
        hit_eos = live_eos.any(dim=1)
        m = torch.where(hit_eos, torch.minimum(m, live_eos.int().argmax(dim=1) + 1), m)
        emitted = torch.where(idx < m[:, None], emitted, torch.full_like(emitted, pad_id))
    s.buf.scatter_(1, s.n_out[:, None] + idx, emitted)
    # the new (prev, cur) are the last two tokens of the sequence (frozen rows: both stay cur)
    padded = torch.cat([s.cur[:, None], emitted], dim=1)
    s.prev.copy_(padded.gather(1, torch.clamp(m - 1, min=0)[:, None])[:, 0])
    s.cur.copy_(padded.gather(1, m[:, None])[:, 0])
    s.pos += m
    s.n_out += m
    s.done |= hit_eos


def _blocks(s: SpecState, gamma: int, max_new_tokens: int):
    """The rounds to run before the next look, one read back a block: the fewest rounds that
    the live row nearest its count still needs (a round emits at most gamma + 1 tokens a
    row), at least 1; none once no row is live."""
    while True:
        n_out, done = torch.stack([s.n_out, s.done.long()]).tolist()
        left = [max_new_tokens - n for n, d in zip(n_out, done) if not d and n < max_new_tokens]
        if not left:
            return
        yield -(-min(left) // (gamma + 1))


@torch.inference_mode()
def generate_speculative(model: llama.Llama, draft_model: llama.Llama, prompt: torch.Tensor, *, max_new_tokens: int,
                         gamma: int = 4, generator: torch.Generator | None = None, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0,
                         cache_dtype=torch.bfloat16, prompt_lens: torch.Tensor | None = None, eager: bool = False):
    """prompt [B, P] -> (tokens [B, max_new_tokens] int64, stats). ``prompt_lens`` [B]
    makes the rows ragged (right-padded to P).

    temperature 0: the target's own greedy trajectory, token for token ``generate``'s in
    fp32 (in bf16 a near-tie can go the other way: the verify pass sums in another order
    than a one-token step). temperature > 0: rejection sampling, distributed as the
    target's ancestral sampling. The draft must share the target's vocabulary. stats:
    ``target_passes`` (prefill + verify passes) and ``tokens_emitted`` [B].

    On the card both prefills and the first token are one replay of a graph captured per
    prompt shape (the model's prefill runner), and each round one replay of the round's
    captured graph, over a buffer set the runner keeps for (B, cache type, the draft's
    config); ``eager``: the prefills and the rounds launched op by op, in buffers of their
    own. A model on a mesh needs ``eager``."""
    config, dconfig = model.config, draft_model.config
    B, P = prompt.shape
    if config.vocab_size != draft_model.config.vocab_size:
        raise ValueError("the draft must share the target's vocabulary")
    if P + max_new_tokens + gamma + 1 > config.max_seq_len or P + max_new_tokens + gamma > dconfig.max_seq_len:
        raise ValueError(f"prompt {P} + {max_new_tokens} new tokens + gamma {gamma} exceed a cache")
    name = "generate_speculative round"
    if not eager:
        for m in (model, draft_model):
            dg.refuse_mesh(m, name)
    dev = model.device
    prompt = prompt.to(dev)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    make = lambda: new_spec_state(model, draft_model, B, cache_dtype)  # noqa: E731
    lens = None if prompt_lens is None else prompt_lens.to(device=dev, dtype=torch.long).reshape(-1).expand(B)
    prefill = "generate_speculative prefill"
    if eager:
        s, inp = make(), dg.PrefillInputs(prompt, None, lens)
    else:
        s = dg.lease(model, ("speculative", B, cache_dtype, dconfig), make)
        inp = dg.prefill_inputs(model, (prefill, B, P, lens is not None), prompt, None, lens, others=(draft_model,))
    dg.run(model, prefill, (*s.buffers(), *inp.buffers()), (P, lens is not None, eos_id, pad_id, *sample.values()),
           lambda m, gen: _start(m, draft_model, s, inp, gen, eos_id=eos_id, pad_id=pad_id, **sample), 1, generator,
           eager=eager, draws=temperature > 0.0, others=(draft_model,), runner=dg.prefill_runner_of(model))
    s.limit.fill_(max_new_tokens)
    s.rounds.zero_()
    kv_bound = verify_bound(config, P + max_new_tokens + gamma, cache_dtype, gamma)
    key = (gamma, kv_bound, eos_id, pad_id, *sample.values())
    for n in _blocks(s, gamma, max_new_tokens):
        if s.slot is not None and s.lease != s.slot.lease:
            raise RuntimeError("generate_speculative: a later call took this buffer set mid-request")
        dg.run(model, name, s.buffers(), key,
               lambda m, gen: _round(m, draft_model, s, gen, gamma=gamma, kv_bound=kv_bound, eos_id=eos_id,
                                     pad_id=pad_id, **sample),
               n, generator, eager=eager, draws=temperature > 0.0, others=(draft_model,))

    out = s.buf[:, :max_new_tokens]
    if eos_id >= 0:  # pad everything after the first eos
        is_eos = (out == eos_id).long()
        out = torch.where(torch.cumsum(is_eos, dim=-1) - is_eos > 0, torch.full_like(out, pad_id), out)
    out = torch.where(torch.arange(max_new_tokens, device=dev)[None, :] >= s.n_out[:, None],
                      torch.full_like(out, pad_id), out)
    return out, {"target_passes": int(s.rounds) + 1, "tokens_emitted": torch.clamp(s.n_out, max=max_new_tokens)}
