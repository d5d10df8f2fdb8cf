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
the verify through the flash kernel's offsets form from gamma 8. Rows accept at their own
rate, so positions are per row; finished rows freeze (m = 0). The loop of rounds is a
Python loop that reads one flag back per round (any row still running); the JAX package
compiles it as one ``while_loop``. Random draws come from a ``torch.Generator``: the law is
the JAX package's, the bits are not.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.generate import filter_logits, gumbel_argmax, sample_logits
from llama_x_tpu_torch.ops.attention import MaskInfo


def _prefill(model: llama.Llama, prompt: torch.Tensor, cache_dtype, prompt_lens=None):
    """The prompt through the trunk once, filling a fresh cache -> (cache, logits at each
    row's last valid position [B, V], per-row position [B]). Ragged rows (``prompt_lens``)
    are right-padded to P; their pad K/V stay hidden behind each row's kv_len until
    overwritten (the ragged ``generate``'s argument)."""
    B, P = prompt.shape
    cache = llama.init_kv_cache(model.config, B, dtype=cache_dtype, device=model.device,
                               kv_heads=llama.local_kv_heads(model))
    x = llama.embed(model, prompt)
    h, cache = llama.trunk(model, x, MaskInfo(causal=True), cache, input_pos=torch.arange(P, device=model.device),
                           prefill=True)
    if prompt_lens is None:
        h_last = h[:, -1:]
        row_pos = torch.full((B,), P, dtype=torch.long, device=model.device)
    else:
        row_pos = prompt_lens.to(device=model.device, dtype=torch.long).reshape(-1).expand(B)
        h_last = h.gather(1, (row_pos - 1)[:, None, None].expand(B, 1, h.shape[-1]))
    return cache, llama.head(model, h_last)[:, 0], row_pos


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


def _target_verify(model: llama.Llama, cache, cur, drafts, pos, gamma: int):
    """One target pass over [cur, d_1..d_gamma] at per-row positions pos..pos + gamma ->
    logits [B, gamma + 1, V]: logits[:, i] scores the token AFTER input i (the last is the
    bonus position of a full accept). The cache updates in place."""
    inputs = torch.cat([cur[:, None], drafts], dim=1)
    x = llama.embed(model, inputs)
    qpos = pos[:, None] + torch.arange(gamma + 1, device=pos.device)[None, :]
    h, _ = llama.trunk(model, x, MaskInfo(causal=True, q_positions=qpos, kv_len=pos + gamma + 1), cache,
                       input_pos=qpos)
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


@torch.inference_mode()
def generate_speculative(model: llama.Llama, draft_model: llama.Llama, prompt: torch.Tensor, *, max_new_tokens: int,
                         gamma: int = 4, generator: torch.Generator | None = None, temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0, eos_id: int = -1, pad_id: int = 0,
                         cache_dtype=torch.bfloat16, prompt_lens: torch.Tensor | None = None):
    """prompt [B, P] -> (tokens [B, max_new_tokens] int64, stats). ``prompt_lens`` [B]
    makes the rows ragged (right-padded to P).

    temperature 0: the target's own greedy trajectory, token for token ``generate``'s in
    fp32 (in bf16 a near-tie can go the other way: the verify pass sums in another order
    than a one-token step). temperature > 0: rejection sampling, distributed as the
    target's ancestral sampling. The draft must share the target's vocabulary. stats:
    ``target_passes`` (prefill + verify passes) and ``tokens_emitted`` [B]."""
    config, dconfig = model.config, draft_model.config
    B, P = prompt.shape
    if config.vocab_size != draft_model.config.vocab_size:
        raise ValueError("the draft must share the target's vocabulary")
    if P + max_new_tokens + gamma + 1 > config.max_seq_len or P + max_new_tokens + gamma > dconfig.max_seq_len:
        raise ValueError(f"prompt {P} + {max_new_tokens} new tokens + gamma {gamma} exceed a cache")
    dev = model.device
    prompt = prompt.to(dev)
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p)
    t_cache, first_logits, pos = _prefill(model, prompt, cache_dtype, prompt_lens)
    d_cache, _, _ = _prefill(draft_model, prompt, cache_dtype, prompt_lens)
    first = sample_logits(first_logits, generator=generator, **sample)

    buf = torch.full((B, max_new_tokens + gamma + 1), pad_id, dtype=torch.long, device=dev)
    buf[:, 0] = first
    prev = prompt[:, -1] if prompt_lens is None else prompt.gather(1, (pos - 1)[:, None])[:, 0]
    cur = first
    n_out = torch.ones(B, dtype=torch.long, device=dev)
    done = first == eos_id
    idx = torch.arange(gamma + 1, device=dev)[None, :]
    rounds = 0
    while bool(((n_out < max_new_tokens) & ~done).any()):
        drafts, q_probs = _draft_propose(draft_model, d_cache, prev, cur, pos, gamma, generator, **sample)
        t_logits = _target_verify(model, t_cache, cur, drafts, pos, gamma)
        if temperature == 0.0:
            targets = t_logits.float().argmax(dim=-1)  # [B, gamma + 1]
            match = torch.cat([drafts == targets[:, :gamma], torch.zeros_like(drafts[:, :1], dtype=torch.bool)], 1)
            emitted, m = targets, match.int().argmin(dim=1) + 1
        else:
            p_probs = torch.softmax(filter_logits(t_logits, temperature, top_k, top_p, min_p), dim=-1)
            emitted, m = speculative_accept(drafts, q_probs, p_probs, generator)
        # rows finished by count or eos freeze: emit nothing, positions stay put
        m = torch.where((n_out < max_new_tokens) & ~done, m, torch.zeros_like(m))
        emitted = torch.where(idx < m[:, None], emitted, torch.full_like(emitted, pad_id))
        hit_eos = torch.zeros_like(done)
        if eos_id >= 0:
            live = (emitted == eos_id) & (idx < m[:, None])
            hit_eos = live.any(dim=1)
            m = torch.where(hit_eos, torch.minimum(m, live.int().argmax(dim=1) + 1), m)
            emitted = torch.where(idx < m[:, None], emitted, torch.full_like(emitted, pad_id))
        buf.scatter_(1, n_out[:, None] + idx, emitted)
        # the new (prev, cur) are the last two tokens of the sequence (frozen rows: both stay cur)
        padded = torch.cat([cur[:, None], emitted], dim=1)
        prev = padded.gather(1, torch.clamp(m - 1, min=0)[:, None])[:, 0]
        cur = padded.gather(1, m[:, None])[:, 0]
        pos, n_out, done = pos + m, n_out + m, done | hit_eos
        rounds += 1

    out = buf[:, :max_new_tokens]
    if eos_id >= 0:  # pad everything after the first eos
        is_eos = (out == eos_id).long()
        out = torch.where(torch.cumsum(is_eos, dim=-1) - is_eos > 0, torch.full_like(out, pad_id), out)
    out = torch.where(torch.arange(max_new_tokens, device=dev)[None, :] >= n_out[:, None],
                      torch.full_like(out, pad_id), out)
    return out, {"target_passes": rounds + 1, "tokens_emitted": torch.clamp(n_out, max=max_new_tokens)}
