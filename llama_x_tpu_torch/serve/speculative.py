"""Speculative continuous batching: draft-propose / target-verify rounds over the
persistent slot batch (port of llama_x_tpu/serve/speculative.py).

models/speculative.py runs the round for one request batch; here the round is the
continuous scheduler's chunk step, so requests join and leave at round boundaries, every
per-request quantity (sampling parameters, stop token, budget) is an [n_slots] tensor, and
each slot's acceptance advances its own position.

A temperature-0 row accepts the longest draft prefix that matches the target's argmax and
emits the target's own greedy tokens: its output is the target's greedy trajectory
whatever shares the batch. A sampled row runs the rejection step on its own filtered
distributions (``filter_logits_rows``). Both kinds share one round: the round computes both
laws and picks per row. Frozen and empty slots ride along with m = 0: their draft and
verify writes land at held positions that their kv_len never exposes.

The verify pass is gamma + 1 query rows over the target's slot cache: through the decode
kernel up to gamma 7, through the flash kernel's offsets form (per-row offsets over the
slots) from gamma 8, over a static bound on kv_len that the scheduler keeps on the host
(``SpeculativeScheduler._kv_bound``), so that nothing is read back inside a round.

A round reads and writes only static buffers, in place: the state (both caches, prev, cur,
pos, done, emitted, the chunk's token ring and each row's cursor in it), the six per-row
tensors and the live-round count. The JAX package jits ``spec_chunk`` as a ``lax.scan`` over
rounds; here on the card a chunk is ``n_rounds`` replays of the round's captured CUDA graph
(models/decode_graph.py), and ``eager=True`` launches the same round op by op. Admission (two
prefills of the prompt padded to its bucket, into the working rows of ``AdmitBuffers``) is
one replay of its graph per bucket as well (serve/continuous.py), ``eager=True`` op by op.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.decode_graph import cache_tensors
from llama_x_tpu_torch.models.generate import gumbel_argmax
from llama_x_tpu_torch.models.speculative import speculative_accept, verify_bound
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.serve.continuous import (
    AdmitBuffers,
    ContinuousScheduler,
    RowHandle,
    activate,
    filter_logits_rows,
    lane_copy,
    prefill_rows,
    prompt_bucket,
    run_admission,
    sample_at,
)
from llama_x_tpu_torch.utils import spans
from llama_x_tpu_torch.utils.device import resolve_device

# state: (t_cache, d_cache, prev [N], cur [N], pos [N], done [N] bool, emitted [N], ring [N, W],
# cursor [N]); prev and cur are the last two tokens of each row (the draft's pair step
# re-feeds prev), pos the depth that the target's and the draft's caches both hold; ring holds
# a chunk's tokens, each row's at its own cursor. All int64 but done: the static buffers of
# the captured round, written in place


def init_spec_state(config: llama.LlamaConfig, draft_config: llama.LlamaConfig, n_slots: int,
                    cache_dtype=torch.bfloat16, device=None, kv_heads=(None, None), width: int | None = None):
    """``kv_heads``: the target's and the draft's local kv heads under tensor parallelism.
    ``width``: the ring's, at least a chunk's rounds times gamma + 1 (default max_seq_len)."""
    dev = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape or (n_slots,), dtype=torch.int64, device=dev)  # noqa: E731
    return (llama.init_kv_cache(config, n_slots, dtype=cache_dtype, device=dev, kv_heads=kv_heads[0]),
            llama.init_kv_cache(draft_config, n_slots, dtype=cache_dtype, device=dev, kv_heads=kv_heads[1]),
            zeros(), zeros(), zeros(), torch.ones(n_slots, dtype=torch.bool, device=dev), zeros(),
            zeros(n_slots, width or config.max_seq_len), zeros())


def _sample_rows(logits, temperature, top_k, top_p, min_p, generator):
    """Per-row draft sampling -> (tokens [B], q rows [B, V] f32). Greedy rows take the raw
    argmax (their q row is never read by the greedy law)."""
    f = filter_logits_rows(logits, temperature, top_k, top_p, min_p)
    sampled = gumbel_argmax(f, generator)
    greedy = logits.float().argmax(dim=-1)
    return torch.where(temperature == 0.0, greedy, sampled), torch.softmax(f, dim=-1)


def _spec_round(model: llama.Llama, draft_model: llama.Llama, state, generator, params, gamma: int, pad_id: int,
                kv_bound: int, live_rounds) -> None:
    """One speculative round over every slot, in place (the body a graph captures)."""
    t_cache, d_cache, prev, cur, pos, done, emitted, ring, cursor = state
    temperature, top_k, top_p, min_p, eos_ids, budget = params
    N = temperature.shape[0]
    dev = pos.device
    idx = torch.arange(gamma + 1, device=dev)[None, :]
    if live_rounds is not None:
        live_rounds += (~done).sum()
    # draft: the pair step, then gamma - 1 single steps at per-row positions
    pair = torch.stack([prev, cur], dim=1)
    x = llama.embed(draft_model, pair)
    ppos = pos[:, None] + torch.arange(-1, 1, device=dev)[None, :]
    h, _ = llama.trunk(draft_model, x, MaskInfo(causal=True, q_positions=ppos, kv_len=pos + 1), d_cache,
                       input_pos=ppos)
    tok, q = _sample_rows(llama.head(draft_model, h[:, -1:])[:, 0], temperature, top_k, top_p, min_p, generator)
    drafts, qs, p = [tok], [q], pos + 1
    for _ in range(gamma - 1):
        x = llama.embed(draft_model, tok[:, None])
        h, _ = llama.trunk(draft_model, x, MaskInfo(causal=True, q_positions=p[:, None], kv_len=p + 1), d_cache,
                           input_pos=p[:, None])
        tok, q = _sample_rows(llama.head(draft_model, h)[:, 0], temperature, top_k, top_p, min_p, generator)
        drafts.append(tok)
        qs.append(q)
        p = p + 1
    drafts, q_probs = torch.stack(drafts, dim=1), torch.stack(qs, dim=1)

    # target: one verify pass over [cur, d_1..d_gamma], contiguous positions under kv_bound
    inputs = torch.cat([cur[:, None], drafts], dim=1)
    x = llama.embed(model, inputs)
    qpos = pos[:, None] + idx
    h, _ = llama.trunk(model, x, MaskInfo(causal=True, q_positions=qpos, kv_len=pos + gamma + 1), t_cache,
                       input_pos=qpos, kv_bound=kv_bound)
    t_logits = llama.head(model, h)  # [N, gamma + 1, V]

    # acceptance: both laws, picked per row by its temperature
    targets = t_logits.float().argmax(dim=-1)
    match = torch.cat([drafts == targets[:, :gamma], torch.zeros_like(drafts[:, :1], dtype=torch.bool)], dim=1)
    a_greedy = match.int().argmin(dim=1)
    rep = lambda v: v[:, None].expand(N, gamma + 1).reshape(-1)  # noqa: E731
    p_flat = filter_logits_rows(t_logits.reshape(N * (gamma + 1), -1), rep(temperature), rep(top_k), rep(top_p),
                                rep(min_p))
    p_probs = torch.softmax(p_flat, dim=-1).reshape(t_logits.shape)
    emitted_s, m_s = speculative_accept(drafts, q_probs, p_probs, generator)
    is_greedy = temperature == 0.0
    emit = torch.where(is_greedy[:, None], targets, emitted_s)
    m = torch.where(is_greedy, a_greedy + 1, m_s)

    # freeze, budget and stop token, per row and monotone
    m = torch.where(done, torch.zeros_like(m), torch.minimum(m, budget - emitted))
    emit = torch.where(idx < m[:, None], emit, torch.full_like(emit, pad_id))
    live_eos = (emit == eos_ids[:, None]) & (idx < m[:, None])
    hit_eos = live_eos.any(dim=1)
    m = torch.where(hit_eos, torch.minimum(m, live_eos.int().argmax(dim=1) + 1), m)
    emit = torch.where(idx < m[:, None], emit, torch.full_like(emit, pad_id))

    ring.scatter_(1, cursor[:, None] + idx, emit)  # cursor + gamma < n_rounds (gamma + 1)
    padded = torch.cat([cur[:, None], emit], dim=1)
    prev.copy_(padded.gather(1, torch.clamp(m - 1, min=0)[:, None])[:, 0])
    cur.copy_(padded.gather(1, m[:, None])[:, 0])
    emitted += m
    done |= hit_eos | (emitted >= budget)
    pos += m
    cursor += m


@torch.inference_mode()
def spec_chunk(model: llama.Llama, draft_model: llama.Llama, state, n_rounds: int, generator, temperature, top_k,
               top_p, min_p, eos_ids, budget, gamma: int, pad_id: int = 0, live_rounds: torch.Tensor | None = None,
               kv_bound: int | None = None, eager: bool = False):
    """``n_rounds`` speculative rounds over every slot -> (tokens [N, n_rounds * (gamma + 1)],
    state): each live row's new tokens are the prefix of its row of length emitted_after -
    emitted_before (a row emits m in [0, gamma + 1] a round). Reads nothing back from the
    device. On the card each round is one replay of the round's captured graph over the
    state, the six per-row tensors and ``live_rounds`` (captured on the first call with these
    buffers: pass the same tensors each chunk); ``eager``: launched op by op. The state is
    updated in place and the tokens are a view of its ring, which the next call overwrites.
    ``live_rounds`` (a 0-d tensor, optional) gains the number of rows live at each round's
    start: tokens / live rounds is the acceptance. ``kv_bound``: at least every live row's
    kv_len in the chunk's verify passes (``verify_bound``; default max_seq_len)."""
    ring, cursor = state[7], state[8]
    W = n_rounds * (gamma + 1)
    if W > ring.shape[1]:
        raise ValueError(f"{n_rounds} rounds of gamma {gamma} exceed the ring's {ring.shape[1]} tokens")
    with spans.on_device("device.copy"):
        ring[:, :W].fill_(pad_id)
        cursor.zero_()
    params = (temperature, top_k, top_p, min_p, eos_ids, budget)
    kv_bound = model.config.max_seq_len if kv_bound is None else kv_bound
    buffers = (*cache_tensors(state[0]), *cache_tensors(state[1]), *state[2:], *params,
               *(() if live_rounds is None else (live_rounds,)))
    dg.run(model, "spec_chunk round", buffers, (gamma, pad_id, kv_bound),
           lambda m, gen: _spec_round(m, draft_model, state, gen, params, gamma, pad_id, kv_bound, live_rounds),
           n_rounds, generator, eager=eager, draws=True, others=(draft_model,))
    return ring[:, :W], state


def _spec_admit_body(model, draft_model, generator, state, inputs: AdmitBuffers, Pb: int) -> None:
    ids = inputs.ids[:, :Pb]
    h = prefill_rows(model, ids, inputs.work)
    prefill_rows(draft_model, ids, inputs.draft)
    first = sample_at(model, h, inputs.length - 1, inputs, generator)
    lane_copy(state[0], inputs.work, inputs.slot, Pb)
    lane_copy(state[1], inputs.draft, inputs.slot, Pb)
    state[2].index_copy_(0, inputs.slot, ids[0].index_select(0, inputs.length - 1))  # prev: the prompt's last
    activate(state[3:7], inputs, first, inputs.length)  # cur, pos, done, emitted


@torch.inference_mode()
def spec_admit_row(model: llama.Llama, draft_model: llama.Llama, state, inputs: AdmitBuffers, slot: int,
                   prompt: list[int], sampling, eos_id: int, generator: torch.Generator | None = None, *,
                   prompt_multiple: int = 64, pad_id: int = 0, eager: bool = False):
    """Prefill BOTH caches' rows for one prompt row, padded to its bucket Pb, and make it live
    in ``slot`` -> (first token, state). The first token is sampled from the TARGET's
    position P - 1. On the card one replay of the graph of Pb (keyed also by the draft's
    weights; ``eager``: launched op by op)."""
    cap = min(cache_tensors(c)[0].shape[3] for c in state[:2])
    Pb = prompt_bucket(len(prompt), prompt_multiple, cap - 1)
    inputs.feed(prompt, Pb, pad_id, slot=slot, length=len(prompt), eos_id=eos_id, sampling=sampling)
    run_admission(model, "spec_admit_row", (*cache_tensors(state[0]), *cache_tensors(state[1]), *state[2:7]), inputs,
                  (Pb,), lambda m, gen: _spec_admit_body(m, draft_model, gen, state, inputs, Pb), generator, eager,
                  others=(draft_model,))
    return inputs.first[0].clone(), state


class SpeculativeScheduler(ContinuousScheduler):
    """Continuous batching whose chunk step is a scan of speculative rounds.
    ``chunk_size`` counts ROUNDS per dispatch (each emits 1..gamma + 1 tokens a live row).
    On the card each round is one replay of ``spec_chunk``'s captured graph; ``eager``: the
    rounds launched op by op (a model or a draft on a mesh needs it). Prefix caching and
    chunked prefill do not compose with the two-cache admission yet (as in the JAX package)
    and raise."""

    def __init__(self, model: llama.Llama, draft_model: llama.Llama, *, gamma: int = 4, **kw):
        if kw.get("prefix_cache") or kw.get("prefill_chunk"):
            raise ValueError("speculative continuous batching does not compose with prefix caching or chunked "
                             "prefill yet")
        if model.config.vocab_size != draft_model.config.vocab_size:
            raise ValueError("the draft must share the target's vocabulary")
        self.draft_model, self.draft_config = draft_model, draft_model.config
        self.gamma = gamma
        self.rounds_run = 0
        super().__init__(model, **kw)
        # rows live at each round's start, summed on the device: (tokens emitted after the
        # first of each row) / live_row_rounds is the tokens a verify pass gives, 1 + accepted
        self.live_row_rounds = torch.zeros((), dtype=torch.int64, device=self.device)

    def _init_state(self):
        return init_spec_state(self.config, self.draft_config, self.n_slots, self.cache_dtype, self.device,
                               (llama.local_kv_heads(self.model), llama.local_kv_heads(self.draft_model)),
                               self.chunk_size * (self.gamma + 1))

    # a round writes target positions up to pos + gamma and draft positions up to
    # pos + gamma - 1; pos <= P + budget - 1 while live, so P + budget + gamma must fit both
    def _cap(self) -> int:
        return min(self.config.max_seq_len, self.draft_config.max_seq_len)

    def submit(self, ids, max_tokens: int, sampling=(0.0, 0, 1.0, 0.0), eos_id: int = -1,
               stream_q=None) -> RowHandle:
        if len(ids) + self.gamma + 1 >= self._cap():
            raise ValueError(f"prompt ({len(ids)} tokens) + gamma {self.gamma} fills the {self._cap()} cache")
        return super().submit(ids, max_tokens, sampling, eos_id, stream_q)

    def _init_inputs(self) -> AdmitBuffers:
        return AdmitBuffers(self.model, self.state[0], self.state[1])

    def _admit(self, slot: int, row: RowHandle):
        first, self.state = spec_admit_row(self.model, self.draft_model, self.state, self.inputs, slot, row.ids,
                                           row.sampling, row.eos_id, self.generator,
                                           prompt_multiple=self.prompt_multiple, pad_id=self.pad_id, eager=self.eager)
        self._activate(slot, row, int(first))

    def _budget_cap(self, row: RowHandle) -> int:
        return min(row.max_tokens, self._cap() - len(row.ids) - self.gamma)

    def _kv_bound(self) -> int:
        """The verify's static kv bound for the chunk about to go (``verify_bound``): each
        live row's position at the last collect, plus gamma + 1 a round for this chunk and
        the one that may still be in flight (the worker collects a chunk after it dispatches
        the next), at most the position its budget lets it reach; then the verify's gamma + 1
        positions. A dead slot's stale kv_len may pass it: the offsets form clamps it, and the
        row emits nothing."""
        ahead = 2 * self.chunk_size * (self.gamma + 1)
        hi = max((min(len(row.ids) + self.emitted_seen[slot] - 1 + ahead, len(row.ids) + self.budget[slot] - 1)
                  for slot, row in enumerate(self.rows) if row is not None), default=0)
        return verify_bound(self.config, hi + self.gamma + 1, self.cache_dtype, self.gamma)

    def _dispatch_chunk(self):
        toks, self.state = spec_chunk(self.model, self.draft_model, self.state, self.chunk_size, self.generator,
                                      *self._row_tensors(), gamma=self.gamma, pad_id=self.pad_id,
                                      live_rounds=self.live_row_rounds, kv_bound=self._kv_bound(), eager=self.eager)
        self.dispatches += 1
        self.rounds_run += self.chunk_size
        return toks, self.state[6], self.state[5]
