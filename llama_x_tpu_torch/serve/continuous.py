"""Continuous batching: rows join and leave the running decode batch at chunk
boundaries (port of llama_x_tpu/serve/continuous.py).

- ONE persistent decode state over a fixed number of slots. The KV cache is
  [L, n_slots, Hkv, S_max, hd] (bf16, or int8 with f32 scales), preallocated once and
  written in place.
- Admission prefills one prompt row, right-padded to its bucket, into a row cache of
  S_max positions (the prefill attends over the fresh K/V only), samples the first token at
  the prompt's last position and copies the row's first Pb positions into the slot's lane.
  With a prefix-cache hit the harvested prefix K/V is copied into the row cache and only the
  suffix runs, over it (the flash kernel's offsets form, or the decode kernel for a suffix
  of at most ``MAX_SQ`` tokens).
- Chunked prefill (``prefill_chunk`` > 0): an admission runs one chunk of C tokens (the last
  padded) per scheduler iteration into the working row cache (the decode steps of the other
  slots write every lane, so a lane cannot be filled in pieces while they run), then the
  first token is sampled and the row copied into the lane. The first chunk is a prefill
  (flash self-attention); each later one attends over the row through the flash kernel's
  offsets form. Where several slots admit at once, a slot whose chunk comes after another's
  takes the working row back from a pooled row of its own, where it was parked (plain
  copies of the prefilled positions), so one graph a bucket serves every slot.
- Decoding is a chunk of single-token steps over every slot with every per-request
  quantity held as an [n_slots] tensor: sampling parameters, stop token, token budget and
  the done mask. Nothing in a step reads back from the device; the host syncs once per
  chunk, when it collects the chunk's tokens. On the card each step is one replay of the
  step's captured CUDA graph (models/decode_graph.py), the state and the per-row tensors its
  static buffers.
- Between chunks the host appends each row's new tokens (the freeze is monotone, so a
  row's new tokens are a prefix of its chunk row of length emitted_after -
  emitted_before), streams them, frees finished slots and admits queued rows.

A hybrid decoder (``models/nemotron_h.HybridConfig``: Mamba-2 blocks beside attention) keeps
two more state tensors a slot, its SSM state (f32) and its conv state, at the end of the state
tuple. Its admissions and prefill chunks write them straight into the slot's lanes (K8 over
the span): the decode steps leave a lane whose ``done`` is set as it is (K9), and a slot's lane
stays done from its last row's end until its next row's install. A chunk whose span holds the
prompt's harvest point P0 also writes the states at P0 into the admission buffers' snapshot
(``AdmitBuffers.snap``), which the scheduler copies out at once (``serve.snapshot``) and keeps
with the prefix's K/V; a hit copies them into the slot's lanes (``serve.restore``) before the
suffix runs.

Admissions are padded to the JAX package's buckets (``prompt_multiple`` = pm): a prompt of P
tokens to Pb = min(max(pm, ceil(P / pm) pm), S_max - 1), a suffix after a prefix of P0 to
Sb = min(ceil(len / pm) pm, S_max - P0), a chunk to the fixed width C; pad positions are
computed too and their K/V stay hidden behind kv_len until a decode step overwrites them.
Each admission program reads and writes only static buffers (``AdmitBuffers``: the padded
ids, the real length, the slot, the sampling values and the stop token on the device, filled
from pinned host memory; the working row cache; the state), takes the slot as data and reads
nothing back, so on the card each is one replay of a graph captured per bucket
(models/decode_graph.py; the buffer set's own runner keeps every key while the set lives), as
the JAX package compiles one per bucket; ``eager=True`` launches the same program op by op over
the same buffers. The host
reads the first token back once, after the program. Attention, RoPE and the cache writes are
row-local, so a row's greedy output equals an unbatched ``generate`` of its prompt whatever
shares its batch (held by the tests against the JAX scheduler and against ``generate``). The
JAX package's threefry draws are not reproduced: sampled rows follow the same law from a
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading

import torch

from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models import nemotron_h
from llama_x_tpu_torch.models import speculative as mspec
from llama_x_tpu_torch.models.decode_graph import cache_tensors
from llama_x_tpu_torch.models.generate import gumbel_argmax
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.utils import spans
from llama_x_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# per-row sampling: the [B] form of models/generate.py:sample_logits. For rows with the
# same parameters and the same generator state both draw the same token.
# ---------------------------------------------------------------------------


def filter_logits_rows(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                       min_p: torch.Tensor) -> torch.Tensor:
    """``generate.filter_logits`` with per-row thresholds ([B] each): [B, V] f32 filtered
    logits. The scalar path's order and arithmetic: top-k truncates (k = 0 keeps all),
    min-p relative to the row max, then the nucleus keeps the smallest prefix whose mass
    reaches top_p (the top token always)."""
    B, V = logits.shape
    neg_inf = float("-inf")  # a Python scalar: no host-to-device copy (a captured step takes none)
    lg = logits.float() / temperature.float().clamp(min=1e-6)[:, None]
    desc = torch.sort(lg, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, V)).clamp(1, V).long()
    kth = desc.gather(1, (k - 1)[:, None])
    lg = torch.where(lg < kth, neg_inf, lg)
    cutoff = lg.amax(dim=-1, keepdim=True) + torch.log(min_p.float().clamp(1e-12, 1.0))[:, None]
    lg = torch.where((min_p > 0.0)[:, None] & (lg < cutoff), neg_inf, lg)
    desc = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p.float()[:, None]
    cutoff = torch.where(keep, desc, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where((top_p < 1.0)[:, None] & (lg < cutoff), neg_inf, lg)


def sample_logits_rows(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
                       min_p: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] + per-row parameters [B] -> token ids [B] (int64). Rows at
    temperature 0 take the argmax of the raw logits (the scalar sampler's greedy branch);
    the noise is drawn for every row."""
    greedy = logits.float().argmax(dim=-1)
    sampled = gumbel_argmax(filter_logits_rows(logits, temperature, top_k, top_p, min_p), generator)
    return torch.where(temperature == 0.0, greedy, sampled)


def sampling_tensors(rows: list[tuple], device) -> tuple[torch.Tensor, ...]:
    """(temperature, top_k, top_p, min_p) [B] tensors from per-row (t, k, p, min_p)."""
    t, k, p, mp = zip(*rows)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.tensor(t, **f32), torch.tensor(k, dtype=torch.int64, device=device), torch.tensor(p, **f32),
            torch.tensor(mp, **f32))


# ---------------------------------------------------------------------------
# device programs: admission, chunked prefill and the multi-row decode chunk
# state: (kv_cache, tok [N], pos [N], done [N] bool, emitted [N], ring [N, S_max], at [1]),
# all int64 but done, and a hybrid's (ssm, conv) lanes: the static buffers of the captured
# decode step, written in place
# ---------------------------------------------------------------------------


def is_hybrid(config) -> bool:
    return isinstance(config, nemotron_h.HybridConfig)


def init_state(config, n_slots: int, cache_dtype=torch.bfloat16, device=None, kv_heads: int | None = None,
               conv_dtype=torch.bfloat16):
    """The scheduler's state over ``n_slots`` lanes; ``kv_heads``: a tensor-parallel rank's
    local kv heads (``llama.local_kv_heads``). ``ring`` holds each decode chunk's tokens,
    ``at`` its write index. A hybrid's cache holds its attention blocks, and its SSM and conv
    lanes (``nemotron_h.init_states``, the conv in ``conv_dtype``) follow."""
    dev = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape or (n_slots,), dtype=torch.int64, device=dev)  # noqa: E731
    kv_config = config.attention_config() if is_hybrid(config) else config
    state = (llama.init_kv_cache(kv_config, n_slots, dtype=cache_dtype, device=dev, kv_heads=kv_heads), zeros(),
             zeros(), torch.ones(n_slots, dtype=torch.bool, device=dev), zeros(),  # empty slots are "done"
             zeros(n_slots, config.max_seq_len), zeros(1))
    return state + nemotron_h.init_states(config, n_slots, dev, conv_dtype) if is_hybrid(config) else state


def copy_positions(dst_cache, src_cache, n: int) -> None:
    """Positions [0, n) of every tensor of ``src_cache`` into ``dst_cache`` (both [L, 1, ...])."""
    with spans.on_device("device.copy"):
        for d, s in zip(cache_tensors(dst_cache), cache_tensors(src_cache)):
            d[:, :, :, :n].copy_(s[:, :, :, :n])


# ---------------------------------------------------------------------------
# admission: the JAX package's buckets, and programs over static buffers
# ---------------------------------------------------------------------------


def prompt_bucket(n: int, multiple: int, cap: int) -> int:
    """A prompt's padded length Pb: n rounded up to ``multiple``, at least one multiple, at
    most ``cap`` (S_max - 1; llama_x_tpu/serve/continuous.py:539-540)."""
    return min(max(multiple, -(-n // multiple) * multiple), cap)


def suffix_bucket(n: int, multiple: int, room: int) -> int:
    """A suffix's padded length Sb after a prefix: n rounded up to ``multiple``, at most
    ``room`` (S_max - P0; llama_x_tpu/serve/continuous.py:526-527)."""
    return min(-(-n // multiple) * multiple, room)


def cache_dtype_of(kv_cache):
    return torch.int8 if isinstance(kv_cache[0], tuple) else kv_cache[0].dtype


def admit_bound(config: llama.LlamaConfig, need: int, cache_dtype, rows: int) -> int:
    """The static kv bound of ``rows`` queries over a row cache whose every kv_len is at most
    ``need`` (``llama.trunk``'s ``kv_bound``): ``verify_bound``'s buckets, which split keys
    only where the bound sizes the int8 cache's dequantized prefix."""
    return mspec.verify_bound(config, need, cache_dtype, rows - 1)


def row_extent(need: int, S: int) -> int:
    """The positions of the working row a prefix admission copies into its lane: ``need``
    (P0 + Sb) rounded up to the verify's kv bucket, at most S. So P0 is data and not a key:
    the programs of a suffix bucket Sb are one an extent, not one a prefix length."""
    return min(S, -(-need // mspec.KV_BUCKET) * mspec.KV_BUCKET)


def _row_like(kv_cache):
    """A zeroed single-row cache of the form of ``kv_cache``'s lanes ([L, 1, ...] tensors)."""
    def one(t):
        return torch.zeros((t.shape[0], 1, *t.shape[2:]), dtype=t.dtype, device=t.device)

    def side(x):
        return tuple(one(t) for t in x) if isinstance(x, tuple) else one(x)
    return side(kv_cache[0]), side(kv_cache[1])


class AdmitBuffers:
    """The static buffers of the admission programs, on the model's device, which every
    program reads and writes at fixed addresses (a graph's inputs and outputs):

    - ``ids`` [1, S_max]: the padded prompt, suffix or chunk; ``ints`` [6]: the slot, the
      real tokens in ``ids`` (``length``), the position of ids[0] (``start``), the stop token,
      top_k and the offset in ``ids`` of a hybrid's snapshot (``snap_at``, -1: none); ``floats``
      [3]: temperature, top_p, min_p; ``first`` [1]: the token sampled.
      ``feed`` fills them from pinned host memory on the card (the caching host allocator
      keeps a block until its copy has run).
    - ``work``: the working row cache, S_max positions of the lanes' form (with ``draft``, the
      draft's beside it), and ``h_last`` [1, 1, D], the hidden state at a prefill chunk's last
      real position. A chunked prefill holds it between chunks; another slot's chunk first
      parks it in a pooled row (``lease``, at most one an admitting slot, made on first use).
      A hybrid's SSM and conv states stay in the slot's lanes; ``snap``: their snapshot at the
      harvest point (``nemotron_h.init_states`` of one lane).
    - ``runner``: the graphs of the programs over these buffers (``decode_graph.Runner``), one
      a key, every key kept while the set lives, in one memory pool.
    """

    def __init__(self, model: llama.Llama, kv_cache, draft_cache=None):
        dev = model.device
        S = cache_tensors(kv_cache)[0].shape[3]
        self.pin = dev.type == "cuda"
        self.i64 = torch.zeros(6 + S, dtype=torch.int64, device=dev)
        self.ints, self.ids = self.i64[:6], self.i64[6:].view(1, S)
        self.slot, self.length, self.start, self.eos, self.top_k, self.snap_at = (self.ints[i:i + 1] for i in range(6))
        self.floats = torch.zeros(3, dtype=torch.float32, device=dev)
        self.first = torch.zeros(1, dtype=torch.int64, device=dev)
        self.work = _row_like(kv_cache)
        self.draft = None if draft_cache is None else _row_like(draft_cache)
        self.h_last = torch.zeros(1, 1, model.config.embed_dim, dtype=model.tok_embeddings.dtype, device=dev)
        self.snap = (tuple(t[:, 0] for t in nemotron_h.init_states(model.config, 1, dev, model.tok_embeddings.dtype))
                     if is_hybrid(model.config) else ())
        self.owner = None  # the admitting slot whose chunked prefill the working row holds
        self.pool: list = []  # parked rows
        self.free: list[int] = []
        self.runner = dg.Runner(cap=None, shared_pool=True)

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return (self.i64, self.floats, self.first, *cache_tensors(self.work),
                *(cache_tensors(self.draft) if self.draft is not None else ()), self.h_last, *self.snap)

    def feed(self, tokens, width: int, pad_id: int, *, slot: int = 0, length: int = 0, start: int = 0,
             eos_id: int = -1, sampling=(0.0, 0, 1.0, 0.0), snap_at: int = -1) -> None:
        """``tokens`` right-padded with ``pad_id`` to ``width`` into ``ids``, and the scalars."""
        t, k, p, mp = sampling
        ints = [slot, length, start, eos_id, k, snap_at] + list(tokens) + [pad_id] * (width - len(tokens))
        srcs = []
        for dst, vals in ((self.i64[:6 + width], ints), (self.floats, [t, p, mp])):
            src = torch.tensor(vals, dtype=dst.dtype)
            srcs.append((dst, src.pin_memory() if self.pin else src))
        with spans.on_device("device.copy"):
            for dst, src in srcs:
                dst.copy_(src, non_blocking=self.pin)

    def lease(self) -> int:
        """A pooled row (the lowest free one, made on first use)."""
        if self.free:
            self.free.sort()
            return self.free.pop(0)
        self.pool.append(_row_like(self.work))
        return len(self.pool) - 1

    def release(self, i: int) -> None:
        self.free.append(i)

    def nbytes(self) -> int:
        """Device memory the buffers hold: the inputs, the working row(s) and the pooled rows."""
        return sum(t.nbytes for t in self.buffers()) + sum(t.nbytes for c in self.pool for t in cache_tensors(c))


def lane_copy(kv_cache, row, slot: torch.Tensor, n: int) -> None:
    """Positions [0, n) of a [L, 1, ...] row cache into lane ``slot`` ([1] on the device) of
    the shared cache (the JAX ``_scatter_row``)."""
    for b, r in zip(cache_tensors(kv_cache), cache_tensors(row)):
        b[:, :, :, :n].index_copy_(1, slot, r[:, :, :, :n])


def activate(rows, inputs: AdmitBuffers, first: torch.Tensor, total: torch.Tensor) -> None:
    """The slot's entries of ``rows`` = (tok, pos, done, emitted), indexed by the device slot."""
    tok, pos, done, emitted = rows
    tok.index_copy_(0, inputs.slot, first)
    pos.index_copy_(0, inputs.slot, total)
    done.index_copy_(0, inputs.slot, first == inputs.eos)
    emitted.index_fill_(0, inputs.slot, 1)
    inputs.first.copy_(first)


def sample_at(model: llama.Llama, h: torch.Tensor, at: torch.Tensor, inputs: AdmitBuffers, generator) -> torch.Tensor:
    """The first token [1] from the hidden state at position ``at`` ([1] on the device) of
    ``h`` [1, S, D], under the sampling values of ``inputs``."""
    logits = llama.head(model, h.index_select(1, at))[:, 0]
    t, p, mp = inputs.floats[0:1], inputs.floats[1:2], inputs.floats[2:3]
    return sample_logits_rows(logits, t, inputs.top_k, p, mp, generator)


def _trunk(model, x, mask, cache, states=None, **kw):
    """``llama.trunk``, or a hybrid's over its ``states`` too."""
    if states is None:
        return llama.trunk(model, x, mask, cache, **kw)
    return nemotron_h.trunk(model, x, mask, cache, states=states, **kw)


def _span(state, inputs: AdmitBuffers, fresh: bool):
    """A span over the admitting slot's lanes (``state[7:]``: a hybrid's SSM and conv states),
    or None where the state has no lanes."""
    lanes = () if state is None else state[7:]
    return nemotron_h.Span(*lanes, inputs.slot, inputs.length, fresh, inputs.snap_at, *inputs.snap) if lanes else None


def prefill_rows(model: llama.Llama, ids: torch.Tensor, row, states=None) -> torch.Tensor:
    """A prefill of ``ids`` [1, W] at positions [0, W) into a row cache (flash
    self-attention over the fresh K/V) -> h [1, W, D]."""
    W = ids.shape[1]
    pos = torch.arange(W, device=ids.device).clamp(max=cache_tensors(row)[0].shape[3] - 1)
    return _trunk(model, llama.embed(model, ids), MaskInfo(causal=True), row, states, input_pos=pos, prefill=True)[0]


def _over_row(model: llama.Llama, ids: torch.Tensor, row, inputs: AdmitBuffers, kv_bound: int,
              states=None) -> torch.Tensor:
    """``ids`` [1, W] at positions [start, start + W) (the device ``start``) over a row cache
    that holds [0, start): causal q_positions and kv_len = start + length -> h [1, W, D]. Pad
    positions past the cache are clamped to its last (their K/V is never read)."""
    W = ids.shape[1]
    qpos = (inputs.start + torch.arange(W, device=ids.device)).clamp(max=cache_tensors(row)[0].shape[3] - 1)
    mask = MaskInfo(causal=True, q_positions=qpos[None], kv_len=inputs.start + inputs.length)
    return _trunk(model, llama.embed(model, ids), mask, row, states, input_pos=qpos, kv_bound=kv_bound)[0]


def _admit_body(model, generator, state, inputs: AdmitBuffers, Pb: int) -> None:
    h = prefill_rows(model, inputs.ids[:, :Pb], inputs.work, _span(state, inputs, True))
    first = sample_at(model, h, inputs.length - 1, inputs, generator)
    lane_copy(state[0], inputs.work, inputs.slot, Pb)
    activate(state[1:5], inputs, first, inputs.length)


def _prefix_body(model, generator, state, inputs: AdmitBuffers, Sb: int, extent: int, kv_bound: int) -> None:
    h = _over_row(model, inputs.ids[:, :Sb], inputs.work, inputs, kv_bound, _span(state, inputs, False))
    first = sample_at(model, h, inputs.length - 1, inputs, generator)
    lane_copy(state[0], inputs.work, inputs.slot, extent)
    activate(state[1:5], inputs, first, inputs.start + inputs.length)


def _chunk_body(model, inputs: AdmitBuffers, C: int, first: bool, kv_bound: int, state=None) -> None:
    ids = inputs.ids[:, :C]
    span = _span(state, inputs, first)
    h = (prefill_rows(model, ids, inputs.work, span) if first
         else _over_row(model, ids, inputs.work, inputs, kv_bound, span))
    inputs.h_last.copy_(h.index_select(1, inputs.length - 1))


def _install_body(model, generator, state, inputs: AdmitBuffers) -> None:
    first = sample_at(model, inputs.h_last, torch.zeros_like(inputs.length), inputs, generator)
    lane_copy(state[0], inputs.work, inputs.slot, cache_tensors(inputs.work)[0].shape[3])
    activate(state[1:5], inputs, first, inputs.length)


def run_admission(model, name: str, state_buffers, inputs: AdmitBuffers, key: tuple, body, generator, eager: bool,
                  draws: bool = True, others=()) -> None:
    """One admission program ``body(model, generator)`` over ``state_buffers`` and the
    buffers of ``inputs``, keyed besides by ``key`` (the bucket)."""
    dg.run(model, name, (*state_buffers, *inputs.buffers()), key, body, 1, generator, eager=eager, draws=draws,
           others=others, runner=inputs.runner)


def _state_buffers(state) -> tuple:
    return (*cache_tensors(state[0]), *state[1:5], *state[7:])


@torch.inference_mode()
def admit_row(model: llama.Llama, state, inputs: AdmitBuffers, slot: int, prompt: list[int], sampling, eos_id: int,
              generator: torch.Generator | None = None, *, prompt_multiple: int = 64, pad_id: int = 0,
              eager: bool = False, snap_at: int = -1):
    """Prefill one prompt row, padded to its bucket Pb, and make it live in ``slot`` ->
    (first token, state). The prefill attends over its fresh K/V only, the first token is
    sampled at position P - 1, and the row's [0, Pb) go into the lane; the decode steps
    overwrite each later position before they expose it. On the card one replay of the
    graph of Pb (``eager``: launched op by op). A hybrid's states go into the slot's lanes,
    and where ``snap_at`` > 0 those after that many tokens into ``inputs.snap``."""
    P, S = len(prompt), cache_tensors(state[0])[0].shape[3]
    Pb = prompt_bucket(P, prompt_multiple, S - 1)
    inputs.feed(prompt, Pb, pad_id, slot=slot, length=P, eos_id=eos_id, sampling=sampling, snap_at=snap_at)
    run_admission(model, "admit_row", _state_buffers(state), inputs, (Pb,),
                   lambda m, gen: _admit_body(m, gen, state, inputs, Pb), generator, eager)
    return inputs.first[0].clone(), state


@torch.inference_mode()
def admit_row_prefix(model: llama.Llama, state, inputs: AdmitBuffers, slot: int, prefix_kv, prefix_len: int,
                     suffix: list[int], sampling, eos_id: int, generator: torch.Generator | None = None, *,
                     prompt_multiple: int = 64, pad_id: int = 0, eager: bool = False, snap_at: int = -1):
    """Admit a row whose first ``prefix_len`` tokens have harvested K/V: the prefix is copied
    into the working row, and ONLY the suffix, padded to its bucket Sb, runs over it ->
    (first token, state). By causality the prefix's K/V are what a full prefill of the prompt
    would write; the row's first ``row_extent(P0 + Sb)`` positions go into the lane (past P0 +
    Sb they are hidden behind kv_len until a decode step overwrites them). On the card one
    replay of the graph of (Sb, extent), P0 data (the JAX package compiles one per (P0, Sb)).
    A hybrid's suffix runs from the states in the slot's lanes (the caller restored the
    prefix's there); ``snap_at``: as ``admit_row``'s, an offset into the suffix."""
    P0, S = prefix_len, cache_tensors(state[0])[0].shape[3]
    Sb = suffix_bucket(len(suffix), prompt_multiple, S - P0)
    copy_positions(inputs.work, prefix_kv, P0)
    inputs.feed(suffix, Sb, pad_id, slot=slot, length=len(suffix), start=P0, eos_id=eos_id, sampling=sampling,
                snap_at=snap_at)
    extent = row_extent(P0 + Sb, S)
    bound = admit_bound(model.config, extent, cache_dtype_of(state[0]), Sb)
    run_admission(model, "admit_row_prefix", _state_buffers(state), inputs, (Sb, extent, bound),
                   lambda m, gen: _prefix_body(m, gen, state, inputs, Sb, extent, bound), generator, eager)
    return inputs.first[0].clone(), state


@torch.inference_mode()
def prefill_chunk(model: llama.Llama, inputs: AdmitBuffers, chunk: list[int], start: int, width: int, *,
                  pad_id: int = 0, eager: bool = False, state=None, slot: int = 0, snap_at: int = -1) -> None:
    """One chunk of an incremental prefill into the working row of ``inputs``: ``chunk``
    right-padded to ``width`` at positions [start, start + width). A chunk at position 0 is a
    prefill (flash self-attention over its fresh K/V); a later one attends over the row
    (kv_len start + len(chunk)) under a static bound. The hidden state at the chunk's last
    real position goes to ``inputs.h_last``. On the card one replay of the graph of (width,
    first, bound). A hybrid's chunk reads and writes lane ``slot`` of ``state``'s SSM and conv
    states (``snap_at``: as ``admit_row``'s, an offset into the chunk)."""
    first = start == 0
    S = cache_tensors(inputs.work)[0].shape[3]
    bound = S if first else admit_bound(model.config, start + width, cache_dtype_of(inputs.work), width)
    inputs.feed(chunk, width, pad_id, length=len(chunk), start=start, slot=slot, snap_at=snap_at)
    lanes = () if state is None else tuple(state[7:])
    run_admission(model, "prefill_chunk", lanes, inputs, (width, first, bound),
                   lambda m, gen: _chunk_body(m, inputs, width, first, bound, state), None, eager, draws=False)


@torch.inference_mode()
def install_row(model: llama.Llama, state, slot: int, inputs: AdmitBuffers, total: int, sampling, eos_id: int,
                generator: torch.Generator | None = None, *, eager: bool = False):
    """After a chunked prefill's last chunk: the first token sampled from ``inputs.h_last``,
    the working row (every position, as the JAX ``install_row`` scatters it) copied into lane
    ``slot``, the row live at ``total`` -> (first token, state). The JAX ``sample_first`` and
    ``install_row`` in one program."""
    inputs.feed([], 0, 0, slot=slot, length=total, eos_id=eos_id, sampling=sampling)
    run_admission(model, "install_row", _state_buffers(state), inputs, (),
                   lambda m, gen: _install_body(m, gen, state, inputs), generator, eager)
    return inputs.first[0].clone(), state


@torch.inference_mode()
def slice_prefix(kv_cache, slot: int, p0: int):
    """Lane ``slot``'s first ``p0`` positions, copied out of the shared cache as a
    [L, 1, Hkv, p0, ...] cache of the same form."""
    def one(side):
        return (tuple(t[:, slot:slot + 1, :, :p0].clone() for t in side) if isinstance(side, tuple)
                else side[:, slot:slot + 1, :, :p0].clone())
    return one(kv_cache[0]), one(kv_cache[1])


def _rows_step(model: llama.Llama, state, generator, params, pad_id: int) -> None:
    """One decode step over every slot, in place (the body a graph captures)."""
    kv_cache, tok, pos, done, emitted, ring, at = state[:7]
    temperature, top_k, top_p, min_p, eos_ids, budget = params
    S_max = model.config.max_seq_len
    x = llama.embed(model, tok[:, None])
    mask = MaskInfo(causal=True, q_positions=pos[:, None], kv_len=pos + 1)
    lanes = nemotron_h.Lanes(*state[7:], done) if state[7:] else None
    h, _ = _trunk(model, x, mask, kv_cache, lanes, input_pos=pos[:, None])
    nxt = sample_logits_rows(llama.head(model, h)[:, 0], temperature, top_k, top_p, min_p, generator)
    nxt = torch.where(done, pad_id, nxt)
    new_emitted = emitted + (~done).long()
    new_pos = torch.where(done, pos, torch.clamp(pos + 1, max=S_max - 1))
    new_done = done | (nxt == eos_ids) | (new_emitted >= budget) | (pos + 1 >= S_max)
    ring.index_copy_(1, at, nxt[:, None])
    at += 1
    tok.copy_(nxt)
    pos.copy_(new_pos)
    done.copy_(new_done)
    emitted.copy_(new_emitted)


@torch.inference_mode()
def decode_rows(model: llama.Llama, state, n_steps: int, generator: torch.Generator | None, temperature, top_k,
                top_p, min_p, eos_ids, budget, pad_id: int = 0, eager: bool = False):
    """``n_steps`` decode steps over every slot -> (tokens [N, n_steps], state). Reads
    nothing back from the device. On the card each step is one replay of the step's
    captured graph over the state and the six per-row tensors (captured on the first call
    with these buffers: pass the same tensors each chunk); ``eager``: launched op by op.
    The state is updated in place and the tokens are a view of its ring, which the next
    call overwrites.

    A row freezes (monotonically) when it emits its stop token, exhausts its budget or
    fills the cache; frozen and empty slots ride along emitting ``pad_id`` and hold their
    position, so the decode kernel's window of a dead lane does not grow."""
    ring, at = state[5], state[6]
    if n_steps > ring.shape[1]:
        raise ValueError(f"{n_steps} steps exceed the model's {ring.shape[1]} positions")
    params = (temperature, top_k, top_p, min_p, eos_ids, budget)
    with spans.on_device("device.copy"):
        at.zero_()
    dg.run(model, "decode_rows step", (*cache_tensors(state[0]), *state[1:], *params), (pad_id,),
           lambda m, gen: _rows_step(m, state, gen, params, pad_id), n_steps, generator, eager=eager, draws=True)
    return ring[:, :n_steps], state


# ---------------------------------------------------------------------------
# host-side scheduler
# ---------------------------------------------------------------------------


_row_ids = itertools.count(1)
_scheduler_ids = itertools.count(1)


class RowHandle:
    """One prompt row moving through the scheduler. ``event`` fires when the row is
    finished; ``stream_q`` (optional, anything with ``put``) receives token-id lists per
    chunk and a ``None`` sentinel at the end.

    Its lifecycle, on ``time.perf_counter_ns()``: ``t_submit`` (made), ``t_slot`` (taken
    into a slot: an admission or the start of a chunked prefill), ``t_first`` (its first
    token delivered), ``t_done`` (finished, failed or left at the scheduler's close); a time
    not reached stays None. When it ends it becomes two spans under its ``id``
    (``end_spans``)."""

    def __init__(self, ids: list[int], max_tokens: int, sampling, eos_id: int, stream_q=None,
                 scheduler: int | None = None):
        if max_tokens < 1:
            raise ValueError("max_tokens must be at least 1")
        self.t_submit = spans.now()
        self.t_slot = self.t_first = self.t_done = None
        self.id, self.scheduler = next(_row_ids), scheduler
        self.ids = ids
        self.reused = 0  # prompt tokens taken from the prefix cache
        self.slot: int | None = None  # the slot the row was taken into
        self.max_tokens = max_tokens
        self.sampling = sampling  # (temperature, top_k, top_p, min_p)
        self.eos_id = eos_id
        self.stream_q = stream_q
        self.tokens: list[int] = []  # raw emissions, eos included
        self.event = threading.Event()
        self.error: Exception | None = None

    @property
    def finish_reason(self) -> str:
        return "stop" if (self.tokens and self.tokens[-1] == self.eos_id) else "length"

    def end_spans(self) -> None:
        """Stamp ``t_done`` and record ``request.queue`` [submit, slot] and ``request.prefill``
        [slot, first], each from a time the row reached to the next one, or to ``t_done`` with
        ``reached`` False where it stopped short (failed, or left at the close)."""
        self.t_done = spans.now()
        marks = (self.t_submit, self.t_slot, self.t_first)
        for i, name in enumerate(("request.queue", "request.prefill")):
            if marks[i] is None:
                break
            end = marks[i + 1]
            spans.record(name, marks[i], self.t_done if end is None else end, request=self.id,
                         scheduler=self.scheduler, reached=end is not None)


class _Admitting:
    """A slot mid-way through a chunked prefill: the next prompt position to run and, while
    another slot's prefill holds the working row, the cache that holds its positions [0,
    next) (a harvested prefix before its first chunk, then its parked row, ``parked``); a
    hybrid's SSM and conv states stay in the slot's lanes."""

    def __init__(self, row: RowHandle, start: int, src=None):
        self.row, self.next, self.src, self.parked = row, start, src, None
        self.snap = None  # a hybrid's states at the harvest point, once a chunk has passed it


class ContinuousScheduler:
    """Admit-between-chunks serving loop over a fixed slot array.

    ``submit`` is thread-safe and does not block; a worker thread owns the device state
    and loops: admit queued rows into free slots -> one prefill chunk per admitting slot
    (chunked prefill) -> one decode chunk over all slots -> deliver tokens and free
    finished slots (one chunk later: the chunk in flight is collected after the next one
    is dispatched, so the host queues work while the device computes). On the card each
    decode step is one replay of ``decode_rows``' captured graph over the state and the six
    per-row tensors (static buffers, filled from pinned host memory each chunk);
    ``eager``: the steps launched op by op. Each admission, prefill chunk and row install is
    likewise one replay of its program's graph, captured per bucket, over ``inputs``
    (``AdmitBuffers``; ``eager`` launches them op by op too). A dispatched chunk's tokens,
    emitted counts and done mask are copied out (to pinned host memory on the card) before
    the next dispatch overwrites them, and its collection waits for that copy alone. Counters:
    ``dispatches`` (decode chunks), ``admissions``, ``prefill_dispatches`` (prefill
    chunks), ``prefix_hits`` and ``prefix_tokens_reused``; a hybrid's also ``state_snapshots``
    (snapshots kept), ``prefix_state_hits`` (snapshots restored) and ``state_bytes_copied``
    (the bytes of both).

    Spans (``utils/spans.py``), from the worker thread: ``serve.admit`` (a row taken into a
    slot), ``serve.prefill_chunk``, ``serve.install`` and ``serve.dispatch`` (a decode chunk
    with its row parameters and staging copies), under the row's id where they have one;
    each row's ``request.*`` spans when it ends. A hybrid's snapshot and restore copies are
    device intervals ``serve.snapshot`` and ``serve.restore``. On the card the worker's
    ``spans.DeviceClock`` (``clock``) times each replay and each block of copies as a
    ``device.*`` span whose ``stage`` is the worker span it ran under, read at ``_collect``,
    after the wait it makes anyway, and anchored whenever the worker waits with nothing in
    flight."""

    def __init__(self, model: llama.Llama, *, n_slots: int = 8, chunk_size: int = 16, prompt_multiple: int = 64,
                 cache_dtype=torch.bfloat16, pad_id: int = 0, seed: int = 0, prefix_cache: int = 0,
                 prefill_chunk: int = 0, eager: bool = False):
        self.model, self.config = model, model.config
        self.eager = eager
        self.device = model.device
        self.n_slots, self.chunk_size = n_slots, chunk_size
        self.prompt_multiple = prompt_multiple
        self.cache_dtype, self.pad_id = cache_dtype, pad_id
        self.prefill_chunk = prefill_chunk  # chunk width in tokens, 0 = one prefill per admission
        self.admitting: dict[int, _Admitting] = {}
        self.prefill_dispatches = 0
        # prefix caching (prefix_cache = most entries kept, 0 = off): after each admission
        # the prompt's longest prompt_multiple-aligned PROPER prefix [0, P0) is copied out
        # of the slot's lane under its token ids; a later prompt that starts with those
        # tokens prefills only its suffix. Worker thread only. Values: [cache, P0, lru].
        self.prefix_cap = prefix_cache
        self.prefixes: dict[tuple[int, ...], list] = {}
        self._lru = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.state_snapshots = self.prefix_state_hits = self.state_bytes_copied = 0
        self.id = next(_scheduler_ids)
        self.clock: spans.DeviceClock | None = None
        self.state = self._init_state()
        self.inputs = self._init_inputs()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # host mirrors of the per-slot row parameters fed to each decode chunk
        self.sampling = [(0.0, 0, 1.0, 0.0)] * n_slots
        self.eos = [-1] * n_slots
        self.budget = [1] * n_slots
        self.emitted_seen = [0] * n_slots  # host copy of emitted
        # the per-row tensors each chunk reads, (temperature, top_p, min_p) f32 and
        # (top_k, eos, budget) int64, on the device at fixed addresses, and two host copies
        # in turn (pinned on the card): the host fills one while the other's copy may be queued
        self.row_params = (torch.zeros(3, n_slots, device=self.device),
                           torch.zeros(3, n_slots, dtype=torch.int64, device=self.device))
        pin = self.device.type == "cuda"
        self.row_params_host = [(torch.zeros(3, n_slots, pin_memory=pin),
                                 torch.zeros(3, n_slots, dtype=torch.int64, pin_memory=pin)) for _ in range(2)]
        self.rows: list[RowHandle | None] = [None] * n_slots
        self.queue: list[RowHandle] = []
        self.cond = threading.Condition()
        self.dispatches = 0
        self.admissions = 0
        self.dead: Exception | None = None
        self._stop = False
        self._hold = self._held = False  # paused(): asked for, and the worker holding
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def _init_state(self):
        return init_state(self.config, self.n_slots, self.cache_dtype, self.device, llama.local_kv_heads(self.model),
                          self.model.tok_embeddings.dtype)

    def _init_inputs(self) -> AdmitBuffers:
        return AdmitBuffers(self.model, self.state[0])

    # -- client side ---------------------------------------------------------

    def submit(self, ids: list[int], max_tokens: int, sampling=(0.0, 0, 1.0, 0.0), eos_id: int = -1,
               stream_q=None) -> RowHandle:
        cap = self.config.max_seq_len
        if len(ids) + 1 > cap:
            raise ValueError(f"prompt ({len(ids)} tokens) fills the {cap} cache")
        if not ids:
            raise ValueError("empty prompt")
        row = RowHandle(list(ids), max_tokens, tuple(sampling), eos_id, stream_q, scheduler=self.id)
        with self.cond:
            if self.dead is not None:
                raise RuntimeError("scheduler worker died") from self.dead
            self.queue.append(row)
            self.cond.notify()
        return row

    @contextlib.contextmanager
    def paused(self):
        """Holds the worker at the top of its loop while the block runs: it has returned to
        the top before the block starts, so no launch of its own starts or is in progress
        meanwhile (what it queued before may still run on the card), and no row is taken into
        a slot. A profiler started or stopped inside sees no launch in flight."""
        with self.cond:
            self._hold = True
            self.cond.notify_all()
            while not self._held and self.dead is None and self.worker.is_alive():
                self.cond.wait(timeout=0.1)
        try:
            yield
        finally:
            with self.cond:
                self._hold = False
                self.cond.notify_all()

    def close(self):
        with self.cond:
            self._stop = True
            self.cond.notify()
        self.worker.join(timeout=60)

    # -- worker side ---------------------------------------------------------

    def _match_prefix(self, ids: list[int]) -> tuple[int, ...] | None:
        """Longest registered key that is a PROPER prefix of ids (at least one suffix
        token must remain: the admission samples from its last position)."""
        best = None
        for key in self.prefixes:
            n = len(key)
            if n < len(ids) and (best is None or n > len(best)) and tuple(ids[:n]) == key:
                best = key
        return best

    def _take_prefix(self, row: RowHandle):
        """(prefix cache, P0) of the longest match for the row's prompt, counted as a hit (and
        as the row's ``reused``), or None."""
        hit = self._match_prefix(row.ids) if self.prefix_cap else None
        if hit is None:
            return None
        entry = self.prefixes[hit]
        self._lru += 1
        entry[2] = self._lru
        self.prefix_hits += 1
        self.prefix_tokens_reused += entry[1]
        row.reused = entry[1]
        return entry[0], entry[1]

    def _harvest_prefix(self, slot: int, ids: list[int], snap=None):
        """Register the prompt's longest aligned proper prefix from the freshly admitted
        lane (admission wrote positions [0, P)) with ``snap``, the lanes' states at P0: an
        entry is (K/V, snap), snap () for a decoder without lanes; a hybrid's prefix whose
        states were not taken (None) is not registered."""
        p0 = (len(ids) - 1) // self.prompt_multiple * self.prompt_multiple
        if p0 < self.prompt_multiple:
            return
        key = tuple(ids[:p0])
        self._lru += 1
        if key in self.prefixes:
            self.prefixes[key][2] = self._lru
            return
        if snap is None and self.inputs.snap:
            return
        with spans.on_device("device.copy"):
            cache = slice_prefix(self.state[0], slot, p0)
        self.prefixes[key] = [(cache, snap or ()), p0, self._lru]
        while len(self.prefixes) > self.prefix_cap:
            self._evict()

    def _evict(self):
        """Drop the least recently used prefix."""
        del self.prefixes[min(self.prefixes, key=lambda k: self.prefixes[k][2])]

    def _snap_at(self, ids: list[int], start: int, end: int) -> int:
        """A hybrid's snapshot offset in the span [start, end) of ``ids``: where the span ends
        at or past the harvest point P0 (after start) and P0's prefix is not kept yet; else -1."""
        pm = self.prompt_multiple
        p0 = (len(ids) - 1) // pm * pm
        if not (self.inputs.snap and self.prefix_cap and p0 >= pm and start < p0 <= end):
            return -1
        return -1 if tuple(ids[:p0]) in self.prefixes else p0 - start

    def _stash(self):
        """A copy of the snapshot the admission program just wrote (``inputs.snap``), or None.
        The prefix cache's entries and the snapshots still waiting for their rows' installs keep
        at most ``prefix_cap`` snapshots together: the least recently used entries make room,
        and where the waiting ones fill it no copy is made (that prefix is not registered)."""
        waiting = sum(st.snap is not None for st in self.admitting.values())
        while self.prefixes and len(self.prefixes) + waiting >= self.prefix_cap:
            self._evict()
        if waiting >= self.prefix_cap:
            return None
        with spans.on_device("serve.snapshot"):
            snap = tuple(t.clone() for t in self.inputs.snap)
        self.state_snapshots += 1
        self.state_bytes_copied += sum(t.nbytes for t in snap)
        return snap

    def _restore(self, slot: int, entry):
        """A prefix hit's K/V; its states at P0 (a hybrid's) go into the slot's lanes first."""
        kv, snap = entry
        if snap:
            with spans.on_device("serve.restore"):
                for lanes, t in zip(self.state[7:], snap):
                    lanes[:, slot].copy_(t)
            self.prefix_state_hits += 1
            self.state_bytes_copied += sum(t.nbytes for t in snap)
        return kv

    def _admit(self, slot: int, row: RowHandle):
        hit = self._take_prefix(row)
        kw = dict(prompt_multiple=self.prompt_multiple, pad_id=self.pad_id, eager=self.eager)
        if hit is not None:
            cache, p0 = hit
            at = self._snap_at(row.ids, p0, len(row.ids))
            first, self.state = admit_row_prefix(self.model, self.state, self.inputs, slot, self._restore(slot, cache),
                                                 p0, row.ids[p0:], row.sampling, row.eos_id, self.generator,
                                                 snap_at=at, **kw)
        else:
            at = self._snap_at(row.ids, 0, len(row.ids))
            first, self.state = admit_row(self.model, self.state, self.inputs, slot, row.ids, row.sampling,
                                          row.eos_id, self.generator, snap_at=at, **kw)
        self._activate(slot, row, int(first), self._stash() if at > 0 else None)

    def _start_prefill(self, slot: int, row: RowHandle):
        """Chunked-prefill admission: queued for chunks from position 0, or from P0 over a
        prefix hit's K/V (a hybrid's states restored into the slot's lanes)."""
        hit = self._take_prefix(row)
        self.admitting[slot] = (_Admitting(row, 0) if hit is None
                                else _Admitting(row, hit[1], self._restore(slot, hit[0])))

    def _hold_working_row(self, slot: int):
        """Make the working row hold ``slot``'s positions [0, next): the slot that held it
        parks its own in a pooled row first. Plain copies of host-known extents, outside the
        programs."""
        inputs = self.inputs
        if inputs.owner == slot:
            return
        other = self.admitting.get(inputs.owner)
        if other is not None:
            if other.parked is None:
                other.parked = inputs.lease()
            other.src = inputs.pool[other.parked]
            copy_positions(other.src, inputs.work, other.next)
        st = self.admitting[slot]
        if st.src is not None:
            copy_positions(inputs.work, st.src, st.next)
        inputs.owner = slot

    def _advance_prefill(self, slot: int):
        """ONE prefill chunk of an admitting slot (C tokens, the last chunk padded); after the
        last, sample the first token, install the row into the lane and go live."""
        st = self.admitting[slot]
        ids = st.row.ids
        start, end = st.next, min(st.next + self.prefill_chunk, len(ids))
        at = self._snap_at(ids, start, end)
        with spans.span("serve.prefill_chunk", st.row.id):
            self._hold_working_row(slot)
            prefill_chunk(self.model, self.inputs, ids[start:end], start, self.prefill_chunk, pad_id=self.pad_id,
                          eager=self.eager, state=self.state, slot=slot, snap_at=at)
            if at > 0:
                st.snap = self._stash()
        self.prefill_dispatches += 1
        st.next = end
        if end == len(ids):
            with spans.span("serve.install", st.row.id):
                first, self.state = install_row(self.model, self.state, slot, self.inputs, len(ids),
                                                st.row.sampling, st.row.eos_id, self.generator, eager=self.eager)
                if st.parked is not None:
                    self.inputs.release(st.parked)
                self.inputs.owner = None
                del self.admitting[slot]
                self._activate(slot, st.row, int(first), st.snap)

    def _budget_cap(self, row: RowHandle) -> int:
        """Decode budget capped by the cache (the prompt took P positions, the first
        token sits at P)."""
        return min(row.max_tokens, self.config.max_seq_len - len(row.ids))

    def _activate(self, slot: int, row: RowHandle, first: int, snap=None):
        """Go-live bookkeeping once a row's lane and first token exist (``snap``: a hybrid's
        states at the harvest point)."""
        self.rows[slot] = row
        self.sampling[slot] = row.sampling
        self.eos[slot] = row.eos_id
        self.budget[slot] = self._budget_cap(row)
        self.emitted_seen[slot] = 1
        self.admissions += 1
        row.tokens.append(first)
        row.t_first = spans.now()
        self._deliver(row, [first])
        if self.prefix_cap:
            self._harvest_prefix(slot, row.ids, snap)
        if row.tokens[-1] == row.eos_id or len(row.tokens) >= self.budget[slot]:
            # the lane freezes on its own within a step: free the slot now
            self._finish(slot)

    @staticmethod
    def _deliver(row: RowHandle, new: list[int]):
        if row.stream_q is not None and new:
            row.stream_q.put(list(new))

    def _finish(self, slot: int):
        row = self.rows[slot]
        self.rows[slot] = None
        self.eos[slot] = -1
        if row is not None:
            row.end_spans()
            if row.stream_q is not None:
                row.stream_q.put(None)
            row.event.set()

    def _row_tensors(self):
        """(temperature, top_k, top_p, min_p, eos, budget) [N] on the device, the host
        mirrors copied in from this chunk's pinned buffers (double-buffered: the copy
        queued two chunks ago has run, since its chunk was collected)."""
        t, k, p, mp = zip(*self.sampling)
        f32, i64 = self.row_params_host[self.dispatches % 2]
        f32.copy_(torch.tensor([t, p, mp], dtype=torch.float32))
        i64.copy_(torch.tensor([k, self.eos, self.budget], dtype=torch.int64))
        dev_f32, dev_i64 = self.row_params
        with spans.on_device("device.copy"):
            dev_f32.copy_(f32, non_blocking=True)
            dev_i64.copy_(i64, non_blocking=True)
        return dev_f32[0], dev_i64[0], dev_f32[1], dev_f32[2], dev_i64[1], dev_i64[2]

    def _dispatch_chunk(self):
        """One decode chunk over every slot -> (tokens [N, W], emitted [N], done [N]) on
        the device, not yet synced, which the next chunk overwrites (``_stage`` copies them
        out). A subclass substitutes its own chunk (speculative rounds) under the same
        delivery contract: each row's new tokens are the [:emitted delta] prefix of its
        tokens row."""
        toks, self.state = decode_rows(self.model, self.state, self.chunk_size, self.generator, *self._row_tensors(),
                                       pad_id=self.pad_id, eager=self.eager)
        self.dispatches += 1
        return toks, self.state[4], self.state[3]

    def _stage(self, chunk) -> tuple:
        """Copies of a dispatched chunk's tensors, queued behind it before anything else can
        write them (the next dispatch, an admission), and the event that marks them done: on
        the card into pinned host memory, so that collecting waits for this chunk alone."""
        if self.device.type != "cuda":
            return (*(t.clone() for t in chunk), None)
        with spans.on_device("device.copy"):
            host = tuple(t.to("cpu", non_blocking=True) for t in chunk)
        done = torch.cuda.Event()
        done.record()
        return (*host, done)

    def _collect(self, chunk):
        """Wait for one dispatched chunk's copies and deliver it. ``chunk`` carries the row
        list AT DISPATCH TIME: a slot whose occupant changed since (its lane was dead in
        this chunk) is skipped."""
        toks_h, emitted_h, done_h, copied, snap = chunk
        if copied is not None:
            copied.synchronize()
        if self.clock is not None:
            self.clock.collect()
        toks, emitted, done = toks_h.tolist(), emitted_h.tolist(), done_h.tolist()
        for slot, row in enumerate(snap):
            if row is None or row is not self.rows[slot]:
                continue
            n_new = int(emitted[slot] - self.emitted_seen[slot])
            self.emitted_seen[slot] = emitted[slot]
            new = [int(t) for t in toks[slot][:n_new]]
            row.tokens.extend(new)
            self._deliver(row, new)
            if done[slot]:
                self._finish(slot)

    def _idle(self, inflight) -> bool:
        return (not self._stop and not self.queue and not self.admitting and all(r is None for r in self.rows)
                and inflight is None)

    def _run(self):
        clock = None
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # this thread's launches go to the model's card
            clock = self.clock = spans.DeviceClock(self.device)
            clock.bind()
            clock.settle()
        inflight = None  # (toks, emitted, done, copy event, rows snapshot) of the chunk not yet collected
        pending: list[RowHandle] = []  # taken from the queue, not yet admitting (a failed admission's row among them)
        try:
            with torch.inference_mode():
                while True:
                    if clock is not None and self._idle(inflight):
                        clock.settle()  # nothing in flight: anchor the device's clock again
                    with self.cond:
                        while self._hold or self._idle(inflight):
                            if self._hold and not self._held:
                                self._held = True
                                self.cond.notify_all()
                            self.cond.wait()
                        self._held = False
                        if self._stop:
                            break
                        pending = self.queue
                        self.queue = []
                    # admit into free slots; overflow returns to the queue (slots freed by
                    # the chunk in flight are reused on the next iteration)
                    for slot in range(self.n_slots):
                        if pending and self.rows[slot] is None and slot not in self.admitting:
                            row = pending[0]
                            row.t_slot, row.slot = spans.now(), slot
                            with spans.span("serve.admit", row.id):
                                (self._start_prefill if self.prefill_chunk else self._admit)(slot, row)
                            pending.pop(0)
                    if pending:
                        with self.cond:
                            self.queue = pending + self.queue
                        pending = []
                    # one prefill chunk per admitting slot: co-tenants decode in between
                    for slot in list(self.admitting):
                        self._advance_prefill(slot)
                    nxt = None
                    if any(r is not None for r in self.rows):
                        with spans.span("serve.dispatch"):
                            nxt = (*self._stage(self._dispatch_chunk()), list(self.rows))
                    if inflight is not None:
                        self._collect(inflight)
                    inflight = nxt
                if inflight is not None:  # stop requested: flush the chunk in flight
                    self._collect(inflight)
                if clock is not None:
                    clock.settle()
                with self.cond:
                    left = ([r for r in self.rows if r is not None] + [st.row for st in self.admitting.values()]
                            + pending + self.queue)
                for row in left:
                    row.end_spans()
        except Exception as e:  # the worker must never die silently
            with self.cond:
                self.dead = e
                broken = ([r for r in self.rows if r is not None]
                          + [st.row for st in self.admitting.values()] + pending + self.queue)
                self.rows = [None] * self.n_slots
                self.admitting = {}
                self.queue = []
            for row in broken:
                row.error = e
                row.end_spans()
                if row.stream_q is not None:
                    row.stream_q.put(None)
                row.event.set()
        finally:
            if clock is not None:
                clock.unbind()
