"""Continuous batching: rows join and leave the running decode batch at chunk
boundaries (port of llama_x_tpu/serve/continuous.py).

- ONE persistent decode state over a fixed number of slots. The KV cache is
  [L, n_slots, Hkv, S_max, hd] (bf16, or int8 with f32 scales), preallocated once and
  written in place.
- Admission prefills one prompt row straight into its slot's lane of the shared cache
  (the prefill attends over the fresh K/V only, so the lane's stale entries never show)
  and samples the first token. With a prefix-cache hit the harvested prefix K/V is copied
  into the lane and only the suffix runs, over the cache (the flash kernel's offsets form,
  or the decode kernel for a suffix of at most ``MAX_SQ`` tokens).
- Chunked prefill (``prefill_chunk`` > 0): an admission runs one chunk of its prompt per
  scheduler iteration into a private row cache (the decode steps of the other slots write
  every lane, so a lane cannot be filled in pieces while they run), then the row cache is
  copied into the lane. The first chunk is a prefill (flash self-attention); each later one
  attends over the row cache through the flash kernel's offsets form.
- Decoding is a chunk of single-token steps over every slot with every per-request
  quantity held as an [n_slots] tensor: sampling parameters, stop token, token budget and
  the done mask. Nothing in a step reads back from the device; the host syncs once per
  chunk, when it collects the chunk's tokens. On the card each step is one replay of the
  step's captured CUDA graph (models/decode_graph.py), the state and the per-row tensors its
  static buffers.
- Between chunks the host appends each row's new tokens (the freeze is monotone, so a
  row's new tokens are a prefix of its chunk row of length emitted_after -
  emitted_before), streams them, frees finished slots and admits queued rows.

PyTorch runs eagerly, so nothing is padded to a shape bucket: prompts and chunks run at
their own lengths, and ``prompt_multiple`` only aligns the harvested prefixes. Attention,
RoPE and the cache writes are row-local, so a row's greedy output equals an unbatched
``generate`` of its prompt whatever shares its batch (held by the tests against the JAX
scheduler and against ``generate``). The JAX package's threefry draws are not
reproduced: sampled rows follow the same law from a ``torch.Generator``.
"""

from __future__ import annotations

import threading

import torch

from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.decode_graph import cache_tensors
from llama_x_tpu_torch.models.generate import gumbel_argmax
from llama_x_tpu_torch.ops.attention import MaskInfo
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
# all int64 but done: the static buffers of the captured decode step, written in place
# ---------------------------------------------------------------------------


def init_state(config: llama.LlamaConfig, n_slots: int, cache_dtype=torch.bfloat16, device=None,
               kv_heads: int | None = None):
    """The scheduler's state over ``n_slots`` lanes; ``kv_heads``: a tensor-parallel rank's
    local kv heads (``llama.local_kv_heads``). ``ring`` holds each decode chunk's tokens,
    ``at`` its write index."""
    dev = resolve_device(device)
    zeros = lambda *shape: torch.zeros(shape or (n_slots,), dtype=torch.int64, device=dev)  # noqa: E731
    return (llama.init_kv_cache(config, n_slots, dtype=cache_dtype, device=dev, kv_heads=kv_heads), zeros(), zeros(),
            torch.ones(n_slots, dtype=torch.bool, device=dev), zeros(),  # empty slots are "done"
            zeros(n_slots, config.max_seq_len), zeros(1))


def lane(kv_cache, slot: int):
    """The cache restricted to one slot, as a [L, 1, ...] view (writes land in the cache)."""
    def one(side):
        return tuple(t[:, slot:slot + 1] for t in side) if isinstance(side, tuple) else side[:, slot:slot + 1]
    return one(kv_cache[0]), one(kv_cache[1])


def row_cache(config: llama.LlamaConfig, length: int, cache_dtype, device, kv_heads: int | None = None):
    """A private single-row cache of ``length`` positions (a chunked prefill's)."""
    return llama.init_kv_cache(config.replace(max_seq_len=length), 1, dtype=cache_dtype, device=device,
                               kv_heads=kv_heads)


def copy_positions(dst_cache, src_cache, n: int) -> None:
    """Positions [0, n) of every tensor of ``src_cache`` into ``dst_cache`` (both [L, 1, ...])."""
    for d, s in zip(cache_tensors(dst_cache), cache_tensors(src_cache)):
        d[:, :, :, :n].copy_(s[:, :, :, :n])


def _activate_row(state, slot: int, first: torch.Tensor, total: int, eos_id: int) -> None:
    tok, pos, done, emitted = state[1:5]
    tok[slot] = first
    pos[slot] = total
    done[slot] = first == eos_id
    emitted[slot] = 1


@torch.inference_mode()
def sample_first(model: llama.Llama, h_last, sampling, generator: torch.Generator | None = None):
    """A row's first token from the hidden state at its prompt's last position [1, 1, D]."""
    t, k, p, mp = sampling_tensors([sampling], model.device)
    return sample_logits_rows(llama.head(model, h_last)[:, 0], t, k, p, mp, generator)[0]


@torch.inference_mode()
def admit_row(model: llama.Llama, state, slot: int, prompt: list[int], sampling, eos_id: int,
              generator: torch.Generator | None = None):
    """Prefill one prompt row into ``slot``'s lane and make it live -> (first token, state).
    The prefill attends over its fresh K/V only, so what the lane held before is never
    read, and the decode steps overwrite each later position before they expose it."""
    P = len(prompt)
    ids = torch.tensor([prompt], dtype=torch.long, device=model.device)
    x = llama.embed(model, ids)
    h, _ = llama.trunk(model, x, MaskInfo(causal=True), lane(state[0], slot),
                       input_pos=torch.arange(P, device=model.device), prefill=True)
    first = sample_first(model, h[:, -1:], sampling, generator)
    _activate_row(state, slot, first, P, eos_id)
    return first, state


def _suffix_over_cache(model, cache, suffix: list[int], start: int):
    """Run ``suffix`` at positions [start, start + len) over a [L, 1, ...] cache that holds
    positions [0, start): causal q_positions and kv_len, the read of the cache that the
    flash kernel's offsets form takes (the decode kernel up to MAX_SQ rows)."""
    n = len(suffix)
    ids = torch.tensor([suffix], dtype=torch.long, device=model.device)
    x = llama.embed(model, ids)
    qpos = torch.arange(start, start + n, device=model.device)
    mask = MaskInfo(causal=True, q_positions=qpos[None], kv_len=torch.tensor([start + n], device=model.device))
    h, _ = llama.trunk(model, x, mask, cache, input_pos=qpos)
    return h[:, -1:]


@torch.inference_mode()
def admit_row_prefix(model: llama.Llama, state, slot: int, prefix_kv, prefix_len: int, suffix: list[int], sampling,
                     eos_id: int, generator: torch.Generator | None = None):
    """Admit a row whose first ``prefix_len`` tokens have harvested K/V: copy the prefix
    into the lane and run ONLY the suffix, over the cache -> (first token, state). By
    causality the prefix's K/V are what a full prefill of the prompt would write."""
    row = lane(state[0], slot)
    copy_positions(row, prefix_kv, prefix_len)
    h_last = _suffix_over_cache(model, row, suffix, prefix_len)
    first = sample_first(model, h_last, sampling, generator)
    _activate_row(state, slot, first, prefix_len + len(suffix), eos_id)
    return first, state


@torch.inference_mode()
def prefill_chunk(model: llama.Llama, cache, chunk: list[int], start: int):
    """One chunk of an incremental prefill into a single-row cache -> h at the chunk's last
    position [1, 1, D]. A chunk at position 0 is a prefill (flash self-attention over its
    fresh K/V); a later one attends over the whole row cache (positions [0, start + len))."""
    if start == 0:
        ids = torch.tensor([chunk], dtype=torch.long, device=model.device)
        x = llama.embed(model, ids)
        h, _ = llama.trunk(model, x, MaskInfo(causal=True), cache,
                           input_pos=torch.arange(len(chunk), device=model.device), prefill=True)
        return h[:, -1:]
    return _suffix_over_cache(model, cache, chunk, start)


@torch.inference_mode()
def install_row(state, slot: int, cache, first: torch.Tensor, total: int, eos_id: int):
    """Copy a fully prefilled row cache (``total`` positions) into lane ``slot`` and make it live."""
    copy_positions(lane(state[0], slot), cache, total)
    _activate_row(state, slot, first, total, eos_id)
    return state


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
    kv_cache, tok, pos, done, emitted, ring, at = state
    temperature, top_k, top_p, min_p, eos_ids, budget = params
    S_max = model.config.max_seq_len
    x = llama.embed(model, tok[:, None])
    mask = MaskInfo(causal=True, q_positions=pos[:, None], kv_len=pos + 1)
    h, _ = llama.trunk(model, x, mask, kv_cache, input_pos=pos[:, None])
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
    at.zero_()
    dg.run(model, "decode_rows step", (*cache_tensors(state[0]), *state[1:], *params), (pad_id,),
           lambda m, gen: _rows_step(m, state, gen, params, pad_id), n_steps, generator, eager=eager, draws=True)
    return ring[:, :n_steps], state


# ---------------------------------------------------------------------------
# host-side scheduler
# ---------------------------------------------------------------------------


class RowHandle:
    """One prompt row moving through the scheduler. ``event`` fires when the row is
    finished; ``stream_q`` (optional, anything with ``put``) receives token-id lists per
    chunk and a ``None`` sentinel at the end."""

    def __init__(self, ids: list[int], max_tokens: int, sampling, eos_id: int, stream_q=None):
        if max_tokens < 1:
            raise ValueError("max_tokens must be at least 1")
        self.ids = ids
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


class _Admitting:
    """A slot mid-way through a chunked prefill: its private row cache and the next
    prompt position to run."""

    def __init__(self, row: RowHandle, cache, start: int):
        self.row, self.cache, self.next = row, cache, start


class ContinuousScheduler:
    """Admit-between-chunks serving loop over a fixed slot array.

    ``submit`` is thread-safe and does not block; a worker thread owns the device state
    and loops: admit queued rows into free slots -> one prefill chunk per admitting slot
    (chunked prefill) -> one decode chunk over all slots -> deliver tokens and free
    finished slots (one chunk later: the chunk in flight is collected after the next one
    is dispatched, so the host queues work while the device computes). On the card each
    decode step is one replay of ``decode_rows``' captured graph over the state and the six
    per-row tensors (static buffers, filled from pinned host memory each chunk);
    ``eager``: the steps launched op by op. A dispatched chunk's tokens, emitted counts and
    done mask are copied out (to pinned host memory on the card) before the next dispatch
    overwrites them, and its collection waits for that copy alone. Counters:
    ``dispatches`` (decode chunks), ``admissions``, ``prefill_dispatches`` (prefill
    chunks), ``prefix_hits`` and ``prefix_tokens_reused``."""

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
        self.state = self._init_state()
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
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def _init_state(self):
        return init_state(self.config, self.n_slots, self.cache_dtype, self.device, llama.local_kv_heads(self.model))

    # -- client side ---------------------------------------------------------

    def submit(self, ids: list[int], max_tokens: int, sampling=(0.0, 0, 1.0, 0.0), eos_id: int = -1,
               stream_q=None) -> RowHandle:
        cap = self.config.max_seq_len
        if len(ids) + 1 > cap:
            raise ValueError(f"prompt ({len(ids)} tokens) fills the {cap} cache")
        if not ids:
            raise ValueError("empty prompt")
        row = RowHandle(list(ids), max_tokens, tuple(sampling), eos_id, stream_q)
        with self.cond:
            if self.dead is not None:
                raise RuntimeError("scheduler worker died") from self.dead
            self.queue.append(row)
            self.cond.notify()
        return row

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

    def _take_prefix(self, ids: list[int]):
        """(prefix cache, P0) of the longest match, counted as a hit, or None."""
        hit = self._match_prefix(ids) if self.prefix_cap else None
        if hit is None:
            return None
        entry = self.prefixes[hit]
        self._lru += 1
        entry[2] = self._lru
        self.prefix_hits += 1
        self.prefix_tokens_reused += entry[1]
        return entry[0], entry[1]

    def _harvest_prefix(self, slot: int, ids: list[int]):
        """Register the prompt's longest aligned proper prefix from the freshly admitted
        lane (admission wrote positions [0, P))."""
        p0 = (len(ids) - 1) // self.prompt_multiple * self.prompt_multiple
        if p0 < self.prompt_multiple:
            return
        key = tuple(ids[:p0])
        self._lru += 1
        if key in self.prefixes:
            self.prefixes[key][2] = self._lru
            return
        self.prefixes[key] = [slice_prefix(self.state[0], slot, p0), p0, self._lru]
        while len(self.prefixes) > self.prefix_cap:
            oldest = min(self.prefixes, key=lambda k: self.prefixes[k][2])
            del self.prefixes[oldest]

    def _admit(self, slot: int, row: RowHandle):
        hit = self._take_prefix(row.ids)
        if hit is not None:
            cache, p0 = hit
            first, self.state = admit_row_prefix(self.model, self.state, slot, cache, p0, row.ids[p0:], row.sampling,
                                                 row.eos_id, self.generator)
        else:
            first, self.state = admit_row(self.model, self.state, slot, row.ids, row.sampling, row.eos_id,
                                          self.generator)
        self._activate(slot, row, int(first))

    def _start_prefill(self, slot: int, row: RowHandle):
        """Chunked-prefill admission: a private row cache (seeded from a prefix hit when
        one matches), queued for chunks."""
        cache = row_cache(self.config, len(row.ids), self.cache_dtype, self.device, llama.local_kv_heads(self.model))
        start = 0
        hit = self._take_prefix(row.ids)
        if hit is not None:
            copy_positions(cache, hit[0], hit[1])
            start = hit[1]
        self.admitting[slot] = _Admitting(row, cache, start)

    def _advance_prefill(self, slot: int):
        """ONE prefill chunk of an admitting slot; after the last, sample the first token,
        install the row cache into the lane and go live."""
        st = self.admitting[slot]
        ids = st.row.ids
        start, end = st.next, min(st.next + self.prefill_chunk, len(ids))
        h_last = prefill_chunk(self.model, st.cache, ids[start:end], start)
        self.prefill_dispatches += 1
        st.next = end
        if end == len(ids):
            first = sample_first(self.model, h_last, st.row.sampling, self.generator)
            self.state = install_row(self.state, slot, st.cache, first, len(ids), st.row.eos_id)
            del self.admitting[slot]
            self._activate(slot, st.row, int(first))

    def _budget_cap(self, row: RowHandle) -> int:
        """Decode budget capped by the cache (the prompt took P positions, the first
        token sits at P)."""
        return min(row.max_tokens, self.config.max_seq_len - len(row.ids))

    def _activate(self, slot: int, row: RowHandle, first: int):
        """Go-live bookkeeping once a row's lane and first token exist."""
        self.rows[slot] = row
        self.sampling[slot] = row.sampling
        self.eos[slot] = row.eos_id
        self.budget[slot] = self._budget_cap(row)
        self.emitted_seen[slot] = 1
        self.admissions += 1
        row.tokens.append(first)
        self._deliver(row, [first])
        if self.prefix_cap:
            self._harvest_prefix(slot, row.ids)
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

    def _run(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # this thread's launches go to the model's card
        inflight = None  # (toks, emitted, done, copy event, rows snapshot) of the chunk not yet collected
        try:
            with torch.inference_mode():
                while True:
                    with self.cond:
                        while (not self._stop and not self.queue and not self.admitting
                               and all(r is None for r in self.rows) and inflight is None):
                            self.cond.wait()
                        if self._stop:
                            break
                        pending = self.queue
                        self.queue = []
                    # admit into free slots; overflow returns to the queue (slots freed by
                    # the chunk in flight are reused on the next iteration)
                    for slot in range(self.n_slots):
                        if pending and self.rows[slot] is None and slot not in self.admitting:
                            if self.prefill_chunk:
                                self._start_prefill(slot, pending.pop(0))
                            else:
                                self._admit(slot, pending.pop(0))
                    if pending:
                        with self.cond:
                            self.queue = pending + self.queue
                    # one prefill chunk per admitting slot: co-tenants decode in between
                    for slot in list(self.admitting):
                        self._advance_prefill(slot)
                    nxt = None
                    if any(r is not None for r in self.rows):
                        nxt = (*self._stage(self._dispatch_chunk()), list(self.rows))
                    if inflight is not None:
                        self._collect(inflight)
                    inflight = nxt
                if inflight is not None:  # stop requested: flush the chunk in flight
                    self._collect(inflight)
        except Exception as e:  # the worker must never die silently
            with self.cond:
                self.dead = e
                broken = ([r for r in self.rows if r is not None]
                          + [st.row for st in self.admitting.values()] + self.queue)
                self.rows = [None] * self.n_slots
                self.admitting = {}
                self.queue = []
            for row in broken:
                row.error = e
                if row.stream_q is not None:
                    row.stream_q.put(None)
                row.event.set()
