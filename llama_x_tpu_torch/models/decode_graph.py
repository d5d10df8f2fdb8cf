"""Decode steps as captured CUDA graphs: the port's counterpart of the JAX package's
jitted ``lax.scan`` over single-token steps (llama_x_tpu/models/generate.py: the whole
generation is one compiled program; ``decode_chunk``; llama_x_tpu/serve/continuous.py:
``decode_rows``, jitted with its state donated), and of its jitted speculative rounds
(llama_x_tpu/serve/speculative.py: ``spec_chunk``'s ``lax.scan``;
llama_x_tpu/models/speculative.py: ``generate_speculative``'s ``while_loop``).

A step body reads and writes only static buffers: the KV cache, the last token, the
position, the done mask (for the scheduler's rows also the tokens emitted, the per-row
sampling tensors, stop tokens and budgets) and a ring of the tokens each step emits with
its write index on the device. What the body allocates comes from the graph's private
memory pool during capture (the kernels' split-K and split-KV partials among it), so on the
card one step is one ``CUDAGraph.replay()``: no Python, no per-kernel dispatch.

- Keys, ``jax.jit``'s static arguments: the address, shape and dtype of every static buffer
  (so B, uniform or ragged positions, the cache type and which buffers), and what the
  caller names static (``generate``'s temperature, top_k, top_p, min_p, eos_id and pad_id;
  the scheduler's pad_id, its sampling tensors being buffers). A model keeps at most
  ``MAX_GRAPHS`` graphs, the least recently used dropped with its pool.
- Buffers for ``generate``: a prefill writes a cache the graph then reads at its captured
  address, so the runner keeps ``MAX_SLOTS`` buffer sets per model, one per (B, uniform or
  ragged, cache type), and a prefill writes into its set in place; the memory stays held
  between requests (at 8B width, B 4 and 4096 positions a bf16 cache is 2.15 GB);
  ``generate_speculative`` leases its own sets (both caches and its round's buffers). A new
  prefill on a set supersedes the state an earlier one handed out (``DecodeState.lease``),
  as JAX's donation does: decoding the old one raises.
- Weights: a graph reads them at their captured addresses. Each call fingerprints the model
  (its config and the address of every parameter and buffer) once; when that changes (a
  ``load_state_dict(assign=True)``, a LoRA merge, an HF import, ``set_max_seq_len``) the
  model's graphs and buffer sets are dropped and the next call captures again. Updates in
  place (an optimizer step) keep the addresses, and a replay reads the new values. A
  speculative round also reads a draft model (``others``): the draft's fingerprint joins
  the round's key, and when it changes the graphs that read the draft are dropped.
- Capture: the first call of a key runs its first step eagerly on a side stream (every lazy
  allocation, cuBLAS workspace and ``cudaFuncSetAttribute`` happens there, and the step is
  a real one), then captures the body on that stream with ``capture_error_mode=
  "thread_local"``: the scheduler's and the HTTP server's worker threads capture while
  other threads run. The kernel wrappers launch on the current stream, so they follow the
  capture; kernel arguments, the TMA descriptors among them (``CUtensorMap`` passed as
  ``__grid_constant__``), are copied into the graph's nodes by value.
- Sampling draws from a ``torch.Generator``. A graph draws from a generator of the runner's,
  registered with the graph; its seed and Philox offset are set from the caller's generator
  before the replays and handed back after, so the replays advance the offset exactly as
  the eager steps do and draw the same bits.
- Launch counts: a wrapper counts where it launches its kernel (ops/launches.py). At a
  capture nothing launches: the wrappers' launches on the capturing stream go to the
  capture's tally, and every replay credits each wrapper with its tally. chip_smoke.py
  holds the credited counts to the kernels a profiler trace of the replays shows.
- No fallback: on the card a capture or a replay that fails raises with the step's name. The
  eager loop (the same body, launched op by op) runs only where the caller asks for it
  (``eager=True``) or on CPU tensors, where there is no graph and the body runs over the
  same static buffers, so the CPU tests see the aliasing a replay has.
- A model placed on a mesh (tensor-parallel serving over gloo) refuses the graph by name: its
  collectives go through host memory and cannot be captured. It decodes with ``eager=True``.
- Admissions (serve/continuous.py, serve/speculative.py: a prompt's prefill into a row cache,
  its first token and its lane; a prefill chunk): the JAX package jits each once per
  prompt-length bucket and keeps every one. Here each is a graph of a runner that the
  admission buffer set owns (``Runner(cap=None, shared_pool=True)``): every key is kept while
  the set lives, and the bucket formulas bound the keys (a few hundred at 4096 positions);
  the decode steps' runner is apart, so admissions never evict a step. The graphs share one
  memory pool, since admissions run one at a time on the scheduler's worker thread and keep
  nothing in the pool between replays.
- Prefills (``generate``'s prefill and first token, llama_x_tpu/models/generate.py:
  ``prefill_start``; ``generate_speculative``'s two prefills, its first token and the fill of
  its state, inside the JAX package's one jitted call): a graph per prompt shape of a second
  runner on the model (``prefill_runner_of``), apart from the decode steps', so a prefill key
  never evicts a step. A prefill body reads key-owned input buffers (``PrefillInputs``: the
  ids, the modality prefix, the prompt lengths), into which each request's tensors are
  copied, and writes the cache, token, position and done mask of the buffer set the request
  leased from the decode steps' runner. Every key is kept, as JAX keeps every shape it
  compiled: a key's first use costs an eager prefill and a capture, so a cap would make a
  caller that cycles through more shapes than it holds (``generate_cli``'s prompt lengths,
  the HTTP server's buckets of P and B) pay that on every request. The graphs share one
  pool, since prefills of one model run one at a time and keep nothing in it between
  replays: it is as large as the largest prefill's transients, not their sum, and a key
  adds its graph and its input buffers. A key holds the addresses of the buffer set it
  writes, so a graph over a set the decode runner dropped is replayed only over a set made
  at the same addresses, shapes and dtypes, which it then fills as it would its own.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict

import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.parallel.tensor import mesh_of
from llama_x_tpu_torch.utils import spans

MAX_GRAPHS = 8  # captured steps kept per model
MAX_SLOTS = 2  # generate's buffer sets kept per model


def cache_tensors(kv_cache) -> list[torch.Tensor]:
    """Every tensor of a cache (bf16 tensors, or int8 (data, scale) pairs)."""
    return [t for side in kv_cache for t in (side if isinstance(side, tuple) else (side,))]


@dataclasses.dataclass(eq=False)
class DecodeState:
    """What ``decode_chunk`` carries between calls, the JAX package's (kv_cache, tok, pos,
    done), each tensor written in place: the cache, the last token [B], the position (0-d:
    every row at one depth; [B]: ragged), the done mask [B], and the ring of emitted tokens
    [B, max_seq_len] with its write index [1]. ``slot``: the runner's buffer set this state
    leases (None: the state owns its buffers) at lease number ``lease``."""

    cache: tuple
    tok: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    ring: torch.Tensor
    at: torch.Tensor
    slot: DecodeState | None = None
    lease: int = 0

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return (*cache_tensors(self.cache), self.tok, self.pos, self.done, self.ring, self.at)


def new_state(model: llama.Llama, batch: int, ragged: bool, cache_dtype) -> DecodeState:
    """Fresh buffers for a decode of ``batch`` rows on the model's device."""
    dev = model.device
    zeros = lambda *shape, dtype=torch.int64: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
    cache = llama.init_kv_cache(model.config, batch, dtype=cache_dtype, device=dev,
                                kv_heads=llama.local_kv_heads(model))
    return DecodeState(cache, zeros(batch), zeros(batch) if ragged else zeros(), zeros(batch, dtype=torch.bool),
                       zeros(batch, model.config.max_seq_len), zeros(1))


@dataclasses.dataclass(eq=False)
class PrefillInputs:
    """A prefill's inputs at fixed addresses: the prompt ``ids`` [B, P] (int64), the modality
    ``prefix`` [B, T, D] in the embeddings' dtype and the prompt lengths ``lens`` [B] (int64) of
    a ragged batch (None where the key has none)."""

    ids: torch.Tensor
    prefix: torch.Tensor | None = None
    lens: torch.Tensor | None = None

    @classmethod
    def like(cls, model: llama.Llama, ids, prefix=None, lens=None) -> PrefillInputs:
        """Empty buffers of the shapes of a request's tensors on the model's device."""
        dev = model.device
        return cls(torch.empty(ids.shape, dtype=torch.int64, device=dev),
                   None if prefix is None else torch.empty(prefix.shape, dtype=model.tok_embeddings.dtype, device=dev),
                   None if lens is None else torch.empty(lens.shape, dtype=torch.int64, device=dev))

    def fill(self, ids, prefix=None, lens=None) -> PrefillInputs:
        """A request's tensors copied in; returns the buffers."""
        for dst, src in ((self.ids, ids), (self.prefix, prefix), (self.lens, lens)):
            if dst is not None:
                dst.copy_(src)
        return self

    def buffers(self) -> tuple[torch.Tensor, ...]:
        return tuple(t for t in (self.ids, self.prefix, self.lens) if t is not None)


def on_card(t: torch.Tensor) -> bool:
    """Where a step is captured and replayed: CUDA tensors."""
    return t.is_cuda


def refuse_mesh(model: llama.Llama, name: str) -> None:
    if mesh_of(model) is not None:
        raise ValueError(f"{name}: the model is placed on a mesh, whose collectives go through host memory and "
                         "cannot be captured in a CUDA graph; decode it with eager=True")


class Captured:
    """One step recorded by ``capture()`` (which returns an object with ``replay()``) on
    ``stream`` (default: the current stream), with the launches each replay runs
    (``credits``: {wrapper: launches}, the capture's tally on that stream)."""

    def __init__(self, capture, stream=None):
        with launches.tally(stream) as tally:
            self.graph = capture()
        self.credits = dict(tally)

    def replay(self, n: int, **attrs) -> None:
        """``n`` replays; on a thread with a ``spans.DeviceClock`` (a scheduler's worker on the
        card) each one a ``device.replay`` interval with ``attrs``."""
        for _ in range(n):
            with spans.on_device("device.replay", one_launch=True, **attrs):
                self.graph.replay()
            for fn, k in self.credits.items():
                fn.launches += k


def _key_of(buffers) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in buffers)


def _fingerprint(model: llama.Llama) -> tuple:
    """A model's config and the address of every parameter and buffer: what a graph that
    reads its weights depends on."""
    return (model.config, tuple(t.data_ptr() for t in model.parameters()),
            tuple(t.data_ptr() for t in model.buffers()))


class _Entry:
    """A captured step, the addresses of the buffers it reads and writes, the other models
    whose weights it reads (their ``id``s: a speculative round's draft), and its capture's
    seconds and pool bytes (as ``stats()`` lists them)."""

    def __init__(self, captured: Captured, ptrs: set):
        self.captured, self.ptrs, self.others = captured, ptrs, frozenset()
        self.capture_s = self.pool_bytes = None


class Runner:
    """Captured graphs, at most ``cap`` of them (least recently used first; None: every key
    kept), and ``generate``'s buffer sets (or, in a prefill runner, each key's input buffers).
    ``shared_pool``: every graph in one memory pool, made at the first capture (for programs
    that run one at a time and keep nothing in it between replays). A model's decode steps:
    ``runner_of``; its prefills: ``prefill_runner_of``."""

    def __init__(self, cap: int | None = MAX_GRAPHS, shared_pool: bool = False):
        self.cap, self.shared_pool = cap, shared_pool
        self.pool = None
        self.lock = threading.Lock()
        self.fingerprint = None
        self.others: dict = {}  # id of another model a graph reads -> its fingerprint at the last call
        self.graphs: OrderedDict[tuple, _Entry] = OrderedDict()
        self.slots: OrderedDict[tuple, DecodeState] = OrderedDict()  # or another set with buffers() and lease
        self.streams: dict = {}  # device -> the side stream of warm-up and capture
        self.generators: dict = {}  # device -> the generator the graphs draw from
        self.captures = 0  # steps captured (on the CPU: none)
        self.replays = 0
        self.capture_s: list[float] = []  # capture + instantiate of each, seconds
        self.pool_bytes: list[int] = []  # device memory each capture's pool reserved

    def check(self, model: llama.Llama, others=()) -> None:
        """Drop every graph and buffer set when the model's weights moved, and the graphs
        that read one of ``others`` when its weights moved (once per call)."""
        fp_now = _fingerprint(model)
        with self.lock:
            if fp_now != self.fingerprint:
                self.graphs.clear()
                self.slots.clear()
                self.fingerprint = fp_now
            for other in others:
                fp = _fingerprint(other)
                if self.others.get(id(other), fp) != fp:
                    for k in [k for k, e in self.graphs.items() if id(other) in e.others]:
                        del self.graphs[k]
                self.others[id(other)] = fp

    def lease(self, key: tuple, make):
        """The buffer set of ``key`` (``generate``'s: (B, ragged, cache dtype)), made by
        ``make()`` on first use, handed out under a new lease number (which supersedes every
        earlier one)."""
        with self.lock:
            slot = self.slots.pop(key, None)
            if slot is None:
                slot = make()
            self.slots[key] = slot
            while len(self.slots) > MAX_SLOTS:
                _, old = self.slots.popitem(last=False)
                freed = {t.data_ptr() for t in old.buffers()}
                for k in [k for k, e in self.graphs.items() if e.ptrs & freed]:
                    del self.graphs[k]
            slot.lease += 1
            return dataclasses.replace(slot, slot=slot, lease=slot.lease)

    def inputs(self, key: tuple, make):
        """The input buffers of ``key`` (a prefill's ``PrefillInputs``), made by ``make()`` on
        first use and kept with the key's graph."""
        with self.lock:
            if key not in self.slots:
                self.slots[key] = make()
            return self.slots[key]

    def replay(self, model, name: str, buffers, key: tuple, body, n: int, generator, draws: bool,
               others=()) -> None:
        """``n`` steps on the card: the captured graph of ``key`` replayed, captured first
        (after one eager step) where the runner has none. ``others``: the other models the
        body reads, whose weights' addresses join the key."""
        dev = buffers[0].device
        full_key = (name, key, _key_of(buffers), tuple(_fingerprint(m) for m in others))
        src = own = generator
        if draws:  # the graphs draw from the runner's generator, set from the caller's
            src = generator if generator is not None else (
                torch.cuda.default_generators[dev.index] if dev.type == "cuda" else torch.default_generator)
            if dev not in self.generators:
                self.generators[dev] = torch.Generator(device=dev)
            own = self.generators[dev]
            own.set_state(src.get_state())
        with self.lock:
            entry = self.graphs.get(full_key)
            if entry is not None:
                self.graphs.move_to_end(full_key)
        if entry is None:
            entry = self._capture(model, name, buffers, body, own, draws)
            entry.others = frozenset(id(m) for m in others)
            n -= 1
            with self.lock:
                self.graphs[full_key] = entry
                while self.cap is not None and len(self.graphs) > self.cap:
                    self.graphs.popitem(last=False)
        try:
            entry.captured.replay(n, graph=name)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: CUDA graph replay failed: {e}") from e
        self.replays += n
        if draws:
            src.set_state(own.get_state())

    def stats(self) -> dict:
        """Captures, replays, graphs and buffer sets held, the bytes the sets hold between
        requests, and each capture's seconds and pool bytes (with a shared pool: its growth
        at each capture)."""
        held = sum(t.nbytes for slot in self.slots.values() for t in slot.buffers())
        return dict(captures=self.captures, replays=self.replays, graphs=len(self.graphs), slots=len(self.slots),
                    slot_bytes=held, capture_s=list(self.capture_s), pool_bytes=list(self.pool_bytes))

    def _capture(self, model, name, buffers, body, own, draws) -> _Entry:
        """One eager step on the side stream, then the body captured there."""
        dev = buffers[0].device
        if dev not in self.streams:
            self.streams[dev] = torch.cuda.Stream(dev)
        stream = self.streams[dev]
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            body(model, own)  # the first step, eager: warm-up and a real step
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # so that the reserved memory's growth is the pool's
        reserved = torch.cuda.memory_reserved(dev)
        if self.shared_pool and self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()

        def capture():
            graph = torch.cuda.CUDAGraph()
            if draws:
                graph.register_generator_state(own)
            with torch.cuda.graph(graph, pool=self.pool, stream=stream, capture_error_mode="thread_local"):
                body(model, own)
            return graph

        t0 = time.perf_counter()
        try:
            captured = Captured(capture, stream)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: CUDA graph capture failed: {e}") from e
        capture_s = time.perf_counter() - t0
        current.wait_stream(stream)
        entry = _Entry(captured, {t.data_ptr() for t in buffers})
        entry.capture_s, entry.pool_bytes = capture_s, torch.cuda.memory_reserved(dev) - reserved
        self.captures += 1
        self.capture_s.append(entry.capture_s)
        self.pool_bytes.append(entry.pool_bytes)
        return entry


_runners_lock = threading.Lock()


def _runners(model: llama.Llama) -> tuple[Runner, Runner]:
    """The model's decode-step and prefill runners, made together on first use and kept on
    the model."""
    with _runners_lock:
        d = model.__dict__
        if "_decode_runner" not in d:
            d["_decode_runner"] = Runner()
            d["_prefill_runner"] = Runner(cap=None, shared_pool=True)
        return d["_decode_runner"], d["_prefill_runner"]


def runner_of(model: llama.Llama) -> Runner:
    """The model's decode-step runner, made on first use and kept on the model."""
    return _runners(model)[0]


def prefill_runner_of(model: llama.Llama) -> Runner:
    """The model's prefill runner: every prefill key kept, in one pool."""
    return _runners(model)[1]


def prefill_inputs(model: llama.Llama, key: tuple, ids, prefix=None, lens=None, others=()) -> PrefillInputs:
    """The input buffers of prefill ``key`` on the model's prefill runner (made like the
    request's tensors on first use) with the request's tensors copied in. The runner is
    checked first, so a weight change drops its graphs before the buffers are taken."""
    runner = prefill_runner_of(model)
    runner.check(model, others)
    return runner.inputs(key, lambda: PrefillInputs.like(model, ids, prefix, lens)).fill(ids, prefix, lens)


def lease(model: llama.Llama, key: tuple, make):
    """A request's static buffers, the set of ``key`` made by ``make()`` on first use (the
    caller refuses a mesh first)."""
    runner = runner_of(model)
    runner.check(model)
    return runner.lease(key, make)


def run(model: llama.Llama, name: str, buffers, key: tuple, body, n: int, generator, *, eager: bool,
        draws: bool, others=(), runner: Runner | None = None) -> None:
    """``n`` steps of ``body(model, generator)``, a step that reads and writes only
    ``buffers`` (in place) and depends besides on ``key`` and the weights of ``model`` and
    ``others`` alone. ``eager``: the body launched op by op. Otherwise on the card a replay
    of its captured graph each step; on CPU tensors the body over the same buffers.
    ``draws``: the body samples from the generator. ``runner``: the runner that keeps the
    graph (default: the model's, ``runner_of``)."""
    if n <= 0:
        return
    if not eager:
        for m in (model, *others):
            refuse_mesh(m, name)
        runner = runner or runner_of(model)
        runner.check(model, others)
        if on_card(buffers[0]):
            runner.replay(model, name, buffers, key, body, n, generator, draws, others)
            return
    for _ in range(n):
        body(model, generator)


def release(model: llama.Llama) -> None:
    """Drop the model's runners: their graphs (with their pools), buffer sets and counts."""
    with _runners_lock:
        model.__dict__.pop("_decode_runner", None)
        model.__dict__.pop("_prefill_runner", None)


def stats(model: llama.Llama) -> dict:
    """The model's decode-step runner's ``stats()``."""
    return runner_of(model).stats()


def prefill_stats(model: llama.Llama) -> dict:
    """The model's prefill runner's ``stats()`` (``slot_bytes``: the keys' input buffers)."""
    return prefill_runner_of(model).stats()
