"""The training step as captured CUDA graphs: the port's counterpart of the JAX trainers'
``jax.jit(make_train_step(...), donate_argnums=(0,))`` (llama_x_tpu/train/trainer.py: one
dispatch per optimizer step, the microbatches a ``lax.scan`` inside it, the state donated).

train/trainer.py writes the step as two bodies over static buffers: ``micro`` takes one
microbatch from the input buffers, runs the forward and the backward and adds the fp32
gradients, the loss and the label count into accumulators; ``update`` divides, takes the
norm, clips, runs the optimizer (train/optim.py: its count, moments and parameters written in
place on the device), selects the old state where ``skip_nonfinite`` finds a non-finite norm,
writes the metrics buffer and zeroes the accumulators. On the card a step is ``accum`` replays
of the microbatch graph, each after a device-to-device copy of its microbatch into the input
buffers, and one replay of the update graph: no Python, no per-kernel dispatch.

- One graph a microbatch, replayed ``accum`` times, and one update graph, as the JAX step is
  one scan body and one update: the capture and the graph's nodes do not grow with ``accum``,
  and ``accum`` does not enter the microbatch graph's key.
- Keys, ``jax.jit``'s static arguments: the step's name, what the caller names static (the
  loss function, ``skip_nonfinite``), the model's config (the remat policy among it), ``accum``
  and each input's name, microbatch shape and dtype (a padding bucket is a key). A state keeps
  at most ``MAX_KEYS`` keys, the least recently used dropped with its graphs and buffers.
- Memory: every graph of a state captures into one pool. What persists between replays lives
  outside it (the parameters, the optimizer's state, the gradient accumulators, the input and
  metrics buffers), so nothing a graph leaves behind is read by another, and the pool holds
  about the largest key's activations, not their sum.
- Addresses: a graph reads and writes the tensors it captured. Each step fingerprints the
  model's parameters and buffers and the optimizer's state tensors; when that changes (a LoRA
  merge, a ``load_state_dict(assign=True)``) the graphs and buffers are dropped and the next
  step captures again. ``AdamW.load_state_dict`` (``--resume``) copies into the storage.
- Capture: the first step of a key runs eagerly on a side stream and is a real step. It is
  the warm-up: cuBLAS / cuDNN / cuFFT workspaces, the kernels' attributes, K1's split-K
  counters and every cache are made there, outside the pool, which the other keys' graphs
  keep meanwhile: a new key's warm-up needs the pool plus one eager step of memory
  (``release`` frees the pool). Both bodies are then captured on the side stream
  (``capture_error_mode="thread_local"``: the prefetch thread pins and copies meanwhile). The
  backward runs on the autograd engine's device thread onto the capturing stream, and the
  kernel wrappers' launches there go to the capture's tally (ops/launches.py), which every
  replay credits.
- No fallback: on the card a capture or a replay that fails raises with the step's name. The
  eager step (the same bodies over the same buffers, launched op by op) runs where the caller
  asks for it (``eager=True``) or on CPU tensors, where the bodies run over the same buffers.
- Refused by name: a mesh of more than one rank (gloo goes through host memory, the tp
  cross-entropy reads a count back), which the trainers meet with ``eager=True`` by
  ``eager_reason``; and a loss that hands dropout seeds to the forward
  (``models/llama.py:layer_seeds`` refuses them inside ``captured_step``: K2 / K5 take them as
  host integers, which a graph would freeze). A config's ``attn_dropout`` alone is captured:
  without seeds no dropout applies, and no trainer hands them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.decode_graph import Captured, on_card
from llama_x_tpu_torch.parallel.tensor import mesh_of

MAX_KEYS = 16  # the padding buckets of a 4096-position run (multiples of 256), each a key


def eager_reason(model, mesh=None) -> str | None:
    """Why a step of ``model`` (placed on ``mesh``) cannot be captured, or None: the one rule
    by which the trainers choose the eager step."""
    mesh = mesh_of(model) if mesh is None else mesh
    if mesh is not None and mesh.size > 1:
        return (f"the model is placed on a mesh of {mesh.size} ranks, whose collectives go through host memory "
                "(gloo) and read counts back (the tp cross-entropy's nonzero)")
    return None


def refuse(model, name: str, mesh=None) -> None:
    reason = eager_reason(model, mesh)
    if reason is not None:
        raise ValueError(f"{name}: {reason}; it cannot be captured in a CUDA graph: pass eager=True")


@dataclasses.dataclass(eq=False)
class StepBuffers:
    """What a step writes besides the model and the optimizer: the fp32 gradient accumulators
    (one per trainable parameter), the loss sum (f32) and label-token count (int64) of the
    microbatches, and the metrics of the last step (loss, grad_norm, n_tokens, skipped)."""

    grads: list[torch.Tensor]
    loss_sum: torch.Tensor
    n_tokens: torch.Tensor
    metrics: dict[str, torch.Tensor]

    def zero(self) -> None:
        torch._foreach_zero_(self.grads)
        self.loss_sum.zero_()
        self.n_tokens.zero_()


def new_buffers(params: list[torch.Tensor]) -> StepBuffers:
    dev = params[0].device
    f32 = lambda: torch.zeros((), dtype=torch.float32, device=dev)  # noqa: E731
    i64 = torch.zeros((), dtype=torch.int64, device=dev)
    return StepBuffers([torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in params], f32(),
                       torch.zeros((), dtype=torch.int64, device=dev),
                       {"loss": f32(), "grad_norm": f32(), "n_tokens": i64, "skipped": f32()})


class _Entry:
    """A key's input buffers (one microbatch) and its two captured graphs."""

    def __init__(self, inputs: dict[str, torch.Tensor]):
        self.inputs = inputs
        self.micro: Captured | None = None
        self.update: Captured | None = None


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))


def _fingerprint(state) -> tuple:
    model, opt = state.model, state.optimizer
    held = opt.tensors() if hasattr(opt, "tensors") else []
    return (tuple(t.data_ptr() for t in model.parameters()), tuple(t.data_ptr() for t in model.buffers()),
            tuple(t.data_ptr() for t in held))


class Runner:
    """A ``TrainState``'s captured steps and static buffers (``runner_of``)."""

    def __init__(self):
        self.fingerprint = None
        self.buffers: StepBuffers | None = None
        self.entries: OrderedDict[tuple, _Entry] = OrderedDict()
        self.pool = None  # the one memory pool of every graph of the state
        self.stream = None  # the side stream of warm-up and capture
        self.captures = 0  # keys captured (on the CPU: none)
        self.replays = 0  # steps replayed
        self.warmup_s: list[float] = []  # the eager first step of each key, seconds
        self.capture_s: list[float] = []  # capture + instantiate of each key, seconds
        self.pool_bytes: list[int] = []  # device memory each capture added to the pool

    def check(self, state) -> None:
        """Drop the graphs and buffers when the state's storage moved."""
        fp_now = _fingerprint(state)
        if fp_now != self.fingerprint:
            self.drop()
            self.buffers = new_buffers([p for _, p in state.trainable])
            self.fingerprint = fp_now

    def drop(self) -> None:
        """Drop every key's graphs and buffers; the pool goes with the last graph."""
        self.entries = OrderedDict()
        self.pool = None

    def entry(self, key: tuple, batch: dict) -> _Entry:
        """The key's entry, made (its input buffers on the state's device) on first use."""
        entry = self.entries.pop(key, None)
        if entry is None:
            dev = self.buffers.loss_sum.device
            entry = _Entry({k: torch.empty(v.shape[1:], dtype=v.dtype, device=dev) for k, v in batch.items()})
        self.entries[key] = entry
        while len(self.entries) > MAX_KEYS:
            self.entries.popitem(last=False)
        return entry

    def eager(self, state, entry: _Entry, batch: dict, accum: int, micro, update) -> None:
        """One step launched op by op over the static buffers, on the current stream."""
        for i in range(accum):
            _load(entry.inputs, batch, i)
            micro(state, self.buffers, entry.inputs)
        update(state, self.buffers, accum)

    def replay(self, state, name: str, entry: _Entry, batch: dict, accum: int, micro, update) -> None:
        """One step on the card: the key's graphs replayed, captured first (after one eager
        step) where the key has none."""
        if entry.micro is None:
            self._capture(state, name, entry, batch, accum, micro, update)
            return
        try:
            for i in range(accum):
                _load(entry.inputs, batch, i)
                entry.micro.replay(1)
            entry.update.replay(1)
        except RuntimeError as e:
            raise RuntimeError(f"{name}: CUDA graph replay failed: {e}") from e
        self.replays += 1

    def _capture(self, state, name, entry, batch, accum, micro, update) -> None:
        """The warm-up step on the side stream, then both bodies captured there."""
        dev = self.buffers.loss_sum.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        stream, current = self.stream, torch.cuda.current_stream(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.eager(state, entry, batch, accum, micro, update)
        torch.cuda.synchronize(dev)
        self.warmup_s.append(time.perf_counter() - t0)
        torch.cuda.empty_cache()  # so that the reserved memory's growth is the pool's
        reserved = torch.cuda.memory_reserved(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()

        def capture(body):
            def run():
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool, stream=stream, capture_error_mode="thread_local"):
                    body()
                return graph

            return Captured(run, stream)

        t0 = time.perf_counter()
        try:
            entry.micro = capture(lambda: micro(state, self.buffers, entry.inputs))
            entry.update = capture(lambda: update(state, self.buffers, accum))
        except RuntimeError as e:
            entry.micro = entry.update = None
            raise RuntimeError(f"{name}: CUDA graph capture failed: {e}") from e
        capture_s = time.perf_counter() - t0
        current.wait_stream(stream)
        self.captures += 1
        self.capture_s.append(capture_s)
        self.pool_bytes.append(torch.cuda.memory_reserved(dev) - reserved)


def _load(inputs: dict[str, torch.Tensor], batch: dict, i: int) -> None:
    """Microbatch ``i`` of ``batch`` into the input buffers (a device-to-device copy for the
    prefetched step batches)."""
    for k, buf in inputs.items():
        buf.copy_(batch[k][i], non_blocking=True)


def runner_of(state) -> Runner:
    """The state's runner, made on first use and kept on the state (its graphs go with it)."""
    runner = state.__dict__.get("_step_runner")
    if runner is None:
        runner = state.__dict__["_step_runner"] = Runner()
    return runner


def run(state, name: str, static: tuple, batch: dict, micro, update, *, eager: bool) -> dict:
    """One optimizer step of ``micro`` (one microbatch over the input buffers) ``accum`` times
    and ``update``, over ``state``'s static buffers; ``batch``: tensors or arrays with a
    leading [accum] axis. ``eager``: the bodies launched op by op. Otherwise on the card the
    replays of the key's graphs; on CPU tensors the bodies over the same buffers. Returns the
    metrics, copied out of the buffers (a later step leaves them as they are)."""
    if not eager:
        refuse(state.model, name)
    batch = {k: _tensor(v) for k, v in batch.items()}
    accum = len(next(iter(batch.values())))
    runner = runner_of(state)
    runner.check(state)
    key = (name, static, state.model.config, accum,
           tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in batch.items()))
    entry = runner.entry(key, batch)
    if eager:
        runner.eager(state, entry, batch, accum, micro, update)
    else:
        with llama.captured_step(name):  # a loss that hands dropout seeds raises here, on the CPU too
            if on_card(runner.buffers.loss_sum):
                runner.replay(state, name, entry, batch, accum, micro, update)
            else:
                runner.eager(state, entry, batch, accum, micro, update)
    return {k: v.clone() for k, v in runner.buffers.metrics.items()}


def release(state) -> None:
    """Drop the state's runner: its graphs (with their pool), buffers and counts."""
    state.__dict__.pop("_step_runner", None)


def stats(state) -> dict:
    """Keys held and captured, steps replayed, each key's eager warm-up step and capture in
    seconds and the pool bytes its capture added, and the bytes of the persistent buffers
    (accumulators, inputs)."""
    runner = runner_of(state)
    held = 0
    if runner.buffers is not None:
        held = sum(t.nbytes for t in runner.buffers.grads)
    held += sum(t.nbytes for e in runner.entries.values() for t in e.inputs.values())
    return dict(keys=len(runner.entries), graphs=sum(2 for e in runner.entries.values() if e.micro is not None),
                captures=runner.captures, replays=runner.replays, warmup_s=list(runner.warmup_s),
                capture_s=list(runner.capture_s),
                pool_bytes=list(runner.pool_bytes), buffer_bytes=held)
