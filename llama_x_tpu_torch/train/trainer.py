"""The train step: forward + backward over microbatches, accumulate, clip, update
(port of llama_x_tpu/train/trainer.py).

The JAX package jits one pure function over a state pytree, scans the microbatches and
donates the state; here the step works in place (the model's parameters and the optimizer's
state are updated where they lie) over static buffers, and on the card each step is a replay
of captured CUDA graphs (train/step_graph.py: one graph a microbatch, one for the update).

Freezing is ``requires_grad``: only parameters that require grad are differentiated,
accumulated and handed to the optimizer; frozen ones (the int8 base above all) are
never touched.

Gradients of the microbatches are summed into fp32 buffers and divided by their
number: ``.grad`` of a bf16 parameter would accumulate in bf16 and drift from the
JAX trainer. The buffers persist between steps (the graphs read their addresses) and are
zeroed by each update.

Over a mesh (parallel/mesh.py) each rank holds its block of the microbatch's rows over
the batch axes dp x fsdp (parallel/sharding.py: ``shard_batch``), and the model its cp slice
of the sequence, whose loss comes back as the rank's share of the mean over its rows. The
step scales each batch rank's loss by its label count over the count all-reduced across
dp x fsdp, so that the losses of all ranks add up to the mean over the whole microbatch, as
on one process. The gradients are then summed where their placement leaves them partial
(``reduce_gradients``): over dp and cp always (other rows, other positions), over fsdp for a
tensor not sharded there (a sharded one came back reduce-scattered from its gather's
backward), over pp for a tensor every stage holds (the embeddings, the head, the stems:
each stage gives only its own part), never over tp (``copy_to_tp`` completed them in the
backward). The norm and the clip count each replicated tensor once
(``train/optim.py:global_norm``); the logged loss is the sum over dp x fsdp x cp.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from llama_x_tpu_torch.parallel.mesh import Mesh, all_reduce
from llama_x_tpu_torch.parallel.tensor import sharded_axes, stage_local
from llama_x_tpu_torch.train import step_graph
from llama_x_tpu_torch.train.optim import AdamW, global_norm
from llama_x_tpu_torch.train.step_graph import StepBuffers


class TrainState:
    """The model, its trainable parameters (name, tensor) in ``named_parameters``
    order, the optimizer over them, and the number of steps taken."""

    def __init__(self, model: nn.Module, optimizer: AdamW, step: int = 0):
        self.model = model
        self.trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        if [id(p) for _, p in self.trainable] != [id(p) for p in optimizer.params]:
            raise ValueError("the optimizer must hold the model's trainable parameters, in order")
        self.optimizer = optimizer
        self.step = step


def trainable_parameters(model: nn.Module) -> list[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


def reduce_axes(p: torch.Tensor, mesh: Mesh) -> str:
    """The axes over which a parameter's gradient is partial after the backward (see the
    module docstring), as a combination ("dp+cp", "dp+fsdp+pp", ...)."""
    axes = ["dp", "cp"]
    if "fsdp" not in sharded_axes(p, mesh):
        axes.append("fsdp")
    if not stage_local(p):
        axes.append("pp")
    return "+".join(a for a in ("dp", "fsdp", "pp", "cp") if a in axes)


def reduce_gradients(mesh: Mesh, params: list[torch.Tensor], grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """The gradients summed over each one's ``reduce_axes``, one flat buffer (one
    collective) per combination of axes."""
    out = list(grads)
    groups: dict[str, list[int]] = {}
    for i, p in enumerate(params):
        groups.setdefault(reduce_axes(p, mesh), []).append(i)
    for axes, idx in groups.items():
        if mesh.axis_size(axes) == 1:
            continue
        flat = all_reduce(mesh, torch.cat([grads[i].reshape(-1) for i in idx]), axes)
        for i, t in zip(idx, torch.split(flat, [grads[i].numel() for i in idx])):
            out[i] = t.reshape(grads[i].shape)
    return out


def make_train_step(loss_fn: Callable, skip_nonfinite: bool = False, mesh: Mesh | None = None, eager: bool = False):
    """loss_fn(model, microbatch) -> (scalar loss, n_label_tokens).

    Returns train_step(state, batch) -> metrics, which updates ``state`` in place;
    every entry of ``batch`` has a leading [accum] microbatch axis (accum = 1 for no
    accumulation). Metrics, as 0-d tensors on the model's device, copied out of the step's
    buffers (a later step leaves them as they are): loss (mean over microbatches),
    grad_norm (after accumulation, before clipping), n_tokens (sum of label tokens that are
    not padding), skipped (1.0 when skip_nonfinite suppressed the update).

    On the card each step is a replay of captured CUDA graphs (train/step_graph.py), the
    JAX trainers' jitted and donated step; ``eager=True`` launches the same step op by op (the
    reference, and the mesh trainers' step: ``step_graph.eager_reason``).

    skip_nonfinite: when the global grad norm is NaN or Inf (a bad batch, an
    overflow) the whole update, parameters AND optimizer state (its count too), is
    suppressed for that step instead of poisoning the run, by a select on the device; the
    state's step still advances.

    mesh: a mesh of more than one rank (see the module docstring); ``batch`` is then this
    rank's block of rows over dp x fsdp, and ``loss_fn``'s count the label tokens of those
    rows. Its collectives cannot be captured: it needs ``eager=True``."""
    distributed = mesh is not None and mesh.size > 1
    if distributed and not eager:
        raise ValueError(f"train_step: a mesh of {mesh.size} ranks cannot be captured in a CUDA graph (its collectives "
                         "go through host memory): pass eager=True")

    def micro(state: TrainState, bufs: StepBuffers, mb: dict) -> None:
        """One microbatch: forward, backward, fp32 gradients and the loss and count added up."""
        params = [p for _, p in state.trainable]
        loss, n = loss_fn(state.model, mb)
        if distributed:  # this batch rank's share of the microbatch's mean
            n_all = all_reduce(mesh, n, "dp+fsdp")
            loss = loss * (n.float() / n_all.clamp(min=1).float())
            n = n_all
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        live = [i for i, g in enumerate(grads) if g is not None]
        if live:
            torch._foreach_add_([bufs.grads[i] for i in live], [grads[i] for i in live])
        bufs.loss_sum.add_(loss.detach().float())
        bufs.n_tokens.add_(n)

    @torch.no_grad()
    def update(state: TrainState, bufs: StepBuffers, accum: int) -> None:
        """The mean gradients, their norm, the optimizer step (or, where skipped, the old
        state kept), the metrics; the accumulators zeroed for the next step."""
        params = [p for _, p in state.trainable]
        grads = bufs.grads if accum == 1 else torch._foreach_div(bufs.grads, accum)
        loss_sum = bufs.loss_sum
        if distributed:
            grads = reduce_gradients(mesh, params, grads)
            loss_sum = all_reduce(mesh, loss_sum, "dp+fsdp+cp")
        grad_norm = global_norm(grads, mesh, params)
        m = bufs.metrics
        if skip_nonfinite:
            ok = torch.isfinite(grad_norm)
            state.optimizer.step(grads, norm=grad_norm, apply=ok)
            m["skipped"].copy_(torch.logical_not(ok))
        else:
            state.optimizer.step(grads, norm=grad_norm)
            m["skipped"].zero_()
        m["loss"].copy_(loss_sum / accum)
        m["grad_norm"].copy_(grad_norm)
        m["n_tokens"].copy_(bufs.n_tokens)
        bufs.zero()

    def train_step(state: TrainState, batch: dict) -> dict:
        metrics = step_graph.run(state, "train_step", (loss_fn, skip_nonfinite), batch, micro, update,
                                 eager=eager)
        state.step += 1
        return metrics

    return train_step
