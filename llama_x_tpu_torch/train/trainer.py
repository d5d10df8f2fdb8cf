"""The train step: forward + backward over microbatches, accumulate, clip, update
(port of llama_x_tpu/train/trainer.py).

The JAX package jits one pure function over a state pytree and scans the
microbatches; here the step is eager PyTorch and works in place: the model's
parameters and the optimizer's moments are updated where they lie.

Freezing is ``requires_grad``: only parameters that require grad are differentiated,
accumulated and handed to the optimizer; frozen ones (the int8 base above all) are
never touched.

Gradients of the microbatches are summed into fp32 buffers and divided by their
number: ``.grad`` of a bf16 parameter would accumulate in bf16 and drift from the
JAX trainer.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from llama_x_tpu_torch.train.optim import AdamW, global_norm


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


def make_train_step(loss_fn: Callable, skip_nonfinite: bool = False):
    """loss_fn(model, microbatch) -> (scalar loss, n_label_tokens).

    Returns train_step(state, batch) -> metrics, which updates ``state`` in place;
    every entry of ``batch`` has a leading [accum] microbatch axis (accum = 1 for no
    accumulation). Metrics, as 0-d tensors on the model's device: loss (mean over
    microbatches), grad_norm (after accumulation, before clipping), n_tokens (sum of
    label tokens that are not padding), skipped (1.0 when skip_nonfinite suppressed
    the update).

    skip_nonfinite: when the global grad norm is NaN or Inf (a bad batch, an
    overflow) the whole update, parameters AND optimizer state, is suppressed for
    that step instead of poisoning the run; the step count still advances."""

    def train_step(state: TrainState, batch: dict) -> dict:
        params = [p for _, p in state.trainable]
        dev = params[0].device
        accum = len(next(iter(batch.values())))
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ntok = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(accum):
            mb = {k: torch.as_tensor(v[i]).to(dev) for k, v in batch.items()}
            loss, n = loss_fn(state.model, mb)
            micro = torch.autograd.grad(loss, params, allow_unused=True)
            micro = [torch.zeros_like(p) if g is None else g for g, p in zip(micro, params)]
            if grads is None:
                grads = [g.float() for g in micro]
            else:
                for acc, g in zip(grads, micro):
                    acc += g
            loss_sum = loss_sum + loss.detach().float()
            ntok = ntok + n
        grads = [g / accum for g in grads]
        grad_norm = global_norm(grads)

        skipped = torch.zeros((), dtype=torch.float32, device=dev)
        if skip_nonfinite and not bool(torch.isfinite(grad_norm)):
            skipped = torch.ones((), dtype=torch.float32, device=dev)
        else:
            state.optimizer.step(grads)
        state.step += 1
        return {"loss": loss_sum / accum, "grad_norm": grad_norm, "n_tokens": ntok, "skipped": skipped}

    return train_step
