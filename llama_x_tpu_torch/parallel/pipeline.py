"""Pipeline parallelism: GPipe microbatch pipelining over the "pp" mesh axis (port of
llama_x_tpu/parallel/pipeline.py).

Stage s holds layers [s·L/P, (s+1)·L/P) (``parallel/sharding.py:shard_params`` drops the
others); every stage holds the embeddings, the final norm and the head. The schedule is
GPipe's: ``M + P − 1`` forward ticks, stage s running microbatch t − s at tick t (stage 0
embeds it, the others receive it from stage s − 1, and each sends its output on to
s + 1), then the backward drains in reverse: the last stage differentiates its
microbatch's loss, every other stage runs ``torch.autograd.grad`` on its saved stage
output against the gradient that stage s + 1 sends back, and sends its input's gradient
upstream. Activations and their gradients travel as point-to-point messages over the pp
axis (``parallel/mesh.py:send`` / ``recv``); a bubble tick runs nothing (the JAX scan
computes on zeros there).

The JAX package gets the backward from ``jax.grad`` through its scan; here the whole
schedule is one ``autograd.Function`` whose inputs are the stage's trainable parameters
(and the modality prefix), so a train step's ``torch.autograd.grad`` of the returned loss
runs the drain and gives the stage's parameter gradients. Loss semantics are the fused
loss forward's: the sum of per-token CE over the valid labels divided by their count, so
the pp loss equals the single-process loss; the last stage's value is replicated over pp
(the JAX psum-select).

``prefix_embeds`` [B, Pfx, D] (audio / image stem outputs) come from stems that run
outside the pipeline; stage 0 prepends them, one rope spans the concatenation, the last
stage strips the prefix positions before the head, and their gradient arrives at stage 0
only (zero elsewhere): a trainer then sums the stems' parameter gradients over pp, as it
sums the embeddings' and the head's (``train/trainer.py:reduce_axes``). ``prefix_lm`` makes
the prefix attend bidirectionally. Packed ``segment_ids``, tied embeddings, the fused CE
and a dp / fsdp axis (each batch rank pipelines its own rows) work as in JAX; attention
dropout and context-parallel attention do not combine with pp (``train/validate.py``).

Under ``activation_checkpointing`` a stage checkpoints each block whole under the remat
policy's base (``llama.base_policy``: the q8 and attn_q8 families map to the named-save
policy beneath them), as the JAX ``_stage_trunk`` runs ``llama.block`` under
``llama.remat_policy``: no int8 residual in a stage's MLP or attention.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.ops.cross_entropy import IGNORE_INDEX
from llama_x_tpu_torch.parallel.mesh import Mesh, all_reduce, recv, send
from llama_x_tpu_torch.parallel.sharding import stage_layers


class _Schedule:
    """The non-tensor state of one pipelined loss: the model, the microbatches and the
    stage's saved (input, output) pair of each microbatch between the two passes."""

    def __init__(self, model, mesh, tokens, labels, seg, n_micro, prefix_lm, n_prefix, reduce_batch):
        self.model, self.mesh, self.M = model, mesh, n_micro
        self.P, self.s = mesh.axis_size("pp"), mesh.index("pp")
        self.tok = tokens.chunk(n_micro)
        self.lab = labels.chunk(n_micro)
        self.seg = None if seg is None else seg.chunk(n_micro)
        self.prefix_lm, self.n_prefix, self.reduce_batch = prefix_lm, n_prefix, reduce_batch
        self.layers = stage_layers(model)
        self.saved: list = [None] * n_micro

    def mask(self, m: int) -> MaskInfo:
        mb = self.tok[m].shape[0]
        prefix = (torch.full((mb,), self.n_prefix, dtype=torch.int32, device=self.tok[m].device)
                  if (self.prefix_lm and self.n_prefix) else None)
        return MaskInfo(causal=True, segment_ids=None if self.seg is None else self.seg[m], prefix_len=prefix)

    def shape(self, m: int, like: torch.Tensor) -> torch.Tensor:
        mb, S = self.tok[m].shape
        return like.new_empty((mb, self.n_prefix + S, self.model.config.embed_dim))


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Schedule, prefix, *params):
        model, mesh, P, s, M = run.model, run.mesh, run.P, run.s, run.M
        first, last = s == 0, s == P - 1
        dtype = model.tok_embeddings.dtype
        like = torch.empty((), dtype=dtype, device=model.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        n_valid = torch.zeros((), dtype=torch.int64, device=model.device)
        pending = []
        pfx = None if prefix is None else prefix.detach().chunk(M)
        for t in range(M + P - 1):
            m = t - s  # the microbatch this stage runs at tick t
            if not 0 <= m < M:
                continue
            with torch.enable_grad():
                if first:
                    x_in = None if pfx is None else pfx[m].detach().requires_grad_(True)
                    x = llama.embed(model, run.tok[m])
                    if x_in is not None:
                        x = torch.cat([x_in.to(x.dtype), x], dim=1)
                else:
                    x_in = recv(mesh, [run.shape(m, like)], "pp", s - 1, tag=m)[0].detach().requires_grad_(True)
                    x = x_in
                y, _ = llama.trunk(model, x, run.mask(m), layers=run.layers, stage=True)
                if last:
                    lab = run.lab[m]
                    n = (lab != IGNORE_INDEX).sum()
                    h = y[:, run.n_prefix:] if run.n_prefix else y
                    y = llama.head(model, h, lab) * n.float()  # this microbatch's CE sum
                    loss_sum = loss_sum + y.detach()
                    n_valid = n_valid + n
            if not last:
                pending.append(send(mesh, [y.detach()], "pp", s + 1, tag=m))
            run.saved[m] = (x_in, y)
        for req in pending:
            req.wait()
        # the last stage's numbers, replicated over pp; over the batch axes with reduce_batch
        total = all_reduce(mesh, torch.stack([loss_sum, n_valid.float()]) * float(last), "pp")
        if run.reduce_batch:
            total = all_reduce(mesh, total, "dp+fsdp")
        ctx.run, ctx.n_valid = run, total[1].clamp(min=1)
        ctx.has_prefix = prefix is not None
        return total[0] / ctx.n_valid

    @staticmethod
    def backward(ctx, g):
        run = ctx.run
        mesh, P, s, M = run.mesh, run.P, run.s, run.M
        params = [p for p in run.model.parameters() if p.requires_grad]
        acc = [None] * len(params)
        prefix_grads = [None] * M
        pending = []
        scale = g / ctx.n_valid
        for t in reversed(range(M + P - 1)):
            m = t - s
            if not 0 <= m < M:
                continue
            x_in, y = run.saved[m]
            run.saved[m] = None
            if s == P - 1:
                out, grad_out = y, scale.to(y.dtype)
            else:
                out = y
                grad_out = recv(mesh, [y], "pp", s + 1, tag=M + m)[0]
            inputs = params + ([x_in] if x_in is not None else [])
            grads = torch.autograd.grad(out, inputs, grad_out, allow_unused=True)
            for i, gp in enumerate(grads[:len(params)]):
                if gp is not None:
                    acc[i] = gp if acc[i] is None else acc[i] + gp
            if x_in is not None:
                gx = grads[-1] if grads[-1] is not None else torch.zeros_like(x_in)
                if s > 0:
                    pending.append(send(mesh, [gx], "pp", s - 1, tag=M + m))
                else:
                    prefix_grads[m] = gx
        for req in pending:
            req.wait()
        prefix_grad = torch.cat(prefix_grads) if ctx.has_prefix and s == 0 else None
        return (None, prefix_grad, *acc)


def pipeline_loss(model, tokens: torch.Tensor, labels: torch.Tensor, mesh: Mesh, n_microbatches: int,
                  segment_ids: torch.Tensor | None = None, prefix_embeds: torch.Tensor | None = None,
                  prefix_lm: bool = False, reduce_batch: bool = True) -> torch.Tensor:
    """Pipeline-parallel fused-loss forward over the mesh's "pp" axis. tokens / labels
    [B, S] are this rank's rows (its block over dp x fsdp); B % n_microbatches == 0. Returns
    the scalar mean CE (``llama.forward`` with labels, or ``fusion.fuse_forward`` with a
    prefix): over every batch rank's rows, or over this rank's with ``reduce_batch=False``
    (a train step then weighs it by its label count, ``train/trainer.py``). Every stage
    returns the same value, and a ``torch.autograd.grad`` of it gives each stage the
    gradients of the parameters it holds (see the module docstring)."""
    config = model.config
    P = mesh.axis_size("pp")
    if config.num_layers % P:
        raise ValueError(f"num_layers {config.num_layers} must divide by the pp axis ({P})")
    if prefix_embeds is not None and segment_ids is not None:
        raise ValueError("a modality prefix and packed segments do not combine")
    B = tokens.shape[0]
    if B % n_microbatches:
        raise ValueError(f"local batch {B} must divide into {n_microbatches} pipeline microbatches")
    n_prefix = 0 if prefix_embeds is None else int(prefix_embeds.shape[1])
    run = _Schedule(model, mesh, tokens, labels, segment_ids, n_microbatches, prefix_lm, n_prefix, reduce_batch)
    params = [p for p in model.parameters() if p.requires_grad]
    return _Pipeline.apply(run, prefix_embeds, *params)
