"""Cross-entropy loss fused into the forward pass (port of
llama_x_tpu/ops/cross_entropy.py).

- ``cross_entropy_loss``: plain fp32 log-softmax CE over materialized logits; the
  oracle of the chunked version.
- ``fused_linear_cross_entropy``: takes the final hidden states and the LM head's
  weight and computes the CE without keeping the [N, vocab] fp32 logits alive: a
  ``torch.autograd.Function`` walks the rows in chunks and recomputes each chunk's
  logits in the backward. For Llama-3's 128,256-entry vocabulary that removes the
  largest activation of a long-sequence step.

Both return sum(per-token CE over labels != -100) / max(valid count, 1) in fp32.

The head is stored ``weight [V, D]`` here (the JAX package holds ``kernel [D, V]``),
so with ``head_int8`` the two int8 GEMM forms swap roles against JAX: per-vocab
scales are ROW scales of [V, D], the logits product h [M, D] x W [V, D] is the NT
form (kernel K1) and dH = dlogits [M, V] x W [V, D] reads the same bytes as
[K = V, N = D], the KN form (kernel K4). The integers and scales are those of the
JAX package's colwise-quantized [D, V] kernel.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.ops import int8_mm
from llama_x_tpu_torch.ops.int8 import quantize_int8_rowwise

IGNORE_INDEX = -100


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean fp32 CE over positions where labels != -100. logits [..., V], labels [...]."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1).long()
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, safe[:, None])[:, 0]
    losses = torch.where(valid, logz - gold, torch.zeros_like(logz))
    return losses.sum() / valid.sum().clamp(min=1)


def _chunk_logits(h: torch.Tensor, weight_f32: torch.Tensor) -> torch.Tensor:
    """f32 logits of one row chunk: the inputs' values, accumulated and kept in f32."""
    return h.float() @ weight_f32.T


def _chunk_logits_int8(h: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """f32 logits through the int8 path: rowwise-quantized h x the per-vocab-quantized head."""
    h_i8, h_scale = quantize_int8_rowwise(h)
    return int8_mm.int8_mm_dequant_nt(h_i8, w_i8, h_scale, w_scale, out_dtype=torch.float32)


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, labels, num_chunks, kernel_grad, head_int8):
        n = hidden.shape[0]
        if n % num_chunks:
            raise ValueError(f"rows {n} not divisible by num_chunks {num_chunks}")
        labels = labels.long()
        valid = labels != IGNORE_INDEX
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        # one view of the head for both passes: the int8 pair, or its f32 values
        head = quantize_int8_rowwise(weight) if head_int8 else (weight.float(),)
        size = n // num_chunks
        sum_loss = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(num_chunks):
            rows = slice(i * size, (i + 1) * size)
            logits = _chunk_logits_int8(hidden[rows], *head) if head_int8 else _chunk_logits(hidden[rows], *head)
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, safe[rows, None])[:, 0]
            sum_loss = sum_loss + torch.where(valid[rows], logz - gold, torch.zeros_like(logz)).sum()
        n_valid = valid.sum().clamp(min=1)
        ctx.save_for_backward(hidden, weight, safe, valid, n_valid)
        ctx.num_chunks, ctx.kernel_grad, ctx.head_int8 = num_chunks, kernel_grad, head_int8
        return sum_loss / n_valid

    @staticmethod
    def backward(ctx, g):
        hidden, weight, safe, valid, n_valid = ctx.saved_tensors
        num_chunks, kernel_grad, head_int8 = ctx.num_chunks, ctx.kernel_grad, ctx.head_int8
        n, d = hidden.shape
        size = n // num_chunks
        dev = hidden.device
        if head_int8:
            w_i8, w_scale = quantize_int8_rowwise(weight)
            w_scale_f32 = w_scale.float()
            ones = torch.ones(d, dtype=torch.float32, device=dev)
        else:
            weight_f32 = weight.float()
        dh = torch.empty((n, d), dtype=torch.float32, device=dev)
        # frozen head: no dW product and no [V, D] f32 accumulator at all
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=dev) if kernel_grad else None
        for i in range(num_chunks):
            rows = slice(i * size, (i + 1) * size)
            h = hidden[rows]
            logits = _chunk_logits_int8(h, w_i8, w_scale) if head_int8 else _chunk_logits(h, weight_f32)
            dlogits = torch.softmax(logits, dim=-1)
            dlogits[torch.arange(size, device=dev), safe[rows]] -= 1.0  # probs - onehot
            dlogits = dlogits * valid[rows, None].float()
            if head_int8:
                # dH = dlogits @ W with W = W_i8 * s_v: fold s_v into dlogits BEFORE the
                # rowwise quantization (it multiplies the vocabulary contraction), then
                # the KN kernel against W_i8 as stored
                dl_i8, dl_scale = quantize_int8_rowwise(dlogits * w_scale_f32[None, :])
                dh[rows] = int8_mm.int8_mm_dequant(dl_i8, w_i8, dl_scale, ones, out_dtype=torch.float32)
                continue
            dlogits = dlogits.to(hidden.dtype)
            dh[rows] = dlogits.float() @ weight_f32
            if kernel_grad:
                dw += dlogits.float().T @ h.float()
        scale = g / n_valid.float()
        dweight = (dw * scale).to(weight.dtype) if kernel_grad else None
        return (dh * scale).to(hidden.dtype), dweight, None, None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                               num_chunks: int = 8, kernel_grad: bool = True,
                               head_int8: bool = False) -> torch.Tensor:
    """CE(hidden @ weight.T, labels) computed in row chunks, with its own backward.

    hidden [N, D] (flattened batch * seq), weight [V, D], labels [N].

    ``kernel_grad=False`` declares the head frozen (QLoRA never adapts it): the
    backward then skips the dW product, as large as the dH product, and its fp32
    [V, D] accumulator, and returns no gradient for the weight. Set it only when the
    head really takes no gradient, or its training is silently dropped.

    ``head_int8=True`` runs the three vocabulary GEMMs (logits, their recompute in the
    backward, dH) on the int8 kernels. It requires ``kernel_grad=False``: the dW
    product's scales do not factor, and an int8 head that is being trained would be
    wrong anyway. The head is quantized per vocabulary entry afresh each pass; the
    path is lossy only in the int8 rounding of the head, of each chunk's activations
    and of its dlogits rows."""
    if head_int8 and kernel_grad:
        raise ValueError("head_int8 requires kernel_grad=False (frozen LM head)")
    return _FusedLinearCrossEntropy.apply(hidden, weight, labels, num_chunks, kernel_grad, head_int8)
