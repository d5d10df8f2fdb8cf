"""Early-fusion core shared by every multimodal variant (port of
llama_x_tpu/models/fusion.py).

Modality tokens are PREPENDED to the text embeddings, one rope spans the concatenated
sequence, and after the trunk the modality positions are sliced off so that the loss
covers text only. With ``prefix_lm`` attention is bidirectional over all modality
tokens and causal over text (``MaskInfo.prefix_len``).

Under context parallelism (``attn_impl`` ring / ulysses) every rank runs the stems whole
(they are small) and keeps its slice of the fused sequence: the labels are padded with the
ignore index over the modality positions and cut with it, so no position is stripped and
the loss is this rank's share of the mean over the text.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.ops.cross_entropy import IGNORE_INDEX
from llama_x_tpu_torch.parallel import context as cp


def embed_prefix(fn, x: torch.Tensor, config: llama.LlamaConfig) -> torch.Tensor:
    """A stem's ``fn(x)``, recomputed in the backward under ``activation_checkpointing``
    (the JAX package wraps each stem in ``jax.checkpoint`` there)."""
    if config.activation_checkpointing and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False)
    return fn(x)


def fuse_forward(model: llama.Llama, prefix_embeds: list[torch.Tensor], tokens: torch.Tensor, *,
                 labels: torch.Tensor | None = None, prefix_lm: bool = False, kv_cache=None, input_pos=None,
                 kv_len=None, dropout_seeds=None):
    """prefix_embeds: list of [B, T_i, D] modality token embeddings, prepended in order
    before the text tokens [B, S]. Returns loss/logits (+ the cache when one is given)."""
    x = llama.embed(model, tokens)
    n_prefix = sum(int(p.shape[1]) for p in prefix_embeds)
    if prefix_embeds:
        x = torch.cat([*[p.to(x.dtype) for p in prefix_embeds], x], dim=1)

    def prefix_len():
        return torch.full((x.shape[0],), n_prefix, dtype=torch.int32, device=x.device)

    if kv_cache is not None:
        q_pos = input_pos[None, :] if input_pos is not None else None
        # the bidirectional modality prefix must survive into cache prefill, or the
        # cached K/V mismatch prefix-LM training semantics
        pl = prefix_len() if (prefix_lm and n_prefix > 0) else None
        mask_info = MaskInfo(causal=True, q_positions=q_pos, kv_len=kv_len, prefix_len=pl)
    elif prefix_lm and n_prefix > 0:
        mask_info = MaskInfo(causal=True, prefix_len=prefix_len())
    else:
        mask_info = MaskInfo(causal=True)

    mesh = llama.context_mesh(model.config) if kv_cache is None else None
    if mesh is not None:
        if labels is None:
            raise ValueError("context parallelism runs the training loss: pass labels")
        labels = torch.cat([torch.full((labels.shape[0], n_prefix), IGNORE_INDEX, dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
        x, mask_info, labels = cp.shard_sequence(mesh, x, mask_info, labels)
        n_prefix = 0  # the padded labels ignore the modality positions

    x, kv_cache = llama.trunk(model, x, mask_info, kv_cache, input_pos, dropout_seeds=dropout_seeds)

    if n_prefix > 0:
        x = x[:, n_prefix:]  # strip modality positions before the head
    out = llama.head(model, x, labels)
    if mesh is not None:
        out = cp.loss_share(mesh, out, labels)
    return (out, kv_cache) if kv_cache is not None else out
