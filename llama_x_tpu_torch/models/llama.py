"""Llama-3/3.1 decoder (port of llama_x_tpu/models/llama.py).

GQA attention with RoPE (incl. the Llama-3.1 rescale), SwiGLU MLP, pre-RMSNorm
blocks, untied or tied LM head, and the static full-length KV cache. The JAX
package holds params as a pytree and scans stacked layers; here the model is a tree
of ``nn.Module``s (one ``Block`` per layer) and the functions below mirror the JAX
ones (``attention``, ``feed_forward``, ``block``, ``trunk``, ``head``, ``forward``)
with a module in place of a param dict.

Kernels on this path: the prefill and every training forward run the flash forward,
the training backward the flash backward (ops/flash_attention.py), every decode step
the decode kernel (ops/decode_attention.py), a query of more than ``MAX_SQ`` rows over the
cache (a continuation chunk of chunked prefill, a prefix-cache admission, a speculative
verify at gamma >= 8) the flash forward's offsets form, with ``dynamic_int8_act`` every int8
projection the NT int8 GEMM and with ``dynamic_int8_bwd`` its input gradient the KN
int8 GEMM (ops/int8_mm.py); ``int8_head`` puts the fused loss's vocabulary GEMMs on
both. The kernel modules are called through their module attributes.

Training: ``forward(..., labels=)`` returns the scalar loss (fused into the head
when ``fused_ce_chunks > 0``), and ``activation_checkpointing`` recomputes each
block in the backward (``torch.utils.checkpoint``) under ``remat_policy``: "full"
keeps the block's input only; the named-save policies ("dots", "dots_flash", "flash",
"flash_qkv", "flash_proj") also keep the named results through a per-block
``SaveStore`` (ops/remat.py), so that the recompute launches no kernel for them; the
q8 policies ("flash_q8", ... "flash_proj_q8s") checkpoint the attention half only and
run the MLP outside as ``feed_forward_q8``, an ``autograd.Function`` whose residuals
are the block's hidden state and h1 (and h3) as rowwise int8; ``attn_q8`` /
``attn_q8s`` checkpoint nothing: the attention half is ``attention_q8``, an
``autograd.Function`` whose residuals are the hidden state, the post-RoPE q / k / v and
the flash output as rowwise int8 (plus lse), and whose backward runs no GEMM again, and the
MLP half is ``feed_forward_q8`` (h1 and h3, or h1 alone). With attention dropout they fall
back to ``flash_q8`` / ``flash_q8s``; under context parallelism ``attention_q8`` runs the
ring's or Ulysses' forward and backward on its own residuals. A pipeline stage
(``trunk(stage=True)``) checkpoints each block whole under the policy's base
(``base_policy``), as the JAX stage does.

Context parallelism (``attn_impl`` "ring" / "ulysses", without a cache): the ambient mesh's
"cp" axis (parallel/mesh.py: ``use_mesh``) splits the sequence. ``forward`` and the
multimodal ``fuse_forward`` cut the embeddings (after the stems), the segment ids and the
labels to this rank's slice (parallel/context.py: ``shard_sequence``), ``trunk`` takes the
RoPE rows at the slice's global positions, attention runs over the ring
(``context_parallel_attention``: K2's ring form and K5's offsets form) or through Ulysses'
all-to-alls (K2 / K5 in their normal form), and the loss is this rank's share of the mean
over the whole sequence (``loss_share``). Under ``attn_q8`` / ``attn_q8s``, ``attention_q8``
keeps this rank's rows as int8 and calls the same exchanges and kernels from its own
forward and backward, so the step equals the same step at cp 1, as the JAX package's does.
Attention dropout raises there, as in the JAX package.

Parameter sharding (``parallel/sharding.py:shard_params``: fsdp, tp and pp over a mesh;
``parallel/tensor.py`` for the collectives): the embedding is vocabulary-parallel
(``embed``), attention runs on the Hq / tp and Hkv / tp heads of this rank (their count
comes from the projections' local width; K2, K5 and K3 take them as they are, and a KV
cache holds the local heads: ``init_kv_cache(kv_heads=local_kv_heads(model))``), the linears
gather their fsdp shards just before use (ops/linear.py), inside the checkpointed region,
so the recompute gathers again, and the head is vocabulary-parallel (the fused loss across
"tp", or logits gathered over "tp" for sampling, so every rank samples the same token).
Under pp the model holds its stage's layers only and runs through ``parallel/pipeline.py``.

Attention dropout: ``LlamaConfig.attn_dropout`` with ``forward(dropout_seeds=)``, one
32-bit seed per layer (or a CPU ``torch.Generator`` to draw them from); the JAX
package splits a ``dropout_rng`` per layer and draws each kernel's seed from it, which
the port does not reproduce. Without seeds no dropout applies, whatever the config.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops import remat as rm
from llama_x_tpu_torch.ops.attention import MaskInfo, dot_product_attention
from llama_x_tpu_torch.ops.cross_entropy import (cross_entropy_loss, fused_linear_cross_entropy,
                                                  vocab_parallel_cross_entropy)
from llama_x_tpu_torch.ops.int8 import quantize_int8_rowwise
from llama_x_tpu_torch.ops.linear import Linear, apply_linear, apply_linear_grouped, linear_vjp
from llama_x_tpu_torch.ops.norms import rms_norm
from llama_x_tpu_torch.ops.ring_attention import ring_bwd_from_res, ring_fwd_with_lse
from llama_x_tpu_torch.ops.rope import apply_rope, build_rope
from llama_x_tpu_torch.parallel import context as cp
from llama_x_tpu_torch.parallel.mesh import Mesh, all_gather, current_mesh
from llama_x_tpu_torch.parallel.tensor import (copy_to_tp, gather, mesh_of, placement, tp_rows, tp_size,
                                               vocab_parallel_embedding)
from llama_x_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_bwd_from_res, ulysses_fwd_with_lse
from llama_x_tpu_torch.utils.device import resolve_device

CP_IMPLS = ("ring", "ulysses")  # the context-parallel attention implementations


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Model hyperparameters: the fields of the JAX ``LlamaConfig`` that serving and
    text training read."""

    embed_dim: int
    num_layers: int
    head_dim: int
    num_heads: int
    num_kv_heads: int
    intermediate_dim: int
    max_seq_len: int = 2048
    vocab_size: int = 128_256  # Llama3
    attn_dropout: float = 0.0  # on the attention probabilities, only where forward() is given dropout_seeds
    rope_base: float = 50_000.0
    is_llama3_1: bool = False
    rope_scale_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_old_context_len: int = 8192
    tied_embeddings: bool = False
    activation_checkpointing: bool = False
    fused_ce_chunks: int = 0  # 0 = plain CE; > 0 = chunked fused-linear CE
    # LM head frozen (QLoRA): the fused-CE backward then skips the dW product and its
    # [V, D] fp32 accumulator. Set from the actual requires_grad of the head
    # (train/cli.py) and it MUST match it: a trainable head with frozen_head=True
    # silently trains nothing.
    frozen_head: bool = False
    dynamic_int8_act: bool = False  # int8 x int8 projections (set after quantize_linear)
    dynamic_int8_bwd: bool = False  # int8 input gradients through the frozen base (ops/int8.py)
    int8_head: bool = False  # the fused CE's vocabulary GEMMs on the int8 kernels (needs frozen_head)
    norm_eps: float = 1e-5
    # what activation_checkpointing keeps: "full" recomputes each block; "dots" keeps
    # the projections' outputs, "dots_flash" those and the flash output + lse, "flash"
    # only the latter, "flash_qkv" also the q/k/v projections, "flash_proj" also the wo
    # and w2 outputs; "<base>_q8" / "<base>_q8s" keep <base> for the attention half and
    # run the MLP as feed_forward_q8 (h1 and h3, or h1 alone, kept as rowwise int8)
    remat_policy: str = "full"
    # "ring" / "ulysses": context-parallel attention over the ambient mesh's "cp" axis
    # (training without a cache); "auto" / "flash": the flash kernels on the card, their
    # plain versions on the CPU
    attn_impl: str = "auto"

    def replace(self, **kw) -> "LlamaConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(**kw) -> LlamaConfig:
    """A CPU-runnable config for tests (the JAX package's tiny_config)."""
    base = dict(
        embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2,
        intermediate_dim=128, max_seq_len=128, vocab_size=256,
    )
    base.update(kw)
    return LlamaConfig(**base)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


class Attention(nn.Module):
    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


class FeedForward(nn.Module):
    def __init__(self, w1: Linear, w2: Linear, w3: Linear):
        super().__init__()
        self.w1, self.w2, self.w3 = w1, w2, w3


class Block(nn.Module):
    def __init__(self, attention_norm: RMSNorm, attention: Attention, ffn_norm: RMSNorm, feed_forward: FeedForward):
        super().__init__()
        self.attention_norm, self.attention = attention_norm, attention
        self.ffn_norm, self.feed_forward = ffn_norm, feed_forward


class Llama(nn.Module):
    """The decoder. ``output`` is None with tied embeddings (the head is then the
    embedding matrix). The rope table is built once, on the model's device."""

    def __init__(self, config: LlamaConfig, tok_embeddings: torch.Tensor, layers: list[Block],
                 norm: RMSNorm, output: Linear | None):
        super().__init__()
        if len(layers) != config.num_layers:
            raise ValueError(f"{len(layers)} layers for a {config.num_layers}-layer config")
        if (output is None) != config.tied_embeddings:
            raise ValueError("output head must be absent exactly when tied_embeddings is set")
        self.config = config
        self.tok_embeddings = nn.Parameter(tok_embeddings, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.norm = norm
        self.output = output
        c = config
        self.register_buffer("rope", build_rope(
            c.max_seq_len, c.head_dim, c.rope_base, c.is_llama3_1,
            scale_factor=c.rope_scale_factor, low_freq_factor=c.rope_low_freq_factor,
            high_freq_factor=c.rope_high_freq_factor, old_context_len=c.rope_old_context_len,
            device=tok_embeddings.device,
        ), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device

    @classmethod
    def from_hf(cls, path, **kwargs) -> "Llama":
        """A local HF checkpoint directory (models/hf.py:load_llama)."""
        from llama_x_tpu_torch.models.hf import load_llama

        return load_llama(path, **kwargs)

    def set_max_seq_len(self, max_seq_len: int) -> "Llama":
        """Serve with a cache of ``max_seq_len`` positions: the config and the rope table
        follow, in place."""
        c = self.config = self.config.replace(max_seq_len=max_seq_len)
        self.rope = build_rope(
            c.max_seq_len, c.head_dim, c.rope_base, c.is_llama3_1, scale_factor=c.rope_scale_factor,
            low_freq_factor=c.rope_low_freq_factor, high_freq_factor=c.rope_high_freq_factor,
            old_context_len=c.rope_old_context_len, device=self.device,
        )
        return self

    def forward(self, tokens: torch.Tensor, **kw):
        return forward(self, tokens, **kw)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init(config: LlamaConfig, *, seed: int = 0, dtype=torch.bfloat16, device=None) -> Llama:
    """Random init (tests / from scratch): kaiming-uniform(a=sqrt(5)) linears (torch
    nn.Linear's default), unit-normal embeddings, unit norms — the JAX ``init``'s
    distributions, drawn from a ``torch.Generator`` (not JAX's bits)."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def lin(fan_in, fan_out):
        bound = (6.0 / ((1 + 5.0) * fan_in)) ** 0.5
        w = torch.empty(fan_out, fan_in, device=dev).uniform_(-bound, bound, generator=gen)
        return Linear(weight=w.to(dtype))

    def norm():
        return RMSNorm(torch.ones(c.embed_dim, dtype=dtype, device=dev), c.norm_eps)

    d, hd, nh, nkv, ffn = c.embed_dim, c.head_dim, c.num_heads, c.num_kv_heads, c.intermediate_dim
    emb = torch.randn(c.vocab_size, d, device=dev, generator=gen).to(dtype)
    layers = [
        Block(norm(), Attention(lin(d, nh * hd), lin(d, nkv * hd), lin(d, nkv * hd), lin(nh * hd, d)),
              norm(), FeedForward(lin(d, ffn), lin(ffn, d), lin(d, ffn)))
        for _ in range(c.num_layers)
    ]
    output = None if c.tied_embeddings else lin(d, c.vocab_size)
    return Llama(c, emb, layers, norm(), output)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def local_kv_heads(model: Llama) -> int:
    """The kv heads this rank's attention holds: Hkv / tp under tensor parallelism."""
    return model.config.num_kv_heads // tp_size(mesh_of(model))


def init_kv_cache(config: LlamaConfig, batch_size: int, dtype=torch.bfloat16, device=None,
                  kv_heads: int | None = None):
    """Static full-length cache, layout [L, B, n_kv, S, hd] (each head's rows
    contiguous, the decode kernel's read). ``dtype=torch.int8``: each side is a pair
    (int8 [L, B, n_kv, S, hd], f32 scale [L, B, n_kv, S]). ``kv_heads``: n_kv when it is
    not the config's (a tensor-parallel rank's ``local_kv_heads``)."""
    dev = resolve_device(device)
    shape = (config.num_layers, batch_size, kv_heads or config.num_kv_heads, config.max_seq_len, config.head_dim)
    if dtype == torch.int8:
        def side():
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        return side(), side()
    return torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)


def quantize_kv_rows(x: torch.Tensor):
    """[..., D] float -> (int8 [..., D], f32 scale [...]): symmetric absmax/127 per row
    (``quantize_int8_rowwise``: K7 on the card)."""
    q, scale = quantize_int8_rowwise(x.reshape(-1, x.shape[-1]), scale_dtype=torch.float32)
    return q.reshape(x.shape), scale.reshape(x.shape[:-1])


def dequant_kv(side) -> torch.Tensor:
    """Quantized cache side (int8 data, f32 scale) -> bf16 [..., S, D] (the plain
    read path's dequant, as the JAX package rounds it)."""
    data, scale = side
    return (data.float() * scale[..., None]).to(torch.bfloat16)


def _layer_cache(kv_cache, layer: int):
    """Per-layer views of the stacked cache (writes through them land in the cache)."""
    def one(side):
        return tuple(t[layer] for t in side) if isinstance(side, tuple) else side[layer]
    return one(kv_cache[0]), one(kv_cache[1])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _decode_kernel_fits(mi: MaskInfo, Sq: int) -> bool:
    """The decode kernel's contract: causal small-Sq queries with explicit positions
    and kv_len over the cache (ops/decode_attention.py)."""
    return (
        1 <= Sq <= da.MAX_SQ and mi.causal and mi.kv_len is not None and mi.q_positions is not None
        and mi.kv_positions is None and mi.segment_ids is None and mi.prefix_len is None
    )


def _offsets_fit(mi: MaskInfo) -> bool:
    """What the flash forward's offsets form takes over the cache: causal queries with
    explicit positions and kv_len, no segments, prefix or kv_positions."""
    return (
        mi.causal and mi.kv_len is not None and mi.q_positions is not None and mi.kv_positions is None
        and mi.segment_ids is None and mi.prefix_len is None
    )


def cache_offsets(mi: MaskInfo, B: int, S: int, kv_bound: int | None = None):
    """(q_offset [B], kv_offset [B], kv_len [B], kv_max) int32 for the offsets form over the
    cache: q_offset = q_positions[:, 0], kv_offset 0 (cache entry j holds position j), and
    a bound on every kv_len as a host int (the int8 cache's dequantized prefix). Without
    ``kv_bound`` it reads one small tensor back from the device, once per trunk call: the
    longest kv_len, and a flag that raises where a row's q_positions are not contiguous
    (the kernel places row i at q_offset + i). ``kv_bound``: the caller's word that the rows
    are contiguous and every kv_len is at most ``kv_bound``; nothing is read back (a captured
    step's)."""
    qp = mi.q_positions
    qp = (qp.reshape(1, -1) if qp.ndim == 1 else qp).expand(B, S)
    if mi.kv_len.ndim != 1:
        raise ValueError(f"the offsets form takes kv_len [B], got {tuple(mi.kv_len.shape)}")
    lens = mi.kv_len.to(torch.int32).expand(B).contiguous()
    q_off = qp[:, 0].to(torch.int32).contiguous()
    if kv_bound is not None:
        return q_off, torch.zeros_like(q_off), lens, int(kv_bound)
    steps = qp.long() == qp[:, :1].long() + torch.arange(S, device=qp.device)
    flag, kv_max = torch.stack([steps.all().long(), lens.max().long()]).tolist()
    if not flag:
        raise ValueError("the offsets form takes q_positions contiguous in each row (q_offset + i)")
    return q_off, torch.zeros_like(q_off), lens, int(kv_max)


def context_mesh(config: LlamaConfig) -> Mesh | None:
    """The ambient mesh when attention is context-parallel (``attn_impl`` ring / ulysses),
    else None; raises where such a config finds no mesh."""
    if config.attn_impl not in CP_IMPLS:
        return None
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"attn_impl={config.attn_impl!r} needs parallel.mesh.use_mesh(mesh) around the step")
    return mesh


def _named(saves: rm.SaveStore | None, name: str):
    return None if saves is None else (saves, name)


def attention(attn: Attention, config: LlamaConfig, x: torch.Tensor, rope: torch.Tensor, mask_info: MaskInfo,
              cache=None, input_pos: torch.Tensor | None = None, prefill: bool = False,
              saves: rm.SaveStore | None = None, dropout_seed=None, offsets=None):
    """GQA attention. x [B, S, D]; ``rope`` None: q and k are not rotated. With ``cache``
    (this layer's (k, v) views), the fresh k/v are written into the cache IN PLACE at
    ``input_pos`` ([S], or [B, S] per row) and, unless ``prefill``, attention reads the
    cache (decode). ``prefill``
    attends over the fresh k/v (the cache starts empty at position 0: same result).
    A read of the cache takes the decode kernel up to ``MAX_SQ`` query rows, and on the
    card the flash forward's offsets form beyond (``offsets``: ``cache_offsets``, given by
    ``trunk``); any other mask over the cache runs the plain attention on CPU tensors and
    raises on the card. ``saves``: the checkpointed region's named
    saves (q/k/v, the flash output + lse, the wo output). ``dropout_seed`` turns on
    ``config.attn_dropout`` in the flash kernels. Returns (out, cache)."""
    c = config
    B, S, _ = x.shape
    int8_kw = dict(dynamic_int8_act=c.dynamic_int8_act, dynamic_int8_bwd=c.dynamic_int8_bwd)
    q, k, v = apply_linear_grouped(x, (attn.wq, attn.wk, attn.wv), save=_named(saves, rm.QKV), **int8_kw)
    # this rank's heads (all of them, or Hq / tp and Hkv / tp under tensor parallelism)
    q, k, v = (t.reshape(B, S, -1, c.head_dim) for t in (q, k, v))
    if rope is not None:  # None: no position embedding (a hybrid decoder's attention blocks)
        q = apply_rope(q, rope, positions=input_pos)
        k = apply_rope(k, rope, positions=input_pos)

    decode_from_cache = False
    quantized = False
    if cache is not None:
        if input_pos is None:
            raise ValueError("a cache write needs input_pos")
        k_cache, v_cache = cache
        quantized = isinstance(k_cache, tuple)
        pos = (input_pos if input_pos.ndim == 2 else input_pos[None, :].expand(B, S)).long()
        rows = torch.arange(B, device=x.device)[:, None]

        def put(side, fresh):  # fresh [B, S, n_kv, hd] -> cache rows [b, :, pos[b, s]]
            if quantized:
                data, scale = side
                f_i8, f_s = quantize_kv_rows(fresh)
                data[rows, :, pos] = f_i8
                scale[rows, :, pos] = f_s
            else:
                side[rows, :, pos] = fresh.to(side.dtype)

        put(k_cache, k)
        put(v_cache, v)
        decode_from_cache = not prefill

    if decode_from_cache:
        if _decode_kernel_fits(mask_info, S):
            lens = da.effective_lens(mask_info, B, S)
            scale = 1.0 / math.sqrt(c.head_dim)
            if quantized:
                out = da.decode_attention_int8(q, k_cache[0], k_cache[1], v_cache[0], v_cache[1], lens, scale)
            else:
                out = da.decode_attention(q, k_cache, v_cache, lens, scale)
        elif offsets is not None:
            q_off, kv_off, lens, kv_max = offsets
            if quantized:
                out, _ = fa.flash_fwd_offsets_int8(q, k_cache[0], k_cache[1], v_cache[0], v_cache[1], q_off, kv_off,
                                                   lens, kv_max)
            else:
                out, _ = fa.flash_fwd_offsets(q, k_cache, v_cache, q_off, kv_off, lens)
        elif q.is_cuda:
            raise ValueError(
                f"a read of the cache on the card takes the decode kernel (Sq <= {da.MAX_SQ}) or the flash "
                f"kernel's offsets form: causal queries with q_positions and kv_len, no segments/prefix/"
                f"kv_positions (got Sq={S})"
            )
        else:
            kd = dequant_kv(k_cache) if quantized else k_cache
            vd = dequant_kv(v_cache) if quantized else v_cache
            out = dot_product_attention(q, kd.transpose(1, 2), vd.transpose(1, 2), mask_info)
    elif c.attn_impl in CP_IMPLS and cache is None:
        # the sequence is split over the mesh's "cp" axis: ring attention passes the kv
        # blocks around the ring, Ulysses scatters heads / gathers the sequence and back
        if c.attn_dropout > 0.0 and dropout_seed is not None:
            raise NotImplementedError(f"attention dropout is not supported with attn_impl={c.attn_impl!r}")
        mesh = context_mesh(c)
        if c.attn_impl == "ring":
            out = cp.context_parallel_attention(q, k, v, mesh, mask_info)
        else:
            out = ulysses_attention(q, k, v, mesh, mask_info)
    else:
        rate = c.attn_dropout if dropout_seed is not None else 0.0
        out, _ = rm.run_saved(_named(saves, rm.FLASH), lambda kept: fa.flash_fwd_with_lse(
            q, k, v, mask_info, dropout_rate=rate, dropout_seed=dropout_seed, preset=kept))
    out = out.reshape(B, S, -1)
    return apply_linear(out, attn.wo, save=_named(saves, rm.O_PROJ), **int8_kw), cache


def feed_forward(ff: FeedForward, config: LlamaConfig, x: torch.Tensor,
                 saves: rm.SaveStore | None = None) -> torch.Tensor:
    """SwiGLU: w2(silu(w1 x) * w3 x)."""
    int8_kw = dict(dynamic_int8_act=config.dynamic_int8_act, dynamic_int8_bwd=config.dynamic_int8_bwd)
    h1, h3 = apply_linear_grouped(x, (ff.w1, ff.w3), save=_named(saves, rm.MLP_IN), **int8_kw)
    return apply_linear(torch.nn.functional.silu(h1) * h3, ff.w2, save=_named(saves, rm.MLP_OUT), **int8_kw)


# ---------------------------------------------------------------------------
# int8-residual feed-forward (the "*_q8" remat policies)
#
# Under "flash_proj" the backward still re-runs the w1 / w3 F-wide GEMMs of every
# layer: their outputs feed the SwiGLU derivative and are too wide to keep in bf16.
# Kept as rowwise int8 they are a quarter of that, and the backward computes the SwiGLU
# derivative from the dequantized values. The int8 round trip perturbs only the
# backward's view of h1 (and h3): the forward output comes from the exact values. "_q8"
# keeps h1 and h3; "_q8s" keeps h1 and recomputes h3 with one w3 GEMM. No checkpoint
# policy can re-encode what it keeps, so the MLP is an autograd.Function of its own,
# placed outside the checkpointed attention half by trunk().
# ---------------------------------------------------------------------------


def _deq_rows(q: torch.Tensor, s: torch.Tensor, dtype, shape) -> torch.Tensor:
    """Rowwise int8 codes and their scales back to ``dtype``, reshaped to ``shape``."""
    return (q.float() * s.float()[:, None]).to(dtype).reshape(shape)


class _FeedForwardQ8(torch.autograd.Function):
    """ffn_norm + SwiGLU of one block with int8 residuals. ``params`` are the trainable
    tensors of the norm and the three linears, passed so that autograd routes their
    gradients; ``keys`` names them as (owner, tensor name)."""

    @staticmethod
    def forward(ctx, blk, config, keys, h, *params):
        ff = blk.feed_forward
        kw = dict(dynamic_int8_act=config.dynamic_int8_act, dynamic_int8_bwd=config.dynamic_int8_bwd)
        x = blk.ffn_norm(h)
        h1, h3 = apply_linear_grouped(x, (ff.w1, ff.w3), **kw)
        out = apply_linear(torch.nn.functional.silu(h1) * h3, ff.w2, **kw)
        F = h1.shape[-1]
        rows = tp_rows(placement(ff.w1), "col")  # h1 / h3 hold F / tp columns under tp: the absmax spans the row
        kept = [h, *quantize_int8_rowwise(h1.reshape(-1, F), rows)]
        if not config.remat_policy.endswith("_q8s"):
            kept += quantize_int8_rowwise(h3.reshape(-1, F), rows)
        ctx.save_for_backward(*kept)
        ctx.blk, ctx.kw, ctx.keys = blk, kw, keys
        return out

    @staticmethod
    def backward(ctx, g):
        h, q1, s1, *third = ctx.saved_tensors
        blk, kw = ctx.blk, ctx.kw
        ff, norm = blk.feed_forward, blk.ffn_norm
        shape = (*h.shape[:-1], q1.shape[-1])
        with torch.enable_grad():
            hg = h.detach().requires_grad_(True)
            x_graph = norm(hg)
        x_ = x_graph.detach()
        h1 = _deq_rows(q1, s1, h.dtype, shape)
        # q8s: h3 was not kept; one w3 GEMM gives its exact forward value again
        h3 = _deq_rows(*third, h.dtype, shape) if third else apply_linear(x_, ff.w3, **kw)
        sig = torch.sigmoid(h1)
        silu_h1 = h1 * sig
        dprod, grads2 = linear_vjp(ff.w2, silu_h1 * h3, g, **kw)
        dh1 = dprod * h3 * (sig * (1 + h1 * (1 - sig)))  # d/dh [h sigmoid(h)] = sig (1 + h (1 - sig))
        dh3 = dprod * silu_h1
        dx1, grads1 = linear_vjp(ff.w1, x_, dh1, **kw)
        dx3, grads3 = linear_vjp(ff.w3, x_, dh3, **kw)
        norm_params = [norm.scale] if norm.scale.requires_grad else []
        dh, *dscale = torch.autograd.grad(x_graph, [hg] + norm_params, dx1 + dx3)
        by_key = {("w1", n): t for n, t in grads1.items()}
        by_key.update({("w2", n): t for n, t in grads2.items()})
        by_key.update({("w3", n): t for n, t in grads3.items()})
        if dscale:
            by_key[("ffn_norm", "scale")] = dscale[0]
        return (None, None, None, dh, *(by_key.get(key) for key in ctx.keys))


def feed_forward_q8(blk: Block, config: LlamaConfig, h: torch.Tensor) -> torch.Tensor:
    """ffn_norm + SwiGLU on the pre-norm hidden state ``h``, with int8 backward
    residuals (``config.remat_policy`` ends in "_q8" or "_q8s"). The norm is folded in so
    that the only full-width residual is h itself; it is recomputed in the backward."""
    ff = blk.feed_forward
    keys, params = _trainable([("ffn_norm", blk.ffn_norm)] + [(n, getattr(ff, n)) for n in ("w1", "w2", "w3")])
    return _FeedForwardQ8.apply(blk, config, keys, h, *params)


# ---------------------------------------------------------------------------
# int8-residual attention (the "attn_q8" / "attn_q8s" remat policies)
#
# Under the checkpointed q8 policies the backward still reruns the q / k / v (and wo)
# int8 GEMMs to rebuild the flash kernel's inputs. attention_q8 keeps the post-RoPE q / k
# / v and the flash output as rowwise int8 instead, and its backward runs wo's vjp, the
# flash backward on the dequantized residuals, the inverse RoPE rotation, the q / k / v
# vjps and rms_norm's vjp: no GEMM of the forward runs again. The JAX package measured it
# slower than flash_q8s on its chip (llama_x_tpu/models/llama.py:447-454); it is a
# supported variant, not a default.
#
# Under context parallelism (attn_impl ring / ulysses over the ambient mesh's "cp" axis) the
# rank keeps its own rows as above, and the flash forward and backward become the ring's
# (K2's ring form, K5's offsets form; ops/ring_attention.py) or Ulysses' (the all-to-alls
# around K2 / K5; parallel/ulysses.py) forward and backward from residuals. The rows, and so
# their int8 codes, are those of the cp 1 step; only the flash output's codes can differ, at
# a rounding tie, since the ring merges its blocks in another order.
# ---------------------------------------------------------------------------


def _trainable(owners) -> tuple[tuple, list]:
    """(keys, tensors) of the trainable tensors of ``owners`` ((name, module) pairs), keyed
    as (owner name, tensor name)."""
    named = [(owner, n, p) for owner, mod in owners for n, p in mod.named_parameters() if p.requires_grad]
    return tuple((owner, n) for owner, n, _ in named), [p for _, _, p in named]


class _AttentionQ8(torch.autograd.Function):
    """attention_norm + GQA attention of one block with int8 residuals (the JAX
    ``_make_attention_q8``). ``params`` are the trainable tensors of the norm and the four
    linears, passed so that autograd routes their gradients; ``keys`` names them.

    Under Ulysses the residuals are the local rows, kept before the heads -> sequence
    exchange, not the head shard over the whole sequence after it. The memory is the same
    (B S_local Hq D = B S Hq/n D; k / v before their g-fold repeat, g times less when g > 1),
    and the rows are the cp 1 step's: a flash output row is a whole token, as wo reads it and
    as tensor parallelism's rowwise quantizer spans it. The price is in the backward: it sends
    q / k / v and the output through heads -> sequence again (the forward's bytes once more)
    besides the incoming gradient, where residuals kept after the exchange would need the
    output and the gradient only."""

    @staticmethod
    def forward(ctx, blk, config, keys, h, rope, mask_info, *params):
        attn = blk.attention
        kw = dict(dynamic_int8_act=config.dynamic_int8_act, dynamic_int8_bwd=config.dynamic_int8_bwd)
        B, S, _ = h.shape
        D = config.head_dim
        x = blk.attention_norm(h)
        q, k, v = apply_linear_grouped(x, (attn.wq, attn.wk, attn.wv), **kw)
        q = apply_rope(q.reshape(B, S, -1, D), rope)
        k = apply_rope(k.reshape(B, S, -1, D), rope)
        v = v.reshape(B, S, -1, D)
        mesh, res_mi = context_mesh(config), mask_info
        if mesh is None:
            out, lse = fa.flash_fwd_with_lse(q, k, v, mask_info)
        elif config.attn_impl == "ring":
            out, lse = ring_fwd_with_lse(q, k, v, mask_info, 1.0 / math.sqrt(D), mesh, "cp")
        else:
            out, lse, res_mi = ulysses_fwd_with_lse(q, k, v, mask_info, 1.0 / math.sqrt(D), mesh, "cp")
        flat = out.reshape(B * S, -1)
        o = apply_linear(flat.reshape(B, S, -1), attn.wo, **kw)
        # q / k / v rows are one head's D (local under tp); the flash output's rows are
        # wo's input, which tp shards on the last axis: their absmax spans the row
        kept = [h, lse]
        for t in (q, k, v):
            kept += quantize_int8_rowwise(t.reshape(-1, D))
        kept += quantize_int8_rowwise(flat, tp_rows(placement(attn.wo), "row"))
        ctx.save_for_backward(*kept)
        ctx.blk, ctx.kw, ctx.keys, ctx.rope, ctx.mask_info = blk, kw, keys, rope, res_mi
        ctx.mesh, ctx.impl = mesh, config.attn_impl
        ctx.shapes = (q.shape, k.shape, v.shape)
        return o

    @staticmethod
    def backward(ctx, g):
        h, lse, qi, qs, ki, ks, vi, vs, ai, as_ = ctx.saved_tensors
        blk, kw, rope = ctx.blk, ctx.kw, ctx.rope
        attn, norm = blk.attention, blk.attention_norm
        B, S, _ = h.shape
        dt = h.dtype
        q_shape, k_shape, v_shape = ctx.shapes
        q, k, v = (_deq_rows(i, s_, dt, shp) for i, s_, shp in ((qi, qs, q_shape), (ki, ks, k_shape),
                                                                 (vi, vs, v_shape)))
        out = _deq_rows(ai, as_, dt, q_shape)
        dattn, grads_o = linear_vjp(attn.wo, out.reshape(B, S, -1), g, **kw)
        do, mesh, scale = dattn.reshape(q_shape), ctx.mesh, 1.0 / math.sqrt(q_shape[-1])
        if mesh is None:
            dq, dk, dv = fa.flash_bwd_from_res(q, k, v, out, lse, do, ctx.mask_info)
        else:
            bwd = ring_bwd_from_res if ctx.impl == "ring" else ulysses_bwd_from_res
            dq, dk, dv = bwd(q, k, v, out, lse, do, ctx.mask_info, scale, mesh, "cp")
        # RoPE is a rotation, linear in q / k: its vjp does not read the primal, so taking it
        # at the dequantized values is exact
        with torch.enable_grad():
            qg, kg = q.detach().requires_grad_(True), k.detach().requires_grad_(True)
            dq, dk = torch.autograd.grad([apply_rope(qg, rope), apply_rope(kg, rope)], [qg, kg], [dq, dk])
            hg = h.detach().requires_grad_(True)
            x_graph = norm(hg)
        x_ = x_graph.detach()
        dx, by_key = None, {("wo", n): t for n, t in grads_o.items()}
        for name, d in (("wq", dq), ("wk", dk), ("wv", dv)):
            dxi, grads = linear_vjp(getattr(attn, name), x_, d.reshape(B, S, -1), **kw)
            dx = dxi if dx is None else dx + dxi
            by_key.update({(name, n): t for n, t in grads.items()})
        norm_params = [norm.scale] if norm.scale.requires_grad else []
        dh, *dscale = torch.autograd.grad(x_graph, [hg] + norm_params, dx)
        if dscale:
            by_key[("attention_norm", "scale")] = dscale[0]
        return (None, None, None, dh, None, None, *(by_key.get(key) for key in ctx.keys))


def attention_q8(blk: Block, config: LlamaConfig, h: torch.Tensor, rope: torch.Tensor,
                 mask_info: MaskInfo) -> torch.Tensor:
    """attention_norm + GQA attention on the pre-norm hidden state ``h`` with rowwise-int8
    backward residuals (post-RoPE q / k / v and the flash output; no GEMM recompute in the
    backward). Training only: no cache, no dropout (``trunk`` falls back). Under context
    parallelism ``h`` is this rank's rows, ``rope`` their rows of the table, and the
    attention runs over the whole sequence through the ring or Ulysses."""
    attn = blk.attention
    keys, params = _trainable([("attention_norm", blk.attention_norm)]
                              + [(n, getattr(attn, n)) for n in ("wq", "wk", "wv", "wo")])
    return _AttentionQ8.apply(blk, config, keys, h, rope, mask_info, *params)


# q8 policies: the attention half keeps the mapped policy's saves; the MLP runs outside
# the checkpoint as feed_forward_q8
_Q8_POLICIES = {
    "flash_q8": "flash", "flash_qkv_q8": "flash_qkv", "flash_proj_q8": "flash_proj",
    "flash_q8s": "flash", "flash_qkv_q8s": "flash_qkv", "flash_proj_q8s": "flash_proj",
}
# attention_q8 + feed_forward_q8, no checkpoint at all; the values are the checkpointed
# fallback where attention_q8 cannot apply (dropout)
_ATTN_Q8_POLICIES = {"attn_q8": "flash_q8", "attn_q8s": "flash_q8s"}
REMAT_POLICIES = (*rm.POLICY_SAVES, *_Q8_POLICIES, *_ATTN_Q8_POLICIES)


def check_remat_policy(policy: str) -> None:
    """Raise for a policy the port does not know."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of {REMAT_POLICIES}")


def base_policy(policy: str) -> str:
    """The named-save policy under which a caller that checkpoints whole blocks (a
    pipeline stage) runs ``policy``: the q8 families map to their base, as the JAX
    ``remat_policy`` maps them (attn_q8 -> flash_q8 -> flash)."""
    policy = _ATTN_Q8_POLICIES.get(policy, policy)
    return _Q8_POLICIES.get(policy, policy)


def block(blk: Block, config: LlamaConfig, x: torch.Tensor, rope: torch.Tensor, mask_info: MaskInfo,
          cache=None, input_pos=None, prefill: bool = False, saves: rm.SaveStore | None = None, dropout_seed=None,
          offsets=None):
    """Pre-norm transformer layer."""
    attn_out, cache = attention(blk.attention, config, blk.attention_norm(x), rope, mask_info, cache,
                                input_pos, prefill=prefill, saves=saves, dropout_seed=dropout_seed, offsets=offsets)
    x = x + attn_out
    x = x + feed_forward(blk.feed_forward, config, blk.ffn_norm(x), saves)
    return x, cache


# the name of the step being captured into a CUDA graph (train/step_graph.py:run), or None
_CAPTURED_STEP: contextvars.ContextVar[str | None] = contextvars.ContextVar("captured_step", default=None)


@contextlib.contextmanager
def captured_step(name: str):
    """Marks the forward passes inside as a captured step's, which ``layer_seeds`` refuses
    dropout seeds in."""
    token = _CAPTURED_STEP.set(name)
    try:
        yield
    finally:
        _CAPTURED_STEP.reset(token)


def layer_seeds(dropout_seeds, num_layers: int) -> list:
    """One 32-bit dropout seed per layer from ``forward``'s ``dropout_seeds``: None (no
    dropout), a sequence or tensor of ``num_layers`` integers, or a CPU
    ``torch.Generator`` from which they are drawn. Seeds handed inside a captured step
    (``captured_step``) raise: K2 / K5 take them as host integers, which a graph would freeze."""
    if dropout_seeds is None:
        return [None] * num_layers
    step = _CAPTURED_STEP.get()
    if step is not None:
        raise ValueError(f"{step}: dropout seeds are handed to the forward (models/llama.py:layer_seeds); K2 / K5 "
                         "take them as host integers, which a captured CUDA graph would freeze: pass eager=True")
    if isinstance(dropout_seeds, torch.Generator):
        dropout_seeds = torch.randint(0, 2**31 - 1, (num_layers,), generator=dropout_seeds)
    seeds = [int(s) for s in dropout_seeds]
    if len(seeds) != num_layers:
        raise ValueError(f"{len(seeds)} dropout seeds for {num_layers} layers")
    return seeds


def trunk(model: Llama, x: torch.Tensor, mask_info: MaskInfo, kv_cache=None,
          input_pos: torch.Tensor | None = None, prefill: bool = False, dropout_seeds=None,
          layers: range | None = None, stage: bool = False, kv_bound: int | None = None):
    """Run every layer (``layers``: these of them, a pipeline stage's). x [B, S, D]
    embeddings. Returns (x, kv_cache); the cache (a pair of [L, B, n_kv, S, hd] tensors,
    or of (int8, scale) pairs) is updated in place and returned. Without a cache and with
    ``activation_checkpointing``, each block (under a q8 policy: its attention half) keeps
    its input and what ``remat_policy`` names, and the rest is recomputed in the backward;
    under attn_q8 / attn_q8s no block is checkpointed (``attention_q8`` and
    ``feed_forward_q8``). ``stage``: a pipeline stage's layers, each block checkpointed
    whole under ``base_policy`` (the JAX ``pipeline._stage_trunk``). ``kv_bound``: a read of
    the cache through the flash kernel's offsets form takes the caller's word that each row's
    q_positions are contiguous and every kv_len is at most ``kv_bound``, and reads nothing
    back (``cache_offsets``)."""
    config = model.config
    layers = range(config.num_layers) if layers is None else layers
    if any(not isinstance(model.layers[i], Block) for i in layers):
        raise ValueError("this rank holds one pipeline stage's layers: run the model through "
                         "parallel/pipeline.py:pipeline_loss")
    remat = kv_cache is None and config.activation_checkpointing and torch.is_grad_enabled()
    policy = config.remat_policy
    if remat:
        check_remat_policy(policy)
    if input_pos is not None:
        rope = model.rope
    else:  # a context-parallel rank's rows sit at their global positions
        mesh = context_mesh(config) if kv_cache is None else None
        start = cp.sequence_start(mesh, x.shape[1]) if mesh is not None else 0
        rope = model.rope[start: start + x.shape[1]]
    seeds = layer_seeds(dropout_seeds, config.num_layers)
    if stage:
        policy = base_policy(policy)
    attn_q8 = remat and policy in _ATTN_Q8_POLICIES and dropout_seeds is None
    policy = _ATTN_Q8_POLICIES.get(policy, policy)  # the dropout fallback (and attn_q8's MLP family)
    q8 = remat and policy in _Q8_POLICIES
    keep = rm.POLICY_SAVES[_Q8_POLICIES.get(policy, policy)] if remat else ()
    B, S = x.shape[:2]
    offsets = None
    if (kv_cache is not None and not prefill and x.is_cuda and not _decode_kernel_fits(mask_info, S)
            and _offsets_fit(mask_info)):
        offsets = cache_offsets(mask_info, B, S, kv_bound)  # once for every layer

    def region(h, blk, saves, seed):
        # the checkpointed function: the first pass records the named saves, the recompute takes them
        saves.enter()
        if not q8:
            return block(blk, config, h, rope, mask_info, saves=saves, dropout_seed=seed)[0]
        out, _ = attention(blk.attention, config, blk.attention_norm(h), rope, mask_info, saves=saves,
                           dropout_seed=seed)
        return h + out

    for layer in layers:
        blk = model.layers[layer]
        if attn_q8:
            x = x + attention_q8(blk, config, x, rope, mask_info)
            x = x + feed_forward_q8(blk, config, x)
            continue
        if remat:
            x = checkpoint(region, x, blk, rm.SaveStore(keep), seeds[layer], use_reentrant=False,
                           preserve_rng_state=False)
            if q8:
                x = x + feed_forward_q8(blk, config, x)
            continue
        cache = None if kv_cache is None else _layer_cache(kv_cache, layer)
        x, _ = block(blk, config, x, rope, mask_info, cache, input_pos, prefill=prefill, dropout_seed=seeds[layer],
                     offsets=offsets)
    return x, kv_cache


def embed(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings [..., D] of ``tokens``: a lookup, vocabulary-parallel under tp
    (parallel/tensor.py), the table gathered over "fsdp" first."""
    mesh = mesh_of(model)
    if mesh is None:
        return torch.nn.functional.embedding(tokens, model.tok_embeddings)
    weight = gather(model.tok_embeddings, mesh)
    if tp_size(mesh) == 1:
        return torch.nn.functional.embedding(tokens, weight)
    return vocab_parallel_embedding(tokens, weight, mesh, model.config.vocab_size)


def head(model: Llama, x: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
    """Final norm + LM head -> logits, or the scalar loss when labels are given (fused
    into the head when ``fused_ce_chunks > 0``). Tied embeddings use the embedding
    matrix: one shared weight, one shared gradient. Under tp the head is vocabulary-
    parallel: the loss combines across "tp", and logits are gathered whole over it."""
    c = model.config
    x = model.norm(x)
    weight = model.tok_embeddings if c.tied_embeddings else model.output.weight
    mesh = mesh_of(model)
    tp = tp_size(mesh) > 1
    if labels is not None and c.fused_ce_chunks > 0:
        n = x.shape[0] * x.shape[1]
        return fused_linear_cross_entropy(x.reshape(n, -1), weight, labels.reshape(n), c.fused_ce_chunks,
                                          not c.frozen_head, c.int8_head and c.frozen_head, mesh, c.vocab_size)
    if mesh is not None:
        weight = gather(weight, mesh)
    logits = torch.nn.functional.linear(copy_to_tp(x, mesh) if tp else x, weight.to(x.dtype))
    if labels is not None:
        return vocab_parallel_cross_entropy(logits, labels, mesh, c.vocab_size) if tp else cross_entropy_loss(
            logits, labels)
    return all_gather(mesh, logits, "tp", -1, total=c.vocab_size) if tp else logits


def forward(model: Llama, tokens: torch.Tensor, *, segment_ids: torch.Tensor | None = None,
            labels: torch.Tensor | None = None, kv_cache=None,
            input_pos: torch.Tensor | None = None, kv_len: torch.Tensor | None = None, dropout_seeds=None):
    """Logits [B, S, V] for tokens [B, S] (+ optional segment_ids for packed
    documents), or the scalar loss when labels [B, S] are given. With kv_cache +
    input_pos [S] + kv_len [B]: a decode step over the cache; returns (out, kv_cache).
    ``dropout_seeds`` (``layer_seeds``) turns on ``config.attn_dropout``."""
    x = embed(model, tokens)
    if kv_cache is not None:
        q_pos = input_pos[None, :] if input_pos is not None else None
        mask_info = MaskInfo(causal=True, q_positions=q_pos, kv_len=kv_len)
    else:
        mask_info = MaskInfo(causal=True, segment_ids=segment_ids)
    mesh = context_mesh(model.config) if kv_cache is None else None
    if mesh is not None:  # this rank's slice of the sequence (labels are aligned to positions)
        x, mask_info, labels = cp.shard_sequence(mesh, x, mask_info, labels)
    x, kv_cache = trunk(model, x, mask_info, kv_cache, input_pos, dropout_seeds=dropout_seeds)
    out = head(model, x, labels)
    if mesh is not None and labels is not None:
        out = cp.loss_share(mesh, out, labels)
    return (out, kv_cache) if kv_cache is not None else out
