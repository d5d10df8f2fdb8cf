"""Llama-3/3.1 decoder (port of llama_x_tpu/models/llama.py).

GQA attention with RoPE (incl. the Llama-3.1 rescale), SwiGLU MLP, pre-RMSNorm
blocks, untied or tied LM head, and the static full-length KV cache. The JAX
package holds params as a pytree and scans stacked layers; here the model is a tree
of ``nn.Module``s (one ``Block`` per layer) and the functions below mirror the JAX
ones (``attention``, ``feed_forward``, ``block``, ``trunk``, ``head``, ``forward``)
with a module in place of a param dict.

Kernels on this path: the prefill and every training forward run the flash forward,
the training backward the flash backward (ops/flash_attention.py), every decode step
the decode kernel (ops/decode_attention.py), with ``dynamic_int8_act`` every int8
projection the NT int8 GEMM and with ``dynamic_int8_bwd`` its input gradient the KN
int8 GEMM (ops/int8_mm.py); ``int8_head`` puts the fused loss's vocabulary GEMMs on
both. The kernel modules are called through their module attributes.

Training: ``forward(..., labels=)`` returns the scalar loss (fused into the head
when ``fused_ce_chunks > 0``), and ``activation_checkpointing`` recomputes each
block in the backward (``torch.utils.checkpoint``, the JAX package's
``remat_policy="full"``). The named-save remat policies and the int8-residual
``feed_forward_q8`` / ``attention_q8`` families are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops.attention import MaskInfo, dot_product_attention
from llama_x_tpu_torch.ops.cross_entropy import cross_entropy_loss, fused_linear_cross_entropy
from llama_x_tpu_torch.ops.linear import Linear, apply_linear, apply_linear_grouped
from llama_x_tpu_torch.ops.norms import rms_norm
from llama_x_tpu_torch.ops.rope import apply_rope, build_rope
from llama_x_tpu_torch.utils.device import resolve_device


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
    # what activation_checkpointing keeps: "full" recomputes each block. The JAX
    # package's named-save policies are not ported yet.
    remat_policy: str = "full"

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


def init_kv_cache(config: LlamaConfig, batch_size: int, dtype=torch.bfloat16, device=None):
    """Static full-length cache, layout [L, B, n_kv, S, hd] (each head's rows
    contiguous, the decode kernel's read). ``dtype=torch.int8``: each side is a pair
    (int8 [L, B, n_kv, S, hd], f32 scale [L, B, n_kv, S])."""
    dev = resolve_device(device)
    shape = (config.num_layers, batch_size, config.num_kv_heads, config.max_seq_len, config.head_dim)
    if dtype == torch.int8:
        def side():
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape[:-1], dtype=torch.float32, device=dev))
        return side(), side()
    return torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)


def quantize_kv_rows(x: torch.Tensor):
    """[..., D] float -> (int8 [..., D], f32 scale [...]): symmetric absmax/127 per row."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-12)[..., None]).to(torch.int8)
    return q, scale


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


def attention(attn: Attention, config: LlamaConfig, x: torch.Tensor, rope: torch.Tensor, mask_info: MaskInfo,
              cache=None, input_pos: torch.Tensor | None = None, prefill: bool = False):
    """GQA attention. x [B, S, D]. With ``cache`` (this layer's (k, v) views), the
    fresh k/v are written into the cache IN PLACE at ``input_pos`` ([S], or [B, S]
    per row) and, unless ``prefill``, attention reads the cache (decode). ``prefill``
    attends over the fresh k/v (the cache starts empty at position 0: same result).
    A decode whose mask the decode kernel cannot take runs the plain attention on
    CPU tensors and raises on the card. Returns (out, cache)."""
    c = config
    B, S, _ = x.shape
    int8_kw = dict(dynamic_int8_act=c.dynamic_int8_act, dynamic_int8_bwd=c.dynamic_int8_bwd)
    q, k, v = apply_linear_grouped(x, (attn.wq, attn.wk, attn.wv), **int8_kw)
    q = apply_rope(q.reshape(B, S, c.num_heads, c.head_dim), rope, positions=input_pos)
    k = apply_rope(k.reshape(B, S, c.num_kv_heads, c.head_dim), rope, positions=input_pos)
    v = v.reshape(B, S, c.num_kv_heads, c.head_dim)

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
        elif q.is_cuda:
            raise ValueError(
                f"decode over the cache on the card takes the decode kernel only: causal queries with "
                f"q_positions and kv_len, no segments/prefix/kv_positions, 1 <= Sq <= {da.MAX_SQ} (got Sq={S})"
            )
        else:
            kd = dequant_kv(k_cache) if quantized else k_cache
            vd = dequant_kv(v_cache) if quantized else v_cache
            out = dot_product_attention(q, kd.transpose(1, 2), vd.transpose(1, 2), mask_info)
    else:
        out = fa.flash_attention(q, k, v, mask_info)
    out = out.reshape(B, S, c.num_heads * c.head_dim)
    return apply_linear(out, attn.wo, **int8_kw), cache


def feed_forward(ff: FeedForward, config: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: w2(silu(w1 x) * w3 x)."""
    int8_kw = dict(dynamic_int8_act=config.dynamic_int8_act, dynamic_int8_bwd=config.dynamic_int8_bwd)
    h1, h3 = apply_linear_grouped(x, (ff.w1, ff.w3), **int8_kw)
    return apply_linear(torch.nn.functional.silu(h1) * h3, ff.w2, **int8_kw)


def block(blk: Block, config: LlamaConfig, x: torch.Tensor, rope: torch.Tensor, mask_info: MaskInfo,
          cache=None, input_pos=None, prefill: bool = False):
    """Pre-norm transformer layer."""
    attn_out, cache = attention(blk.attention, config, blk.attention_norm(x), rope, mask_info, cache,
                                input_pos, prefill=prefill)
    x = x + attn_out
    x = x + feed_forward(blk.feed_forward, config, blk.ffn_norm(x))
    return x, cache


def trunk(model: Llama, x: torch.Tensor, mask_info: MaskInfo, kv_cache=None,
          input_pos: torch.Tensor | None = None, prefill: bool = False):
    """Run every layer. x [B, S, D] embeddings. Returns (x, kv_cache); the cache (a
    pair of [L, B, n_kv, S, hd] tensors, or of (int8, scale) pairs) is updated in
    place and returned. Without a cache and with ``activation_checkpointing``, each
    block keeps only its input and is recomputed in the backward."""
    config = model.config
    rope = model.rope if input_pos is not None else model.rope[: x.shape[1]]
    remat = kv_cache is None and config.activation_checkpointing and torch.is_grad_enabled()
    if remat and config.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={config.remat_policy!r}: only 'full' is ported; the named-save and int8-residual "
            "policies come with slice 2b"
        )
    for layer, blk in enumerate(model.layers):
        if remat:
            x = checkpoint(lambda h, blk=blk: block(blk, config, h, rope, mask_info)[0], x,
                           use_reentrant=False, preserve_rng_state=False)
            continue
        cache = None if kv_cache is None else _layer_cache(kv_cache, layer)
        x, _ = block(blk, config, x, rope, mask_info, cache, input_pos, prefill=prefill)
    return x, kv_cache


def head(model: Llama, x: torch.Tensor, labels: torch.Tensor | None = None) -> torch.Tensor:
    """Final norm + LM head -> logits, or the scalar loss when labels are given (fused
    into the head when ``fused_ce_chunks > 0``). Tied embeddings use the embedding
    matrix: one shared weight, one shared gradient."""
    c = model.config
    x = model.norm(x)
    weight = model.tok_embeddings if c.tied_embeddings else model.output.weight
    if labels is not None and c.fused_ce_chunks > 0:
        n = x.shape[0] * x.shape[1]
        return fused_linear_cross_entropy(x.reshape(n, -1), weight, labels.reshape(n), c.fused_ce_chunks,
                                          not c.frozen_head, c.int8_head and c.frozen_head)
    logits = torch.nn.functional.linear(x, weight.to(x.dtype))
    if labels is not None:
        return cross_entropy_loss(logits, labels)
    return logits


def forward(model: Llama, tokens: torch.Tensor, *, segment_ids: torch.Tensor | None = None,
            labels: torch.Tensor | None = None, kv_cache=None,
            input_pos: torch.Tensor | None = None, kv_len: torch.Tensor | None = None):
    """Logits [B, S, V] for tokens [B, S] (+ optional segment_ids for packed
    documents), or the scalar loss when labels [B, S] are given. With kv_cache +
    input_pos [S] + kv_len [B]: a decode step over the cache; returns (out, kv_cache)."""
    x = torch.nn.functional.embedding(tokens, model.tok_embeddings)
    if kv_cache is not None:
        q_pos = input_pos[None, :] if input_pos is not None else None
        mask_info = MaskInfo(causal=True, q_positions=q_pos, kv_len=kv_len)
    else:
        mask_info = MaskInfo(causal=True, segment_ids=segment_ids)
    x, kv_cache = trunk(model, x, mask_info, kv_cache, input_pos)
    out = head(model, x, labels)
    return (out, kv_cache) if kv_cache is not None else out
