"""A hybrid decoder of Mamba-2, attention and MLP blocks (Nemotron-H: NVIDIA's
``NemotronHForCausalLM``), for serving through ``serve/continuous.py``.

Block i computes x <- x + mixer_i(RMSNorm_i(x)) (bf16 residual), its mixer by the i-th
character of ``pattern`` (the config's ``hybrid_override_pattern``):

- ``M`` Mamba-2: in_proj -> [z | xBC | dt]; xBC <- SiLU(causal depthwise conv1d(xBC)) of
  ``conv_kernel`` taps with bias; x | B | C; the SSD recurrence (ops/ssd.py: K8 over a span of
  one row, K9 one token of every slot); y <- RMSNorm over groups of d_inner / n_groups
  channels of (y * SiLU(z)) times its weight; out_proj.
- ``*`` attention: ``llama.attention`` with no rotary embedding (the config declares none),
  GQA, causal, scale 1 / sqrt(head_dim), over the int8 / bf16 KV cache of the attention
  blocks alone (``llama.init_kv_cache`` of ``attention_config()``).
- ``-`` MLP: down(relu(up(x))^2), no gate.

A final RMSNorm and an untied head follow (``llama.head``). Every projection is a ``Linear``
(``ops/linear.py``: an int8 base with ``dynamic_int8_act`` runs K7 + K1).

State besides the KV cache, per slot (``init_states``): the SSM state [L_M, lanes, H, P, N]
in f32 and the conv state [L_M, lanes, K - 1, C] (the last K - 1 conv inputs). A decode step
steps every lane (``Lanes``; a lane whose ``done`` is set is left as it is); a span of one row
(``Span``: an admission's prefill or a chunk of one) reads and writes lane ``slot`` and can
write the state at one offset inside it to a snapshot (the prefix cache's).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops import ssd
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.ops.linear import Linear, apply_linear
from llama_x_tpu_torch.utils.device import resolve_device

KINDS = "M*-"  # Mamba-2, attention, MLP


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """The hyperparameters, and the fields that ``llama.head`` and the serving scheduler read."""

    tied_embeddings = False  # (a constant, not a field) the head is its own matrix

    embed_dim: int
    pattern: str
    head_dim: int
    num_heads: int
    num_kv_heads: int
    intermediate_dim: int
    mamba_heads: int
    mamba_head_dim: int
    ssm_state: int
    n_groups: int
    conv_kernel: int = 4
    max_seq_len: int = 2048
    vocab_size: int = 131_072
    norm_eps: float = 1e-5
    dynamic_int8_act: bool = False

    def __post_init__(self):
        if set(self.pattern) - set(KINDS):
            raise ValueError(f"pattern {self.pattern!r} holds blocks other than {KINDS!r}")
        if self.mamba_heads % self.n_groups or self.d_inner % self.n_groups:
            raise ValueError("the Mamba heads and channels split into whole groups")

    @property
    def num_layers(self) -> int:
        return len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.ssm_state

    @property
    def mamba_layers(self) -> int:
        return self.pattern.count("M")

    def replace(self, **kw) -> HybridConfig:
        return dataclasses.replace(self, **kw)

    def attention_config(self) -> llama.LlamaConfig:
        """The attention blocks as a ``LlamaConfig`` (its ``num_layers`` theirs): what
        ``llama.attention`` and the KV cache read."""
        return llama.LlamaConfig(
            embed_dim=self.embed_dim, num_layers=self.pattern.count("*"), head_dim=self.head_dim,
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads, intermediate_dim=self.intermediate_dim,
            max_seq_len=self.max_seq_len, vocab_size=self.vocab_size, norm_eps=self.norm_eps,
            dynamic_int8_act=self.dynamic_int8_act)


def tiny_config(**kw) -> HybridConfig:
    """A CPU-runnable config for tests: every kind of block, each kind twice."""
    base = dict(embed_dim=64, pattern="M-*M-*", head_dim=16, num_heads=4, num_kv_heads=2, intermediate_dim=96,
                mamba_heads=8, mamba_head_dim=8, ssm_state=16, n_groups=2, max_seq_len=128, vocab_size=256)
    base.update(kw)
    return HybridConfig(**base)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Mamba(nn.Module):
    """A Mamba-2 mixer's tensors: the projections, the conv (``conv_weight`` [C, K],
    ``conv_bias`` [C]), ``A_log``, ``dt_bias`` and ``D`` [H] f32, the gated norm's weight."""

    def __init__(self, in_proj: Linear, conv_weight, conv_bias, A_log, dt_bias, D, norm_weight, out_proj: Linear):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        for name, t in (("conv_weight", conv_weight), ("conv_bias", conv_bias), ("A_log", A_log),
                        ("dt_bias", dt_bias), ("D", D), ("norm_weight", norm_weight)):
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class MLP(nn.Module):
    def __init__(self, up: Linear, down: Linear):
        super().__init__()
        self.up, self.down = up, down


class Block(nn.Module):
    """One block: its pre-norm and its mixer (``Mamba``, ``llama.Attention`` or ``MLP``)."""

    def __init__(self, kind: str, norm: llama.RMSNorm, mixer: nn.Module):
        super().__init__()
        self.kind, self.norm, self.mixer = kind, norm, mixer


class Hybrid(nn.Module):
    """The decoder: embeddings, ``config.pattern``'s blocks, the final norm and the head."""

    def __init__(self, config: HybridConfig, tok_embeddings: torch.Tensor, layers: list[Block],
                 norm: llama.RMSNorm, output: Linear):
        super().__init__()
        if "".join(b.kind for b in layers) != config.pattern:
            raise ValueError("the blocks do not follow the config's pattern")
        self.config = config
        self.tok_embeddings = nn.Parameter(tok_embeddings, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.norm, self.output = norm, output

    @property
    def device(self) -> torch.device:
        return self.tok_embeddings.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def init(config: HybridConfig, *, seed: int = 0, dtype=torch.bfloat16, device=None) -> Hybrid:
    """Random init (tests): linears as ``llama.init``'s, the conv as PyTorch's Conv1d, A from
    U(1, 16), dt from log-uniform [0.001, 0.1] (floor 1e-4) behind an inverse-softplus bias,
    D and the norms ones (Mamba-2's init)."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def lin(fan_in, fan_out):
        bound = (6.0 / ((1 + 5.0) * fan_in)) ** 0.5
        return Linear(weight=torch.empty(fan_out, fan_in, device=dev).uniform_(-bound, bound, generator=gen).to(dtype))

    def norm():
        return llama.RMSNorm(torch.ones(c.embed_dim, dtype=dtype, device=dev), c.norm_eps)

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)

    H, D = c.mamba_heads, c.embed_dim
    layers = []
    for kind in c.pattern:
        if kind == "M":
            dt = torch.exp(uniform(H, math.log(1e-3), math.log(0.1))).clamp(min=1e-4)
            in_proj = lin(D, 2 * c.d_inner + 2 * c.n_groups * c.ssm_state + H)
            mixer = Mamba(in_proj, uniform((c.conv_dim, c.conv_kernel), -0.5, 0.5).to(dtype),
                          uniform(c.conv_dim, -0.5, 0.5).to(dtype),
                          torch.log(uniform(H, 1.0, 16.0)), dt + torch.log(-torch.expm1(-dt)),
                          torch.ones(H, device=dev), torch.ones(c.d_inner, dtype=dtype, device=dev), lin(c.d_inner, D))
        elif kind == "*":
            hd = c.head_dim
            mixer = llama.Attention(lin(D, c.num_heads * hd), lin(D, c.num_kv_heads * hd), lin(D, c.num_kv_heads * hd),
                                    lin(c.num_heads * hd, D))
        else:
            mixer = MLP(lin(D, c.intermediate_dim), lin(c.intermediate_dim, D))
        layers.append(Block(kind, norm(), mixer))
    emb = torch.randn(c.vocab_size, D, device=dev, generator=gen).to(dtype)
    return Hybrid(c, emb, layers, norm(), lin(D, c.vocab_size))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def init_states(config: HybridConfig, lanes: int, device=None, conv_dtype=torch.bfloat16):
    """(ssm [L_M, lanes, H, P, N] f32, conv [L_M, lanes, K - 1, C]) zeros."""
    c, dev = config, resolve_device(device)
    return (torch.zeros(c.mamba_layers, lanes, c.mamba_heads, c.mamba_head_dim, c.ssm_state, device=dev),
            torch.zeros(c.mamba_layers, lanes, c.conv_kernel - 1, c.conv_dim, dtype=conv_dtype, device=dev))


@dataclasses.dataclass(eq=False)
class Lanes:
    """A decode step over every lane: the stacked states, and the lanes left as they are."""

    ssm: torch.Tensor
    conv: torch.Tensor
    done: torch.Tensor | None = None


@dataclasses.dataclass(eq=False)
class Span:
    """A span of one row's positions over lane ``slot`` ([1] int64 on the device): its first
    ``length`` positions are real; ``fresh``: it starts the sequence (zero state); the state
    after ``snap_at`` positions (where 1 <= snap_at <= the span's width) goes to ``snap_ssm``
    [L_M, H, P, N] and ``snap_conv`` [L_M, K - 1, C]."""

    ssm: torch.Tensor
    conv: torch.Tensor
    slot: torch.Tensor
    length: torch.Tensor
    fresh: bool
    snap_at: torch.Tensor | None = None
    snap_ssm: torch.Tensor | None = None
    snap_conv: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def conv_span(xbc: torch.Tensor, lane: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, fresh: bool,
              length: torch.Tensor, snap_at: torch.Tensor | None):
    """The causal depthwise conv of a span's inputs ``xbc`` [W, C] after the lane's last K - 1
    inputs ``lane`` [K - 1, C] (zeros where ``fresh``) -> (SiLU(conv) [W, C] in xbc's dtype
    (``ssd.ssd_conv``), the last K - 1 inputs at ``length``, those at ``snap_at`` (clamped into
    the span))."""
    K1, W = lane.shape[0], xbc.shape[0]
    win = torch.cat([torch.zeros_like(lane) if fresh else lane.to(xbc.dtype), xbc], dim=0)  # [K - 1 + W, C]
    out = ssd.ssd_conv(win, weight, bias)
    taps = torch.arange(K1, device=xbc.device)
    last = win.index_select(0, length.reshape(1) + taps)
    snap = None if snap_at is None else win.index_select(0, snap_at.reshape(1).clamp(0, W) + taps)
    return out, last, snap


def mamba(mx: Mamba, c: HybridConfig, x: torch.Tensor, states, layer: int) -> torch.Tensor:
    """A Mamba-2 mixer on x [B, S, D] over the ``layer``-th Mamba lanes of ``states``
    (``Lanes`` with S 1, or a ``Span`` of one row)."""
    B, S, _ = x.shape
    di, C, H = c.d_inner, c.conv_dim, c.mamba_heads
    proj = apply_linear(x, mx.in_proj, dynamic_int8_act=c.dynamic_int8_act)
    z, xbc, dt = proj[..., :di], proj[..., di:di + C], proj[..., di + C:]
    A = -torch.exp(mx.A_log.float())
    dims = dict(heads=H, head_dim=c.mamba_head_dim, groups=c.n_groups, state_dim=c.ssm_state)
    if isinstance(states, Lanes):
        if S != 1:
            raise ValueError(f"a step over every lane takes one position a row, got {S}")
        y = ssd.ssd_step(xbc[:, 0], dt[:, 0], mx.conv_weight, mx.conv_bias, A, mx.D, mx.dt_bias, states.conv[layer],
                         states.ssm[layer], states.done, **dims)
    else:
        if B != 1:
            raise ValueError(f"a span is one row's, got {B} rows")
        conv = states.conv[layer]
        lane = conv.index_select(0, states.slot.reshape(1))[0]
        act, last, snap = conv_span(xbc[0], lane, mx.conv_weight, mx.conv_bias, states.fresh, states.length,
                                    states.snap_at if states.snap_conv is not None else None)
        conv.index_copy_(0, states.slot.reshape(1), last[None].to(conv.dtype))
        if snap is not None:
            states.snap_conv[layer].copy_(snap)
        y = ssd.ssd_scan(act.contiguous(), dt[0], A, mx.D, mx.dt_bias, states.ssm[layer], states.slot, states.length,
                         states.snap_at, None if states.snap_ssm is None else states.snap_ssm[layer],
                         fresh=states.fresh, **dims)
    g = ssd.gated_norm(y.reshape(B, S, di), z, mx.norm_weight, c.n_groups, c.norm_eps)
    return apply_linear(g, mx.out_proj, dynamic_int8_act=c.dynamic_int8_act)


def mlp(m: MLP, c: HybridConfig, x: torch.Tensor) -> torch.Tensor:
    """down(relu(up(x))^2)."""
    h = apply_linear(x, m.up, dynamic_int8_act=c.dynamic_int8_act)
    return apply_linear(torch.relu(h.float()).square().to(x.dtype), m.down, dynamic_int8_act=c.dynamic_int8_act)


def trunk(model: Hybrid, x: torch.Tensor, mask_info: MaskInfo, kv_cache=None, input_pos: torch.Tensor | None = None,
          prefill: bool = False, kv_bound: int | None = None, states=None):
    """Every block on x [B, S, D] -> (x, kv_cache): the attention blocks over ``kv_cache`` as
    ``llama.trunk`` runs them (``input_pos``, ``prefill``, ``kv_bound``; no rotary embedding),
    the Mamba blocks over ``states`` (``Lanes`` or ``Span``), each updated in place."""
    c = model.config
    ac = c.attention_config()
    B, S = x.shape[:2]
    offsets = None
    if (kv_cache is not None and not prefill and x.is_cuda and not llama._decode_kernel_fits(mask_info, S)
            and llama._offsets_fit(mask_info)):
        offsets = llama.cache_offsets(mask_info, B, S, kv_bound)  # once for every attention block
    at = mi = 0
    for blk in model.layers:
        h = blk.norm(x)
        if blk.kind == "M":
            out = mamba(blk.mixer, c, h, states, mi)
            mi += 1
        elif blk.kind == "*":
            cache = None if kv_cache is None else llama._layer_cache(kv_cache, at)
            out, _ = llama.attention(blk.mixer, ac, h, None, mask_info, cache, input_pos, prefill=prefill,
                                     offsets=offsets)
            at += 1
        else:
            out = mlp(blk.mixer, c, h)
        x = x + out
    return x, kv_cache


@torch.inference_mode()
def forward(model: Hybrid, tokens: torch.Tensor) -> torch.Tensor:
    """Logits [B, S, V] of tokens [B, S], each row from a zero state (no cache): a fresh span
    of each row over lanes of its own."""
    dev = model.device
    out = []
    for row in tokens:
        ssm, conv = init_states(model.config, 1, dev, model.tok_embeddings.dtype)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        span = Span(ssm, conv, zero, zero + row.shape[0], fresh=True)
        h, _ = trunk(model, llama.embed(model, row[None]), MaskInfo(causal=True), states=span)
        out.append(llama.head(model, h))
    return torch.cat(out, dim=0)
