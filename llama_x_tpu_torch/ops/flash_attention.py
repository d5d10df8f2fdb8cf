"""Flash attention with MaskInfo masking, forward (kernel K2,
``csrc/flash_attention.cu``) and backward (kernel K5, ``csrc/flash_attention_bwd.cu``).

Port of llama_x_tpu/ops/flash_attention.py. Forward (``_fwd_kernel`` through
``flash_fwd_with_lse`` and ``flash_attention``): online softmax in fp32 with exp2,
scale*log2e folded into q (one f32 multiply, one rounding to q's dtype), masked
logits -1e30, the l == 0 guard, and a natural-log lse [B, Hq, S, 1] beside the
output. Backward (``_bwd_dkv_kernel`` through ``_bwd`` and ``flash_bwd_from_res``):
the identical fold of q, p = exp2(s - lse*log2e), p rounded to the input dtype before
the dV product, ds = p * (dp - delta) * ln2 rounded before the dk and dq products,
f32 accumulation, dq scaled once at the end, dk / dv summed over the GQA group. The
mask is built in the kernels from ``causal``, ``segment_ids`` / ``kv_segment_ids``
and ``prefix_len`` and equals ops/attention.py's ``make_attention_mask``. The TPU's
block-alignment gate is not copied: the kernels mask a ragged S themselves. The kernels
sort their tiles with ``tile_class`` (all masked: never loaded; all visible: no mask
code; partial: masked per element), the JAX kernels' ``_needed`` and ``_all_true`` with
the segment test widened to the ranges of segment ids that ``segment_ranges`` gives them.

The offsets form of the forward (``_fwd(offsets=)``, ``has_offsets``), through
``flash_fwd_offsets``: Sq queries per batch row at global positions q_offset[b] + i over a
KV cache in its own head-major layout [B, Hkv, S_max, D], read in place, entry j at
kv_offset[b] + j; visible iff q_offset[b] + i >= kv_offset[b] + j and j < kv_len[b]. The
JAX kernel's scalar pair is the case where every row has the same offsets (and kv_len is
the whole cache). ``flash_fwd_offsets_int8`` first dequantizes the live prefix of an int8
cache to bf16, as the JAX package's XLA path (``dequant_kv``) does.

The ring form (``_fwd(offsets=)`` / ``_bwd(offsets=, delta=, cast=False)`` as ring attention
calls them), through ``flash_fwd_ring`` (K2) and ``flash_bwd_ring`` (K5): self-attention
operands of one shard, every mask, with the local q rows at global positions q_offset + i
and the rotated kv block at kv_offset + j (one pair for the call): the causal diagonal is
shifted by q_offset - kv_offset and the prefix tested at global positions. The forward
returns the block's bf16 out and f32 lse; the backward takes the ring's final merged out
and lse and a precomputed delta [B, Hq, S], and adds f32 dq, dk, dv into the caller's
accumulators. Their plain versions are ``flash_fwd_ring_plain`` / ``flash_bwd_ring_plain``.

Attention dropout (``dropout_rate`` > 0 with a ``dropout_seed``) is the JAX kernels'
counter-based hash, reproduced bit for bit in the kernels and in the plain versions
(``dropout_keep``): element (b, q head, q position, kv position) is kept iff
fmix32(fmix32(key) + r * bk + c) >= min(int(rate * 2**32), 2**32 - 1) in uint32, with
the key folding (seed, b, kv head, q block, kv block) and (r, c) the element's place in
the stacked-group block of the JAX plan (bq, bk). f32 p is multiplied by keep / (1 - rate)
and then rounded for the PV product; l sums the undropped p. The backward rebuilds the
same mask: dV += bf16(p * keep)^T dO, dp = (dO V^T) * keep, ds = p (dp - delta) ln2
with the undropped p. The plan is ``dropout_plan``: the JAX package's block choice
(512 / 1024 by default, group * bq <= 1024) without its TPU gate. Where the JAX package
has no plan (an S that no block divides) it leaves the kernel for ``jax.random.bernoulli``,
which cannot be reproduced; the port then keys the hash on ONE block spanning the whole
sequence, so such shapes share the keep rate and the forward/backward consistency with
the JAX package, not its bits. ``jax.random`` seeds are not reproduced either: the
caller hands over one 32-bit seed per call.

``flash_attention`` and ``flash_fwd_with_lse`` are differentiable: a
``torch.autograd.Function`` saves q, k, v, out, lse and its backward is
``flash_bwd_from_res``. On CPU tensors the wrappers run ``flash_fwd_plain`` /
``flash_bwd_plain``; on CUDA tensors they launch the kernels or raise (head_dim must be
64 or 128, dtype bfloat16, and the mask must carry no explicit positions or kv_len).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.utils import build

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_M32 = 0xFFFFFFFF
_TILE = 128  # the kernels' largest kv tile: a dropout plan's bk must be a multiple of it, or span the sequence
SEG_CHUNK = 64  # the granularity of the segment-id ranges the kernels read (csrc/common.cuh)


class Dropout(NamedTuple):
    """One call's attention dropout: the rate, the 32-bit seed and the JAX plan's
    blocks (bq, bk) that key the hash."""

    rate: float
    seed: int
    bq: int
    bk: int

    @property
    def threshold(self) -> int:
        """keep iff bits >= threshold; computed in double on the host, as the JAX kernel does."""
        return min(int(self.rate * 2**32), 2**32 - 1)

    @property
    def keep_scale(self) -> float:
        """1 / (1 - rate) in double, rounded to f32 (the value p is multiplied by)."""
        return float(torch.tensor(1.0 / (1.0 - self.rate), dtype=torch.float32))


def _pick_block(s: int, target: int, candidates: tuple = (512, 256, 128)) -> int | None:
    for b in (target, *candidates):
        if b <= s and s % b == 0:
            return b
    return None


def dropout_plan(sq: int, skv: int, group: int, block_q: int = 512, block_kv: int = 1024) -> tuple[int, int]:
    """(bq, bk) of the JAX package's flash plan for these shapes (``_pick_bq`` with the
    group * bq <= 1024 cap, ``_pick_block``), which key the dropout hash. Where that
    package has no plan, one block spans the whole sequence: (sq, skv)."""
    cap = max(32, 1024 // max(group, 1))
    bq = _pick_block(sq, min(block_q, cap), candidates=(512, 256, 128, 64, 32))
    bk = _pick_block(skv, block_kv)
    return (sq, skv) if bq is None or bk is None else (bq, bk)


def make_dropout(rate: float, seed, sq: int, skv: int, group: int, block_q: int = 512,
                 block_kv: int = 1024) -> Dropout | None:
    """The call's ``Dropout``, or None when no dropout applies (rate 0 or no seed, as
    the JAX package treats a missing ``dropout_rng``)."""
    if rate <= 0.0 or seed is None:
        return None
    if not rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {rate}")
    return Dropout(float(rate), int(seed) & _M32, *dropout_plan(sq, skv, group, block_q, block_kv))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without leaving int64's range."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors that hold uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_keep(dropout: Dropout, B: int, Hkv: int, group: int, sq: int, skv: int, device=None) -> torch.Tensor:
    """The keep mask of the JAX kernels' ``_keep_for``, bit for bit, as bool
    [B, Hkv, group, sq, skv] (True = kept)."""
    seed, bq, bk = dropout.seed, dropout.bq, dropout.bk
    qpos = torch.arange(sq, dtype=torch.int64, device=device)
    kpos = torch.arange(skv, dtype=torch.int64, device=device)
    g = torch.arange(group, dtype=torch.int64, device=device)
    row = ((g[:, None] * bq + (qpos % bq)[None, :]) * bk)[:, :, None]  # r * bk, [group, sq, 1]
    col = (kpos % bk)[None, None, :]
    block = ((qpos // bq) * 0xC2B2AE35)[:, None] + ((kpos // bk) * 0x27D4EB2F)[None, :]  # [sq, skv]
    out = torch.empty((B, Hkv, group, sq, skv), dtype=torch.bool, device=device)
    for b in range(B):
        for h in range(Hkv):
            key = (block + ((seed + b * 0x9E3779B9 + h * 0x85EBCA6B) & _M32)) & _M32
            bits = _fmix32((_fmix32(key)[None] + row + col) & _M32)
            out[b, h] = bits >= dropout.threshold
    return out


def _check_mask(mi: MaskInfo) -> None:
    if mi.q_positions is not None or mi.kv_positions is not None or mi.kv_len is not None:
        raise ValueError("flash attention takes causal/segment/prefix masks only (no positions or kv_len)")


def flash_fwd_plain(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None,
                    dropout: Dropout | None = None):
    """Plain version of the kernel's arithmetic: q [B, S, Hq, D], k/v [B, S, Hkv, D]
    (model layout) -> (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S, 1] f32)."""
    mi = mask_info or MaskInfo(causal=False)
    _check_mask(mi)
    mask = make_attention_mask(mi, q.shape[1], k.shape[1], q.shape[0], device=q.device)
    return _fwd_plain_masked(q, k, v, mask, scale, dropout)


def _fwd_plain_masked(q, k, v, mask, scale, dropout: Dropout | None = None):
    """The plain forward under a materialized [B, 1, Sq, Skv] mask (or None)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)  # the wrapper-side fold of the JAX kernel
    qf = qs.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())  # base-2 logits [B, Hkv, g, Sq, Skv]
    if mask is not None:
        s = torch.where(mask[:, :, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)  # the undropped p
    if dropout is not None:
        keep = dropout_keep(dropout, B, Hkv, group, Sq, Skv, q.device)
        p = torch.where(keep, p * dropout.keep_scale, torch.zeros_like(p))
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log2(torch.clamp(l, min=1e-30))) * _LN2
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return out, lse.reshape(B, Hq, Sq, 1)


def flash_fwd_tolerance(ref: torch.Tensor) -> tuple[torch.Tensor, float]:
    """(atol, rtol) that holds the forward kernel's out to its plain version, per element:
    |got - ref| <= atol + rtol |ref| with rtol = 2^-7 and atol = 2^-5 of the rms of the
    element's own row of ref (over head_dim; atol is [B, S, Hq, 1]).

    Both sides round p to bf16 before the PV product, the kernel at its running row max
    and the plain version at the final one, and their logits are f32 sums in another
    order; the two final casts to bf16 can land one ulp apart (2^-7 |ref|). A p on the
    other side of its rounding moves its row by 2^-8 p |v|, and a row's rms over head_dim
    is at least the largest p times rms(v), whether the row sees one key or thousands; a
    global rms would not cover the first rows of a causal or packed sequence. Readings of
    chip_smoke.py on one H100 (32/8 heads, D 128), as the largest share of atol that any
    element uses beyond 2^-7 |ref|: prefix-LM 2000 at S 4096 0.3409 without dropout and
    0.3404 at rate 0.1, causal S 4096 0.3357, 8 packed documents 0.3463, S 512 0.2547 to
    0.3365, S 37 0.0154 and 0.0318 with dropout. A keep mask that is wrong on one block of
    the dropout plan moves that block's rows by about 0.2 of their rms at the audio step's
    proportions, six times the limit, and a missing keep scale moves every element by
    about rate |ref|; tests/test_torch_dropout.py plants both."""
    rms = ref.float().pow(2).mean(dim=-1, keepdim=True).sqrt()
    return 2**-5 * rms, 2**-7


def tile_class(q0: int, kv0: int, bq: int, bk: int, S: int, causal: bool, prefix: int | None,
               qseg_range: tuple[int, int] | None, kseg_range: tuple[int, int] | None, q_offset: int = 0,
               kv_offset: int = 0, kv_end: int | None = None) -> str:
    """The class of the tile [q0, q0 + bq) x [kv0, kv0 + bk) of local rows under the flash
    kernels' mask (``make_attention_mask`` at global positions q + q_offset and k + kv_offset:
    base = (q + q_offset >= k + kv_offset if causal) & (same segment), visible = base |
    (q + q_offset < prefix & k + kv_offset < prefix), where base is all True with neither
    causal nor segments and no prefix and all False with a prefix; no query at or past S, no
    key at or past ``kv_end``): "skip" when no element can be visible, "full" when every
    element is, "partial" otherwise. ``prefix`` is the batch row's prefix length or None;
    ``qseg_range`` / ``kseg_range`` the (min, max) of the tile's segment ids below S, or None
    without segments. Self-attention has both offsets 0 and kv_end S. The ring form has the
    q shard's and the kv block's global starts, so a block wholly above the diagonal is
    skipped and one from an earlier shard is full under a causal mask. The offsets form over
    a cache has the row's offsets and kv_end = its kv_len, so a tile at or past kv_len is
    skipped and one that kv_len cuts is never full. The kernels mirror it (csrc/common.cuh:
    tile_class): skip tiles are never loaded, full ones run with no mask code. It is the JAX
    kernels' ``_needed`` and ``_all_true`` with the segment test widened to id ranges: two
    ranges that do not meet share no id."""
    kv_end = S if kv_end is None else kv_end
    if q0 >= S or kv0 >= kv_end:
        return "skip"
    qa, ka = q0 + q_offset, kv0 + kv_offset  # global starts
    segs = qseg_range is not None
    has_base, has_prefix = causal or segs, prefix is not None
    base_skip = (causal and qa + bq - 1 < ka) or (not has_base and has_prefix)
    base_full = (not causal or qa >= ka + bk - 1) and (has_base or not has_prefix)
    if segs and not base_skip:
        (qlo, qhi), (klo, khi) = qseg_range, kseg_range
        base_skip = qhi < klo or khi < qlo
        base_full = base_full and qlo == qhi == klo == khi
    pre_any = has_prefix and qa < prefix and ka < prefix
    pre_full = has_prefix and qa + bq <= prefix and ka + bk <= prefix
    if base_skip and not pre_any:
        return "skip"
    if (base_full or pre_full) and q0 + bq <= S and kv0 + bk <= kv_end:
        return "full"
    return "partial"


def segment_ranges(seg: torch.Tensor | None) -> torch.Tensor | None:
    """[B, ceil(S / SEG_CHUNK), 2] int32: the min and max id of every SEG_CHUNK positions of
    each row of ``seg`` [B, S] (the last chunk over the positions below S), from which the
    kernels take a tile's id range; None without segments."""
    if seg is None:
        return None
    B, S = seg.shape
    n = -(-S // SEG_CHUNK)
    pad = n * SEG_CHUNK - S
    x = seg if pad == 0 else torch.cat([seg, seg[:, -1:].expand(B, pad)], dim=1)
    x = x.reshape(B, n, SEG_CHUNK)
    return torch.stack([x.amin(dim=-1), x.amax(dim=-1)], dim=-1).to(torch.int32).contiguous()


def _check_qkv(q, k, v):
    """What both kernels take: bf16 self-attention operands on one card, head_dim 64 or
    128, Hq a multiple of Hkv. Returns them contiguous."""
    B, S, Hq, D = q.shape
    if k.shape[:2] != (B, S) or k.shape != v.shape or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (self-attention, same S)")
    Hkv = k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in (64, 128):
        raise ValueError(f"the flash kernels take head_dim 64 or 128, got {D}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernels take bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("q, k, v must be 16-byte aligned")
    return q, k, v


def _mask_operands(mi: MaskInfo, B: int, S: int, dev):
    """(qseg [B, S], kseg [B, S], their ``segment_ranges``, prefix [B]) as int32 on
    ``dev``, None where absent."""
    def ids(x):
        return None if x is None else x.to(device=dev, dtype=torch.int32).expand(B, S).contiguous()

    qseg = ids(mi.segment_ids)
    kseg = qseg if mi.kv_segment_ids is None else ids(mi.kv_segment_ids)
    qrange = segment_ranges(qseg)
    krange = qrange if kseg is qseg else segment_ranges(kseg)
    prefix = None if mi.prefix_len is None else mi.prefix_len.to(device=dev, dtype=torch.int32).reshape(B).contiguous()
    return qseg, kseg, qrange, krange, prefix


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dropout_args(dropout: Dropout | None, skv: int) -> tuple:
    """The kernels' dropout arguments (on, threshold, keep scale, seed, bq, bk). The
    kernels hoist the block key per kv tile (128 positions in K2 and K5's dkv kernel, 64
    in its dq kernel), so a tile must not straddle two kv blocks of the plan."""
    if dropout is None:
        return 0, 0, 1.0, 0, 1, 1
    if dropout.bk % _TILE and dropout.bk != skv:
        raise ValueError(f"the dropout plan's kv block {dropout.bk} must be a multiple of {_TILE} or span the sequence")
    return 1, dropout.threshold, dropout.keep_scale, dropout.seed, dropout.bq, dropout.bk


def _launch(q, k, v, mi: MaskInfo, scale: float, dropout: Dropout | None = None, offsets: tuple[int, int] = (0, 0),
            counter=None):
    """K2 on self-attention operands; ``offsets``: the ring form's (q_offset, kv_offset);
    ``counter``: the wrapper whose ``launches`` this call adds to."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    q, k, v = _check_qkv(q, k, v)
    _check_mask(mi)
    dev = q.device
    qseg, kseg, qrange, krange, prefix = _mask_operands(mi, B, S, dev)
    drop = _dropout_args(dropout, S)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S, 1), dtype=torch.float32, device=dev)
    if B == 0 or S == 0:
        return out, lse
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches.add(counter or flash_fwd_with_lse)
    build.check(
        lib.lxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(qseg), _ptr(kseg), _ptr(qrange), _ptr(krange),
            _ptr(prefix), out.data_ptr(), lse.data_ptr(),
            B, S, Hq, Hkv, D, int(bool(mi.causal)), int(offsets[0]), int(offsets[1]), float(scale * _LOG2E), *drop,
            stream,
        ),
        "flash_attention",
    )
    return out, lse


def _forward_impl(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None,
                  dropout: Dropout | None = None):
    """(out, lse) without autograd: the kernel on CUDA tensors, its plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask_info, scale, dropout)
    mi = mask_info or MaskInfo(causal=False)
    return _launch(q, k, v, mi, 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale, dropout)


def flash_bwd_plain(q, k, v, out, lse, do, mask_info: MaskInfo | None = None, scale: float | None = None,
                    dropout: Dropout | None = None):
    """Plain version of the backward kernel's arithmetic, rounding points included:
    model-layout q/out/do [B, S, Hq, D], k/v [B, S, Hkv, D], lse [B, Hq, S, 1] f32 ->
    (dq, dk, dv) in the inputs' layouts and dtypes."""
    mi = mask_info or MaskInfo(causal=False)
    _check_mask(mi)
    mask = make_attention_mask(mi, q.shape[1], k.shape[1], q.shape[0], device=q.device)
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2)  # [B, Hq, Sq]
    dq, dk, dv = _bwd_plain_masked(q, k, v, lse, do, delta, mask, scale, dropout)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_plain_masked(q, k, v, lse, do, delta, mask, scale, dropout: Dropout | None = None):
    """The plain backward under a materialized mask with delta [B, Hq, Sq] f32 given;
    returns f32 (dq, dk, dv), before any cast."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    fold = scale * _LOG2E
    qs = (q.float() * fold).to(q.dtype)  # the forward's fold, bit for bit
    qf = qs.reshape(B, Sq, Hkv, group, D).float()
    dof = do.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())  # base-2 logits [B, Hkv, g, Sq, Skv]
    p = torch.exp2(s - lse.reshape(B, Hkv, group, Sq, 1) * _LOG2E)
    if mask is not None:
        p = torch.where(mask[:, :, None], p, torch.zeros_like(p))
    delta = delta.reshape(B, Hkv, group, Sq, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    p_v = p
    if dropout is not None:  # the forward's mask, rebuilt: dV sees p * keep, dp is masked, ds keeps the undropped p
        keep = dropout_keep(dropout, B, Hkv, group, Sq, Skv, q.device)
        p_v = torch.where(keep, p * dropout.keep_scale, torch.zeros_like(p))
        dp = torch.where(keep, dp * dropout.keep_scale, torch.zeros_like(dp))
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p_v.to(do.dtype).float(), dof)
    ds = (p * (dp - delta) * _LN2).to(q.dtype).float()
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * fold
    return dq.reshape(B, Sq, Hq, D), dk, dv


def flash_bwd_tolerance(ref: torch.Tensor) -> tuple[float, float]:
    """(atol, rtol) that holds one of the backward kernel's outputs to its plain version,
    per element: |got - ref| <= atol + rtol |ref| with rtol = 2^-7 and atol = 2^-5 rms(ref).

    Both sides round p and ds to bf16 at the same places, but their logits are f32 sums in
    another order, so now and then a p or ds falls on the other side of a bf16 rounding,
    and the two final casts to bf16 can land one ulp apart: 2^-7 |ref|. One flipped ds
    moves its whole dq row and dk row by 2^-8 of that one term, and a row that sees few
    keys (the start of a packed document) has terms far above the output's rms; the rms
    term covers those. Readings on one H100 at B 1, S 4096, 32/8 heads, D 128, as the
    largest excess over 2^-7 |ref| in units of rms(ref): causal 2^-6.7 and 2^-7.0 (two
    seeds), prefix-LM 2000 2^-7.8, 8 packed documents 2^-5.7 (dq: 2.598e-03 where
    rms(ref) is 0.137). A mask one position off, a lost GQA group member or a missing ln2
    moves elements by rms(ref) or more, 32 times the limit."""
    return 2**-5 * float(ref.float().pow(2).mean().sqrt()), 2**-7


def _launch_bwd(q, k, v, out, lse, do, mi: MaskInfo, scale: float, dropout: Dropout | None = None,
                offsets: tuple[int, int] = (0, 0), ring=None):
    """K5; ``ring``: the offsets form's (delta, dq_acc, dk_acc, dv_acc), f32, which the kernels
    read (delta) and add into (the rest) at ``offsets``; None: bf16 dq, dk, dv are returned."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    q, k, v = _check_qkv(q, k, v)
    _check_mask(mi)
    if out.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (B, Hq, S, 1):
        raise ValueError(f"out {tuple(out.shape)}, do {tuple(do.shape)}, lse {tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if out.dtype != torch.bfloat16 or do.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise TypeError(f"the flash backward takes bfloat16 out/do and float32 lse, got {out.dtype}/{do.dtype}/{lse.dtype}")
    dev = q.device
    out, do, lse = out.contiguous(), do.contiguous(), lse.contiguous()
    if out.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("out and do must be 16-byte aligned")
    qseg, kseg, qrange, krange, prefix = _mask_operands(mi, B, S, dev)
    drop = _dropout_args(dropout, S)
    # the folded q, written by the dq kernel for the dkv kernel
    qs = torch.empty_like(q)
    if ring is None:
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        # delta = rowsum(dO * O) in f32, laid out like lse: written by the dq kernel
        delta = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
    else:
        delta, dq, dk, dv = ring
        for t, want in ((delta, (B, Hq, S)), (dq, tuple(q.shape)), (dk, tuple(k.shape)), (dv, tuple(v.shape))):
            if tuple(t.shape) != want or t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
                raise ValueError(f"the offsets form takes contiguous f32 delta / accumulators on q's device, "
                                 f"got {tuple(t.shape)} {t.dtype} for {want}")
    if B == 0 or S == 0:
        return dq, dk, dv
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches.add(flash_bwd_from_res if ring is None else flash_bwd_ring)
    build.check(
        lib.lxt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(qseg), _ptr(kseg), _ptr(qrange), _ptr(krange), _ptr(prefix), qs.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, Hq, Hkv, D, int(bool(mi.causal)), int(offsets[0]), int(offsets[1]), int(ring is not None),
            float(scale * _LOG2E), *drop, stream,
        ),
        "flash_attention_bwd",
    )
    return dq, dk, dv


def flash_bwd_from_res(q, k, v, out, lse, do, mask_info: MaskInfo | None = None, scale: float | None = None,
                       dropout: Dropout | None = None):
    """(dq, dk, dv) from the forward's saved (out, lse): the kernel on CUDA tensors,
    its plain version on CPU tensors. The counterpart of ``flash_fwd_with_lse``;
    ``dropout`` is the forward's (``make_dropout``)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, lse, do, mask_info, scale, dropout)
    mi = mask_info or MaskInfo(causal=False)
    return _launch_bwd(q, k, v, out, lse, do, mi, 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale, dropout)


launches.counted("flash_attention_bwd", flash_bwd_from_res, r"flash_bwd_dkv_kernel<\d+, \w+, false>")


class _FlashAttention(torch.autograd.Function):
    """out, lse = flash forward; the backward runs from the saved q, k, v, out, lse.
    lse carries no gradient (as in the JAX custom_vjp, which returns out alone).
    ``preset``: an (out, lse) pair kept from an earlier forward on the same inputs (a
    remat policy's saved flash residuals); the forward then returns it and launches
    nothing, and the backward is the same."""

    @staticmethod
    def forward(ctx, q, k, v, mask_info, scale, dropout, preset):
        if preset is None:
            out, lse = _forward_impl(q, k, v, mask_info, scale, dropout)
        else:
            out, lse = (t.detach() for t in preset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask_info, ctx.scale, ctx.dropout = mask_info, scale, dropout
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_from_res(q, k, v, out, lse, do, ctx.mask_info, ctx.scale, ctx.dropout)
        return dq, dk, dv, None, None, None, None


def flash_fwd_with_lse(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None,
                       dropout_rate: float = 0.0, dropout_seed=None, block_q: int = 512, block_kv: int = 1024,
                       preset=None):
    """Model-layout [B, S, H, D] in and out, plus the fp32 natural-log lse
    [B, Hq, S, 1]; differentiable in q, k, v. The kernels on CUDA tensors, their plain
    versions on CPU tensors. Dropout applies when ``dropout_rate`` > 0 and a
    ``dropout_seed`` (32 bits) is given; ``block_q`` / ``block_kv`` are the JAX plan's
    targets, which only key the dropout hash here."""
    dropout = make_dropout(dropout_rate, dropout_seed, q.shape[1], k.shape[1], q.shape[2] // max(k.shape[2], 1),
                           block_q, block_kv)
    return _FlashAttention.apply(q, k, v, mask_info, scale, dropout, preset)


launches.counted("flash_attention", flash_fwd_with_lse, r"flash_fwd_kernel<\d+, \w+, false>")


def flash_attention(q, k, v, mask_info: MaskInfo | None = None, scale: float | None = None,
                    dropout_rate: float = 0.0, dropout_seed=None, block_q: int = 512, block_kv: int = 1024):
    """Flash attention over the model's [B, S, H, D] layout (output only)."""
    return flash_fwd_with_lse(q, k, v, mask_info, scale, dropout_rate, dropout_seed, block_q, block_kv)[0]


# ---------------------------------------------------------------------------
# the ring form (ring attention's per-block calls)
# ---------------------------------------------------------------------------


def ring_block_mask(mask_info: MaskInfo, B: int, S: int, q_offset: int, kv_offset: int, device="cpu"):
    """[B, 1, S, S] bool mask (or None) on ``device`` of one ring block: ``mask_info``'s causal
    flag, local q segment ids, the kv block's segment ids (``kv_segment_ids``) and the prefix
    lengths, at global positions q_offset + i and kv_offset + j (the JAX ring's
    ``block_mask_info``)."""
    ar = torch.arange(S, dtype=torch.int32, device=device)
    block = mask_info._replace(q_positions=ar + int(q_offset), kv_positions=ar + int(kv_offset))
    return make_attention_mask(block, S, S, B, device=device)


def _check_ring(mi: MaskInfo) -> None:
    _check_mask(mi)
    if (mi.kv_segment_ids is None) != (mi.segment_ids is None):
        raise ValueError("the ring form takes the q shard's segment_ids with the kv block's kv_segment_ids")


def flash_fwd_ring_plain(q, k, v, mask_info: MaskInfo, q_offset: int, kv_offset: int, scale: float | None = None):
    """Plain version of K2's ring form: ``flash_fwd_plain``'s arithmetic under
    ``ring_block_mask``. q [B, S, Hq, D], k / v [B, S, Hkv, D] (one shard each) ->
    (out [B, S, Hq, D] in q's dtype, lse [B, Hq, S, 1] f32). A row that sees no key of the
    block has lse (-1e30 + log2(S)) ln2, -1e30 ln2 in f32 as in the kernel, and an out that
    the ring's lse merge weighs by exactly 0 (the kernels may leave 0 there)."""
    _check_ring(mask_info)
    mask = ring_block_mask(mask_info, q.shape[0], q.shape[1], q_offset, kv_offset, q.device)
    return _fwd_plain_masked(q, k, v, mask, scale)


def flash_fwd_ring(q, k, v, mask_info: MaskInfo, q_offset: int, kv_offset: int, scale: float | None = None):
    """K2's ring form: the block attention of the local q shard (global positions q_offset +
    i) over one kv block (kv_offset + j) with ``mask_info``'s causal flag, q ``segment_ids``,
    the block's ``kv_segment_ids`` and ``prefix_len`` tested at global positions -> (bf16 out,
    f32 natural-log lse [B, Hq, S, 1]). The kernel on CUDA tensors (head_dim 64 or 128,
    bfloat16; anything else raises), its plain version on CPU tensors. No autograd: ring
    attention's autograd function calls it."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return flash_fwd_ring_plain(q, k, v, mask_info, q_offset, kv_offset, scale)
    _check_ring(mask_info)
    return _launch(q, k, v, mask_info, scale, None, (q_offset, kv_offset), counter=flash_fwd_ring)


launches.counted("flash_attention_ring", flash_fwd_ring, r"flash_fwd_kernel<\d+, \w+, false>")


def flash_bwd_ring_plain(q, k, v, out, lse, do, delta, mask_info: MaskInfo, q_offset: int, kv_offset: int,
                         scale: float | None = None):
    """Plain version of K5's offsets form: f32 (dq, dk, dv) of one ring block from the ring's
    final merged ``out`` / ``lse`` and ``delta`` = rowsum(dO * out) [B, Hq, S] f32 (the JAX
    ``_bwd(offsets=, delta=, cast=False)``). ``out`` is unread: delta carries it."""
    _check_ring(mask_info)
    mask = ring_block_mask(mask_info, q.shape[0], q.shape[1], q_offset, kv_offset, q.device)
    return _bwd_plain_masked(q, k, v, lse, do, delta, mask, scale)


def flash_bwd_ring(q, k, v, out, lse, do, delta, accumulators, mask_info: MaskInfo, q_offset: int,
                   kv_offset: int, scale: float | None = None) -> None:
    """K5's offsets form: ADDS this ring block's f32 dq, dk, dv into ``accumulators`` = (dq
    [B, S, Hq, D], dk, dv [B, S, Hkv, D]), all f32, given the ring's final ``out`` (bf16),
    ``lse`` [B, Hq, S, 1] and ``delta`` [B, Hq, S] f32. The kernels on CUDA tensors (they add
    in place), the plain version on CPU tensors."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        for acc, g in zip(accumulators, flash_bwd_ring_plain(q, k, v, out, lse, do, delta, mask_info, q_offset,
                                                             kv_offset, scale)):
            acc += g
        return
    _check_ring(mask_info)
    _launch_bwd(q, k, v, out, lse, do, mask_info, scale, None, (q_offset, kv_offset),
                ring=(delta.contiguous(), *accumulators))


launches.counted("flash_attention_bwd_ring", flash_bwd_ring, r"flash_bwd_dkv_kernel<\d+, \w+, true>")


# ---------------------------------------------------------------------------
# the offsets form over a KV cache
# ---------------------------------------------------------------------------


def offsets_mask(q_offset, kv_offset, kv_len, Sq: int, Skv: int) -> torch.Tensor:
    """[B, Sq, Skv] bool: query i of row b sees cache entry j iff q_offset[b] + i >=
    kv_offset[b] + j and j < kv_len[b]."""
    dev = q_offset.device
    i = torch.arange(Sq, device=dev)
    j = torch.arange(Skv, device=dev)
    qpos = q_offset.long().reshape(-1, 1) + i
    kpos = kv_offset.long().reshape(-1, 1) + j
    return (qpos[:, :, None] >= kpos[:, None, :]) & (j[None, None, :] < kv_len.long().reshape(-1, 1, 1))


def flash_fwd_offsets_plain(q, k, v, q_offset, kv_offset, kv_len, scale: float | None = None):
    """Plain version of the offsets form's arithmetic: q [B, Sq, Hq, D] in the model's
    layout, k / v [B, Hkv, Skv, D] in the cache's, q_offset / kv_offset / kv_len [B] ->
    (out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq, 1] f32). The same fold of q, base-2
    softmax, -1e30 masking, l == 0 guard and natural-log lse as ``flash_fwd_plain``."""
    B, Sq, Hq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qs = (q.float() * (scale * _LOG2E)).to(q.dtype)
    qf = qs.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, k.float())  # base-2 logits [B, Hkv, g, Sq, Skv]
    mask = offsets_mask(q_offset, kv_offset, kv_len, Sq, Skv)[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    out = pv / torch.where(l == 0.0, torch.ones_like(l), l)
    lse = (m + torch.log2(torch.clamp(l, min=1e-30))) * _LN2
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return out, lse.reshape(B, Hq, Sq, 1)


def _row_ints(x, B: int, dev) -> torch.Tensor:
    """[B] int32 on ``dev`` from a per-row tensor (or one broadcast over the rows)."""
    return x.to(device=dev, dtype=torch.int32).reshape(-1).expand(B).contiguous()


def _launch_offsets(q, k, v, q_offset, kv_offset, kv_len, scale: float):
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} / {tuple(v.shape)} are not a [B, Hkv, S, D] cache for q {tuple(q.shape)}")
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in (64, 128):
        raise ValueError(f"the flash kernels take head_dim 64 or 128, got {D}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"the flash kernels take bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    q = q.contiguous()
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the cache is read in place: k and v must be contiguous and 16-byte aligned")
    dev = q.device
    q_off, kv_off, lens = (_row_ints(t, B, dev) for t in (q_offset, kv_offset, kv_len))
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=dev)
    if B == 0 or Sq == 0:
        return out, lse
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches.add(flash_fwd_offsets)
    build.check(
        lib.lxt_flash_attention_fwd_offsets(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_off.data_ptr(), kv_off.data_ptr(), lens.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, float(scale * _LOG2E), stream,
        ),
        "flash_attention_offsets",
    )
    return out, lse


def flash_fwd_offsets(q, k, v, q_offset, kv_offset, kv_len, scale: float | None = None):
    """The offsets form over a bf16 KV cache: q [B, Sq, Hq, D], k / v [B, Hkv, S_max, D]
    (a layer of the cache, read in place), q_offset / kv_offset / kv_len [B] -> (out
    [B, Sq, Hq, D], lse [B, Hq, Sq, 1] f32). The kernel on CUDA tensors (head_dim 64 or
    128, bfloat16, contiguous cache; anything else raises), its plain version on CPU
    tensors. No autograd: serving reads it."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return flash_fwd_offsets_plain(q, k, v, q_offset, kv_offset, kv_len, scale)
    return _launch_offsets(q, k, v, q_offset, kv_offset, kv_len, scale)


launches.counted("flash_attention_offsets", flash_fwd_offsets, r"flash_fwd_kernel<\d+, \w+, true>")


def dequant_live(data: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    """The first ``n`` positions of an int8 cache side ([B, Hkv, S_max, D] data, [B, Hkv,
    S_max] f32 scales) as bf16 [B, Hkv, n, D]: data * scale, rounded to bf16 once (the JAX
    package's ``dequant_kv``)."""
    return (data[:, :, :n] * scale[:, :, :n, None]).to(torch.bfloat16)  # int8 * f32 computes in f32


def flash_fwd_offsets_int8(q, k_i8, k_scale, v_i8, v_scale, q_offset, kv_offset, kv_len, kv_max: int,
                           scale: float | None = None):
    """The offsets form over an int8 cache: the live prefix [0, kv_max) of each side
    (``kv_max`` >= every row's kv_len, known on the host) is dequantized to bf16 in plain
    PyTorch, then the bf16 form runs over it."""
    n = max(1, min(int(kv_max), k_i8.shape[2]))
    k, v = dequant_live(k_i8, k_scale, n), dequant_live(v_i8, v_scale, n)
    return flash_fwd_offsets(q, k, v, q_offset, kv_offset, torch.clamp(kv_len, max=n), scale)


def wgmma_check(a: torch.Tensor, b: torch.Tensor, b_mn_major: bool) -> torch.Tensor:
    """One bare wgmma product through the flash kernels' building blocks
    (csrc/wgmma_check.cu), for the card tests: a bf16 [64, 64] times b, where b is [N, 64]
    read K-major (a @ b.T, both operands from shared memory) or [64, N] read MN-major
    (a @ b, a from registers); N is 64 or 128. Returns f32 [64, N]. CUDA tensors only."""
    n = b.shape[1] if b_mn_major else b.shape[0]
    if a.shape != (64, 64) or b.shape != ((64, n) if b_mn_major else (n, 64)) or n not in (64, 128):
        raise ValueError(f"a must be [64, 64] and b [N, 64] or [64, N] with N 64 or 128, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or not (a.is_cuda and b.is_cuda):
        raise TypeError("wgmma_check takes bfloat16 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, n), dtype=torch.float32, device=a.device)
    lib = build.load_library()
    build.check(lib.lxt_wgmma_check(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, int(b_mn_major),
                                    torch.cuda.current_stream(a.device).cuda_stream), "wgmma_check")
    return c
