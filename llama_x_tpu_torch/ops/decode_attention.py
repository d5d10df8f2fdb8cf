"""Decode attention: a few queries per row over the static KV cache (kernel K3,
``csrc/decode_attention.cu``).

Port of llama_x_tpu/ops/decode_attention.py (``decode_attention``,
``decode_attention_int8``, ``MAX_SQ``, ``effective_lens``). The TPU's routing gate
(``D % 128``, a TPU measurement) is not copied: on the card every decode step takes
the kernel, and a shape the kernel cannot hold raises.

Contract, as in the JAX package: q [B, Sq, Hq, D] in the model layout (Sq <=
MAX_SQ); the cache in its storage layout [B, Hkv, S_max, D] (bf16), or int8 data
with f32 per-position scales [B, Hkv, S_max]; ``kv_len`` [B] or [B, Sq] window
lengths (``effective_lens``). Returns [B, Sq, Hq, D] in q's dtype. On CPU tensors
the wrappers run the plain versions below; on CUDA tensors they launch the kernel
or raise.

The kernel splits the cache into ``decode_split_plan`` ranges, one CTA each, and
merges their partial softmax states; ``decode_attention_split_plain`` writes that
arithmetic out. The plan depends on the cache's size only, never on the windows, so
the wrapper reads nothing back from the card.
"""

from __future__ import annotations

import functools

import torch

from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.utils import build

_NEG_INF = -1e30

# largest query count one kernel cell packs (speculative verify uses Sq = gamma + 1)
MAX_SQ = 8
# most query rows (Sq x GQA group) one CTA holds: four 16-row tiles of mma fragments
_MAX_ROWS = 64
# the kernel's kv tile; a split's range is a whole number of tiles
SPLIT_TILE = 64
# CTAs the split plan aims for: four for each of an H100's 132 SMs (at B 4, 8 kv heads,
# S_max 4096: 16 splits of 256 positions). A CTA's tiles run one after another, each
# waiting on its loads, so short ranges let more CTAs share a window (a serving window
# of some 576 positions is read by 3 CTAs a head); the CTAs whose range starts past
# every window exit at once, and the merge reads one partial per split
TARGET_CTAS = 4 * 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def decode_split_plan(S_max: int, B: int, Hkv: int, target: int = TARGET_CTAS) -> tuple[int, int]:
    """(splits, split_len): the cache's S_max positions cut into ``splits`` ranges of
    ``split_len`` (a multiple of SPLIT_TILE; the last may run past S_max) so that the
    (splits, Hkv, B) grid has about ``target`` CTAs. From the shapes alone: the windows
    are never read on the host."""
    tiles = _cdiv(S_max, SPLIT_TILE)
    per = _cdiv(tiles, max(1, min(tiles, _cdiv(target, B * Hkv))))
    return _cdiv(tiles, per), per * SPLIT_TILE


def effective_lens(mi, B: int, Sq: int = 1) -> torch.Tensor:
    """Oracle semantics: causal AND kv_pos < kv_len — with explicit query positions
    each query's window is min(kv_len, q_pos + 1). Returns [B, Sq] int32."""
    lens = mi.kv_len.to(torch.int32).reshape(-1)[:, None].expand(B, Sq)
    if mi.q_positions is not None:
        qp = mi.q_positions.to(torch.int32)
        qp = (qp[None, -Sq:] if qp.ndim == 1 else qp[:, -Sq:]).expand(B, Sq)
        lens = torch.minimum(lens, qp + 1)
    return lens.contiguous()


def _lens2d(kv_len: torch.Tensor, B: int, Sq: int) -> torch.Tensor:
    lens = kv_len.to(torch.int32)
    lens = lens.reshape(-1)[:, None] if lens.ndim <= 1 else lens
    return lens.expand(B, Sq).contiguous()


def dequant_in(data: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 cache side -> ``dtype``: data x scale computed in ``dtype`` (the kernel's
    in-tile dequant, which rounds as the Pallas kernel does)."""
    return data.to(dtype) * scale.to(dtype)[..., None]


def decode_attention_plain(q, k_cache, v_cache, kv_len, scale: float):
    """Plain version of the kernel's arithmetic over a float cache (materialized
    scores; fp32 softmax in natural exp; P rounded to the value dtype before P V;
    masked logits -1e30; l == 0 guarded)."""
    B, Sq, Hq, D = q.shape
    _, Hkv, S_max, _ = k_cache.shape
    group = Hq // Hkv
    lens = _lens2d(kv_len, B, Sq)  # [B, Sq]
    qf = q.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bhkd->bhqgk", qf, k_cache.float()) * scale  # [B, Hkv, Sq, g, S]
    pos = torch.arange(S_max, device=q.device)
    valid = pos[None, None, :] < lens[:, :, None]  # [B, Sq, S]
    s = torch.where(valid[:, None, :, None, :], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhqgk,bhkd->bhqgd", p.to(v_cache.dtype).float(), v_cache.float())
    out = pv / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_split_plain(q, k_cache, v_cache, kv_len, scale: float, splits: int, split_len: int):
    """The kernel's split arithmetic written plainly. Split i covers positions [i split_len,
    (i + 1) split_len) up to the batch row's longest window; a split that starts at or
    past it is empty (m -1e30, l 0). Each live split keeps its own (m, l, acc) with P
    rounded to the value dtype at the split's max; the splits merge in order as
    out = sum acc_i e^(m_i - M) / sum l_i e^(m_i - M), empty ones skipped, l == 0 guarded.
    Agrees with ``decode_attention_plain`` up to where P is rounded (and on rows whose
    window is empty, which no caller makes)."""
    B, Sq, Hq, D = q.shape
    _, Hkv, S_max, _ = k_cache.shape
    group = Hq // Hkv
    lens = _lens2d(kv_len, B, Sq)
    qf = q.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bhkd->bhqgk", qf, k_cache.float()) * scale  # [B, Hkv, Sq, g, S]
    pos = torch.arange(S_max, device=q.device)
    valid = pos[None, None, :] < lens[:, :, None]  # [B, Sq, S]
    s = torch.where(valid[:, None, :, None, :], s, torch.full_like(s, _NEG_INF))
    max_len = lens.clamp(max=S_max).amax(dim=1)  # [B]
    parts = []
    for i in range(splits):
        a = i * split_len
        e = min(a + split_len, S_max)
        if a >= S_max:
            break
        live = pos[None, a:e] < max_len[:, None]  # [B, positions]: the split's part up to the longest window
        si = torch.where(live[:, None, None, None, :], s[..., a:e], torch.full_like(s[..., a:e], float("-inf")))
        m = si.amax(dim=-1, keepdim=True)
        p = torch.exp(si - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhqgk,bhkd->bhqgd", p.to(v_cache.dtype).float(), v_cache[:, :, a:e].float())
        empty = (max_len <= a)[:, None, None, None, None]
        parts.append((torch.where(empty, torch.full_like(m, _NEG_INF), m), torch.where(empty, torch.zeros_like(l), l),
                      torch.where(empty, torch.zeros_like(acc), acc)))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(m))
        L = L + l * w
        A = A + acc * w
    out = A / torch.where(L == 0.0, torch.ones_like(L), L)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention_int8_plain(q, k_i8, k_scale, v_i8, v_scale, kv_len, scale: float):
    return decode_attention_plain(
        q, dequant_in(k_i8, k_scale, q.dtype), dequant_in(v_i8, v_scale, q.dtype), kv_len, scale
    )


def _launch(q, k, v, k_scale, v_scale, kv_len, scale, quantized, counter):
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"cache {tuple(k.shape)} / {tuple(v.shape)} does not fit q {tuple(q.shape)}")
    Hkv, S_max = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the decode kernel takes bfloat16 queries, got {q.dtype}")
    if D not in (64, 128):
        raise ValueError(f"the decode kernel takes head_dim 64 or 128, got {D}")
    want = torch.int8 if quantized else torch.bfloat16
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"cache must be {want}, got {k.dtype}/{v.dtype}")
    if not 1 <= Sq <= MAX_SQ or Hq % Hkv or Sq * (Hq // Hkv) > _MAX_ROWS:
        raise ValueError(f"Sq={Sq} (<= {MAX_SQ}) x group={Hq // max(Hkv, 1)} exceeds the kernel's rows")
    for t in (q, k, v, *((k_scale, v_scale) if quantized else ())):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("all operands must lie on q's CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attention operands must be contiguous and 16-byte aligned")
    if quantized:
        if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
            raise ValueError("scales must be [B, Hkv, S_max]")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError("cache scales must be float32")
    if kv_len.dtype == torch.int32 and kv_len.shape == (B, Sq) and kv_len.device == q.device and kv_len.is_contiguous():
        lens = kv_len  # effective_lens' own form: nothing to convert
    else:
        lens = _lens2d(kv_len.to(q.device), B, Sq)
    out = torch.empty_like(q)
    splits, split_len = decode_split_plan(S_max, B, Hkv)
    rows = Sq * (Hq // Hkv)
    acc_ptr = ml_ptr = None
    if splits > 1:  # f32 partials (acc, then m and l) that the merge kernel combines: one count a call;
        # under a CUDA graph's capture they come from the graph's pool
        n_acc = B * Hkv * splits * rows * D
        part = torch.empty(n_acc + 2 * B * Hkv * splits * rows, dtype=torch.float32, device=q.device)
        acc_ptr, ml_ptr = part.data_ptr(), part.data_ptr() + 4 * n_acc
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launches.add(counter)
    build.check(
        lib.lxt_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
            lens.data_ptr(), out.data_ptr(), acc_ptr, ml_ptr, B, Sq, Hq, Hkv, S_max, D, float(scale),
            int(quantized), splits, split_len, stream,
        ),
        "decode_attention_int8" if quantized else "decode_attention",
    )
    return out


def decode_attention(q, k_cache, v_cache, kv_len, scale: float):
    """Decode attention over a bf16 (or, on the CPU, any float) cache."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)
    return _launch(q.contiguous(), k_cache, v_cache, None, None, kv_len, scale, False, decode_attention)


def decode_attention_int8(q, k_i8, k_scale, v_i8, v_scale, kv_len, scale: float):
    """Decode attention over an int8 cache with f32 per-position scales."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_i8, k_scale, v_i8, v_scale, kv_len, scale)
    return _launch(q.contiguous(), k_i8, v_i8, k_scale, v_scale, kv_len, scale, True, decode_attention_int8)


launches.counted("decode_attention", decode_attention, r"decode_kernel<false")
launches.counted("decode_attention_int8", decode_attention_int8, r"decode_kernel<true")
