"""The flash probe (kernel K6, ``csrc/flash_probe.cu``): a matmul-only attention that
bounds what the flash forward's two products cost without its softmax. It runs K2's own
main loop (wgmma, TMA ring, tile classes) with the softmax taken out, so the gap between
K2 and the probe isolates what K2's online softmax, masking and rescaling cost.

Port of the probe kernel of tools/probe_flash.py (``probe_kernel``): for the plan
(bq, bk) and a prefix length,

    out = sum over the needed (i, j) blocks of bf16(Q_i K_j^T) V_j     (f32 accumulator)
    need(i, j) = (i*bq + bq - 1 >= j*bk) | ((i*bq < prefix) & (j*bk < prefix))

q is not scaled, the logits are rounded to the inputs' dtype before the second product,
and inside a needed block nothing is masked: the skip is whole-block, as the TPU
kernel's. The port keeps the model's [B, S, H, D] layout (the TPU tool transposes to
head-major around its kernel). On CPU tensors ``flash_probe`` runs ``flash_probe_plain``;
on CUDA tensors it launches the kernel or raises (bf16, head_dim 64 or 128, bq and bk
multiples of 64 that divide S). The kernel walks 128 x 128 tiles; ``probe_tile_class``
says which it skips, which it runs with no mask code, and which it masks per element.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.ops.flash_attention import _check_qkv
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.utils import build

_TILE = 64  # bq and bk are multiples of this: a consumer warpgroup's 64 rows lie in one q block
PROBE_TILE = 128  # the kernel's q and kv tile


def needed_blocks(S: int, bq: int, bk: int, prefix: int, device=None) -> torch.Tensor:
    """bool [S // bq, S // bk]: the (q block, kv block) pairs the probe computes."""
    q_start = torch.arange(S // bq, device=device)[:, None] * bq
    kv_start = torch.arange(S // bk, device=device)[None, :] * bk
    return (q_start + bq - 1 >= kv_start) | ((q_start < prefix) & (kv_start < prefix))


def probe_tile_class(q0: int, kv0: int, nq: int, nk: int, S: int, bq: int, bk: int, prefix: int) -> str:
    """The class of the tile [q0, q0 + nq) x [kv0, kv0 + nk) under the probe's plan, which
    the kernel mirrors (csrc/flash_probe.cu: tile_class): "skip" when no (bq, bk) block it
    touches below S is needed (never loaded), "full" when every one is (no mask code),
    "partial" otherwise (S zeroed per element outside the needed blocks)."""
    if q0 >= S or kv0 >= S:
        return "skip"
    need = [(i * bq + bq - 1 >= j * bk) or (i * bq < prefix and j * bk < prefix)
            for i in range(q0 // bq, (min(q0 + nq, S) - 1) // bq + 1)
            for j in range(kv0 // bk, (min(kv0 + nk, S) - 1) // bk + 1)]
    return "full" if all(need) else "partial" if any(need) else "skip"


def tile_census(S: int, bq: int, bk: int, prefix: int) -> dict:
    """The kernel's 128 x 128 tiles of one head by class, and the share of the (q, kv)
    pairs that the needed blocks hold (what the kernel computes)."""
    n = {"skip": 0, "partial": 0, "full": 0}
    for q0 in range(0, S, PROBE_TILE):
        for kv0 in range(0, S, PROBE_TILE):
            n[probe_tile_class(q0, kv0, PROBE_TILE, PROBE_TILE, S, bq, bk, prefix)] += 1
    pairs = float(needed_blocks(S, bq, bk, prefix).sum()) * bq * bk / (S * S)
    return {**n, "pairs_needed": pairs}


def _check_plan(S: int, bq: int, bk: int) -> None:
    if bq <= 0 or bk <= 0 or S % bq or S % bk:
        raise ValueError(f"bq={bq} and bk={bk} must divide S={S}")


def flash_probe_plain(q, k, v, bq: int, bk: int, prefix: int = 0):
    """Plain version of the kernel's arithmetic: q [B, S, Hq, D], k/v [B, S, Hkv, D] ->
    out [B, S, Hq, D] in q's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    _check_plan(S, bq, bk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, Hkv, group, D).float(), k.float())
    s = s.to(q.dtype).float()  # the logits' rounding before the second product
    need = needed_blocks(S, bq, bk, prefix, q.device)
    need = need.repeat_interleave(bq, dim=0).repeat_interleave(bk, dim=1)  # [S, S]
    s = torch.where(need, s, torch.zeros_like(s))
    out = torch.einsum("bhgqk,bkhd->bqhgd", s, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def flash_probe(q, k, v, bq: int = 256, bk: int = 1024, prefix: int = 0):
    """K6 on CUDA tensors, its plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_probe_plain(q, k, v, bq, bk, prefix)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    _check_plan(S, bq, bk)
    if bq % _TILE or bk % _TILE:
        raise ValueError(f"the probe kernel takes bq and bk that are multiples of {_TILE}, got {bq}, {bk}")
    q, k, v = _check_qkv(q, k, v)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launches.add(flash_probe)
    build.check(
        lib.lxt_flash_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, D,
                            int(bq), int(bk), int(prefix), stream),
        "flash_probe",
    )
    return out


launches.counted("flash_probe", flash_probe, r"flash_probe_kernel")


def probe_tolerance(ref: torch.Tensor) -> tuple[float, float]:
    """(atol, rtol) per element that holds the kernel to its plain version:
    |got - ref| <= 2^-8 rms(ref) + 2^-7 |ref|. Both sides round the logits to bf16 and the
    output to bf16; their f32 sums run in another order, so the two outputs can land one
    bf16 ulp apart (2^-7 |ref|), and a logit that falls on the other side of its rounding
    moves its row by 2^-8 |s v|, far below the rms of a sum over thousands of such terms.
    A skipped or an extra block moves a row by about rms(ref)."""
    return 2**-8 * float(ref.float().pow(2).mean().sqrt()), 2**-7
