"""The flash kernels' tile classes and kv tile, on the CPU.

``tile_class`` (ops/flash_attention.py) is the predicate the kernels K2 and K5 mirror
(csrc/common.cuh): a "skip" tile is never loaded or computed and a "full" one runs with no
mask code, so a wrong class is a wrong answer. Here it is held against
``make_attention_mask`` itself, tile by tile, with the segment-id ranges taken the way the
kernels take them (``segment_ranges``, per 64 positions): every "skip" tile is all False,
every "full" tile all True. Then the dropout plans: a kv tile of the kernels must lie inside
one kv block of the plan (the block key is hoisted per tile), which ``_dropout_args`` checks.
"""

import numpy as np
import pytest
import torch

from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask


def _packed(S: int, bounds) -> torch.Tensor:
    pos = torch.arange(S)
    return ((pos[:, None] >= torch.tensor(bounds)[None, :]).sum(dim=1) + 1).to(torch.int32)[None]


def _kernel_range(ranges: torch.Tensor, x0: int, n: int, S: int) -> tuple[int, int]:
    """A tile's id range as the kernels read it: the union of its 64-position chunks."""
    lo, hi = x0 // fa.SEG_CHUNK, (min(x0 + n, S) - 1) // fa.SEG_CHUNK
    return int(ranges[lo:hi + 1, 0].min()), int(ranges[lo:hi + 1, 1].max())


def _classes(mi: MaskInfo, S: int, bq: int, bk: int):
    """(q0, kv0, class, mask tile) of every tile of batch row 0."""
    mask = make_attention_mask(mi, S, S, 1)
    mask = torch.ones(S, S, dtype=torch.bool) if mask is None else mask[0, 0]
    qseg = None if mi.segment_ids is None else mi.segment_ids[0]
    kseg = qseg if mi.kv_segment_ids is None else mi.kv_segment_ids[0]
    qr = None if qseg is None else fa.segment_ranges(qseg[None])[0]
    kr = None if kseg is None else fa.segment_ranges(kseg[None])[0]
    prefix = None if mi.prefix_len is None else int(mi.prefix_len[0])
    out = []
    for q0 in range(0, S, bq):
        for kv0 in range(0, S, bk):
            q_range = None if qr is None else _kernel_range(qr, q0, bq, S)
            k_range = None if kr is None else _kernel_range(kr, kv0, bk, S)
            if qseg is not None:  # the chunked ranges are the tile's own
                assert q_range == (int(qseg[q0:q0 + bq].min()), int(qseg[q0:q0 + bq].max()))
                assert k_range == (int(kseg[kv0:kv0 + bk].min()), int(kseg[kv0:kv0 + bk].max()))
            cls = fa.tile_class(q0, kv0, bq, bk, S, bool(mi.causal), prefix, q_range, k_range)
            out.append((q0, kv0, cls, mask[q0:q0 + bq, kv0:kv0 + bk]))
    return out


def _mask_case(case: str, S: int) -> MaskInfo:
    rng = np.random.default_rng(S)
    pre = lambda n: torch.tensor([n], dtype=torch.int32)
    if case == "causal":
        return MaskInfo(causal=True)
    if case == "noncausal":
        return MaskInfo(causal=False)
    if case == "noncausal prefix":
        return MaskInfo(causal=False, prefix_len=pre(S // 3))
    if case == "packed on tiles":
        return MaskInfo(causal=True, segment_ids=_packed(S, [b for b in (128, 256, 512, 1024, 1536) if b < S]))
    if case == "packed inside tiles":
        return MaskInfo(causal=True, segment_ids=_packed(S, [b for b in (100, 300, 700, 1100, 1800) if b < S]))
    if case == "unsorted segments":
        return MaskInfo(causal=True, segment_ids=torch.from_numpy(rng.integers(1, 4, (1, S)).astype(np.int32)))
    if case == "unsorted segments, noncausal":
        return MaskInfo(causal=False, segment_ids=torch.from_numpy(rng.integers(1, 3, (1, S)).astype(np.int32)))
    if case == "kv segments":
        q = _packed(S, [b for b in (200, 640) if b < S])
        return MaskInfo(causal=True, segment_ids=q, kv_segment_ids=_packed(S, [b for b in (128, 640) if b < S]))
    if case == "prefix 2000":
        return MaskInfo(causal=True, prefix_len=pre(min(2000, S - 1)))
    if case == "packed + prefix":
        return MaskInfo(causal=True, segment_ids=_packed(S, [b for b in (300, 1024) if b < S]), prefix_len=pre(S // 4))
    raise ValueError(case)


CASES = ["causal", "noncausal", "noncausal prefix", "packed on tiles", "packed inside tiles", "unsorted segments",
         "unsorted segments, noncausal", "kv segments", "prefix 2000", "packed + prefix"]


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("S", [37, 129, 2304])
@pytest.mark.parametrize("case", CASES)
def test_tile_class_agrees_with_the_mask(case, S, tile):
    """Every skip tile is all masked, every full tile all visible and inside S, for square
    tiles of 64 and 128 (the predicate does not depend on head_dim) at ragged S."""
    for q0, kv0, cls, m in _classes(_mask_case(case, S), S, tile, tile):
        if cls == "skip":
            assert not m.any(), (case, q0, kv0)
        elif cls == "full":
            assert m.all() and q0 + tile <= S and kv0 + tile <= S, (case, q0, kv0)


@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (128, 64)])
def test_tile_class_at_the_kernels_tiles_on_4095_positions(bq, bk):
    """The kernels' own tile shapes (K2 128 x 128, K5's dkv kernel 64 q x 128 kv, its dq
    kernel 128 q x 64 kv) at S 4095 under packed documents and a prefix."""
    for case in ("packed inside tiles", "prefix 2000"):
        for q0, kv0, cls, m in _classes(_mask_case(case, 4095), 4095, bq, bk):
            assert cls != "skip" or not m.any(), (case, q0, kv0)
            assert cls != "full" or m.all(), (case, q0, kv0)


def test_tile_class_skips_and_unmasks_what_it_can():
    """The classes are not all "partial": under a causal mask at S 4096 with 128-tiles the
    496 tiles above the diagonal are skipped and the 496 below it are full; with 8 packed
    documents of 512 (boundaries on tiles) only the 32 diagonal tiles are partial and every
    tile between documents is skipped; a prefix of 2000 adds the 120 tiles of its 15 x 15
    square that are not below the diagonal to the full ones."""
    def count(mi, S=4096, t=128):
        classes = [c for _, _, c, _ in _classes(mi, S, t, t)]
        return {k: classes.count(k) for k in ("skip", "partial", "full")}

    assert count(MaskInfo(causal=True)) == {"skip": 496, "partial": 32, "full": 496}
    packed = MaskInfo(causal=True, segment_ids=_packed(4096, list(range(512, 4096, 512))))
    assert count(packed) == {"skip": 1024 - 32 - 8 * 6, "partial": 32, "full": 8 * 6}
    # partial: 17 diagonal tiles outside the square, and the 15 tiles of kv tile 15
    # (positions 1920-2047) above the diagonal that the prefix reaches into
    prefix = count(MaskInfo(causal=True, prefix_len=torch.tensor([2000], dtype=torch.int32)))
    assert prefix == {"skip": 1024 - 616 - 32, "partial": 32, "full": 496 + 120}


def test_segment_ranges_take_each_chunk_below_S():
    seg = torch.tensor([[5, 1, 3] * 30 + [7]], dtype=torch.int32)  # S 91: a full chunk and 27 positions
    r = fa.segment_ranges(seg)
    assert r.dtype == torch.int32 and r.shape == (1, 2, 2)
    assert r[0].tolist() == [[1, 5], [1, 7]]
    assert fa.segment_ranges(None) is None


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [37, 128, 200, 512, 2048, 4096, 4097])
def test_every_dropout_plan_fits_the_kv_tile(S, group):
    """Each plan the wrapper makes (``dropout_plan``) keeps a kernel kv tile inside one kv
    block of the plan: bk is a multiple of the kernels' 128-position tile or spans S. A
    plan that breaks the rule makes the wrapper raise instead."""
    bq, bk = fa.dropout_plan(S, S, group)
    dropout = fa.Dropout(0.1, 1, bq, bk)
    if bk % fa._TILE == 0 or bk == S:
        assert fa._dropout_args(dropout, S)[0] == 1
    else:
        with pytest.raises(ValueError):
            fa._dropout_args(dropout, S)
    assert fa._TILE == 128
    with pytest.raises(ValueError):
        fa._dropout_args(fa.Dropout(0.1, 1, bq, 64), 4096)  # a 64-position block splits a 128-position tile
