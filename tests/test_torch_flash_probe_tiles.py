"""The flash probe's tile classes on the CPU (ops/flash_probe.py:probe_tile_class), the
predicate K6 mirrors (csrc/flash_probe.cu: tile_class): a "skip" tile is never loaded, a
"full" one runs with no mask code and a "partial" one is masked per element by its blocks'
need, so a wrong class is a wrong answer. Held here against ``needed_blocks`` itself, tile
by tile, at the kernel's 128 x 128 tiles and at a consumer warpgroup's 64 x 128; then the
census of the 8B plans the probe entry point runs (bq 256 / bk 1024 and bq 128 / bk 512 at
prefix 2000: no partial tile, 0.6875 and 0.65625 of the pairs computed), and the 64-wide
plans, whose tiles the kernel masks. Last, the probe's plain arithmetic rebuilt tile by
tile from the classes agrees with ``flash_probe_plain`` within ``probe_tolerance``."""

import math

import numpy as np
import pytest
import torch

from llama_x_tpu_torch.ops import flash_probe as fp

torch.set_num_threads(2)


def _need(S: int, bq: int, bk: int, prefix: int) -> torch.Tensor:
    """bool [S, S]: position pairs of the needed blocks."""
    return fp.needed_blocks(S, bq, bk, prefix).repeat_interleave(bq, dim=0).repeat_interleave(bk, dim=1)


# (S, bq, bk, prefix): the 8B plans at a cut S, 64-wide plans, blocks that are no multiple
# of 128, no prefix, a prefix past S, and an S that is no multiple of the 128-position tile
PLANS = [(1024, 256, 1024, 500), (1024, 128, 512, 500), (512, 64, 64, 200), (512, 256, 64, 130),
         (768, 192, 128, 300), (576, 64, 192, 0), (512, 128, 256, 600), (320, 64, 64, 100)]


@pytest.mark.parametrize("S,bq,bk,prefix", PLANS)
@pytest.mark.parametrize("nq", [128, 64])
def test_probe_tile_classes_match_the_needed_blocks(S, bq, bk, prefix, nq):
    need = _need(S, bq, bk, prefix)
    for q0 in range(0, S, nq):
        for kv0 in range(0, S, fp.PROBE_TILE):
            tile = need[q0:q0 + nq, kv0:kv0 + fp.PROBE_TILE]
            cls = fp.probe_tile_class(q0, kv0, nq, fp.PROBE_TILE, S, bq, bk, prefix)
            assert cls == ("skip" if not tile.any() else "full" if tile.all() else "partial"), (q0, kv0)


@pytest.mark.parametrize("bq,bk,pairs,classes", [(256, 1024, 0.6875, (320, 0, 704)),
                                                 (128, 512, 0.65625, (352, 0, 672))])
def test_probe_census_of_the_8b_plans(bq, bk, pairs, classes):
    """B 1, S 4096, prefix 2000 (the audio step's attention): whole 128-tiles only."""
    c = fp.tile_census(4096, bq, bk, 2000)
    assert (c["skip"], c["partial"], c["full"]) == classes
    assert c["pairs_needed"] == pairs
    assert c["full"] * fp.PROBE_TILE ** 2 == pairs * 4096 ** 2


@pytest.mark.parametrize("S,bq,bk,prefix,partial", [(4096, 64, 64, 2000, 16), (4096, 64, 64, 0, 32),
                                                    (256, 64, 64, 0, 2), (576, 64, 192, 0, 3)])
def test_probe_64_wide_blocks_give_partial_tiles(S, bq, bk, prefix, partial):
    """Blocks of 64 (or 192) split a 128-tile on the block diagonal: those tiles are masked
    per element (the diagonal tiles outside the prefix at S 4096, prefix 2000)."""
    c = fp.tile_census(S, bq, bk, prefix)
    assert c["partial"] == partial
    assert c["skip"] + c["partial"] + c["full"] == math.ceil(S / fp.PROBE_TILE) ** 2


@pytest.mark.parametrize("S,bq,bk,prefix", [(256, 64, 64, 0), (320, 64, 64, 100), (512, 256, 64, 130)])
def test_probe_by_tile_classes_equals_plain(S, bq, bk, prefix):
    """The kernel's walk in plain arithmetic: per 64 query rows (a consumer warpgroup) and
    128 kv positions, skip / full / partial by the classes, the logits rounded to bf16 and
    summed in f32; equal to ``flash_probe_plain`` up to the order of the f32 sums, within
    ``probe_tolerance``; a wrong class would move whole rows."""
    rng = np.random.default_rng(S + bq)
    B, Hq, Hkv, D = 1, 4, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, D), np.float32) * 0.3).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    need = _need(S, bq, bk, prefix)
    out = torch.zeros(B, S, Hq, D)
    qg = q.float().reshape(B, S, Hkv, Hq // Hkv, D)
    for q0 in range(0, S, 64):
        for kv0 in range(0, S, fp.PROBE_TILE):
            cls = fp.probe_tile_class(q0, kv0, 64, fp.PROBE_TILE, S, bq, bk, prefix)
            if cls == "skip":
                continue
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, q0:q0 + 64], k[:, kv0:kv0 + fp.PROBE_TILE].float())
            s = s.to(torch.bfloat16).float()
            if cls == "partial":
                s = torch.where(need[q0:q0 + 64, kv0:kv0 + fp.PROBE_TILE], s, torch.zeros_like(s))
            o = torch.einsum("bhgqk,bkhd->bqhgd", s, v[:, kv0:kv0 + fp.PROBE_TILE].float())
            out[:, q0:q0 + 64] += o.reshape(B, -1, Hq, D)
    ref = fp.flash_probe_plain(q, k, v, bq, bk, prefix)
    atol, rtol = fp.probe_tolerance(ref)
    excess = float(((out.to(torch.bfloat16).float() - ref.float()).abs() - rtol * ref.float().abs()).max())
    assert excess <= atol
