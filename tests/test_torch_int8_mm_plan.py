"""K1's plan on the CPU (ops/int8_mm.py): which path each shape takes (``int8_mm_plan``,
the one place the M threshold lives), the persistent wgmma kernel's walk over the output
tiles (``tile_order`` / ``persistent_units``, mirrors of csrc/int8_mm.cu:unit_coords and
its grid-stride loop), the split-K slices (``split_k_ranges``), and the split-K arithmetic
written plainly (``int8_mm_dequant_nt_split_plain``: exact int32 partials summed, then the
epilogue) against the unsplit plain version and the JAX package's
``int8_mm_dequant_nt_pallas`` with its Pallas kernel in interpret mode. The kernel itself
on the card: test_torch_kernels.py.

Tolerance: none. The sums are exact integers and the epilogue multiplies in one order, so
every comparison here is bit for bit."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from llama_x_tpu.ops import int8_mm as jmm
from llama_x_tpu_torch.ops import int8_mm as tmm

torch.set_num_threads(2)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX int8 GEMM has no interpret switch of its own: hand its pallas_call one."""
    monkeypatch.setattr(jmm.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# (M, N, K): decode (M = the batch) on the streaming path up to STREAM_MAX_M rows; prefill,
# training and the CE head on the wgmma path; a deep contraction over few tiles split over K
PLANS = [
    ((1, 14336, 4096), "stream"), ((4, 14336, 4096), "stream"), ((4, 4096, 14336), "stream"),
    ((4, 1024, 4096), "stream"), ((16, 4096, 4096), "stream"), ((48, 14336, 4096), "stream"),
    ((49, 14336, 4096), "wgmma"), ((65, 14336, 4096), "wgmma"), ((2048, 14336, 4096), "wgmma"),
    ((4096, 14336, 4096), "wgmma"), ((4096, 1024, 4096), "wgmma"), ((512, 128256, 4096), "wgmma"),
    ((512, 4096, 128256), "wgmma"), ((128, 4096, 128256), "wgmma"),
]


@pytest.mark.parametrize("shape,path", PLANS)
def test_plan_picks_the_path(shape, path):
    M, N, K = shape
    got_path, tile, splits = tmm.int8_mm_plan(M, N, K)
    assert got_path == path
    assert tile == (tmm.STREAM_BN if path == "stream" else tile) and tile in (64, 128, 256)
    assert splits >= 1
    tmm.split_k_ranges(K, splits)  # no split is empty
    if path == "stream":
        # about one CTA per SM where the strips alone are fewer
        strips = math.ceil(N / tmm.STREAM_BN)
        assert splits == 1 if strips >= tmm.H100_SMS else strips * splits >= tmm.H100_SMS // 2
    else:
        tiles = math.ceil(M / tmm.WGMMA_BM) * math.ceil(N / tile)
        assert splits == 1 or (2 * tiles < tmm.H100_SMS and tiles * splits <= tmm.H100_SMS)


def test_plan_keeps_the_training_shapes_unsplit_on_wide_tiles():
    """The main path's large products: 128 x 256 tiles, no split-K (the persistent grid
    is full). A deep contraction over few tiles splits K: 128 rows against the vocabulary
    (16 tiles of 256), but not 512 rows (128 tiles of 128 fill the card)."""
    for M, N, K in ((2048, 14336, 4096), (4096, 14336, 4096), (4096, 4096, 14336), (512, 128256, 4096)):
        assert tmm.int8_mm_plan(M, N, K) == ("wgmma", 256, 1)
    assert tmm.int8_mm_plan(512, 4096, 128256) == ("wgmma", 128, 1)
    assert tmm.int8_mm_plan(128, 4096, 128256)[2] > 1


@pytest.mark.parametrize("M,N,bn", [(4096, 14336, 256), (2048, 1024, 128), (300, 1000, 128), (1100, 700, 256),
                                    (65, 14336, 128), (512, 128256, 256), (128, 256, 256)])
@pytest.mark.parametrize("splits", [1, 3])
def test_persistent_walk_visits_every_tile_once(M, N, bn, splits):
    """The wgmma path's grid-stride loop over (tile, split) units, with the grouped tile
    order, covers every (row tile, column tile, split) exactly once."""
    order = tmm.tile_order(M, N, bn)
    mtn, ntn = math.ceil(M / tmm.WGMMA_BM), math.ceil(N / bn)
    assert sorted(order) == [(m, n) for m in range(mtn) for n in range(ntn)]
    units = mtn * ntn * splits
    seen = [(order[u // splits], u % splits) for cta in tmm.persistent_units(units) for u in cta]
    assert len(seen) == units and len(set(seen)) == units
    # grouped: the first GROUP_M row tiles (or all of them) run before any later row tile
    first = order[: min(mtn, tmm.GROUP_M) * ntn]
    assert {m for m, _ in first} == set(range(min(mtn, tmm.GROUP_M)))


@pytest.mark.parametrize("K", [16, 144, 1040, 4096, 4112, 14336, 128256])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 16])
def test_split_k_slices_cover_k_once(K, splits):
    """Each split is a run of whole 128-byte blocks (the last may be ragged); together
    they cover [0, K) once. A count that would leave a split empty raises."""
    blocks = math.ceil(K / tmm.BLOCK_K)
    per = math.ceil(blocks / splits)
    if math.ceil(blocks / per) != splits:
        with pytest.raises(ValueError):
            tmm.split_k_ranges(K, splits)
        return
    ranges = tmm.split_k_ranges(K, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(k0 < k1 and k0 % tmm.BLOCK_K == 0 for k0, k1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _operands(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (M, K), dtype=np.int8), rng.integers(-127, 128, (N, K), dtype=np.int8),
            (rng.random(M) * 0.02).astype(np.float32), (rng.random(N) * 0.001).astype(np.float32))


# ragged M, N and K (the JAX function takes its XLA path there), and a tile-aligned shape
# that its Pallas kernel runs with blocks (32, 128, 128): a 2 x 2 x 3 grid
SHAPES = [((37, 200, 144), None), ((64, 256, 384), (32, 128, 128))]


@pytest.mark.parametrize("shape,blocks", SHAPES)
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_split_k_arithmetic_is_bit_exact(interpret, shape, blocks, splits, out_dtype):
    (M, N, K) = shape
    if math.ceil(math.ceil(K / tmm.BLOCK_K) / math.ceil(math.ceil(K / tmm.BLOCK_K) / splits)) != splits:
        splits = math.ceil(K / tmm.BLOCK_K)  # K 144 holds two blocks: at most 2 splits
    a, b, rs, cs = _operands(M + splits, M, N, K)
    ta, tb, trs, tcs = (torch.from_numpy(x) for x in (a, b, rs, cs))
    got = tmm.int8_mm_dequant_nt_split_plain(ta, tb, trs, tcs, getattr(torch, out_dtype), splits)
    assert torch.equal(got, tmm.int8_mm_dequant_nt_plain(ta, tb, trs, tcs, getattr(torch, out_dtype)))
    kw = {} if blocks is None else dict(block_m=blocks[0], block_n=blocks[1], block_k=blocks[2])
    want = jmm.int8_mm_dequant_nt_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(rs), jnp.asarray(cs),
                                         out_dtype=getattr(jnp, out_dtype), **kw)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
