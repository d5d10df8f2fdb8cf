"""K4's plan and layout on the CPU (ops/int8_mm.py): the m tile and split count each shape
gets (``int8_mm_kn_plan``, the one place K4's thresholds live), the persistent walk over
its BM x KN_BN tiles (``tile_order`` / ``persistent_units``, mirrors of
csrc/int8_mm_kn.cu:unit_coords and its grid-stride loop), the split-K slices, the split-K
arithmetic written plainly (``int8_mm_dequant_split_plain``) against the unsplit plain
version and the JAX package's ``int8_mm_dequant_pallas`` with its Pallas kernel in
interpret mode, and the kernel's register maps: which bytes of the swizzled [k][n] box each
lane hands ldmatrix.trans and how its byte permutes turn them into the b^T fragment
(``kn_row``, ``kn_selectors``), and which accumulator register is which out[m, n]
(``kn_accumulator_coords``). The maps are replayed here with numpy integers, through the
documented ldmatrix.trans and wgmma register layouts, into a tile of the product. The
kernel itself on the card: test_torch_kernels.py.

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


# (M, N, K) -> (m tile, splits): the input gradients of an S 4096 step through w1 / w3,
# w2, wq / wo and wk / wv (K = out-features, N = in-features), a ragged shape, the CE
# head's dH of one 512-row chunk (a contraction over the vocabulary) and the same GEMM the
# other way round, the audio step's 262-row dH chunk (its last 256-m tile reads rows
# 6..261) and a 384-row chunk: chip_smoke.py:phase_k4's shapes and one more
PLANS = [
    ((4096, 14336, 4096), (256, 1)), ((4096, 4096, 14336), (256, 1)), ((4096, 4096, 4096), (256, 1)),
    ((4096, 4096, 1024), (256, 1)), ((300, 4112, 1040), (128, 1)), ((512, 4096, 128256), (256, 2)),
    ((512, 128256, 4096), (256, 1)), ((262, 4096, 128256), (256, 2)), ((384, 4096, 128256), (256, 2)),
]


@pytest.mark.parametrize("shape,plan", PLANS)
def test_kn_plan_per_shape(shape, plan):
    M, N, K = shape
    bm, splits = tmm.int8_mm_kn_plan(M, N, K)
    assert (bm, splits) == plan
    tmm.split_k_ranges(K, splits)  # no split is empty
    tiles = math.ceil(M / bm) * math.ceil(N / tmm.KN_BN)
    assert splits == 1 or (2 * tiles < tmm.H100_SMS and tiles * splits <= tmm.H100_SMS)


def test_kn_plan_splits_only_the_deep_contractions():
    """The CE head's dH chunks (512, 384 and the audio step's 262 rows against K = the
    vocabulary) fill fewer than half of the SMs with 256-m tiles and split K; the M 4096
    input gradients fill the card and do not."""
    for M in (512, 384, 262):
        assert tmm.int8_mm_kn_plan(M, 4096, 128256) == (256, 2)
    for N, K in ((14336, 4096), (4096, 14336), (4096, 4096), (4096, 1024)):
        assert tmm.int8_mm_kn_plan(4096, N, K)[1] == 1


@pytest.mark.parametrize("M,N,bm", [(4096, 14336, 256), (4096, 4096, 256), (300, 4112, 128), (262, 4096, 256),
                                    (512, 128256, 256), (37, 208, 128)])
@pytest.mark.parametrize("splits", [1, 2])
def test_kn_persistent_walk_visits_every_tile_once(M, N, bm, splits):
    """K4's grid-stride loop over (tile, split) units of BM x KN_BN tiles, in the grouped
    order, covers every (m tile, n tile, split) exactly once."""
    order = tmm.tile_order(M, N, tmm.KN_BN, bm)
    mtn, ntn = math.ceil(M / bm), math.ceil(N / tmm.KN_BN)
    assert sorted(order) == [(m, n) for m in range(mtn) for n in range(ntn)]
    units = mtn * ntn * splits
    seen = [(order[u // splits], u % splits) for cta in tmm.persistent_units(units) for u in cta]
    assert len(seen) == units and len(set(seen)) == units
    first = order[: min(mtn, tmm.GROUP_M) * ntn]
    assert {m for m, _ in first} == set(range(min(mtn, tmm.GROUP_M)))


@pytest.mark.parametrize("K", [1024, 1040, 128256])
def test_kn_plan_split_slices_cover_k_once(K):
    """The slices of every split count the K4 plan can give for a contraction of K (the
    plan's own and its neighbours): whole 128-byte blocks, in order, covering [0, K) once."""
    chosen = tmm.int8_mm_kn_plan(262, 4096, K)[1]
    for splits in sorted({1, chosen, chosen + 1}):
        ranges = tmm.split_k_ranges(K, splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        assert all(k0 < k1 and k0 % tmm.BLOCK_K == 0 for k0, k1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def _operands(seed, M, N, K):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (M, K), dtype=np.int8), rng.integers(-127, 128, (K, N), dtype=np.int8),
            (rng.random(M) * 0.02).astype(np.float32), (rng.random(N) * 0.001).astype(np.float32))


# ragged M, N and K (the JAX function takes its XLA path there), and a tile-aligned shape
# that its Pallas kernel runs with blocks (32, 128, 128): a 2 x 2 x 3 grid
SHAPES = [((37, 208, 272), None), ((64, 256, 384), (32, 128, 128))]


@pytest.mark.parametrize("shape,blocks", SHAPES)
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_kn_split_k_arithmetic_is_bit_exact(interpret, shape, blocks, splits, out_dtype):
    M, N, K = shape
    a, b, rs, cs = _operands(M + splits, M, N, K)
    ta, tb, trs, tcs = (torch.from_numpy(x) for x in (a, b, rs, cs))
    got = tmm.int8_mm_dequant_split_plain(ta, tb, trs, tcs, getattr(torch, out_dtype), splits)
    assert torch.equal(got, tmm.int8_mm_dequant_plain(ta, tb, trs, tcs, getattr(torch, out_dtype)))
    kw = {} if blocks is None else dict(block_m=blocks[0], block_n=blocks[1], block_k=blocks[2])
    want = jmm.int8_mm_dequant_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(rs), jnp.asarray(cs),
                                      out_dtype=getattr(jnp, out_dtype), **kw)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---- the register maps, replayed with numpy ----

def _swizzled(box: np.ndarray) -> np.ndarray:
    """A [128 k][128 n] int8 box as TMA writes it in the 128-byte swizzle: the 16-byte
    chunk c of row k at chunk c ^ (k % 8), as flat bytes."""
    out = np.empty_like(box)
    for k in range(box.shape[0]):
        for c in range(8):
            out[k, (c ^ (k % 8)) * 16:(c ^ (k % 8)) * 16 + 16] = box[k, c * 16:c * 16 + 16]
    return out.reshape(-1).view(np.uint8)


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of y:x."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _fragments(smem: np.ndarray, chunk: int, kk: int) -> list[list[int]]:
    """One warp's b^T fragment of k step kk: each lane's ldmatrix.x4.trans (lane l gets,
    of matrix i, 16-bit column l // 4 at the matrix's rows 2 (l % 4) and + 1, the rows being
    the addresses lanes 8i..8i+7 hand in) and then its four byte permutes."""
    rows = []
    for lane in range(32):
        k, phys = tmm.kn_row(lane, chunk)
        base = (kk * 32 + k) * 128 + phys * 16
        rows.append(smem[base:base + 16].view(np.uint16))
    frags = []
    for lane in range(32):
        g, c = divmod(lane, 4)
        r = [int(rows[8 * i + 2 * c][g]) | int(rows[8 * i + 2 * c + 1][g]) << 16 for i in range(4)]
        s0, s1 = tmm.kn_selectors(lane)
        frags.append([_byte_perm(r[0], r[1], s0), _byte_perm(r[0], r[1], s1),
                      _byte_perm(r[2], r[3], s0), _byte_perm(r[2], r[3], s1)])
    return frags


def _as_a_operand(frags) -> np.ndarray:
    """A warp's four registers in wgmma's register A layout for 8-bit types (the mma.m16n8k32
    A layout): register r of lane 4g + c is row g + 8 (r & 1), k 4c + 16 (r >> 1) + byte."""
    A = np.zeros((16, 32), np.int64)
    for lane, regs in enumerate(frags):
        g, c = divmod(lane, 4)
        for r, word in enumerate(regs):
            for j in range(4):
                A[g + 8 * (r & 1), 4 * c + 16 * (r >> 1) + j] = np.int8(np.uint8((word >> (8 * j)) & 0xFF))
    return A


@pytest.mark.parametrize("bm", [128, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_kn_register_maps_build_the_product(bm, seed):
    """One tile of K4 replayed through its maps: each consumer warpgroup's b^T fragments from
    the swizzled b box, the products in wgmma's register layouts with a's box as B (its
    columns are m), the accumulator scattered to out by ``kn_accumulator_coords``: the tile
    equals a @ b exactly, and then the epilogue gives the plain version's bits."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, (bm, 128), dtype=np.int8)  # a's box: [m][k]
    b = rng.integers(-127, 128, (128, tmm.KN_BN), dtype=np.int8)  # b's box: [k][n] as stored
    smem = _swizzled(b)
    tile = np.full((bm, tmm.KN_BN), np.iinfo(np.int64).min, np.int64)
    for wg in range(2):
        for warp in range(4):
            A = np.concatenate([_as_a_operand(_fragments(smem, 4 * wg + warp, kk)) for kk in range(4)], axis=1)
            acc = A @ a.T.astype(np.int64)  # D[row, col] = sum_k A[row, k] B[k, col], B = a's box as [k][m]
            for lane in range(32):
                g, c = divmod(lane, 4)
                for i in range(bm // 8):
                    for e in range(4):
                        m, n = tmm.kn_accumulator_coords(wg, 32 * warp + lane, i, e)
                        tile[m, n] = acc[g + 8 * (e >> 1), 8 * i + 2 * c + (e & 1)]
    np.testing.assert_array_equal(tile, a.astype(np.int64) @ b.astype(np.int64))
    rs, cs = (rng.random(bm) * 0.02).astype(np.float32), (rng.random(tmm.KN_BN) * 0.001).astype(np.float32)
    got = torch.from_numpy(tile.astype(np.float32)) * torch.from_numpy(rs)[:, None] * torch.from_numpy(cs)[None, :]
    want = tmm.int8_mm_dequant_plain(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(rs),
                                     torch.from_numpy(cs), torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", range(8))
def test_kn_ldmatrix_rows_are_free_of_bank_conflicts(chunk):
    """Each 8-lane phase of the ldmatrix (one 8 x 16-byte matrix) reads 8 rows of the b
    box whose swizzled chunks are 8 different 16-byte bank groups; and each quad lane c
    receives k 4c..4c+3 of its step (matrices 0 / 1) and k 16 + 4c.. (matrices 2 / 3)."""
    for mi in range(4):
        assert len({tmm.kn_row(lane, chunk)[1] for lane in range(8 * mi, 8 * mi + 8)}) == 8
    for c in range(4):
        ks = sorted(tmm.kn_row(8 * mi + r, chunk)[0] for mi in (0, 1) for r in (2 * c, 2 * c + 1))
        assert ks == list(range(4 * c, 4 * c + 4))
        ks = sorted(tmm.kn_row(8 * mi + r, chunk)[0] for mi in (2, 3) for r in (2 * c, 2 * c + 1))
        assert ks == list(range(16 + 4 * c, 16 + 4 * c + 4))
