"""int8 x int8 GEMMs with a fused dequant epilogue, in the two layouts of the right
operand: ``int8_mm_dequant_nt`` takes b as [N, K] (kernel K1, ``csrc/int8_mm.cu``),
``int8_mm_dequant`` takes b as [K, N] (kernel K4, ``csrc/int8_mm_kn.cu``).

Port of llama_x_tpu/ops/int8_mm.py: the Pallas ``_kernel`` as reached through
``int8_mm_dequant_nt_pallas`` (``b_nk=True``) and through ``int8_mm_dequant_pallas``.
Two forms exist so that the frozen int8 base keeps ONE stored layout, ``int_data
[out, in]``: the forward reads it as [N, K] (NT), the input gradient reads the same
bytes as [K = out, N = in] (KN), and no transposed copy of the base is ever made. The
TPU versions fell back to XLA when a shape was not a tile multiple; these kernels
mask their own ragged tile edges, so every shape whose int8 rows are 16-byte
multiples runs them (K % 16 for a and for an NT b; N % 16 for a KN b).

Both sum exactly in int32 and multiply ``float(acc) * row_scale[m] * col_scale[n]``
in that order, so kernel and plain version agree bit for bit. On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel or raises.

K1 has two paths (``int8_mm_plan``): decode shapes (M up to ``STREAM_MAX_M``) stream
the weight through ``mma.sync`` in strips of 64 rows, larger M runs a persistent
``wgmma`` kernel over 128 x 256 (or 128 x 128) tiles; either splits K where the card
would otherwise sit idle. K4 has one path (``int8_mm_kn_plan``: m tile, splits), the
same persistent ``wgmma`` kernel turned around: integer ``wgmma`` reads a shared operand
only K-major, so K4 computes each tile transposed, b^T from registers (each warp
transposes its [k][n] slice with ``ldmatrix.trans`` and byte permutes: ``kn_row``,
``kn_selectors``) times a's box from shared memory, over tiles of BM (256 or 128) m x
``KN_BN`` n, and splits K where the tiles fill fewer than half of the SMs (the CE head's
dH chunks of 512 and of the audio step's 262 rows). A split-K launch sums exact int32
partials, so the bits do not depend on the plan
(``int8_mm_dequant_nt_split_plain`` and ``int8_mm_dequant_split_plain`` write that
arithmetic out).
"""

from __future__ import annotations

import functools

import torch

from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.utils import build

# the int32 sum of K products of int8 values in [-127, 127] cannot overflow up to here;
# the Llama-3 vocabulary (128256, the contraction of the CE head's dH product) fits
MAX_K = (2**31 - 1) // (127 * 127)

# K1's plan. Up to STREAM_MAX_M rows (decode: M is the batch) the weight streams through
# mma.sync in strips of STREAM_BN rows; above it the wgmma tiles run. On the H100 the two
# cross between 48 and 64 rows at N 14336, K 4096 (chip_smoke.py:phase_k1_plans, PERF.md
# §6): the stream path's mma.sync work grows with the 16-row tiles of a, while a 128-row
# wgmma tile costs the same at any M. K is cut in blocks of BLOCK_K bytes (a ring stage
# on both paths) and split in whole blocks.
STREAM_MAX_M = 48
STREAM_BN = 64
WGMMA_BM = 128
BLOCK_K = 128
GROUP_M = 8  # row tiles that sweep the column tiles together (L2 reuse of the weight strips)
WGMMA_MIN_SPLIT_BLOCKS = 64
H100_SMS = 132
# K4's plan: tiles of BM (256 or 128) m x KN_BN n (two consumer warpgroups of 64 n). A
# 128-m tile reads a's box from shared memory for every 64 n of b^T against half the
# products of a 256-m one, and runs at about 0.8 of its rate on the H100
# (chip_smoke.py:phase_k4_plans, PERF.md §6).
KN_BN = 128
KN_NARROW_RATE = 0.8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_k(k_blocks: int, want: int) -> tuple[int, int]:
    """(splits, blocks per split) for about ``want`` splits, none of them empty."""
    per = _cdiv(k_blocks, max(1, min(want, k_blocks)))
    return _cdiv(k_blocks, per), per


@functools.lru_cache(maxsize=4096)
def int8_mm_plan(M: int, N: int, K: int, sms: int = H100_SMS) -> tuple[str, int, int]:
    """K1's (path, tile width, splits) for an [M, K] x [N, K] product on a card of
    ``sms`` SMs. The C entry point takes these three as they are.

    "stream" (M <= STREAM_MAX_M): strips of 64 weight rows, K split only where the strips
    are fewer than the SMs, into about one CTA per SM (more splits add partials and a
    fix-up, measured slower). "wgmma": 128-row tiles 256 or 128 wide, whichever
    finishes in fewer tile-widths of work (a 128-wide tile counted at 0.95 of the
    256-wide one's rate, a split plan at 1 / 1.1 for its partials and fix-up); K split
    only where the tiles would fill fewer than half of the SMs, into at most sms / tiles
    splits of at least WGMMA_MIN_SPLIT_BLOCKS blocks (a split-K fix-up costs about as
    much as a short split's products)."""
    k_blocks = _cdiv(K, BLOCK_K)
    if M <= STREAM_MAX_M:
        splits, _ = _split_k(k_blocks, _cdiv(sms, _cdiv(N, STREAM_BN)))
        return "stream", STREAM_BN, splits
    bn, splits = _cheapest_tile(k_blocks, sms, [(bn, rate, _cdiv(M, WGMMA_BM) * _cdiv(N, bn))
                                                for bn, rate in ((256, 1.0), (128, 0.95))])
    return "wgmma", bn, splits


def _cheapest_tile(k_blocks: int, sms: int, options) -> tuple[int, int]:
    """(tile width, splits) of the cheapest of ``options`` (width, rate, tiles), in
    tile-widths of work: waves of units x width x blocks per split / rate, a split plan at
    1 / 1.1 for its partials and fix-up. K is split only where the tiles fill fewer than half
    of the SMs, into at most sms / tiles splits of at least WGMMA_MIN_SPLIT_BLOCKS blocks."""
    best = None
    for width, rate, tiles in options:
        splits, per = _split_k(k_blocks, 1 if 2 * tiles >= sms else min(sms // tiles, k_blocks // WGMMA_MIN_SPLIT_BLOCKS))
        cost = _cdiv(tiles * splits, sms) * width * per / rate * (1.1 if splits > 1 else 1.0)
        if best is None or cost < best[0]:
            best = (cost, width, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=4096)
def int8_mm_kn_plan(M: int, N: int, K: int, sms: int = H100_SMS) -> tuple[int, int]:
    """K4's (m tile BM, splits) for an [M, K] x [K, N] product on a card of ``sms`` SMs;
    the C entry point takes both as they are: the cheaper of the 256- and the 128-m tile
    (``_cheapest_tile``, K1's cost, the 128-m tile at ``KN_NARROW_RATE``)."""
    return _cheapest_tile(_cdiv(K, BLOCK_K), sms, [(bm, rate, _cdiv(M, bm) * _cdiv(N, KN_BN))
                                                   for bm, rate in ((256, 1.0), (128, KN_NARROW_RATE))])


def split_k_ranges(K: int, splits: int) -> list[tuple[int, int]]:
    """The [k0, k1) slice of each split, in whole BLOCK_K blocks (the kernel's split)."""
    k_blocks = _cdiv(K, BLOCK_K)
    per = _cdiv(k_blocks, splits)
    if _cdiv(k_blocks, per) != splits:
        raise ValueError(f"{splits} splits of K={K} would leave one empty")
    return [(s * per * BLOCK_K, min((s + 1) * per * BLOCK_K, K)) for s in range(splits)]


def tile_order(M: int, N: int, bn: int, bm: int = WGMMA_BM) -> list[tuple[int, int]]:
    """(row tile, column tile) of each output tile of bm x bn in the persistent walk of K1's
    wgmma path and of K4 (csrc/int8_mm.cu and csrc/int8_mm_kn.cu: unit_coords): groups of
    GROUP_M row tiles sweep the column tiles. K4 passes its m tile as bm and KN_BN as bn."""
    mtn, ntn = _cdiv(M, bm), _cdiv(N, bn)
    order = []
    for tile in range(mtn * ntn):
        width = GROUP_M * ntn
        first = tile // width * GROUP_M
        gsize, r = min(mtn - first, GROUP_M), tile % width
        order.append((first + r % gsize, r // gsize))
    return order


def persistent_units(units: int, sms: int = H100_SMS) -> list[list[int]]:
    """The work units each persistent CTA takes: CTA c runs c, c + grid, c + 2 grid, ..."""
    grid = min(units, sms)
    return [list(range(c, units, grid)) for c in range(grid)]


def int8_mm_dequant_nt_plain(a_i8, b_nk_i8, row_scale, col_scale, out_dtype=torch.bfloat16):
    """a_i8 [M, K] x b_nk_i8 [N, K] -> [M, N] out_dtype:
    float32(exact integer sum) * row_scale[m] * col_scale[n].

    The sum is exact: int32 on the CPU; on the card, where integer matmul is not
    offered, float64, which is exact while 127^2 * K < 2^53."""
    acc_dtype = torch.int32 if a_i8.device.type == "cpu" else torch.float64
    acc = torch.matmul(a_i8.to(acc_dtype), b_nk_i8.to(acc_dtype).T)
    out = acc.to(torch.float32) * row_scale.reshape(-1, 1).float() * col_scale.reshape(1, -1).float()
    return out.to(out_dtype)


def int8_mm_dequant_nt_split_plain(a_i8, b_nk_i8, row_scale, col_scale, out_dtype=torch.bfloat16, splits=1):
    """K1's split-K arithmetic written plainly: one exact integer partial per K slice
    (``split_k_ranges``), the partials summed, then the epilogue of the plain version."""
    acc_dtype = torch.int32 if a_i8.device.type == "cpu" else torch.float64
    acc = sum(torch.matmul(a_i8[:, k0:k1].to(acc_dtype), b_nk_i8[:, k0:k1].to(acc_dtype).T)
              for k0, k1 in split_k_ranges(a_i8.shape[1], splits))
    out = acc.to(torch.float32) * row_scale.reshape(-1, 1).float() * col_scale.reshape(1, -1).float()
    return out.to(out_dtype)


def kn_row(lane: int, chunk: int) -> tuple[int, int]:
    """K4's b^T fragment, the shared-memory side (csrc/hopper.cuh: kn_row_offset): the k row
    (0..31 of a 32-deep step) whose 16 n bytes of chunk ``chunk`` lane ``lane`` hands to
    ldmatrix.x4.trans, and that row's 16-byte chunk after the 128-byte swizzle (chunk c of
    row k lands at c ^ (k % 8)). Matrix lane // 8 takes the rows of lanes 8i..8i+7 in order."""
    mi, r = divmod(lane, 8)
    k = 16 * (mi >> 1) + (r >> 1) * 4 + (r & 1) + 2 * (((r >> 2) & 1) ^ (mi & 1))
    return k, chunk ^ (k & 7)


def kn_selectors(lane: int) -> tuple[int, int]:
    """The two byte-permute selectors (``__byte_perm``) that turn lane ``lane``'s pairs of
    ldmatrix registers into its fragment words: the first takes n = 2g, the second
    n = 2g + 1 (g = lane // 4); lanes 2 and 3 of a quad hold their upper k in the first
    register (csrc/hopper.cuh: kn_selectors)."""
    return (0x2064, 0x3175) if lane & 2 else (0x6420, 0x7531)


def kn_accumulator_coords(wg: int, tid: int, i: int, e: int) -> tuple[int, int]:
    """(m, n) of accumulator register 4 i + e of thread ``tid`` (0..127) of consumer
    warpgroup ``wg``: m within the tile's a box (which for a last tile reaching past M is
    the BM rows that end at M), n within the tile. Fragment row 16w + g is n 2g of the
    warp's 16, row 16w + g + 8 is n 2g + 1; the accumulator's columns are m."""
    warp, lane = divmod(tid, 32)
    g, c = divmod(lane, 4)
    return 8 * i + 2 * c + (e & 1), 64 * wg + 16 * warp + 2 * g + (e >> 1)


_counters: dict = {}
_retired_counters: list = []  # replaced counter buffers, kept: a captured graph may hold their address
_sms: dict = {}


def _sm_count(device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def _tile_counters(device, n: int) -> torch.Tensor:
    """The split-K arrival counters of K1 and K4 on ``device``: zeros, and every launch leaves them
    at zero (the last split of a tile resets its own). One launch at a time uses them:
    the port runs its kernels on one stream. A launch captured in a CUDA graph keeps the
    buffer's address, so a buffer that a larger one replaces is never freed."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired_counters.append(buf)
        buf = _counters[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return buf


def _f32_vector(x, device):
    if x.dtype == torch.float32 and x.device == device and x.is_contiguous():
        return x.reshape(-1)
    return x.reshape(-1).to(device=device, dtype=torch.float32).contiguous()


def _launch(wrapper, entry: str, a_i8, b_i8, b_nk: bool, row_scale, col_scale, out_dtype, plan=None):
    """Checks shared by K1 and K4, then the launch of ``entry`` counted on ``wrapper``.
    K1 (b_nk) launches ``plan`` (path, tile width, splits), by default ``int8_mm_plan``'s;
    K4 ``plan`` (m tile, splits), by default ``int8_mm_kn_plan``'s."""
    M, K = a_i8.shape
    N, b_k = (b_i8.shape[0], b_i8.shape[1]) if b_nk else (b_i8.shape[1], b_i8.shape[0])
    if a_i8.dtype != torch.int8 or b_i8.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {a_i8.dtype} x {b_i8.dtype}")
    if b_k != K or K % 16 or (not b_nk and N % 16):
        raise ValueError(f"K mismatch, or an int8 row that is no 16-byte multiple: a {tuple(a_i8.shape)}, "
                         f"b {tuple(b_i8.shape)} ({'[N, K]' if b_nk else '[K, N]'})")
    if K > MAX_K:
        raise ValueError(f"K={K}: 127^2 * K would overflow the int32 sum (K <= {MAX_K})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if not (a_i8.is_cuda and b_i8.is_cuda and a_i8.device == b_i8.device):
        raise ValueError("operands must lie on one CUDA device")
    a = a_i8.contiguous()
    b = b_i8.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("int8 operands must be 16-byte aligned")
    rs, cs = _f32_vector(row_scale, a.device), _f32_vector(col_scale, a.device)
    if rs.numel() != M or cs.numel() != N:
        raise ValueError(f"scales {rs.numel()}/{cs.numel()} do not match M={M}, N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = build.load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = [a.data_ptr(), b.data_ptr(), rs.data_ptr(), cs.data_ptr(), out.data_ptr(), M, N, K,
            int(out_dtype == torch.float32)]
    if b_nk:
        path, bn, splits = plan or int8_mm_plan(M, N, K, _sm_count(a.device))
        tiles = _cdiv(M, WGMMA_BM) * _cdiv(N, bn) if path == "wgmma" else _cdiv(N, bn)
        args += [{"stream": 0, "wgmma": 1}[path], bn]
    else:
        bm, splits = plan or int8_mm_kn_plan(M, N, K, _sm_count(a.device))
        tiles = _cdiv(M, bm) * _cdiv(N, KN_BN)
        args += [bm]
    part = counters = None
    if splits > 1:  # under a CUDA graph's capture this comes from the graph's pool
        part = torch.empty((splits, M, N), dtype=torch.int32, device=a.device)
        counters = _tile_counters(a.device, tiles)
    args += [splits, part.data_ptr() if part is not None else None,
             counters.data_ptr() if counters is not None else None]
    launches.add(wrapper)
    build.check(getattr(lib, entry)(*args, stream), wrapper.__name__)
    return out


def int8_mm_dequant_nt(a_i8, b_nk_i8, row_scale, col_scale, out_dtype=torch.bfloat16, plan=None):
    """K1 on CUDA tensors, its plain version on CPU tensors. ``plan``: (path, tile
    width, splits) to launch instead of ``int8_mm_plan``'s (the card tests use it)."""
    if a_i8.device.type == "cpu":
        return int8_mm_dequant_nt_plain(a_i8, b_nk_i8, row_scale, col_scale, out_dtype)
    return _launch(int8_mm_dequant_nt, "lxt_int8_mm_dequant_nt", a_i8, b_nk_i8, True, row_scale, col_scale, out_dtype,
                   plan)


launches.counted("int8_mm_dequant_nt", int8_mm_dequant_nt, r"int8_mm_nt_(stream|wgmma)_kernel")


def int8_mm_dequant_plain(a_i8, b_kn_i8, row_scale, col_scale, out_dtype=torch.bfloat16):
    """a_i8 [M, K] x b_kn_i8 [K, N] -> [M, N] out_dtype, the KN form of
    ``int8_mm_dequant_nt_plain``: the same exact sum and epilogue order."""
    return int8_mm_dequant_nt_plain(a_i8, b_kn_i8.T, row_scale, col_scale, out_dtype)


def int8_mm_dequant_split_plain(a_i8, b_kn_i8, row_scale, col_scale, out_dtype=torch.bfloat16, splits=1):
    """K4's split-K arithmetic written plainly: ``int8_mm_dequant_nt_split_plain`` on the
    same bytes read as [N, K]."""
    return int8_mm_dequant_nt_split_plain(a_i8, b_kn_i8.T, row_scale, col_scale, out_dtype, splits)


def int8_mm_dequant(a_i8, b_kn_i8, row_scale, col_scale, out_dtype=torch.bfloat16, plan=None):
    """K4 on CUDA tensors, its plain version on CPU tensors. ``plan``: (m tile, splits)
    to launch instead of ``int8_mm_kn_plan``'s (the card tests use it)."""
    if a_i8.device.type == "cpu":
        return int8_mm_dequant_plain(a_i8, b_kn_i8, row_scale, col_scale, out_dtype)
    return _launch(int8_mm_dequant, "lxt_int8_mm_dequant_kn", a_i8, b_kn_i8, False, row_scale, col_scale, out_dtype,
                   plan)


launches.counted("int8_mm_dequant", int8_mm_dequant, r"int8_mm_kn_kernel")


def wgmma_check_s8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bare int8 wgmma product through K1's building blocks (csrc/wgmma_check.cu), for
    the card tests: a int8 [64, 128] times b int8 [N, 128] transposed, both K-major from
    shared memory through 2-D tensor maps; N is 128 or 256. Returns int32 [64, N]."""
    n = b.shape[0]
    if a.shape != (64, 128) or b.shape != (n, 128) or n not in (128, 256):
        raise ValueError(f"a must be [64, 128] and b [N, 128] with N 128 or 256, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8 or not (a.is_cuda and b.is_cuda):
        raise TypeError("wgmma_check_s8 takes int8 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, n), dtype=torch.int32, device=a.device)
    lib = build.load_library()
    build.check(lib.lxt_wgmma_check_s8(a.data_ptr(), b.data_ptr(), c.data_ptr(), n,
                                       torch.cuda.current_stream(a.device).cuda_stream), "wgmma_check_s8")
    return c


def wgmma_check_s8_rs(a: torch.Tensor, b: torch.Tensor, canonical: bool) -> torch.Tensor:
    """One bare int8 wgmma with A from registers, K4's product (csrc/wgmma_check.cu), for
    the card tests: a int8 [N, 128] ([m, k]) and b int8 [128, 128] ([k, n] as K4 reads the
    base), both by TMA; returns int32 [64, N] = b[:, :64]^T a^T. ``canonical`` gathers b^T
    into the documented register layout byte by byte, else K4's ``kn_fragment`` builds it
    from b's swizzled box; N is 128 or 256."""
    n = a.shape[0]
    if a.shape != (n, 128) or b.shape != (128, 128) or n not in (128, 256):
        raise ValueError(f"a must be [N, 128] with N 128 or 256 and b [128, 128], got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8 or not (a.is_cuda and b.is_cuda):
        raise TypeError("wgmma_check_s8_rs takes int8 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, n), dtype=torch.int32, device=a.device)
    lib = build.load_library()
    build.check(lib.lxt_wgmma_check_s8_rs(a.data_ptr(), b.data_ptr(), c.data_ptr(), n, int(canonical),
                                          torch.cuda.current_stream(a.device).cuda_stream), "wgmma_check_s8_rs")
    return c
