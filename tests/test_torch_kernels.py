"""The port's hand-written CUDA kernels against their plain PyTorch versions on a
CUDA card. Every test is marked ``gpu`` and skips without a card (decided inside
the test). This file imports only torch and the port, so it runs where JAX is not
installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

Tolerances: K1 (both paths, with split-K) and K4 bit-exact (exact integer sums, same
epilogue order); the bare wgmma products exact (small integers); K2 out per
element 2^-7 |ref| + 2^-5 rms(ref's row) (``flash_fwd_tolerance``, with and without
dropout) and lse 2e-3 (fp32 sums in another order); K3 per
element 4e-3 + 2^-7 |ref| (bf16 out; P rounded to bf16 at the kernel's running max),
which a window one position off misses by 5x or more; K5 per element 2^-7 |ref| +
2^-5 rms(ref) for each of dq, dk, dv (``flash_bwd_tolerance``, the one formula the
chip smoke script uses too), with and without dropout (one flipped bit of the hash moves
elements by the size of the output); K6 per element 2^-7 |ref| + 2^-8 rms(ref)
(``probe_tolerance``). K2's ring form and K5's offsets form (ring attention's blocks) with
K2's and K5's tolerances, out compared on the rows that see a key of the block. K7 (the
rowwise quantizer) bit-exact: codes and scales equal the plain chain's on the card."""

import math

import pytest
import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops import int8 as i8
from llama_x_tpu_torch.ops import int8_mm as mm
from llama_x_tpu_torch.ops.attention import MaskInfo

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("M", [1, 4, 37, 300])
@pytest.mark.parametrize("N,K", [(1024, 4096), (200, 144)])
def test_int8_mm_kernel_matches_plain(cuda, M, N, K):
    """K1: ragged M and N edges, K % 16 == 0, bf16 and f32 out."""
    g = torch.Generator(device=cuda).manual_seed(M + N)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=cuda, generator=g)
    rs = torch.rand(M, device=cuda, generator=g).to(torch.bfloat16)
    cs = torch.rand(N, device=cuda, generator=g)
    before = mm.int8_mm_dequant_nt.launches
    for out_dtype in (torch.bfloat16, torch.float32):
        got = mm.int8_mm_dequant_nt(a, b, rs, cs, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, mm.int8_mm_dequant_nt_plain(a, b, rs, cs, out_dtype=out_dtype))
    assert mm.int8_mm_dequant_nt.launches == before + 2
    with pytest.raises(ValueError):
        mm.int8_mm_dequant_nt(a[:, :8].contiguous(), b[:, :8].contiguous(), rs, cs)  # K % 16 != 0


@pytest.mark.parametrize("M", [1, 4, 16, 17, 48, 49, 63, 64, 65, 300, 2048])
@pytest.mark.parametrize("N,K", [(200, 144), (1024, 4096)])
def test_int8_mm_paths_match_plain(cuda, M, N, K):
    """K1 on both paths (weight streaming up to STREAM_MAX_M = 48 rows, wgmma above)
    around the threshold and the 16-row and 128-row tile edges, with the plan's split-K,
    bf16 and f32 out: bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7 * M + N)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=cuda, generator=g)
    rs = torch.rand(M, device=cuda, generator=g) * 0.02
    cs = torch.rand(N, device=cuda, generator=g) * 0.001
    path, _, _ = mm.int8_mm_plan(M, N, K)
    assert path == ("stream" if M <= mm.STREAM_MAX_M else "wgmma")
    for out_dtype in (torch.bfloat16, torch.float32):
        got = mm.int8_mm_dequant_nt(a, b, rs, cs, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, mm.int8_mm_dequant_nt_plain(a, b, rs, cs, out_dtype=out_dtype)), out_dtype


@pytest.mark.parametrize("M", [1, 4, 16])
def test_int8_mm_unsplit_stream_matches_plain(cuda, M):
    """K1's streaming path without split-K (N 14336: the strips alone fill the SMs), the
    decode shape of w1 / w3: bit for bit, bf16 out."""
    N, K = 14336, 4096
    assert mm.int8_mm_plan(M, N, K) == ("stream", mm.STREAM_BN, 1)
    g = torch.Generator(device=cuda).manual_seed(M)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=cuda, generator=g)
    rs, cs = torch.rand(M, device=cuda, generator=g) * 0.02, torch.rand(N, device=cuda, generator=g) * 0.001
    got = mm.int8_mm_dequant_nt(a, b, rs, cs)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.int8_mm_dequant_nt_plain(a, b, rs, cs))


@pytest.mark.parametrize("M,N,K,plan", [
    (4, 1024, 4096, None),                # the decode plan: 16 strips x 16 splits
    (40, 200, 1040, ("stream", 64, 3)),   # ragged strips and a ragged last slice
    (512, 4096, 16384, ("wgmma", 256, 4)),
    (300, 1000, 4112, ("wgmma", 128, 5)),  # ragged tiles on both sides, a ragged last slice
    (128, 4096, 128256, None),            # a deep contraction over few tiles: the plan splits K
])
def test_int8_mm_split_k_gives_the_same_bits_twice(cuda, M, N, K, plan):
    """K1's split-K: the last split of a tile adds the others' int32 partials, so two runs
    (and any arrival order) give the bits of the plain version; the counters are left at
    zero for the next launch."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=cuda, generator=g)
    rs = torch.rand(M, device=cuda, generator=g) * 0.02
    cs = torch.rand(N, device=cuda, generator=g) * 0.001
    assert (plan or mm.int8_mm_plan(M, N, K))[2] > 1
    first = mm.int8_mm_dequant_nt(a, b, rs, cs, out_dtype=torch.float32, plan=plan)
    second = mm.int8_mm_dequant_nt(a, b, rs, cs, out_dtype=torch.float32, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, mm.int8_mm_dequant_nt_plain(a, b, rs, cs, out_dtype=torch.float32))
    assert int(mm._counters[a.device].abs().sum()) == 0


# K7's rows: decode (1, 32) and training (4096) at the widths of the projections' inputs
# and gradients (128: the KV cache's rows), and the head's dlogits chunk
QUANTIZE_SHAPES = [(R, C) for R in (1, 32, 4096) for C in (128, 1024, 4096, 5120, 14336)] + [(512, 131072)]


def _quantize_input(device, R: int, C: int, dtype, seed: int) -> torch.Tensor:
    """Rows of varied magnitude; where R >= 3 row 0 is zero, row 1 lands on exact halves
    (max 127, so the scale is 1 and x / scale is k + 0.5: half to even decides), and row 2's
    largest magnitude is a negative entry."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(R, C, device=device, generator=g) * (4 * torch.rand(R, 1, device=device, generator=g) + 0.01)
    if R >= 3:
        x[0] = 0.0
        x[1] = torch.arange(C, device=device) % 254 - 126.5
        x[1, 0] = 127.0
        x[2, C // 2] = -2 * x[2].abs().max()
    return x.to(dtype)


@pytest.mark.parametrize("col", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,C", QUANTIZE_SHAPES)
def test_quantize_rows_matches_plain(cuda, R, C, dtype, col):
    """K7 against the plain chain on the card, codes and scales bit for bit, with and without
    the column scale (the backward's weight scale, the head's vocabulary scale), one launch."""
    x = _quantize_input(cuda, R, C, dtype, R + C)
    cs = None
    if col:
        g = torch.Generator(device=cuda).manual_seed(C)
        cs = (torch.rand(C, device=cuda, generator=g) * 0.02 + 1e-4).to(dtype)
    before = i8.quantize_rows.launches
    q, s = i8.quantize_int8_rowwise(x, col_scale=cs)
    torch.cuda.synchronize()
    assert i8.quantize_rows.launches == before + 1
    q_p, s_p = i8.quantize_rows_plain(x, cs)
    assert q.dtype == torch.int8 and s.dtype == dtype
    assert torch.equal(s, s_p)
    assert torch.equal(q, q_p)
    if R >= 3 and not col:
        assert not q[0].any() and s[0] == 0
        assert float(s[1]) == 1.0 and torch.equal(q[1].float(), torch.round(x[1].float()))
        assert int(q[2, C // 2]) == -127


@pytest.mark.parametrize("shape", [(32, 1, 8, 128), (1, 512, 8, 128), (3, 5, 2, 64)])
def test_quantize_kv_rows_matches_plain(cuda, shape):
    """The int8 cache's new rows through K7: f32 scales, bit for bit with the plain chain."""
    x = _quantize_input(cuda, math.prod(shape[:-1]), shape[-1], torch.bfloat16, 3).reshape(shape)
    before = i8.quantize_rows.launches
    q, s = llama.quantize_kv_rows(x)
    torch.cuda.synchronize()
    assert i8.quantize_rows.launches == before + 1
    q_p, s_p = i8.quantize_rows_plain(x.reshape(-1, shape[-1]), scale_dtype=torch.float32)
    assert s.dtype == torch.float32 and s.shape == shape[:-1]
    assert torch.equal(q, q_p.reshape(shape)) and torch.equal(s, s_p.reshape(shape[:-1]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_unaligned_rows_and_views(cuda, dtype):
    """K7's single-element loads (rows that are no whole number of 16-byte loads, rows that
    start one element in), a row wider than its group's registers hold at that width, and
    views the router makes contiguous (a column slice, expanded rows); a view handed to K7's
    wrapper itself raises."""
    x = _quantize_input(cuda, 64, 3002, dtype, 9)
    flat = x.reshape(-1)
    cases = [x[:5, :37].contiguous(), x[:, :3001].contiguous(), flat[1:1 + 63 * 3000].view(63, 3000),
             flat[1:1 + 40 * 1000].view(40, 1000)]
    for v in cases:
        cs = (torch.rand(v.shape[1], device=cuda) * 0.02 + 1e-4).to(dtype)
        for col in (None, cs):
            q, s = i8.quantize_rows(v, col)
            q_p, s_p = i8.quantize_rows_plain(v, col)
            assert torch.equal(q, q_p) and torch.equal(s, s_p), (tuple(v.shape), v.data_ptr() % 16)
    for view in (x[:, 1:1001], x[:1, :2048].expand(6, 2048)):
        q, s = i8.quantize_int8_rowwise(view)
        q_p, s_p = i8.quantize_rows_plain(view)
        assert torch.equal(q, q_p) and torch.equal(s, s_p)
        with pytest.raises(ValueError):
            i8.quantize_rows(view)


def test_quantize_rows_counts_one_launch_a_call_under_a_graph_capture(cuda):
    """Under a CUDA graph's capture each K7 call adds one launch to the capture's tally and
    none to the counter; the replay writes what the plain chain gives."""
    from llama_x_tpu_torch.ops import launches

    x = _quantize_input(cuda, 64, 4096, torch.bfloat16, 5)
    cs = (torch.rand(4096, device=cuda) * 0.02).to(torch.bfloat16)
    stream = torch.cuda.Stream()
    i8.quantize_int8_rowwise(x)  # the library is built outside the capture
    torch.cuda.synchronize()
    before = i8.quantize_rows.launches
    graph = torch.cuda.CUDAGraph()
    with launches.tally(stream) as tally, torch.cuda.graph(graph, stream=stream):
        outs = [i8.quantize_int8_rowwise(x), i8.quantize_int8_rowwise(x, col_scale=cs),
                llama.quantize_kv_rows(x.reshape(64, 32, 128))]
    assert tally == {i8.quantize_rows: 3}
    assert i8.quantize_rows.launches == before
    graph.replay()
    torch.cuda.synchronize()
    want = [i8.quantize_rows_plain(x), i8.quantize_rows_plain(x, cs),
            i8.quantize_rows_plain(x.reshape(-1, 128), scale_dtype=torch.float32)]
    for (q, s), (q_p, s_p) in zip(outs, want):
        assert torch.equal(q.reshape(q_p.shape), q_p) and torch.equal(s.reshape(s_p.shape), s_p)


@pytest.mark.parametrize("col", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,C", [(32, 4096), (4096, 1024), (4096, 14336), (512, 131072)])
def test_quantize_rows_codes_split_rows_from_their_whole_absmax(cuda, monkeypatch, R, C, dtype, col):
    """Rows split over a mesh (tensor parallelism: a rank holds a slice of every row) take K7
    in two launches, its absmax pass, the max all-reduce and its codes pass: a mesh of one rank
    gives the plain chain's codes and scales, and so does each half of rows split in two, its
    all-reduce folding in the other half's absmax as two ranks exchange it."""
    from llama_x_tpu_torch.parallel import mesh as tmesh

    x = _quantize_input(cuda, R, C, dtype, R + C + 1)
    cs = (torch.rand(C, device=cuda) * 0.02 + 1e-4).to(dtype) if col else None
    want_q, want_s = i8.quantize_rows_plain(x, cs)
    mesh = tmesh.Mesh(tmesh.mesh_shape(1), 0, None)
    before = i8.quantize_rows.launches
    q, s = i8.quantize_int8_rowwise(x, mesh, col_scale=cs)
    assert i8.quantize_rows.launches == before + 2
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    halves = [slice(0, C // 2), slice(C // 2, C)]
    got = []
    for mine, other in (halves, halves[::-1]):
        rest = x[:, other] if cs is None else x[:, other] * cs[other]
        rest_amax = rest.float().abs().amax(dim=1)
        monkeypatch.setattr(i8, "all_reduce", lambda mesh, t, axis, op: torch.maximum(t, rest_amax))
        q, s = i8.quantize_int8_rowwise(x[:, mine], mesh, col_scale=None if cs is None else cs[mine].contiguous())
        assert torch.equal(s, want_s)
        got.append(q)
    assert torch.equal(torch.cat(got, dim=1), want_q)


def test_quantize_int8_rowwise_refuses_half_rows_on_the_card(cuda):
    """Every CUDA call reaches K7, whose wrapper raises on a dtype it does not take."""
    with pytest.raises(TypeError):
        i8.quantize_int8_rowwise(torch.ones(4, 64, dtype=torch.float16, device=cuda))


@pytest.mark.parametrize("n", [128, 256])
def test_wgmma_s8_product_matches_float64(cuda, n):
    """The bare int8 wgmma of K1 (csrc/wgmma_check.cu): 2-D tensor maps in the 128-byte
    swizzle, K-major descriptors stepped 32 bytes at a time, m64n128k32 and m64n256k32,
    against the float64 product (exact for these sums)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randint(-127, 128, (64, 128), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (n, 128), dtype=torch.int8, device=cuda, generator=g)
    got = mm.wgmma_check_s8(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.double(), a.double() @ b.double().T)


# document boundaries of the packed case: on the kernels' 128-position tiles (128, 1024,
# 2048, 3968) and inside them (300, 1100, 3000, 4000)
PACKED_BOUNDS = (128, 300, 1024, 1100, 2048, 3000, 3968, 4000)


def _mask(case: str, B: int, S: int, dev):
    g = torch.Generator(device=dev).manual_seed(S)
    segs = torch.sort(torch.randint(1, 4, (B, S), device=dev, generator=g), dim=1).values.to(torch.int32)
    prefix = torch.randint(1, max(S // 2, 2), (B,), device=dev, generator=g).to(torch.int32)
    pos = torch.arange(S, device=dev)
    packed = (pos[:, None] >= torch.tensor(PACKED_BOUNDS, device=dev)[None, :]).sum(dim=1).to(torch.int32) + 1
    return {
        "causal": lambda: MaskInfo(causal=True),
        "noncausal": lambda: MaskInfo(causal=False),
        "prefix": lambda: MaskInfo(causal=True, prefix_len=prefix),
        "segment+prefix": lambda: MaskInfo(causal=True, segment_ids=segs, prefix_len=prefix),
        "packed": lambda: MaskInfo(causal=True, segment_ids=packed.expand(B, S)),
        "prefix2000": lambda: MaskInfo(causal=True, prefix_len=torch.full((B,), 2000, dtype=torch.int32, device=dev)),
    }[case]()


# (mask, S, D, GQA group, B): ragged S on both sides of the 128-position tiles, D 64 and
# 128, groups 1, 4 and 8, packed documents with boundaries on and inside tiles, the
# prefix-LM 2000 of the audio step, and an unmasked S 256 whose tiles are all "full"
FLASH_CASES = [
    ("causal", 512, 128, 4, 2), ("prefix", 37, 64, 4, 2), ("segment+prefix", 200, 128, 4, 2),
    ("noncausal", 64, 64, 4, 2), ("causal", 130, 64, 4, 2), ("causal", 129, 128, 1, 2), ("causal", 255, 64, 8, 2),
    ("segment+prefix", 255, 128, 8, 2), ("noncausal", 256, 128, 2, 2), ("packed", 4096, 128, 4, 1),
    ("prefix2000", 4096, 128, 4, 1), ("prefix2000", 4096, 64, 8, 1),
]


@pytest.mark.parametrize("case,S,D,group,B", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, case, S, D, group, B):
    Hkv = 2
    Hq = Hkv * group
    mi = _mask(case, B, S, cuda)
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = (torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    before = fa.flash_fwd_with_lse.launches
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
    torch.cuda.synchronize()
    assert fa.flash_fwd_with_lse.launches == before + 1
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi)
    _assert_k2_close(out, ref)
    assert _max_err(lse, ref_lse) <= 2e-3


def _assert_k2_close(out, ref):
    atol, rtol = fa.flash_fwd_tolerance(ref)
    over = float(((out.float() - ref.float()).abs() - rtol * ref.float().abs() - atol).max())
    assert over <= 0.0, f"|err| exceeds 2^-5 rms(row) + {rtol}|ref| by {over}"


def _assert_k3_close(out, ref, atol=4e-3, rtol=2**-7):
    excess = float(((out.float() - ref.float()).abs() - rtol * ref.float().abs()).max())
    assert excess <= atol, f"|err| - {rtol}|ref| reaches {excess} > {atol}"


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Sq,D", [(1, 128), (5, 128), (3, 64)])
@pytest.mark.parametrize("last", [(1, 65, 300), (63, 64, 65)])
def test_decode_kernel_matches_plain(cuda, quantized, Sq, D, last):
    """K3: windows of 1, 65 and the whole cache (S_max not a tile multiple), windows
    on both sides of the 64-position tile edge, and the per-query staircase for Sq > 1."""
    B, Hq, Hkv, S_max = 3, 8, 2, 300
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn(B, Sq, Hq, D, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S_max, D, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S_max, D, device=cuda, generator=g).to(torch.bfloat16)
    lens = (torch.tensor(last, device=cuda)[:, None] - (Sq - 1)
            + torch.arange(Sq, device=cuda)[None, :]).clamp(min=1).to(torch.int32)
    scale = 1 / math.sqrt(D)
    if quantized:
        args = (*llama.quantize_kv_rows(k), *llama.quantize_kv_rows(v))
        out = da.decode_attention_int8(q, *args, lens, scale)
        torch.cuda.synchronize()
        ref = da.decode_attention_int8_plain(q, *args, lens, scale)
    else:
        out = da.decode_attention(q, k, v, lens, scale)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, lens, scale)
    _assert_k3_close(out, ref)


def _decode_case(dev, quantized, B, Sq, Hq, Hkv, S_max, D, last, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S_max, D, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S_max, D, device=dev, generator=g).to(torch.bfloat16)
    lens = (torch.tensor(last, device=dev)[:, None] - (Sq - 1)
            + torch.arange(Sq, device=dev)[None, :]).clamp(min=1).to(torch.int32)
    scale = 1 / math.sqrt(D)
    if quantized:
        args = (*llama.quantize_kv_rows(k), *llama.quantize_kv_rows(v))
        return (lambda: da.decode_attention_int8(q, *args, lens, scale),
                lambda: da.decode_attention_int8_plain(q, *args, lens, scale))
    return lambda: da.decode_attention(q, k, v, lens, scale), lambda: da.decode_attention_plain(q, k, v, lens, scale)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("last", [(63, 64, 65, 1000), (127, 128, 129, 40), (700, 193, 8, 1000)])
def test_decode_kernel_at_split_edges(cuda, quantized, last):
    """K3 split-KV with 64 query rows (Sq 8 x group 8) at D 64: windows one position
    either side of a split edge (the plan cuts S_max 1000 into 64-position ranges here),
    rows whose window ends before the second split while another row's runs on, and the
    whole cache (the last range ragged)."""
    B, Sq, Hq, Hkv, S_max, D = 4, 8, 16, 2, 1000, 64
    splits, split_len = da.decode_split_plan(S_max, B, Hkv)
    assert splits > 1 and split_len == 64
    run, plain = _decode_case(cuda, quantized, B, Sq, Hq, Hkv, S_max, D, last, seed=len(last) + int(quantized))
    before = (da.decode_attention_int8 if quantized else da.decode_attention).launches
    out = run()
    torch.cuda.synchronize()
    assert (da.decode_attention_int8 if quantized else da.decode_attention).launches == before + 1
    _assert_k3_close(out, plain())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Sq", [1, 5])
def test_decode_kernel_with_one_split(cuda, quantized, Sq):
    """A cache of one 64-position tile: one split, whose CTA writes bf16 out itself (no
    partials, no merge kernel)."""
    B, Hq, Hkv, S_max, D = 3, 8, 2, 64, 128
    assert da.decode_split_plan(S_max, B, Hkv) == (1, 64)
    run, plain = _decode_case(cuda, quantized, B, Sq, Hq, Hkv, S_max, D, (1, 33, 64), seed=Sq)
    out = run()
    torch.cuda.synchronize()
    _assert_k3_close(out, plain())


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_kernel_gives_the_same_bits_twice(cuda, quantized):
    """K3 has no atomics: the splits merge in a fixed order, so two calls agree bit for
    bit (B 4, 32/8 heads, D 128, S_max 4096: the serving shape, 8 splits)."""
    run, _ = _decode_case(cuda, quantized, 4, 5, 32, 8, 4096, 128, (1, 513, 2048, 4096), seed=11)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", ["kv_positions", "prefix", "segments", "Sq > MAX_SQ, positions with a gap"])
def test_decode_outside_the_kernel_contract_raises(cuda, case):
    """On the card a read of the cache never takes the plain attention: a mask that
    neither the decode kernel nor the flash kernel's offsets form takes raises (above
    MAX_SQ rows, causal q_positions with kv_len go to the offsets form; positions that
    are not contiguous in a row raise)."""
    from llama_x_tpu_torch.ops.attention import MaskInfo

    cfg = llama.tiny_config(embed_dim=256, head_dim=64, num_heads=4, num_kv_heads=2, intermediate_dim=512,
                            max_seq_len=64)
    model = llama.init(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    cache = llama.init_kv_cache(cfg, 1, dtype=torch.bfloat16, device=cuda)
    S = da.MAX_SQ + 1 if case.startswith("Sq") else 1
    pos = torch.arange(S, device=cuda)
    if case.startswith("Sq"):
        pos[-1] += 1
    extra = {"prefix": dict(prefix_len=torch.ones(1, dtype=torch.int32, device=cuda)),
             "segments": dict(segment_ids=torch.ones(1, S, dtype=torch.int32, device=cuda)),
             "kv_positions": dict(kv_positions=torch.arange(64, device=cuda)[None])}.get(case, {})
    mi = MaskInfo(causal=True, q_positions=pos[None], kv_len=torch.tensor([S + 1], device=cuda), **extra)
    x = torch.zeros(1, S, cfg.embed_dim, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="decode kernel|contiguous"):
        llama.trunk(model, x, mi, cache, input_pos=pos)


def _offsets_case(cuda, B, Sq, Hq, Hkv, D, S_max, q_off, kv_len, kv_off=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(B, Hkv, S_max, D, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S_max, D, device=cuda, generator=g).to(torch.bfloat16)
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device=cuda)
    return q, k, v, ints(q_off), ints(kv_off if kv_off is not None else [0] * B), ints(kv_len)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("shape", [
    # a continuation chunk of chunked prefill; a prefix admission (the last q tile ragged,
    # kv_len cutting a kv tile); a verify at gamma 8 over eight slots; offsets on both sides
    ("chunk", 1, 512, 4096, [1536], [2048], None),
    ("prefix admission", 1, 256, 4096, [512], [712], None),
    ("verify gamma 8", 8, 9, 2048, [513, 640, 700, 800, 901, 1000, 1200, 1500],
     [522, 649, 709, 809, 910, 1009, 1209, 1509], None),
    ("kv offsets", 2, 130, 1024, [300, 77], [1024, 333], [40, 0]),
])
def test_flash_offsets_kernel_matches_plain(cuda, D, shape):
    """K2's offsets form over a [B, Hkv, S_max, D] cache read in place, per-row q_offset,
    kv_offset and kv_len, against ``flash_fwd_offsets_plain``: out per element
    ``flash_fwd_tolerance``, lse 2e-3; and the int8 cache through the dequantizing
    wrapper against the plain version over the same dequantized prefix."""
    _, B, Sq, S_max, q_off, kv_len, kv_off = shape
    q, k, v, qo, ko, lens = _offsets_case(cuda, B, Sq, 32 if D == 128 else 8, 8 if D == 128 else 2, D, S_max,
                                          q_off, kv_len, kv_off)
    before = fa.flash_fwd_offsets.launches
    out, lse = fa.flash_fwd_offsets(q, k, v, qo, ko, lens)
    torch.cuda.synchronize()
    assert fa.flash_fwd_offsets.launches == before + 1
    ref, ref_lse = fa.flash_fwd_offsets_plain(q, k, v, qo, ko, lens)
    atol, rtol = fa.flash_fwd_tolerance(ref)
    assert ((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all()
    assert _max_err(lse, ref_lse) <= 2e-3

    k8, ks = llama.quantize_kv_rows(k)
    v8, vs = llama.quantize_kv_rows(v)
    n = max(kv_len)
    out8, _ = fa.flash_fwd_offsets_int8(q, k8, ks, v8, vs, qo, ko, lens, n)
    torch.cuda.synchronize()
    ref8, _ = fa.flash_fwd_offsets_plain(q, fa.dequant_live(k8, ks, n), fa.dequant_live(v8, vs, n), qo, ko, lens)
    atol8, _ = fa.flash_fwd_tolerance(ref8)
    assert ((out8.float() - ref8.float()).abs() <= atol8 + rtol * ref8.float().abs()).all()


def test_flash_offsets_outside_the_kernel_contract_raises(cuda):
    """head_dim 32, a float16 query, a cache that is not contiguous: each raises; nothing
    falls back to the plain version."""
    q, k, v, qo, ko, lens = _offsets_case(cuda, 1, 16, 4, 2, 64, 256, [10], [26])
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd_offsets(q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(), qo, ko,
                             lens)
    with pytest.raises(TypeError):
        fa.flash_fwd_offsets(q.half(), k, v, qo, ko, lens)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd_offsets(q, k[:, :, :128], v[:, :, :128], qo, ko, lens)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_cache_read_beyond_max_sq_runs_the_offsets_form(cuda, cache_dtype):
    """A 24-row chunk over a cache holding 40 earlier positions: the trunk takes K2's
    offsets form once a layer (its counter moves, K3's do not) and gives finite states."""
    from llama_x_tpu_torch.ops.attention import MaskInfo

    cfg = llama.tiny_config(embed_dim=256, head_dim=64, num_heads=4, num_kv_heads=2, intermediate_dim=512,
                            max_seq_len=128)
    model = llama.init(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    cache = llama.init_kv_cache(cfg, 1, dtype=cache_dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    tokens = torch.randint(0, 256, (1, 64), device=cuda, generator=g)
    x = torch.nn.functional.embedding(tokens, model.tok_embeddings)
    with torch.inference_mode():
        llama.trunk(model, x[:, :40], MaskInfo(causal=True), cache, input_pos=torch.arange(40, device=cuda),
                    prefill=True)
        pos = torch.arange(40, 64, device=cuda)
        mi = MaskInfo(causal=True, q_positions=pos[None], kv_len=torch.tensor([64], device=cuda))
        before = (fa.flash_fwd_offsets.launches, da.decode_attention.launches, da.decode_attention_int8.launches)
        h, _ = llama.trunk(model, x[:, 40:], mi, cache, input_pos=pos)
        torch.cuda.synchronize()
        assert fa.flash_fwd_offsets.launches == before[0] + cfg.num_layers
        assert (da.decode_attention.launches, da.decode_attention_int8.launches) == before[1:]
    assert h.shape == (1, 24, cfg.embed_dim) and bool(torch.isfinite(h).all())


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_small_model_generate_runs_the_kernels(cuda, cache_dtype):
    """A head_dim-64 model in bf16 with int8 weights and dynamic int8 activations:
    a ragged generate launches K1, K2 and K3 and returns tokens of the right shape."""
    from llama_x_tpu_torch.adapters.quantize import quantize_linear
    from llama_x_tpu_torch.models.generate import generate

    cfg = llama.tiny_config(embed_dim=256, head_dim=64, num_heads=4, num_kv_heads=2, intermediate_dim=512,
                            max_seq_len=128, dynamic_int8_act=True)
    model = llama.init(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    quantize_linear(model.layers, "int8")
    prompt = torch.randint(0, 256, (2, 40), device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    lens = torch.tensor([40, 17], device=cuda)
    counters = (mm.int8_mm_dequant_nt, fa.flash_fwd_with_lse,
                da.decode_attention_int8 if cache_dtype == torch.int8 else da.decode_attention)
    before = [c.launches for c in counters]
    out = generate(model, prompt, max_new_tokens=6, cache_dtype=cache_dtype, prompt_lens=lens)
    torch.cuda.synchronize()
    assert out.shape == (2, 6)
    assert all(c.launches > b for c, b in zip(counters, before))


@pytest.mark.parametrize("M", [1, 37, 300])
@pytest.mark.parametrize("K,N", [(1024, 4096), (144, 208), (4096, 1024)])
def test_int8_mm_kn_kernel_matches_plain(cuda, M, K, N):
    """K4: b in [K, N] layout; ragged M, tile-ragged N and K (multiples of 16), bf16
    and f32 out, bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(M + N)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=cuda, generator=g)
    rs = torch.rand(M, device=cuda, generator=g).to(torch.bfloat16)
    cs = torch.rand(N, device=cuda, generator=g)
    before = mm.int8_mm_dequant.launches
    for out_dtype in (torch.bfloat16, torch.float32):
        got = mm.int8_mm_dequant(a, b, rs, cs, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, mm.int8_mm_dequant_plain(a, b, rs, cs, out_dtype=out_dtype))
    assert mm.int8_mm_dequant.launches == before + 2
    # the same bytes read as [N, K] by K1 give the transposed product
    assert torch.equal(mm.int8_mm_dequant(a, b, rs, cs), mm.int8_mm_dequant_nt(a, b.T.contiguous(), rs, cs))


@pytest.mark.parametrize("M,N,K,plans", [
    (300, 4112, 1040, [(256, 1), (128, 1), (256, 3), (128, 9)]),  # ragged tiles on every side, ragged last slice
    (37, 208, 272, [(256, 1), (128, 2), (128, 3)]),
    (512, 4096, 16384, [(256, 1), (256, 2), (128, 1), (128, 4)]),
    (384, 4096, 16384, [None]),  # the plan splits K in 2
    (262, 4096, 128256, [None, (128, 1)]),  # the audio step's dH chunk: the last 256-m tile reads rows 6..261
])
def test_int8_mm_kn_plans_match_plain(cuda, M, N, K, plans):
    """K4 at forced plans (m tile, splits): every plan gives the plain version's bits, bf16
    and f32 out, twice (the split-K counters are left at zero for the next launch)."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=cuda, generator=g)
    rs = torch.rand(M, device=cuda, generator=g) * 0.02
    cs = torch.rand(N, device=cuda, generator=g) * 0.001
    for out_dtype in (torch.bfloat16, torch.float32):
        want = mm.int8_mm_dequant_plain(a, b, rs, cs, out_dtype=out_dtype)
        for plan in plans:
            for _ in range(2):
                got = mm.int8_mm_dequant(a, b, rs, cs, out_dtype=out_dtype, plan=plan)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (plan, out_dtype)
    if a.device in mm._counters:
        assert int(mm._counters[a.device].abs().sum()) == 0


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("canonical", [True, False])
def test_wgmma_s8_register_a_matches_float64(cuda, n, canonical):
    """K4's product (csrc/wgmma_check.cu): wgmma m64nNk32 s32.s8.s8 with A from registers,
    b^T gathered into the documented register layout (canonical) or built by K4's
    ldmatrix.trans and byte permutes from b's swizzled TMA box, against the float64
    product (exact for these sums)."""
    g = torch.Generator(device=cuda).manual_seed(n + canonical)
    a = torch.randint(-127, 128, (n, 128), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (128, 128), dtype=torch.int8, device=cuda, generator=g)
    got = mm.wgmma_check_s8_rs(a, b, canonical)
    torch.cuda.synchronize()
    assert torch.equal(got.double(), b[:, :64].double().T @ a.double().T)


@pytest.mark.parametrize("case", ["N % 16", "K % 16", "K overflow", "float a"])
def test_int8_mm_kn_raises(cuda, case):
    M, K, N = 4, 64, 64
    if case == "N % 16":
        N = 40
    elif case == "K % 16":
        K = 40
    elif case == "K overflow":
        K = (mm.MAX_K // 16 + 1) * 16
    a = torch.zeros(M, K, dtype=torch.int8, device=cuda)
    b = torch.zeros(K, N, dtype=torch.int8, device=cuda)
    if case == "float a":
        a = a.float()
    with pytest.raises(TypeError if case == "float a" else ValueError):
        mm.int8_mm_dequant(a, b, torch.ones(M, device=cuda), torch.ones(N, device=cuda))


def _assert_k5_close(name, got, ref):
    """One of dq, dk, dv within ``flash_bwd_tolerance`` of its reference: per element
    2^-7 |ref| + 2^-5 rms(ref)."""
    atol, rtol = fa.flash_bwd_tolerance(ref)
    excess = float(((got.float() - ref.float()).abs() - rtol * ref.float().abs()).max())
    assert excess <= atol, f"{name}: |err| - {rtol} |ref| reaches {excess} > {atol}"


@pytest.mark.parametrize("case,S,D,group,B", [("causal", 256, 128, 4, 2)] + FLASH_CASES[1:])
def test_flash_bwd_kernel_matches_plain(cuda, case, S, D, group, B):
    """K5: dq, dk, dv from the forward kernel's (out, lse): ragged S, D 64 and 128, GQA
    groups 1 to 8, packed documents, prefix-LM, all-full tiles."""
    Hkv = 2
    Hq = Hkv * group
    mi = _mask(case, B, S, cuda)
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
    before = fa.flash_bwd_from_res.launches
    got = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi)
    torch.cuda.synchronize()
    assert fa.flash_bwd_from_res.launches == before + 1
    want = fa.flash_bwd_plain(q, k, v, out, lse, do, mi)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16
        _assert_k5_close(f"{case} S={S} D={D} {name}", a, b)
    # two runs give the same bits (no atomics)
    again = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["float32", "float16 do", "dropout", "head_dim 32", "positions"])
def test_flash_bwd_raises(cuda, case):
    B, S, H, D = 1, 64, 2, 32 if case == "head_dim 32" else 64
    q, k, v, do = (torch.zeros(B, S, H, D, dtype=torch.bfloat16, device=cuda) for _ in range(4))
    out, lse = torch.zeros_like(q), torch.zeros(B, H, S, 1, device=cuda)
    mi, kw, exc = MaskInfo(causal=True), {}, TypeError
    if case == "float32":
        q = q.float()
    elif case == "float16 do":
        do = do.half()
    elif case == "dropout":  # a plan whose kv block would split a 128-position tile
        kw, exc = dict(dropout=fa.Dropout(0.1, 1, 32, 32)), ValueError
    elif case == "head_dim 32":
        exc = ValueError
    else:
        mi, exc = MaskInfo(causal=True, q_positions=torch.arange(S, device=cuda)), ValueError
    with pytest.raises(exc):
        fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, **kw)
    if case == "dropout":
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, mi, dropout_rate=1.0, dropout_seed=1)


def test_flash_bwd_kernel_gives_the_same_bits_twice(cuda):
    """K5 is deterministic: no atomics, a fixed order of every sum, so two calls on the
    same inputs give equal dq, dk, dv (at the audio step's heads, with 8 packed documents
    and dropout, where many CTAs run at once)."""
    B, S, Hq, Hkv, D = 1, 2048, 32, 8, 128
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, do = (torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    mi = _mask("packed", B, S, cuda)
    dropout = fa.make_dropout(0.1, 3, S, S, Hq // Hkv, 32, 128)
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi, dropout_rate=0.1, dropout_seed=3, block_q=32, block_kv=128)
    first = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout)
    second = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("b_mn_major", [False, True])
def test_wgmma_product_matches_matmul(cuda, n, b_mn_major):
    """The bare wgmma helpers (csrc/hopper.cuh through csrc/wgmma_check.cu): TMA tiles in
    the 128-byte swizzle, K-major descriptors (both operands from shared memory) and the
    MN-major B with A from registers, against torch.matmul in f32 on bf16 inputs. Small
    integers make every product and sum exact, so any misplaced element shows."""
    g = torch.Generator(device=cuda).manual_seed(n + int(b_mn_major))
    a = torch.randint(-4, 5, (64, 64), device=cuda, generator=g).to(torch.bfloat16)
    b = torch.randint(-4, 5, (64, n) if b_mn_major else (n, 64), device=cuda, generator=g).to(torch.bfloat16)
    got = fa.wgmma_check(a, b, b_mn_major)
    torch.cuda.synchronize()
    want = a.float() @ (b.float() if b_mn_major else b.float().T)
    assert torch.equal(got, want)


def test_flash_function_gradients_match_plain_on_the_card(cuda, monkeypatch):
    """The autograd.Function through K2 + K5 against the same Function through the
    plain versions, same inputs on the card. Here each side's backward starts from its
    own forward's out and lse, a bf16 ulp apart, which moves delta = rowsum(dO * O) and
    with it every ds; the kernel-against-plain tolerance holds here too."""
    B, S, Hq, Hkv, D = 2, 96, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    base = [torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv)]
    do = torch.randn(B, S, Hq, D, device=cuda, generator=g).to(torch.bfloat16)
    mi = _mask("segment+prefix", B, S, cuda)

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in base]
        fa.flash_attention(*leaves, mi).backward(do)
        return [t.grad for t in leaves]

    counts = (fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches)
    got = grads()
    assert (fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches) == (counts[0] + 1, counts[1] + 1)
    monkeypatch.setattr(fa, "_forward_impl", fa.flash_fwd_plain)
    monkeypatch.setattr(fa, "flash_bwd_from_res", fa.flash_bwd_plain)
    want = grads()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_k5_close(name, a, b)


@pytest.mark.parametrize("dynamic_int8_bwd", [False, True])
def test_int8_linear_function_matches_plain_on_the_card(cuda, monkeypatch, dynamic_int8_bwd):
    """int8_linear's autograd.Function through K1 (+ K4 for the int8 dgrad) against
    the same Function through the plain versions: bit for bit, and no gradient to
    the base."""
    from llama_x_tpu_torch.ops import int8 as i8

    g = torch.Generator(device=cuda).manual_seed(6)
    x0 = torch.randn(3, 50, 128, device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn(208, 128, device=cuda, generator=g).to(torch.bfloat16)
    int_data, scale = i8.quantize_int8_rowwise(w)
    scale = scale.requires_grad_(True)
    go = torch.randn(3, 50, 208, device=cuda, generator=g).to(torch.bfloat16)

    def run():
        x = x0.clone().requires_grad_(True)
        y = i8.int8_linear(x, int_data, scale, True, dynamic_int8_bwd)
        y.backward(go)
        return y.detach(), x.grad

    k1, k4 = mm.int8_mm_dequant_nt.launches, mm.int8_mm_dequant.launches
    y, gx = run()
    assert mm.int8_mm_dequant_nt.launches == k1 + 1
    assert mm.int8_mm_dequant.launches == k4 + int(dynamic_int8_bwd)
    assert scale.grad is None
    monkeypatch.setattr(mm, "int8_mm_dequant_nt", mm.int8_mm_dequant_nt_plain)
    monkeypatch.setattr(mm, "int8_mm_dequant", mm.int8_mm_dequant_plain)
    y_p, gx_p = run()
    assert torch.equal(y, y_p)
    assert torch.equal(gx, gx_p)  # K4 is exact; without it the same cuBLAS product runs both times


def test_small_model_train_step_runs_the_kernels(cuda):
    """A head_dim-64 QLoRA model in bf16 (int8 base, dynamic int8 activations and input
    gradients, int8 head, fused CE, checkpointing): two optimizer steps on packed rows
    launch K1, K2, K4 and K5, keep the int8 base and move the adapters."""
    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    args = entry.parse_args([
        "--synthetic", "16", "--synthetic_task", "count", "--quantize", "int8", "--quantize_kwargs",
        '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
        "--freeze_prefixes", "tok_embeddings", "output", "norm", "--activation_checkpointing", "--fused_ce_chunks", "2",
        "--document_mask", "--max_seq_len", "200", "--batch_size", "2", "--gradient_accumulation", "2", "--lr", "1e-3",
        "--synthetic_config", '{"num_layers": 2, "embed_dim": 256, "head_dim": 64, "num_heads": 4, "num_kv_heads": 2}',
    ])
    model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
    optimizer, _ = cli.setup_optimizer(args, model)
    state = TrainState(model, optimizer)
    data_iter, _ = entry.make_data(args, model.config.vocab_size)
    batch = cli.assemble_step_batch([next(data_iter) for _ in range(2)], pad_values={"labels": -100})
    lin = model.layers[0].feed_forward.w1
    base, lora_b = lin.int_data.clone(), lin.lora_b.detach().clone()
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    before = [c.launches for c in counters]
    step = make_train_step(entry.loss_fn)
    losses = [float(step(state, batch)["loss"]) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(math.isfinite(x) for x in losses) and losses[1] < losses[0]
    assert all(c.launches > b for c, b in zip(counters, before))
    assert torch.equal(lin.int_data, base) and not torch.equal(lin.lora_b, lora_b)


def test_train_entry_point_runs_on_the_card(cuda, tmp_path, monkeypatch):
    """``train_metamathqa.main`` itself on the small QLoRA model: its own loop over fresh
    batches, the logger, the throughput meter and the end-of-run checkpoint, with K1, K2,
    K4 and K5 launched along the way."""
    import json

    from llama_x_tpu_torch import train_metamathqa as entry

    monkeypatch.chdir(tmp_path)
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    before = [c.launches for c in counters]
    entry.main([
        "--synthetic", "16", "--synthetic_task", "count", "--quantize", "int8", "--quantize_kwargs",
        '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
        "--freeze_prefixes", "tok_embeddings", "output", "norm", "--activation_checkpointing", "--fused_ce_chunks", "2",
        "--document_mask", "--max_seq_len", "200", "--batch_size", "2", "--gradient_accumulation", "2",
        "--n_steps", "2", "--log_interval", "1", "--ckpt_interval", "0",
        "--synthetic_config", '{"num_layers": 2, "embed_dim": 256, "head_dim": 64, "num_heads": 4, "num_kv_heads": 2}',
    ])
    assert all(c.launches > b for c, b in zip(counters, before))
    (run,) = (tmp_path / "runs" / "metamathqa").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs)
    assert (run / "step_00000002").exists()  # the end-of-run checkpoint


@pytest.mark.parametrize("case,S,D,blocks", [
    ("causal", 512, 128, (128, 128)),      # a 4 x 4 grid of plan blocks
    ("prefix", 256, 64, (32, 128)),        # the smallest plan blocks: bq 32, bk 128
    ("segment+prefix", 512, 128, (32, 128)),
    ("segment+prefix", 200, 128, None),    # no plan: one block spans the sequence
    ("causal", 37, 64, None),
    ("audio step", 4096, 128, (256, 1024)),  # prefix-LM 2000, 32/8 heads: 16 x 4 plan blocks
])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_flash_kernels_with_dropout_match_plain(cuda, case, S, D, blocks, rate):
    """K2 and K5 with the dropout hash against their plain versions (which hold the
    JAX package's ``_keep_for`` bit for bit in the CPU tests): out, lse, dq, dk, dv
    under the tolerances of the runs without dropout, and the same bits on a second run."""
    B, Hq, Hkv = (1, 32, 8) if case == "audio step" else (2, 8, 2)
    if case == "audio step":
        mi = MaskInfo(causal=True, prefix_len=torch.full((1,), 2000, dtype=torch.int32, device=cuda))
    else:
        mi = _mask(case, B, S, cuda)
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v, do = (torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    kw = {} if blocks is None else dict(block_q=blocks[0], block_kv=blocks[1])
    seed = 0x7FFFFFF0 + S  # the block keys wrap around 2^32
    dropout = fa.make_dropout(rate, seed, S, S, Hq // Hkv, **kw)
    assert (dropout.bq, dropout.bk) == (blocks or (S, S))
    counts = (fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches)
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi, dropout_rate=rate, dropout_seed=seed, **kw)
    got = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches) == (counts[0] + 1, counts[1] + 1)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi, dropout=dropout)
    _assert_k2_close(out, ref)
    assert _max_err(lse, ref_lse) <= 2e-3
    plain_out, _ = fa.flash_fwd_plain(q, k, v, mi)
    # dropout is live (a row of the audio step averages 2000 keys or more, so it moves less)
    assert _max_err(ref, plain_out) > (0.03 if case == "audio step" else 0.1)
    want = fa.flash_bwd_plain(q, k, v, out, lse, do, mi, dropout=dropout)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_k5_close(f"{case} S={S} D={D} rate={rate} {name}", a, b)
    again = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(out, fa.flash_fwd_with_lse(q, k, v, mi, dropout_rate=rate, dropout_seed=seed, **kw)[0])


def test_flash_function_with_dropout_and_preset_on_the_card(cuda):
    """The autograd.Function with dropout: gradients through K2 + K5, then the same
    gradients with the forward's (out, lse) handed in as a preset, which launches no
    forward kernel."""
    B, S, Hq, Hkv, D = 1, 256, 4, 2, 64
    g = torch.Generator(device=cuda).manual_seed(9)
    base = [torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv)]
    do = torch.randn(B, S, Hq, D, device=cuda, generator=g).to(torch.bfloat16)
    mi = MaskInfo(causal=True)

    def grads(preset=None):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out, lse = fa.flash_fwd_with_lse(*leaves, mi, dropout_rate=0.2, dropout_seed=11, preset=preset)
        out.backward(do)
        return (out.detach(), lse.detach()), [t.grad for t in leaves]

    res, first = grads()
    fwd, bwd = fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches
    _, second = grads(preset=res)
    assert (fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches) == (fwd, bwd + 1)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("S,D,bq,bk,prefix", [(512, 128, 128, 256, 200), (256, 64, 64, 64, 0),
                                              (1024, 128, 256, 1024, 500), (320, 64, 64, 64, 100),
                                              (576, 128, 64, 192, 0)])
def test_flash_probe_kernel_matches_plain(cuda, S, D, bq, bk, prefix):
    """K6: the matmul-only probe against its plain version, GQA group 4, at plans whose
    128-tiles are all skip or full, and at 64- and 192-wide blocks that make partial tiles
    (S 320 and 576 also end in half a tile)."""
    from llama_x_tpu_torch.ops import flash_probe as fp

    B, Hq, Hkv = 2, 8, 2
    g = torch.Generator(device=cuda).manual_seed(S + bq)
    q, k, v = ((torch.randn(B, S, h, D, device=cuda, generator=g) * 0.3).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    before = fp.flash_probe.launches
    out = fp.flash_probe(q, k, v, bq, bk, prefix)
    torch.cuda.synchronize()
    assert fp.flash_probe.launches == before + 1
    ref = fp.flash_probe_plain(q, k, v, bq, bk, prefix)
    atol, rtol = fp.probe_tolerance(ref)
    excess = float(((out.float() - ref.float()).abs() - rtol * ref.float().abs()).max())
    assert excess <= atol, f"|err| - {rtol}|ref| reaches {excess} > {atol}"
    with pytest.raises(ValueError):
        fp.flash_probe(q, k, v, 32, bk, prefix)  # bq below the kernel's tile
    with pytest.raises(ValueError):
        fp.flash_probe(q, k, v, bq, S // 2 + 64, prefix)  # bk does not divide S


@pytest.mark.parametrize("policy", ["flash_q8s", "flash_proj", "attn_q8", "attn_q8s"])
def test_audio_train_entry_point_runs_on_the_card(cuda, tmp_path, monkeypatch, policy):
    """``train_librispeech.main`` itself on a small QLoRA model with a stem: 2 s of audio
    (100 audio tokens) before 64 text tokens, prefix-LM, a saving remat policy; K1, K2, K4
    and K5 launch, and the flash forward runs once per layer and microbatch (no recompute)."""
    import json

    from llama_x_tpu_torch import train_librispeech as entry

    monkeypatch.chdir(tmp_path)
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    before = [c.launches for c in counters]
    entry.main([
        "--synthetic", "8", "--quantize", "int8", "--quantize_kwargs",
        '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
        "--freeze_prefixes", "tok_embeddings", "output", "norm", "audio_embed", "--activation_checkpointing",
        "--remat_policy", policy, "--fused_ce_chunks", "2", "--prefix_lm", "--audio_duration", "2",
        "--seq_len_multiple", "64", "--batch_size", "2", "--gradient_accumulation", "2", "--n_steps", "2",
        "--log_interval", "1", "--ckpt_interval", "0",
        "--synthetic_config", '{"num_layers": 2, "embed_dim": 256, "head_dim": 64, "num_heads": 4, "num_kv_heads": 2}',
    ])
    after = [c.launches for c in counters]
    assert all(a > b for a, b in zip(after, before))
    assert after[2] - before[2] == after[3] - before[3] == 2 * 2 * 2  # layers x microbatches x steps
    (run,) = (tmp_path / "runs" / "librispeech").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in recs)


def test_probe_entry_point_runs_on_the_card(cuda):
    from llama_x_tpu_torch import probe_flash as entry
    from llama_x_tpu_torch.ops import flash_probe as fp

    before = (fp.flash_probe.launches, fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches)
    res = entry.main(["--seq_len", "512", "--prefix", "200", "--bq", "128", "--bk", "256", "--reps", "2"])
    after = (fp.flash_probe.launches, fa.flash_fwd_with_lse.launches, fa.flash_bwd_from_res.launches)
    assert all(a > b for a, b in zip(after, before))
    assert res["clock"] == "cuda events" and all(res[k] > 0 for k in ("fwd_ms", "fwdbwd_ms", "probe_matmul_only_ms"))
    sweep = entry.main(["--seq_len", "2048", "--prefix", "1000", "--reps", "1", "--sweep"])
    assert len([k for k in sweep if k.startswith("bq")]) == len(entry.SWEEP)


SMALL_QLORA = [
    "--quantize", "int8", "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--activation_checkpointing", "--fused_ce_chunks", "2", "--prefix_lm", "--n_steps", "2",
    "--log_interval", "1", "--ckpt_interval", "0",
    "--synthetic_config", '{"num_layers": 2, "embed_dim": 256, "head_dim": 64, "num_heads": 4, "num_kv_heads": 2}',
]


@pytest.mark.parametrize("entry_name", ["train_vision", "train_omni"])
def test_vision_and_omni_train_entry_points_run_on_the_card(cuda, tmp_path, monkeypatch, entry_name):
    """``train_vision.main`` / ``train_omni.main`` on a small QLoRA model: the image (and
    audio) prefix under prefix-LM through K1, K2, K4 and K5, one flash forward and one
    backward per layer and microbatch (``flash_proj`` keeps the flash output)."""
    import importlib
    import json

    entry = importlib.import_module(f"llama_x_tpu_torch.{entry_name}")
    monkeypatch.chdir(tmp_path)
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    before = [c.launches for c in counters]
    extra = (["--synthetic", "16", "--batch_size", "4"] if entry_name == "train_vision" else
             ["--synthetic", "8", "--audio_duration", "1", "--seq_len_multiple", "64", "--batch_size", "2"])
    entry.main([*extra, "--image_size", "32", "--patch_size", "8", "--remat_policy", "flash_proj", *SMALL_QLORA])
    after = [c.launches for c in counters]
    assert all(a > b for a, b in zip(after, before))
    assert after[2] - before[2] == after[3] - before[3] == 2 * 2  # layers x steps (one microbatch a step)
    (run,) = (tmp_path / "runs" / entry_name.split("_")[1]).iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and all(math.isfinite(r["loss"]) for r in recs)


TRAINER_FLAGS = {  # each trainer's small QLoRA run: (task directory, its own flags)
    "train_metamathqa": ("metamathqa", ["--synthetic", "16", "--document_mask", "--max_seq_len", "256",
                                        "--batch_size", "2"]),
    "train_librispeech": ("librispeech", ["--synthetic", "8", "--audio_duration", "2", "--seq_len_multiple", "64",
                                          "--batch_size", "2", "--prefix_lm"]),
    "train_vision": ("vision", ["--synthetic", "16", "--batch_size", "4", "--image_size", "32", "--patch_size", "8",
                                "--prefix_lm"]),
    "train_omni": ("omni", ["--synthetic", "8", "--audio_duration", "1", "--seq_len_multiple", "64", "--batch_size",
                            "2", "--image_size", "32", "--patch_size", "8", "--prefix_lm"]),
}


@pytest.mark.parametrize("entry_name", list(TRAINER_FLAGS))
def test_every_trainer_takes_attn_q8s_on_the_card(cuda, tmp_path, monkeypatch, entry_name):
    """Each trainer's ``main`` under ``--remat_policy attn_q8s`` on a small QLoRA model: K1, K2,
    K4 and K5 launch, one flash forward and one backward per layer and step, finite losses."""
    import importlib
    import json

    entry = importlib.import_module(f"llama_x_tpu_torch.{entry_name}")
    task, extra = TRAINER_FLAGS[entry_name]
    monkeypatch.chdir(tmp_path)
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    before = [c.launches for c in counters]
    entry.main([*extra, "--remat_policy", "attn_q8s", *[f for f in SMALL_QLORA if f != "--prefix_lm"]])
    after = [c.launches for c in counters]
    assert all(a > b for a, b in zip(after, before))
    assert after[2] - before[2] == after[3] - before[3] == 2 * 2  # layers x steps (one microbatch a step)
    (run,) = (tmp_path / "runs" / task).iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and all(math.isfinite(r["loss"]) for r in recs)


def test_eval_entry_points_decode_through_the_kernels(cuda):
    """``eval_vision`` and ``eval_librispeech`` with ``--synthetic``: the prefill with the
    modality prefix through K2, every new token through K3."""
    from llama_x_tpu_torch import eval_librispeech, eval_vision

    before = (fa.flash_fwd_with_lse.launches, da.decode_attention.launches)
    vis = eval_vision.main(["--synthetic", "4", "--image_size", "32", "--patch_size", "8", "--max_new_tokens", "8",
                            "--prefix_lm", "--eval_batch_size", "2"])
    ls = eval_librispeech.main(["--synthetic", "2", "--max_new_tokens", "8", "--prefix_lm"])
    after = (fa.flash_fwd_with_lse.launches, da.decode_attention.launches)
    assert after[0] > before[0] and after[1] - before[1] >= 7 * 4  # 7 decode steps x 4 layers, first batch
    assert vis["n_samples"] == 4 and ls["n_utts"] == 2


@pytest.mark.parametrize("B,S,prefix", [(8, 304, 272), (1, 4096, 1772), (2, 200, 130)])
def test_flash_kernels_at_the_vision_and_omni_prefixes(cuda, B, S, prefix):
    """K2 (out, lse) and K5 (dq, dk, dv) at prefix lengths that are no tile multiple:
    the vision step's 272 of 304 (ragged last q and kv tiles), the omni step's 1772."""
    g = torch.Generator(device=cuda).manual_seed(S + prefix)
    mk = lambda h: torch.randn(B, S, h, 128, device=cuda, generator=g).to(torch.bfloat16)  # noqa: E731
    q, k, v, do = mk(32), mk(8), mk(8), mk(32)
    mi = MaskInfo(causal=True, prefix_len=torch.full((B,), prefix, dtype=torch.int32, device=cuda))
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi)
    atol, rtol = fa.flash_fwd_tolerance(ref)
    assert bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())
    assert _max_err(lse, ref_lse) <= 2e-3
    got = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi)
    want = fa.flash_bwd_plain(q, k, v, out, lse, do, mi)
    for a, b in zip(got, want):
        atol, rtol = fa.flash_bwd_tolerance(b)
        assert bool(((a.float() - b.float()).abs() <= atol + rtol * b.float().abs()).all())


@pytest.mark.parametrize("S,prefix", [(107, 75), (112, 72), (162, 122)])
def test_flash_kernels_at_the_learned_task_shapes(cuda, S, prefix):
    """K2 and K5 at the learned tasks' training shapes on the card (B 16, 4 / 2 heads of 64,
    prefix-LM): wer_synthetic's 75 audio + 32 text positions, vision_synthetic's 72 image +
    40 text, omni_synthetic's 50 audio + 72 image + 40 text (two kv tiles, the prefix ending
    inside the first)."""
    B = 16
    g = torch.Generator(device=cuda).manual_seed(S)
    mk = lambda h: torch.randn(B, S, h, 64, device=cuda, generator=g).to(torch.bfloat16)  # noqa: E731
    q, k, v, do = mk(4), mk(2), mk(2), mk(4)
    mi = MaskInfo(causal=True, prefix_len=torch.full((B,), prefix, dtype=torch.int32, device=cuda))
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi)
    _assert_k2_close(out, ref)
    assert _max_err(lse, ref_lse) <= 2e-3
    got = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi)
    want = fa.flash_bwd_plain(q, k, v, out, lse, do, mi)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _assert_k5_close(f"S={S} prefix={prefix} {name}", a, b)


RING_MASKS = ["causal", "doc", "prefix", "prefix past the shard", "noncausal"]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mask", RING_MASKS)
def test_flash_ring_forms_match_plain(cuda, D, mask):
    """K2's ring form and K5's offsets form at the four blocks of a ring of 2 (S_local 256,
    32/8 heads): out (on the rows that see a key of the block) and lse within K2's
    tolerance, dq / dk / dv (f32, added into zeroed accumulators) within K5's."""
    S, Hq, Hkv = 256, 32, 8
    g = torch.Generator(device=cuda).manual_seed(D)
    mk = lambda *shape: torch.randn(*shape, device=cuda, generator=g).to(torch.bfloat16)
    q, k, v, do = mk(1, S, Hq, D), mk(1, S, Hkv, D), mk(1, S, Hkv, D), mk(1, S, Hq, D)
    segs = torch.sort(torch.randint(1, 5, (1, 2 * S), device=cuda, generator=g), dim=1).values.to(torch.int32)
    prefix = {"prefix": S // 2, "prefix past the shard": S + 37}.get(mask)
    before = (fa.flash_fwd_ring.launches, fa.flash_bwd_ring.launches)
    for qo, ko in [(0, 0), (S, 0), (S, S), (0, S)]:
        mi = MaskInfo(causal=mask != "noncausal", segment_ids=segs[:, qo:qo + S] if mask == "doc" else None,
                      kv_segment_ids=segs[:, ko:ko + S] if mask == "doc" else None,
                      prefix_len=None if prefix is None else torch.tensor([prefix], dtype=torch.int32, device=cuda))
        out, lse = fa.flash_fwd_ring(q, k, v, mi, qo, ko)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_fwd_ring_plain(q, k, v, mi, qo, ko)
        m = fa.ring_block_mask(mi, 1, S, qo, ko, device=cuda)
        seen = torch.ones(1, S, dtype=torch.bool, device=cuda) if m is None else m[:, 0].any(-1)
        atol, rtol = fa.flash_fwd_tolerance(ref)
        assert bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs())[seen].all()), (qo, ko)
        ls = seen[:, None, :, None].expand_as(lse)
        if bool(ls.any()):
            assert _max_err(lse[ls], ref_lse[ls]) <= 2e-3
        assert bool((lse[~ls] < -1e29).all())
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=cuda) for t in (q, k, v)]
        fa.flash_bwd_ring(q, k, v, out, lse, do, delta, acc, mi, qo, ko)
        torch.cuda.synchronize()
        for got, want in zip(acc, fa.flash_bwd_ring_plain(q, k, v, out, lse, do, delta, mi, qo, ko)):
            atol, rtol = fa.flash_bwd_tolerance(want)
            assert bool(((got - want).abs() <= atol + rtol * want.abs()).all()), (qo, ko)
    assert (fa.flash_fwd_ring.launches, fa.flash_bwd_ring.launches) == (before[0] + 4, before[1] + 4)


def test_ring_on_the_card_runs_the_kernels_or_raises(cuda, monkeypatch):
    """One rank's ring is the flash attention of its block; the plain ring is refused on
    CUDA tensors, and a kernel library that cannot be built raises (no fallback)."""
    from llama_x_tpu_torch.ops.ring_attention import ring_attention
    from llama_x_tpu_torch.parallel.mesh import make_mesh
    from llama_x_tpu_torch.utils import build

    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 256, h, 128, device=cuda, generator=g).to(torch.bfloat16) for h in (32, 8, 8))
    mesh = make_mesh()
    mi = MaskInfo(causal=True)
    got = ring_attention(q, k, v, mesh, mi)
    want, _ = fa.flash_fwd_plain(q, k, v, mi)
    atol, rtol = fa.flash_fwd_tolerance(want)
    assert bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())
    with pytest.raises(ValueError, match="CPU tensors"):
        ring_attention(q, k, v, mesh, mi, impl="xla")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        ring_attention(q, k, v, mesh, mi)


# the tensor-parallel shard shapes at Llama-3.1-8B width (D 4096, 32 / 8 heads of 128, F 14336,
# V 128256): each rank's projections at tp 2, and the vocabulary-parallel head at tp 2 and 4
# (V / 4 = 32064 rows, not a multiple of 128)
TP_K1_SHAPES = [(4096, 2048, 4096), (4096, 512, 4096), (4096, 4096, 2048), (4096, 7168, 4096), (4096, 4096, 7168),
                (512, 64128, 4096), (512, 32064, 4096)]
TP_K4_SHAPES = [(4096, 4096, 2048), (4096, 4096, 512), (4096, 4096, 7168), (4096, 2048, 4096), (4096, 7168, 4096),
                (512, 4096, 64128), (512, 4096, 32064)]


@pytest.mark.parametrize("M,N,K", TP_K1_SHAPES)
def test_int8_mm_at_tp_shard_shapes(cuda, M, N, K):
    """K1 at each tp rank's shapes (column-parallel N / tp, row-parallel K / tp, the head's
    vocabulary shard): bit for bit against its plain version under the plan it picks."""
    g = torch.Generator(device=cuda).manual_seed(N + K)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=cuda, generator=g)
    rs, cs = torch.rand(M, device=cuda, generator=g), torch.rand(N, device=cuda, generator=g)
    out_dtype = torch.float32 if N > 16384 else torch.bfloat16
    got = mm.int8_mm_dequant_nt(a, b, rs, cs, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.int8_mm_dequant_nt_plain(a, b, rs, cs, out_dtype=out_dtype)), mm.int8_mm_plan(M, N, K)


@pytest.mark.parametrize("M,N,K", TP_K4_SHAPES)
def test_int8_mm_kn_at_tp_shard_shapes(cuda, M, N, K):
    """K4 at each tp rank's input gradients (column-parallel K = out / tp, row-parallel
    N = in / tp) and the CE dH over the vocabulary shard: bit for bit against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(N + K + 1)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=cuda, generator=g)
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=cuda, generator=g)
    rs, cs = torch.rand(M, device=cuda, generator=g), torch.rand(N, device=cuda, generator=g)
    out_dtype = torch.float32 if K > 16384 else torch.bfloat16
    got = mm.int8_mm_dequant(a, b, rs, cs, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.int8_mm_dequant_plain(a, b, rs, cs, out_dtype)), mm.int8_mm_kn_plan(M, N, K)


def _attn_q8_model(policy: str, layers: int = 2, chunks: int = 2):
    """A QLoRA text model of width 256 with heads of 64 in bf16 (int8 base, dynamic int8
    activations and input gradients, int8 head, fused CE) under ``policy``, and one microbatch
    of packed rows; lora_b drawn live so that every adapter gradient is."""
    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli

    args = entry.parse_args([
        "--synthetic", "16", "--synthetic_task", "count", "--quantize", "int8", "--quantize_kwargs",
        '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
        "--freeze_prefixes", "tok_embeddings", "output", "norm", "--activation_checkpointing",
        "--remat_policy", policy, "--fused_ce_chunks", str(chunks), "--document_mask", "--max_seq_len", "512",
        "--batch_size", "2", "--synthetic_config",
        f'{{"num_layers": {layers}, "embed_dim": 256, "head_dim": 64, "num_heads": 4, "num_kv_heads": 2}}',
    ])
    model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
    g = torch.Generator(device=model.device).manual_seed(3)
    for blk in model.layers:
        for lin in (*blk.attention.children(), *blk.feed_forward.children()):
            lin.lora_b.data.copy_(torch.randn(lin.lora_b.shape, generator=g, device=model.device) * 0.05)
    data_iter, _ = entry.make_data(args, model.config.vocab_size)
    mb = {k: torch.as_tensor(v).cuda() for k, v in next(data_iter).items()}
    return model, mb, entry.loss_fn


@pytest.mark.parametrize("policy", ["attn_q8", "attn_q8s"])
def test_attn_q8_launches_of_one_microbatch(cuda, policy):
    """One microbatch's forward + backward under attn_q8 / attn_q8s at L layers and C CE
    chunks: K1 7 L + 2 C (attn_q8s: 8 L, one w3 GEMM again), K4 7 L + C, K2 and K5 once a
    layer: no GEMM of the attention runs again in its backward."""
    model, mb, loss_fn = _attn_q8_model(policy, layers=3, chunks=2)
    L, C = 3, 2
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    before = [c.launches for c in counters]
    params = [p for p in model.parameters() if p.requires_grad]
    torch.autograd.grad(loss_fn(model, mb)[0], params)
    torch.cuda.synchronize()
    got = [c.launches - b for c, b in zip(counters, before)]
    assert got == [(7 + (policy == "attn_q8s")) * L + 2 * C, 7 * L + C, L, L]


def test_attn_q8s_kernel_path_matches_plain_on_a_two_layer_cut(cuda, monkeypatch):
    """Loss and adapter gradients of one microbatch under attn_q8s through K1 / K4 / K2 / K5
    and through their plain versions, at chip_smoke.py's compare_grad_paths tolerances: the
    loss within 2^-10 of its size, each adapter gradient within 2^-6 of its norm (relative
    L2)."""
    model, mb, loss_fn = _attn_q8_model("attn_q8s")
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad and "lora_" in n]

    def run():
        loss = loss_fn(model, mb)[0]
        return float(loss.detach()), torch.autograd.grad(loss, [p for _, p in named])

    loss_k, grads_k = run()
    for mod, name, fn in [(mm, "int8_mm_dequant_nt", mm.int8_mm_dequant_nt_plain),
                          (mm, "int8_mm_dequant", mm.int8_mm_dequant_plain),
                          (fa, "_forward_impl", fa.flash_fwd_plain), (fa, "flash_bwd_from_res", fa.flash_bwd_plain)]:
        monkeypatch.setattr(mod, name, fn)
    loss_p, grads_p = run()
    assert math.isfinite(loss_k) and abs(loss_k - loss_p) <= 2**-10 * abs(loss_p)
    for (name, _), a, b in zip(named, grads_k, grads_p):
        rel = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
        assert rel <= 2**-6, (name, rel)


@pytest.mark.parametrize("tool", ["wer_synthetic", "vision_synthetic", "omni_synthetic", "int8_bwd_quality",
                                  "int8_head_quality"])
def test_learned_task_entry_points_run_on_the_card(cuda, tmp_path, tool):
    """Each learned-task entry point at a few steps through its own ``main``: heads of 64 in
    bf16, the loss falls, its artifact names the card, and the kernels of its path launch
    (K2 / K5 to train, K3 to decode; K1 / K4 for the QLoRA quality studies)."""
    import importlib

    from llama_x_tpu_torch.ops import decode_attention as da

    entry = importlib.import_module(f"llama_x_tpu_torch.{tool}")
    counters = {"K1": mm.int8_mm_dequant_nt, "K4": mm.int8_mm_dequant, "K2": fa.flash_fwd_with_lse,
                "K5": fa.flash_bwd_from_res, "K3": da.decode_attention}
    before = {k: c.launches for k, c in counters.items()}
    if tool.startswith("int8"):
        art = entry.main(["--steps", "12", "--out", str(tmp_path / "quality.json")])
        curve = art[next(k for k in art if k.startswith("curve_"))]
        assert curve[-1] < curve[0]
        need = ("K1", "K4", "K2", "K5")
    else:
        flag = "--eval_utts" if tool == "wer_synthetic" else "--eval_samples"
        art = entry.main(["--steps", "12", flag, "2", "--out_dir", str(tmp_path)])
        assert art["final_loss"] < art["losses_every_50"][0]
        need = ("K2", "K5", "K3")
    assert art["model"]["head_dim"] == 64 and art["device"] == torch.cuda.get_device_name(0)
    assert all(counters[k].launches > before[k] for k in need), {k: counters[k].launches - before[k] for k in need}


# ---------------------------------------------------------------------------
# the decode step as one captured CUDA graph (models/decode_graph.py), at 8B width cut to 2 layers
# ---------------------------------------------------------------------------


def _graph_model(dev, quant: bool):
    """Llama-3.1-8B width, 2 layers, random weights from seed 0 as ``generate_cli`` builds
    them: bf16, or int8 weights with dynamic int8 activations."""
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model

    cfg = llama.LlamaConfig(**dict(GEOMETRIES["8b"], num_layers=2), max_seq_len=1024, dynamic_int8_act=quant)
    return build_model(cfg, quant, seed=0, device=dev)


def _graph_prompt(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    return torch.randint(0, 256, (4, 96), device=dev, generator=g), torch.tensor([96, 70, 33, 5], device=dev)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_decode_graph_matches_the_eager_loop(cuda, kind):
    """``generate`` through the captured step against the eager loop (bf16 weights and
    cache; int8 weights, dynamic int8 act and the int8 cache): greedy tokens equal and
    launches equal, on the capturing call and on the next (replays only); each replay
    credits one K3 a layer (and seven K1 with int8), the kernels a device trace of three
    replays shows; a replay allocates nothing (the kernels' partials live in the graph's
    pool)."""
    from torch.profiler import ProfilerActivity, profile

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models.generate import generate
    from llama_x_tpu_torch.ops import launches

    quant = kind == "int8"
    model = _graph_model(cuda, quant)
    prompt, lens = _graph_prompt(cuda)
    cache_dtype = torch.int8 if quant else torch.bfloat16
    k3 = da.decode_attention_int8 if quant else da.decode_attention
    counters = (mm.int8_mm_dequant_nt, fa.flash_fwd_with_lse, k3)

    def run(eager):
        before = [c.launches for c in counters]
        out = generate(model, prompt, max_new_tokens=24, prompt_lens=lens, cache_dtype=cache_dtype, eager=eager)
        torch.cuda.synchronize()
        return out, [c.launches - b for c, b in zip(counters, before)]

    want, eager_launches = run(True)
    for _ in range(2):  # capture, then replays only
        got, graph_launches = run(False)
        assert torch.equal(got, want)
        assert graph_launches == eager_launches
    s = dg.stats(model)
    assert s["captures"] == 1 and s["replays"] == 22 + 23 and s["pool_bytes"][0] > 0
    (entry,) = dg.runner_of(model).graphs.values()
    credits = {fn.__name__: k for fn, k in entry.captured.credits.items()}
    # int8: K7 quantizes 7 projections' inputs and the 2 new KV rows a layer
    assert credits == ({"decode_attention_int8": 2, "int8_mm_dequant_nt": 14, "quantize_rows": 18} if quant
                       else {"decode_attention": 2})
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    entry.captured.replay(3)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated
    # the credits are what the device ran: the replays' kernels in a trace. A trace can lose a
    # run of records but never shows a kernel that did not run: a short one is taken again.
    for _ in range(3):
        before = {name: fn.launches for name, fn in launches.COUNTED.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            entry.captured.replay(3)
            torch.cuda.synchronize()
        counts = {name: fn.launches - before[name] for name, fn in launches.COUNTED.items()}
        kernels = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        traced = launches.traced_counts(kernels)
        assert all(traced[g] <= sum(counts[n] for n in g.split(" + ")) for g in traced)
        if all(traced[g] == sum(counts[n] for n in g.split(" + ")) for g in traced):
            break
    launches.check_trace(kernels, counts, "3 replays")
    assert traced["decode_attention_int8" if quant else "decode_attention"] == 3 * 2
    assert traced["int8_mm_dequant_nt"] == (3 * 14 if quant else 0)


def test_decode_graph_sampled_tokens_equal_the_eager_loop(cuda):
    """Sampled decoding (temperature, top-k, top-p) on one generator seed: the graph's
    replays draw the eager loop's bits, and leave the caller's generator where the eager
    loop leaves it."""
    from llama_x_tpu_torch.models.generate import generate

    model = _graph_model(cuda, False)
    prompt, lens = _graph_prompt(cuda)
    kw = dict(max_new_tokens=20, prompt_lens=lens, temperature=0.8, top_k=50, top_p=0.9)
    gens, outs = [], []
    for eager in (True, False, False):
        gens.append(torch.Generator(device=cuda).manual_seed(11))
        outs.append(generate(model, prompt, generator=gens[-1], eager=eager, **kw))
    torch.cuda.synchronize()
    assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])
    assert all(torch.equal(g.get_state(), gens[0].get_state()) for g in gens[1:])


def test_continuous_scheduler_with_graphs_matches_eager(cuda):
    """The int8 model with the int8 cache through ``ContinuousScheduler`` (4 slots, 8-step
    chunks, chunked prefill of 64): six rows that join and leave; each row's greedy tokens
    through the captured step equal the eager loop's."""
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    model = _graph_model(cuda, True)
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist() for n in (20, 150, 64, 7, 90, 200)]
    rows = {}
    for eager in (True, False):
        sched = ContinuousScheduler(model, n_slots=4, chunk_size=8, cache_dtype=torch.int8, prefill_chunk=64,
                                    eager=eager)
        try:
            handles = [sched.submit(p, max_tokens=12 + 5 * i) for i, p in enumerate(prompts)]
            for h in handles:
                assert h.event.wait(600) and h.error is None, h.error
        finally:
            sched.close()
        rows[eager] = [h.tokens for h in handles]
    assert rows[False] == rows[True]
    assert dg.stats(model)["captures"] == 1


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_prefill_graph_matches_the_eager_prefill(cuda, kind, sampled):
    """``prefill_start`` through the captured prefill (the first call captures the key, the
    next two replay it) against ``eager=True`` on the 2-layer cut (bf16 weights and cache;
    int8 weights, dynamic int8 act and the int8 cache), 4 ragged rows of 96: the first token
    and every cache tensor over [0, P) of each row bit for bit, greedy and at temperature 0.8
    with top-k 50 on one generator seed (the caller's generator left where the eager prefill
    leaves it); the launches of each request equal; one capture; each replay credits one K2
    a layer (and seven K1 with int8), the kernels a device trace of three replays shows; a
    replay allocates nothing."""
    from torch.profiler import ProfilerActivity, profile

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models.generate import prefill_start
    from llama_x_tpu_torch.ops import launches

    quant = kind == "int8"
    model = _graph_model(cuda, quant)
    prompt, lens = _graph_prompt(cuda)
    P = prompt.shape[1]
    cache_dtype = torch.int8 if quant else torch.bfloat16
    counters = (mm.int8_mm_dequant_nt, fa.flash_fwd_with_lse)
    sample = dict(temperature=0.8, top_k=50) if sampled else {}

    def run(eager):
        gen = torch.Generator(device=cuda).manual_seed(11)
        before = [c.launches for c in counters]
        first, state = prefill_start(model, prompt, prompt_lens=lens, cache_dtype=cache_dtype, max_new_tokens=16,
                                     generator=gen, eager=eager, **sample)
        torch.cuda.synchronize()
        cache = [t[:, :, :, :P].clone() for t in dg.cache_tensors(state.cache)]
        return first, cache, gen.get_state(), [c.launches - b for c, b in zip(counters, before)]

    want = run(True)
    for _ in range(3):
        first, cache, gstate, counts = run(False)
        assert torch.equal(first, want[0]) and torch.equal(gstate, want[2]) and counts == want[3]
        assert all(torch.equal(a, b) for a, b in zip(cache, want[1]))
    s = dg.prefill_stats(model)
    assert (s["captures"], s["replays"], s["graphs"]) == (1, 2, 1) and s["pool_bytes"][0] > 0
    assert dg.stats(model)["captures"] == 0  # the decode steps' runner is apart
    (entry,) = dg.prefill_runner_of(model).graphs.values()
    credits = {fn.__name__: k for fn, k in entry.captured.credits.items()}
    assert credits == ({"flash_fwd_with_lse": 2, "int8_mm_dequant_nt": 14, "quantize_rows": 18} if quant
                       else {"flash_fwd_with_lse": 2})
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    entry.captured.replay(3)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated
    for _ in range(3):  # a trace that lost records is taken again (never one that shows too many)
        before = {name: fn.launches for name, fn in launches.COUNTED.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            entry.captured.replay(3)
            torch.cuda.synchronize()
        counts = {name: fn.launches - before[name] for name, fn in launches.COUNTED.items()}
        kernels = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        traced = launches.traced_counts(kernels)
        assert all(traced[g] <= sum(counts[n] for n in g.split(" + ")) for g in traced)
        if all(traced[g] == sum(counts[n] for n in g.split(" + ")) for g in traced):
            break
    launches.check_trace(kernels, counts, "3 prefill replays")
    assert traced["flash_attention + flash_attention_ring"] == 3 * 2
    assert traced["int8_mm_dequant_nt"] == (3 * 14 if quant else 0)


TRAIN_CUT_FLAGS = [
    "--synthetic", "64", "--synthetic_task", "count", "--geometry", "8b", "--synthetic_config", '{"num_layers": 2}',
    "--quantize", "int8", "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--adapter_kwargs", '{"rank": 8}', "--freeze_prefixes", "tok_embeddings", "output", "norm",
    "--activation_checkpointing", "--fused_ce_chunks", "8", "--document_mask", "--max_seq_len", "2048",
    "--batch_size", "2", "--gradient_accumulation", "2", "--lr", "1e-3", "--warmup", "0.25", "--n_steps", "4",
    "--clip_grad_norm", "1.0", "--seed", "0",
]


def test_train_step_graph_matches_the_eager_step(cuda):
    """The text QLoRA step at Llama-3.1-8B width cut to 2 layers (int8 base, LoRA r 8, int8
    act / dgrad / head, fused CE x8, remat full, accumulation 2, warmup and clipping): 4 steps
    through the captured graphs against 4 eager steps from the same weights on the same
    batches, bit for bit in loss, grad norm, label count and every adapter; the launches of
    each step equal; each replay of the microbatch graph credits the backward's K4 and K5,
    which the autograd engine's thread launched onto the capturing stream; a replay allocates
    nothing."""
    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli, step_graph
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    args = entry.parse_args(TRAIN_CUT_FLAGS)
    states = []
    for _ in range(2):
        model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
        states.append(TrainState(model, cli.setup_optimizer(args, model)[0]))
    data_iter, _ = entry.make_data(args, states[0].model.config.vocab_size)
    batches = [cli.assemble_step_batch([next(data_iter) for _ in range(2)], pad_values={"labels": -100})
               for _ in range(4)]
    counters = (mm.int8_mm_dequant_nt, mm.int8_mm_dequant, fa.flash_fwd_with_lse, fa.flash_bwd_from_res)
    steps = (make_train_step(entry.loss_fn), make_train_step(entry.loss_fn, eager=True))
    for i, batch in enumerate(batches):
        got = []
        for state, step in zip(states, steps):
            before = [c.launches for c in counters]
            m = step(state, batch)
            torch.cuda.synchronize()
            got.append((m, [c.launches - b for c, b in zip(counters, before)]))
        (mg, lg), (me, le) = got
        for k in me:
            assert torch.equal(mg[k], me[k]), (i, k, float(mg[k]), float(me[k]))
        assert lg == le and all(lg), (i, lg, le)
    for (n, a), (_, b) in zip(states[0].trainable, states[1].trainable):
        assert torch.equal(a, b), n
    s = step_graph.stats(states[0])
    assert (s["captures"], s["replays"], s["graphs"]) == (1, 3, 2) and s["pool_bytes"][0] > 0
    (entry_,) = step_graph.runner_of(states[0]).entries.values()
    credits = {fn.__name__: k for fn, k in entry_.micro.credits.items()}
    # a microbatch under remat full: K1 7 L + 7 L + 2 C, K4 7 L + C, K2 2 L, K5 L; K7 before
    # every K1 and K4 (21 L + 3 C) and the frozen head's two quantizations
    L, C = 2, 8
    assert credits == {"int8_mm_dequant_nt": 14 * L + 2 * C, "int8_mm_dequant": 7 * L + C,
                       "flash_fwd_with_lse": 2 * L, "flash_bwd_from_res": L,
                       "quantize_rows": 21 * L + 3 * C + 2}, credits
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    entry_.micro.replay(1)
    entry_.update.replay(1)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated


# ---------------------------------------------------------------------------
# speculative decoding's rounds as captured CUDA graphs, at 8B width cut to 2 layers
# ---------------------------------------------------------------------------


def _spec_draft(dev):
    """A 2-layer draft of width 1024 with heads of 128 and the 8B vocabulary, bf16, seed 7."""
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model

    cfg = llama.LlamaConfig(**dict(GEOMETRIES["8b"], num_layers=2, embed_dim=1024, num_heads=8, num_kv_heads=8,
                                   intermediate_dim=2816), max_seq_len=1024)
    return build_model(cfg, False, seed=7, device=dev)


SPEC_CASES = [(4, "bf16"), (8, "bf16"), (8, "int8")]


@pytest.mark.parametrize("gamma,cache", SPEC_CASES)
def test_generate_speculative_graph_matches_the_eager_rounds(cuda, gamma, cache):
    """``generate_speculative`` on the int8 2-layer model (dynamic int8 act) with the bf16
    draft: greedy over 4 ragged rows, through the captured round (two requests: the first
    captures, the second replays only) against ``eager=True``: tokens, target passes and
    launches equal; every round one replay; the verify on K3 at gamma 4 and on K2's offsets
    form at gamma 8 (over the int8 cache through the static kv bound). At gamma 4 also a
    sampled request on one generator seed, bit for bit."""
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models.speculative import generate_speculative

    model, draft = _graph_model(cuda, True), _spec_draft(cuda)
    prompt, lens = _graph_prompt(cuda)
    counters = (mm.int8_mm_dequant_nt, fa.flash_fwd_offsets, da.decode_attention, da.decode_attention_int8)

    def run(eager, **kw):
        before = [c.launches for c in counters]
        out, stats = generate_speculative(model, draft, prompt, max_new_tokens=40, gamma=gamma, prompt_lens=lens,
                                          cache_dtype=torch.int8 if cache == "int8" else torch.bfloat16, eager=eager,
                                          **kw)
        torch.cuda.synchronize()
        return out, stats, [c.launches - b for c, b in zip(counters, before)]

    want, wstats, wl = run(True)
    for i in range(2):
        got, stats, gl = run(False)
        assert torch.equal(got, want) and stats["target_passes"] == wstats["target_passes"] and gl == wl
        s = dg.stats(model)
        assert s["captures"] == 1 and s["replays"] == (i + 1) * (stats["target_passes"] - 1) - 1
    assert wl[0] > 0 and (wl[1] > 0) == (gamma >= 8) and wl[3 if cache == "int8" else 2] > 0
    if gamma == 4:
        sample = dict(temperature=0.8, top_k=50, top_p=0.9)
        outs = [run(eager, generator=torch.Generator(device=cuda).manual_seed(3), **sample)[0]
                for eager in (True, False, False)]
        assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0])


@pytest.mark.parametrize("gamma,cache", SPEC_CASES)
def test_speculative_scheduler_graph_matches_the_eager_rounds(cuda, gamma, cache):
    """``SpeculativeScheduler`` (4 slots, 4-round chunks) on the same models: six greedy
    rows that join and leave; each row's tokens through the captured round equal the eager
    rounds'; every round a replay (the int8 cache's kv bound may add a capture a bucket)."""
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.speculative import SpeculativeScheduler

    model, draft = _graph_model(cuda, True), _spec_draft(cuda)
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 256, (n,), generator=g).tolist() for n in (20, 150, 64, 7, 90, 600)]
    rows, rounds = {}, 0
    for eager in (True, False):
        sched = SpeculativeScheduler(model, draft, gamma=gamma, n_slots=4, chunk_size=4,
                                     cache_dtype=torch.int8 if cache == "int8" else torch.bfloat16, eager=eager)
        try:
            handles = [sched.submit(p, max_tokens=12 + 5 * i) for i, p in enumerate(prompts)]
            for h in handles:
                assert h.event.wait(600) and h.error is None, h.error
        finally:
            sched.close()
        rows[eager] = [h.tokens for h in handles]
        rounds = sched.rounds_run
    assert rows[False] == rows[True]
    s = dg.stats(model)
    assert s["captures"] >= 1 and s["replays"] + s["captures"] == rounds


# ---------------------------------------------------------------------------
# the schedulers' admission programs as captured CUDA graphs (serve/continuous.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_admission_graphs_match_the_eager_admissions(cuda, cache):
    """Every admission program on the int8 2-layer model of 8B width with the 2-layer draft
    (``chip_smoke.check_admissions``): ``admit_row`` at 3 buckets, ``admit_row_prefix`` at 2
    (Sb, extent) keys, a chunked prefill (first and continuation chunks) with its install, and
    ``spec_admit_row``, through their graphs (a capture a key, then replays only) against
    ``eager=True``: first tokens and every state tensor bit for bit, a pass of replays
    launching what the eager pass launches (K1 and K2 in both forms), held to the device
    trace."""
    import chip_smoke

    res = chip_smoke.check_admissions(_graph_model(cuda, True), _spec_draft(cuda),
                                      torch.int8 if cache == "int8" else torch.bfloat16)
    per_pass = res["launches_per_pass"]
    assert per_pass["int8_mm_dequant_nt"] > 0 and per_pass["flash_attention"] > 0
    assert per_pass["flash_attention_offsets"] > 0


def _ssd_inputs(dev, T, H, G, N, seed):
    """A span's x | B | C rows and dt (a view with the projection's row stride), the heads'
    A, D and dt_bias, and three lanes of state."""
    from llama_x_tpu_torch.ops import ssd

    g = torch.Generator(device=dev).manual_seed(seed)
    P = ssd.SSD_HEAD_DIM
    xbc = (torch.randn(T, H * P + 2 * G * N, device=dev, generator=g) * 0.5).to(torch.bfloat16)
    proj = (torch.randn(T, 3 * H, device=dev, generator=g)).to(torch.bfloat16)
    A = -(torch.rand(H, device=dev, generator=g) * 15 + 1)
    D = torch.rand(H, device=dev, generator=g) + 0.5
    dt_bias = torch.log(torch.expm1(torch.rand(H, device=dev, generator=g) * 0.099 + 0.001))
    lanes = torch.randn(3, H, P, N, device=dev, generator=g) * 0.1
    return xbc, proj[:, H:2 * H], A, D, dt_bias, lanes


@pytest.mark.parametrize("N", [128, 256])
@pytest.mark.parametrize("T,length,snap,fresh", [(1, 1, 1, True), (37, 30, 17, False), (64, 64, 64, False),
                                                 (200, 173, 100, True), (512, 512, -1, False)])
def test_ssd_scan_kernel_matches_plain(cuda, N, T, length, snap, fresh):
    """K8 against its plain version on the card: y, the lane it writes (the pads after
    ``length`` leave it as at ``length``), the lanes it leaves alone, and the snapshot at an
    interior offset. f32 sums in another order: within 2e-4 of each output's largest value."""
    from llama_x_tpu_torch.ops import ssd

    H, G = 8, 2
    xbc, dt, A, D, dt_bias, lanes = _ssd_inputs(cuda, T, H, G, N, T + N)
    dims = dict(heads=H, head_dim=ssd.SSD_HEAD_DIM, groups=G, state_dim=N, fresh=fresh)
    slot = torch.tensor([1], device=cuda)
    scalars = (torch.tensor([length], device=cuda), torch.tensor([snap], device=cuda))
    want_lanes, got_lanes = lanes.clone(), lanes.clone()
    want_snap, got_snap = (torch.zeros(H, ssd.SSD_HEAD_DIM, N, device=cuda) for _ in range(2))
    want = ssd.ssd_scan_plain(xbc, dt, A, D, dt_bias, want_lanes, slot, *scalars, want_snap, **dims)
    before, scanned = ssd.ssd_scan.launches, ssd.ssd_scan.scanned.launches
    got = ssd.ssd_scan(xbc, dt, A, D, dt_bias, got_lanes, slot, *scalars, got_snap, **dims)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1 and ssd.ssd_scan.scanned.launches == scanned + T
    for a, b in ((got[:length], want[:length]), (got_lanes, want_lanes), (got_snap, want_snap)):
        assert _max_err(a, b) <= 2e-4 * max(1e-3, float(b.abs().max()))
    assert torch.equal(got_lanes[0], lanes[0]) and torch.equal(got_lanes[2], lanes[2])


@pytest.mark.parametrize("N", [128, 256])
@pytest.mark.parametrize("B", [1, 5, 16])
def test_ssd_step_kernel_matches_plain(cuda, N, B):
    """K9 against its plain version on the card, one slot in three done: y and the state
    within 2e-4 of their largest values (f32 sums in another order), the conv lanes bit for
    bit (the shifted inputs), and a done slot's lanes untouched with y 0."""
    from llama_x_tpu_torch.ops import ssd

    H, G, K = 8, 2, ssd.CONV_KERNEL
    xbc, _, A, D, dt_bias, _ = _ssd_inputs(cuda, B, H, G, N, B * N)
    g = torch.Generator(device=cuda).manual_seed(B)
    C = xbc.shape[1]
    proj = torch.randn(B, C + 2 * H, device=cuda, generator=g).to(torch.bfloat16)
    proj[:, :C] = xbc
    conv_w = (torch.rand(C, K, device=cuda, generator=g) - 0.5).to(torch.bfloat16)
    conv_b = (torch.rand(C, device=cuda, generator=g) - 0.5).to(torch.bfloat16)
    conv = torch.randn(B, K - 1, C, device=cuda, generator=g).to(torch.bfloat16)
    state = torch.randn(B, H, ssd.SSD_HEAD_DIM, N, device=cuda, generator=g) * 0.1
    done = torch.arange(B, device=cuda) % 3 == 1
    args = (proj[:, :C], proj[:, C:C + H], conv_w, conv_b, A, D, dt_bias)
    dims = dict(heads=H, head_dim=ssd.SSD_HEAD_DIM, groups=G, state_dim=N)
    wc, ws = conv.clone(), state.clone()
    want = ssd.ssd_step_plain(*args, wc, ws, done, **dims)
    gc, gs = conv.clone(), state.clone()
    before = ssd.ssd_step.launches
    for _ in range(2):  # the group counters are left at zero: a second launch steps again
        got = ssd.ssd_step(*args, gc, gs, done, **dims)
        if _ == 0:
            torch.cuda.synchronize()
            assert _max_err(got, want) <= 2e-4 * float(want.abs().max())
            assert _max_err(gs, ws) <= 2e-4 * float(ws.abs().max())
            assert torch.equal(gc, wc)
            want = ssd.ssd_step_plain(*args, wc, ws, done, **dims)
    torch.cuda.synchronize()
    assert ssd.ssd_step.launches == before + 2
    assert _max_err(gs, ws) <= 4e-4 * float(ws.abs().max()) and torch.equal(gc, wc)
    assert torch.equal(gs[done], state[done]) and torch.equal(gc[done], conv[done]) and not got[done].any()


def _hybrid_model(dev):
    """A small Nemotron-H (every block kind, Mamba heads of 64 over a state of 128) with int8
    projections and dynamic int8 activations."""
    from llama_x_tpu_torch.adapters.quantize import quantize_linear
    from llama_x_tpu_torch.models import nemotron_h as nh

    cfg = nh.HybridConfig(embed_dim=256, pattern="M-*M-M*-", head_dim=64, num_heads=4, num_kv_heads=2,
                          intermediate_dim=512, mamba_heads=8, mamba_head_dim=64, ssm_state=128, n_groups=2,
                          max_seq_len=512, vocab_size=512)
    model = nh.init(cfg, seed=1, device=dev)
    quantize_linear(model.layers, "int8")
    model.config = cfg.replace(dynamic_int8_act=True)
    return model


def test_hybrid_scheduler_with_graphs_matches_eager(cuda):
    """The hybrid through ``ContinuousScheduler`` on the card (int8 cache, chunked prefill of
    64, a prefix cache): rows that join and leave and a follow-up turn that restores a snapshot;
    every row's greedy tokens through the captured graphs equal the eager loop's, and the
    state counters agree."""
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    model = _hybrid_model(cuda)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 512, (n,), generator=g).tolist() for n in (20, 150, 97, 7, 200)]
    prompts.append(prompts[1] + torch.randint(0, 512, (60,), generator=g).tolist())
    rows, counts = {}, {}
    for eager in (True, False):
        sched = ContinuousScheduler(model, n_slots=3, chunk_size=8, cache_dtype=torch.int8, prefill_chunk=64,
                                    prefix_cache=4, eager=eager)
        try:
            handles = [sched.submit(p, max_tokens=10 + 3 * i) for i, p in enumerate(prompts[:5])]
            for h in handles:
                assert h.event.wait(600) and h.error is None, h.error
            last = sched.submit(prompts[5], max_tokens=9)
            assert last.event.wait(600) and last.error is None, last.error
            handles.append(last)
        finally:
            sched.close()
        rows[eager] = [h.tokens for h in handles]
        counts[eager] = (sched.prefix_hits, sched.prefix_state_hits, sched.state_snapshots, sched.state_bytes_copied)
    assert rows[False] == rows[True]
    assert counts[False] == counts[True] and counts[True][1] >= 1


@pytest.mark.parametrize("W", [1, 37, 512])
def test_ssd_conv_pass_matches_plain(cuda, W):
    """The span's conv pass (Triton) against its plain version: SiLU(conv) rounded to bf16,
    within one bf16 step of the larger (f32 sums that may fuse into fmas)."""
    from llama_x_tpu_torch.ops import ssd

    g = torch.Generator(device=cuda).manual_seed(W)
    C, K = 20480, ssd.CONV_KERNEL
    win = torch.randn(K - 1 + W, C, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.rand(C, K, device=cuda, generator=g) - 0.5).to(torch.bfloat16)
    b = (torch.rand(C, device=cuda, generator=g) - 0.5).to(torch.bfloat16)
    before = ssd.ssd_conv.launches
    got, want = ssd.ssd_conv(win, w, b), ssd.ssd_conv_plain(win, w, b)
    torch.cuda.synchronize()
    assert ssd.ssd_conv.launches == before + 1
    assert bool(((got.float() - want.float()).abs() <= 2 ** -7 * want.float().abs() + 1e-6).all())


@pytest.mark.parametrize("rows,groups,C", [(1, 8, 16384), (16, 8, 16384), (512, 8, 16384), (3, 2, 96)])
def test_gated_norm_pass_matches_plain(cuda, rows, groups, C):
    """The gated RMSNorm pass (Triton) against its plain version, z a strided view of a wider
    projection: within one bf16 step (f32 sums in another order, the bf16 rounding of the
    output)."""
    from llama_x_tpu_torch.ops import ssd

    g = torch.Generator(device=cuda).manual_seed(rows + C)
    y = torch.randn(rows, C, device=cuda, generator=g)
    proj = torch.randn(rows, C + 40, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.rand(C, device=cuda, generator=g) + 0.5).to(torch.bfloat16)
    before = ssd.gated_norm.launches
    got = ssd.gated_norm(y, proj[:, :C], w, groups, 1e-5)
    want = ssd.gated_norm_plain(y, proj[:, :C], w, groups, 1e-5)
    torch.cuda.synchronize()
    assert ssd.gated_norm.launches == before + 1
    assert bool(((got.float() - want.float()).abs() <= 2 ** -7 * want.float().abs() + 1e-5).all())
