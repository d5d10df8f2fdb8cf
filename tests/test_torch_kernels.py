"""The port's hand-written CUDA kernels against their plain PyTorch versions on a
CUDA card. Every test is marked ``gpu`` and skips without a card (decided inside
the test). This file imports only torch and the port, so it runs where JAX is not
installed:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

Tolerances: K1 and K4 bit-exact (exact integer sums, same epilogue order); K2 out
3e-2 (a few bf16 ulps at |out| < 4) and lse 2e-3 (fp32 sums in another order); K3 per
element 4e-3 + 2^-7 |ref| (bf16 out; P rounded to bf16 at the kernel's running max),
which a window one position off misses by 5x or more; K5 per element 2^-7 |ref| +
2^-5 rms(ref) for each of dq, dk, dv (``flash_bwd_tolerance``, the one formula the
chip smoke script uses too)."""

import math

import pytest
import torch

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops import flash_attention as fa
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


def _mask(case: str, B: int, S: int, dev):
    g = torch.Generator(device=dev).manual_seed(S)
    segs = torch.sort(torch.randint(1, 4, (B, S), device=dev, generator=g), dim=1).values.to(torch.int32)
    prefix = torch.randint(1, max(S // 2, 2), (B,), device=dev, generator=g).to(torch.int32)
    return {
        "causal": MaskInfo(causal=True),
        "noncausal": MaskInfo(causal=False),
        "prefix": MaskInfo(causal=True, prefix_len=prefix),
        "segment+prefix": MaskInfo(causal=True, segment_ids=segs, prefix_len=prefix),
    }[case]


@pytest.mark.parametrize("case,S,D", [("causal", 512, 128), ("prefix", 37, 64), ("segment+prefix", 200, 128),
                                      ("noncausal", 64, 64)])
def test_flash_kernel_matches_plain(cuda, case, S, D):
    B, Hq, Hkv = 2, 8, 2
    mi = _mask(case, B, S, cuda)
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q, k, v = (torch.randn(B, S, h, D, device=cuda, generator=g).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    before = fa.flash_fwd_with_lse.launches
    out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
    torch.cuda.synchronize()
    assert fa.flash_fwd_with_lse.launches == before + 1
    ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi)
    assert _max_err(out, ref) <= 3e-2
    assert _max_err(lse, ref_lse) <= 2e-3


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


@pytest.mark.parametrize("case", ["Sq > MAX_SQ", "prefix", "segments"])
def test_decode_outside_the_kernel_contract_raises(cuda, case):
    """On the card a decode over the cache never takes the plain attention: a mask
    the decode kernel cannot take raises."""
    from llama_x_tpu_torch.ops.attention import MaskInfo

    cfg = llama.tiny_config(embed_dim=256, head_dim=64, num_heads=4, num_kv_heads=2, intermediate_dim=512,
                            max_seq_len=64)
    model = llama.init(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    cache = llama.init_kv_cache(cfg, 1, dtype=torch.bfloat16, device=cuda)
    S = da.MAX_SQ + 1 if case == "Sq > MAX_SQ" else 1
    pos = torch.arange(S, device=cuda)
    extra = {"prefix": dict(prefix_len=torch.ones(1, dtype=torch.int32, device=cuda)),
             "segments": dict(segment_ids=torch.ones(1, S, dtype=torch.int32, device=cuda))}.get(case, {})
    mi = MaskInfo(causal=True, q_positions=pos[None], kv_len=torch.tensor([S], device=cuda), **extra)
    x = torch.zeros(1, S, cfg.embed_dim, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="decode kernel"):
        llama.trunk(model, x, mi, cache, input_pos=pos)


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


@pytest.mark.parametrize("case,S,D", [("causal", 256, 128), ("prefix", 37, 64), ("segment+prefix", 200, 128),
                                      ("noncausal", 64, 64), ("causal", 130, 64)])
def test_flash_bwd_kernel_matches_plain(cuda, case, S, D):
    """K5: dq, dk, dv from the forward kernel's (out, lse), GQA group 4, ragged S."""
    B, Hq, Hkv = 2, 8, 2
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
    elif case == "dropout":
        kw, exc = dict(dropout_rate=0.1), NotImplementedError
    elif case == "head_dim 32":
        exc = ValueError
    else:
        mi, exc = MaskInfo(causal=True, q_positions=torch.arange(S, device=cuda)), ValueError
    with pytest.raises(exc):
        fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, **kw)
    if case == "dropout":
        with pytest.raises(NotImplementedError):
            fa.flash_attention(q, k, v, mi, dropout_rate=0.1)


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
