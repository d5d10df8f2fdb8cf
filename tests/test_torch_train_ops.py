"""The port's training ops against the JAX package's on the same numpy inputs, in fp32
on the CPU: the KN int8 GEMM's plain version, ``int8_linear`` and its input gradient
(bf16 and int8 dgrad), LoRA / DoRA gradients, and the cross-entropy losses with their
gradients.

Tolerances: bit-exact where the arithmetic is integer (the int8 GEMMs' exact sums and
their epilogue); rtol/atol 1e-5 where only the fp32 summation order differs; 2e-5 for
the int8 dgrad and the int8 head, where a value that sits on an int8 rounding tie may
round the other way on one side and move an output by one quantization step of one
term (stated at each test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.ops import cross_entropy as jce
from llama_x_tpu.ops import int8 as jint8
from llama_x_tpu.ops import linear as jlinear
from llama_x_tpu_torch.ops import cross_entropy as tce
from llama_x_tpu_torch.ops import int8 as tint8
from llama_x_tpu_torch.ops import int8_mm as tmm
from llama_x_tpu_torch.ops import linear as tlinear

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_mm_kn_plain_matches_jax(out_dtype):
    """K4's plain version against ``_int8_mm_dequant_xla`` at K = 14336 (the dgrad
    through w2 contracts over the MLP width), bit for bit, and against the NT form on
    the transposed operand."""
    rng = np.random.default_rng(3)
    M, K, N = 6, 14336, 48
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    rs = rng.random(M).astype(np.float32) * 0.02
    cs = rng.random(N).astype(np.float32) * 0.001
    want = jint8._int8_mm_dequant_xla(jnp.asarray(a), jnp.asarray(b), jnp.asarray(rs), jnp.asarray(cs),
                                      getattr(jnp, out_dtype))
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(rs), torch.from_numpy(cs))
    got = tmm.int8_mm_dequant(*args, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and tmm.int8_mm_dequant.launches == 0
    np.testing.assert_array_equal(_np(got.float()), np.asarray(want.astype(jnp.float32)))
    nt = tmm.int8_mm_dequant_nt(args[0], args[1].T.contiguous(), args[2], args[3], out_dtype=getattr(torch, out_dtype))
    assert torch.equal(got, nt)


def test_int8_mm_exact_at_the_vocabulary_contraction():
    """127^2 * 128256 fits int32 (the CE head's dH product contracts over the
    vocabulary); the bound the wrappers refuse beyond is the last K that does."""
    assert 127 * 127 * 128256 < 2**31
    assert 127 * 127 * tmm.MAX_K < 2**31 <= 127 * 127 * (tmm.MAX_K + 1)
    a = torch.full((1, 128256), 127, dtype=torch.int8)
    b = torch.full((128256, 1), 127, dtype=torch.int8)
    got = tmm.int8_mm_dequant(a, b, torch.ones(1), torch.ones(1), out_dtype=torch.float32)
    assert float(got) == float(np.float32(127 * 127 * 128256))


def _int8_linear_case(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32) * 0.1  # [out, in]
    g = rng.standard_normal((2, 5, 48)).astype(np.float32)
    q, s = jint8.quantize_int8_rowwise(jnp.asarray(w))
    return x, g, q, s


@pytest.mark.parametrize("dynamic_act", [False, True])
@pytest.mark.parametrize("dynamic_bwd", [False, True])
def test_int8_linear_value_and_input_gradient_match_jax(dynamic_act, dynamic_bwd):
    """Value and grad_x against ``jax.vjp`` of the JAX ``int8_linear``. With
    ``dynamic_int8_bwd`` g * scale is rounded to int8 per row: a tie may fall the other
    way (2e-5, one step of one term at these magnitudes)."""
    x, g, q, s = _int8_linear_case()
    want, vjp = jax.vjp(lambda x_: jint8.int8_linear(x_, q, s, dynamic_act, dynamic_bwd), jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tint8.int8_linear(tx, torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)), dynamic_act, dynamic_bwd)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    tol = dict(rtol=2e-5, atol=2e-5) if dynamic_bwd else TOL
    np.testing.assert_allclose(_np(tx.grad), np.asarray(want_gx), **tol)


def test_int8_linear_gives_the_base_no_gradient():
    """The int8 base is frozen by construction: even a scale that asks for a gradient
    gets none, with either dgrad."""
    x, g, q, s = _int8_linear_case()
    for bwd in (False, True):
        tx = torch.from_numpy(x).requires_grad_(True)
        scale = torch.from_numpy(np.array(s)).requires_grad_(True)
        tint8.int8_linear(tx, torch.from_numpy(np.array(q)), scale, True, bwd).backward(torch.from_numpy(g))
        assert scale.grad is None and tx.grad is not None


def test_int8_dgrad_scale_is_folded_before_quantizing():
    """The weight scale multiplies the contraction dim, so the int8 dgrad quantizes
    g * scale, not g: with very unequal scales the two orders differ visibly, and the
    port follows the JAX order exactly."""
    rng = np.random.default_rng(9)
    g = rng.standard_normal((4, 32)).astype(np.float32)
    q = rng.integers(-127, 128, (32, 16), dtype=np.int8)
    s = (10.0 ** rng.uniform(-3, 0, 32)).astype(np.float32)
    tx = torch.zeros(4, 16, requires_grad=True)
    tint8.int8_linear(tx, torch.from_numpy(q), torch.from_numpy(s), False, True).backward(torch.from_numpy(g))
    g_i8, g_s = jint8.quantize_int8_rowwise(jnp.asarray(g * s))
    want = jint8._int8_mm_dequant_xla(g_i8, jnp.asarray(q), g_s, jnp.ones(16, jnp.float32), jnp.float32)
    np.testing.assert_array_equal(_np(tx.grad), np.asarray(want))
    wrong_i8, wrong_s = jint8.quantize_int8_rowwise(jnp.asarray(g))
    wrong = (np.asarray(wrong_i8, np.float32) * np.asarray(wrong_s)[:, None] * s) @ q.astype(np.float32)
    assert np.abs(wrong - _np(tx.grad)).max() > 1e-3


def _adapter_pair(rng, din, dout, *, int8, dora):
    w = rng.standard_normal((din, dout)).astype(np.float32) * 0.1
    a = rng.standard_normal((din, 4)).astype(np.float32) * 0.1
    b = rng.standard_normal((4, dout)).astype(np.float32) * 0.1
    jp = {"kernel": jnp.asarray(w)}
    tp = {"weight": torch.from_numpy(np.ascontiguousarray(w.T))}
    if int8:
        q, s = jint8.quantize_int8_rowwise(jnp.asarray(w.T))
        jp = {"int_data": q, "scale": s}
        tp = {"int_data": torch.from_numpy(np.array(q)), "scale": torch.from_numpy(np.array(s))}
    jp |= {"lora_a": jnp.asarray(a), "lora_b": jnp.asarray(b), "lora_scale": jnp.asarray(np.float32(2.0))}
    tp |= {"lora_a": torch.from_numpy(a), "lora_b": torch.from_numpy(b), "lora_scale": torch.tensor(2.0)}
    if dora:
        m = rng.random(dout).astype(np.float32) + 0.5
        jp["m"], tp["m"] = jnp.asarray(m), torch.from_numpy(m)
    lin = tlinear.Linear(**tp)
    for name in ("lora_a", "lora_b", "m"):
        if getattr(lin, name) is not None:
            getattr(lin, name).requires_grad_(True)
    return jp, lin


@pytest.mark.parametrize("variant", ["lora", "dora", "int8+lora", "int8+dora", "int8+lora+bwd8"])
def test_adapter_gradients_match_jax(variant):
    """Gradients of lora_a, lora_b (and m) and of the input through ``apply_linear``
    and the grouped form; the DoRA norm carries no gradient on either side."""
    rng = np.random.default_rng(6)
    int8, dora, bwd8 = "int8" in variant, "dora" in variant, "bwd8" in variant
    pairs = [_adapter_pair(rng, 64, dout, int8=int8, dora=dora) for dout in (32, 16)]
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    gs = [rng.standard_normal((2, 5, dout)).astype(np.float32) for dout in (32, 16)]
    kw = dict(dynamic_int8_act=int8, dynamic_int8_bwd=bwd8)
    names = ["lora_a", "lora_b"] + (["m"] if dora else [])

    def jloss(adapters, x_):
        ps = [{**p, **ad} for (p, _), ad in zip(pairs, adapters)]
        outs = jlinear.apply_linear_grouped(x_, ps, **kw)
        single = jlinear.apply_linear(x_, ps[0], **kw)
        return sum(jnp.sum(o * jnp.asarray(g)) for o, g in zip(outs, gs)) + jnp.sum(single * jnp.asarray(gs[0]))

    adapters = [{n: p[n] for n in names} for p, _ in pairs]
    want_ad, want_x = jax.grad(jloss, argnums=(0, 1))(adapters, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_(True)
    lins = [lin for _, lin in pairs]
    outs = tlinear.apply_linear_grouped(tx, lins, **kw)
    single = tlinear.apply_linear(tx, lins[0], **kw)
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(outs, gs)) + (single * torch.from_numpy(gs[0])).sum()
    loss.backward()
    tol = dict(rtol=2e-5, atol=2e-5) if bwd8 else dict(rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(want_x), **tol)
    for lin, want in zip(lins, want_ad):
        for n in names:
            np.testing.assert_allclose(_np(getattr(lin, n).grad), np.asarray(want[n]), rtol=1e-5, atol=2e-5)
        assert lin.lora_scale.grad is None
        if int8:
            assert lin.scale.grad is None
        else:
            assert lin.weight.grad is None  # frozen under an adapter


def _ce_case(seed=7, n=24, d=32, v=80):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    kernel = rng.standard_normal((d, v)).astype(np.float32) * 0.3  # JAX layout [D, V]
    labels = rng.integers(0, v, n).astype(np.int32)
    labels[[1, 5, 6, 17]] = -100
    return hidden, kernel, labels


def test_cross_entropy_loss_matches_jax():
    hidden, kernel, labels = _ce_case()
    logits = hidden @ kernel
    want, want_g = jax.value_and_grad(lambda l: jce.cross_entropy_loss(l, jnp.asarray(labels)))(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = tce.cross_entropy_loss(tl, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(tl.grad), np.asarray(want_g), **TOL)
    # nothing but ignored labels: the count is clamped at 1 and the loss is 0
    none = torch.full((24,), -100, dtype=torch.int32)
    assert float(tce.cross_entropy_loss(torch.from_numpy(logits), none)) == 0.0


@pytest.mark.parametrize("kernel_grad,head_int8", [(True, False), (False, False), (False, True)])
@pytest.mark.parametrize("num_chunks", [1, 4])
def test_fused_linear_cross_entropy_matches_jax(kernel_grad, head_int8, num_chunks):
    """Loss, dH and dK of the chunked fused CE against the JAX custom_vjp, with ignored
    labels. The port holds the head as weight [V, D] = kernel.T; a frozen head gets no
    gradient at all (JAX returns zeros). With ``head_int8`` the logits and dlogits are
    rounded to int8 per row on both sides: 2e-5 for a tie that falls the other way."""
    hidden, kernel, labels = _ce_case()
    f = lambda h, k: jce.fused_linear_cross_entropy(h, k, jnp.asarray(labels), num_chunks, kernel_grad, head_int8)
    want, (want_dh, want_dk) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(kernel))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(np.ascontiguousarray(kernel.T)).requires_grad_(True)
    got = tce.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), num_chunks, kernel_grad, head_int8)
    got.backward()
    tol = dict(rtol=2e-5, atol=2e-5) if head_int8 else TOL
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=2e-6)
    np.testing.assert_allclose(_np(th.grad), np.asarray(want_dh), **tol)
    if kernel_grad:
        np.testing.assert_allclose(_np(tw.grad).T, np.asarray(want_dk), **TOL)
    else:
        assert tw.grad is None and not np.asarray(want_dk).any()
    # the fused loss equals the plain loss over materialized logits
    if not head_int8:
        plain = tce.cross_entropy_loss(torch.from_numpy(hidden @ kernel), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got.detach()), float(plain), rtol=2e-6)


def test_fused_linear_cross_entropy_refuses_what_jax_refuses():
    hidden, kernel, labels = _ce_case()
    args = (torch.from_numpy(hidden), torch.from_numpy(np.ascontiguousarray(kernel.T)), torch.from_numpy(labels))
    with pytest.raises(ValueError, match="head_int8 requires"):
        tce.fused_linear_cross_entropy(*args, 4, True, True)
    with pytest.raises(ValueError, match="not divisible"):
        tce.fused_linear_cross_entropy(*args, 5, True, False)


def test_int8_head_goes_through_both_int8_gemm_forms(monkeypatch):
    """With ``head_int8`` the logits run the NT form and dH the KN form, on the SAME
    stored int8 head [V, D] (no transposed copy): the head's integers and scales are
    those of the JAX package's colwise-quantized [D, V] kernel."""
    hidden, kernel, labels = _ce_case()
    calls = []
    nt, kn = tmm.int8_mm_dequant_nt, tmm.int8_mm_dequant
    monkeypatch.setattr(tmm, "int8_mm_dequant_nt", lambda a, b, *r, **k: calls.append(("nt", b)) or nt(a, b, *r, **k))
    monkeypatch.setattr(tmm, "int8_mm_dequant", lambda a, b, *r, **k: calls.append(("kn", b)) or kn(a, b, *r, **k))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(np.ascontiguousarray(kernel.T))
    tce.fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), 2, False, True).backward()
    assert [c[0] for c in calls] == ["nt", "nt", "nt", "kn", "nt", "kn"]
    k_i8, k_scale = jint8.quantize_int8_colwise(jnp.asarray(kernel))
    for _, b in calls:
        assert tuple(b.shape) == tuple(tw.shape)
        np.testing.assert_array_equal(_np(b), np.asarray(k_i8).T)
    np.testing.assert_array_equal(_np(tint8.quantize_int8_rowwise(tw)[1]), np.asarray(k_scale))
