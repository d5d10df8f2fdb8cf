"""The flash backward's plain version (and the ``autograd.Function`` around the flash
forward) against ``jax.grad`` through the JAX package's ``flash_attention``, whose
Pallas kernels run in interpret mode on the CPU, on the same numpy inputs in fp32.

Tolerances: in fp32 every rounding point (p and ds cast to the input dtype) is a
no-op on both sides, so only the summation order differs: the JAX kernel sums a row in
kv blocks and its dq in per-block partials. Gradients within 2e-5 + 2e-5 |ref|, the
forward within 1e-5. The kernels against this plain version are held on the card
(tests/test_torch_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu.ops.attention import MaskInfo as JMaskInfo
from llama_x_tpu_torch.ops import flash_attention as tfa
from llama_x_tpu_torch.ops.attention import MaskInfo, dot_product_attention

torch.set_num_threads(2)

GRAD_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32) * 0.5
    q, k, v, do = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, S, Hq, D)
    segs = np.sort(rng.integers(1, 5, (B, S)), axis=1).astype(np.int32)
    prefix = rng.integers(1, S // 2, (B,)).astype(np.int32)
    return q, k, v, do, segs, prefix


def _masks(case, segs, prefix):
    kw = {"causal": {}, "noncausal": {}, "doc": dict(segment_ids=segs), "prefix": dict(prefix_len=prefix),
          "doc+prefix": dict(segment_ids=segs, prefix_len=prefix)}[case]
    causal = case != "noncausal"
    return (JMaskInfo(causal=causal, **{n: jnp.asarray(a) for n, a in kw.items()}),
            MaskInfo(causal=causal, **{n: torch.from_numpy(a) for n, a in kw.items()}))


CASES = [
    ("causal", 256, 4, 2, 128),
    ("doc", 256, 4, 2, 128),
    ("prefix", 128, 4, 2, 64),
    ("doc+prefix", 256, 8, 2, 64),  # GQA group 4
    ("noncausal", 128, 2, 2, 64),
    ("causal", 128, 4, 1, 128),  # MQA
]


@pytest.mark.parametrize("case,S,Hq,Hkv,D", CASES)
def test_flash_gradients_match_jax_kernels(case, S, Hq, Hkv, D):
    """dq, dk, dv of the port's differentiable ``flash_attention`` (plain forward and
    plain backward on the CPU) against ``jax.vjp`` through the Pallas forward and
    backward kernels."""
    q, k, v, do, segs, prefix = _inputs(S + Hq, 2, S, Hq, Hkv, D)
    jmi, tmi = _masks(case, segs, prefix)
    assert jfa.flash_plan(q.shape, k.shape, jmi) is not None  # the JAX side runs its kernels
    out, vjp = jax.vjp(lambda q_, k_, v_: jfa.flash_attention(q_, k_, v_, jmi), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got_out = tfa.flash_attention(*leaves, tmi)
    got_out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)
    assert tfa.flash_bwd_from_res.launches == 0 and tfa.flash_fwd_with_lse.launches == 0  # CPU: plain versions


@pytest.mark.parametrize("case", ["causal", "doc+prefix"])
def test_flash_bwd_plain_from_residuals_matches_jax(case):
    """``flash_bwd_plain`` fed the JAX forward's own (out, lse) against the JAX
    ``flash_bwd_from_res``: the backward alone, residual layout included
    (lse [B, Hq, S, 1], natural log)."""
    B, S, Hq, Hkv, D = 2, 128, 4, 2, 64
    q, k, v, do, segs, prefix = _inputs(11, B, S, Hq, Hkv, D)
    jmi, tmi = _masks(case, segs, prefix)
    plan = jfa.flash_plan(q.shape, k.shape, jmi)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = jfa.flash_fwd_with_lse(jq, jk, jv, jmi, plan)
    want = jfa.flash_bwd_from_res(jq, jk, jv, out, lse, jnp.asarray(do), jmi, plan)
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfa.flash_bwd_plain(t(q), t(k), t(v), t(out), t(lse), t(do), tmi)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)
    # and the port's forward gives those residuals
    t_out, t_lse = tfa.flash_fwd_plain(t(q), t(k), t(v), tmi)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(lse), rtol=1e-5, atol=1e-5)


def test_flash_bwd_plain_matches_autograd_of_the_oracle_at_ragged_s():
    """S = 37 (no JAX kernel plan exists there): the plain backward against PyTorch's
    own autograd through the plain attention oracle."""
    q, k, v, do, segs, prefix = _inputs(5, 2, 37, 4, 2, 64)
    mi = MaskInfo(causal=True, segment_ids=torch.from_numpy(segs), prefix_len=torch.from_numpy(prefix))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tfa.flash_attention(*leaves, mi).backward(torch.from_numpy(do))
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    dot_product_attention(*leaves, mi).backward(torch.from_numpy(do))
    for g, t in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), **GRAD_TOL)


def test_flash_bwd_keeps_the_rounding_points_in_bf16():
    """In bf16 the plain backward rounds p before the dV product and ds before the dk /
    dq products, as the TPU kernel does: against an fp32 run of the same inputs the
    gradients move by bf16 roundings (above 1e-4 somewhere) and stay within 2^-6 of the
    largest gradient."""
    q, k, v, do, _, _ = _inputs(3, 1, 64, 2, 1, 64)
    mi = MaskInfo(causal=True)
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qb, kb, vb, dob = b(q), b(k), b(v), b(do)
    out, lse = tfa.flash_fwd_plain(qb, kb, vb, mi)
    got = tfa.flash_bwd_plain(qb, kb, vb, out, lse, dob, mi)
    f = lambda t: t.float()
    out32, lse32 = tfa.flash_fwd_plain(f(qb), f(kb), f(vb), mi)
    ref = tfa.flash_bwd_plain(f(qb), f(kb), f(vb), out32, lse32, f(dob), mi)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        err = float((g.float() - r).abs().max())
        assert 1e-4 < err <= 2**-6 * float(r.abs().max())


def test_flash_dropout_is_refused():
    """Dropout is ported (tests/test_torch_dropout.py); what is still refused is a rate
    outside [0, 1). A rate without a seed is no dropout, as in the JAX package."""
    q = torch.randn(1, 8, 1, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="dropout"):
        tfa.flash_attention(q, q, q, MaskInfo(causal=True), dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout"):
        tfa.make_dropout(1.5, 0, 8, 8, 1)
    plain = tfa.flash_attention(q, q, q, MaskInfo(causal=True))
    assert torch.equal(tfa.flash_attention(q, q, q, MaskInfo(causal=True), dropout_rate=0.5), plain)


@pytest.mark.parametrize("fault", ["mask one position off", "missing ln2", "lost group member"])
def test_flash_bwd_tolerance_sees_faults(fault):
    """``flash_bwd_tolerance`` (what holds the kernel to the plain version on the card:
    per element 2^-7 |ref| + 2^-5 rms(ref)) accepts the reference itself and rejects a
    backward whose segment boundaries lie one position off, whose dq and dk lack the ln2
    of the base-2 logits, or whose dk / dv lose one q head of a GQA group."""
    B, S, Hq, Hkv, D = 1, 128, 4, 2, 64
    q, k, v, do, segs, _ = _inputs(7, B, S, Hq, Hkv, D)
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qb, kb, vb, dob = b(q), b(k), b(v), b(do)
    mi = MaskInfo(causal=True, segment_ids=torch.from_numpy(segs))
    out, lse = tfa.flash_fwd_plain(qb, kb, vb, mi)
    ref = tfa.flash_bwd_plain(qb, kb, vb, out, lse, dob, mi)
    if fault == "mask one position off":
        off = MaskInfo(causal=True, segment_ids=torch.from_numpy(np.roll(segs, 1, axis=1)))
        got = tfa.flash_bwd_plain(qb, kb, vb, out, lse, dob, off)
    elif fault == "missing ln2":
        got = ((ref[0].float() / 0.6931471805599453).to(torch.bfloat16),
               (ref[1].float() / 0.6931471805599453).to(torch.bfloat16), ref[2])
    else:
        lost = dob.clone()
        lost[:, :, 1] = 0
        got = (ref[0], *tfa.flash_bwd_plain(qb, kb, vb, out, lse, lost, mi)[1:])

    def excess_over_atol(g, r):
        atol, rtol = tfa.flash_bwd_tolerance(r)
        return float(((g.float() - r.float()).abs() - rtol * r.float().abs()).max()) / atol

    assert all(excess_over_atol(r, r) <= 1 for r in ref)
    assert max(excess_over_atol(g, r) for g, r in zip(got, ref)) > 4  # missed by a factor, not by a hair
