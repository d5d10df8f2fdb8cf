"""Attention dropout in the port's flash path against the JAX package's, on the CPU.

The JAX kernels build their keep mask from a counter-based hash (``_keep_for``); the
port reproduces it in its kernels and in their plain versions. Here: the plain hash
against ``_keep_for`` bit for bit; the plain forward and backward with dropout against
the JAX Pallas kernels run in interpret mode (as tests/test_flash_dropout.py runs them)
on the same numpy inputs; ``llama.forward`` with the JAX package's per-layer seeds handed
over; and, where the JAX package has no plan and falls back to ``jax.random.bernoulli``
(which no port can reproduce), the keep rate and the forward/backward consistency.

Tolerances: the hash is exact. Forward and backward run in fp32 on both sides and
differ by summation order only: 2e-5 + 1e-4 |ref| for the output, 5e-4 + 1e-3 |ref| for
the gradients (the limits of tests/test_flash_dropout.py against its dense oracle). A
mask that differs in one element moves its output row by about p v / (1 - rate), far
above these. The bf16 limit that holds the CUDA forward to its plain version on the
card (``flash_fwd_tolerance``) is tried here on a tiled restatement of that kernel's
arithmetic: it passes, and a keep mask wrong on one plan block or a missing keep scale
does not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu.ops.attention import MaskInfo as JMaskInfo
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.ops import flash_attention as tfa
from llama_x_tpu_torch.ops.attention import MaskInfo

torch.set_num_threads(2)


@pytest.fixture
def interpret():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _jax_seed(key) -> int:
    """The seed the JAX wrapper draws from a dropout key (flash_attention.py:748-751)."""
    return int(jax.random.randint(key, (1, 1), 0, jnp.iinfo(jnp.int32).max, jnp.int32)[0, 0])


@pytest.mark.parametrize("seed,rate,bq,bk,group", [
    (12345, 0.3, 128, 128, 2),
    (0, 0.1, 32, 128, 4),
    (2**31 - 2, 0.5, 64, 256, 1),      # with b, h > 0 the key wraps around 2^32
    (0xFFFFFFF0, 0.25, 128, 512, 2),   # the seed alone is close to the wrap
    (7, 0.999, 32, 128, 2),
    (7, 1e-9, 32, 128, 2),             # the threshold rounds to 4: (almost) everything kept
])
def test_plain_hash_equals_keep_for_bit_for_bit(seed, rate, bq, bk, group):
    B, Hkv, S = 2, 3, 512
    dropout = tfa.Dropout(rate, seed, bq, bk)
    keep = tfa.dropout_keep(dropout, B, Hkv, group, S, S).numpy()
    for b in range(B):
        for h in range(Hkv):
            for i in range(S // bq):
                for j in range(S // bk):
                    want = np.asarray(jfa._keep_for(jnp.uint32(seed), rate, group * bq, bk, b, h, i, j))
                    got = keep[b, h, :, i * bq:(i + 1) * bq, j * bk:(j + 1) * bk].reshape(group * bq, bk)
                    np.testing.assert_array_equal(got, want > 0, err_msg=f"b={b} h={h} i={i} j={j}")
                    assert np.all(want[want > 0] == np.float32(dropout.keep_scale))


@pytest.mark.parametrize("sq,skv,group,targets,want", [
    (4096, 4096, 4, (512, 1024), (256, 1024)),  # the 8B step: group * bq <= 1024
    (256, 256, 2, (128, 128), (128, 128)),
    (4096, 4096, 32, (512, 1024), (32, 1024)),  # MQA
    (384, 384, 1, (512, 1024), (128, 128)),
    (100, 100, 2, (512, 1024), (100, 100)),     # no plan: one block spans the sequence
    (96, 96, 2, (512, 1024), (96, 96)),         # bq would be 32, but no kv block divides 96
])
def test_dropout_plan_is_the_jax_plan(sq, skv, group, targets, want, interpret):
    assert tfa.dropout_plan(sq, skv, group, *targets) == want
    plan = jfa.flash_plan((1, sq, group, 64), (1, skv, 1, 64), JMaskInfo(causal=True), *targets)
    assert plan == (want if plan is not None else None)
    assert (plan is None) == (want == (sq, skv) and sq not in (128, 256, 512))


B, HQ, HKV, S = 1, 4, 2, 256
BQ = BK = 128  # a 2 x 2 grid of plan blocks
RATE = 0.3


def _qkv(seed, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, d)).astype(np.float32) * 0.5 for h in (HQ, HKV, HKV)]


def _masks(kind):
    if kind == "causal":
        return JMaskInfo(causal=True), MaskInfo(causal=True)
    prefix = np.array([100], np.int32)
    return (JMaskInfo(causal=True, prefix_len=jnp.asarray(prefix)),
            MaskInfo(causal=True, prefix_len=torch.from_numpy(prefix)))


@pytest.mark.parametrize("kind", ["causal", "prefix"])
@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
def test_dropout_forward_matches_the_jax_kernel(interpret, d, kind):
    q, k, v = _qkv(0, d)
    jmi, tmi = _masks(kind)
    key = jax.random.PRNGKey(7)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), jmi, block_q=BQ, block_kv=BK, dropout_rate=RATE,
                               dropout_rng=key)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), tmi, dropout_rate=RATE, dropout_seed=_jax_seed(key),
                              block_q=BQ, block_kv=BK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    # another seed gives another mask
    other = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), tmi, dropout_rate=RATE, dropout_seed=1,
                                block_q=BQ, block_kv=BK)
    assert float((other - got).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["causal", "prefix"])
@pytest.mark.parametrize("d", [64, 128], ids=["d64", "d128"])
def test_dropout_backward_matches_the_jax_kernel(interpret, d, kind):
    q, k, v = _qkv(1, d)
    ct = np.random.default_rng(2).standard_normal((B, S, HQ, d)).astype(np.float32)
    jmi, tmi = _masks(kind)
    key = jax.random.PRNGKey(3)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, jmi, block_q=BQ, block_kv=BK, dropout_rate=RATE, dropout_rng=key)
        return jnp.sum(out * ct)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, tmi, dropout_rate=RATE, dropout_seed=_jax_seed(key), block_q=BQ, block_kv=BK)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4, rtol=1e-3, err_msg=f"d{name}")


def _dense_dropout_attention(q, k, v, keep, keep_scale, mask):
    """softmax(masked logits) * keep / (1 - rate) @ v in plain differentiable torch."""
    Bq, Sq, Hq, D = q.shape
    group = Hq // k.shape[2]
    qf = q.reshape(Bq, Sq, k.shape[2], group, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k) / D**0.5
    logits = torch.where(mask[:, :, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1) * keep * keep_scale
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(Bq, Sq, Hq, D)


@pytest.mark.parametrize("S_odd,rate", [(100, 0.3), (37, 0.1)])
def test_unaligned_shapes_keep_the_rate_and_their_own_backward(S_odd, rate):
    """No block divides S: the JAX package has no plan there and draws its mask with
    ``jax.random.bernoulli``. The port keys the hash on one block that spans the
    sequence: the share it drops is the rate, and its backward is the gradient of its
    forward (held against autograd through a dense version with the same mask)."""
    from llama_x_tpu_torch.ops.attention import make_attention_mask

    Bq, Hq, Hkv, D = 2, 4, 2, 32
    dropout = tfa.make_dropout(rate, 99, S_odd, S_odd, Hq // Hkv)
    assert (dropout.bq, dropout.bk) == (S_odd, S_odd)
    wide = tfa.dropout_keep(tfa.make_dropout(rate, 99, 500, 500, 2), 2, 2, 2, 500, 500)
    assert abs(1.0 - float(wide.float().mean()) - rate) < 0.005  # 2M draws: 3 sigma is below 0.001
    g = torch.Generator().manual_seed(S_odd)
    base = [torch.randn(Bq, S_odd, h, D, generator=g) * 0.5 for h in (Hq, Hkv, Hkv)]
    ct = torch.randn(Bq, S_odd, Hq, D, generator=g)
    mi = MaskInfo(causal=True)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in base]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, ct)

    out, got = grads(lambda q, k, v: tfa.flash_attention(q, k, v, mi, dropout_rate=rate, dropout_seed=99))
    keep = tfa.dropout_keep(dropout, Bq, Hkv, Hq // Hkv, S_odd, S_odd)
    mask = make_attention_mask(mi, S_odd, S_odd, Bq)
    ref, want = grads(lambda q, k, v: _dense_dropout_attention(q, k, v, keep, dropout.keep_scale, mask))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-4)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4, rtol=1e-3, err_msg=f"d{name}")


def test_bf16_plain_versions_round_where_the_kernels_round():
    """In bf16 the plain forward multiplies f32 p by keep / (1 - rate) and THEN rounds
    for the PV product, and l sums the undropped p: held against an fp32 evaluation of the
    same mask within bf16's resolution of the output, and lse equal to the run without
    dropout bit for bit."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(5, 64))
    mi = MaskInfo(causal=True)
    dropout = tfa.make_dropout(RATE, 5, S, S, HQ // HKV, BQ, BK)
    out, lse = tfa.flash_fwd_plain(q, k, v, mi, dropout=dropout)
    _, lse0 = tfa.flash_fwd_plain(q, k, v, mi)
    assert torch.equal(lse, lse0)
    ref, _ = tfa.flash_fwd_plain(q.float(), k.float(), v.float(), mi, dropout=dropout)
    assert float((out.float() - ref).abs().max()) <= 2**-6 * float(ref.abs().max())


def _tiled_dropout_forward(q, k, v, mask, dropout, keep_fn=None, tile=64, descending=False):
    """The forward as the CUDA kernel walks it: kv tiles of ``tile`` under a running row
    max (first to last, or last to first as the wgmma kernel walks them), f32 p times
    keep / (1 - rate) rounded to bf16 per tile, the accumulator rescaled in f32.
    ``keep_fn`` edits the keep mask (to plant a fault)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qs = (q.float() * (D**-0.5 * 1.4426950408889634)).to(q.dtype)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs.reshape(B, Sq, Hkv, group, D).float(), k.float())
    s = torch.where(mask[:, :, None], s, torch.full_like(s, -1e30))
    keep = tfa.dropout_keep(dropout, B, Hkv, group, Sq, k.shape[1])
    keep = keep if keep_fn is None else keep_fn(keep)
    m = torch.full_like(s[..., :1], -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, group, Sq, D)
    starts = range(0, k.shape[1], tile)
    for j in reversed(starts) if descending else starts:
        st = s[..., j:j + tile]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        p = torch.where(keep[..., j:j + tile], p * dropout.keep_scale, torch.zeros_like(p))
        acc = alpha * acc + torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v[:, j:j + tile].float())
        m = m_new
    return (acc / l).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def _over_the_forward_limit(got, ref):
    atol, rtol = tfa.flash_fwd_tolerance(ref)
    return (got.float() - ref.float()).abs() - rtol * ref.float().abs() - atol > 0.0


@pytest.mark.parametrize("tile,descending", [(64, False), (128, True)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("fault", ["none", "one plan block", "keep scale"])
def test_forward_tolerance_passes_tiled_arithmetic_and_rejects_dropout_faults(fault, rate, tile, descending):
    """``flash_fwd_tolerance`` (the limit that holds K2 to its plain version on the card)
    at the audio step's proportions, a quarter of its size: S 1024, prefix-LM 500, plan
    bq 64, bk 256, so a plan block holds a quarter to a half of the keys its rows see. A
    forward that rounds p per kv tile at the running max, as the kernels do (64-key tiles
    first to last in the mma.sync design, 128-key tiles last to first in the wgmma one),
    stays inside the limit. The same forward with the keep mask of another seed on ONE plan
    block (the last q block, whose rows see the most keys, so the block weighs least)
    breaks it on more than a fifth of that block's elements and nowhere else; one that
    leaves out the keep scale breaks it on most elements."""
    from llama_x_tpu_torch.ops.attention import make_attention_mask

    Sx, bq, bk, Hq, Hkv, D = 1024, 64, 256, 2, 1, 64
    g = torch.Generator().manual_seed(int(rate * 10))
    q, k, v = (torch.randn(1, Sx, h, D, generator=g).bfloat16() for h in (Hq, Hkv, Hkv))
    mi = MaskInfo(causal=True, prefix_len=torch.tensor([500], dtype=torch.int32))
    dropout = tfa.make_dropout(rate, 77, Sx, Sx, Hq // Hkv, bq, bk)
    assert (dropout.bq, dropout.bk) == (bq, bk)
    ref, _ = tfa.flash_fwd_plain(q, k, v, mi, dropout=dropout)
    mask = make_attention_mask(mi, Sx, Sx, 1)
    rows, cols = slice(Sx - bq, Sx), slice(0, bk)

    def other_seed_on_one_block(keep):
        other = tfa.dropout_keep(dropout._replace(seed=78), 1, Hkv, Hq // Hkv, Sx, Sx)
        keep = keep.clone()
        keep[..., rows, cols] = other[..., rows, cols]
        return keep

    if fault == "keep scale":
        class Unscaled(tfa.Dropout):
            keep_scale = 1.0

        got = _tiled_dropout_forward(q, k, v, mask, Unscaled(*dropout), tile=tile, descending=descending)
    else:
        got = _tiled_dropout_forward(q, k, v, mask, dropout, other_seed_on_one_block if fault != "none" else None,
                                     tile=tile, descending=descending)
    over = _over_the_forward_limit(got, ref)
    if fault == "none":
        assert not over.any()
    elif fault == "one plan block":
        assert over[:, rows].float().mean() > 0.2
        assert not over[:, :Sx - bq].any()
    else:
        assert over.float().mean() > 0.5


def _model_pair(dtype=jnp.float32, **cfg):
    kw = dict(embed_dim=128, num_layers=2, head_dim=64, num_heads=2, num_kv_heads=1, intermediate_dim=256,
              vocab_size=128, max_seq_len=128, attn_dropout=0.1, **cfg)
    jcfg = jllama.tiny_config(attn_impl="flash", **kw)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=dtype)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**kw), device="cpu",
                            freeze_prefixes=())
    return params, jcfg, model


@pytest.mark.parametrize("remat", [None, "full", "flash_proj"])
def test_model_forward_with_the_jax_layer_seeds(interpret, remat):
    """``llama.forward`` with ``attn_dropout``: the JAX package splits its ``dropout_rng``
    per layer and each flash call draws a seed from its key; handed those seeds, the
    port gives the same loss (1e-5) and gradients (1e-4 of each tensor's largest entry),
    with and without checkpointing."""
    cfg = {} if remat is None else dict(activation_checkpointing=True, remat_policy=remat)
    params, jcfg, model = _model_pair(**cfg)
    tokens = np.random.default_rng(3).integers(0, 128, (1, 128)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    seeds = [_jax_seed(k) for k in jax.random.split(key, jcfg.num_layers)]

    def jloss(p):
        return jllama.forward(p, jcfg, jnp.asarray(tokens), labels=jnp.asarray(tokens), dropout_rng=key)

    want_loss, want = jax.value_and_grad(jloss)(params)
    t = torch.from_numpy(tokens).long()
    loss = tllama.forward(model, t, labels=t, dropout_seeds=seeds)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = named_tensors(model, grads=True)
    from llama_x_tpu.utils.tree import named_leaves

    for name, w in named_leaves(want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-7, err_msg=name)
    # dropout is live, and without seeds it is off whatever the config says
    plain = float(tllama.forward(model, t, labels=t).detach())
    assert abs(plain - float(loss.detach())) > 1e-4
    assert plain == pytest.approx(float(jllama.forward(params, jcfg, jnp.asarray(tokens), labels=jnp.asarray(tokens))),
                                  rel=1e-5)


def test_layer_seeds_from_a_generator_or_a_sequence():
    gen = torch.Generator().manual_seed(4)
    seeds = tllama.layer_seeds(gen, 3)
    assert len(seeds) == 3 and len(set(seeds)) == 3 and all(0 <= s < 2**31 for s in seeds)
    assert tllama.layer_seeds(torch.Generator().manual_seed(4), 3) == seeds
    assert tllama.layer_seeds(torch.tensor([5, 6]), 2) == [5, 6]
    assert tllama.layer_seeds(None, 2) == [None, None]
    with pytest.raises(ValueError, match="dropout seeds"):
        tllama.layer_seeds([1, 2, 3], 2)
