"""The flash forward's offsets form over a KV cache (K2's, ``ops/flash_attention.py``)
against the JAX package, on the CPU: ``flash_fwd_offsets_plain`` against the JAX kernel
``_fwd(offsets=)`` run in the Pallas interpreter, against the port's own
``dot_product_attention`` with causal ``q_positions`` and per-row ``kv_len``, and its
int8 wrapper against the JAX package's ``dequant_kv``; ``tile_class`` with the diagonal
shifted by the offsets and kv_len cutting the tiles, tile by tile against the mask that
the kernel mirrors.

Tolerances: fp32 out and lse against the JAX kernel 2e-5 absolute + 1e-4 relative (f32
sums in another order); against the plain attention 1e-5 (the same logits, exp2 against
exp); the int8 wrapper against the plain version over the JAX package's dequantized
cache, bit for bit (the same bf16 values through the same arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.ops import flash_attention as tfa
from llama_x_tpu_torch.ops.attention import MaskInfo, dot_product_attention

torch.set_num_threads(2)


@pytest.fixture
def interpret():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _ints(xs):
    return torch.tensor(xs, dtype=torch.int32)


def _case(seed, B, Sq, Hq, Hkv, D, Skv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("q_off,kv_off", [(0, 0), (128, 0), (192, 64), (512, 256)])
@pytest.mark.parametrize("D", [64, 128])
def test_offsets_plain_matches_the_jax_kernel(interpret, q_off, kv_off, D):
    """The JAX kernel's scalar (q_offset, kv_offset) pair, with kv_len the whole cache:
    the case where every row has the same offsets. Every query sees at least one key."""
    B, Sq, Hq, Hkv, Skv = 2, 128, 4, 2, 256
    q, k, v = _case(D + q_off, B, Sq, Hq, Hkv, D, Skv)
    scale = 1.0 / np.sqrt(D)
    out, lse = jfa._fwd(jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k), jnp.asarray(v), None, None, None,
                        scale=scale, causal=True, bq=64, bk=128,
                        offsets=jnp.asarray([[q_off, kv_off]], jnp.int32))
    got, got_lse = tfa.flash_fwd_offsets_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                               _ints([q_off] * B), _ints([kv_off] * B), _ints([Skv] * B), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(out).transpose(0, 2, 1, 3), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("q_off,kv_len", [([40, 3], [60, 20]), ([0, 100], [20, 130]), ([7, 7], [27, 64])])
def test_offsets_plain_matches_the_plain_attention(q_off, kv_len):
    """Per-row q_offset and kv_len over a [B, Hkv, S_max, D] cache: the same function as
    the plain attention with q_positions = q_offset + i and kv_len (kv_offset 0: cache entry
    j holds position j), which is what the model's read of the cache computes on the CPU."""
    B, Sq, Hq, Hkv, D, S_max = 2, 20, 4, 2, 16, 160
    q, k, v = (torch.from_numpy(a) for a in _case(1, B, Sq, Hq, Hkv, D, S_max))
    qo, lens = _ints(q_off), _ints(kv_len)
    got, lse = tfa.flash_fwd_offsets(q, k, v, qo, torch.zeros_like(qo), lens)  # the CPU wrapper: the plain version
    mi = MaskInfo(causal=True, q_positions=qo[:, None] + torch.arange(Sq), kv_len=lens)
    want = dot_product_attention(q, k.transpose(1, 2), v.transpose(1, 2), mi)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert lse.shape == (B, Hq, Sq, 1) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("shift,kv_end,Sq", [(0, 256, 256), (100, 300, 50), (512, 700, 200), (1536, 2048, 512),
                                             (513, 522, 9), (-30, 90, 70)])
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 128), (64, 64)])
def test_tile_class_with_offsets_matches_the_mask(shift, kv_end, Sq, bq, bk):
    """Tile by tile: "skip" only where no element is visible, "full" only where every
    element is, and a tile that kv_len cuts is never full; tiles at or past kv_len skip."""
    S_kv = kv_end + 200  # the cache runs on past kv_len
    mask = tfa.offsets_mask(_ints([shift]), _ints([0]), _ints([kv_end]), Sq, S_kv)[0]
    counts = {"skip": 0, "partial": 0, "full": 0}
    for q0 in range(0, Sq, bq):
        for kv0 in range(0, S_kv, bk):
            cls = tfa.tile_class(q0, kv0, bq, bk, Sq, True, None, None, None, q_offset=shift, kv_end=kv_end)
            tile = mask[q0:q0 + bq, kv0:kv0 + bk]
            whole = tile.shape == (bq, bk) and bool(tile.all())
            assert cls != "skip" or not bool(tile.any()), (q0, kv0)
            assert cls != "full" or whole, (q0, kv0)
            if kv0 >= kv_end:
                assert cls == "skip"
            if kv0 < kv_end < kv0 + bk:
                assert cls != "full"
            if whole:  # the kernel runs such a tile without mask code
                assert cls == "full", (q0, kv0)
            counts[cls] += 1
    assert counts["partial"] > 0


@pytest.mark.parametrize("kv_len", [[37, 64], [64, 64]])
def test_offsets_int8_matches_the_jax_dequant(kv_len):
    """The int8 cache: the wrapper dequantizes the live prefix to bf16 as the JAX package's
    ``dequant_kv`` does (data * scale, rounded to bf16 once), then attends."""
    B, Sq, Hq, Hkv, D, S_max = 2, 12, 4, 2, 16, 96
    q, k, v = _case(2, B, Sq, Hq, Hkv, D, S_max)
    k8, ks = tllama.quantize_kv_rows(torch.from_numpy(k))
    v8, vs = tllama.quantize_kv_rows(torch.from_numpy(v))
    n = max(kv_len)
    for data, scale in ((k8, ks), (v8, vs)):
        want = np.asarray(jllama.dequant_kv((jnp.asarray(data.numpy()), jnp.asarray(scale.numpy())))[:, :, :n])
        got = tfa.dequant_live(data, scale, n)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    qt = torch.from_numpy(q).to(torch.bfloat16)
    qo, lens = _ints([n - Sq, kv_len[1] - Sq]), _ints(kv_len)
    got, got_lse = tfa.flash_fwd_offsets_int8(qt, k8, ks, v8, vs, qo, torch.zeros_like(qo), lens, n)
    kd, vd = (torch.from_numpy(np.asarray(jllama.dequant_kv((jnp.asarray(a.numpy()), jnp.asarray(s.numpy()))),
                                          np.float32)).to(torch.bfloat16) for a, s in ((k8, ks), (v8, vs)))
    want, want_lse = tfa.flash_fwd_offsets_plain(qt, kd, vd, qo, torch.zeros_like(qo), lens)
    assert torch.equal(got, want) and torch.equal(got_lse, want_lse)
