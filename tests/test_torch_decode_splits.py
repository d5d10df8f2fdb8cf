"""K3's split-KV arithmetic on the CPU: the split planner (``decode_split_plan``) and the
plain version of the kernel's split arithmetic (``decode_attention_split_plain``: per-split
(m, l, acc), merged in split order) against the unsplit plain version and against the JAX
package's ``decode_attention`` / ``decode_attention_int8`` with the Pallas kernel in
interpret mode (as test_torch_attention.py runs it). The kernel itself against these on
the card: test_torch_kernels.py.

Tolerance: K3's, per element 4e-3 + 2^-7 |ref| (bf16 out; P rounded to bf16 at a split's
max instead of the row's), which a window one position off misses (test_torch_attention.py:
test_decode_tolerance_sees_window_faults). In fp32 nothing is rounded between the two
forms, and the split form agrees with the unsplit one to 1e-5."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.ops import decode_attention as jda
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(2)

K3_ATOL, K3_RTOL = 4e-3, 2**-7


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jda, "INTERPRET", True)


@pytest.mark.parametrize("S_max", [64, 100, 512, 1000, 4096, 8192])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("Hkv", [1, 2, 8])
def test_split_plan_covers_the_cache_once(S_max, B, Hkv):
    """Every position of the cache lies in exactly one split; each split is a whole
    number of the kernel's 64-position tiles and starts inside the cache."""
    splits, split_len = tda.decode_split_plan(S_max, B, Hkv)
    assert split_len > 0 and split_len % tda.SPLIT_TILE == 0
    covered = np.zeros(S_max, dtype=np.int64)
    for i in range(splits):
        start, end = i * split_len, min((i + 1) * split_len, S_max)
        assert start < end
        covered[start:end] += 1
    assert (covered == 1).all()
    # as many CTAs as the target asks for, unless the cache has fewer tiles than that
    tiles = math.ceil(S_max / tda.SPLIT_TILE)
    assert splits * B * Hkv >= min(tda.TARGET_CTAS, tiles * B * Hkv) // 2


def test_split_plan_fills_the_card_at_the_serving_shape():
    """B 4, 8 kv heads, S_max 4096 (the 8B serving cache): at least two CTAs per SM of
    an H100, from the shapes alone."""
    splits, split_len = tda.decode_split_plan(4096, 4, 8)
    assert splits * 4 * 8 >= 2 * 132
    assert splits * split_len >= 4096


def _staircase(last, Sq):
    """[B, Sq] windows: query i of row b sees last_b - (Sq - 1) + i positions (at least 1)."""
    return np.maximum(np.asarray(last, np.int32)[:, None] - (Sq - 1) + np.arange(Sq, dtype=np.int32)[None, :], 1)


def _inputs(seed, B, Sq, Hq, Hkv, S_max, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S_max, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S_max, D)).astype(np.float32))


def _excess(got, want):
    return float(((got.double() - want.double()).abs() - K3_RTOL * want.double().abs()).max())


# windows one position either side of a split edge (split_len 128), and a batch row whose
# windows all end before the second split while the others run past it
WINDOWS = [(127, 128, 129), (40, 300, 512)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Sq", [1, 5, 8])
@pytest.mark.parametrize("last", WINDOWS)
def test_split_plain_matches_the_jax_kernel(interpret, quantized, Sq, last):
    """fp32: 4 splits of 128 over S_max 512, merged, against the Pallas decode kernel
    (interpreted) within K3's tolerance, and against the unsplit plain version to 1e-5."""
    B, Hq, Hkv, S_max, D = 3, 8, 2, 512, 128
    q, k, v = _inputs(Sq + 10 * int(quantized), B, Sq, Hq, Hkv, S_max, D)
    lens = _staircase(last, Sq)
    scale = 1.0 / math.sqrt(D)
    tq, tl = torch.from_numpy(q), torch.from_numpy(lens)
    if quantized:
        jk8, jks = jllama.quantize_kv_rows(jnp.asarray(k))
        jv8, jvs = jllama.quantize_kv_rows(jnp.asarray(v))
        want = jda.decode_attention_int8(jnp.asarray(q), jk8, jks, jv8, jvs, jnp.asarray(lens), scale)
        k8, ks, v8, vs = (torch.from_numpy(np.array(a)) for a in (jk8, jks, jv8, jvs))
        tk, tv = tda.dequant_in(k8, ks, tq.dtype), tda.dequant_in(v8, vs, tq.dtype)
    else:
        want = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), scale)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = tda.decode_attention_split_plain(tq, tk, tv, tl, scale, 4, 128)
    assert got.shape == (B, Sq, Hq, D)
    assert _excess(got, torch.from_numpy(np.array(want))) <= K3_ATOL
    np.testing.assert_allclose(got.numpy(), tda.decode_attention_plain(tq, tk, tv, tl, scale).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Sq", [1, 5, 8])
@pytest.mark.parametrize("last", WINDOWS)
def test_split_plain_matches_the_plain_version_in_bf16(quantized, Sq, last):
    """bf16 with the planner's own splits (S_max 512 at B 3, 2 kv heads: 64-position
    ranges) and 64 query rows (Sq 8 x group 8 at its largest): the split form within K3's
    tolerance of the unsplit plain version, P rounded at each split's max."""
    B, Hkv, S_max, D = 3, 2, 512, 128
    Hq = Hkv * (8 if Sq == 8 else 4)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(Sq, B, Sq, Hq, Hkv, S_max, D))
    lens = torch.from_numpy(_staircase(last, Sq))
    scale = 1.0 / math.sqrt(D)
    splits, split_len = tda.decode_split_plan(S_max, B, Hkv)
    assert splits > 1
    if quantized:
        (k8, ks), (v8, vs) = tllama.quantize_kv_rows(k), tllama.quantize_kv_rows(v)
        k, v = tda.dequant_in(k8, ks, q.dtype), tda.dequant_in(v8, vs, q.dtype)
    got = tda.decode_attention_split_plain(q, k, v, lens, scale, splits, split_len)
    want = tda.decode_attention_plain(q, k, v, lens, scale)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _excess(got, want) <= K3_ATOL


def test_split_plain_sees_a_wrong_merge():
    """The merge's weights e^(m_i - M) matter: summing the splits' acc and l unweighted
    misses K3's tolerance by far, so the comparison above would catch a kernel that
    dropped them."""
    B, Sq, Hq, Hkv, S_max, D = 3, 1, 8, 2, 512, 128
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, B, Sq, Hq, Hkv, S_max, D))
    q = q * 4  # sharper rows: the splits' maxima differ by several units
    lens = torch.from_numpy(_staircase((300, 400, 512), Sq))
    scale = 1.0 / math.sqrt(D)
    want = tda.decode_attention_plain(q, k, v, lens, scale)
    qf = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bhkd->bhqgk", qf, k) * scale
    s = torch.where(torch.arange(S_max)[None, None, None, None, :] < lens[:, None, :, None, None], s,
                    torch.full_like(s, -1e30))
    acc = l = 0
    for a in range(0, S_max, 128):  # each split's own (l, acc) at its own max, merged without weights
        p = torch.exp(s[..., a:a + 128] - s[..., a:a + 128].amax(dim=-1, keepdim=True))
        acc = acc + torch.einsum("bhqgk,bhkd->bhqgd", p, v[:, :, a:a + 128])
        l = l + p.sum(dim=-1, keepdim=True)
    wrong = (acc / l).permute(0, 2, 1, 3, 4).reshape(B, Sq, Hq, D)
    assert _excess(wrong, want) > 5 * K3_ATOL
