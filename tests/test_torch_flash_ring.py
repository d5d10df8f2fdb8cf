"""K2's ring form and K5's offsets form (``ops/flash_attention.py``: ``flash_fwd_ring`` /
``flash_bwd_ring``) against the JAX kernels on the CPU: the plain versions against
``_fwd(offsets=)`` and ``_bwd(offsets=, delta=, cast=False)`` run in the Pallas
interpreter, at every (my, kv_idx) pair of a ring of 2 and of 4, under causal, non-causal,
packed-document, prefix-LM and document + prefix masks, with prefixes that cross a shard
boundary (as tests/test_ring_attention.py:146 has it); the backward from the ring's final
merged out / lse and one delta, as ring attention calls it. ``tile_class`` with both offsets,
tile by tile, against the block mask it mirrors.

Tolerances (fp32, the JAX ring tests' own): out and lse 2e-5 absolute + 1e-4 relative (f32
sums in another order), gradients 5e-4 + 1e-3. A row that sees no key of a block is
compared on its lse alone (about -1e30 ln2 on both sides): its out is weighed by exactly 0
in the lse merge, and the kernels leave what their tiling gives there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu_torch.ops import flash_attention as tfa
from llama_x_tpu_torch.ops.attention import MaskInfo

torch.set_num_threads(2)

B, S, HQ, HKV, D = 2, 64, 4, 2, 64
BQ = BK = 32


@pytest.fixture
def interpret():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _inputs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n * S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, n * S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, n * S, HKV, D)).astype(np.float32)
    do = rng.standard_normal((B, n * S, HQ, D)).astype(np.float32)
    seg = np.sort(rng.integers(1, 2 + 2 * n, (B, n * S)), axis=1).astype(np.int32)
    return q, k, v, do, seg


MASKS = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "doc": dict(causal=True, seg=True),
    "prefix": dict(causal=True, prefix=True),
    "doc+prefix": dict(causal=True, seg=True, prefix=True),
}


def _prefix(n: int) -> np.ndarray:
    # row 0: past the first shard boundary (into the second shard); row 1: inside the first
    return np.asarray([S + S // 2 + 3, S // 2 - 5], np.int32) if n == 2 else np.asarray([2 * S + 11, S + 9], np.int32)


def _shard(x, i):
    return np.ascontiguousarray(x[:, i * S:(i + 1) * S])


@functools.lru_cache(maxsize=None)
def _jax_fns(causal: bool, has_seg: bool, has_prefix: bool):
    scale = 1.0 / np.sqrt(D)

    @jax.jit
    def fwd(q, k, v, qseg, kseg, prefix, offs):
        return jfa._fwd(q, k, v, qseg if has_seg else None, kseg if has_seg else None,
                        prefix if has_prefix else None, scale=scale, causal=causal, bq=BQ, bk=BK, offsets=offs)

    @jax.jit
    def bwd(q, k, v, qseg, kseg, prefix, out, lse, do, delta, offs):
        return jfa._bwd(q, k, v, qseg if has_seg else None, kseg if has_seg else None,
                        prefix if has_prefix else None, out, lse, do, scale=scale, causal=causal, bq=BQ, bk=BK,
                        offsets=offs, delta=delta, cast=False)

    return fwd, bwd


def _t(x):  # model layout [B, S, H, D] -> the JAX kernels' [B, H, S, D]
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mask", list(MASKS))
def test_ring_forms_match_the_jax_kernels_at_every_ring_pair(interpret, n, mask):
    spec = MASKS[mask]
    q, k, v, do, seg = _inputs(n, 7 * n + len(mask))
    prefix = _prefix(n) if spec.get("prefix") else None
    fwd, bwd = _jax_fns(spec["causal"], bool(spec.get("seg")), prefix is not None)
    dummy = jnp.zeros((B, 1, 1), jnp.int32)
    # the ring's final out / lse of each q shard: the whole sequence's attention (every row
    # sees at least itself under these masks)
    full_mi = MaskInfo(causal=spec["causal"], segment_ids=torch.from_numpy(seg) if spec.get("seg") else None,
                       prefix_len=None if prefix is None else torch.from_numpy(prefix))
    out_full, lse_full = tfa.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), full_mi)
    for my in range(n):
        qs, dos = _shard(q, my), _shard(do, my)
        out_my = out_full[:, my * S:(my + 1) * S].contiguous()
        lse_my = lse_full[:, :, my * S:(my + 1) * S].contiguous()
        delta = (torch.from_numpy(dos) * out_my).sum(-1).transpose(1, 2).contiguous()  # [B, Hq, S]
        for kv_idx in range(n):
            ks, vs = _shard(k, kv_idx), _shard(v, kv_idx)
            qseg, kseg = (_shard(seg, my), _shard(seg, kv_idx)) if spec.get("seg") else (None, None)
            mi = MaskInfo(causal=spec["causal"],
                          segment_ids=None if qseg is None else torch.from_numpy(qseg),
                          kv_segment_ids=None if kseg is None else torch.from_numpy(kseg),
                          prefix_len=None if prefix is None else torch.from_numpy(prefix))
            offs = jnp.asarray([[my * S, kv_idx * S]], jnp.int32)
            jq = jnp.asarray(qseg.reshape(B, S, 1)) if qseg is not None else dummy
            jk = jnp.asarray(kseg.reshape(B, 1, S)) if kseg is not None else dummy
            jp = jnp.asarray(prefix.reshape(B, 1)) if prefix is not None else jnp.zeros((B, 1), jnp.int32)
            tag = f"{mask} ring {n} (my {my}, kv {kv_idx})"

            want_out, want_lse = fwd(_t(qs), _t(ks), _t(vs), jq, jk, jp, offs)
            got_out, got_lse = tfa.flash_fwd_ring(*(torch.from_numpy(x) for x in (qs, ks, vs)), mi, my * S,
                                                  kv_idx * S)
            seen = tfa.ring_block_mask(mi, B, S, my * S, kv_idx * S)
            seen = np.ones((B, S), bool) if seen is None else seen[:, 0].any(-1).numpy()
            np.testing.assert_allclose(got_out.numpy()[seen], np.asarray(want_out).transpose(0, 2, 1, 3)[seen],
                                       atol=2e-5, rtol=1e-4, err_msg=tag)
            np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=2e-5, rtol=1e-4, err_msg=tag)

            wdq, wdk, wdv = bwd(_t(qs), _t(ks), _t(vs), jq, jk, jp, _t(out_my.numpy()), jnp.asarray(lse_my.numpy()),
                                _t(dos), jnp.asarray(delta.numpy()[..., None]), offs)
            acc = [torch.zeros(x.shape) for x in (qs, ks, vs)]
            tfa.flash_bwd_ring(*(torch.from_numpy(x) for x in (qs, ks, vs)), out_my, lse_my, torch.from_numpy(dos),
                               delta, acc, mi, my * S, kv_idx * S)
            for name, got, want in zip(("dq", "dk", "dv"), acc, (wdq, wdk, wdv)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3), atol=5e-4, rtol=1e-3,
                                           err_msg=f"{tag} {name}")


def test_ring_backward_blocks_add_up_to_the_whole_gradient():
    """The offsets form's accumulation over a ring's kv blocks gives the plain backward
    of the whole sequence: dq of each q shard summed over the blocks, dk / dv of each kv
    block summed over the q shards (fp32: 1e-5)."""
    n = 4
    q, k, v, do, seg = _inputs(n, 3)
    prefix = _prefix(n)
    mi_full = MaskInfo(causal=True, segment_ids=torch.from_numpy(seg), prefix_len=torch.from_numpy(prefix))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tfa.flash_fwd_plain(tq, tk, tv, mi_full)
    want = tfa.flash_bwd_plain(tq, tk, tv, out, lse, tdo, mi_full)
    dq, dk, dv = torch.zeros(q.shape), torch.zeros(k.shape), torch.zeros(v.shape)
    delta = (tdo * out).sum(-1).transpose(1, 2)
    for my in range(n):
        r = slice(my * S, (my + 1) * S)
        for kv in range(n):
            c = slice(kv * S, (kv + 1) * S)
            mi = MaskInfo(causal=True, segment_ids=torch.from_numpy(seg[:, r]),
                          kv_segment_ids=torch.from_numpy(seg[:, c]), prefix_len=torch.from_numpy(prefix))
            acc = [torch.zeros(q[:, r].shape), torch.zeros(k[:, c].shape), torch.zeros(v[:, c].shape)]
            tfa.flash_bwd_ring(tq[:, r], tk[:, c], tv[:, c], out[:, r], lse[:, :, r].contiguous(), tdo[:, r],
                               delta[:, :, r].contiguous(), acc, mi, my * S, kv * S)
            dq[:, r] += acc[0]
            dk[:, c] += acc[1]
            dv[:, c] += acc[2]
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("q_off,kv_off", [(0, 0), (256, 0), (256, 256), (0, 256), (512, 128), (128, 512)])
@pytest.mark.parametrize("mask", ["causal", "noncausal", "doc", "prefix", "doc+prefix"])
@pytest.mark.parametrize("tile", [(64, 64), (128, 128), (64, 128)])
def test_tile_class_with_both_offsets_matches_the_block_mask(q_off, kv_off, mask, tile):
    """Every tile of a 256-position block: "skip" only where the block mask (global
    positions) is all False, "full" only where it is all True; the causal shift alone
    makes a block above the diagonal all skip and one below it all full."""
    Sl, (bq, bk) = 256, tile
    spec = MASKS[mask]
    rng = np.random.default_rng(q_off + kv_off)
    seg = np.sort(rng.integers(1, 6, (1, 1024)), axis=1).astype(np.int32)
    qs, ks = seg[:, q_off:q_off + Sl], seg[:, kv_off:kv_off + Sl]
    prefix = 300 if spec.get("prefix") else None
    mi = MaskInfo(causal=spec["causal"], segment_ids=torch.from_numpy(qs) if spec.get("seg") else None,
                  kv_segment_ids=torch.from_numpy(ks) if spec.get("seg") else None,
                  prefix_len=None if prefix is None else torch.tensor([prefix]))
    m = tfa.ring_block_mask(mi, 1, Sl, q_off, kv_off)
    m = torch.ones(Sl, Sl, dtype=torch.bool) if m is None else m[0, 0]
    classes = set()
    for q0 in range(0, Sl, bq):
        for kv0 in range(0, Sl, bk):
            qr = (int(qs[0, q0:q0 + bq].min()), int(qs[0, q0:q0 + bq].max())) if spec.get("seg") else None
            kr = (int(ks[0, kv0:kv0 + bk].min()), int(ks[0, kv0:kv0 + bk].max())) if spec.get("seg") else None
            cls = tfa.tile_class(q0, kv0, bq, bk, Sl, spec["causal"], prefix, qr, kr, q_offset=q_off, kv_offset=kv_off)
            t = m[q0:q0 + bq, kv0:kv0 + bk]
            classes.add(cls)
            if cls == "skip":
                assert not bool(t.any()), (q0, kv0)
            if cls == "full":
                assert bool(t.all()), (q0, kv0)
    if mask == "causal" and q_off + Sl <= kv_off:
        assert classes == {"skip"}
    if mask == "causal" and q_off >= kv_off + Sl:
        assert classes == {"full"}


def test_ring_form_refuses_a_lone_kv_segment():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="kv_segment_ids"):
        tfa.flash_fwd_ring(q, q[:, :, :1], q[:, :, :1], MaskInfo(causal=True, segment_ids=torch.zeros(1, 8)), 0, 0)
