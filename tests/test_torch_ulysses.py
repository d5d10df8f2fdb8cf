"""Ulysses (``parallel/ulysses.py``) on the CPU against the JAX package: ``_kv_repeat`` and
``ulysses_supported`` over a grid of geometries, and ``ulysses_attention`` in 2 and 4 gloo
processes against the JAX ``ulysses_attention`` on a cp mesh of the 8-device CPU
simulation, forward and gradients, with the JAX side on its plain attention (``impl="xla"``)
and on the interpreted Pallas kernels; the port's local attention is K2 / K5 in their
normal form (their plain versions on CPU tensors). Four masks, GQA with kv heads repeated
(Hkv 2 over cp 4).

Tolerances (fp32): out 2e-5 absolute + 1e-4 relative, gradients 5e-4 + 1e-3. The ranks
run in subprocesses that import no JAX (tests/torch_dist_workers.py), with a file store
under the test's directory and a timeout of their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu.ops.attention import MaskInfo as JMaskInfo
from llama_x_tpu.parallel import ulysses as jul
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.parallel import ulysses as tul
from torch_dist_workers import run_ranks

B, HQ, HKV, D, S_LOCAL = 2, 8, 2, 64, 64


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
def test_kv_repeat_and_supported_match_jax(n):
    for hq in (4, 8, 12, 32, 64):
        for hkv in (1, 2, 4, 8):
            if hq % hkv:
                continue
            assert tul._kv_repeat(hq, hkv, n) == jul._kv_repeat(hq, hkv, n), (hq, hkv, n)
            for S in (n * 64, n * 64 + 1):
                for pos in (False, True):
                    tmi = MaskInfo(causal=True, q_positions=torch.arange(S) if pos else None)
                    jmi = JMaskInfo(causal=True, q_positions=jnp.arange(S) if pos else None)
                    assert tul.ulysses_supported(S, hq, hkv, n, tmi) == jul.ulysses_supported(S, hq, hkv, n, jmi)


def _mesh_cp(n):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("cp",))


def _case(n: int, mask: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    S = n * S_LOCAL
    mk = lambda *shape: (rng.standard_normal(shape) * 0.5).astype(np.float32)
    case = dict(q=mk(B, S, HQ, D), k=mk(B, S, HKV, D), v=mk(B, S, HKV, D), do=mk(B, S, HQ, D),
                causal=mask != "noncausal", seg=None, prefix=None)
    if "doc" in mask:
        case["seg"] = np.sort(rng.integers(1, 2 + 2 * n, (B, S)), axis=1).astype(np.int32)
    if "prefix" in mask:
        case["prefix"] = np.asarray([S_LOCAL + 21, S_LOCAL // 2 - 3], np.int32)
    return case


def _jax_reference(n: int, impl: str, causal: bool):
    """The JAX Ulysses out and input gradients, jitted once per (n, impl, causal): segment
    ids and prefix lengths are data (all-equal ids and a prefix of 0 mask nothing)."""
    mesh = _mesh_cp(n)

    @jax.jit
    def f(q, k, v, seg, prefix, do):
        mi = JMaskInfo(causal=causal, segment_ids=seg, prefix_len=prefix)
        out, vjp = jax.vjp(lambda q, k, v: jul.ulysses_attention(q, k, v, mesh, mi, impl=impl), q, k, v)
        return (out, *vjp(do))

    def run(case):
        S = case["q"].shape[1]
        seg = case["seg"] if case["seg"] is not None else np.ones((B, S), np.int32)
        prefix = case["prefix"] if case["prefix"] is not None else np.zeros((B,), np.int32)
        return [np.asarray(t) for t in f(*(jnp.asarray(case[x]) for x in "qkv"), jnp.asarray(seg),
                                          jnp.asarray(prefix), jnp.asarray(case["do"]))]

    return run


@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_in_gloo_processes_matches_jax(tmp_path, n):
    cases, want = [], []
    for impl, masks in (("xla", ["causal", "noncausal", "doc", "prefix", "doc+prefix"]), ("flash", ["doc+prefix"])):
        jfa.INTERPRET = impl == "flash"
        try:
            refs = {}
            for j, mask in enumerate(masks):
                case = _case(n, mask, 20 * n + j)
                if case["causal"] not in refs:
                    refs[case["causal"]] = _jax_reference(n, impl, case["causal"])
                want.append(refs[case["causal"]](case))
                cases.append(dict(case, attn="ulysses", impl=impl, tag=f"{impl} {mask}"))
        finally:
            jfa.INTERPRET = False
    ranks = run_ranks(dict(kind="attention", world=n, mesh=dict(cp=n), cases=cases), tmp_path)
    for c, case in enumerate(cases):
        got = [np.concatenate([r[c][key] for r in ranks], axis=1) for key in ("out", "dq", "dk", "dv")]
        np.testing.assert_allclose(got[0], want[c][0], atol=2e-5, rtol=1e-4, err_msg=case["tag"])
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[c][1:]):
            np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3, err_msg=f"{case['tag']} {name}")


def test_ulysses_refuses_an_unscatterable_geometry():
    from llama_x_tpu_torch.parallel.mesh import Mesh as TMesh

    mesh = TMesh({"dp": 1, "fsdp": 1, "pp": 1, "cp": 3, "tp": 1}, 0, None)
    q = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="divisible"):
        tul.ulysses_attention(q, q[:, :, :2], q[:, :, :2], mesh, MaskInfo(causal=True))
