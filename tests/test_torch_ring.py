"""Ring attention (``ops/ring_attention.py`` through ``parallel/context.py``) in 2 and 4
gloo processes on the CPU against the JAX package's ``context_parallel_attention`` on a cp
mesh of the 8-device CPU simulation (tests/conftest.py), forward and gradients: the port's
plain ring (``impl="xla"``) against the JAX plain ring over five masks, and the port's ring
on K2's ring form and K5's offsets form (``impl="flash"``, their plain versions on CPU
tensors) against the JAX ring on the interpreted Pallas kernels. Each rank holds its slice
of the sequence; the slices are put back together here.

Tolerances (fp32, the JAX ring tests' own): out 2e-5 absolute + 1e-4 relative, gradients
5e-4 + 1e-3. The ranks run in subprocesses that import no JAX (tests/torch_dist_workers.py),
with a file store under the test's directory and a timeout of their own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu.ops.attention import MaskInfo as JMaskInfo
from llama_x_tpu.parallel.context import context_parallel_attention
from torch_dist_workers import run_ranks

B, HQ, HKV, D, S_LOCAL = 2, 4, 2, 64, 128


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
    if "prefix" in mask:  # one prefix crosses a shard boundary, one stays inside the first shard
        case["prefix"] = np.asarray([S_LOCAL + 37, S_LOCAL // 2 - 3], np.int32)
    return case


def _jax_reference(n: int, impl: str, causal: bool):
    """The JAX ring's out and input gradients, jitted once per (n, impl, causal): segment
    ids and prefix lengths are data (all-equal ids and a prefix of 0 mask nothing), so one
    compiled function serves every causal mask."""
    mesh = _mesh_cp(n)

    @jax.jit
    def f(q, k, v, seg, prefix, do):
        mi = JMaskInfo(causal=causal, segment_ids=seg, prefix_len=prefix)
        out, vjp = jax.vjp(lambda q, k, v: context_parallel_attention(q, k, v, mesh, mi, impl=impl), q, k, v)
        return (out, *vjp(do))

    def run(case):
        S = case["q"].shape[1]
        seg = case["seg"] if case["seg"] is not None else np.ones((B, S), np.int32)
        prefix = case["prefix"] if case["prefix"] is not None else np.zeros((B,), np.int32)
        return [np.asarray(t) for t in f(*(jnp.asarray(case[x]) for x in "qkv"), jnp.asarray(seg),
                                          jnp.asarray(prefix), jnp.asarray(case["do"]))]

    return run


XLA_MASKS = ["causal", "noncausal", "doc", "prefix", "doc+prefix"]
FLASH_MASKS = ["causal", "doc+prefix"]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_in_gloo_processes_matches_jax_context_parallel_attention(tmp_path, n):
    cases, want = [], []
    for impl, masks in (("xla", XLA_MASKS), ("flash", FLASH_MASKS)):
        jfa.INTERPRET = impl == "flash"
        try:
            refs = {}
            for j, mask in enumerate(masks):
                case = _case(n, mask, 10 * n + j)
                if case["causal"] not in refs:
                    refs[case["causal"]] = _jax_reference(n, impl, case["causal"])
                want.append(refs[case["causal"]](case))
                cases.append(dict(case, attn="ring", impl=impl, tag=f"{impl} {mask}"))
        finally:
            jfa.INTERPRET = False
    ranks = run_ranks(dict(kind="attention", world=n, mesh=dict(cp=n), cases=cases), tmp_path)
    for c, case in enumerate(cases):
        got = [np.concatenate([r[c][key] for r in ranks], axis=1) for key in ("out", "dq", "dk", "dv")]
        np.testing.assert_allclose(got[0], want[c][0], atol=2e-5, rtol=1e-4, err_msg=case["tag"])
        for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[c][1:]):
            np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3, err_msg=f"{case['tag']} {name}")
