"""The port's remat policies on the CPU.

Named-save policies ("dots", "dots_flash", "flash", "flash_qkv", "flash_proj") change
memory and time, never a value: loss and every gradient equal those of "full" bit for
bit, and counters on the wrappers of K1 and K2 (which run their plain versions on CPU
tensors) show what the recompute no longer launches. The q8 policies perturb only the
backward's view of h1 (and h3): held against the JAX package under the same policy (the
same int8 round trip on both sides: 3e-3 of each tensor's largest entry) and, as
tests/test_model_parity.py:140-167 bounds them, within 3% of each tensor's largest entry
of the "flash_proj" gradients. ``linear_vjp``, the direct backward they are built on,
is held against autograd through the real forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.ops import flash_attention as tfa
from llama_x_tpu_torch.ops import int8_mm as tmm
from llama_x_tpu_torch.ops import remat as rm
from llama_x_tpu_torch.ops.linear import Linear, apply_linear, linear_vjp

torch.set_num_threads(2)

NAMED = ["dots", "dots_flash", "flash", "flash_qkv", "flash_proj"]
Q8 = ["flash_q8", "flash_qkv_q8", "flash_proj_q8", "flash_q8s", "flash_qkv_q8s", "flash_proj_q8s"]
L = 2


def _pair(mode: str, seed=0):
    """(JAX params, JAX config, JAX mask, port model): "float" (fp32, everything
    trains) or "qlora" (int8 base with int8 activations and input gradients, LoRA with
    live lora_b, embeddings / head / final norm frozen)."""
    kw = dict(max_seq_len=64, num_layers=L)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True)
    jcfg = jllama.tiny_config(attn_impl="xla", **kw)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    freeze = ()
    if mode == "qlora":
        layers = japply_adapter(jquantize(params["layers"], "int8"), "lora", jax.random.PRNGKey(seed + 1), rank=4,
                                dtype=jnp.float32)
        rng = np.random.default_rng(seed)
        layers = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
            if path[-1].key == "lora_b" else v, layers)
        params = dict(params, layers=layers)
        freeze = ("tok_embeddings", "output", "norm")
    mask = jtrainable_mask(params, freeze)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**kw), device="cpu",
                            freeze_prefixes=freeze)
    return params, jcfg, mask, model


def _batch(seed=1, B=2, S=48):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, S)).astype(np.int32), rng.integers(0, 256, (B, S)).astype(np.int32)


def _port(model, policy, tokens, labels):
    model.zero_grad(set_to_none=True)
    model.config = model.config.replace(activation_checkpointing=policy is not None, remat_policy=policy or "full")
    loss = tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels))
    loss.backward()
    return float(loss.detach()), named_tensors(model, grads=True)


@pytest.fixture
def counted(monkeypatch):
    """Counts calls of the wrappers of K1 and K2: on CPU tensors each runs its plain
    version exactly where it would launch its kernel on the card."""
    counts = {"K1": 0, "K2": 0}
    k1, k2 = tmm.int8_mm_dequant_nt, tfa._forward_impl

    def count_k1(*a, **kw):
        counts["K1"] += 1
        return k1(*a, **kw)

    def count_k2(*a, **kw):
        counts["K2"] += 1
        return k2(*a, **kw)

    monkeypatch.setattr(tmm, "int8_mm_dequant_nt", count_k1)
    monkeypatch.setattr(tfa, "_forward_impl", count_k2)
    return counts


# K1 and K2 calls of one forward + backward over L layers (no int8 head here): the
# forward's 7 projections and 1 flash call per layer, plus what the recompute runs again
RECOMPUTED = {  # policy: (projections, flash calls) run again per layer
    None: (0, 0), "full": (7, 1), "dots": (0, 1), "dots_flash": (0, 0), "flash": (7, 0), "flash_qkv": (4, 0),
    "flash_proj": (2, 0),
    # q8: the attention half reruns what its base policy does not keep (of wq, wk, wv, wo);
    # the MLP reruns nothing ("_q8") or one w3 GEMM ("_q8s")
    "flash_q8": (4, 0), "flash_qkv_q8": (1, 0), "flash_proj_q8": (0, 0),
    "flash_q8s": (5, 0), "flash_qkv_q8s": (2, 0), "flash_proj_q8s": (1, 0),
}


@pytest.mark.parametrize("mode", ["float", "qlora"])
@pytest.mark.parametrize("policy", NAMED)
def test_named_save_policies_equal_full_bit_for_bit(policy, mode, counted):
    _, _, _, model = _pair(mode)
    tokens, labels = _batch()
    loss_full, grads_full = _port(model, "full", tokens, labels)
    full_counts = dict(counted)
    counted.update(K1=0, K2=0)
    loss, grads = _port(model, policy, tokens, labels)
    assert loss == loss_full
    assert set(grads) == set(grads_full) and grads
    for name in grads_full:
        np.testing.assert_array_equal(grads[name], grads_full[name], err_msg=name)
    proj, flash = RECOMPUTED[policy]
    assert counted["K2"] == (1 + flash) * L and full_counts["K2"] == 2 * L
    if mode == "qlora":  # the float base runs no int8 GEMM
        assert counted["K1"] == (7 + proj) * L and full_counts["K1"] == 14 * L


@pytest.mark.parametrize("policy", Q8)
def test_q8_policies_match_the_jax_package(policy, counted):
    params, jcfg, mask, model = _pair("qlora")
    tokens, labels = _batch(6)
    trainable, frozen = partition(params, mask)

    def jax_grads(pol):
        cfg = jcfg.replace(activation_checkpointing=True, remat_policy=pol)

        def lfn(t):
            return jllama.forward(merge(t, frozen), cfg, jnp.asarray(tokens), labels=jnp.asarray(labels))

        loss, grads = jax.value_and_grad(lfn)(trainable)
        return float(loss), {n: np.asarray(g, np.float64) for n, g in named_leaves(grads)}

    want_loss, want = jax_grads(policy)
    _, reference = jax_grads("flash_proj")
    loss_exact, _ = _port(model, "flash_proj", tokens, labels)
    counted.update(K1=0, K2=0)
    loss, got = _port(model, policy, tokens, labels)
    assert loss == loss_exact  # the forward computes from the exact h1 / h3
    assert loss == pytest.approx(want_loss, rel=1e-5)
    assert set(got) == set(want)
    for name, w in want.items():
        denom = np.abs(reference[name]).max() + 1e-30
        np.testing.assert_allclose(got[name] / denom, w / denom, atol=3e-3, err_msg=f"{name} vs JAX {policy}")
        np.testing.assert_allclose(got[name] / denom, reference[name] / denom, atol=0.03,
                                   err_msg=f"{name} vs JAX flash_proj")
    proj, flash = RECOMPUTED[policy]
    assert counted["K1"] == (7 + proj) * L and counted["K2"] == (1 + flash) * L


@pytest.mark.parametrize("policy", ["flash_proj_q8", "flash_q8s"])
def test_q8_policies_on_a_float_model_with_a_trainable_norm(policy):
    """Everything trains (float weights, norms): the Function routes the weight and
    ffn_norm gradients too, against JAX under the same policy."""
    params, jcfg, mask, model = _pair("float")
    tokens, labels = _batch(7)
    cfg = jcfg.replace(activation_checkpointing=True, remat_policy=policy)
    want_loss, want = jax.value_and_grad(
        lambda p: jllama.forward(p, cfg, jnp.asarray(tokens), labels=jnp.asarray(labels)))(params)
    loss, got = _port(model, policy, tokens, labels)
    assert loss == pytest.approx(float(want_loss), rel=1e-5)
    names = [n for n, _ in named_leaves(want)]
    assert set(got) == set(names) and "layers/ffn_norm/scale" in got and "layers/feed_forward/w1/kernel" in got
    for name, w in named_leaves(want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got[name], w, atol=3e-3 * np.abs(w).max() + 1e-9, err_msg=name)


def test_policies_are_ignored_without_checkpointing_and_in_eval(counted):
    _, _, _, model = _pair("qlora")
    tokens, labels = _batch()
    t = torch.from_numpy(tokens).long()
    model.config = model.config.replace(activation_checkpointing=False, remat_policy="attn_q8")
    tllama.forward(model, t, labels=torch.from_numpy(labels)).backward()  # no checkpointing: the policy is not read
    assert counted == {"K1": 7 * L, "K2": L}
    model.config = model.config.replace(activation_checkpointing=True, remat_policy="flash_q8s")
    with torch.no_grad():
        tllama.forward(model, t)
    assert counted == {"K1": 14 * L, "K2": 2 * L}


def test_save_store_records_then_replays():
    store = rm.SaveStore(("a",))
    calls = []

    def point(name, value):
        def fn(kept):
            calls.append((name, kept is not None))
            return value if kept is None else kept
        return store.run(name, fn)

    store.enter()
    x, y = torch.ones(2, requires_grad=True) * 2, torch.zeros(3)
    assert point("a", x) is x and point("b", y) is y and point("a", (x, y))[1] is y
    store.enter()
    first, _, pair = point("a", None), point("b", y), point("a", None)
    assert torch.equal(first, x) and not first.requires_grad and torch.equal(pair[0], x)
    assert calls == [("a", False), ("b", False), ("a", False), ("a", True), ("b", False), ("a", True)]
    assert rm.run_saved(None, lambda kept: kept) is None


def _linear(kind: str, rng) -> Linear:
    w = torch.from_numpy(rng.standard_normal((24, 16)).astype(np.float32))
    adapters = dict(lora_a=torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)),
                    lora_b=torch.from_numpy(rng.standard_normal((4, 24)).astype(np.float32)),
                    lora_scale=torch.tensor(0.5))
    if kind == "int8 + lora":
        from llama_x_tpu_torch.ops.int8 import quantize_int8_rowwise

        q, s = quantize_int8_rowwise(w)
        lin = Linear(int_data=q, scale=s, **adapters)
    elif kind == "float":
        lin = Linear(weight=w, bias=torch.from_numpy(rng.standard_normal(24).astype(np.float32)))
    else:
        lin = Linear(weight=w, **adapters, **(dict(m=w.norm(dim=1)) if kind == "dora" else {}))
    for name, p in lin.named_parameters():
        p.requires_grad_(name not in ("scale", "lora_scale") and not (kind != "float" and name == "weight"))
    return lin


@pytest.mark.parametrize("kind", ["int8 + lora", "float", "float + lora", "dora"])
@pytest.mark.parametrize("int8_bwd", [False, True])
def test_linear_vjp_is_the_backward_of_apply_linear(kind, int8_bwd, counted):
    """dx and every trainable tensor's gradient equal autograd's through the real
    forward (the same operations in the same order: bit for bit), and the int8 base
    product does not run again (DoRA, whose rescale reads the output, aside)."""
    rng = np.random.default_rng(3)
    lin = _linear(kind, rng)
    kw = dict(dynamic_int8_act=True, dynamic_int8_bwd=int8_bwd)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))
    named = [(n, p) for n, p in lin.named_parameters() if p.requires_grad]
    want = torch.autograd.grad(apply_linear(x, lin, **kw), [x] + [p for _, p in named], g)
    counted.update(K1=0)
    dx, grads = linear_vjp(lin, x.detach(), g, **kw)
    assert counted["K1"] == 0
    assert torch.equal(dx, want[0])
    assert set(grads) == {n for n, _ in named}
    for (n, _), w in zip(named, want[1:]):
        assert torch.equal(grads[n], w), n


def test_attn_q8_is_refused_by_name_everywhere():
    """Every policy the trainers offer is accepted (attn_q8 / attn_q8s since they were
    ported, tests/test_torch_attn_q8.py), and a name outside them raises ValueError."""
    from llama_x_tpu_torch.train import cli

    assert set(cli.REMAT_POLICIES) == set(NAMED) | set(Q8) | {"full", "attn_q8", "attn_q8s"}
    for policy in cli.REMAT_POLICIES:
        tllama.check_remat_policy(policy)
    for policy in ("attn_q9", "dots_proj"):
        with pytest.raises(ValueError, match="unknown remat_policy"):
            tllama.check_remat_policy(policy)
