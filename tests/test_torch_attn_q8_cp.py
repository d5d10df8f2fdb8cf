"""The int8-residual attention (``attn_q8`` / ``attn_q8s``, models/llama.py:attention_q8) under
context parallelism, in gloo processes on the CPU, against the JAX package at cp 1 and the
port at cp 1.

The JAX ``attention_q8`` never looks at ``attn_impl``: at any cp it attends over the whole
sequence, so its cp 1 step is the reference. The port's ranks keep their own rows as int8 and
run the ring (K2's ring form and K5's offsets form, their plain versions on CPU tensors) or
Ulysses (the all-to-alls around K2 / K5) from those residuals. Cases: both policies x ring and
Ulysses at cp 2 through ``llama.forward`` (``model_job``), and ``attn_q8s`` on the ring at cp 4
through one ``make_train_step(mesh=..., eager=True)`` step (``step_job``), on a tiny fp32
QLoRA model (int8 base, LoRA with live lora_b, trainable layer norms) over packed documents that cross the shard boundaries; Ulysses at cp 2 repeats the one kv head
twice (g = 2), so the backward's sum over the copies is exercised.

Tolerances, fp32:
- against the port at cp 1: the loss within 1e-5 relative and every gradient within 1e-3 of
  its tensor's largest entry plus 1e-4 relative. The rows and their int8 codes are the cp 1
  step's, but the ring merges its blocks in another order, so a value that sits on a rounding
  tie can take the other code, and one such code moves a LoRA gradient by a few 1e-4 of its
  largest entry. At cp 4 the flash output of layer 1, row 168, column 111 is -57.4999918
  scales at cp 1 and -57.4999995 on the ring: code -57 against -58, and wo's lora_a gradient
  moves by 2.65e-4 of its largest entry. At cp 2 the ring's h1 codes of feed_forward_q8 tie
  likewise (w2's lora_a moves by 5.21e-4), as they do under flash_q8s, which ran at cp
  before. Every other gradient of the cp 2 cases is within 1e-4; a wrong mask, block or RoPE
  row moves them by the order of their largest entry.
- against the JAX package at cp 1: the loss within 2e-4 relative and every gradient within
  3e-3 of its tensor's largest entry, tests/test_torch_attn_q8.py's tolerances for the port
  at cp 1 against the same JAX step (the two frameworks' int8 round trips). The JAX side runs
  its Pallas flash kernels in interpret mode (heads of 64, sequences of 128: the kernels'
  plan), so both take the flash backward from the forward's lse.
The ranks run in subprocesses that import no JAX (tests/torch_dist_workers.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.ops import flash_attention as jfa
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step
from torch_dist_workers import Recorder, run_ranks

torch.set_num_threads(2)
FREEZE = ("tok_embeddings", "output", "norm")
CFG = dict(embed_dim=128, head_dim=64, num_heads=2, num_kv_heads=1, intermediate_dim=256, max_seq_len=128,
           num_layers=2, frozen_head=True, activation_checkpointing=True)
B, S = 2, 128


@functools.cache
def _setup():
    """(numpy params, tokens, labels, segment ids): the QLoRA model at CFG and a packed batch
    whose documents cross the cp 2 and cp 4 shard boundaries."""
    jcfg = jllama.tiny_config(attn_impl="xla", **CFG)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    layers = japply_adapter(jquantize(params["layers"], "int8"), "lora", jax.random.PRNGKey(1), rank=4,
                            dtype=jnp.float32)
    rng = np.random.default_rng(0)
    layers = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        if path[-1].key == "lora_b" else v, layers)
    params = dict(params, layers=layers)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels[0, S // 2 - 1] = -100  # an ignored target at the cp 2 boundary
    seg = np.sort(rng.integers(1, 4, (B, S)), axis=1).astype(np.int32)
    for n in (2, 4):
        for cut in range(S // n, S, S // n):
            assert (seg[:, cut - 1] == seg[:, cut]).any(), "a document crosses every shard boundary"
    return params, tokens, labels, seg


@functools.cache
def _jax_cp1(policy: str):
    """The JAX step at cp 1 under ``policy``: loss and trainable gradients, the flash kernels
    interpreted."""
    params, tokens, labels, seg = _setup()
    cfg = jllama.tiny_config(attn_impl="xla", **CFG).replace(remat_policy=policy)
    trainable, frozen = partition(params, jtrainable_mask(params, FREEZE))
    jfa.INTERPRET = True
    try:
        loss, grads = jax.jit(jax.value_and_grad(lambda t: jllama.forward(
            merge(t, frozen), cfg, jnp.asarray(tokens), labels=jnp.asarray(labels),
            segment_ids=jnp.asarray(seg))))(trainable)
    finally:
        jfa.INTERPRET = False
    return float(loss), {n: np.asarray(g, np.float64) for n, g in named_leaves(grads)}


def _model(policy: str):
    params, *_ = _setup()
    return params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**CFG, remat_policy=policy),
                           device="cpu", freeze_prefixes=FREEZE)


@functools.cache
def _port_cp1(policy: str):
    """The port at cp 1 (one process, no mesh) under ``policy``: loss and trainable gradients."""
    _, tokens, labels, seg = _setup()
    model = _model(policy)
    loss = tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels),
                          segment_ids=torch.from_numpy(seg))
    loss.backward()
    return float(loss.detach()), named_tensors(model, grads=True)


def _held(loss: float, grads: dict, policy: str, what: str):
    """``loss`` and ``grads`` against the port's and the JAX package's cp 1 step."""
    for ref in ("port cp 1", "JAX cp 1"):
        want_loss, want = _port_cp1(policy) if ref == "port cp 1" else _jax_cp1(policy)
        assert loss == pytest.approx(want_loss, rel=1e-5 if ref == "port cp 1" else 2e-4), f"{what} vs {ref}"
        assert set(grads) == set(want) and any("lora" in k for k in grads)
        share = 3e-3 if ref == "JAX cp 1" else 1e-3
        rtol = 0.0 if ref == "JAX cp 1" else 1e-4
        for name, w in want.items():
            np.testing.assert_allclose(grads[name], w, rtol=rtol, atol=share * np.abs(w).max() + 1e-9,
                                       err_msg=f"{name}: {what} vs {ref}")


_CP2: dict = {}  # policy -> the ranks' results, shared by the ring and the Ulysses case


def _cp2_ranks(policy: str, tmp_path_factory) -> list:
    if policy not in _CP2:
        params, tokens, labels, seg = _setup()
        _CP2[policy] = run_ranks(dict(kind="model", world=2, mesh=dict(cp=2), params=jax.tree.map(np.asarray, params),
                                      config=dict(CFG, remat_policy=policy), freeze=FREEZE, tokens=tokens,
                                      labels=labels, seg=seg, impls=["ring", "ulysses"]),
                                 tmp_path_factory.mktemp(f"cp2_{policy}"))
    return _CP2[policy]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("policy", ["attn_q8", "attn_q8s"])
def test_attn_q8_at_cp2_equals_cp1(policy, impl, tmp_path_factory):
    """Loss and trainable gradients of ``llama.forward`` at cp 2 (summed over the ranks)
    against cp 1, the port's and the JAX package's."""
    ranks = _cp2_ranks(policy, tmp_path_factory)
    loss, grads = ranks[0][impl]
    assert ranks[1][impl][0] == loss
    _held(loss, grads, policy, f"{policy} {impl} cp 2")


def test_attn_q8s_train_step_on_the_ring_at_cp4_equals_cp1(tmp_path):
    """One ``make_train_step(mesh=..., eager=True)`` step at cp 4 on the ring under attn_q8s:
    every rank's loss and grad norm against the one-process step's, and the gradients it hands
    the optimizer against the port's and the JAX package's cp 1 gradients."""
    params, tokens, labels, seg = _setup()
    batch = {"inputs": tokens[None], "labels": labels[None], "segment_ids": seg[None]}
    ranks = run_ranks(dict(kind="step", world=4, mesh=dict(cp=4), params=jax.tree.map(np.asarray, params),
                           config=dict(CFG, remat_policy="attn_q8s"), freeze=FREEZE, impl="ring", batch=batch),
                      tmp_path)

    def loss_fn(m, mb):
        loss = tllama.forward(m, mb["inputs"].long(), segment_ids=mb["segment_ids"], labels=mb["labels"])
        return loss, (mb["labels"] != -100).sum()

    model = _model("attn_q8s")
    opt = Recorder([p for p in model.parameters() if p.requires_grad])
    metrics = make_train_step(loss_fn, eager=True)(TrainState(model, opt), batch)
    assert float(metrics["loss"]) == pytest.approx(_port_cp1("attn_q8s")[0], rel=1e-6)
    for r in ranks:
        assert (r["loss"], r["grad_norm"]) == (ranks[0]["loss"], ranks[0]["grad_norm"])
        assert r["n_tokens"] == int(metrics["n_tokens"])
    assert ranks[0]["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-4)
    for p, g in zip(opt.params, ranks[0]["grads"]):
        p.grad = torch.from_numpy(g)
    _held(ranks[0]["loss"], named_tensors(model, grads=True), "attn_q8s", "attn_q8s ring cp 4 step")
