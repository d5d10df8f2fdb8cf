"""The int8-residual attention (``attn_q8`` / ``attn_q8s``: ``models/llama.py:attention_q8``
beside ``feed_forward_q8``) against the JAX package on the CPU.

Both sides keep the post-RoPE q / k / v and the flash output as rowwise int8 and run the
attention backward from the dequantized values, so they take the same int8 round trips:
the loss is held to 2e-4 relative in fp32 (the forward computes from the exact values, and
equals the "flash_proj" forward bit for bit) and every gradient to 3e-3 of its tensor's
largest entry, as tests/test_torch_remat.py holds the q8 policies. The JAX side runs its
Pallas flash kernels in interpret mode (``interpret_flash``, as the JAX package's own ring
and Ulysses tests run them), so both sides take the flash backward from the forward's lse
and the dequantized output, the algorithm of the kernels; that needs heads of 64 and
sequences of 128 (the kernels' plan), hence ``GEO``. Without the kernels the JAX package
takes ``_dpa``'s vjp at the dequantized q / k / v instead, whose softmax is renormalized
there: it differs from the flash backward by first-order terms of the int8 error (5% of a
small wk gradient). Also here: the launches of one forward + backward
(no K1 in the attention backward), the 10-step audio curve under each policy at the audio
tolerances, the dropout fallback to ``flash_q8`` / ``flash_q8s``, the step at tp 2 and fsdp
2 against the JAX step on the 8-device simulation (at the sharding tests' int8 tolerances),
and the context-parallel outcome: the JAX ``attention_q8`` ignores ``attn_impl`` and attends
over the whole sequence, so cp 2 equals cp 1 there, and the port accepts the combination and
runs it (over gloo processes at cp 2 and cp 4: tests/test_torch_attn_q8_cp.py)."""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import audio as jaudio
from llama_x_tpu.models import fusion as jfusion
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.parallel import make_mesh as jmake_mesh
from llama_x_tpu.parallel import shard_params as jshard_params
from llama_x_tpu.parallel import use_mesh as juse_mesh
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu.train.cli import assemble_step_batch as jassemble
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch import train_librispeech as ttrain_cli
from llama_x_tpu_torch.adapters.lora import tree_path
from llama_x_tpu_torch.models import audio as taudio
from llama_x_tpu_torch.models import fusion as tfusion
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.ops import flash_attention as tfa
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.ops import int8_mm as tmm
from llama_x_tpu_torch.parallel import mesh as tmesh
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train import trainer as ttrainer
from llama_x_tpu_torch.train import validate as tvalidate
from torch_dist_workers import run_ranks

torch.set_num_threads(2)
POLICIES = ["attn_q8", "attn_q8s"]
FREEZE = ("tok_embeddings", "output", "norm")
L = 2
GEO = dict(embed_dim=128, head_dim=64, num_heads=2, num_kv_heads=1, intermediate_dim=256)


@pytest.fixture
def interpret_flash():
    from llama_x_tpu.ops import flash_attention as jfa

    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _fill_lora_b(layers, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1)
        if path[-1].key == "lora_b" else v, layers)


def _pair(mode: str, seed=0, audio=False, **cfg):
    """(JAX params, JAX config, mask, port model, port config fields) in fp32: "qlora"
    (int8 base with int8 activations and input gradients, LoRA with live lora_b, embeddings /
    head / final norm frozen) or "float" (everything trains, the norms too)."""
    kw = dict(dict(max_seq_len=128, num_layers=L), **cfg)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True)
    jcfg = jllama.tiny_config(attn_impl="xla", **kw)
    key = jax.random.PRNGKey(seed)
    params = jaudio.LlamaAudio.init(key, jcfg, dtype=jnp.float32).params if audio else jllama.init(
        key, jcfg, dtype=jnp.float32)
    freeze = ()
    if mode == "qlora":
        layers = japply_adapter(jquantize(params["layers"], "int8"), "lora", jax.random.PRNGKey(seed + 1), rank=4,
                                dtype=jnp.float32)
        params = dict(params, layers=_fill_lora_b(layers, seed))
        freeze = FREEZE
    mask = jtrainable_mask(params, freeze)
    frozen_head = not mask["output"]["kernel"]
    jcfg = jcfg.replace(frozen_head=frozen_head)
    kw["frozen_head"] = frozen_head
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**kw), device="cpu",
                            freeze_prefixes=freeze)
    return params, jcfg, mask, model, kw


def _batch(seed=1, B=2, S=128, D=128, n_prefix=0):
    """(tokens, labels, segment ids, prefix) with S - n_prefix text positions."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S - n_prefix)).astype(np.int32)
    labels = rng.integers(0, 256, (B, S - n_prefix)).astype(np.int32)
    seg = np.sort(rng.integers(1, 4, (B, S - n_prefix)), axis=1).astype(np.int32)
    prefix = (rng.standard_normal((B, n_prefix, D)) * 0.5).astype(np.float32)
    return tokens, labels, seg, prefix


def _jax_loss(mask_kind, cfg, tokens, labels, seg, prefix):
    """The JAX model's loss as a function of its parameters, under one of the three masks."""
    tok, lab = jnp.asarray(tokens), jnp.asarray(labels)
    if mask_kind == "prefix":
        return lambda p: jfusion.fuse_forward(p, cfg, [jnp.asarray(prefix)], tok, labels=lab, prefix_lm=True)
    segment_ids = jnp.asarray(seg) if mask_kind == "packed" else None
    return lambda p: jllama.forward(p, cfg, tok, labels=lab, segment_ids=segment_ids)


def _port_loss(model, mask_kind, tokens, labels, seg, prefix, **kw):
    tok, lab = torch.from_numpy(tokens).long(), torch.from_numpy(labels)
    if mask_kind == "prefix":
        return tfusion.fuse_forward(model, [torch.from_numpy(prefix)], tok, labels=lab, prefix_lm=True, **kw)
    return tllama.forward(model, tok, labels=lab, segment_ids=torch.from_numpy(seg) if mask_kind == "packed" else None,
                          **kw)


def _port(model, policy, mask_kind, batch, **kw):
    model.zero_grad(set_to_none=True)
    model.config = model.config.replace(activation_checkpointing=True, remat_policy=policy)
    loss = _port_loss(model, mask_kind, *batch, **kw)
    loss.backward()
    return float(loss.detach()), named_tensors(model, grads=True)


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of the wrappers of K1, K2 and K5: on CPU tensors each runs its
    plain version exactly where it would launch its kernel on the card."""
    counts = {"K1": 0, "K2": 0, "K5": 0}
    wrapped = {"K1": (tmm, "int8_mm_dequant_nt"), "K2": (tfa, "_forward_impl"), "K5": (tfa, "flash_bwd_from_res")}
    for key, (mod, name) in wrapped.items():
        fn = getattr(mod, name)

        def count(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, count)
    return counts


def _held(got: dict, want: dict, tol: float, what: str):
    assert set(got) == set(want) and got
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol * np.abs(w).max() + 1e-9, err_msg=f"{name} {what}")


@functools.cache
def _qlora_jax_grads(mask_kind: str, policy: str):
    """The JAX trunk's loss and trainable gradients on ``_pair("qlora", **GEO)`` under the
    mask and the policy (each pair computed once a module: both policies' cases read the
    "flash_proj" reference)."""
    params, jcfg, mask, _, _ = _pair("qlora", **GEO)
    batch = _batch(6, n_prefix=8 if mask_kind == "prefix" else 0)
    trainable, frozen = partition(params, mask)
    from llama_x_tpu.ops import flash_attention as jfa

    jfa.INTERPRET = True
    try:
        lfn = _jax_loss(mask_kind, jcfg.replace(activation_checkpointing=True, remat_policy=policy), *batch)
        loss, grads = jax.jit(jax.value_and_grad(lambda t: lfn(merge(t, frozen))))(trainable)
    finally:
        jfa.INTERPRET = False
    return float(loss), {n: np.asarray(g, np.float64) for n, g in named_leaves(grads)}


@functools.cache
def _qlora_port_flash_proj(mask_kind: str):
    """The port's loss and gradients under "flash_proj" on the same model and batch."""
    _, _, _, model, _ = _pair("qlora", **GEO)
    return _port(model, "flash_proj", mask_kind, _batch(6, n_prefix=8 if mask_kind == "prefix" else 0))


@pytest.mark.parametrize("mask_kind", ["causal", "packed", "prefix"])
@pytest.mark.parametrize("policy", POLICIES)
def test_attn_q8_matches_the_jax_package(policy, mask_kind, counted, interpret_flash):
    """QLoRA: loss and every adapter and norm gradient against the JAX trunk under the
    same policy; the forward equals flash_proj's; one forward + backward launches K1 7 L
    (attn_q8) or 8 L (attn_q8s: one w3 GEMM again), K2 and K5 once a layer.

    The int8 activations and input gradients of every projection take their own rounding
    ties, policy or not: at this geometry the port's "flash_proj" gradients (no int8
    residual at all) differ from the JAX package's by up to 1e-2 of a tensor's largest
    entry (a layer norm's scale, a sum over every position). So each tensor is held to
    3e-3 of its largest entry beyond what that tensor shows under "flash_proj" in the same
    test; the float model below, whose only int8 are the residuals, gets 3e-3 alone."""
    params, jcfg, mask, model, _ = _pair("qlora", **GEO)
    batch = _batch(6, n_prefix=8 if mask_kind == "prefix" else 0)
    want_loss, want = _qlora_jax_grads(mask_kind, policy)
    _, want_exact = _qlora_jax_grads(mask_kind, "flash_proj")
    exact, got_exact = _qlora_port_flash_proj(mask_kind)
    counted.update(K1=0, K2=0, K5=0)
    loss, got = _port(model, policy, mask_kind, batch)
    assert counted == {"K1": (7 + (policy == "attn_q8s")) * L, "K2": L, "K5": L}
    assert loss == exact
    assert loss == pytest.approx(want_loss, rel=2e-4)
    assert set(got) == set(want) and "layers/attention/wq/lora_a" in got
    for name, w in want.items():
        floor = np.abs(got_exact[name] - want_exact[name]).max()
        np.testing.assert_allclose(got[name], w, rtol=0, atol=3e-3 * np.abs(w).max() + floor,
                                   err_msg=f"{name} vs JAX {policy} ({mask_kind})")


@pytest.mark.parametrize("policy", POLICIES)
def test_attn_q8_on_a_float_model_with_trainable_norms(policy, interpret_flash):
    """Everything trains: the Function routes the weights' and attention_norm's gradients
    too (the backward's rms_norm vjp), against JAX under the same policy."""
    params, jcfg, _, model, _ = _pair("float", **GEO)
    batch = _batch(7)
    lfn = _jax_loss("causal", jcfg.replace(activation_checkpointing=True, remat_policy=policy), *batch)
    want_loss, want = jax.jit(jax.value_and_grad(lfn))(params)
    loss, got = _port(model, policy, "causal", batch)
    assert loss == pytest.approx(float(want_loss), rel=2e-4)
    assert "layers/attention_norm/scale" in got and "layers/attention/wq/kernel" in got
    _held(got, dict(named_leaves(want)), 3e-3, f"vs JAX {policy}")


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_falls_back_to_the_checkpointed_q8_policy(policy, counted):
    """With dropout seeds attention_q8 cannot apply (no dropout path): the layer runs
    flash_q8 / flash_q8s, bit for bit, with their launches."""
    _, _, _, model, _ = _pair("qlora", attn_dropout=0.2)
    batch = _batch(8)
    fallback = tllama._ATTN_Q8_POLICIES[policy]
    want_loss, want = _port(model, fallback, "causal", batch, dropout_seeds=[11, 12])
    want_counts = dict(counted)
    counted.update(K1=0, K2=0, K5=0)
    loss, got = _port(model, policy, "causal", batch, dropout_seeds=[11, 12])
    assert counted == want_counts and counted["K1"] == (7 + (5 if policy == "attn_q8s" else 4)) * L
    assert loss == want_loss
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    no_drop, _ = _port(model, policy, "causal", batch)
    assert no_drop != loss


@pytest.mark.parametrize("policy", POLICIES)
def test_ten_step_audio_curve_tracks_the_jax_trainer(policy):
    """The audio QLoRA run of tests/test_torch_audio.py (prefix-LM, accumulation 2, the int8
    head, clipping) under the policy on both sides: every step's loss within 2e-4 and grad
    norm within 5e-3 (the audio tolerances)."""
    params, jcfg, mask, model, _ = _pair("qlora", audio=True, int8_head=True, fused_ce_chunks=4,
                                         activation_checkpointing=True, remat_policy=policy)
    acfg = jaudio.AudioConfig()

    def jloss(p, mb):
        loss = jaudio.forward(p, jcfg, acfg, mb["audio"], mb["tokens"], labels=mb["labels"], prefix_lm=True)
        return loss, jnp.sum(mb["labels"] != -100)

    lr, steps, accum = 1e-2, 10, 2
    tx = joptim.get_optimizer("AdamW", joptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    jstate = jtrainer.init_train_state(params, mask, tx)
    jstep = jax.jit(jtrainer.make_train_step(jloss, tx))
    opt = toptim.get_optimizer("AdamW", ttrainer.trainable_parameters(model),
                               toptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    tstate = ttrainer.TrainState(model, opt)
    tstep = ttrainer.make_train_step(ttrain_cli.make_loss_fn(prefix_lm=True))
    data = ttrain_cli.synthetic_audio_batches(np.random.default_rng(0), taudio.AudioConfig(), 2, 0.5, 24, 256)
    jl, tl, jg, tg = [], [], [], []
    for _ in range(steps):
        micro = [next(data) for _ in range(accum)]
        jstate, jm = jstep(jstate, jassemble(micro, pad_values={"labels": -100}))
        tm = tstep(tstate, tcli.assemble_step_batch(micro, pad_values={"labels": -100}))
        jl.append(float(jm["loss"])), tl.append(float(tm["loss"]))
        jg.append(float(jm["grad_norm"])), tg.append(float(tm["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    np.testing.assert_allclose(tg, jg, rtol=5e-3)


def _jax_named(grads: dict) -> dict:
    """{port parameter name: array} -> {JAX tree path: array}, the layers stacked in order
    and a linear's weight transposed back to the JAX kernel."""
    by = {}
    for name, g in grads.items():
        path = tree_path(name)
        g = g.T if path.endswith("/kernel") and g.ndim == 2 else g
        by.setdefault(path, []).append((int(name.split(".")[1]) if name.startswith("layers.") else 0, g))
    return {k: np.stack([g for _, g in sorted(v, key=lambda e: e[0])]) if k.startswith("layers/") else v[0][1]
            for k, v in by.items()}


def _jax_grads_on_mesh(params, jcfg, mask, mesh_kw, batch):
    """Loss and trainable gradients (mean over the accumulation axis) on the simulated mesh,
    the params placed by the JAX ``shard_params``."""
    n = int(np.prod(list(mesh_kw.values())))
    mesh = jmake_mesh(devices=jax.devices()[:n], **mesh_kw)
    trainable, frozen = partition(jshard_params(params, mesh), mask)
    sh = NamedSharding(mesh, P(("dp", "fsdp")))
    vg = jax.jit(jax.value_and_grad(lambda t, tok, lab: jllama.forward(merge(t, frozen), jcfg, tok, labels=lab)))
    losses, grads = [], []
    for i in range(batch["inputs"].shape[0]):
        loss, g = vg(trainable, jax.device_put(jnp.asarray(batch["inputs"][i]), sh),
                     jax.device_put(jnp.asarray(batch["labels"][i]), sh))
        losses.append(float(loss))
        grads.append({k: np.asarray(v) for k, v in named_leaves(g)})
    return float(np.mean(losses)), {k: np.mean([g[k] for g in grads], axis=0) for k in grads[0]}


@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(fsdp=2)])
def test_attn_q8_on_sharded_linears_matches_the_jax_step(tmp_path, mesh_kw, interpret_flash):
    """The QLoRA step (int8 head, fused CE) under attn_q8s at tp 2 (one head of
    64 a rank; the flash output's rows quantized with their absmax over tp) and fsdp 2 (the
    weights gathered as the int8 linear gathers them), in two gloo processes, against the
    JAX step on the same mesh of the 8-device simulation: loss within 2e-4, gradients within
    5e-3 of their largest entry (the sharding tests' int8 tolerances) beyond what the same
    tensor shows under "flash_proj" in the same run (the rounding ties of the int8
    activations, as in ``test_attn_q8_matches_the_jax_package``)."""
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 256, (1, 2, 128)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
    labels[..., -1] = -100
    batch = {"inputs": tokens, "labels": labels}
    policies = ["flash_proj", "attn_q8s"]
    cases, wants = [], []
    for policy in policies:
        params, jcfg, mask, _, kw = _pair("qlora", int8_head=True, fused_ce_chunks=4, activation_checkpointing=True,
                                          remat_policy=policy, **dict(GEO, num_kv_heads=2))
        cases.append(dict(params=jax.tree.map(np.asarray, params), config=kw, freeze=FREEZE, batch=batch))
        wants.append(_jax_grads_on_mesh(params, jcfg, mask, mesh_kw, batch))
    ranks = run_ranks(dict(kind="sharded_step", world=2, mesh=mesh_kw, cases=cases), tmp_path)
    for r in ranks:
        floor = {n: np.abs(g - wants[0][1][n]).max() for n, g in _jax_named(r[0]["grads"]).items()}
        for i, policy in enumerate(policies):
            want_loss, want = wants[i]
            assert r[i]["loss"][0] == pytest.approx(want_loss, rel=2e-4), policy
            got = _jax_named(r[i]["grads"])
            assert set(got) == set(want) and got
            for name, w in want.items():
                np.testing.assert_allclose(got[name], w, rtol=0, atol=5e-3 * np.abs(w).max() + floor[name],
                                           err_msg=f"{name} {policy} {mesh_kw}")


def test_context_parallelism_outcome():
    """The JAX package at cp 2 (ring) under attn_q8s computes what it computes at cp 1:
    its attention_q8 never looks at attn_impl, so the loss and gradients agree to fp32
    summation order. The port takes the combination too: validate_launch accepts attn_q8 /
    attn_q8s with ring and Ulysses at cp 2, and trunk runs them over a mesh of one rank, where
    the ring's one block and Ulysses' exchanges within one rank give the cp 1 loss and
    gradients bit for bit. (cp 2 and cp 4 over gloo processes:
    tests/test_torch_attn_q8_cp.py.)"""
    params, jcfg, mask, model, _ = _pair("qlora", max_seq_len=64)
    tokens, labels, seg, _ = _batch(3, B=2, S=64)
    trainable, frozen = partition(params, mask)
    cfg = jcfg.replace(activation_checkpointing=True, remat_policy="attn_q8s")

    def grads(c):
        return jax.jit(jax.value_and_grad(lambda t: jllama.forward(merge(t, frozen), c, jnp.asarray(tokens),
                                                                   labels=jnp.asarray(labels))))(trainable)

    one_loss, one = grads(cfg)
    with juse_mesh(jmake_mesh(devices=jax.devices()[:2], cp=2)):
        two_loss, two = grads(cfg.replace(attn_impl="ring"))
    assert float(two_loss) == pytest.approx(float(one_loss), rel=1e-5)
    _held(dict((n, np.asarray(g)) for n, g in named_leaves(two)), dict(named_leaves(one)), 1e-4, "cp 2 vs cp 1")

    batch = (tokens, labels, seg, None)
    for policy in POLICIES:
        model.config = model.config.replace(attn_impl="auto")
        want_loss, want = _port(model, policy, "packed", batch)
        for impl in ("ring", "ulysses"):
            args = argparse.Namespace(batch_size=2, gradient_accumulation=1, attn_impl=impl, remat_policy=policy)
            tvalidate.validate_launch(args, tmesh.Mesh(tmesh.mesh_shape(2, cp=2), 0, None), max_seq_len=64)
            model.config = model.config.replace(attn_impl=impl)
            with tmesh.use_mesh(tmesh.make_mesh()):
                got_loss, got = _port(model, policy, "packed", batch)
            assert got_loss == want_loss, (policy, impl)
            assert set(got) == set(want) and got
            for name, w in want.items():
                np.testing.assert_array_equal(got[name], w, err_msg=f"{name} {policy} {impl}")


TRAINERS = {  # each trainer's small run on the CPU: (task directory, its own flags)
    "train_metamathqa": ("metamathqa", ["--synthetic", "16", "--document_mask", "--max_seq_len", "128",
                                        "--batch_size", "2"]),
    "train_librispeech": ("librispeech", ["--synthetic", "8", "--audio_duration", "1", "--seq_len_multiple", "32",
                                          "--batch_size", "2", "--prefix_lm"]),
    "train_vision": ("vision", ["--synthetic", "8", "--batch_size", "2", "--image_size", "32", "--patch_size", "8",
                                "--prefix_lm"]),
    "train_omni": ("omni", ["--synthetic", "8", "--audio_duration", "1", "--seq_len_multiple", "32", "--batch_size",
                            "2", "--image_size", "32", "--patch_size", "8", "--prefix_lm"]),
}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("entry_name", list(TRAINERS))
def test_every_trainer_trains_under_attn_q8(entry_name, policy, tmp_path, monkeypatch):
    """Each trainer's ``main`` takes the policy: QLoRA with int8 activations and input
    gradients, two steps with finite losses, and the trainer's flags parse as the JAX ones."""
    import importlib
    import json

    entry = importlib.import_module(f"llama_x_tpu_torch.{entry_name}")
    task, extra = TRAINERS[entry_name]
    monkeypatch.chdir(tmp_path)
    entry.main([*extra, "--device", "cpu", "--remat_policy", policy, "--activation_checkpointing", "--quantize",
                "int8", "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true}', "--adapter",
                "lora", "--n_steps", "2", "--log_interval", "1", "--ckpt_interval", "0", "--synthetic_config",
                '{"num_layers": 2, "embed_dim": 64, "head_dim": 16, "num_heads": 4, "num_kv_heads": 2, '
                '"intermediate_dim": 128}'])
    (run,) = (tmp_path / "runs" / task).iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
    assert json.loads((run / "config.json").read_text())["remat_policy"] == policy
