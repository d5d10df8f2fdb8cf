"""The port's training path against the JAX package's on the same weights and data, on
the CPU: loss and every trainable gradient of ``forward(labels=)``, the train step
(accumulation, clipping, skip_nonfinite), a 20-step run beside the JAX trainer's loss
curve, and checkpoint resume. The optimizer, the data iterators, the adapter / freeze
rules and the CLI are in test_torch_train_parts.py.

Weights are made by the JAX package's ``init`` and carried across with
``params_from_jax``; tokens come from numpy. Tolerances are stated at each test: in
fp32 only the summation order differs (1e-5 class); the 20-step curves add up Adam
steps and get 2e-4 (fp32) and 3e-2 (bf16, where the two frameworks round every
matmul's bf16 output from differently ordered sums)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.data import metamathqa as jdata
from llama_x_tpu.data import synthetic as jsynth
from llama_x_tpu.data.tokenizers import get_tokenizer as jget_tokenizer
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu.train.cli import assemble_step_batch as jassemble
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch import train_metamathqa as ttrain_cli
from llama_x_tpu_torch.data import metamathqa as tdata
from llama_x_tpu_torch.data import synthetic as tsynth
from llama_x_tpu_torch.data.tokenizers import get_tokenizer as tget_tokenizer
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.train import checkpoint as tckpt
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

QLORA_FREEZE = ("tok_embeddings", "output", "norm")


def _fill_lora_b(layers, seed):
    """lora_b starts at zero; give it values so that every adapter gradient is live."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1).astype(v.dtype)
                        if k == "lora_b" else fill(v)) for k, v in node.items()}
        return node

    return fill(layers)


def _pair(mode: str, dtype=jnp.float32, seed=0, fill_b=True, **cfg):
    """(JAX params, JAX config, JAX mask, port model) for one training set-up:
    "full" (everything trains), "lora" / "dora" (float base + adapter) or "qlora"
    (int8 base, dynamic int8 act and dgrad, LoRA, frozen embeddings / head / final norm,
    fused CE with the int8 head)."""
    kw = dict(max_seq_len=64, **cfg)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True, int8_head=True, fused_ce_chunks=4)
    jcfg = jllama.tiny_config(**kw)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    freeze = ()
    if mode == "qlora":
        params = dict(params, layers=jquantize(params["layers"], "int8"))
        freeze = QLORA_FREEZE
    if mode != "full":
        adapter = "dora" if mode == "dora" else "lora"
        layers = japply_adapter(params["layers"], adapter, jax.random.PRNGKey(seed + 1), rank=4, dtype=dtype)
        params = dict(params, layers=_fill_lora_b(layers, seed) if fill_b else layers)
    mask = jtrainable_mask(params, freeze)
    head_trainable = mask["tok_embeddings"]["weight"] if jcfg.tied_embeddings else mask["output"]["kernel"]
    jcfg = jcfg.replace(frozen_head=not head_trainable)
    tcfg = tllama.tiny_config(**kw).replace(frozen_head=not head_trainable)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu", freeze_prefixes=freeze)
    return params, jcfg, mask, model


def _batch(seed, B=2, S=48, vocab=256, segments=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[:, -5:] = -100
    labels[0, 3] = -100
    seg = np.sort(rng.integers(1, 4, (B, S)), axis=1).astype(np.int32) if segments else None
    return tokens, labels, seg


def _jax_loss_and_grads(params, jcfg, mask, tokens, labels, seg):
    trainable, frozen = partition(params, mask)

    def lfn(t):
        return jllama.forward(merge(t, frozen), jcfg, jnp.asarray(tokens), labels=jnp.asarray(labels),
                              segment_ids=None if seg is None else jnp.asarray(seg))

    loss, grads = jax.value_and_grad(lfn)(trainable)
    return float(loss), {name: np.asarray(g, np.float32) for name, g in named_leaves(grads)}


def _port_loss_and_grads(model, tokens, labels, seg):
    model.zero_grad(set_to_none=True)
    loss = tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels),
                          segment_ids=None if seg is None else torch.from_numpy(seg))
    loss.backward()
    return float(loss.detach()), named_tensors(model, grads=True)


@pytest.mark.parametrize("mode,cfg", [
    ("full", {}),
    ("full", dict(fused_ce_chunks=4, tied_embeddings=True)),
    ("lora", dict(fused_ce_chunks=2)),
    ("dora", {}),
    ("qlora", {}),
])
def test_loss_and_trainable_gradients_match_jax(mode, cfg):
    """fp32: the scalar loss within 1e-5 and every trainable gradient within 1e-4 of
    its largest entry (a whole model's worth of re-ordered fp32 sums; with the int8
    paths also a rounding tie or two)."""
    params, jcfg, mask, model = _pair(mode, **cfg)
    tokens, labels, seg = _batch(1)
    want_loss, want = _jax_loss_and_grads(params, jcfg, mask, tokens, labels, seg)
    got_loss, got = _port_loss_and_grads(model, tokens, labels, seg)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert set(got) == set(want)  # exactly the JAX mask's trainable leaves got a gradient
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-7, err_msg=name)
    if mode == "qlora":
        assert not any("int_data" in n or n.endswith("/scale") and "norm" not in n for n in got)


@pytest.mark.parametrize("mode", ["full", "qlora"])
def test_activation_checkpointing_gives_the_same_gradients(mode):
    """Per-block recomputation changes memory, not numbers: the same loss and
    gradients bit for bit (each block's forward is the same code run twice)."""
    _, _, _, model = _pair(mode)
    tokens, labels, seg = _batch(2)
    loss0, grads0 = _port_loss_and_grads(model, tokens, labels, seg)
    model.config = model.config.replace(activation_checkpointing=True)
    loss1, grads1 = _port_loss_and_grads(model, tokens, labels, seg)
    assert loss0 == loss1
    for name in grads0:
        np.testing.assert_array_equal(grads0[name], grads1[name], err_msg=name)


@pytest.mark.parametrize("policy,exc,match", [
    ("flash_q9", ValueError, "unknown remat_policy"), ("dots_proj", ValueError, "unknown remat_policy"),
])
def test_other_remat_policies_are_refused_by_name(policy, exc, match):
    """Every policy of ``REMAT_POLICIES`` is ported (tests/test_torch_remat.py,
    tests/test_torch_attn_q8.py, under context parallelism tests/test_torch_attn_q8_cp.py); an
    unknown name raises by name, here over a mesh of one rank."""
    from llama_x_tpu_torch.parallel.mesh import make_mesh, use_mesh

    _, _, _, model = _pair("full")
    model.config = model.config.replace(activation_checkpointing=True, remat_policy=policy)
    tokens, labels, seg = _batch(2)
    with use_mesh(make_mesh()), pytest.raises(exc, match=match):
        tllama.forward(model, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _loss_fns(jcfg):
    def jloss(p, mb):
        loss = jllama.forward(p, jcfg, mb["inputs"], segment_ids=mb.get("segment_ids"), labels=mb["labels"])
        return loss, jnp.sum(mb["labels"] != -100)

    return jloss, ttrain_cli.loss_fn


def _count_data(micro_bs, seq_len, seed=0):
    toks_j = jsynth.counting_tokens(48, seed, seq_len // 2, jget_tokenizer("byte", None))
    toks_t = tsynth.counting_tokens(48, seed, seq_len // 2, tget_tokenizer("byte"))
    ji, _ = jdata.get_metamathqa("byte", True, micro_bs, seq_len, tokens_list=toks_j, seed=seed)
    ti, _ = tdata.get_metamathqa("byte", True, micro_bs, seq_len, tokens_list=toks_t, seed=seed)
    return ji, ti


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_twenty_step_run_tracks_the_jax_trainer(dtype, tol):
    """A ``--synthetic``-style QLoRA run (learnable counting task, packed rows with
    segment ids, accumulation 2, warmup / decay, clipping, weight decay) beside the JAX
    trainer on the same initial weights: every step's loss within ``tol`` (relative),
    the loss falls, and grad norms agree likewise."""
    jdt = getattr(jnp, dtype)
    params, jcfg, mask, model = _pair("qlora", dtype=jdt, fill_b=False, vocab_size=320, num_layers=2)
    jloss, tloss = _loss_fns(jcfg)
    lr, steps, accum = 1e-2, 20, 2
    tx = joptim.get_optimizer("AdamW", joptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    jstate = jtrainer.init_train_state(params, mask, tx)
    jstep = jax.jit(jtrainer.make_train_step(jloss, tx))
    opt = toptim.get_optimizer("AdamW", ttrainer.trainable_parameters(model),
                               toptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    tstate = ttrainer.TrainState(model, opt)
    tstep = ttrainer.make_train_step(tloss)
    ji, ti = _count_data(2, 64)
    jl, tl, jg, tg = [], [], [], []
    for _ in range(steps):
        jb = jassemble([next(ji) for _ in range(accum)], pad_values={"labels": -100})
        tb = tcli.assemble_step_batch([next(ti) for _ in range(accum)], pad_values={"labels": -100})
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        jstate, jm = jstep(jstate, jb)
        tm = tstep(tstate, tb)
        assert int(tm["n_tokens"]) == int(jm["n_tokens"]) and float(tm["skipped"]) == 0.0
        jl.append(float(jm["loss"])), tl.append(float(tm["loss"]))
        jg.append(float(jm["grad_norm"])), tg.append(float(tm["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=tol)
    np.testing.assert_allclose(tg, jg, rtol=10 * tol)
    assert tl[-1] < 0.9 * tl[0] and tstate.step == steps
    # the trained adapters agree too, and the frozen tensors never moved
    want = {n: np.asarray(v, np.float32) for n, v in named_leaves(jtrainer.full_params(jstate))}
    got = named_tensors(model)
    # (Adam divides by sqrt(v): an entry whose gradients are tiny moves by about lr a step
    # whatever their size, so the parameters are held to a share of steps * lr, the most
    # an entry can have moved: 2% in fp32, 10% in bf16, for all but 1 entry in 100, whose
    # gradients are rounding noise on both sides and whose Adam steps follow their signs)
    for name in ("layers/attention/wq/lora_b", "layers/feed_forward/w2/lora_a", "layers/ffn_norm/scale"):
        off = np.abs(got[name] - want[name]) > (0.02 if dtype == "float32" else 0.1) * steps * lr
        assert off.mean() <= 0.01, (name, off.mean())
    for name in ("layers/attention/wq/int_data", "layers/attention/wq/scale", "tok_embeddings/weight", "output/kernel",
                 "norm/scale", "layers/attention/wq/lora_scale"):
        np.testing.assert_array_equal(got[name], want[name])


def test_gradient_accumulation_is_the_mean_of_the_microbatch_gradients():
    """accum = 2 takes the step that one AdamW update on the fp32 mean of the two
    microbatch gradients takes, and reports the mean loss and the summed tokens."""
    _, _, _, model = _pair("lora", seed=3)
    _, _, _, twin = _pair("lora", seed=3)
    b1, b2 = _batch(4, segments=False), _batch(5, segments=False)
    batch = {"inputs": np.stack([b1[0], b2[0]]), "labels": np.stack([b1[1], b2[1]])}
    opt = toptim.AdamW(ttrainer.trainable_parameters(model), 1e-2)
    metrics = ttrainer.make_train_step(ttrain_cli.loss_fn)(ttrainer.TrainState(model, opt), batch)

    params = ttrainer.trainable_parameters(twin)
    losses, grads = [], []
    for tokens, labels, _ in (b1, b2):
        loss, _ = ttrain_cli.loss_fn(twin, {"inputs": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
        grads.append(torch.autograd.grad(loss, params))
        losses.append(float(loss.detach()))
    mean = [(a.float() + b.float()) / 2 for a, b in zip(*grads)]
    toptim.AdamW(params, 1e-2).step(mean)
    assert float(metrics["loss"]) == pytest.approx(sum(losses) / 2, rel=1e-6)
    assert float(metrics["grad_norm"]) == pytest.approx(float(toptim.global_norm(mean)), rel=1e-6)
    assert int(metrics["n_tokens"]) == int((b1[1] != -100).sum() + (b2[1] != -100).sum())
    for a, b in zip(ttrainer.trainable_parameters(model), params):
        assert torch.equal(a, b)


def test_frozen_tensors_do_not_move_and_adapters_do():
    _, _, _, model = _pair("qlora", fill_b=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = toptim.AdamW(ttrainer.trainable_parameters(model), 1e-2)
    state = ttrainer.TrainState(model, opt)
    tokens, labels, seg = _batch(6)
    batch = {"inputs": tokens[None], "labels": labels[None], "segment_ids": seg[None]}
    for _ in range(2):
        ttrainer.make_train_step(ttrain_cli.loss_fn)(state, batch)
    trainable = {n for n, _ in state.trainable}
    assert trainable and all(n.endswith(("lora_a", "lora_b")) or "norm.scale" in n for n in trainable)
    for name, t in model.state_dict().items():
        moved = not torch.equal(t, before[name])
        assert moved == (name in trainable), name


def test_skip_nonfinite_suppresses_the_whole_update():
    _, _, _, model = _pair("lora", seed=1)
    opt = toptim.AdamW(ttrainer.trainable_parameters(model), 1e-2)
    state = ttrainer.TrainState(model, opt)
    tokens, labels, _ = _batch(7, segments=False)
    batch = {"inputs": tokens[None], "labels": labels[None]}

    def bad_loss(m, mb):
        loss, n = ttrain_cli.loss_fn(m, mb)
        return loss * float("nan"), n

    before = [p.clone() for p in opt.params]
    metrics = ttrainer.make_train_step(bad_loss, skip_nonfinite=True)(state, batch)
    assert float(metrics["skipped"]) == 1.0 and not np.isfinite(float(metrics["grad_norm"]))
    assert all(torch.equal(a, b) for a, b in zip(opt.params, before))
    assert opt.count == 0 and all(float(m.abs().max()) == 0.0 for m in opt.mu) and state.step == 1
    # without the guard the same batch poisons the parameters
    metrics = ttrainer.make_train_step(bad_loss)(state, batch)
    assert float(metrics["skipped"]) == 0.0 and bool(torch.isnan(opt.params[0]).any())


@pytest.mark.parametrize("optim", ["AdamW", "AdamW8bit"])
def test_checkpoint_resume_is_exact(tmp_path, optim):
    """Three steps, save, two more; a fresh model restored from the save and given the
    same two batches ends bit-identical in parameters, optimizer state and step."""
    def fresh():
        _, _, _, model = _pair("qlora", fill_b=False, seed=2)
        opt = toptim.get_optimizer(optim, ttrainer.trainable_parameters(model), toptim.trapezoid_schedule(1e-2, 5, 0.2))
        return ttrainer.TrainState(model, opt)

    step = ttrainer.make_train_step(ttrain_cli.loss_fn)
    batches = []
    for i in range(5):
        tokens, labels, seg = _batch(10 + i)
        batches.append({"inputs": tokens[None], "labels": labels[None], "segment_ids": seg[None]})
    a = fresh()
    for b in batches[:3]:
        step(a, b)
    path = tckpt.save_checkpoint(tmp_path, a, a.step)
    assert tckpt.latest_checkpoint(tmp_path) == path and path.name == "step_00000003"
    for b in batches[3:]:
        step(a, b)
    r = tckpt.restore_checkpoint(tckpt.latest_checkpoint(tmp_path), fresh())
    assert r.step == 3 and r.optimizer.count == 3
    for b in batches[3:]:
        step(r, b)
    for (k, x), y in zip(a.model.state_dict().items(), r.model.state_dict().values()):
        assert torch.equal(x, y), k
    flat = lambda s: [t for m in s for t in (m if isinstance(m, tuple) else (m,))]
    for x, y in zip(flat(a.optimizer.mu + a.optimizer.nu), flat(r.optimizer.mu + r.optimizer.nu)):
        assert torch.equal(x, y)
    # saving the same step again keeps the bytes and repoints "last"
    assert tckpt.save_checkpoint(tmp_path, a, 3) == path
