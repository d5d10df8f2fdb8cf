"""The port's image path against the JAX package's on the same numpy inputs, on the CPU:
the patch-embed stem, ``params_from_jax`` with it, ``vision.forward`` loss and every
trainable gradient (float and QLoRA, causal and prefix-LM, with and without the stem
recomputed), a 10-step loss curve beside the JAX trainer's pieces on
``synthetic_shapes_batches``, and the ``train_vision`` entry point.

Tolerances, stated at each test: the stem is one reshape and one matmul, which the
two frameworks compute bit for bit at these sizes in fp32 and in bf16; losses and
gradients run in fp32 and differ by summation order (1e-5 relative for a loss, 2e-4
of a tensor's largest entry for gradients)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.data import vision as jdata
from llama_x_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models import vision as jvision
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu.train.cli import assemble_step_batch as jassemble
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch import train_vision as ttrain_cli
from llama_x_tpu_torch.adapters.lora import tree_path
from llama_x_tpu_torch.data import vision as tdata
from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models import vision as tvision
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

CFG = dict(embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2, intermediate_dim=128, vocab_size=288,
           max_seq_len=128)
VC = dict(image_size=32, patch_size=8)


def _pair(mode="float", seed=0, use_newline=True, **cfg):
    """(JAX params, JAX config, JAX mask, port model) of a LlamaVision in fp32: "float"
    (everything trains) or "qlora" (int8 base, int8 act and dgrad, LoRA with live lora_b,
    fused CE with the int8 head, embeddings / head / final norm frozen, stem trainable)."""
    kw = dict(CFG)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True, int8_head=True, fused_ce_chunks=4)
    kw.update(cfg)
    jcfg = jllama.tiny_config(**kw)
    jvc = jvision.VisionConfig(**VC, use_newline=use_newline)
    params = jvision.LlamaVision.init(jax.random.PRNGKey(seed), jcfg, jvc, dtype=jnp.float32).params
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
    frozen_head = not mask["output"]["kernel"]
    jcfg = jcfg.replace(frozen_head=frozen_head)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**kw).replace(frozen_head=frozen_head),
                            device="cpu", freeze_prefixes=freeze,
                            vision_config=tvision.VisionConfig(**VC, use_newline=use_newline))
    return params, jcfg, mask, model


def _images(seed, B=2, size=32):
    return np.random.default_rng(seed).standard_normal((B, size, size, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# the stem
# ---------------------------------------------------------------------------


def test_vision_config_counts_tokens_as_the_jax_package():
    for size, ps, nl in ((224, 14, True), (224, 14, False), (32, 8, True), (336, 14, True)):
        t, j = tvision.VisionConfig(size, ps, use_newline=nl), jvision.VisionConfig(size, ps, use_newline=nl)
        assert t.num_image_tokens() == j.num_image_tokens() and t.patches_per_side == j.patches_per_side
    assert tvision.VisionConfig().num_image_tokens() == 272
    with pytest.raises(ValueError, match="divide"):
        tvision.VisionConfig(30, 8).num_image_tokens()


@pytest.mark.parametrize("use_newline", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_embed_matches_jax_bit_for_bit(dtype, use_newline):
    """[B, 32, 32, 3] -> [B, 16 (+4 newlines), 64]: equal bit for bit in fp32 and in
    bf16 (one matmul rounded to the dtype, then the bias in the dtype, on both sides)."""
    params, _, _, model = _pair(use_newline=use_newline)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    stem = jax.tree.map(lambda a: a.astype(jdt), params["patch_embed"])
    model.patch_embed.to(tdt)
    images = _images(1)
    want = np.asarray(jvision.patch_embed(stem, jvision.VisionConfig(**VC, use_newline=use_newline),
                                          jnp.asarray(images), dtype=jdt).astype(jnp.float32))
    got = tvision.patch_embed(model.patch_embed, model.vision_config, torch.from_numpy(images), dtype=tdt)
    assert got.dtype == tdt and got.shape == want.shape == (2, 20 if use_newline else 16, 64)
    np.testing.assert_array_equal(got.float().detach().numpy(), want)


def test_patch_layout_is_row_col_channel():
    """A patch's features run (row, column, channel), patches row-major, the newline
    after each row: checked through an identity-like projection on a canvas whose
    pixels name their own coordinates (a wrong permute still trains, so only this shows it)."""
    ps, n = 4, 2
    H = ps * n
    img = np.zeros((1, H, H, 3), np.float32)
    for y in range(H):
        for x in range(H):
            img[0, y, x] = (y, x, 100 + y * H + x)
    fan_in = ps * ps * 3
    stem = tvision.PatchEmbed(torch.eye(fan_in), torch.zeros(fan_in), torch.full((fan_in,), -1.0))
    tok = tvision.patch_embed(stem, tvision.VisionConfig(H, ps), torch.from_numpy(img), dtype=torch.float32)[0]
    assert tok.shape == (n * n + n, fan_in)
    row1_col0 = tok[n + 1].reshape(ps, ps, 3)  # second patch row (after one newline), first column
    assert row1_col0[0, 0].tolist() == [ps, 0, 100 + ps * H]
    assert row1_col0[1, 2].tolist() == [ps + 1, 2, 100 + (ps + 1) * H + 2]
    assert (tok[n] == -1).all() and (tok[2 * n + 1] == -1).all()  # the newline rows


def test_params_from_jax_carries_the_patch_stem():
    params, _, mask, model = _pair("qlora")
    assert isinstance(model, tvision.LlamaVision) and model.vision_config == tvision.VisionConfig(**VC)
    got = named_tensors(model)
    want = {n: np.asarray(v, np.float32) for n, v in named_leaves(params)}
    assert set(want) - set(got) == set() and got["patch_embed/proj/kernel"].shape == (192, 64)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert model.patch_embed.proj.weight.shape == (64, 192)  # nn.Linear holds the [fan_in, D] kernel's transpose
    assert {tree_path(n) for n, p in model.named_parameters() if p.requires_grad} == {
        n for n, m in named_leaves(mask) if m}
    freeze = ("patch_embed", "tok_embeddings", "output", "norm")
    frozen = params_from_jax(jax.tree.map(np.asarray, params), model.config, device="cpu", freeze_prefixes=freeze,
                             vision_config=model.vision_config)
    assert not any(p.requires_grad for p in frozen.patch_embed.parameters())
    with pytest.raises(FileNotFoundError, match="never downloads"):  # a hub id: local directories only
        tvision.LlamaVision.from_hf("meta-llama/Llama-3.1-8B")


def test_init_patch_embed_draws_the_jax_distributions():
    config = tllama.tiny_config(embed_dim=256)
    stem = tvision.init_patch_embed(config, tvision.VisionConfig(), torch.Generator().manual_seed(0), torch.float32)
    w, b, nl = stem.proj.weight, stem.proj.bias, stem.newline
    bound = 588**-0.5
    assert w.shape == (256, 588) and b.shape == (256,) and nl.shape == (256,)
    assert float(w.abs().max()) <= bound and float(w.detach().std()) == pytest.approx(bound / 3**0.5, rel=0.05)
    assert float(b.abs().max()) <= bound and float(nl.detach().std()) == pytest.approx(0.02, rel=0.2)
    model = tvision.LlamaVision.init(config, tvision.VisionConfig(), seed=3, dtype=torch.float32, device="cpu")
    again = tvision.LlamaVision.init(config, tvision.VisionConfig(), seed=3, dtype=torch.float32, device="cpu")
    assert torch.equal(model.patch_embed.proj.weight, again.patch_embed.proj.weight)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _batch(seed, B=2, S=16, vocab=288):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
    labels[:, -1] = -100
    return _images(seed, B), tokens, labels


@pytest.mark.parametrize("mode,prefix_lm,remat,int8_bwd", [
    ("float", False, None, False), ("float", True, "full", False), ("qlora", True, None, False),
    ("qlora", True, "full", False), ("qlora", False, "flash_proj", False), ("qlora", True, "flash_proj", True),
])
def test_vision_forward_loss_and_gradients_match_jax(mode, prefix_lm, remat, int8_bwd):
    """Loss within 1e-5 and every trainable gradient (adapters or weights, and the stem)
    within 2e-4 of its largest entry. With ``activation_checkpointing`` the stem is
    recomputed in the backward (``jax.checkpoint`` on the JAX side): the same numbers.

    With ``dynamic_int8_bwd`` each input gradient row is quantized to int8 on its way
    through the frozen base, and the two frameworks' fp32 sums, a few ulps apart, put
    an entry on either side of a rounding tie now and then (in 4 of 6 seeds tried):
    that row moves by one int8 step, 1/127 of its largest entry, and the gradients below
    it by up to 3.2e-3 of their largest entry; that case is held to 4e-3."""
    cfg = {} if remat is None else dict(activation_checkpointing=True, remat_policy=remat)
    params, jcfg, mask, model = _pair(mode, dynamic_int8_bwd=int8_bwd and mode == "qlora", **cfg)
    jcfg = jcfg.replace(attn_impl="xla")
    images, tokens, labels = _batch(5)
    trainable, frozen = partition(params, mask)
    jvc = jvision.VisionConfig(**VC)

    def lfn(t):
        return jvision.forward(merge(t, frozen), jcfg, jvc, jnp.asarray(images), jnp.asarray(tokens),
                               labels=jnp.asarray(labels), prefix_lm=prefix_lm)

    want_loss, want = jax.value_and_grad(lfn)(trainable)
    loss = tvision.forward(model, torch.from_numpy(images), torch.from_numpy(tokens).long(),
                           labels=torch.from_numpy(labels), prefix_lm=prefix_lm)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = named_tensors(model, grads=True)
    want = {n: np.asarray(g, np.float32) for n, g in named_leaves(want)}
    assert set(got) == set(want) and "patch_embed/proj/kernel" in got
    tol = 4e-3 if int8_bwd else 2e-4
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=tol, atol=tol * np.abs(w).max() + 1e-7, err_msg=name)
    # text only (images=None) is the text model's loss
    t_only = tvision.forward(model, None, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels))
    j_only = jvision.forward(params, jcfg, jvc, None, jnp.asarray(tokens), labels=jnp.asarray(labels))
    assert float(t_only.detach()) == pytest.approx(float(j_only), rel=1e-5)


def test_vision_logits_with_a_cache_match_jax():
    """Prefill of image tokens + text through the cache under prefix-LM, as the caption
    evaluation runs it: logits within 2e-4."""
    params, jcfg, _, model = _pair()
    images, tokens, _ = _batch(6, S=5)
    n = 20 + 5
    jcache = jllama.init_kv_cache(jcfg, 2, dtype=jnp.float32)
    want, _ = jvision.forward(params, jcfg, jvision.VisionConfig(**VC), jnp.asarray(images), jnp.asarray(tokens),
                              prefix_lm=True, kv_cache=jcache, input_pos=jnp.arange(n), kv_len=jnp.full((2,), n))
    tcache = tllama.init_kv_cache(model.config, 2, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, _ = tvision.forward(model, torch.from_numpy(images), torch.from_numpy(tokens).long(), prefix_lm=True,
                                 kv_cache=tcache, input_pos=torch.arange(n), kv_len=torch.full((2,), n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_ten_step_run_tracks_the_jax_trainer():
    """A ``train_vision --synthetic`` QLoRA run (prefix-LM, accumulation 2, stem and
    adapters training, clipping) beside the JAX trainer's pieces on the same initial
    weights and the same ``synthetic_shapes_batches``: every step's loss within 2e-4
    (relative) and the grad norms within 5e-3 (an int8 rounding tie moved by the sixth
    digit moves a grad norm by more than the loss, as in the audio curve)."""
    params, jcfg, mask, model = _pair("qlora")
    jcfg = jcfg.replace(attn_impl="xla")
    jvc = jvision.VisionConfig(**VC)

    def jloss(p, mb):
        loss = jvision.forward(p, jcfg, jvc, mb["images"], mb["tokens"], labels=mb["labels"], prefix_lm=True)
        return loss, jnp.sum(mb["labels"] != -100)

    lr, steps, accum = 1e-2, 10, 2
    tx = joptim.get_optimizer("AdamW", joptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    jstate = jtrainer.init_train_state(params, mask, tx)
    jstep = jax.jit(jtrainer.make_train_step(jloss, tx))
    opt = toptim.get_optimizer("AdamW", ttrainer.trainable_parameters(model),
                               toptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    tstate = ttrainer.TrainState(model, opt)
    tstep = ttrainer.make_train_step(ttrain_cli.make_loss_fn(prefix_lm=True))
    ji = jdata.synthetic_shapes_batches(np.random.default_rng(0), JByteTokenizer(), 2, 32, 32)
    ti = tdata.synthetic_shapes_batches(np.random.default_rng(0), ByteTokenizer(), 2, 32, 32)
    jl, tl, jg, tg = [], [], [], []
    for _ in range(steps):
        jb = jassemble([next(ji) for _ in range(accum)], pad_values={"labels": -100})
        tb = tcli.assemble_step_batch([next(ti) for _ in range(accum)], pad_values={"labels": -100})
        jstate, jm = jstep(jstate, jb)
        tm = tstep(tstate, tb)
        assert int(tm["n_tokens"]) == int(jm["n_tokens"])
        jl.append(float(jm["loss"])), tl.append(float(tm["loss"]))
        jg.append(float(jm["grad_norm"])), tg.append(float(tm["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    np.testing.assert_allclose(tg, jg, rtol=5e-3)
    assert tl[-1] < tl[0]
    got = named_tensors(model)
    moved = np.abs(got["patch_embed/proj/kernel"] - np.asarray(params["patch_embed"]["proj"]["kernel"])).max()
    assert moved > 1e-4  # the stem trains


QLORA_FLAGS = [
    "--synthetic", "16", "--device", "cpu", "--dtype", "float32", "--quantize", "int8", "--quantize_kwargs",
    '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
    "--freeze_prefixes", "tok_embeddings", "output", "norm", "patch_embed", "--activation_checkpointing",
    "--fused_ce_chunks", "2", "--prefix_lm", "--image_size", "32", "--patch_size", "8", "--batch_size", "4",
    "--gradient_accumulation", "2", "--lr", "1e-2", "--log_interval", "1", "--ckpt_interval", "0",
    "--synthetic_config", '{"num_layers": 2, "embed_dim": 64}',
]


@pytest.mark.parametrize("policy", ["full", "flash_proj"])
def test_train_vision_entry_point_runs_on_the_cpu(policy, tmp_path, monkeypatch):
    """``train_vision.main`` itself: a frozen stem, its own loop, the logger, the
    model config with the vision config, the end-of-run checkpoint."""
    monkeypatch.chdir(tmp_path)
    ttrain_cli.main([*QLORA_FLAGS, "--remat_policy", policy, "--n_steps", "3"])
    (run,) = (tmp_path / "runs" / "vision").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    config = json.loads((run / "model_config.json").read_text())
    assert config["vision"] == {"image_size": 32, "patch_size": 8, "in_channels": 3, "use_newline": True}
    assert config["llama"]["max_seq_len"] == 16 + 4 + 512 and config["llama"]["remat_policy"] == policy
    assert (run / "step_00000003").exists()


def test_build_model_params_with_a_patch_stem_at_a_geometry():
    args = ttrain_cli.parse_args(["--synthetic", "4", "--device", "cpu", "--geometry", "tiny", "--quantize", "int8",
                                  "--adapter", "lora", "--freeze_prefixes", "tok_embeddings", "output", "norm",
                                  "patch_embed", "--image_size", "32", "--patch_size", "8"])
    model = tcli.build_model_params(args, max_seq_len=64, vision_config=tvision.VisionConfig(32, 8))
    assert isinstance(model, tvision.LlamaVision)
    stem = dict(model.patch_embed.named_parameters())
    assert set(stem) == {"proj.weight", "proj.bias", "newline"}
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in stem.values())
    assert model.layers[0].attention.wq.lora_a.requires_grad and model.config.frozen_head
    # a depth cut of a geometry through --synthetic_config, and a tokenizer that does not fit it
    cut = ttrain_cli.parse_args(["--synthetic", "4", "--device", "cpu", "--geometry", "tiny", "--synthetic_config",
                                 '{"num_layers": 1}'])
    assert tcli.build_model_params(cut, max_seq_len=64).config.num_layers == 1
    with pytest.raises(ValueError, match="do not fit"):
        tcli.build_model_params(cut, max_seq_len=64, vocab_size=128_256)


def test_train_vision_refuses_what_is_not_ported():
    """The pp branch (slice 5b) is ported: ``--mesh '{"pp": 2}'`` parses; a run without data
    still raises."""
    assert ttrain_cli.parse_args(["--synthetic", "4", "--mesh", '{"pp": 2}', "--device", "cpu"]).mesh == {"pp": 2}
    assert ttrain_cli.parse_args(["--dataset_dir", "x", "--model", "m", "--device", "cpu"]).model == "m"  # slice 3
    with pytest.raises(ValueError, match="--dataset_dir"):
        ttrain_cli.parse_args(["--device", "cpu"])
    args = ttrain_cli.parse_args(["--dataset_dir", "captions"])
    assert args.device == "cuda" and (args.image_size, args.patch_size, args.seq_len_multiple) == (224, 14, 32)
