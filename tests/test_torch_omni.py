"""The port's omni path (audio + image + text) against the JAX package's on the same
numpy inputs, on the CPU: ``params_from_jax`` with both stems, ``omni.forward`` loss and
every trainable gradient with either modality or both, the prefix order (audio, then
image), ``synthetic_omni_batches`` against the JAX trainer's, a 10-step loss curve
beside the JAX trainer's pieces, and the ``train_omni`` entry point.

Tolerances, stated at each test: fp32 on both sides, apart by summation order (1e-5
relative for a loss, 2e-4 of a tensor's largest entry for gradients; 4e-3 where the
input gradients go through int8, whose rounding ties the two frameworks' sums split now
and then, as tests/test_torch_vision.py sets out; 2e-4 for the loss curve)."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import audio as jaudio
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models import omni as jomni
from llama_x_tpu.models import vision as jvision
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu.train.cli import assemble_step_batch as jassemble
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch import train_omni as ttrain_cli
from llama_x_tpu_torch.adapters.lora import tree_path
from llama_x_tpu_torch.models import audio as taudio
from llama_x_tpu_torch.models import fusion as tfusion
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models import omni as tomni
from llama_x_tpu_torch.models import vision as tvision
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CFG = dict(embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2, intermediate_dim=128, vocab_size=256,
           max_seq_len=128)
VC = dict(image_size=32, patch_size=8)


def _jax_trainer_module():
    """The JAX package's train_omni.py (a script at the repository root)."""
    spec = importlib.util.spec_from_file_location("jax_train_omni", REPO / "train_omni.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pair(mode="float", seed=0, **cfg):
    """(JAX params, JAX config, JAX mask, port model) of a LlamaOmni in fp32: "float"
    (everything trains) or "qlora" (int8 base, int8 act and dgrad, LoRA with live lora_b,
    fused CE with the int8 head, embeddings / head / final norm frozen, stems trainable)."""
    kw = dict(CFG)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True, int8_head=True, fused_ce_chunks=4)
    kw.update(cfg)
    jcfg = jllama.tiny_config(**kw)
    params = jomni.LlamaOmni.init(jax.random.PRNGKey(seed), jcfg, jaudio.AudioConfig(), jvision.VisionConfig(**VC),
                                  dtype=jnp.float32).params
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
                            device="cpu", freeze_prefixes=freeze, vision_config=tvision.VisionConfig(**VC))
    return params, jcfg, mask, model


def _batch(seed, B=2, T=4000, S=16, vocab=256):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
    labels[:, -1] = -100
    return audio, images, tokens, labels


def test_params_from_jax_carries_both_stems():
    params, _, mask, model = _pair("qlora")
    assert isinstance(model, tomni.LlamaOmni)
    assert model.audio_config == taudio.AudioConfig() and model.vision_config == tvision.VisionConfig(**VC)
    got = named_tensors(model)
    want = {n: np.asarray(v, np.float32) for n, v in named_leaves(params)}
    assert set(want) - set(got) == set()
    assert {"audio_embed/conv1/kernel", "patch_embed/proj/kernel", "patch_embed/newline"} <= set(got)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert {tree_path(n) for n, p in model.named_parameters() if p.requires_grad} == {
        n for n, m in named_leaves(mask) if m}
    freeze = ("audio_embed", "patch_embed", "tok_embeddings", "output", "norm")
    frozen = params_from_jax(jax.tree.map(np.asarray, params), model.config, device="cpu", freeze_prefixes=freeze,
                             vision_config=model.vision_config)
    assert not any(p.requires_grad for n, p in frozen.named_parameters() if n.split(".")[0].endswith("_embed"))
    with pytest.raises(FileNotFoundError, match="never downloads"):  # a hub id: local directories only
        tomni.LlamaOmni.from_hf("meta-llama/Llama-3.1-8B")


@pytest.mark.parametrize("mode,prefix_lm,remat,which,int8_act", [
    ("float", True, None, "both", False), ("float", False, "full", "both", False),
    ("qlora", True, None, "both", False), ("qlora", True, "flash_proj", "both", False),
    ("qlora", True, "full", "audio", False), ("qlora", True, None, "image", True),
    ("qlora", True, "flash_q8s", "image", True),
])
def test_omni_forward_loss_and_gradients_match_jax(mode, prefix_lm, remat, which, int8_act):
    """Loss within 1e-5 and every trainable gradient (adapters or weights, both stems)
    within 2e-4 of its largest entry. A stem whose modality is absent gets zeros from JAX
    and no gradient here.

    With audio the QLoRA cases keep an int8 base but float activations and input
    gradients: the audio stem's output differs from the JAX one in the sixth digit (the
    fp32 FFT), and the dynamic int8 quantizer then puts an activation on the other side
    of a rounding tie now and then, which moves the loss by 1e-4 and some gradient
    entries by more than any summation-order tolerance (the 10-step curve below holds
    that configuration, as the audio curve does). Image-only cases run the full int8
    path (the stem agrees bit for bit), with the int8 input gradients' own ties at 4e-3."""
    cfg = {} if remat is None else dict(activation_checkpointing=True, remat_policy=remat)
    if mode == "qlora":
        cfg.update(dynamic_int8_act=int8_act, dynamic_int8_bwd=int8_act)
    params, jcfg, mask, model = _pair(mode, **cfg)
    jcfg = jcfg.replace(attn_impl="xla")
    audio, images, tokens, labels = _batch(5)
    audio = audio if which in ("both", "audio") else None
    images = images if which in ("both", "image") else None
    trainable, frozen = partition(params, mask)
    as_j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    as_t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731

    def lfn(t):
        return jomni.forward(merge(t, frozen), jcfg, jaudio.AudioConfig(), jvision.VisionConfig(**VC), as_j(audio),
                             as_j(images), jnp.asarray(tokens), labels=jnp.asarray(labels), prefix_lm=prefix_lm)

    want_loss, want = jax.value_and_grad(lfn)(trainable)
    loss = tomni.forward(model, as_t(audio), as_t(images), torch.from_numpy(tokens).long(),
                         labels=torch.from_numpy(labels), prefix_lm=prefix_lm)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = named_tensors(model, grads=True)
    want = {n: np.asarray(g, np.float32) for n, g in named_leaves(want)}
    absent = {n for n in want if n.startswith("audio_embed" if audio is None else "patch_embed" if images is None
                                               else "-")}
    assert all(np.abs(want[n]).max() == 0 for n in absent) and set(got) == set(want) - absent
    tol = 4e-3 if int8_act else 2e-4
    for name, g in got.items():
        w = want[name]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * np.abs(w).max() + 1e-7, err_msg=name)


def test_omni_prefix_is_audio_then_image():
    """The logits equal ``fuse_forward`` over [audio tokens, image tokens] in that order,
    and differ from the other order."""
    _, _, _, model = _pair()
    audio, images, tokens, _ = (torch.from_numpy(a) for a in _batch(7))
    with torch.no_grad():
        a = taudio.audio_embed(model.audio_embed, model.audio_config, audio, dtype=torch.float32)
        im = tvision.patch_embed(model.patch_embed, model.vision_config, images, dtype=torch.float32)
        got = tomni.forward(model, audio, images, tokens.long(), prefix_lm=True)
        want = tfusion.fuse_forward(model, [a, im], tokens.long(), prefix_lm=True)
        swapped = tfusion.fuse_forward(model, [im, a], tokens.long(), prefix_lm=True)
    assert torch.equal(got, want) and float((got - swapped).abs().max()) > 1e-3


def test_synthetic_omni_batches_equal_the_jax_trainer():
    """Images, then audio, then tokens from one generator, array for array."""
    jmod = _jax_trainer_module()
    ji = jmod.synthetic_omni_batches(np.random.default_rng(3), jaudio.AudioConfig(), 2, 0.5, 32, 16, 256)
    ti = ttrain_cli.synthetic_omni_batches(np.random.default_rng(3), taudio.AudioConfig(), 2, 0.5, 32, 16, 256)
    for _ in range(3):
        jb, tb = next(ji), next(ti)
        assert set(jb) == set(tb) == {"audio", "images", "tokens", "labels"}
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
            assert jb[k].dtype == tb[k].dtype


def test_ten_step_run_tracks_the_jax_trainer():
    """A ``train_omni --synthetic`` QLoRA run (prefix-LM, accumulation 2, stems and
    adapters training, clipping) beside the JAX trainer's pieces on the same initial
    weights and the same ``synthetic_omni_batches``: every step's loss within 2e-4
    (relative) and the grad norms within 5e-3, as the audio curve holds them."""
    params, jcfg, mask, model = _pair("qlora")
    jcfg = jcfg.replace(attn_impl="xla")
    jac, jvc = jaudio.AudioConfig(), jvision.VisionConfig(**VC)

    def jloss(p, mb):
        loss = jomni.forward(p, jcfg, jac, jvc, mb["audio"], mb["images"], mb["tokens"], labels=mb["labels"],
                             prefix_lm=True)
        return loss, jnp.sum(mb["labels"] != -100)

    lr, steps, accum = 1e-2, 10, 2
    tx = joptim.get_optimizer("AdamW", joptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    jstate = jtrainer.init_train_state(params, mask, tx)
    jstep = jax.jit(jtrainer.make_train_step(jloss, tx))
    opt = toptim.get_optimizer("AdamW", ttrainer.trainable_parameters(model),
                               toptim.trapezoid_schedule(lr, steps, 0.1, 0.2), 0.01, 1.0)
    tstate = ttrainer.TrainState(model, opt)
    tstep = ttrainer.make_train_step(ttrain_cli.make_loss_fn(prefix_lm=True))
    jmod = _jax_trainer_module()
    ji = jmod.synthetic_omni_batches(np.random.default_rng(0), jac, 2, 0.25, 32, 16, 256)
    ti = ttrain_cli.synthetic_omni_batches(np.random.default_rng(0), taudio.AudioConfig(), 2, 0.25, 32, 16, 256)
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
    got = named_tensors(model)
    for path, start in (("audio_embed/conv2/kernel", params["audio_embed"]["conv2"]["kernel"]),
                        ("patch_embed/proj/kernel", params["patch_embed"]["proj"]["kernel"])):
        assert np.abs(got[path] - np.asarray(start)).max() > 1e-4, path  # both stems train


QLORA_FLAGS = [
    "--synthetic", "8", "--device", "cpu", "--dtype", "float32", "--quantize", "int8", "--quantize_kwargs",
    '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
    "--freeze_prefixes", "tok_embeddings", "output", "norm", "audio_embed", "patch_embed",
    "--activation_checkpointing", "--fused_ce_chunks", "2", "--prefix_lm", "--audio_duration", "0.5",
    "--image_size", "32", "--patch_size", "8", "--seq_len_multiple", "32", "--lr", "1e-2", "--log_interval", "1",
    "--ckpt_interval", "0", "--synthetic_config", '{"num_layers": 2, "embed_dim": 64}',
]


@pytest.mark.parametrize("policy", ["flash_proj", "flash_q8s"])
def test_train_omni_entry_point_runs_on_the_cpu(policy, tmp_path, monkeypatch):
    """``train_omni.main`` itself: frozen stems, its own loop, the logger with audio
    seconds per second, both configs beside the checkpoint."""
    monkeypatch.chdir(tmp_path)
    ttrain_cli.main([*QLORA_FLAGS, "--remat_policy", policy, "--n_steps", "3"])
    (run,) = (tmp_path / "runs" / "omni").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs) and recs[-1]["audio_secs_per_second"] > 0
    config = json.loads((run / "model_config.json").read_text())
    assert config["audio"]["n_mels"] == 128 and config["vision"]["patch_size"] == 8
    assert config["llama"]["max_seq_len"] == 25 + 20 + 1024
    assert (run / "step_00000003").exists()


def test_build_model_params_with_both_stems():
    args = ttrain_cli.parse_args(["--synthetic", "4", "--device", "cpu", "--geometry", "tiny", "--quantize", "int8",
                                  "--adapter", "lora", "--freeze_prefixes", "tok_embeddings", "output", "norm",
                                  "audio_embed", "patch_embed", "--image_size", "32", "--patch_size", "8"])
    audio_config, vision_config, max_seq_len = ttrain_cli.configs(args)
    assert max_seq_len == 2000 + 20 + 1024
    model = tcli.build_model_params(args, max_seq_len=max_seq_len, audio_config=audio_config,
                                    vision_config=vision_config)
    assert isinstance(model, tomni.LlamaOmni)
    stems = [p for n, p in model.named_parameters() if n.split(".")[0] in ("audio_embed", "patch_embed")]
    assert len(stems) == 7 and all(p.dtype == torch.bfloat16 and not p.requires_grad for p in stems)
    assert model.layers[0].attention.wq.lora_a.requires_grad and model.config.frozen_head


def test_train_omni_refuses_what_is_not_ported():
    """The pp branch (slice 5b) is ported: ``--mesh '{"pp": 2}'`` and ``--pp_microbatches`` parse;
    a run without data still raises."""
    args = ttrain_cli.parse_args(["--synthetic", "4", "--mesh", '{"pp": 2}', "--pp_microbatches", "4", "--device", "cpu"])
    assert args.mesh == {"pp": 2} and args.pp_microbatches == 4
    with pytest.raises(ValueError, match="--dataset_dir"):
        ttrain_cli.parse_args(["--device", "cpu"])
    args = ttrain_cli.parse_args(["--dataset_dir", "corpus"])
    assert args.device == "cuda" and (args.audio_duration, args.image_size, args.max_text_len) == (40.0, 224, 1024)
