"""The port's audio path against the JAX package's on the same numpy inputs, on the CPU:
the frontend (both spectral backends), the conv stem, ``fuse_forward`` with and without
prefix-LM attention and with a cache, ``audio.forward`` loss and every trainable
gradient, a 10-step loss curve beside the JAX trainer on ``synthetic_audio_batches``,
``params_from_jax`` with a stem, the ``train_librispeech`` and ``probe_flash`` entry
points, and the probe kernel's plain version.

Tolerances, stated at each test: everything runs in fp32 and differs by summation order
(1e-5 class for a loss, 1e-4 of a tensor's largest entry for gradients and activations);
the power spectrum spans ten orders of magnitude, so it is held relative to its largest
entry (2e-5) and the log-mel, which is what the model reads, absolutely (2e-3 where the
power is at least 1e-9 of the largest, i.e. above the fp32 FFT's own noise floor)."""

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
from llama_x_tpu.models import fusion as jfusion
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.ops import audio_frontend as jfront
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu.train.cli import assemble_step_batch as jassemble
from llama_x_tpu.utils.tree import merge, named_leaves, partition
from llama_x_tpu_torch import probe_flash as tprobe_cli
from llama_x_tpu_torch import train_librispeech as ttrain_cli
from llama_x_tpu_torch.models import audio as taudio
from llama_x_tpu_torch.models import fusion as tfusion
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.ops import audio_frontend as tfront
from llama_x_tpu_torch.ops import flash_probe as tprobe
from llama_x_tpu_torch.train import cli as tcli
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _jax_trainer_module():
    """The JAX package's train_librispeech.py (a script at the repository root)."""
    spec = importlib.util.spec_from_file_location("jax_train_librispeech", REPO / "train_librispeech.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _audio(seed=0, B=2, T=8000):
    return (np.random.default_rng(seed).standard_normal((B, T)) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------


def test_window_and_filterbank_equal_the_jax_package():
    np.testing.assert_array_equal(tfront.hann_window(400), jfront.hann_window(400))
    for n_mels, n_fft, sr in ((128, 512, 16_000), (80, 400, 16_000), (40, 256, 8_000)):
        got, want = tfront.mel_filterbank(n_mels, n_fft, sr), jfront.mel_filterbank(n_mels, n_fft, sr)
        assert got.dtype == np.float32 and got.shape == (n_mels, n_fft // 2 + 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [8000, 4321])
@pytest.mark.parametrize("impl", ["fft", "dft"])
def test_mel_spectrogram_matches_jax(impl, T):
    audio = _audio(1, T=T)
    want = np.asarray(jfront.mel_spectrogram(jnp.asarray(audio), impl=impl))
    got = tfront.mel_spectrogram(torch.from_numpy(audio), impl=impl).numpy()
    assert got.shape == want.shape == (2, 128, 1 + T // 160)
    np.testing.assert_allclose(got, want, atol=2e-5 * want.max(), rtol=0)
    # the two backends compute the same function
    other = tfront.mel_spectrogram(torch.from_numpy(audio), impl="dft" if impl == "fft" else "fft").numpy()
    np.testing.assert_allclose(got, other, atol=2e-5 * want.max(), rtol=0)
    jlog = np.asarray(jfront.log_mel_cmn(jnp.asarray(want), dtype=jnp.float32))
    tlog = tfront.log_mel_cmn(torch.from_numpy(got), dtype=torch.float32).numpy()
    loud = want[..., :-1] >= 1e-9 * want.max()
    assert loud.mean() > 0.99
    np.testing.assert_allclose(tlog[loud], jlog[loud], atol=2e-3)
    assert tfront.log_mel_cmn(torch.from_numpy(got)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="impl"):
        tfront.mel_spectrogram(torch.from_numpy(audio), impl="auto")


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

CFG = dict(embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2, intermediate_dim=128, vocab_size=256,
           max_seq_len=128)


def _pair(mode="float", seed=0, **cfg):
    """(JAX params, JAX config, JAX mask, port model) of a LlamaAudio in fp32: "float"
    (everything trains) or "qlora" (int8 base, int8 act and dgrad, LoRA with live lora_b,
    fused CE with the int8 head, embeddings / head / final norm frozen, stem trainable)."""
    kw = dict(CFG, **cfg)
    if mode == "qlora":
        kw.update(dynamic_int8_act=True, dynamic_int8_bwd=True, int8_head=True, fused_ce_chunks=4)
    jcfg = jllama.tiny_config(**kw)
    params = jaudio.LlamaAudio.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32).params
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
                            device="cpu", freeze_prefixes=freeze)
    return params, jcfg, mask, model


def test_params_from_jax_carries_the_stem():
    params, _, mask, model = _pair("qlora")
    assert isinstance(model, taudio.LlamaAudio) and model.audio_config == taudio.AudioConfig()
    got = named_tensors(model)
    want = {n: np.asarray(v, np.float32) for n, v in named_leaves(params)}
    assert set(want) - set(got) == set() and "audio_embed/conv2/kernel" in got
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    assert model.audio_embed.conv1.weight.shape == (64, 128, 3)  # [C_out, C_in, W]
    # requires_grad is the JAX trainable mask, with the stem trainable and with it frozen
    assert _trainable_paths(model) == {n for n, m in named_leaves(mask) if m}
    assert {n for n in _trainable_paths(model) if n.startswith("audio_embed")} == {
        "audio_embed/conv1/kernel", "audio_embed/conv1/bias", "audio_embed/conv2/kernel", "audio_embed/conv2/bias"}
    freeze = ("audio_embed", "tok_embeddings", "output", "norm")
    frozen = params_from_jax(jax.tree.map(np.asarray, params), model.config, device="cpu", freeze_prefixes=freeze)
    assert not any(p.requires_grad for p in frozen.audio_embed.parameters())
    assert _trainable_paths(frozen) == {n for n, m in named_leaves(jtrainable_mask(params, freeze)) if m}


def _trainable_paths(model):
    from llama_x_tpu_torch.adapters.lora import tree_path

    return {tree_path(n) for n, p in model.named_parameters() if p.requires_grad}


def test_audio_embed_matches_jax():
    """The stem on 0.5 s of audio: [B, 25, D] tokens within 1e-4 of the largest."""
    params, _, _, model = _pair()
    audio = _audio(2)
    want = np.asarray(jaudio.audio_embed(params["audio_embed"], jaudio.AudioConfig(), jnp.asarray(audio),
                                         dtype=jnp.float32))
    got = taudio.audio_embed(model.audio_embed, model.audio_config, torch.from_numpy(audio),
                             dtype=torch.float32).detach().numpy()
    assert got.shape == want.shape == (2, 25, 64)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    assert taudio.AudioConfig().num_audio_tokens(640_000) == jaudio.AudioConfig().num_audio_tokens(640_000) == 2000
    with pytest.raises(FileNotFoundError, match="never downloads"):  # a hub id: local directories only
        taudio.LlamaAudio.from_hf("meta-llama/Llama-3.1-8B")


@pytest.mark.parametrize("prefix_lm", [False, True])
def test_fuse_forward_logits_match_jax(prefix_lm):
    params, jcfg, _, model = _pair()
    rng = np.random.default_rng(3)
    prefixes = [rng.standard_normal((2, n, 64)).astype(np.float32) for n in (7, 5)]
    tokens = rng.integers(0, 256, (2, 20)).astype(np.int32)
    want = np.asarray(jfusion.fuse_forward(params, jcfg, [jnp.asarray(p) for p in prefixes], jnp.asarray(tokens),
                                           prefix_lm=prefix_lm))
    got = tfusion.fuse_forward(model, [torch.from_numpy(p) for p in prefixes], torch.from_numpy(tokens).long(),
                               prefix_lm=prefix_lm).detach().numpy()
    assert got.shape == want.shape == (2, 20, 256)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    if prefix_lm:  # the mask matters: causal logits differ
        causal = tfusion.fuse_forward(model, [torch.from_numpy(p) for p in prefixes],
                                      torch.from_numpy(tokens).long()).detach().numpy()
        assert np.abs(causal - got).max() > 1e-3
    # no prefix at all: the text model
    plain = tfusion.fuse_forward(model, [], torch.from_numpy(tokens).long()).detach().numpy()
    np.testing.assert_allclose(plain, np.asarray(jllama.forward(params, jcfg, jnp.asarray(tokens))), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("prefix_lm", [False, True])
def test_fuse_forward_with_a_cache_matches_jax(prefix_lm):
    """Prefill through the cache (the prefix-LM mask survives into it) and one decode
    step: logits against the JAX package's, and the cache contents."""
    params, jcfg, _, model = _pair()
    rng = np.random.default_rng(4)
    prefix = rng.standard_normal((2, 6, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (2, 9)).astype(np.int32)
    n = 6 + 9
    jcache = jllama.init_kv_cache(jcfg, 2, dtype=jnp.float32)
    want, jcache = jfusion.fuse_forward(params, jcfg, [jnp.asarray(prefix)], jnp.asarray(tokens), prefix_lm=prefix_lm,
                                        kv_cache=jcache, input_pos=jnp.arange(n), kv_len=jnp.full((2,), n))
    tcache = tllama.init_kv_cache(model.config, 2, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        got, tcache = tfusion.fuse_forward(model, [torch.from_numpy(prefix)], torch.from_numpy(tokens).long(),
                                           prefix_lm=prefix_lm, kv_cache=tcache, input_pos=torch.arange(n),
                                           kv_len=torch.full((2,), n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tcache[0].numpy(), np.asarray(jcache[0]), atol=1e-5)
    nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
    want1, _ = jfusion.fuse_forward(params, jcfg, [], jnp.asarray(nxt), kv_cache=jcache, input_pos=jnp.array([n]),
                                    kv_len=jnp.full((2,), n + 1))
    with torch.no_grad():
        got1, _ = tfusion.fuse_forward(model, [], torch.from_numpy(nxt).long(), kv_cache=tcache,
                                       input_pos=torch.tensor([n]), kv_len=torch.full((2,), n + 1))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-4, rtol=2e-4)


def _batch(seed, B=2, T=8000, S=24, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=-1).astype(np.int32)
    labels[:, -1] = -100
    return _audio(seed, B, T), tokens, labels


@pytest.mark.parametrize("mode,prefix_lm,remat", [
    ("float", False, None), ("float", True, "full"), ("qlora", True, None), ("qlora", True, "flash_proj"),
    ("qlora", False, "flash_q8s"),
])
def test_audio_forward_loss_and_gradients_match_jax(mode, prefix_lm, remat):
    """Loss within 1e-5 and every trainable gradient (adapters or weights, and the stem)
    within 1e-4 of its largest entry; under "flash_q8s" both sides take the same int8
    round trip of h1 and get 3e-3."""
    cfg = {} if remat is None else dict(activation_checkpointing=True, remat_policy=remat)
    params, jcfg, mask, model = _pair(mode, **cfg)
    jcfg = jcfg.replace(attn_impl="xla")
    audio, tokens, labels = _batch(5)
    trainable, frozen = partition(params, mask)

    def lfn(t):
        return jaudio.forward(merge(t, frozen), jcfg, jaudio.AudioConfig(), jnp.asarray(audio), jnp.asarray(tokens),
                              labels=jnp.asarray(labels), prefix_lm=prefix_lm)

    want_loss, want = jax.value_and_grad(lfn)(trainable)
    loss = taudio.forward(model, torch.from_numpy(audio), torch.from_numpy(tokens).long(),
                          labels=torch.from_numpy(labels), prefix_lm=prefix_lm)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = named_tensors(model, grads=True)
    want = {n: np.asarray(g, np.float32) for n, g in named_leaves(want)}
    assert set(got) == set(want) and "audio_embed/conv1/kernel" in got
    tol = 3e-3 if remat == "flash_q8s" else 1e-4
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=tol, atol=tol * np.abs(w).max() + 1e-7, err_msg=name)
    # text only (audio=None) is the text model's loss
    t_only = taudio.forward(model, None, torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels))
    j_only = jaudio.forward(params, jcfg, jaudio.AudioConfig(), None, jnp.asarray(tokens), labels=jnp.asarray(labels))
    assert float(t_only.detach()) == pytest.approx(float(j_only), rel=1e-5)


def test_audio_forward_with_dropout_seeds_is_live():
    _, _, _, model = _pair(attn_dropout=0.2)
    audio, tokens, labels = (torch.from_numpy(a) for a in _batch(6))
    run = lambda seeds: float(taudio.forward(model, audio, tokens.long(), labels=labels, prefix_lm=True,  # noqa: E731
                                             dropout_seeds=seeds).detach())
    assert run([1, 2]) == run([1, 2]) != run([3, 4])
    assert run(None) != run([1, 2])


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def test_synthetic_audio_batches_equal_the_jax_trainer():
    jmod = _jax_trainer_module()
    ji = jmod.synthetic_audio_batches(np.random.default_rng(3), jaudio.AudioConfig(), 2, 0.5, 16, 256)
    ti = ttrain_cli.synthetic_audio_batches(np.random.default_rng(3), taudio.AudioConfig(), 2, 0.5, 16, 256)
    for _ in range(3):
        jb, tb = next(ji), next(ti)
        assert set(jb) == set(tb) == {"audio", "tokens", "labels"}
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
            assert jb[k].dtype == tb[k].dtype


def test_ten_step_run_tracks_the_jax_trainer():
    """A ``--synthetic``-style audio QLoRA run (prefix-LM, accumulation 2, stem and
    adapters training, clipping) beside the JAX trainer on the same initial weights and
    the same ``synthetic_audio_batches``: every step's loss within 2e-4 (relative), as
    the text trainer's 20-step test holds it, and the grad norms within 5e-3: the stem's
    output differs in the sixth digit between the frameworks, which moves a few
    activations across an int8 rounding tie (one microbatch of the first step reads loss
    5.61207 against 5.61189 and grad norm 0.97841 against 0.97775 for that reason, while
    the same step with a float base agrees to the last digit)."""
    params, jcfg, mask, model = _pair("qlora")
    jcfg = jcfg.replace(attn_impl="xla")
    jcfg_audio = jaudio.AudioConfig()

    def jloss(p, mb):
        loss = jaudio.forward(p, jcfg, jcfg_audio, mb["audio"], mb["tokens"], labels=mb["labels"], prefix_lm=True)
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
    ji = jmod.synthetic_audio_batches(np.random.default_rng(0), jcfg_audio, 2, 0.5, 24, 256)
    ti = ttrain_cli.synthetic_audio_batches(np.random.default_rng(0), taudio.AudioConfig(), 2, 0.5, 24, 256)
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
    assert tstate.step == steps
    got = named_tensors(model)
    want = {n: np.asarray(v, np.float32) for n, v in named_leaves(jtrainer.full_params(jstate))}
    np.testing.assert_array_equal(got["layers/attention/wq/int_data"], want["layers/attention/wq/int_data"])
    moved = np.abs(got["audio_embed/conv2/kernel"] - np.asarray(params["audio_embed"]["conv2"]["kernel"])).max()
    assert moved > 1e-4  # the stem trains


QLORA_FLAGS = [
    "--synthetic", "8", "--device", "cpu", "--dtype", "float32", "--quantize", "int8", "--quantize_kwargs",
    '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
    "--freeze_prefixes", "tok_embeddings", "output", "norm", "audio_embed", "--activation_checkpointing",
    "--fused_ce_chunks", "2", "--prefix_lm", "--audio_duration", "1", "--seq_len_multiple", "32", "--lr", "1e-2",
    "--log_interval", "1", "--ckpt_interval", "0",
]


@pytest.mark.parametrize("policy", ["full", "flash_proj", "flash_q8s"])
def test_train_librispeech_entry_point_runs_on_the_cpu(policy, tmp_path, monkeypatch):
    """``train_librispeech.main`` itself: model with a frozen stem, its own loop, the
    logger with audio seconds per second, the end-of-run checkpoint."""
    monkeypatch.chdir(tmp_path)
    ttrain_cli.main([*QLORA_FLAGS, "--remat_policy", policy, "--n_steps", "3"])
    (run,) = (tmp_path / "runs" / "librispeech").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    assert recs[-1]["audio_secs_per_second"] > 0 and recs[-1]["toks_per_second"] > 0
    config = json.loads((run / "model_config.json").read_text())
    assert config["audio"]["n_mels"] == 128 and config["llama"]["remat_policy"] == policy
    assert (run / "step_00000003").exists()


def test_train_librispeech_refuses_what_is_not_ported():
    args = ttrain_cli.parse_args(["--dataset_dir", "LibriSpeech/train-clean-100", "--tokenizer", "llama2",
                                  "--tokenizer_path", "tokenizer.model", "--device", "cpu"])
    assert (args.dataset_dir, args.tokenizer, args.tokenizer_path) == (
        "LibriSpeech/train-clean-100", "llama2", "tokenizer.model")  # real data is read since slice 4
    with pytest.raises(ValueError, match="--dataset_dir"):
        ttrain_cli.parse_args(["--device", "cpu"])  # neither --synthetic nor a dataset
    assert ttrain_cli.parse_args(["--dataset_dir", "d", "--model", "m", "--device", "cpu"]).model == "m"  # slice 3
    assert ttrain_cli.parse_args(["--synthetic", "4", "--remat_policy", "attn_q8", "--device", "cpu"]).remat_policy == (
        "attn_q8")  # the int8-residual attention is ported
    with pytest.raises(ValueError, match="positions"):
        ttrain_cli.parse_args(["--synthetic", "4", "--audio_duration", "40", "--seq_len_multiple", "4096"])
    args = ttrain_cli.parse_args(["--synthetic", "4"])
    assert args.device == "cuda" and args.audio_duration == 40.0 and args.seq_len_multiple == 128


def test_build_model_params_with_a_stem_at_a_geometry():
    """``--geometry`` with a stem: the decoder drawn as int8, the stem beside it in
    bf16, frozen by ``--freeze_prefixes audio_embed``, never quantized or adapted."""
    args = ttrain_cli.parse_args(["--synthetic", "4", "--device", "cpu", "--geometry", "tiny", "--quantize", "int8",
                                  "--adapter", "lora", "--freeze_prefixes", "tok_embeddings", "output", "norm",
                                  "audio_embed", "--audio_duration", "1"])
    model = tcli.build_model_params(args, max_seq_len=ttrain_cli.MAX_SEQ_LEN, audio_config=taudio.AudioConfig())
    assert isinstance(model, taudio.LlamaAudio) and model.config.max_seq_len == 4096
    stem = dict(model.audio_embed.named_parameters())
    assert set(stem) == {"conv1.weight", "conv1.bias", "conv2.weight", "conv2.bias"}
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad for p in stem.values())
    assert model.layers[0].attention.wq.int_data is not None and model.layers[0].attention.wq.lora_a.requires_grad
    assert model.config.frozen_head


# ---------------------------------------------------------------------------
# the probe (K6) and its entry point
# ---------------------------------------------------------------------------


def _probe_numpy(q, k, v, bq, bk, prefix):
    """tools/probe_flash.py:94-117 stated in numpy, grid cell by grid cell: for each
    (b, kv head h, q block i) an f32 accumulator over the stacked GQA group's rows; for
    each kv block j, if need(i, j): acc += bf16(q_block @ k_block^T) @ v_block."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    bf16 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()  # noqa: E731
    out = np.zeros((B, S, Hq, D), np.float32)
    for b in range(B):
        for h in range(Hkv):
            for i in range(S // bq):
                rows = np.concatenate([q[b, i * bq:(i + 1) * bq, h * group + g] for g in range(group)])  # [group*bq, D]
                acc = np.zeros((group * bq, D), np.float32)
                for j in range(S // bk):
                    q_start, kv_start = i * bq, j * bk
                    need = (q_start + bq - 1 >= kv_start) or (q_start < prefix and kv_start < prefix)
                    if need:
                        s = rows @ k[b, kv_start:kv_start + bk, h].T
                        acc += bf16(s) @ v[b, kv_start:kv_start + bk, h]
                for g in range(group):
                    out[b, i * bq:(i + 1) * bq, h * group + g] = acc[g * bq:(g + 1) * bq]
    return bf16(out)


@pytest.mark.parametrize("bq,bk,prefix", [(32, 64, 100), (64, 32, 0), (16, 128, 256)])
def test_flash_probe_plain_matches_the_tpu_kernel_stated_in_numpy(bq, bk, prefix):
    """The TPU probe kernel is a closure inside ``main()`` of tools/probe_flash.py with
    the 8B shape fixed there, so it can be neither imported nor run on the CPU without
    editing that file; its arithmetic is restated above instead. bf16 inputs, the logits
    rounded to bf16, f32 accumulation: within one bf16 ulp of the output plus 2^-8 of
    its rms (``probe_tolerance``)."""
    rng = np.random.default_rng(bq)
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 32
    mk = lambda h: torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(np.float32) * 0.3).bfloat16()  # noqa: E731
    q, k, v = mk(Hq), mk(Hkv), mk(Hkv)
    got = tprobe.flash_probe(q, k, v, bq, bk, prefix).float().numpy()  # a CPU tensor: the plain version
    want = _probe_numpy(q.float().numpy(), k.float().numpy(), v.float().numpy(), bq, bk, prefix)
    atol, rtol = tprobe.probe_tolerance(torch.from_numpy(want))
    assert np.all(np.abs(got - want) <= atol + rtol * np.abs(want))
    need = tprobe.needed_blocks(S, bq, bk, prefix).numpy()
    assert need[-1].all() and (prefix > 0 or not need[0, -1])
    skipped = _probe_numpy(q.float().numpy(), k.float().numpy(), v.float().numpy(), bq, bk, -1)
    assert prefix <= 0 or np.abs(skipped - want).max() > 10 * atol  # the prefix blocks matter
    with pytest.raises(ValueError, match="divide"):
        tprobe.flash_probe_plain(q, k, v, 48, bk, prefix)


def test_probe_flash_entry_point_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "probe.json"
    res = tprobe_cli.main(["--device", "cpu", "--seq_len", "256", "--prefix", "100", "--bq", "64", "--bk", "128",
                           "--reps", "1", "--out", str(out)])
    text = capsys.readouterr().out
    assert all(word in text for word in ("fwd ", "fwd+bwd", "mm-probe", "fwd - probe"))
    saved = json.loads(out.read_text())
    assert saved["device"] == "cpu" and "host clock" in saved["clock"]
    assert res["fwd_minus_probe_ms"] == pytest.approx(res["fwd_ms"] - res["probe_matmul_only_ms"])
    args = tprobe_cli.parse_args([])
    assert (args.device, args.seq_len, args.prefix, args.bq, args.bk) == ("cuda", 4096, 2000, 256, 1024)
