"""The port's evaluations against the JAX package's, on the CPU: greedy captions
(``eval_vision``) and transcripts (``eval_librispeech``) of a tiny fp32 model equal the
JAX ones, id for id and string for string, with and without prefix-LM; the generated
ids through a modality prefix equal JAX ``generate``'s; the entry points run with
``--synthetic``, ``--data_dir`` and ``--resume`` from a run of the port's trainers;
``restore_model`` rebuilds a trained model exactly; ``--model`` raises by name.

Tolerance: none. Greedy decoding is an argmax over fp32 logits that the two frameworks
compute a few ulps apart, so the tokens are equal unless two logits tie to that
precision. The KV cache is held in fp32 on both sides for that reason: with the default
bf16 cache, K and V a few fp32 ulps apart round to neighbouring bf16 values now and then,
and that moved a top-2 margin of 5.6e-5 the other way (causal captions, second row,
fifth token), the known near-tie flip of greedy decoding over a bf16 cache."""

import argparse
import functools
import importlib.util
import json
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from llama_x_tpu.models import audio as jaudio
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models import vision as jvision
from llama_x_tpu.models.generate import generate as jgenerate
from llama_x_tpu_torch import eval_librispeech as teval_ls
from llama_x_tpu_torch import eval_vision as teval_vis
from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
from llama_x_tpu_torch.models import audio as taudio
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models import vision as tvision
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.models.generate import generate as tgenerate

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CFG = dict(embed_dim=64, num_layers=2, head_dim=16, num_heads=4, num_kv_heads=2, intermediate_dim=128, vocab_size=288,
           max_seq_len=160)


def _script(name: str):
    """A JAX script at the repository root (eval_vision.py, eval_librispeech.py)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _vision_pair(seed=0):
    jcfg = jllama.tiny_config(**CFG)
    jvc = jvision.VisionConfig(image_size=32, patch_size=8)
    jmodel = jvision.LlamaVision.init(jax.random.PRNGKey(seed), jcfg, jvc, dtype=jnp.float32)
    tmodel = params_from_jax(jax.tree.map(np.asarray, jmodel.params), tllama.tiny_config(**CFG), device="cpu",
                             vision_config=tvision.VisionConfig(32, 8))
    return jmodel, tmodel


def _audio_pair(seed=0):
    jcfg = jllama.tiny_config(**CFG)
    jmodel = jaudio.LlamaAudio.init(jax.random.PRNGKey(seed), jcfg, jaudio.AudioConfig(), dtype=jnp.float32)
    tmodel = params_from_jax(jax.tree.map(np.asarray, jmodel.params), tllama.tiny_config(**CFG), device="cpu")
    return jmodel, tmodel


def _args(**kw):
    return argparse.Namespace(**{"eval_batch_size": 3, "max_new_tokens": 12, "prefix_lm": True, **kw})


def _f32_cache(monkeypatch, jmod, tmod):
    """Both evaluations' ``generate`` with an fp32 cache (see the module docstring)."""
    monkeypatch.setattr(jmod, "generate", functools.partial(jmod.generate, cache_dtype=jnp.float32))
    monkeypatch.setattr(tmod, "generate", functools.partial(tmod.generate, cache_dtype=torch.float32))


@pytest.mark.parametrize("prefix_lm", [True, False])
def test_greedy_captions_equal_the_jax_evaluation(prefix_lm, monkeypatch):
    """Five canvases in batches of 3 (the tail padded): the JAX ``_caption_batched``'s
    strings, and underneath them JAX ``generate``'s ids through the image prefix."""
    jmodel, tmodel = _vision_pair()
    jmod = _script("eval_vision")
    _f32_cache(monkeypatch, jmod, teval_vis)
    images = [np.random.default_rng(i).standard_normal((32, 32, 3)).astype(np.float32) for i in range(5)]
    args = _args(prefix_lm=prefix_lm)
    want = jmod._caption_batched(jmodel, images, JByteTokenizer(), args)
    got = teval_vis._caption_batched(tmodel, images, ByteTokenizer(), args)
    assert got == want and len(got) == 5
    batch = np.stack(images[:3])
    jprefix = jvision.patch_embed(jmodel.params["patch_embed"], jmodel.vision_config, jnp.asarray(batch),
                                  dtype=jnp.float32)
    jids = jgenerate(jmodel.params, jmodel.config, jnp.full((3, 1), 256, jnp.int32), max_new_tokens=12, eos_id=257,
                     pad_id=258, prefix_embeds=jprefix, prefix_lm=prefix_lm, cache_dtype=jnp.float32)
    with torch.no_grad():
        tprefix = tvision.patch_embed(tmodel.patch_embed, tmodel.vision_config, torch.from_numpy(batch),
                                      dtype=torch.float32)
    tids = tgenerate(tmodel, torch.full((3, 1), 256), max_new_tokens=12, eos_id=257, pad_id=258,
                     prefix_embeds=tprefix, prefix_lm=prefix_lm, cache_dtype=torch.float32)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert len(set(map(tuple, tids.tolist()))) > 1  # the image decides the caption
    assert jmod._score(["a b", "c"], ["a b", "d"]) == teval_vis._score(["a b", "c"], ["a b", "d"])


@pytest.mark.parametrize("prefix_lm", [True, False])
def test_greedy_transcripts_equal_the_jax_evaluation(prefix_lm, monkeypatch):
    """Four 0.5 s utterances of different lengths in batches of 3, each padded to the
    longest: the JAX ``_decode_batched``'s strings and ``generate``'s ids."""
    jmodel, tmodel = _audio_pair()
    jmod = _script("eval_librispeech")
    _f32_cache(monkeypatch, jmod, teval_ls)
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (8000, 6000, 8000, 7000)]
    args = _args(prefix_lm=prefix_lm)
    want = jmod._decode_batched(jmodel, wavs, JByteTokenizer(), args)
    got = teval_ls._decode_batched(tmodel, wavs, ByteTokenizer(), args)
    assert got == want and len(got) == 4
    audio = np.stack([wavs[0], wavs[2]])
    jprefix = jaudio.audio_embed(jmodel.params["audio_embed"], jmodel.audio_config, jnp.asarray(audio),
                                 dtype=jnp.float32)
    jids = jgenerate(jmodel.params, jmodel.config, jnp.full((2, 1), 256, jnp.int32), max_new_tokens=12, eos_id=257,
                     pad_id=258, prefix_embeds=jprefix, prefix_lm=prefix_lm, cache_dtype=jnp.float32)
    with torch.no_grad():
        tprefix = taudio.audio_embed(tmodel.audio_embed, tmodel.audio_config, torch.from_numpy(audio),
                                     dtype=torch.float32)
        tids = tgenerate(tmodel, torch.full((2, 1), 256), max_new_tokens=12, eos_id=257, pad_id=258,
                         prefix_embeds=tprefix, prefix_lm=prefix_lm, cache_dtype=torch.float32)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_eval_entry_points_run_with_synthetic_data_on_the_cpu(capsys):
    res = teval_vis.main(["--synthetic", "3", "--image_size", "32", "--patch_size", "8", "--device", "cpu",
                          "--max_new_tokens", "6", "--eval_batch_size", "2", "--prefix_lm"])
    assert res["n_samples"] == 3 and res["synthetic"] and 0.0 <= res["exact_match"] <= 1.0 and res["wer"] >= 0.0
    res = teval_ls.main(["--synthetic", "3", "--device", "cpu", "--max_new_tokens", "6", "--eval_batch_size", "2"])
    assert res["n_utts"] == 3 and res["synthetic"] and res["wer"] >= 0.0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [set(r) for r in lines] == [{"exact_match", "wer", "n_samples", "synthetic"}, {"wer", "n_utts", "synthetic"}]


def test_eval_entry_points_refuse_what_is_not_ported():
    for mod in (teval_vis, teval_ls):
        assert mod.parse_args(["--model", "m", "--data_dir", "x"]).model == "m"  # HF import: slice 3
        with pytest.raises(ValueError, match="--resume"):
            mod.parse_args(["--data_dir", "x"])
        assert mod.parse_args(["--synthetic", "2"]).device == "cuda"


TRAIN_FLAGS = ["--device", "cpu", "--dtype", "float32", "--n_steps", "2", "--log_interval", "1", "--ckpt_interval", "0",
               "--quantize", "int8", "--adapter", "lora", "--synthetic_config",
               '{"num_layers": 1, "embed_dim": 64, "intermediate_dim": 128}']


def _write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1), w.setsampwidth(2), w.setframerate(16_000)
        w.writeframes(x.astype(np.int16).tobytes())


def test_eval_librispeech_resumes_a_port_run_on_a_data_dir(tmp_path, monkeypatch):
    """train_librispeech (int8 base + LoRA) for two steps, then eval_librispeech
    ``--resume`` on a LibriSpeech-layout directory: the model comes back from the run's
    files alone and decodes every utterance that fits."""
    from llama_x_tpu_torch import train_librispeech

    monkeypatch.chdir(tmp_path)
    train_librispeech.main(["--synthetic", "4", "--audio_duration", "1", "--seq_len_multiple", "16", *TRAIN_FLAGS])
    (run,) = (tmp_path / "runs" / "librispeech").iterdir()
    d = tmp_path / "dev" / "1" / "2"
    d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, n in enumerate((8000, 12000, 40000)):
        _write_wav(d / f"1-2-{i}.wav", rng.integers(-3000, 3000, n))
    (d / "1-2.trans.txt").write_text("1-2-0 HELLO THERE\n1-2-1 GOOD MORNING\n1-2-2 TOO LONG TO FIT\n")
    res = teval_ls.main(["--data_dir", str(tmp_path / "dev"), "--resume", str(run), "--device", "cpu",
                         "--audio_duration", "1", "--max_new_tokens", "4"])
    assert res["n_utts"] == 2 and res["wer"] >= 0.0


def test_eval_vision_resumes_a_port_run(tmp_path, monkeypatch):
    from llama_x_tpu_torch import train_vision

    monkeypatch.chdir(tmp_path)
    train_vision.main(["--synthetic", "8", "--image_size", "32", "--patch_size", "8", "--batch_size", "2",
                       "--prefix_lm", *TRAIN_FLAGS])
    (run,) = (tmp_path / "runs" / "vision").iterdir()
    res = teval_vis.main(["--synthetic", "2", "--resume", str(run / "step_00000002"), "--device", "cpu",
                          "--max_new_tokens", "4", "--prefix_lm"])
    assert res["n_samples"] == 2


@pytest.mark.parametrize("stems", ["audio", "vision", "omni"])
def test_restore_model_rebuilds_a_trained_model_exactly(tmp_path, stems):
    """A run saved by the trainers' loop comes back as the same class with the same
    tensors (int8 base, LoRA, stems) and computes the same logits."""
    from llama_x_tpu_torch.models.audio import AudioConfig
    from llama_x_tpu_torch.models.vision import VisionConfig
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.checkpoint import restore_model, save_checkpoint
    from llama_x_tpu_torch.train.trainer import TrainState

    parser = argparse.ArgumentParser()
    cli.add_common_args(parser)
    args = parser.parse_args(["--synthetic", "2", "--device", "cpu", "--dtype", "float32", "--quantize", "int8",
                              "--adapter", "dora", "--adapter_kwargs", '{"rank": 3}', "--synthetic_config",
                              '{"num_layers": 1, "embed_dim": 64, "intermediate_dim": 128}'])
    ac = AudioConfig() if stems in ("audio", "omni") else None
    vc = VisionConfig(32, 8) if stems in ("vision", "omni") else None
    model = cli.build_model_params(args, max_seq_len=256, audio_config=ac, vision_config=vc)
    with torch.no_grad():
        model.layers[0].attention.wq.lora_b.add_(0.5)
    optimizer, _ = cli.setup_optimizer(args, model)
    cli.save_model_config(tmp_path, model.config, ac, vc)
    save_checkpoint(tmp_path, TrainState(model, optimizer), 7)
    back = restore_model(tmp_path, "cpu")
    assert type(back) is type(model) and back.config == model.config
    want, got = model.state_dict(), back.state_dict()
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
    tokens = torch.randint(0, 256, (1, 8))
    no_prefix = [None, None] if stems == "omni" else [None]  # text only through every stem's forward
    with torch.no_grad():
        assert torch.equal(back(*no_prefix, tokens), model(*no_prefix, tokens))
