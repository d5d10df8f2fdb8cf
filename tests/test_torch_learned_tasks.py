"""The learned-task entry points of the port (``wer_synthetic``, ``vision_synthetic``,
``omni_synthetic``, ``int8_bwd_quality``, ``int8_head_quality``) against the JAX tools of
the same names, loaded by path from tools/ on the CPU, and the counting helpers of
data/synthetic.py against the JAX package's.

Each tool's data generator gives the JAX tool's arrays from the same seed, element for
element. On the JAX tool's own model (its config, heads of 32, fp32, the weights carried
over by models/convert.py) the port's loss equals the JAX tool's ``loss_fn`` within 2e-4
relative; a 5-step curve through the port's train step (``learned_task.train``) tracks the
JAX tool's step within 2e-4 at every step (the audio tolerance); the checkpoint round trip
gives back the trained tensors bit for bit; and greedy decoding through the tool's
evaluation gives the JAX tool's hypotheses string for string on the same weights, with
the KV cache in fp32 on both sides (tests/test_torch_eval.py says why). The quality
studies' 3-step curves equal the JAX ``run`` within 2e-4 on the same initial weights."""

import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.data import synthetic as jsynth
from llama_x_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from llama_x_tpu.models import audio as jaudio
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models import omni as jomni
from llama_x_tpu.models import vision as jvision
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu_torch import int8_bwd_quality, int8_head_quality, omni_synthetic, vision_synthetic, wer_synthetic
from llama_x_tpu_torch.adapters.lora import set_trainable
from llama_x_tpu_torch.data import synthetic as tsynth
from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.audio import AudioConfig
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.models.vision import VisionConfig
from llama_x_tpu_torch.train import learned_task
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train.trainer import trainable_parameters

jgenerate_mod = importlib.import_module("llama_x_tpu.models.generate")  # the package exports the function
torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@functools.cache
def _tool(name: str):
    """A JAX tool of tools/, loaded by path (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_batches_equal(want_it, got_it, n: int = 3):
    for _ in range(n):
        want, got = next(want_it), next(got_it)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(np.asarray(want[k]), got[k], err_msg=k)


def test_data_generators_give_the_jax_tools_arrays():
    """Training batches (rejection-sampled away from the held-out combinations) and held-out
    samples of the three learned tasks, and the quality studies' copy-permutation stream."""
    jtok, tok = JByteTokenizer(), ByteTokenizer()
    jw, jv, jo = _tool("wer_synthetic"), _tool("vision_synthetic"), _tool("omni_synthetic")
    _assert_batches_equal(jw.batches(np.random.default_rng(3), jtok, 4),
                          wer_synthetic.batches(np.random.default_rng(3), tok, 4))
    _assert_batches_equal(jv.batches(np.random.default_rng(4), jtok, 4, 48),
                          vision_synthetic.batches(np.random.default_rng(4), tok, 4, 48))
    _assert_batches_equal(jo.batches(np.random.default_rng(5), jtok, 4),
                          omni_synthetic.batches(np.random.default_rng(5), tok, 4))
    for jfn, tfn in ((jw.make_utterance, wer_synthetic.make_utterance),
                     (lambda r, s: jo.make_sample(r, s), lambda r, s: omni_synthetic.make_sample(r, s))):
        jr, tr = np.random.default_rng(6), np.random.default_rng(6)
        for _ in range(4):
            want, got = jfn(jr, "eval"), tfn(tr, "eval")
            for w, g in zip(want, got):
                np.testing.assert_array_equal(np.asarray(w), np.asarray(g))
    for n_next in (63, 64):  # int8_bwd_quality's and int8_head_quality's sequences
        rng = np.random.default_rng(42)
        it = int8_bwd_quality.copy_task_batches(n_next)
        for _ in range(3):
            toks = [rng.integers(1, 512, (1, 8, 1))]
            for _ in range(n_next):
                toks.append((toks[-1] * 3 + 7) % 512)
            tokens = np.concatenate(toks, axis=-1).astype(np.int32)
            got = next(it)
            np.testing.assert_array_equal(got["tokens"], tokens[..., :-1])
            np.testing.assert_array_equal(got["labels"], tokens[..., 1:])


# the JAX tools' models, as their main()s build them
def _jax_config(tok):
    return jllama.tiny_config(embed_dim=256, num_layers=4, head_dim=32, num_heads=8, num_kv_heads=4,
                              intermediate_dim=768, vocab_size=tok.vocab_size + 5, max_seq_len=512)


def _wer_task():
    jtool, tok = _tool("wer_synthetic"), ByteTokenizer()
    jcfg, acfg = _jax_config(JByteTokenizer()), jaudio.AudioConfig()
    params = jaudio.LlamaAudio.init(jax.random.PRNGKey(0), jcfg, acfg, dtype=jnp.float32).params

    def jloss(p, mb):
        return jaudio.forward(p, jcfg, acfg, mb["audio"], mb["tokens"], labels=mb["labels"], prefix_lm=True)

    def jeval(p, rng, n):
        return jtool.eval_wer(p, jcfg, acfg, JByteTokenizer(), rng, n)[2]

    def teval(m, rng, n):
        return wer_synthetic.eval_wer(m, tok, rng, n)[2]

    return dict(jtool=jtool, tool=wer_synthetic, params=params, jcfg=jcfg, jloss=jloss, jeval=jeval, teval=teval,
                batches=lambda seed: wer_synthetic.batches(np.random.default_rng(seed), tok, 2),
                jbatches=lambda seed: jtool.batches(np.random.default_rng(seed), JByteTokenizer(), 2),
                tx=lambda steps: joptim.get_optimizer("AdamW", 2e-3),
                opt=lambda model, steps: toptim.get_optimizer("AdamW", trainable_parameters(model), 2e-3),
                port_config=wer_synthetic.make_config(tok, CPU)[0], kw={})


def _vision_task():
    jtool, tok = _tool("vision_synthetic"), ByteTokenizer()
    jcfg = _jax_config(JByteTokenizer())
    jvc = jvision.VisionConfig(image_size=48, patch_size=6, use_newline=True)
    params = jvision.LlamaVision.init(jax.random.PRNGKey(0), jcfg, jvc, dtype=jnp.float32).params

    def jloss(p, mb):
        return jvision.forward(p, jcfg, jvc, mb["images"], mb["tokens"], labels=mb["labels"], prefix_lm=True)

    args = vision_synthetic.parse_args(["--device", "cpu"])
    return dict(jtool=jtool, tool=vision_synthetic, params=params, jcfg=jcfg, jloss=jloss,
                jeval=lambda p, rng, n: jtool.eval_captions(p, jcfg, jvc, JByteTokenizer(), rng, n)[3],
                teval=lambda m, rng, n: vision_synthetic.eval_captions(m, tok, rng, n)[3],
                batches=lambda seed: vision_synthetic.batches(np.random.default_rng(seed), tok, 2, 48),
                jbatches=lambda seed: jtool.batches(np.random.default_rng(seed), JByteTokenizer(), 2, 48),
                tx=lambda steps: joptim.get_optimizer("AdamW", joptim.trapezoid_schedule(2e-3, steps, 0.05, 0.4),
                                                      weight_decay=0.01),
                opt=lambda model, steps: toptim.get_optimizer(
                    "AdamW", trainable_parameters(model), toptim.trapezoid_schedule(2e-3, steps, 0.05, 0.4), 0.01),
                port_config=vision_synthetic.make_config(args, tok, CPU)[0],
                kw=dict(vision_config=VisionConfig(image_size=48, patch_size=6)))


def _omni_task():
    jtool, tok = _tool("omni_synthetic"), ByteTokenizer()
    jcfg, acfg = _jax_config(JByteTokenizer()), jaudio.AudioConfig()
    jvc = jvision.VisionConfig(image_size=48, patch_size=6)
    params = jomni.LlamaOmni.init(jax.random.PRNGKey(0), jcfg, acfg, jvc, dtype=jnp.float32).params

    def jloss(p, mb):
        return jomni.forward(p, jcfg, acfg, jvc, mb["audio"], mb["images"], mb["tokens"], labels=mb["labels"],
                             prefix_lm=True)

    return dict(jtool=jtool, tool=omni_synthetic, params=params, jcfg=jcfg, jloss=jloss,
                jeval=lambda p, rng, n: jtool.eval_model(p, jcfg, acfg, jvc, JByteTokenizer(), rng, n)[2],
                teval=lambda m, rng, n: omni_synthetic.eval_model(m, tok, rng, n)[2],
                batches=lambda seed: omni_synthetic.batches(np.random.default_rng(seed), tok, 2),
                jbatches=lambda seed: jtool.batches(np.random.default_rng(seed), JByteTokenizer(), 2),
                tx=lambda steps: joptim.get_optimizer("AdamW", joptim.trapezoid_schedule(2e-3, steps, 0.05, 0.4),
                                                      weight_decay=0.01),
                opt=lambda model, steps: toptim.get_optimizer(
                    "AdamW", trainable_parameters(model), toptim.trapezoid_schedule(2e-3, steps, 0.05, 0.4), 0.01),
                port_config=omni_synthetic.make_config(tok, CPU)[0],
                kw=dict(audio_config=AudioConfig(), vision_config=VisionConfig(image_size=48, patch_size=6)))


TASKS = {"wer_synthetic": _wer_task, "vision_synthetic": _vision_task, "omni_synthetic": _omni_task}


def _port_model(task, params):
    model = params_from_jax(jax.tree.map(np.asarray, params), task["port_config"], device="cpu", **task["kw"])
    set_trainable(model, ())
    return model


@pytest.mark.parametrize("name", list(TASKS))
def test_learned_task_tracks_the_jax_tool(name, tmp_path, monkeypatch):
    """The tool's config is the JAX tool's; the loss on carried-over weights, a 5-step curve,
    the checkpoint round trip, and the greedy hypotheses of two held-out samples."""
    task = TASKS[name]()
    jcfg, port_cfg = task["jcfg"], task["port_config"]
    for field in ("embed_dim", "num_layers", "head_dim", "num_heads", "num_kv_heads", "intermediate_dim",
                  "vocab_size", "max_seq_len"):
        assert getattr(port_cfg, field) == getattr(jcfg, field), field

    steps = 5
    model = _port_model(task, task["params"])
    batch = next(task["batches"](1))
    mb = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    with torch.no_grad():
        loss = float(task["tool"].loss_fn(model, mb)[0])
    assert loss == pytest.approx(float(task["jloss"](task["params"], {k: jnp.asarray(v[0]) for k, v in batch.items()})),
                                 rel=2e-4)

    tx = task["tx"](steps)
    jstate = jtrainer.init_train_state(task["params"], jtrainable_mask(task["params"]), tx)
    jstep = jax.jit(jtrainer.make_train_step(lambda p, mb: (task["jloss"](p, mb), jnp.sum(mb["labels"] != -100)), tx))
    jdata, want = task["jbatches"](0), []
    for _ in range(steps):
        jstate, m = jstep(jstate, next(jdata))
        want.append(float(m["loss"]))
    state, got, _ = learned_task.train(model, task["opt"](model, steps), task["tool"].loss_fn, task["batches"](0),
                                       steps, log_every=1)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]

    restored = learned_task.checkpoint_round_trip(tmp_path, state, steps)
    trained, back = named_tensors(model), named_tensors(restored)
    assert set(trained) == set(back)
    for k in trained:
        np.testing.assert_array_equal(back[k], trained[k], err_msg=k)

    params = jtrainer.full_params(jstate)
    monkeypatch.setattr(jgenerate_mod, "generate", functools.partial(jgenerate_mod.generate, cache_dtype=jnp.float32))
    monkeypatch.setattr(learned_task, "generate", functools.partial(learned_task.generate, cache_dtype=torch.float32))
    want_hyps = task["jeval"](params, np.random.default_rng(10_000), 2)
    got_hyps = task["teval"](_port_model(task, params), np.random.default_rng(10_000), 2)
    assert got_hyps == want_hyps


@pytest.mark.parametrize("study", ["bwd", "head"])
def test_quality_study_curves_track_the_jax_tool(study):
    """The quality study's QLoRA model on the JAX tool's initial weights (int8 base, LoRA,
    embeddings / head / final norm frozen) under the int8 flag the study turns on: a 3-step
    curve of the port's ``run`` against the JAX tool's ``run``."""
    jtool = _tool(f"int8_{study}_quality")
    flag, n_next = ("dynamic_int8_bwd", 63) if study == "bwd" else ("int8_head", 64)
    fixed = {} if study == "bwd" else int8_head_quality.FIXED
    config, dtype = int8_bwd_quality.make_config(CPU, **{flag: True, **fixed})
    jcfg = jllama.LlamaConfig(**{f: getattr(config, f) for f in (
        "embed_dim", "num_layers", "head_dim", "num_heads", "num_kv_heads", "intermediate_dim", "max_seq_len",
        "vocab_size", "dynamic_int8_act", "dynamic_int8_bwd", "int8_head", "fused_ce_chunks", "frozen_head")},
        attn_impl="xla")
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = dict(params, layers=jquantize(params["layers"], "int8"))
    params = dict(params, layers=japply_adapter(params["layers"], "lora", jax.random.PRNGKey(1)))
    model = params_from_jax(jax.tree.map(np.asarray, params), config, device="cpu",
                            freeze_prefixes=int8_bwd_quality.FREEZE)
    assert dtype == torch.float32 and config.head_dim == 32
    want = jtool.run(True, 3)
    got = int8_bwd_quality.run(model, 3, n_next)
    np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("name", ["wer_synthetic", "vision_synthetic", "omni_synthetic", "int8_bwd_quality",
                                  "int8_head_quality"])
def test_entry_points_run_on_the_card_unless_told_cpu(name, tmp_path):
    """No hidden fallback: without ``--device cpu`` each tool asks for the card and, where
    there is none, raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    entry = importlib.import_module(f"llama_x_tpu_torch.{name}")
    out = ["--out", str(tmp_path / "q.json")] if name.startswith("int8") else ["--out_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main(["--steps", "1", *out])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# the counting helpers: tests/test_synthetic_tasks.py's cases on the port
# ---------------------------------------------------------------------------


def test_counting_text_carries():
    s = tsynth.counting_text(98, 20)
    assert s.startswith("98,99,100,101,") and len(s) == 20
    assert s == jsynth.counting_text(98, 20)
    assert tsynth.counting_samples(5, 3, 40) == jsynth.counting_samples(5, 3, 40)


def test_counting_accuracy_scores_true_continuation():
    p = tsynth.counting_prompt(np.random.default_rng(0), 24)
    assert p == jsynth.counting_prompt(np.random.default_rng(0), 24)
    full = tsynth.counting_text(int(p.split(",")[0]), 200)
    true_cont = full[24:100]
    assert tsynth.counting_accuracy(p, true_cont) == 1.0
    assert tsynth.counting_accuracy(p, "xxxx") < 0.5
    assert tsynth.counting_accuracy(p, "") == 0.0
    for completion in (true_cont, "xxxx", true_cont[:7] + "x" + true_cont[8:20], ""):
        assert tsynth.counting_accuracy(p, completion) == jsynth.counting_accuracy(p, completion)


def test_counting_tokens_roundtrip():
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer

    tok = get_tokenizer("byte")
    toks = tsynth.counting_tokens(3, 0, 64, tok)
    assert len(toks) == 3
    s = tok.decode([int(t) for t in toks[0] if t < 256])
    assert tsynth.counting_accuracy(s[:10], s[10:]) >= 0.9  # a self-consistent continuation
    assert all(np.array_equal(a, b) for a, b in zip(jsynth.counting_tokens(3, 0, 64, JByteTokenizer()), toks))


def test_counting_is_learnable_by_tiny_model():
    """The JAX test's 2-layer model and data on the port with the port's AdamW (no weight
    decay: Adam): full-batch steps pull the loss well under 1.0 (random bytes over the task's
    ~13-character alphabet sit near ln 13 ~ 2.56). The JAX test takes 150 steps; the port's
    loss is under 1.0 from about step 25, so 60 steps hold the same bar in a third of the time."""
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    tok = get_tokenizer("byte")
    rows = np.full((64, 97), -100, np.int32)
    for i, s in enumerate(tsynth.counting_samples(64, 0, 96)):
        ids = tok(s, add_bos=True)
        rows[i, : len(ids)] = ids
    batch = {"inputs": np.where(rows == -100, 0, rows)[None, :, :-1], "labels": rows[None, :, 1:]}
    config = tllama.tiny_config(embed_dim=128, num_layers=2, head_dim=32, num_heads=4, num_kv_heads=2,
                                intermediate_dim=256, vocab_size=259, max_seq_len=96)
    model = tllama.init(config, seed=0, dtype=torch.float32, device="cpu")
    set_trainable(model, ())
    state = TrainState(model, toptim.get_optimizer("AdamW", trainable_parameters(model), 3e-3))

    def loss_fn(m, mb):
        return tllama.forward(m, mb["inputs"].long(), labels=mb["labels"]), (mb["labels"] != -100).sum()

    step = make_train_step(loss_fn)
    losses = [float(step(state, batch)["loss"]) for _ in range(60)]
    assert losses[-1] < 1.0, (losses[0], losses[-1])
