"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX package on the CPU:
the cases of tests/test_pipeline.py, each with its JAX reference (the single-device fused
loss forward, ``fusion.fuse_forward``, the JAX dp step) computed here and the port's
pipeline run by 2 or 4 gloo processes (``tests/torch_dist_workers.py``, at most four a
case: the JAX test's 8-stage case runs at 4 stages of 2 layers, and its dp 2 x pp 4 meshes
at dp 2 x pp 2). Each group of cases shares one set of processes (a module fixture).

Tolerances are the JAX tests' own: losses ``rtol=1e-5``, gradients and updated tensors
``rtol=1e-4``, ``atol=1e-6``; after three AdamW steps taken by two frameworks, an entry whose
gradient is at noise level may move by a rounding of lr (ROADMAP C, "Adam"), so there 99.9%
of the entries are held to that and every entry to 1% of lr."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import audio as jaudio
from llama_x_tpu.models import fusion as jfusion
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.train.trainer import init_train_state, make_train_step as jmake_train_step
from llama_x_tpu.utils.tree import named_leaves
from llama_x_tpu_torch.adapters.lora import tree_path
from torch_dist_workers import run_ranks

JAX_TOL = dict(rtol=1e-4, atol=1e-6)


def _setup(num_layers=8, B=4, S=32, tied=False):
    """The JAX test's ``_setup``: (JAX config, params, tokens, labels, port config fields)."""
    kw = dict(num_layers=num_layers, max_seq_len=64, tied_embeddings=tied)
    config = jllama.tiny_config(attn_impl="xla", **kw)
    params = jllama.init(jax.random.PRNGKey(0), config, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, config.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, config.vocab_size, (B, S)).astype(np.int32)
    labels[:, -3:] = -100  # some ignored positions
    return config, params, tokens, labels, kw


def _np(params):
    return jax.tree.map(np.asarray, params)


def _jax_named(grads: dict) -> dict:
    """{port parameter name: array} -> {JAX tree path: array}: layers stacked in order, a
    linear's weight transposed back to the JAX kernel."""
    by = {}
    for name, g in grads.items():
        path = tree_path(name)
        g = g.T if path.endswith("/kernel") and g.ndim == 2 else g
        layer = int(name.split(".")[1]) if name.startswith("layers.") else 0
        by.setdefault(path, []).append((layer, g))
    return {p: np.stack([g for _, g in sorted(v, key=lambda e: e[0])]) if p.startswith("layers/") else v[0][1]
            for p, v in by.items()}


def _case(params, kw, tokens, labels, micro, **extra):
    batch = {"tokens": tokens, "labels": labels}
    for k in ("seg", "prefix"):
        if k in extra:
            batch[k] = extra.pop(k)
    return dict(params=_np(params), config=kw, freeze=(), batch=batch, micro=micro, **extra)


def _prefix(B=4, D=64):
    return np.random.default_rng(2).standard_normal((B, 8, D)).astype(np.float32)


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    """The 4-stage cases in one set of four processes, in this order: the loss at M 4 and at
    M 2 (8 layers), the gradients, tied embeddings, packed documents, the fused CE, the prefix
    without and with prefix-LM (with gradients)."""
    _, params8, tokens, labels, kw8 = _setup()
    _, params4, tok4, lab4, kw4 = _setup(num_layers=4, B=4, S=16)
    _, tied, ttok, tlab, kwt = _setup(tied=True)
    seg = np.sort(np.random.default_rng(1).integers(1, 4, tokens.shape), axis=1).astype(np.int32)
    _, p432, tok432, lab432, kw432 = _setup(num_layers=4, B=4, S=32)
    cases = [
        _case(params8, kw8, tokens, labels, 4), _case(params8, kw8, tokens, labels, 2),
        _case(params4, kw4, tok4, lab4, 2, grads=True), _case(tied, kwt, ttok, tlab, 4),
        _case(params8, kw8, tokens, labels, 4, seg=seg),
        _case(p432, dict(kw432, fused_ce_chunks=4), tok432, lab432, 2),
        _case(params4, kw4, tok4, lab4, 2, prefix=_prefix()),
        _case(params4, kw4, tok4, lab4, 2, prefix=_prefix(), prefix_lm=True, grads=True),
    ]
    return run_ranks(dict(kind="pipeline", world=4, mesh=dict(pp=4), cases=cases),
                     tmp_path_factory.mktemp("pp4"), timeout=240)[0]


def _jax_loss(config, params, tokens, labels, **kw):
    return float(jllama.forward(params, config, jnp.asarray(tokens), labels=jnp.asarray(labels), **kw))


@pytest.mark.parametrize("n_stages,n_micro,at", [(4, 4, 0), (8, 2, 1), (2, 4, None)])
def test_pipeline_loss_matches_single_device(n_stages, n_micro, at, tmp_path, pp4):
    config, params, tokens, labels, kw = _setup()
    want = _jax_loss(config, params, tokens, labels)
    if at is None:  # two stages of four layers: a set of two processes of its own
        got = run_ranks(dict(kind="pipeline", world=2, mesh=dict(pp=2), cases=[
            _case(params, kw, tokens, labels, n_micro)]), tmp_path)[0][0]["loss"]
    else:
        got = pp4[at]["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_pipeline_grads_match_single_device(pp4):
    config, params, tokens, labels, _ = _setup(num_layers=4, B=4, S=16)
    g_ref = jax.grad(lambda p: jllama.forward(p, config, jnp.asarray(tokens), labels=jnp.asarray(labels)))(params)
    got = _jax_named(pp4[2]["grads"])
    want = dict(named_leaves(g_ref))
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], np.asarray(w), err_msg=n, **JAX_TOL)


def test_pipeline_tied_embeddings(pp4):
    config, params, tokens, labels, _ = _setup(tied=True)
    np.testing.assert_allclose(pp4[3]["loss"], _jax_loss(config, params, tokens, labels), rtol=1e-5)


def test_pipeline_document_mask(pp4):
    config, params, tokens, labels, _ = _setup()
    seg = jnp.asarray(np.sort(np.random.default_rng(1).integers(1, 4, tokens.shape), axis=1), jnp.int32)
    np.testing.assert_allclose(pp4[4]["loss"], _jax_loss(config, params, tokens, labels, segment_ids=seg), rtol=1e-5)


def test_pipeline_fused_ce_matches_plain(pp4):
    config, params, tokens, labels, _ = _setup(num_layers=4, B=4, S=32)
    plain = _jax_loss(config, params, tokens, labels)
    fused = _jax_loss(config.replace(fused_ce_chunks=4), params, tokens, labels)
    np.testing.assert_allclose(pp4[5]["loss"], plain, rtol=1e-5)
    np.testing.assert_allclose(pp4[5]["loss"], fused, rtol=1e-5)


def test_pipeline_prefix_matches_fuse_forward(pp4):
    config, params, tokens, labels, _ = _setup(num_layers=4, B=4, S=16)
    prefix = jnp.asarray(_prefix())
    for plm, res in ((False, pp4[6]), (True, pp4[7])):
        want = float(jfusion.fuse_forward(params, config, [prefix], jnp.asarray(tokens), labels=jnp.asarray(labels),
                                          prefix_lm=plm))
        np.testing.assert_allclose(res["loss"], want, rtol=1e-5, err_msg=f"prefix_lm={plm}")
    g_ref = jax.grad(lambda p, pre: jfusion.fuse_forward(p, config, [pre], jnp.asarray(tokens),
                                                         labels=jnp.asarray(labels), prefix_lm=True),
                     argnums=(0, 1))(params, prefix)
    np.testing.assert_allclose(pp4[7]["prefix_grad"], np.asarray(g_ref[1]), **JAX_TOL)
    got = _jax_named(pp4[7]["grads"])
    for n, w in named_leaves(g_ref[0]):
        np.testing.assert_allclose(got[n], np.asarray(w), err_msg=n, **JAX_TOL)


@pytest.fixture(scope="module")
def dp2pp2(tmp_path_factory):
    """The dp 2 x pp 2 cases in one set of four processes: the loss of pipeline_loss with
    the batch split over dp, three pp trainer steps (AdamW), and the audio pp step."""
    _, params, tokens, labels, kw = _setup(num_layers=4, B=4, S=32)
    acfg, aparams, audio, atok, alab, akw = _audio_setup()
    batch = {"tokens": tokens[None], "labels": labels[None]}
    abatch = {"audio": audio[None], "tokens": atok[None], "labels": alab[None]}
    ranks = run_ranks(dict(kind="pipeline", world=4, mesh=dict(dp=2, pp=2), cases=[
        _case(params, kw, tokens, labels, 2)]), tmp_path_factory.mktemp("dppp"), timeout=240)
    steps = run_ranks(dict(kind="pp_step", world=4, mesh=dict(dp=2, pp=2), cases=[
        dict(params=_np(params), config=kw, freeze=(), batch=batch, micro=2, steps=3, lr=1e-3, wd=1e-4),
        dict(params=_np(aparams), config=akw, freeze=(), batch=abatch, micro=2, steps=1, lr=1e-3, wd=1e-4,
             prefix_lm=True)]), tmp_path_factory.mktemp("ppstep"), timeout=240)
    return ranks, steps


def test_pipeline_composes_with_dp(dp2pp2):
    config, params, tokens, labels, _ = _setup(num_layers=4, B=4, S=32)
    want = _jax_loss(config, params, tokens, labels)
    for r in dp2pp2[0]:
        np.testing.assert_allclose(r[0]["loss"], want, rtol=1e-5)


def test_pp_trainer_step_matches_dp(dp2pp2):
    """The pp trainer step (dp 2 x pp 2, the port's make_train_step over the GPipe loss)
    against the JAX trainer's plain step, three AdamW steps: loss and label count every
    step, every updated tensor after them."""
    config, params, tokens, labels, _ = _setup(num_layers=4, B=4, S=32)
    tx = optax.adamw(1e-3)
    mask = jtrainable_mask(params)

    def loss_fn(p, mb):
        return jllama.forward(p, config, mb["inputs"], labels=mb["labels"]), jnp.sum(mb["labels"] != -100)

    state = init_train_state(params, mask, tx)
    step = jax.jit(jmake_train_step(loss_fn, tx))
    batch = {"inputs": jnp.asarray(tokens)[None], "labels": jnp.asarray(labels)[None]}
    want = []
    for _ in range(3):
        state, m = step(state, batch)
        want.append((float(m["loss"]), int(m["n_tokens"])))
    for r in dp2pp2[1]:
        got = r[0]
        np.testing.assert_allclose(got["loss"], [w[0] for w in want], rtol=1e-5)
        assert got["n_tokens"] == [w[1] for w in want]
        for n, w in named_leaves(state["trainable"]):
            w = np.asarray(w)
            np.testing.assert_allclose(got["after"][n], w, rtol=0, atol=1e-5, err_msg=n)
            close = np.abs(got["after"][n] - w) <= JAX_TOL["atol"] + JAX_TOL["rtol"] * np.abs(w)
            assert close.mean() >= 0.999, (n, close.mean())


def _audio_setup():
    config = jllama.tiny_config(num_layers=4, max_seq_len=256, attn_impl="xla")
    audio_config = jaudio.AudioConfig()
    model = jaudio.LlamaAudio.init(jax.random.PRNGKey(1), config, audio_config, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((4, 16_000)) * 0.1).astype(np.float32)  # -> 50 audio tokens
    tokens = rng.integers(1, config.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(1, config.vocab_size, (4, 16)).astype(np.int32)
    return config, model.params, audio, tokens, labels, dict(num_layers=4, max_seq_len=256)


def test_pipeline_audio_trainer_step(dp2pp2):
    """LlamaAudio under pp: the stem outside the pipeline, its tokens the prefix; the step's
    loss equals the single-device audio forward."""
    config, params, audio, tokens, labels, _ = _audio_setup()
    want = float(jaudio.forward(params, config, jaudio.AudioConfig(), jnp.asarray(audio), jnp.asarray(tokens),
                                labels=jnp.asarray(labels), prefix_lm=True))
    for r in dp2pp2[1]:
        np.testing.assert_allclose(r[1]["loss"][0], want, rtol=1e-5)


Q8_PP_POLICIES = ["flash_q8s", "attn_q8s"]


@pytest.fixture(scope="module")
def pp2_q8(tmp_path_factory):
    """The 4-layer float model's pipeline loss and gradients at pp 2 under each q8 policy,
    in one set of two processes."""
    _, params, tokens, labels, kw = _setup(num_layers=4, B=4, S=32)
    cases = [_case(params, dict(kw, activation_checkpointing=True, remat_policy=p), tokens, labels, 2, grads=True)
             for p in Q8_PP_POLICIES]
    return run_ranks(dict(kind="pipeline", world=2, mesh=dict(pp=2), cases=cases),
                     tmp_path_factory.mktemp("ppq8"), timeout=240)[0]


@pytest.mark.parametrize("policy", Q8_PP_POLICIES)
def test_pipeline_q8_policy_matches_the_jax_stage(policy, pp2_q8):
    """A pipeline stage runs each block checkpointed whole under the policy's base, as the
    JAX ``_stage_trunk`` does under ``llama.remat_policy``: no int8 residual in the stage
    (flash_q8s's h1, attn_q8s's q / k / v / out), so the loss and every gradient equal the
    JAX ``pipeline_loss`` at pp 2 under the same policy at the file's fp32 tolerances."""
    from jax.sharding import Mesh

    from llama_x_tpu.parallel.pipeline import pipeline_loss as jpipeline_loss

    config, params, tokens, labels, _ = _setup(num_layers=4, B=4, S=32)
    config = config.replace(activation_checkpointing=True, remat_policy=policy)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    loss, g_ref = jax.jit(jax.value_and_grad(
        lambda p: jpipeline_loss(p, config, jnp.asarray(tokens), jnp.asarray(labels), mesh, 2)))(params)
    res = pp2_q8[Q8_PP_POLICIES.index(policy)]
    np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-5)
    got = _jax_named(res["grads"])
    want = dict(named_leaves(g_ref))
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], np.asarray(w), err_msg=f"{n} ({policy})", **JAX_TOL)
