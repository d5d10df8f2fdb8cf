"""The train step's graph runner (train/step_graph.py) on the CPU, against the JAX package.

On CPU tensors there is no graph: the step's two bodies (a microbatch, the update) run over
the runner's static buffers, the input buffers, the fp32 gradient accumulators and the
metrics buffer, which the next step reuses. Held against the jitted JAX
``make_train_step`` (llama_x_tpu/train/trainer.py, the optimizer chain of
llama_x_tpu/train/optim.py) on a QLoRA ``tiny_config`` model (2 layers, fp32, int8 base with
dynamic int8 activations and input gradients, LoRA, fused CE with the int8 head) carried
across with ``params_from_jax``: five steps at accumulation 2 give JAX's losses and grad
norms (2e-4 relative, the tolerance of the port's other step tests in fp32) and parameters
(held to a share of steps x lr, as tests/test_torch_train.py holds its curve), with fp32,
8-bit and 4-bit AdamW state; a NaN batch under ``skip_nonfinite`` in the middle of a warmup
leaves JAX's count, learning rate and parameters; the addresses of the parameters, the
moments, the accumulators and the input buffers stay across steps and a ``load_state_dict``;
a step's metrics stay as they were after the next step.

The bookkeeping, with the card's capture replaced by a stub that replays the bodies: one key
per padding bucket, the replays equal to the eager step bit for bit, eviction bounded, a new
parameter storage captured again; the mesh refusal and the dropout seeds' (a config's
``attn_dropout`` without seeds is captured, equal to the eager step); the launch tally
crediting a launch that another thread (the autograd engine's, on the card) issues onto the
capturing stream."""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.adapters import apply_linear_adapter as japply_adapter
from llama_x_tpu.adapters import quantize_linear as jquantize
from llama_x_tpu.adapters import trainable_mask as jtrainable_mask
from llama_x_tpu.models import llama as jllama
from llama_x_tpu.train import optim as joptim
from llama_x_tpu.train import trainer as jtrainer
from llama_x_tpu.utils.tree import named_leaves
from llama_x_tpu_torch import train_metamathqa as ttrain_cli
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.models.decode_graph import Captured
from llama_x_tpu_torch.ops import int8_mm as mm
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.train import optim as toptim
from llama_x_tpu_torch.train import step_graph
from llama_x_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(2)

FREEZE = ("tok_embeddings", "output", "norm")
TOL = 2e-4  # fp32 step tests: the frameworks differ in summation order only
LR, STEPS, ACCUM = 1e-2, 5, 2


def _pair(seed=0, **cfg):
    """(JAX params, JAX config, JAX mask, port model): the QLoRA set-up at tiny width, fp32."""
    kw = dict(max_seq_len=64, vocab_size=256, num_layers=2, dynamic_int8_act=True, dynamic_int8_bwd=True,
              int8_head=True, fused_ce_chunks=4, **cfg)
    jcfg = jllama.tiny_config(**kw)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    params = dict(params, layers=jquantize(params["layers"], "int8"))
    params = dict(params, layers=japply_adapter(params["layers"], "lora", jax.random.PRNGKey(seed + 1), rank=4,
                                                dtype=jnp.float32))
    mask = jtrainable_mask(params, FREEZE)
    jcfg = jcfg.replace(frozen_head=True)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**kw).replace(frozen_head=True),
                            device="cpu", freeze_prefixes=FREEZE)
    return params, jcfg, mask, model


def _step_batch(seed, S=48, B=2, accum=ACCUM, nan=False):
    """A step batch [accum, B, S] of packed rows (tokens, labels with padding, segment ids) and
    a loss scale (NaN poisons the step)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (accum, B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (accum, B, S)).astype(np.int32)
    labels[..., -5:] = -100
    seg = np.sort(rng.integers(1, 4, (accum, B, S)), axis=-1).astype(np.int32)
    scale = np.full((accum,), np.nan if nan else 1.0, np.float32)
    return {"inputs": tokens, "labels": labels, "segment_ids": seg, "scale": scale}


def _jloss(jcfg):
    def loss(p, mb):
        out = jllama.forward(p, jcfg, mb["inputs"], segment_ids=mb["segment_ids"], labels=mb["labels"])
        return out * mb["scale"], jnp.sum(mb["labels"] != -100)

    return loss


def _tloss(model, mb):
    loss, n = ttrain_cli.loss_fn(model, mb)
    return loss * mb["scale"], n


def _optimizers(name, schedule_args=(LR, 8, 0.5, 0.25), **port_kw):
    jtx = joptim.get_optimizer(name, joptim.trapezoid_schedule(*schedule_args), 0.01, 1.0)
    return jtx, lambda params: toptim.get_optimizer(name, params, toptim.trapezoid_schedule(*schedule_args), 0.01, 1.0,
                                                    **port_kw)


def _int_leaves(tree) -> list[int]:
    return [int(x) for x in jax.tree.leaves(tree) if jnp.issubdtype(jnp.asarray(x).dtype, jnp.integer) and x.ndim == 0]


def _held_params(model, jstate, steps, share):
    """Every trainable tensor against JAX's within ``share`` of the most it can have moved
    (steps x lr) in all but 1 entry in 100 (Adam moves a noise-level entry by about lr a step,
    whichever sign its rounding noise gives it); the frozen tensors bit for bit."""
    want = {n: np.asarray(v, np.float32) for n, v in named_leaves(jtrainer.full_params(jstate))}
    got = named_tensors(model)
    for name in ("layers/attention/wq/lora_a", "layers/attention/wq/lora_b", "layers/feed_forward/w2/lora_b"):
        off = np.abs(got[name] - want[name]) > share * steps * LR
        assert off.mean() <= 0.01, (name, off.mean())
    for name in ("layers/attention/wq/int_data", "layers/attention/wq/scale", "output/kernel", "norm/scale"):
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("name,steps,share", [("AdamW", STEPS, 0.02), ("AdamW8bit", STEPS, 0.1), ("AdamW4bit", 2, 0.02)])
def test_five_steps_at_accumulation_2_match_the_jax_step(name, steps, share):
    """Loss, grad norm and label count of every step, the count after them and the trained
    parameters against the jitted JAX step, the runner's buffers reused by every step. 8-bit
    state: a moment on a code's rounding tie may take the neighbouring code on one side, which
    moves that entry's step by up to its size: held at a share of 0.1. 4-bit state: its code
    has 7 levels, and a second moment under (0.5 / 7)^2 of its block's largest decodes to 0
    (here 819 to 1165 of 8448 entries with a live first moment, after each of the first 4
    steps), so a moment that the two frameworks' gradients, 1e-5 apart, put on either side of
    a rounding boundary decodes a whole level apart and changes that entry's next step by a
    large factor. The runs part at the third step (grad norm 0.24% apart, then 9x; the eager
    step before the graph runner parted there alike), so the 4-bit run is held for the two
    steps before."""
    params, jcfg, mask, model = _pair()
    jtx, make_opt = _optimizers(name, (LR, STEPS, 0.2, 0.2))
    jstate = jtrainer.init_train_state(params, mask, jtx)
    jstep = jax.jit(jtrainer.make_train_step(_jloss(jcfg), jtx), donate_argnums=(0,))
    opt = make_opt(ttrainer.trainable_parameters(model))
    state = ttrainer.TrainState(model, opt)
    step = ttrainer.make_train_step(_tloss)
    for i in range(steps):
        batch = _step_batch(10 + i)
        jstate, jm = jstep(jstate, batch)
        tm = step(state, batch)
        assert int(tm["n_tokens"]) == int(jm["n_tokens"]) and float(tm["skipped"]) == 0.0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=10 * TOL)
    assert int(opt.count) == steps and set(_int_leaves(jstate["opt_state"])) == {steps}
    assert step_graph.stats(state)["keys"] == 1
    _held_params(model, jstate, steps, share)


@pytest.mark.parametrize("name", ["AdamW", "AdamW8bit"])
def test_a_nan_batch_in_the_warmup_is_skipped_as_jax_skips_it(name):
    """Steps 0-2 good, step 3 NaN, steps 4-5 good under ``skip_nonfinite`` with a warmup over
    half of 8 steps: the skipped step keeps the parameters, the moments and the count (on the
    device, no read back), so the learning rate after it is read at the same count as JAX's,
    and the parameters after the last step equal JAX's."""
    params, jcfg, mask, model = _pair(seed=1)
    jtx, make_opt = _optimizers(name)
    jstate = jtrainer.init_train_state(params, mask, jtx)
    jstep = jax.jit(jtrainer.make_train_step(_jloss(jcfg), jtx, skip_nonfinite=True))
    opt = make_opt(ttrainer.trainable_parameters(model))
    state = ttrainer.TrainState(model, opt)
    step = ttrainer.make_train_step(_tloss, skip_nonfinite=True)
    jschedule = joptim.trapezoid_schedule(LR, 8, 0.5, 0.25)
    for i in range(6):
        batch = _step_batch(20 + i, nan=i == 3)
        before = [t.clone() for t in opt.tensors()[1:]]
        jstate, jm = jstep(jstate, batch)
        tm = step(state, batch)
        assert float(tm["skipped"]) == float(jm["skipped"]) == float(i == 3)
        (jcount,) = set(_int_leaves(jstate["opt_state"]))
        assert int(opt.count) == jcount == i + 1 - (i >= 3)
        if i == 3:  # the moments kept as they were
            assert all(torch.equal(a, b) for a, b in zip(opt.tensors()[1:], before))
        np.testing.assert_allclose(opt.lr(), float(jschedule(jcount)), rtol=1e-6)
        assert float(opt.learning_rate(opt.count)) == float(np.float32(opt.lr()))  # the float form, rounded once
    assert state.step == 6
    _held_params(model, jstate, 5, 0.02 if name == "AdamW" else 0.1)


@pytest.mark.parametrize("name", ["AdamW", "AdamW8bit"])
def test_state_keeps_its_addresses_across_steps_and_a_load(name):
    """A replayed graph reads and writes the addresses it captured: the parameters, the
    optimizer's count and moments (fp32, or codes and scales), the gradient accumulators and
    the input buffers stay where they are across steps and across ``load_state_dict``, which
    copies into them (and restores the values)."""
    _, _, _, model = _pair(seed=2)
    _, make_opt = _optimizers(name)
    opt = make_opt(ttrainer.trainable_parameters(model))
    state = ttrainer.TrainState(model, opt)
    step = ttrainer.make_train_step(_tloss)
    runner = step_graph.runner_of(state)

    def addresses():
        (entry,) = runner.entries.values()
        return ([p.data_ptr() for p in opt.params], [t.data_ptr() for t in opt.tensors()],
                [t.data_ptr() for t in runner.buffers.grads], [t.data_ptr() for t in entry.inputs.values()])

    step(state, _step_batch(30))
    first = addresses()
    saved = {k: (v if k == "count" else [tuple(t.clone() for t in s) if isinstance(s, tuple) else s.clone() for s in v])
             for k, v in opt.state_dict().items()}
    step(state, _step_batch(31))
    assert addresses() == first and int(opt.count) == 2
    opt.load_state_dict(saved)
    assert addresses() == first and int(opt.count) == 1
    for a, b in zip(opt.tensors()[1:], [t for s in saved["mu"] + saved["nu"] for t in (s if isinstance(s, tuple) else (s,))]):
        assert torch.equal(a, b)
    step(state, _step_batch(32))
    assert addresses() == first and int(opt.count) == 2 and step_graph.stats(state)["keys"] == 1


def test_metrics_of_a_step_stay_after_the_next():
    """Each step's metrics are copies out of the metrics buffer, which the next step
    overwrites: step i's values are what they were after step i + 1, and they are not the
    buffer's tensors."""
    _, _, _, model = _pair(seed=3)
    _, make_opt = _optimizers("AdamW")
    state = ttrainer.TrainState(model, make_opt(ttrainer.trainable_parameters(model)))
    step = ttrainer.make_train_step(_tloss)
    m0 = step(state, _step_batch(40))
    kept = {k: v.clone() for k, v in m0.items()}
    m1 = step(state, _step_batch(41, S=32))
    buf = step_graph.runner_of(state).buffers.metrics
    for k in kept:
        assert torch.equal(m0[k], kept[k]) and m0[k].data_ptr() != buf[k].data_ptr(), k
        assert torch.equal(m1[k], buf[k]), k
    assert float(m0["loss"]) != float(m1["loss"]) and int(m0["n_tokens"]) != int(m1["n_tokens"])


# ---------------------------------------------------------------------------
# bookkeeping, the card's capture replaced by a stub that replays the bodies
# ---------------------------------------------------------------------------


class _StubGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def stub_card(monkeypatch):
    """Route CPU tensors through the runner's card path; a capture runs the first step
    eagerly and returns stub graphs whose replays run the bodies."""
    def capture(self, state, name, entry, batch, accum, micro, update):
        self.eager(state, entry, batch, accum, micro, update)
        entry.micro = Captured(lambda: _StubGraph(lambda: micro(state, self.buffers, entry.inputs)))
        entry.update = Captured(lambda: _StubGraph(lambda: update(state, self.buffers, accum)))
        self.captures += 1

    monkeypatch.setattr(step_graph, "on_card", lambda t: True)
    monkeypatch.setattr(step_graph.Runner, "_capture", capture)


def test_padding_buckets_are_keys_and_replays_equal_the_eager_step(stub_card, monkeypatch):
    """Step batches of three padded lengths: one capture per length, replays after it, and
    every step's metrics and the parameters bit for bit those of the same steps taken with
    ``eager=True`` from the same state. With two keys kept, a third length evicts the least
    recently used, which captures again when it comes back."""
    _, _, _, model = _pair(seed=4)
    _, _, _, twin = _pair(seed=4)
    _, make_opt = _optimizers("AdamW")
    state = ttrainer.TrainState(model, make_opt(ttrainer.trainable_parameters(model)))
    ref = ttrainer.TrainState(twin, make_opt(ttrainer.trainable_parameters(twin)))
    step, eager = ttrainer.make_train_step(_tloss), ttrainer.make_train_step(_tloss, eager=True)
    for i, S in enumerate((32, 48, 32, 48, 32)):
        batch = _step_batch(50 + i, S=S)
        got, want = step(state, batch), eager(ref, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    s = step_graph.stats(state)
    assert (s["keys"], s["graphs"], s["captures"], s["replays"]) == (2, 4, 2, 3)
    assert step_graph.stats(ref)["captures"] == 0
    for a, b in zip(ttrainer.trainable_parameters(model), ttrainer.trainable_parameters(twin)):
        assert torch.equal(a, b)
    monkeypatch.setattr(step_graph, "MAX_KEYS", 2)
    for i, S in enumerate((64, 32, 48)):  # 64 evicts 48 (least recent), 32 replays, 48 captures again
        step(state, _step_batch(60 + i, S=S))
    s = step_graph.stats(state)
    assert (s["keys"], s["captures"], s["replays"]) == (2, 4, 4)


def test_new_parameter_storage_captures_again(stub_card):
    """A parameter given new storage (a LoRA merge, an assignment) changes the fingerprint:
    the graphs and buffers are dropped and the next step captures again, with the same
    values as a state that never moved."""
    _, _, _, model = _pair(seed=5)
    _, _, _, twin = _pair(seed=5)
    _, make_opt = _optimizers("AdamW")
    state = ttrainer.TrainState(model, make_opt(ttrainer.trainable_parameters(model)))
    ref = ttrainer.TrainState(twin, make_opt(ttrainer.trainable_parameters(twin)))
    step = ttrainer.make_train_step(_tloss)
    for i in range(2):
        step(state, _step_batch(70 + i))
        step(ref, _step_batch(70 + i))
    assert step_graph.stats(state)["captures"] == 1
    p = state.trainable[0][1]
    p.data = p.data.clone()
    got, want = step(state, _step_batch(72)), step(ref, _step_batch(72))
    assert step_graph.stats(state)["captures"] == 2
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_a_mesh_refuses_the_graph_by_name():
    """More than one rank cannot be captured (gloo through host memory): ``make_train_step``
    with such a mesh, and a step of a model placed on one, raise by name unless
    ``eager=True``, which is the rule the mesh trainers follow (``eager_reason``)."""
    _, _, _, model = _pair(seed=6)
    mesh = types.SimpleNamespace(size=2)
    with pytest.raises(ValueError, match="train_step: a mesh of 2 ranks"):
        ttrainer.make_train_step(_tloss, mesh=mesh)
    assert "mesh of 2 ranks" in step_graph.eager_reason(model, mesh)
    assert step_graph.eager_reason(model, types.SimpleNamespace(size=1)) is None
    _, make_opt = _optimizers("AdamW")
    state = ttrainer.TrainState(model, make_opt(ttrainer.trainable_parameters(model)))
    model.mesh = mesh
    try:
        with pytest.raises(ValueError, match="train_step: the model is placed on a mesh of 2 ranks"):
            ttrainer.make_train_step(_tloss)(state, _step_batch(80))
    finally:
        del model.mesh


def _seeded_loss(model, mb):
    """``_tloss`` with a dropout seed handed to each layer."""
    loss = tllama.forward(model, mb["inputs"].long(), segment_ids=mb["segment_ids"], labels=mb["labels"],
                          dropout_seeds=[11, 12])
    return loss * mb["scale"], (mb["labels"] != -100).sum()


def test_attention_dropout_refuses_the_graph_by_name():
    """Dropout seeds handed to the forward reach K2 / K5 as host integers, which a graph would
    freeze: a step whose loss hands them raises by name before it changes the state (on CPU
    tensors too), and ``eager=True`` takes it."""
    _, _, _, model = _pair(seed=7)
    model.config = model.config.replace(attn_dropout=0.1)
    _, make_opt = _optimizers("AdamW")
    state = ttrainer.TrainState(model, make_opt(ttrainer.trainable_parameters(model)))
    with pytest.raises(ValueError, match="train_step: dropout seeds are handed to the forward"):
        ttrainer.make_train_step(_seeded_loss)(state, _step_batch(81))
    assert state.step == 0 and int(state.optimizer.count) == 0
    m = ttrainer.make_train_step(_seeded_loss, eager=True)(state, _step_batch(81))
    assert np.isfinite(float(m["loss"])) and state.step == 1


def test_attention_dropout_without_seeds_is_captured_and_equals_the_eager_step(stub_card):
    """A config's ``attn_dropout`` alone does not keep the step from its graph: no trainer's
    loss hands seeds, so no dropout applies. The step is captured once, replayed after, and
    equals ``eager=True`` from the same state bit for bit."""
    _, _, _, model = _pair(seed=8)
    _, _, _, twin = _pair(seed=8)
    for m in (model, twin):
        m.config = m.config.replace(attn_dropout=0.1)
    assert step_graph.eager_reason(model) is None
    _, make_opt = _optimizers("AdamW")
    state = ttrainer.TrainState(model, make_opt(ttrainer.trainable_parameters(model)))
    ref = ttrainer.TrainState(twin, make_opt(ttrainer.trainable_parameters(twin)))
    step, eager = ttrainer.make_train_step(_tloss), ttrainer.make_train_step(_tloss, eager=True)
    for i in range(3):
        got, want = step(state, _step_batch(82 + i)), eager(ref, _step_batch(82 + i))
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    s = step_graph.stats(state)
    assert (s["captures"], s["replays"]) == (1, 2)
    for a, b in zip(ttrainer.trainable_parameters(model), ttrainer.trainable_parameters(twin)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launch tally of a capture, keyed by the capturing stream
# ---------------------------------------------------------------------------


def _on_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_a_launch_from_another_thread_onto_the_capturing_stream_goes_to_the_tally(monkeypatch):
    """The autograd engine launches the backward's kernels from its own device thread onto the
    capturing stream: those launches go to the capture's tally, not to the counter (where they
    would count once, at capture, and never on a replay)."""
    monkeypatch.setattr(launches, "capturing", lambda: True)
    before = mm.int8_mm_dequant.launches
    with launches.tally() as tally:
        launches.add(mm.int8_mm_dequant_nt)
        _on_thread(lambda: [launches.add(mm.int8_mm_dequant) for _ in range(2)])
    assert tally == {mm.int8_mm_dequant_nt: 1, mm.int8_mm_dequant: 2} and mm.int8_mm_dequant.launches == before


def test_each_replay_credits_the_launches_of_every_thread(monkeypatch):
    """A stub capture whose forward launches one K1 and whose backward, on another thread,
    launches two K4: the capture counts none, each of 3 replays credits 1 and 2."""
    monkeypatch.setattr(launches, "capturing", lambda: True)

    class Graph:
        def replay(self):
            pass

    def capture():
        launches.add(mm.int8_mm_dequant_nt)
        _on_thread(lambda: [launches.add(mm.int8_mm_dequant) for _ in range(2)])
        return Graph()

    for fn in (mm.int8_mm_dequant_nt, mm.int8_mm_dequant):
        monkeypatch.setattr(fn, "launches", fn.launches)  # the counts this test adds go with it
    before = (mm.int8_mm_dequant_nt.launches, mm.int8_mm_dequant.launches)
    captured = Captured(capture)
    assert (mm.int8_mm_dequant_nt.launches, mm.int8_mm_dequant.launches) == before
    captured.replay(3)
    assert (mm.int8_mm_dequant_nt.launches, mm.int8_mm_dequant.launches) == (before[0] + 3, before[1] + 6)
