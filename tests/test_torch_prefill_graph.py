"""``generate``'s prefill and ``generate_speculative``'s two prefills through the prefill
runner (models/decode_graph.py: ``prefill_runner_of``, ``PrefillInputs``), the bodies a graph
captures per prompt shape, on the CPU against the JAX package.

On CPU tensors there is no graph: the prefill body runs over the key's input buffers (the
ids, the modality prefix, the prompt lengths, into which each request's tensors are copied)
and the buffer set the request leased. Held against the JAX package on ``tiny_config``
models (fp32 weights carried across with ``params_from_jax``): ``prefill_start`` for
uniform, ragged and ``prefix_embeds`` + ``prefix_lm`` prompts into an fp32, a bf16 and an
int8 cache gives JAX ``prefill_start``'s first token, token, position and done mask exactly,
and its cache over every written position within 2e-4 relative in fp32 (a bf16 or int8 cache
within one rounding of its form: one bf16 ulp; one int8 step, the scales to 1e-6 relative;
both packages compute K and V in fp32 but sum their GEMMs in their own order before the
rounding into the cache); ``generate`` gives JAX ``generate``'s tokens; two requests of one
key with different ids and prefixes each give JAX's, through one set of input buffers read
by a replay; greedy ``generate_speculative`` gives JAX's tokens, target passes and tokens
emitted, its second request a replay of the prefills.

The bookkeeping, with the card's capture replaced by a stub that replays the body: one capture
a key; a new prompt length, prefix length, ragged flag, cache type, ``prefix_lm`` or static
sampling argument makes a new key; every key is kept, with its input buffers; prefill keys
never evict a decode step; replacing a parameter of the model, or of the draft, captures
again; ``release`` drops the prefill graphs, and a graph over a buffer set the decode runner
dropped is never replayed over another set; a replay equals ``eager=True`` bit for bit (first token, cache,
sampled on one seed, the generator left where eager leaves it); each replay credits its
capture's launches; no prefill body reads anything back; a mesh refuses by name before it
takes a buffer set; a failed replay raises with the prefill's name."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models.generate import generate as jgenerate
from llama_x_tpu.models.generate import prefill_start as jprefill_start
from llama_x_tpu.models.speculative import generate_speculative as jgenerate_speculative
from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import generate as tgen
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models import speculative as mspec
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops import launches

torch.set_num_threads(2)
TIMEOUT = 300
DRAFT = dict(num_layers=1, embed_dim=32, num_heads=2, num_kv_heads=2, head_dim=16, intermediate_dim=64)
CACHES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16), "int8": (torch.int8, jnp.int8)}
B, P, T = 3, 9, 5  # rows, prompt length, modality prefix length of the cases
LENS = [9, 4, 6]  # the ragged case's prompt lengths


def _pair(cfg_kw, seed):
    jcfg = jllama.tiny_config(**cfg_kw)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return params, jcfg, params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**cfg_kw), device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """(target, draft), each (JAX params, JAX config, port model): a 2-layer target of 128
    positions and a 1-layer draft of width 32."""
    return _pair(dict(max_seq_len=128), 0), _pair(dict(max_seq_len=128, **DRAFT), 1)


@pytest.fixture
def models(pairs):
    """The pair's port models with runners of their own for this test."""
    (_, _, tm), (_, _, dm) = pairs
    dg.release(tm)
    yield tm, dm
    dg.release(tm)


def _prompt(seed, rows=B, n=P, V=256):
    return np.random.default_rng(seed).integers(0, V, (rows, n)).astype(np.int32)


def _prefix(seed, rows=B, n=T, D=64):
    return np.random.default_rng(seed).standard_normal((rows, n, D)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(case, seed):
    """(prompt, the keyword arguments of either package's prefill as numpy arrays)."""
    prompt = _prompt(seed)
    if case == "ragged":
        return prompt, dict(prompt_lens=np.array(LENS, np.int32))
    if case == "prefix_lm":
        return prompt, dict(prefix_embeds=_prefix(seed + 100), prefix_lm=True)
    return prompt, {}


def _jkw(kw):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _tkw(kw):
    return {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _cache_close(tcache, jcache, n, form):
    """Every cache tensor of the port over positions [0, n) against JAX's."""
    got = [t[:, :, :, :n].float().numpy() for t in dg.cache_tensors(tcache)]
    want = [np.asarray(a)[:, :, :, :n].astype(np.float32) for a in jax.tree.leaves(jcache)]
    assert len(got) == len(want)
    if form == "fp32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-6)
    elif form == "bf16":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2**-7, atol=1e-6)  # one bf16 ulp
    else:
        for (gd, gs), (wd, ws) in zip(zip(got[::2], got[1::2]), zip(want[::2], want[1::2])):
            np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
            assert np.all(np.abs(gd - wd) <= 1)  # one int8 step of the row's scale


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["uniform", "ragged", "prefix_lm"])
def test_prefill_through_the_runner_matches_jax(pairs, models, case, cache):
    """``prefill_start`` through the prefill runner's input buffers into the leased buffer
    set: JAX's first token, token, position and done mask, and JAX's cache."""
    (params, jcfg, _), _ = pairs
    tm, _ = models
    t_dtype, j_dtype = CACHES[cache]
    prompt, kw = _case(case, 1)
    jfirst, (jcache, jtok, jpos, jdone) = jprefill_start(params, jcfg, jnp.asarray(prompt), key=jax.random.PRNGKey(0),
                                                         cache_dtype=j_dtype, eos_id=7, **_jkw(kw))
    tfirst, state = tgen.prefill_start(tm, _t(prompt).long(), cache_dtype=t_dtype, eos_id=7, max_new_tokens=4,
                                       **_tkw(kw))
    assert state.slot is not None and dg.prefill_stats(tm)["slots"] == 1  # the leased set, the key's inputs
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    for got, want in ((state.tok, jtok), (state.pos, jpos), (state.done, jdone)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _cache_close(state.cache, jcache, P + (T if case == "prefix_lm" else 0), cache)


@pytest.mark.parametrize("cache", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["uniform", "ragged", "prefix_lm"])
def test_generate_through_the_prefill_runner_matches_jax(pairs, models, case, cache):
    (params, jcfg, _), _ = pairs
    tm, _ = models
    t_dtype, j_dtype = CACHES[cache]
    prompt, kw = _case(case, 2)
    want = jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=8, cache_dtype=j_dtype, **_jkw(kw))
    got = tgen.generate(tm, _t(prompt).long(), max_new_tokens=8, cache_dtype=t_dtype, **_tkw(kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the bookkeeping, with the capture stubbed
# ---------------------------------------------------------------------------


class _StubGraph:
    def __init__(self, body, model, generator):
        self.body, self.model, self.generator = body, model, generator

    def replay(self):
        self.body(self.model, self.generator)


@pytest.fixture
def stub_card(monkeypatch):
    """Route CPU tensors through the runner's card path; a capture runs the first step
    eagerly and returns a stub graph whose replay runs the body. -> the captured keys' names."""
    captured = []

    def capture(self, model, name, buffers, body, own, draws):
        body(model, own)
        entry = dg._Entry(dg.Captured(lambda: _StubGraph(body, model, own)), {t.data_ptr() for t in buffers})
        self.captures += 1
        captured.append(name)
        return entry

    monkeypatch.setattr(dg, "on_card", lambda t: True)
    monkeypatch.setattr(dg.Runner, "_capture", capture)
    return captured


@pytest.mark.parametrize("case", ["ragged", "prefix_lm"])
def test_two_requests_of_one_key_read_the_static_inputs(pairs, models, stub_card, case):
    """Two ``prefill_start`` calls of one key with different ids (and prefixes): the first
    captures, the second is a replay of the first call's body, which reads the key's input
    buffers; each equals JAX's first token, state and cache."""
    (params, jcfg, _), _ = pairs
    tm, _ = models
    ptrs = []
    for seed in (3, 4):
        prompt, kw = _case(case, seed)
        jfirst, (jcache, jtok, jpos, jdone) = jprefill_start(params, jcfg, jnp.asarray(prompt),
                                                             key=jax.random.PRNGKey(0), cache_dtype=jnp.float32,
                                                             **_jkw(kw))
        tfirst, state = tgen.prefill_start(tm, _t(prompt).long(), cache_dtype=torch.float32, max_new_tokens=4,
                                           **_tkw(kw))
        np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
        for got, want in ((state.tok, jtok), (state.pos, jpos), (state.done, jdone)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _cache_close(state.cache, jcache, P + (T if case == "prefix_lm" else 0), "fp32")
        (inputs,) = dg.prefill_runner_of(tm).slots.values()
        ptrs.append([t.data_ptr() for t in inputs.buffers()])
    s = dg.prefill_stats(tm)
    assert (s["captures"], s["replays"], s["graphs"]) == (1, 1, 1) and ptrs[0] == ptrs[1]
    assert stub_card == ["generate prefill"]


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_generate_speculative_through_the_prefill_runner_matches_jax(pairs, models, stub_card, cache):
    """Two greedy requests of 3 ragged rows of one key (different prompts): each gives JAX's
    tokens, target passes and tokens emitted; the second replays the prefills' graph."""
    (tp, tc, _), (dp, dc, _) = pairs
    tm, dm = models
    t_dtype, j_dtype = CACHES[cache]
    for seed, lens in ((5, [9, 5, 7]), (6, [3, 9, 9])):
        prompt, lens = _prompt(seed), np.array(lens, np.int32)
        kw = dict(max_new_tokens=12, gamma=3)
        want, jstats = jgenerate_speculative(tp, tc, dp, dc, jnp.asarray(prompt), cache_dtype=j_dtype,
                                             prompt_lens=jnp.asarray(lens), **kw)
        got, stats = mspec.generate_speculative(tm, dm, _t(prompt).long(), cache_dtype=t_dtype, prompt_lens=_t(lens),
                                                **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats["target_passes"] == int(jstats["target_passes"])
        assert stats["tokens_emitted"].tolist() == np.asarray(jstats["tokens_emitted"]).tolist()
    s = dg.prefill_stats(tm)
    assert (s["captures"], s["replays"], s["graphs"]) == (1, 1, 1)
    assert stub_card == ["generate_speculative prefill", "generate_speculative round"]


BASE = dict(P=6, prefix=0, ragged=False, cache=torch.float32, prefix_lm=False, temperature=0.0, top_k=0, top_p=1.0,
            min_p=0.0, eos_id=-1)
CHANGES = dict(P=dict(P=7), prefix=dict(prefix=3), ragged=dict(ragged=True), cache=dict(cache=torch.int8),
               prefix_lm=dict(prefix=3, prefix_lm=True), temperature=dict(temperature=0.7),
               top_k=dict(temperature=0.7, top_k=5), top_p=dict(temperature=0.7, top_p=0.9),
               min_p=dict(temperature=0.7, min_p=0.05), eos_id=dict(eos_id=3))


def _request(tm, gen_seed=0, **kw):
    """``prefill_start`` of 2 rows under the arguments of ``BASE`` updated by ``kw``."""
    a = dict(BASE, **kw)
    prompt = _t(_prompt(7, 2, a["P"])).long()
    extra = {}
    if a["ragged"]:
        extra["prompt_lens"] = torch.tensor([a["P"], a["P"] - 2])
    if a["prefix"]:
        extra.update(prefix_embeds=_t(_prefix(8, 2, a["prefix"])), prefix_lm=a["prefix_lm"])
    return tgen.prefill_start(tm, prompt, cache_dtype=a["cache"], temperature=a["temperature"], top_k=a["top_k"],
                              top_p=a["top_p"], min_p=a["min_p"], eos_id=a["eos_id"], max_new_tokens=4,
                              generator=torch.Generator().manual_seed(gen_seed), **extra)


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_one_capture_a_key_and_a_new_key_for_each_static_argument(models, stub_card, change):
    """The base request twice (a capture, then a replay), the changed one twice (a second
    capture and a replay), then the base again (a replay): every key is kept, and the
    prefills never touch the decode steps' runner."""
    tm, _ = models
    for kw in ({}, {}, CHANGES[change], CHANGES[change], {}):
        _request(tm, **kw)
    s = dg.prefill_stats(tm)
    assert (s["captures"], s["replays"], s["graphs"]) == (2, 3, 2)
    assert dg.stats(tm)["captures"] == 0 and stub_card == ["generate prefill"] * 2


def test_every_prefill_key_is_kept(models, stub_card):
    """P 3, 4, 3, 5, 4, 3: three captures, then replays only; each key keeps its graph and its
    input buffers, as JAX keeps every shape it compiled."""
    tm, _ = models
    for n in (3, 4, 3, 5, 4, 3):
        _request(tm, P=n)
    runner = dg.prefill_runner_of(tm)
    assert (runner.captures, runner.replays, len(runner.graphs), len(runner.slots)) == (3, 3, 3, 3)
    assert sorted(k[2] for k in runner.slots) == [3, 4, 5]


def test_prefill_keys_never_evict_a_decode_step(models, stub_card, monkeypatch):
    """Ten prompt lengths through ``generate`` at a cap of 2 decode graphs: one decode step
    captured and kept beside the ten prefill keys."""
    monkeypatch.setattr(dg, "MAX_GRAPHS", 2)
    tm, _ = models
    for n in range(3, 13):
        tgen.generate(tm, _t(_prompt(9, 2, n)).long(), max_new_tokens=3, cache_dtype=torch.float32)
    s, ps = dg.stats(tm), dg.prefill_stats(tm)
    assert (s["captures"], s["graphs"]) == (1, 1)
    assert ps["captures"] == 10 and ps["graphs"] == 10


@pytest.mark.parametrize("which", ["target", "draft"])
def test_replacing_a_parameter_captures_the_prefill_again(models, stub_card, which):
    """New storage for one weight (same values) of the model, or of the draft: the prefill
    graphs that read it go, the next request captures again and gives the same tokens."""
    tm, dm = models
    prompt = _t(_prompt(10, 2, 6)).long()
    kw = dict(max_new_tokens=6, gamma=3, cache_dtype=torch.float32)
    first = mspec.generate_speculative(tm, dm, prompt, **kw)[0]
    if which == "target":
        tgen.generate(tm, prompt, max_new_tokens=4, cache_dtype=torch.float32)
    assert dg.prefill_stats(tm)["captures"] == (2 if which == "target" else 1)
    w = (tm if which == "target" else dm).layers[0].attention.wq.weight
    old = w.data
    try:
        w.data = old.clone()
        assert torch.equal(mspec.generate_speculative(tm, dm, prompt, **kw)[0], first)
        s = dg.prefill_stats(tm)
        assert (s["captures"], s["graphs"]) == ((3, 1) if which == "target" else (2, 1))
    finally:
        w.data = old


def test_release_drops_the_prefill_graphs_and_a_dropped_set_is_never_replayed(models, stub_card, monkeypatch):
    """``release`` drops the prefill runner with the decode runner. When the decode runner
    drops a buffer set (one kept here), the prefill graph that writes it stays but is keyed
    by its addresses: the next request of that shape leases a new set and captures its own
    graph, and the old one is never replayed over it."""
    tm, _ = models
    _request(tm)
    _request(tm)
    assert dg.prefill_stats(tm)["captures"] == 1
    dg.release(tm)
    assert "_prefill_runner" not in tm.__dict__
    _request(tm)
    assert dg.prefill_stats(tm)["captures"] == 1  # a new runner
    monkeypatch.setattr(dg, "MAX_SLOTS", 1)
    _request(tm, ragged=True)  # a second buffer set: the first is dropped
    runner = dg.prefill_runner_of(tm)
    first = next(iter(runner.graphs.values()))  # the graph over the dropped set
    _request(tm)  # a new set for the first shape
    assert (runner.captures, runner.replays, len(runner.graphs)) == (3, 0, 3)
    assert not first.ptrs & {t.data_ptr() for t in dg.runner_of(tm).slots[(2, False, torch.float32)].buffers()}


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_a_replay_equals_the_eager_prefill_bit_for_bit(models, stub_card, cache, sampled):
    """``eager=True``, then the capture, then a replay, on one generator seed: the first
    token and every cache tensor over each row's positions are equal, and the caller's
    generator is left where the eager prefill leaves it."""
    tm, _ = models
    dtype = CACHES[cache][0]
    prompt, lens = _t(_prompt(11, 2, 8)).long(), torch.tensor([8, 5])
    kw = dict(temperature=0.8, top_k=20) if sampled else {}
    outs = []
    for eager in (True, False, False):
        gen = torch.Generator().manual_seed(3)
        first, state = tgen.prefill_start(tm, prompt, cache_dtype=dtype, prompt_lens=lens, max_new_tokens=4,
                                          generator=gen, eager=eager, **kw)
        outs.append((first, [t[:, :, :, :8].clone() for t in dg.cache_tensors(state.cache)], gen.get_state()))
    for first, cache_, gstate in outs[1:]:
        assert torch.equal(first, outs[0][0]) and torch.equal(gstate, outs[0][2])
        assert all(torch.equal(a, b) for a, b in zip(cache_, outs[0][1]))
    assert dg.prefill_stats(tm)["replays"] == 1


@pytest.mark.parametrize("program", ["generate", "speculative"])
def test_each_replay_credits_its_captures_launches(models, monkeypatch, program):
    """K2 counted as on the card: at a stubbed capture the first prefill runs with its
    launches going to the capture's tally, and each replay is credited that tally. A
    prefill of 2 layers is 2 K2 launches (with the 1-layer draft's: 3); through the graph
    each request counts what the eager one counts."""
    tm, dm = models
    k2 = fa.flash_fwd_with_lse
    replaying, capturing = [False], [False]

    def counted_k2(*args, **kwargs):
        if not replaying[0]:
            launches.add(k2)
        return k2(*args, **kwargs)

    class Graph(_StubGraph):
        def replay(self):
            replaying[0] = True
            try:
                super().replay()
            finally:
                replaying[0] = False

    def capture(self, model, name, buffers, body, own, draws):
        def record():
            capturing[0] = True
            try:
                body(model, own)
            finally:
                capturing[0] = False
            return Graph(body, model, own)

        captured = dg.Captured(record)
        for fn, k in captured.credits.items():  # the prefill that ran
            fn.launches += k
        self.captures += 1
        return dg._Entry(captured, {t.data_ptr() for t in buffers})

    monkeypatch.setattr(k2, "launches", k2.launches)  # the count this test adds goes with it
    monkeypatch.setattr(fa, "flash_fwd_with_lse", counted_k2)
    monkeypatch.setattr(launches, "capturing", lambda: capturing[0])
    monkeypatch.setattr(dg, "on_card", lambda t: True)
    monkeypatch.setattr(dg.Runner, "_capture", capture)
    prompt = _t(_prompt(12, 2, 6)).long()
    counts = []
    for eager in (True, False, False):
        before = k2.launches
        if program == "generate":
            tgen.prefill_start(tm, prompt, cache_dtype=torch.float32, max_new_tokens=4, eager=eager)
        else:
            mspec.generate_speculative(tm, dm, prompt, max_new_tokens=1, gamma=3, cache_dtype=torch.float32,
                                       eager=eager)
        counts.append(k2.launches - before)
    per = 2 if program == "generate" else 3
    assert counts == [per] * 3
    (entry,) = dg.prefill_runner_of(tm).graphs.values()
    assert entry.captured.credits == {k2: per}


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every way Python reads a tensor's value back to the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a value read back to the host")

    def guard():
        for name in ("tolist", "item", "numpy", "__bool__", "__int__", "__float__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
    return guard


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_no_prefill_body_reads_anything_back(models, no_host_reads, cache):
    """``generate``'s prefill body (uniform, ragged, prefix-LM; sampled) and
    ``generate_speculative``'s (ragged, sampled) over their buffers, with every read back of
    a tensor's value refused."""
    tm, dm = models
    dtype = CACHES[cache][0]
    gen = torch.Generator().manual_seed(0)
    ids = _t(_prompt(13, 2, 8)).long()
    lens = torch.tensor([8, 3])
    prefix = _t(_prefix(14, 2, 4))
    sample = dict(temperature=0.8, top_k=10, top_p=0.9, min_p=0.0)
    states = [dg.new_state(tm, 2, ragged, dtype) for ragged in (False, True, False)]
    sstate = mspec.new_spec_state(tm, dm, 2, dtype)
    no_host_reads()
    for state, inp, n_prefix in ((states[0], dg.PrefillInputs(ids), 0), (states[1], dg.PrefillInputs(ids, None, lens), 0),
                                 (states[2], dg.PrefillInputs(ids, prefix), 4)):
        tgen._prefill_body(tm, gen, state, inp, n_prefix=n_prefix, prefix_lm=True, eos_id=5, **sample)
    mspec._start(tm, dm, sstate, dg.PrefillInputs(ids, None, lens), gen, eos_id=5, pad_id=0, **sample)


def test_a_mesh_refuses_before_it_takes_a_buffer_set(models):
    tm, dm = models
    prompt = _t(_prompt(15, 2, 5)).long()
    tm.__dict__["mesh"] = object()  # what parallel/sharding.py:shard_params leaves on a model
    try:
        with pytest.raises(ValueError, match="generate step: the model is placed on a mesh.*eager=True"):
            tgen.prefill_start(tm, prompt, cache_dtype=torch.float32, max_new_tokens=3)
        with pytest.raises(ValueError, match="generate_speculative round: the model is placed on a mesh"):
            mspec.generate_speculative(tm, dm, prompt, max_new_tokens=3, cache_dtype=torch.float32)
    finally:
        del tm.__dict__["mesh"]
    assert not dg.runner_of(tm).slots and not dg.prefill_runner_of(tm).slots


@pytest.mark.parametrize("program", ["generate prefill", "generate_speculative prefill"])
def test_a_failed_replay_raises_with_the_prefills_name(models, stub_card, monkeypatch, program):
    tm, dm = models
    prompt = _t(_prompt(16, 2, 5)).long()

    def request():
        if program == "generate prefill":
            return tgen.prefill_start(tm, prompt, cache_dtype=torch.float32, max_new_tokens=3)
        return mspec.generate_speculative(tm, dm, prompt, max_new_tokens=3, cache_dtype=torch.float32)

    request()

    def fail(self):
        raise RuntimeError("an illegal memory access was encountered")

    monkeypatch.setattr(_StubGraph, "replay", fail)
    with pytest.raises(RuntimeError, match=f"{program}: CUDA graph replay failed: an illegal memory access"):
        request()
