"""The schedulers' admission programs over static buffers (serve/continuous.py: ``admit_row``,
``admit_row_prefix``, ``prefill_chunk`` + ``install_row``; serve/speculative.py:
``spec_admit_row``), the bodies the decode graph runner captures per prompt-length bucket, on
the CPU against the JAX package.

Each program pads its tokens to the JAX package's bucket (Pb, Sb, the chunk width C) and
runs over ``AdmitBuffers`` (the padded ids, the real length, the slot, the sampling values
and the stop token as device tensors, and the working row cache). Held against the jitted
JAX programs on ``tiny_config`` models (fp32 weights carried across with
``params_from_jax``), over a bf16 and an int8 cache: ``admit_row`` at two buckets (two
prompts sharing one, the second stopping on its first token), ``admit_row_prefix`` at one
(P0, Sb) pair over a prefix harvested from the lane, two chunks of ``prefill_chunk`` with
``install_row`` (the JAX ``prefill_chunk`` x 2, ``sample_first``, ``install_row``), and
``spec_admit_row``: the first token and the slot's tok / pos / done / emitted (or prev / cur
/ pos / done / emitted) exactly, the lane's K/V over [0, Pb) within one rounding of the
cache's form (one bf16 ulp; one int8 step of the row's scale, the scales to 1e-6 relative):
both packages compute K and V in fp32, but their GEMMs sum in their own order before the
rounding into the cache.

The bookkeeping, with the card's capture replaced by a stub that replays the body: one key a
bucket and none a slot or a prefix length; the buffer set's runner keeps every key, apart from
the decode steps';
a replay equals ``eager=True`` bit for bit, sampled rows included; each replay credits its
capture's launches; no body reads anything back from the device; a mesh refuses the graph by
name; a failed admission ends its request with the error; the scheduler's chunked prefills
share one working row, parking a row when another slot's chunk comes between."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.serve import continuous as jcont
from llama_x_tpu.serve import speculative as jspec
from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.models.decode_graph import cache_tensors
from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.serve import continuous as tcont
from llama_x_tpu_torch.serve import speculative as tspec

torch.set_num_threads(2)
TIMEOUT = 300
S_MAX, PM = 64, 16  # max_seq_len and prompt_multiple of every case
DRAFT = dict(num_layers=1, embed_dim=32, num_heads=2, num_kv_heads=2, head_dim=16, intermediate_dim=64)
CACHES = {"bf16": (torch.bfloat16, jnp.bfloat16), "int8": (torch.int8, jnp.int8)}
GREEDY = (0.0, 0, 1.0, 0.0)


def _pair(cfg_kw, seed):
    jcfg = jllama.tiny_config(max_seq_len=S_MAX, **cfg_kw)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(max_seq_len=S_MAX, **cfg_kw),
                            device="cpu")
    return params, jcfg, model


@pytest.fixture(scope="module")
def pairs():
    """(target, draft), each (JAX params, JAX config, port model): a 2-layer target and a
    1-layer draft of width 32, 64 positions each."""
    return _pair({}, 0), _pair(DRAFT, 1)


@pytest.fixture
def models(pairs):
    """The pair's port models with a runner of their own for this test."""
    (_, _, tm), (_, _, dm) = pairs
    dg.release(tm)
    yield tm, dm
    dg.release(tm)


def _ids(seed, n, V=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


def _padded(ids, width):
    return jnp.asarray([ids + [0] * (width - len(ids))], jnp.int32)


def _jsampling(sampling=GREEDY):
    return jnp.asarray(sampling, jnp.float32)


def _lane_close(tcache, jcache, slot, n, form):
    """The port's lane ``slot`` over [0, n) against the JAX cache's, within one rounding of
    the cache's form."""
    got = [t[:, slot, :, :n].float().numpy() for t in cache_tensors(tcache)]
    want = [np.asarray(a)[:, slot, :, :n].astype(np.float32) for a in jax.tree.leaves(jcache)]
    assert len(got) == len(want)
    if form == "bf16":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2**-7, atol=1e-6)  # one bf16 ulp
        return
    for (gd, gs), (wd, ws) in zip(zip(got[::2], got[1::2]), zip(want[::2], want[1::2])):
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
        assert np.all(np.abs(gd - wd) <= 1)  # one int8 step of the row's scale


def _rows_equal(tstate, jstate, idx=range(1, 5)):
    for i in idx:
        np.testing.assert_array_equal(tstate[i].numpy().astype(np.int64), np.asarray(jstate[i]).astype(np.int64))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_admit_row_at_two_buckets_matches_jax(pairs, models, cache):
    """Prompts of 5 and 12 tokens share the bucket 16, one of 20 takes 32: each admitted into
    its own slot of 3; the second stops on its first token (eos = JAX's first token)."""
    (params, jcfg, _), _ = pairs
    tm, _ = models
    t_dtype, j_dtype = CACHES[cache]
    jstate = jcont.init_state(jcfg, 3, j_dtype)
    tstate = tcont.init_state(tm.config, 3, t_dtype, "cpu")
    inputs = tcont.AdmitBuffers(tm, tstate[0])

    def jadmit(state, slot, ids, Pb, eos):
        return jcont.admit_row(params, jcfg, state, jnp.int32(slot), _padded(ids, Pb), jnp.int32(len(ids)),
                               jax.random.PRNGKey(slot), _jsampling(), jnp.int32(eos), cache_dtype=j_dtype)

    for slot, (seed, P) in enumerate(((1, 5), (2, 12), (3, 20))):
        ids = _ids(seed, P)
        Pb = tcont.prompt_bucket(P, PM, S_MAX - 1)
        assert Pb == (16 if P <= 16 else 32)
        # the second prompt stops on its first token
        eos = int(jadmit(jcont.init_state(jcfg, 3, j_dtype), slot, ids, Pb, -1)[0]) if slot == 1 else -1
        jfirst, jstate = jadmit(jstate, slot, ids, Pb, eos)
        tfirst, tstate = tcont.admit_row(tm, tstate, inputs, slot, ids, GREEDY, eos, prompt_multiple=PM)
        assert int(tfirst) == int(jfirst)
        _rows_equal(tstate, jstate)
        _lane_close(tstate[0], jstate[0], slot, Pb, cache)
    assert bool(tstate[3][1]) and not bool(tstate[3][2])


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_admit_row_prefix_matches_jax(pairs, models, cache):
    """A 40-token prompt admitted whole; its first 32 positions harvested from the lane; a
    prompt of those 32 and 9 more admitted over them at (P0 32, Sb 16)."""
    (params, jcfg, _), _ = pairs
    tm, _ = models
    t_dtype, j_dtype = CACHES[cache]
    jstate = jcont.init_state(jcfg, 2, j_dtype)
    tstate = tcont.init_state(tm.config, 2, t_dtype, "cpu")
    inputs = tcont.AdmitBuffers(tm, tstate[0])
    base = _ids(4, 40)
    jfirst, jstate = jcont.admit_row(params, jcfg, jstate, jnp.int32(0), _padded(base, 48), jnp.int32(40),
                                     jax.random.PRNGKey(0), _jsampling(), jnp.int32(-1), cache_dtype=j_dtype)
    _, tstate = tcont.admit_row(tm, tstate, inputs, 0, base, GREEDY, -1, prompt_multiple=PM)
    P0, suffix = 32, _ids(5, 9)
    Sb = tcont.suffix_bucket(len(suffix), PM, S_MAX - P0)
    assert Sb == 16
    jprefix = jcont._slice_prefix(jstate[0], jnp.int32(0), P0)
    jfirst, jstate = jcont.admit_row_prefix(params, jcfg, jstate, jnp.int32(1), jprefix, jnp.int32(P0),
                                            _padded(suffix, Sb), jnp.int32(len(suffix)), jax.random.PRNGKey(1),
                                            _jsampling(), jnp.int32(-1), cache_dtype=j_dtype)
    tfirst, tstate = tcont.admit_row_prefix(tm, tstate, inputs, 1, tcont.slice_prefix(tstate[0], 0, P0), P0, suffix,
                                            GREEDY, -1, prompt_multiple=PM)
    assert int(tfirst) == int(jfirst)
    _rows_equal(tstate, jstate)
    _lane_close(tstate[0], jstate[0], 1, P0 + Sb, cache)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_two_prefill_chunks_and_install_match_jax(pairs, models, cache):
    """A 24-token prompt in chunks of 16 (the second padded): the JAX ``prefill_chunk`` twice,
    ``sample_first`` and ``install_row`` against ``prefill_chunk`` twice and ``install_row``
    into slot 1 of 2: the whole lane (the row cache installs every position)."""
    (params, jcfg, _), _ = pairs
    tm, _ = models
    t_dtype, j_dtype = CACHES[cache]
    ids, C = _ids(6, 24), 16
    jstate = jcont.init_state(jcfg, 2, j_dtype)
    tstate = tcont.init_state(tm.config, 2, t_dtype, "cpu")
    inputs = tcont.AdmitBuffers(tm, tstate[0])
    row = jllama.init_kv_cache(jcfg, 1, dtype=j_dtype)
    for start in (0, C):
        chunk = ids[start:start + C]
        row, h_last = jcont.prefill_chunk(params, jcfg, row, _padded(chunk, C), jnp.int32(start),
                                          jnp.int32(len(chunk)), first=start == 0)
        tcont.prefill_chunk(tm, inputs, chunk, start, C)
    jfirst = jcont.sample_first(params, jcfg, h_last, jax.random.PRNGKey(0), _jsampling())
    jstate = jcont.install_row(jstate, jnp.int32(1), row, jfirst, jnp.int32(24), jnp.int32(-1))
    tfirst, tstate = tcont.install_row(tm, tstate, 1, inputs, 24, GREEDY, -1)
    assert int(tfirst) == int(jfirst)
    _rows_equal(tstate, jstate)
    _lane_close(tstate[0], jstate[0], 1, S_MAX, cache)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_spec_admit_row_matches_jax(pairs, models, cache):
    """Two prompts (7 and 19 tokens: buckets 16 and 32) into slots 2 and 0 of 3: both
    caches' lanes, prev, cur, pos, done and emitted."""
    (tp, tc, _), (dp, dc, _) = pairs
    tm, dm = models
    t_dtype, j_dtype = CACHES[cache]
    jstate = jspec.init_spec_state(tc, dc, 3, j_dtype)
    tstate = tspec.init_spec_state(tm.config, dm.config, 3, t_dtype, "cpu")
    inputs = tcont.AdmitBuffers(tm, tstate[0], tstate[1])
    for slot, (seed, P) in ((2, (7, 7)), (0, (8, 19))):
        ids, Pb = _ids(seed, P), 16 if P <= 16 else 32
        jfirst, jstate = jspec.spec_admit_row(tp, tc, dp, dc, jstate, jnp.int32(slot), _padded(ids, Pb),
                                              jnp.int32(P), jax.random.PRNGKey(slot), _jsampling(), jnp.int32(-1),
                                              cache_dtype=j_dtype)
        tfirst, tstate = tspec.spec_admit_row(tm, dm, tstate, inputs, slot, ids, GREEDY, -1, prompt_multiple=PM)
        assert int(tfirst) == int(jfirst)
        _rows_equal(tstate, jstate, range(2, 7))
        for side in (0, 1):
            _lane_close(tstate[side], jstate[side], slot, Pb, cache)


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
    """Route CPU tensors through the runner's card path; a capture runs the body once
    eagerly and returns a stub graph whose replay runs it. -> the captured programs' names."""
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


def _admissions(tm, state, inputs, eager, gen_seed=None):
    """Three rows into slots 0, 2, 1 (buckets 16, 16, 32; the third sampled), a prefix
    admission into slot 3 over slot 2's first 16 positions and one into slot 0 over slot 1's
    first 32 (both Sb 16, extent 64) -> the first tokens."""
    gen = torch.Generator().manual_seed(gen_seed or 0)
    kw = dict(prompt_multiple=PM, eager=eager)
    firsts = []
    for slot, (seed, P), sampling in ((0, (1, 5), GREEDY), (2, (2, 12), GREEDY), (1, (3, 20), (0.9, 20, 0.9, 0.0))):
        firsts.append(int(tcont.admit_row(tm, state, inputs, slot, _ids(seed, P), sampling, -1, gen, **kw)[0]))
    for src, p0, dst, n in ((2, 16, 3, 6), (1, 32, 0, 9)):
        prefix = tcont.slice_prefix(state[0], src, p0)
        firsts.append(int(tcont.admit_row_prefix(tm, state, inputs, dst, prefix, p0, _ids(9 + n, n), GREEDY, -1, gen,
                                                 **kw)[0]))
    return firsts, gen


def test_a_key_per_bucket_and_none_per_slot_and_replays_equal_eager(models, stub_card):
    """Through the stubbed graph: ``admit_row`` captures once for the bucket 16 (slots 0 and
    2) and once for 32 (slot 1), the prefix admissions once for their (Sb, extent) whatever
    their P0; the same admissions again (other slots) replay only. State, first tokens and
    the generator after equal ``eager=True``'s bit for bit, the sampled row included. A new
    buffer set keeps graphs of its own."""
    tm, _ = models
    states = {}
    for eager in (True, False):
        state = tcont.init_state(tm.config, 4, torch.bfloat16, "cpu")
        inputs = tcont.AdmitBuffers(tm, state[0])
        firsts, gen = _admissions(tm, state, inputs, eager, gen_seed=3)
        states[eager] = (firsts, [t.clone() for t in (*cache_tensors(state[0]), *state[1:5])], gen.get_state())
    assert states[False][0] == states[True][0]
    assert all(torch.equal(a, b) for a, b in zip(states[False][1], states[True][1]))
    assert torch.equal(states[False][2], states[True][2])
    assert stub_card == ["admit_row", "admit_row", "admit_row_prefix"]
    s = inputs.runner.stats()
    assert (s["captures"], s["replays"], s["graphs"]) == (3, 2, 3)
    state = tcont.init_state(tm.config, 4, torch.bfloat16, "cpu")
    inputs = tcont.AdmitBuffers(tm, state[0])
    _admissions(tm, state, inputs, False)  # new buffers: graphs of their own
    for slot in (1, 3):  # another slot, the same bucket: a replay
        tcont.admit_row(tm, state, inputs, slot, _ids(11, 9), GREEDY, -1, prompt_multiple=PM)
    s = inputs.runner.stats()
    assert s["captures"] == 3 and s["replays"] == 2 + 2 and dg.stats(tm)["captures"] == 0


def test_every_admission_key_is_kept_apart_from_the_decode_step(models, stub_card, monkeypatch):
    """With 2 decode graphs at most: admissions at 4 buckets (16, 32, 48, 63) keep all 4
    graphs in the buffer set's runner (a second pass replays each), and the decode step's
    graph, captured before them, stays in the model's (a later chunk replays it)."""
    tm, _ = models
    monkeypatch.setattr(dg, "MAX_GRAPHS", 2)
    state = tcont.init_state(tm.config, 2, torch.float32, "cpu")
    inputs = tcont.AdmitBuffers(tm, state[0])
    z = torch.zeros(2)
    row = (z, z.long(), z + 1, z, z.long() - 1, z.long() + 30)
    tcont.admit_row(tm, state, inputs, 0, _ids(1, 5), GREEDY, -1, prompt_multiple=PM)
    tcont.decode_rows(tm, state, 2, None, *row)
    for _ in range(2):
        for P in (20, 40, 50, 10):
            tcont.admit_row(tm, state, inputs, 1, _ids(P, P), GREEDY, -1, prompt_multiple=PM)
    s = inputs.runner.stats()
    assert (s["graphs"], s["captures"], s["replays"]) == (4, 4, 1 + 4)
    s = dg.stats(tm)
    assert s["graphs"] == 1 and s["captures"] == 1
    tcont.decode_rows(tm, state, 2, None, *row)
    assert dg.stats(tm)["captures"] == 1 and dg.stats(tm)["replays"] == 1 + 2


def test_each_replay_credits_its_captures_launches(models, monkeypatch):
    """K2 counted as on the card: at a stubbed capture the body runs with its launches going
    to the capture's tally, and each replay is credited that tally: an admission of the
    2-layer model is 2 K2 launches, graph or eager, and the graph's credits are {K2: 2}."""
    tm, _ = models
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
        for fn, k in captured.credits.items():  # the admission that ran
            fn.launches += k
        self.captures += 1
        return dg._Entry(captured, {t.data_ptr() for t in buffers})

    monkeypatch.setattr(fa, "flash_fwd_with_lse", counted_k2)
    monkeypatch.setattr(k2, "launches", k2.launches)  # the count this test adds goes with it
    monkeypatch.setattr(launches, "capturing", lambda: capturing[0])
    monkeypatch.setattr(dg, "on_card", lambda t: True)
    monkeypatch.setattr(dg.Runner, "_capture", capture)
    state = tcont.init_state(tm.config, 2, torch.float32, "cpu")
    inputs = tcont.AdmitBuffers(tm, state[0])
    counts = []
    for eager in (True, False, False):  # eager, then a capture, then a replay
        before = k2.launches
        tcont.admit_row(tm, state, inputs, 1, _ids(2, 7), GREEDY, -1, prompt_multiple=PM, eager=eager)
        counts.append(k2.launches - before)
    assert counts == [2, 2, 2]
    (entry,) = inputs.runner.graphs.values()
    assert entry.captured.credits == {k2: 2}


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
def test_no_admission_body_reads_anything_back(models, no_host_reads, cache):
    """Every admission body over its buffers (filled first), with every read back of a
    tensor's value refused: ``admit_row``'s, ``admit_row_prefix``'s, a first and a
    continuation chunk, ``install_row``'s and ``spec_admit_row``'s."""
    tm, dm = models
    dtype = CACHES[cache][0]
    state = tcont.init_state(tm.config, 2, dtype, "cpu")
    sstate = tspec.init_spec_state(tm.config, dm.config, 2, dtype, "cpu")
    inputs, sinputs = tcont.AdmitBuffers(tm, state[0]), tcont.AdmitBuffers(tm, sstate[0], sstate[1])
    gen = torch.Generator().manual_seed(0)
    inputs.feed(_ids(1, 20), 32, 0, slot=1, length=20, start=16, eos_id=5, sampling=(0.8, 10, 0.9, 0.0))
    sinputs.feed(_ids(1, 20), 32, 0, slot=1, length=20, eos_id=5)
    no_host_reads()
    tcont._admit_body(tm, gen, state, inputs, 32)
    tcont._prefix_body(tm, gen, state, inputs, 32, S_MAX, S_MAX)
    tcont._chunk_body(tm, inputs, 32, True, S_MAX)
    tcont._chunk_body(tm, inputs, 32, False, S_MAX)
    tcont._install_body(tm, gen, state, inputs)
    tspec._spec_admit_body(tm, dm, gen, sstate, sinputs, 32)


def test_a_mesh_refuses_the_admission_graph_by_name(models):
    tm, dm = models
    state = tcont.init_state(tm.config, 2, torch.float32, "cpu")
    sstate = tspec.init_spec_state(tm.config, dm.config, 2, torch.float32, "cpu")
    tm.__dict__["mesh"] = object()  # what parallel/sharding.py:shard_params leaves on a model
    try:
        with pytest.raises(ValueError, match="admit_row: the model is placed on a mesh.*eager=True"):
            tcont.admit_row(tm, state, tcont.AdmitBuffers(tm, state[0]), 0, _ids(1, 5), GREEDY, -1)
        with pytest.raises(ValueError, match="prefill_chunk: the model is placed on a mesh"):
            tcont.prefill_chunk(tm, tcont.AdmitBuffers(tm, state[0]), _ids(1, 5), 0, 16)
        with pytest.raises(ValueError, match="spec_admit_row: the model is placed on a mesh"):
            tspec.spec_admit_row(tm, dm, sstate, tcont.AdmitBuffers(tm, sstate[0], sstate[1]), 0, _ids(1, 5), GREEDY,
                                 -1)
    finally:
        del tm.__dict__["mesh"]


def test_a_failed_admission_ends_its_request_with_the_error(models, monkeypatch):
    """An admission that raises (on the card: a capture or replay that failed, which raises
    with the program's name) ends its request at once with that error, and the scheduler
    refuses later ones."""
    tm, _ = models

    def fail(*args, **kwargs):
        raise RuntimeError("admit_row: CUDA graph capture failed")

    monkeypatch.setattr(tcont, "admit_row", fail)
    sched = tcont.ContinuousScheduler(tm, n_slots=2, chunk_size=4, prompt_multiple=PM)
    try:
        h = sched.submit(_ids(1, 5), max_tokens=3)
        assert h.event.wait(timeout=TIMEOUT)
        assert isinstance(h.error, RuntimeError) and "capture failed" in str(h.error)
        with pytest.raises(RuntimeError, match="worker died"):
            sched.submit(_ids(2, 5), max_tokens=3)
    finally:
        sched.close()


def test_interleaved_chunked_prefills_park_the_working_row(models, stub_card, monkeypatch):
    """Chunked prefill of 16 over the int8 cache through 3 slots, the kv bound's bucket cut to
    16 positions: three prompts of 40, 35 and 50 tokens admit together, so their chunks
    interleave on the one working row (each parks its positions in a pooled row when another's
    chunk comes between, and takes them back); a follow-up whose 32-token prefix is cached
    starts from it. Every row equals the eager scheduler's and the port's unbatched
    ``generate`` with the int8 cache; the programs captured: one first chunk, a continuation
    chunk per kv bound (32, 48, 64) and the install, whatever the slot."""
    from llama_x_tpu_torch.models import speculative as mspec
    from llama_x_tpu_torch.models.generate import generate

    tm, _ = models
    monkeypatch.setattr(mspec, "KV_BUCKET", 16)
    base = [_ids(20 + i, n) for i, n in enumerate((40, 35, 50))]
    traffic = [base, [base[0][:32] + _ids(30, 10)]]
    rows = {}
    for eager in (True, False):
        sched = tcont.ContinuousScheduler(tm, n_slots=3, chunk_size=4, prompt_multiple=PM, prefill_chunk=16,
                                          prefix_cache=3, cache_dtype=torch.int8, eager=eager)
        out = []
        try:
            for wave in traffic:
                handles = [sched.submit(ids, max_tokens=6) for ids in wave]
                for h in handles:
                    assert h.event.wait(timeout=TIMEOUT) and h.error is None, h.error
                out += [h.tokens for h in handles]
        finally:
            sched.close()
        rows[eager] = out
        assert sched.prefix_hits == 1 and len(sched.inputs.pool) >= 2
        assert sorted(sched.inputs.free) == list(range(len(sched.inputs.pool)))
    assert rows[False] == rows[True]
    for ids, got in zip(base + traffic[1], rows[False]):
        assert got == generate(tm, torch.tensor([ids]), max_new_tokens=6, cache_dtype=torch.int8)[0].tolist()
    admissions = [n for n in stub_card if n in ("prefill_chunk", "install_row")]
    assert sorted(admissions) == ["install_row"] + ["prefill_chunk"] * 4
    assert sched.inputs.runner.stats()["graphs"] == 5
