"""Speculative decoding's rounds over static buffers (models/speculative.py:_round,
serve/speculative.py:_spec_round), the bodies the decode graph runner captures, on the
CPU against the JAX package.

On CPU tensors there is no graph: ``generate_speculative`` runs its round over the
runner's buffer set (both caches, the token buffer and the round's counters, reused by a
later request of the same batch shape), and ``spec_chunk`` over the scheduler's state, ring
and per-row tensors. Held against the JAX package on ``tiny_config`` models (fp32 weights
carried across with ``params_from_jax``): greedy ``generate_speculative`` over ragged rows
at gamma 3 and 9 with a bf16 and an int8 cache gives JAX's tokens, target passes and tokens
emitted, two requests on one buffer set each; ``spec_chunk`` over two chunks gives JAX's
tokens and state for every greedy row beside a sampled row and an empty slot. Tokens are
compared exactly: both packages round the cache the same way and sum in fp32.

The bookkeeping, with the card's capture replaced by a stub that replays the body: greedy
and sampled are separate keys on one buffer set; a replay equals the eager round; the
verify's kv bound (``verify_bound``, the scheduler's ``_kv_bound``) rounds up to its bucket
and splits keys only where it sizes the int8 cache's dequantized prefix; a draft whose
storage moves captures again and its old graph goes; a model or a draft on a mesh refuses
the graph by name; each replay credits one round's launches; neither body reads anything
back from the device, and the verify's offsets read none with a bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models.speculative import generate_speculative as jgenerate_speculative
from llama_x_tpu.serve import speculative as jspec
from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models import speculative as mspec
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.serve import speculative as tspec

torch.set_num_threads(2)
TIMEOUT = 300
DRAFT = dict(num_layers=1, embed_dim=32, num_heads=2, num_kv_heads=2, head_dim=16, intermediate_dim=64)
CACHES = {"bf16": (torch.bfloat16, jnp.bfloat16), "int8": (torch.int8, jnp.int8)}


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
    """The pair's port models with a runner of their own for this test."""
    (_, _, tm), (_, _, dm) = pairs
    dg.release(tm)
    yield tm, dm
    dg.release(tm)


def _prompt(seed, B, P, V=256):
    return np.random.default_rng(seed).integers(0, V, (B, P)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("gamma", [3, 9])
def test_generate_speculative_over_the_runner_buffers_matches_jax(pairs, models, gamma, cache):
    """Two greedy requests of 3 ragged rows on one buffer set (the second prompt shorter):
    each gives JAX's tokens, target passes and tokens emitted, and the eager round's tokens."""
    (tp, tc, _), (dp, dc, _) = pairs
    tm, dm = models
    t_dtype, j_dtype = CACHES[cache]
    ptrs = []
    for seed, P, lens in ((2, 12, [12, 5, 9]), (3, 7, [7, 7, 2])):
        prompt, lens = _prompt(seed, 3, P), np.array(lens, np.int32)
        kw = dict(max_new_tokens=14, gamma=gamma)
        want, jstats = jgenerate_speculative(tp, tc, dp, dc, jnp.asarray(prompt), cache_dtype=j_dtype,
                                             prompt_lens=jnp.asarray(lens), **kw)
        got, stats = mspec.generate_speculative(tm, dm, _t(prompt).long(), cache_dtype=t_dtype,
                                                prompt_lens=_t(lens), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats["target_passes"] == int(jstats["target_passes"])
        assert stats["tokens_emitted"].tolist() == np.asarray(jstats["tokens_emitted"]).tolist()
        eager, _ = mspec.generate_speculative(tm, dm, _t(prompt).long(), cache_dtype=t_dtype, prompt_lens=_t(lens),
                                              eager=True, **kw)
        assert torch.equal(eager, got)
        (slot,) = dg.runner_of(tm).slots.values()
        ptrs.append([t.data_ptr() for t in slot.buffers()])
    assert ptrs[0] == ptrs[1]


def _jax_state(tp, tc, dp, dc, n_slots, j_dtype, rows):
    state = jspec.init_spec_state(tc, dc, n_slots, j_dtype)
    for slot, (ids, sampling) in rows.items():
        _, state = jspec.spec_admit_row(tp, tc, dp, dc, state, jnp.int32(slot), jnp.asarray([ids], jnp.int32),
                                        jnp.int32(len(ids)), jax.random.PRNGKey(slot),
                                        jnp.asarray(sampling, jnp.float32), jnp.int32(-1), cache_dtype=j_dtype)
    return state


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("gamma", [3, 9])
def test_spec_chunk_over_static_buffers_matches_jax(pairs, models, gamma, cache):
    """Four slots: two greedy rows (budgets 9 and 30), a sampled row and an empty slot; two
    chunks of 2 rounds through ``spec_chunk``'s round over the state, ring and per-row
    tensors: each greedy row's tokens, prev, cur, pos, done and emitted equal JAX
    ``spec_chunk``'s after each chunk; the empty slot stays done and emits nothing."""
    (tp, tc, _), (dp, dc, _) = pairs
    tm, dm = models
    t_dtype, j_dtype = CACHES[cache]
    prompts = [[int(t) for t in _prompt(20 + i, 1, n)[0]] for i, n in enumerate((9, 14, 6))]
    greedy, sampled = (0.0, 0, 1.0, 0.0), (0.9, 20, 0.9, 0.0)
    rows = {0: (prompts[0], greedy), 1: (prompts[1], sampled), 3: (prompts[2], greedy)}
    jstate = _jax_state(tp, tc, dp, dc, 4, j_dtype, rows)
    tstate = tspec.init_spec_state(tm.config, dm.config, 4, t_dtype, "cpu")
    gen = torch.Generator().manual_seed(0)
    inputs = tspec.AdmitBuffers(tm, tstate[0], tstate[1])
    for slot, (ids, sampling) in rows.items():
        _, tstate = tspec.spec_admit_row(tm, dm, tstate, inputs, slot, ids, sampling, -1, gen)
    temperature = [0.0, 0.9, 0.0, 0.0]
    top_k, top_p, min_p, eos, budget = [0, 20, 0, 0], [1.0, 0.9, 1.0, 1.0], [0.0] * 4, [-1] * 4, [9, 12, 1, 30]
    jrow = (jnp.asarray(temperature, jnp.float32), jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p, jnp.float32),
            jnp.asarray(min_p, jnp.float32), jnp.asarray(eos, jnp.int32), jnp.asarray(budget, jnp.int32))
    f32 = dict(dtype=torch.float32)
    trow = (torch.tensor(temperature, **f32), torch.tensor(top_k), torch.tensor(top_p, **f32),
            torch.tensor(min_p, **f32), torch.tensor(eos), torch.tensor(budget))
    live = torch.zeros((), dtype=torch.int64)
    for chunk in range(2):
        keys = jax.random.split(jax.random.PRNGKey(10 + chunk), 2)
        jtoks, jstate = jspec.spec_chunk(tp, tc, dp, dc, jstate, keys, *jrow, gamma=gamma, n_rounds=2)
        ttoks, tstate = tspec.spec_chunk(tm, dm, tstate, 2, gen, *trow, gamma=gamma, live_rounds=live)
        assert ttoks.shape == tuple(jtoks.shape)
        for slot in (0, 2, 3):
            np.testing.assert_array_equal(ttoks[slot].numpy(), np.asarray(jtoks)[slot])
            for i in range(2, 7):
                assert int(tstate[i][slot]) == int(np.asarray(jstate[i])[slot]), (chunk, slot, i)
    assert bool(tstate[5][2]) and int(tstate[6][2]) == 0 and int(tstate[6][1]) <= 12
    assert int(live) >= 4 * 2  # rows 0, 1 and 3 live at the first chunk's rounds, at least


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
    """Route CPU tensors through the runner's card path; a capture runs the first round
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


def _spec(tm, dm, prompt, gen_seed=None, **kw):
    gen = None if gen_seed is None else torch.Generator().manual_seed(gen_seed)
    kw = dict(dict(max_new_tokens=10, gamma=3, cache_dtype=torch.float32), **kw)
    return mspec.generate_speculative(tm, dm, prompt, generator=gen, **kw)


def test_greedy_and_sampled_are_two_keys_on_one_buffer_set(models, stub_card):
    """Greedy twice (one capture, then replays only), sampled twice on one generator seed
    (a second key on the same buffer set): each equals its eager run, the sampled one bit
    for bit from the same seed. The prefills are a graph of the prefill runner, a key each."""
    tm, dm = models
    prompt = _t(_prompt(4, 2, 6)).long()
    want = _spec(tm, dm, prompt, eager=True)[0]
    for _ in range(2):
        assert torch.equal(_spec(tm, dm, prompt)[0], want)
    s = dg.stats(tm)
    assert (s["captures"], s["graphs"], s["slots"]) == (1, 1, 1) and s["replays"] > 0
    sample = dict(temperature=0.8, top_k=40, top_p=0.9)
    want = _spec(tm, dm, prompt, 5, eager=True, **sample)[0]
    for _ in range(2):
        assert torch.equal(_spec(tm, dm, prompt, 5, **sample)[0], want)
    s = dg.stats(tm)
    assert (s["captures"], s["graphs"], s["slots"]) == (2, 2, 1)
    assert stub_card == ["generate_speculative prefill", "generate_speculative round"] * 2  # the prefills' own runner
    assert dg.prefill_stats(tm)["captures"] == 2


def test_the_scheduler_through_the_graph_equals_its_eager_rounds(models, stub_card):
    """``SpeculativeScheduler`` at gamma 3 with a greedy and a sampled row beside each
    other, through the stubbed graph and with ``eager=True``: the same tokens (one seed),
    one capture for every chunk (the bound does not split a float cache's key), and one
    for every admission (the three prompts share the bucket of 64)."""
    tm, dm = models
    prompts = [[int(t) for t in _prompt(30 + i, 1, n)[0]] for i, n in enumerate((7, 12, 5))]
    rows = {}
    for eager in (True, False):
        sched = tspec.SpeculativeScheduler(tm, dm, n_slots=2, chunk_size=2, gamma=3, cache_dtype=torch.float32,
                                           eager=eager)
        try:
            handles = [sched.submit(p, max_tokens=9, sampling=(0.7, 0, 1.0, 0.0) if i == 1 else (0.0, 0, 1.0, 0.0))
                       for i, p in enumerate(prompts)]
            for h in handles:
                assert h.event.wait(timeout=TIMEOUT) and h.error is None, h.error
        finally:
            sched.close()
        rows[eager] = [h.tokens for h in handles]
    assert rows[False] == rows[True] and all(len(r) == 9 for r in rows[False])
    assert stub_card == ["spec_admit_row", "spec_chunk round"] and dg.stats(tm)["captures"] == 1
    assert sched.inputs.runner.captures == 1


def test_the_verify_bound_rounds_up_to_its_bucket_where_it_sizes_the_prefix(models, stub_card, monkeypatch):
    """``verify_bound``: max_seq_len for a bf16 cache and for a verify through the decode
    kernel (gamma + 1 <= MAX_SQ); for the int8 cache from gamma 8, the need rounded up to
    KV_BUCKET and capped at max_seq_len. The scheduler's bound covers each live row's
    position at the last collect plus (gamma + 1) a round for this chunk and the one that may
    be in flight, capped at its budget. In ``generate_speculative`` it is a key: requests whose
    bounds share a bucket share a graph."""
    tm, dm = models
    cfg = tllama.tiny_config(max_seq_len=2048)
    assert mspec.verify_bound(cfg, 600, torch.bfloat16, 9) == 2048
    assert mspec.verify_bound(cfg, 600, torch.int8, da.MAX_SQ - 1) == 2048
    assert [mspec.verify_bound(cfg, n, torch.int8, 8) for n in (1, 512, 513, 1600, 2047)] == [512, 512, 1024, 2048, 2048]
    sched = tspec.SpeculativeScheduler(tm, dm, n_slots=3, chunk_size=4, gamma=9, cache_dtype=torch.int8)
    sched.close()

    class Row:
        def __init__(self, n):
            self.ids = [1] * n

    monkeypatch.setattr(mspec, "KV_BUCKET", 16)
    sched.rows, sched.emitted_seen, sched.budget = [Row(10), None, Row(30)], [3, 0, 1], [40, 0, 5]
    # row 0: 10 + 3 - 1 + 2 chunks x 4 rounds x 10 = 92, over its budget's 49 -> 49; row 2: 34
    assert sched._kv_bound() == mspec.verify_bound(tm.config, 49 + 10, torch.int8, 9) == 64
    prompt = _t(_prompt(5, 2, 8)).long()
    for n, captures in ((4, 1), (6, 1), (20, 2)):  # 8 + n + 9: 21 and 23 -> 32, 37 -> 48
        want = _spec(tm, dm, prompt, max_new_tokens=n, gamma=9, cache_dtype=torch.int8, eager=True)[0]
        assert torch.equal(_spec(tm, dm, prompt, max_new_tokens=n, gamma=9, cache_dtype=torch.int8)[0], want)
        assert dg.stats(tm)["captures"] == captures


def test_a_draft_whose_storage_moves_captures_again(models, stub_card):
    tm, dm = models
    prompt = _t(_prompt(6, 2, 5)).long()
    first = _spec(tm, dm, prompt)[0]
    _spec(tm, dm, prompt)
    assert dg.stats(tm)["captures"] == 1
    w = dm.layers[0].attention.wq.weight
    old = w.data
    try:
        w.data = old.clone()  # new storage, same values
        assert torch.equal(_spec(tm, dm, prompt)[0], first)
        s = dg.stats(tm)
        assert (s["captures"], s["graphs"]) == (2, 1)  # the graph that read the old storage went
    finally:
        w.data = old


def test_a_mesh_refuses_the_graph_by_name(models):
    tm, dm = models
    prompt = _t(_prompt(7, 2, 5)).long()
    state = tspec.init_spec_state(tm.config, dm.config, 2, torch.float32, "cpu")
    z = torch.zeros(2)
    for m in (tm, dm):
        m.__dict__["mesh"] = object()  # what parallel/sharding.py:shard_params leaves on a model
        try:
            with pytest.raises(ValueError, match="generate_speculative round: the model is placed on a mesh.*eager=True"):
                _spec(tm, dm, prompt)
            with pytest.raises(ValueError, match="spec_chunk round: the model is placed on a mesh"):
                tspec.spec_chunk(tm, dm, state, 2, None, z, z.long(), z + 1, z, z.long() - 1, z.long() + 4, gamma=2)
        finally:
            del m.__dict__["mesh"]


def test_each_replay_credits_one_round_of_launches(models, monkeypatch):
    """K3 counted as on the card: at a stubbed capture the first round runs with its launches
    going to the capture's tally, and each replay (which counts nothing itself) is credited
    that tally. One round of gamma 3 is 3 draft steps of 1 layer and one verify of 2 layers:
    5 K3 launches. ``generate_speculative`` and ``spec_chunk`` through the graph count what
    their eager rounds count."""
    tm, dm = models
    k3 = da.decode_attention
    replaying, capturing = [False], [False]

    def counted_k3(*args):
        if not replaying[0]:
            launches.add(k3)
        return da.decode_attention_plain(*args)

    class Graph(_StubGraph):
        def replay(self):
            replaying[0] = True
            try:
                super().replay()
            finally:
                replaying[0] = False

    def capture(self, model, name, buffers, body, own, draws):
        def record():  # the first round, run for real: its launches go to the capture's tally
            capturing[0] = True
            try:
                body(model, own)
            finally:
                capturing[0] = False
            return Graph(body, model, own)

        captured = dg.Captured(record)
        for fn, k in captured.credits.items():  # the round that ran
            fn.launches += k
        self.captures += 1
        return dg._Entry(captured, {t.data_ptr() for t in buffers})

    monkeypatch.setattr(da, "decode_attention", counted_k3)
    monkeypatch.setattr(launches, "capturing", lambda: capturing[0])
    monkeypatch.setattr(dg, "on_card", lambda t: True)
    monkeypatch.setattr(dg.Runner, "_capture", capture)
    prompt = _t(_prompt(8, 2, 6)).long()
    counts = []
    for eager in (True, False):
        before = k3.launches
        _, stats = _spec(tm, dm, prompt, eager=eager)
        counts.append((k3.launches - before, stats["target_passes"]))
    assert counts[0] == counts[1] and counts[0][0] == 5 * (counts[0][1] - 1)
    entries = list(dg.runner_of(tm).graphs.values())
    assert len(entries) == 1 and entries[0].captured.credits == {k3: 5}

    state = tspec.init_spec_state(tm.config, dm.config, 2, torch.float32, "cpu")
    inputs = tspec.AdmitBuffers(tm, state[0], state[1])
    _, state = tspec.spec_admit_row(tm, dm, state, inputs, 0, prompt[0].tolist(), (0.0, 0, 1.0, 0.0), -1)
    z = torch.zeros(2)
    row = (z, z.long(), z + 1, z, z.long() - 1, z.long() + 20)
    for n in (3, 4):  # a capture and 2 replays, then 4 replays
        before = k3.launches
        tspec.spec_chunk(tm, dm, state, n, torch.Generator().manual_seed(0), *row, gamma=3)
        assert k3.launches - before == 5 * n
    assert [e.captured.credits for e in dg.runner_of(tm).graphs.values()][-1] == {k3: 5}


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every way Python reads a tensor's value back to the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a value read back to the host")

    def guard():
        for name in ("tolist", "item", "numpy", "__bool__", "__int__", "__float__"):
            monkeypatch.setattr(torch.Tensor, name, refuse)
    return guard


def test_neither_round_reads_anything_back(models, no_host_reads):
    """``generate_speculative``'s round (greedy and sampled) and ``spec_chunk``'s round over
    their buffers, with every read back of a tensor's value refused; the verify's offsets
    over the cache (``cache_offsets``) read nothing with the caller's bound, and without it
    read the flag and the longest kv_len."""
    tm, dm = models
    gen = torch.Generator().manual_seed(0)
    s = mspec.new_spec_state(tm, dm, 2, torch.float32)
    s.limit.fill_(8)
    s.pos.fill_(3)
    state = tspec.init_spec_state(tm.config, dm.config, 2, torch.float32, "cpu")
    state[4].fill_(3)
    state[5].zero_()
    z = torch.zeros(2)
    row = (z + 0.5, z.long(), z + 1, z, z.long() - 1, z.long() + 20)
    qpos = torch.tensor([[3, 4, 5], [7, 8, 9]])
    mi = MaskInfo(causal=True, q_positions=qpos, kv_len=qpos[:, -1] + 1)
    no_host_reads()
    for temperature in (0.0, 0.8):
        mspec._round(tm, dm, s, gen, gamma=3, kv_bound=128, temperature=temperature, top_k=0, top_p=0.9, min_p=0.0,
                     eos_id=5, pad_id=0)
    tspec._spec_round(tm, dm, state, gen, row, 3, 0, 128, torch.zeros((), dtype=torch.int64))
    q_off, kv_off, lens, kv_max = tllama.cache_offsets(mi, 2, 3, kv_bound=16)
    assert kv_max == 16
    with pytest.raises(AssertionError, match="read back"):
        tllama.cache_offsets(mi, 2, 3)
