"""The decode graph runner (models/decode_graph.py) on the CPU, against the JAX package.

On CPU tensors there is no graph: the step body runs over the runner's static buffers,
which a later request of the same batch shape reuses, cache and all. Held against the JAX
package on a ``tiny_config`` model (2 layers, fp32) carried across with ``params_from_jax``:
``prefill_start`` + ``decode_chunk`` through the runner's buffers (uniform and ragged)
give JAX's tokens, and the cache they leave gives JAX's next-step logits (rtol / atol 1e-5,
the tolerance of tests/test_torch_generate.py: fp32, summation order only); two successive
requests on one buffer set each equal JAX ``generate``; ``generate_stream`` with an early
stop equals JAX ``generate_stream`` block for block; the continuous scheduler, which
dispatches a chunk before it collects the one before (the tokens of a chunk live in a ring
the next chunk overwrites), gives each row JAX's scheduler's and unbatched greedy tokens,
and ``decode_rows`` over two chunks equals JAX ``decode_rows``.

The bookkeeping, with the card's capture replaced by a stub that replays the body: a key is
reused, a new key makes a new entry, eviction is bounded; replacing a parameter's storage
captures again; each replay credits the launches its capture recorded (a launch off the
capturing stream counts where it runs); every counted wrapper is in the one registry with
the name its kernel carries in a trace, which ``check_trace`` holds counts to; a mesh
refuses the graph by name; a superseded state refuses to decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models.generate import decode_chunk as jdecode_chunk
from llama_x_tpu.models.generate import generate as jgenerate
from llama_x_tpu.models.generate import generate_stream as jgenerate_stream
from llama_x_tpu.models.generate import prefill_start as jprefill_start
from llama_x_tpu.ops.attention import MaskInfo as JMaskInfo
from llama_x_tpu.serve import continuous as jcont
from llama_x_tpu_torch.models import decode_graph as dg
from llama_x_tpu_torch.models import generate as tgen
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.ops import decode_attention as da
from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.serve import continuous as tcont

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 300


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_config(max_seq_len=64)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(max_seq_len=64), device="cpu")
    return params, jcfg, model


@pytest.fixture
def model(pair):
    """The pair's model with a runner of its own for this test."""
    dg.release(pair[2])
    yield pair[2]
    dg.release(pair[2])


def _prompt(seed, B, P, V=256):
    return np.random.default_rng(seed).integers(0, V, (B, P)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_through_the_runner_matches_jax(pair, model, ragged):
    """prefill_start + two decode_chunk calls through the runner's buffers: JAX's tokens,
    a cache whose written positions equal JAX's, and JAX's logits for the next step from
    that cache."""
    params, jcfg, _ = pair
    prompt = _prompt(1, 3, 9)
    lens = np.array([9, 4, 6], np.int32) if ragged else None
    jfirst, jstate = jprefill_start(params, jcfg, jnp.asarray(prompt), key=jax.random.PRNGKey(0),
                                    cache_dtype=jnp.float32, prompt_lens=None if lens is None else jnp.asarray(lens))
    tfirst, tstate = tgen.prefill_start(model, _t(prompt).long(), cache_dtype=torch.float32, max_new_tokens=9,
                                        prompt_lens=None if lens is None else _t(lens))
    assert tstate.slot is not None  # the runner's buffer set
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    for n in (3, 5):
        jtoks, jstate = jdecode_chunk(params, jcfg, jstate, jax.random.split(jax.random.PRNGKey(1), n))
        ttoks, tstate = tgen.decode_chunk(model, tstate, n)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    jcache, jtok, jpos, jdone = jstate
    np.testing.assert_array_equal(tstate.tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jdone))
    end = int(np.max(np.asarray(jpos)))
    for side in (0, 1):
        np.testing.assert_allclose(tstate.cache[side][..., :end, :].numpy(), np.asarray(jcache[side])[..., :end, :],
                                   **TOL)
    # the next step's logits, each package's trunk over its own decoded cache
    pos = np.broadcast_to(np.asarray(jpos), (3,)).astype(np.int32)
    jmi = JMaskInfo(causal=True, q_positions=jnp.asarray(pos)[:, None], kv_len=jnp.asarray(pos + 1))
    jx = jnp.take(params["tok_embeddings"]["weight"], jtok[:, None], axis=0)
    jh, _ = jllama.trunk(params, jcfg, jx, jmi, jcache, input_pos=jnp.asarray(pos)[:, None])
    want = jllama.head(params, jcfg, jh)
    with torch.inference_mode():
        tpos = _t(pos).long()[:, None]
        mi = MaskInfo(causal=True, q_positions=tpos, kv_len=_t(pos + 1))
        h, _ = tllama.trunk(model, tllama.embed(model, tstate.tok[:, None]), mi, tstate.cache, input_pos=tpos)
        got = tllama.head(model, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_two_requests_on_one_buffer_set_each_match_jax(pair, model, ragged):
    """Two successive ``generate`` calls of one batch shape with different prompts (the
    second prompt shorter): one buffer set serves both, cache included, and each equals JAX."""
    params, jcfg, _ = pair
    ptrs = []
    for seed, P in ((2, 12), (3, 7)):
        prompt = _prompt(seed, 2, P)
        lens = np.array([P, P - 3], np.int32) if ragged else None
        want = jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=10, cache_dtype=jnp.float32,
                         prompt_lens=None if lens is None else jnp.asarray(lens))
        got = tgen.generate(model, _t(prompt).long(), max_new_tokens=10, cache_dtype=torch.float32,
                            prompt_lens=None if lens is None else _t(lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        ptrs.append([t.data_ptr() for t in dg.runner_of(model).slots[(2, ragged, torch.float32)].buffers()])
    assert ptrs[0] == ptrs[1] and dg.stats(model)["slots"] == 1


def test_generate_stream_with_an_early_stop_matches_jax(pair, model):
    """Both rows reach their eos early: the port's blocks, through the runner, equal JAX's
    block for block, and the stream stops where JAX's does."""
    params, jcfg, _ = pair
    prompt = _prompt(4, 2, 6)
    full = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=20, cache_dtype=jnp.float32))
    eos = next(int(t) for t in full[0, 1:8] if t in full[1, :8])  # a token both rows emit early
    kw = dict(max_new_tokens=20, chunk_size=3, eos_id=eos, pad_id=5)
    want = [np.asarray(b) for b in jgenerate_stream(params, jcfg, jnp.asarray(prompt), cache_dtype=jnp.float32, **kw)]
    got = [b.numpy() for b in tgen.generate_stream(model, _t(prompt).long(), cache_dtype=torch.float32, **kw)]
    assert sum(b.shape[1] for b in want) < 20  # the stream stopped early
    assert [b.shape for b in got] == [b.shape for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # one row whose eos is its first decoded token: the stream stops after two blocks
    kw["eos_id"] = int(full[0, 1])
    want = [np.asarray(b) for b in jgenerate_stream(params, jcfg, jnp.asarray(prompt[:1]), cache_dtype=jnp.float32,
                                                    **kw)]
    got = [b.numpy() for b in tgen.generate_stream(model, _t(prompt[:1]).long(), cache_dtype=torch.float32, **kw)]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _run(sched, waves):
    handles = []
    try:
        for wave in waves:
            rows = [sched.submit(ids, max_tokens=n) for ids, n in wave]
            for r in rows:
                assert r.event.wait(timeout=TIMEOUT) and r.error is None, r.error
            handles += rows
    finally:
        sched.close()
    return handles


def test_scheduler_dispatching_before_it_collects_matches_jax(pair, model, monkeypatch):
    """Rows that run over many 3-step chunks through 2 slots: the worker dispatches chunk
    i + 1 (whose steps overwrite the ring, emitted and done) before it collects chunk i, so
    each row's tokens hold only if the chunk was copied out at its dispatch. Each row
    equals the JAX scheduler's and unbatched JAX greedy."""
    params, jcfg, _ = pair
    rng = np.random.default_rng(5)
    waves = [[([int(t) for t in rng.integers(0, 256, n)], m) for n, m in ((7, 14), (11, 9), (5, 12))],
             [([int(t) for t in rng.integers(0, 256, 9)], 10)]]
    order = []
    dispatch, collect = tcont.ContinuousScheduler._dispatch_chunk, tcont.ContinuousScheduler._collect
    monkeypatch.setattr(tcont.ContinuousScheduler, "_dispatch_chunk",
                        lambda self: order.append("d") or dispatch(self))
    monkeypatch.setattr(tcont.ContinuousScheduler, "_collect", lambda self, c: order.append("c") or collect(self, c))
    common = dict(n_slots=2, chunk_size=3, prompt_multiple=16)
    got = _run(tcont.ContinuousScheduler(model, cache_dtype=torch.float32, **common), waves)
    want = _run(jcont.ContinuousScheduler(params, jcfg, cache_dtype=jnp.float32, **common), waves)
    assert "ddc" in "".join(order)  # a chunk dispatched while the one before was not yet collected
    for (ids, n), g, w in zip((row for wave in waves for row in wave), got, want):
        single = np.asarray(jgenerate(params, jcfg, jnp.asarray([ids]), max_new_tokens=n, cache_dtype=jnp.float32))
        assert g.tokens == w.tokens == single[0].tolist()


def test_decode_rows_matches_jax_decode_rows(pair, model):
    """Two rows admitted into 3 slots (one empty), two chunks of ``decode_rows`` with
    budgets that freeze one row mid-chunk: tokens, positions, done, emitted and the
    cache's written positions equal JAX's."""
    params, jcfg, _ = pair
    greedy = (0.0, 0, 1.0, 0.0)
    prompts = [_prompt(6, 1, 8)[0].tolist(), _prompt(7, 1, 5)[0].tolist()]
    jstate = jcont.init_state(jcfg, 3, jnp.float32)
    tstate = tcont.init_state(model.config, 3, torch.float32, "cpu")
    inputs = tcont.AdmitBuffers(model, tstate[0])
    for slot, ids in enumerate(prompts):
        padded = jnp.asarray([ids + [0] * (16 - len(ids))], jnp.int32)
        _, jstate = jcont.admit_row(params, jcfg, jstate, jnp.int32(slot), padded, jnp.int32(len(ids)),
                                    jax.random.PRNGKey(slot), jnp.asarray(greedy, jnp.float32), jnp.int32(-1),
                                    cache_dtype=jnp.float32)
        _, tstate = tcont.admit_row(model, tstate, inputs, slot, ids, greedy, -1, prompt_multiple=16)  # JAX's bucket
    z = np.zeros(3, np.float32)
    budget = np.array([9, 4, 1], np.int32)
    args = (z, np.zeros(3, np.int32), np.ones(3, np.float32), z, np.full(3, -1, np.int32), budget)
    targs = tuple(_t(a) if a.dtype == np.float32 else _t(a).long() for a in args)
    for n in (4, 4):
        jtoks, jstate = jcont.decode_rows(params, jcfg, jstate, jax.random.split(jax.random.PRNGKey(2), n),
                                          *map(jnp.asarray, args))
        ttoks, tstate = tcont.decode_rows(model, tstate, n, None, *targs)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    for got, want in zip(tstate[1:5], jstate[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row in (0, 1):  # each admitted row's positions up to its last write
        end = int(tstate[2][row]) + 1
        for side in (0, 1):
            np.testing.assert_allclose(tstate[0][side][:, row, :, :end].numpy(),
                                       np.asarray(jstate[0][side])[:, row, :, :end], **TOL)


# ---------------------------------------------------------------------------
# bookkeeping, the card's capture replaced by a stub that replays the body
# ---------------------------------------------------------------------------


class _StubGraph:
    def __init__(self, body, model, generator):
        self.body, self.model, self.generator = body, model, generator
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.body(self.model, self.generator)


@pytest.fixture
def stub_card(monkeypatch):
    """Route CPU tensors through the runner's card path; a capture runs the first step
    eagerly and returns a stub graph whose replay runs the body."""
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


def test_keys_reuse_a_graph_and_eviction_is_bounded(pair, model, stub_card, monkeypatch):
    params, jcfg, _ = pair
    prompt = _prompt(8, 2, 6)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=6, cache_dtype=jnp.float32))
    run = lambda B=2, **kw: tgen.generate(model, _t(prompt[:B]).long(), max_new_tokens=6,  # noqa: E731
                                          cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(run().numpy(), want)  # first call: one eager step, a capture, 4 replays
    np.testing.assert_array_equal(run().numpy(), want)  # the same key: replays only
    s = dg.stats(model)
    assert (s["captures"], s["replays"], s["graphs"], s["slots"]) == (1, 4 + 5, 1, 1)
    run(pad_id=3)  # a new static argument: a new graph on the same buffer set
    assert dg.stats(model)["captures"] == 2 and dg.stats(model)["graphs"] == 2
    monkeypatch.setattr(dg, "MAX_SLOTS", 2)
    monkeypatch.setattr(dg, "MAX_GRAPHS", 3)
    for B in (1, 2, 1):  # new buffer sets (B 1), then back: the set of B 2 was kept
        run(B=B)
    s = dg.stats(model)
    assert s["slots"] == 2 and s["graphs"] <= 3 and s["captures"] == 3
    run(B=2, prompt_lens=torch.tensor([6, 4]))  # a third buffer set evicts the least recent (B 2's), with its graphs
    s = dg.stats(model)
    assert s["slots"] == 2 and s["graphs"] == 2 and s["captures"] == 4
    assert (2, False, torch.float32) not in dg.runner_of(model).slots


def test_replacing_a_parameter_captures_again(pair, model, stub_card):
    params, jcfg, _ = pair
    prompt = _t(_prompt(9, 2, 5)).long()
    first = tgen.generate(model, prompt, max_new_tokens=4, cache_dtype=torch.float32)
    tgen.generate(model, prompt, max_new_tokens=4, cache_dtype=torch.float32)
    assert dg.stats(model)["captures"] == 1
    w = model.layers[0].attention.wq.weight
    old = w.data
    try:
        w.data = old.clone()  # new storage, same values
        again = tgen.generate(model, prompt, max_new_tokens=4, cache_dtype=torch.float32)
        assert dg.stats(model)["captures"] == 2
        torch.testing.assert_close(again, first, rtol=0, atol=0)
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
        tgen.generate(model, prompt, max_new_tokens=4, cache_dtype=torch.float32)
        assert dg.stats(model)["captures"] == 3
    finally:
        w.data = old


def test_each_replay_credits_the_launches_its_capture_recorded(monkeypatch):
    """A stub capture whose step launches 3 K3 and 2 K1 on the capturing stream: the capture
    counts none of them (nothing ran there), each replay credits 3 and 2."""
    from llama_x_tpu_torch.ops import int8_mm as mm

    monkeypatch.setattr(launches, "capturing", lambda: True)

    class Graph:
        def replay(self):
            pass

    def capture():
        for fn in (da.decode_attention,) * 3 + (mm.int8_mm_dequant_nt,) * 2:
            launches.add(fn)
        return Graph()

    before = (da.decode_attention.launches, mm.int8_mm_dequant_nt.launches)
    captured = dg.Captured(capture)
    assert (da.decode_attention.launches, mm.int8_mm_dequant_nt.launches) == before
    assert captured.credits == {da.decode_attention: 3, mm.int8_mm_dequant_nt: 2}
    captured.replay(5)
    assert (da.decode_attention.launches, mm.int8_mm_dequant_nt.launches) == (before[0] + 15, before[1] + 10)


def test_a_launch_off_the_capturing_stream_counts_where_it_runs(monkeypatch):
    """During a capture, a wrapper launching on a stream that is not being captured runs
    its kernel there and then: it counts at once and no replay credits it. Outside a capture
    a launch counts at once."""
    flags = iter([True, False, True])
    monkeypatch.setattr(launches, "capturing", lambda: next(flags))

    class Graph:
        def replay(self):
            pass

    def capture():
        for _ in range(3):
            launches.add(da.decode_attention)
        return Graph()

    before = da.decode_attention.launches
    captured = dg.Captured(capture)
    assert da.decode_attention.launches == before + 1 and captured.credits == {da.decode_attention: 2}
    captured.replay(2)
    assert da.decode_attention.launches == before + 5
    launches.add(da.decode_attention)  # no capture open: the stream is not asked
    assert da.decode_attention.launches == before + 6


# kernel names as a device trace of the card gives them (demangled), one per counted wrapper
TRACE_NAMES = {
    "int8_mm_dequant_nt": ["void (anonymous namespace)::int8_mm_nt_stream_kernel<1>((anonymous namespace)::Args, int)",
                           "void (anonymous namespace)::int8_mm_nt_wgmma_kernel<256>(CUtensorMap_st, CUtensorMap_st, "
                           "(anonymous namespace)::Args, int)"],
    "int8_mm_dequant": ["void (anonymous namespace)::int8_mm_kn_kernel<256>(CUtensorMap_st, CUtensorMap_st, "
                        "(anonymous namespace)::Args, int)"],
    "flash_attention": ["void (anonymous namespace)::flash_fwd_kernel<128, false, false>(CUtensorMap_st, "
                        "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)"],
    "flash_attention_offsets": ["void (anonymous namespace)::flash_fwd_kernel<128, false, true>(CUtensorMap_st, "
                                "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)"],
    "flash_attention_bwd": ["void (anonymous namespace)::flash_bwd_dkv_kernel<64, true, false>(CUtensorMap_st)"],
    "flash_attention_bwd_ring": ["void (anonymous namespace)::flash_bwd_dkv_kernel<128, false, true>(CUtensorMap_st)"],
    "flash_probe": ["void (anonymous namespace)::flash_probe_kernel<128>(CUtensorMap_st, CUtensorMap_st)"],
    "decode_attention": ["void (anonymous namespace)::decode_kernel<false, 128, 1>((anonymous namespace)::Params)"],
    "decode_attention_int8": ["void (anonymous namespace)::decode_kernel<true, 128, 4>((anonymous namespace)::Params)"],
    "quantize_rows": ["void (anonymous namespace)::quantize_rows_kernel<__nv_bfloat16, __nv_bfloat16, 8, 128>("
                      "__nv_bfloat16 const*, __nv_bfloat16 const*, signed char*, __nv_bfloat16*, int, int)",
                      "void (anonymous namespace)::quantize_rows_kernel<float, float, 1, 32>(float const*, "
                      "float const*, signed char*, float*, int, int)"],
    "ssd_scan": ["void (anonymous namespace)::ssd_scan_kernel<256>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
                 "float const*, float const*, float const*, float*, long const*, long const*, long const*, float*, "
                 "float*, int, int, int, int, int)"],
    "ssd_step": ["void (anonymous namespace)::ssd_step_kernel<256>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
                 "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float const*, float const*, "
                 "__nv_bfloat16*, float*, bool const*, int*, unsigned long long*, float*, int, int, int, int)"],
    "ssd_conv": ["ssd_conv_kernel"],
    "gated_norm": ["gated_norm_kernel"],
}
TRACE_NAMES["flash_attention_ring"] = TRACE_NAMES["flash_attention"]  # the ring form is K2's self form


def test_every_counted_wrapper_is_registered_with_its_kernel_name():
    """Each function of the kernel modules that keeps a launch count is in the one registry,
    and its trace name matches its own kernel's names and no other wrapper's kernel (the
    ring form shares K2's self form, the backward's dq kernel and the merge match nothing)."""
    from llama_x_tpu_torch.ops import flash_attention, flash_probe, int8, int8_mm, ssd

    wrappers = {fn for mod in (int8_mm, int8, da, flash_attention, flash_probe, ssd) for fn in vars(mod).values()
                if callable(fn) and hasattr(fn, "launches")}
    assert wrappers == set(launches.COUNTED.values()) and len(launches.COUNTED) == len(TRACE_NAMES) == 15
    others = ["void (anonymous namespace)::decode_merge_kernel((anonymous namespace)::Params, int)",
              "void (anonymous namespace)::flash_bwd_dq_kernel<128, false, false>(CUtensorMap_st)",
              "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(int, float)",
              "void at::native::vectorized_elementwise_kernel<4, at::native::round_kernel_cuda(at::TensorIteratorBase&)"]
    for name, fn in launches.COUNTED.items():
        same = {n for n, f in launches.COUNTED.items() if f.device_kernel.pattern == fn.device_kernel.pattern}
        for other, kernels in TRACE_NAMES.items():
            assert all(bool(fn.device_kernel.search(k)) == (other in same) for k in kernels), (name, other)
        assert not any(fn.device_kernel.search(k) for k in others), name


def test_check_trace_holds_counts_to_the_kernels_of_a_trace():
    trace = (TRACE_NAMES["int8_mm_dequant_nt"] * 3 + TRACE_NAMES["decode_attention_int8"] * 2
             + TRACE_NAMES["flash_attention"] * 2 + ["void (anonymous namespace)::decode_merge_kernel(Params, int)"])
    counts = {name: 0 for name in launches.COUNTED} | dict(int8_mm_dequant_nt=6, decode_attention_int8=2,
                                                           flash_attention=1, flash_attention_ring=1)
    traced = launches.check_trace(trace, counts, "a window")
    assert traced["int8_mm_dequant_nt"] == 6 and traced["decode_attention_int8"] == 2
    assert traced["flash_attention + flash_attention_ring"] == 2 and traced["decode_attention"] == 0
    counts["decode_attention_int8"] = 3  # a credit the device never ran
    with pytest.raises(AssertionError, match="a window: the wrappers counted 3 launches of decode_attention_int8, "
                                             "the device trace shows 2"):
        launches.check_trace(trace, counts, "a window")


def test_a_mesh_refuses_the_graph_by_name(pair, model):
    prompt = _t(_prompt(10, 2, 5)).long()
    model.__dict__["mesh"] = object()  # what parallel/sharding.py:shard_params leaves on a model
    try:
        with pytest.raises(ValueError, match="generate step: the model is placed on a mesh.*eager=True"):
            tgen.generate(model, prompt, max_new_tokens=3, cache_dtype=torch.float32)
        state = tcont.init_state(model.config, 2, torch.float32, "cpu")
        z = torch.zeros(2)
        with pytest.raises(ValueError, match="decode_rows step: the model is placed on a mesh"):
            tcont.decode_rows(model, state, 2, None, z, z.long(), z + 1, z, z.long() - 1, z.long() + 4)
    finally:
        del model.__dict__["mesh"]


def test_a_superseded_state_refuses_to_decode(model):
    prompt = _t(_prompt(11, 2, 5)).long()
    _, old = tgen.prefill_start(model, prompt, cache_dtype=torch.float32, max_new_tokens=4)
    _, new = tgen.prefill_start(model, prompt, cache_dtype=torch.float32, max_new_tokens=4)
    with pytest.raises(RuntimeError, match="superseded"):
        tgen.decode_chunk(model, old, 2)
    tgen.decode_chunk(model, new, 2)
    # eager states own their buffers: they interleave
    _, a = tgen.prefill_start(model, prompt, cache_dtype=torch.float32, max_new_tokens=4, eager=True)
    _, b = tgen.prefill_start(model, prompt, cache_dtype=torch.float32, max_new_tokens=4, eager=True)
    ta, _ = tgen.decode_chunk(model, a, 2, eager=True)
    tb, _ = tgen.decode_chunk(model, b, 2, eager=True)
    torch.testing.assert_close(ta, tb, rtol=0, atol=0)


def test_a_request_refused_for_its_length_leaves_the_live_state(model):
    """A prefill that the length check refuses takes no buffer set: the state it would
    have superseded still decodes."""
    prompt = _t(_prompt(12, 2, 5)).long()
    _, live = tgen.prefill_start(model, prompt, cache_dtype=torch.float32, max_new_tokens=4)
    with pytest.raises(ValueError, match="exceed max_seq_len"):
        tgen.prefill_start(model, prompt, cache_dtype=torch.float32, max_new_tokens=model.config.max_seq_len)
    tgen.decode_chunk(model, live, 2)
