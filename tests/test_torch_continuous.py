"""The port's continuous batching (serve/continuous.py) against the JAX package's on the
same weights: a ``tiny_config`` JAX param tree (fp32) carried across with
``params_from_jax``, the same traffic through JAX's ``ContinuousScheduler`` and the
port's, on the CPU.

Held: every row's greedy tokens equal the JAX scheduler's and the port's own unbatched
``generate`` of the same prompt (token for token), with slot reuse, mid-stream
admission, chunked prefill (== one-shot), prefix-cache hits (== misses) and both
together; the counters (``admissions``, ``prefill_dispatches``, ``prefix_hits``,
``prefix_tokens_reused``) equal JAX's for the same traffic; per-row stop tokens; the
int8 cache against the port's ``generate`` with the same cache (the two packages read an
int8 cache through different dequantizations, ROADMAP "Known tolerances"); the per-row
sampler draws what ``generate.sample_logits`` draws for equal rows on one generator, and
its filter equals the JAX filter (the -inf set exactly, the kept logits to 1e-6)."""

import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.serve import continuous as jcont
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.models.generate import generate, sample_logits
from llama_x_tpu_torch.serve import continuous as tcont

torch.set_num_threads(2)
TIMEOUT = 300


@pytest.fixture(scope="module")
def pair():
    jcfg = jllama.tiny_config(max_seq_len=64)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(max_seq_len=64), device="cpu")
    return params, jcfg, model


def _prompts(lens, seed, V=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, n)] for n in lens]


def _isolated(model, ids, n, cache_dtype=torch.float32, eos_id=-1):
    """Unbatched ``generate``, cut after the first eos (the scheduler's raw emissions)."""
    out = generate(model, torch.tensor([ids]), max_new_tokens=n, cache_dtype=cache_dtype, eos_id=eos_id)[0].tolist()
    return out[: out.index(eos_id) + 1] if eos_id in out else out


def _run(sched, traffic):
    """Submit (ids, max_tokens, kw) rows in waves (a list per wave; each wave waits for
    the last) -> the handles, the scheduler closed."""
    handles = []
    try:
        for wave in traffic:
            rows = [sched.submit(ids, max_tokens=n, **kw) for ids, n, kw in wave]
            for r in rows:
                assert r.event.wait(timeout=TIMEOUT) and r.error is None, r.error
            handles += rows
    finally:
        sched.close()
    return handles


_COUNTERS = ("admissions", "prefill_dispatches", "prefix_hits", "prefix_tokens_reused")


def _traffic(kind):
    if kind == "slot reuse":  # 3 requests through 2 slots
        return [[(p, 10, {}) for p in _prompts([5, 11, 8], 3)]]
    base = _prompts([40], 91)[0]
    other = base[:32] + _prompts([8], 92)[0]  # shares a 2-bucket prefix with base
    return [[(base, 8, {}), (_prompts([10], 81)[0], 12, {})], [(other, 6, {}), (list(base), 6, {})]]


@pytest.mark.parametrize("kind,kw", [
    ("slot reuse", {}),
    ("waves", {}),
    ("waves", dict(prefill_chunk=16)),
    ("waves", dict(prefix_cache=4)),
    ("waves", dict(prefix_cache=4, prefill_chunk=16)),
])
def test_scheduler_greedy_rows_match_the_jax_scheduler(pair, kind, kw):
    """The same traffic through both schedulers (2 slots, fp32 cache): each row's greedy
    tokens equal JAX's and the port's unbatched ``generate``; the counters equal JAX's.
    Chunked prefill runs 16-token chunks (the later ones over the row cache, more than
    MAX_SQ rows: the offsets form's read on the card); the prefix cache reuses a 32-token
    prefix twice (the suffix admitted over the cache)."""
    params, jcfg, model = pair
    traffic = _traffic(kind)
    common = dict(n_slots=2, chunk_size=4, prompt_multiple=16, **kw)
    ours = tcont.ContinuousScheduler(model, cache_dtype=torch.float32, **common)
    got = _run(ours, traffic)
    theirs = jcont.ContinuousScheduler(params, jcfg, cache_dtype=jnp.float32, **common)
    want = _run(theirs, traffic)
    for (ids, n, _), g, w in zip((row for wave in traffic for row in wave), got, want):
        assert g.tokens == w.tokens == _isolated(model, ids, n), (g.tokens, w.tokens)
        assert g.finish_reason == w.finish_reason
    for name in _COUNTERS:
        assert getattr(ours, name) == getattr(theirs, name), name
    if kw.get("prefix_cache"):
        assert ours.prefix_hits == 2 and ours.prefix_tokens_reused == 64
    if kw.get("prefill_chunk"):
        assert ours.prefill_dispatches > ours.admissions  # some prompt took several chunks


def test_chunked_prefill_and_prefix_hits_equal_one_shot(pair):
    """Within the port: a 40-token prompt prefilled in 16-token chunks, and a prompt
    whose 32-token prefix comes from the cache, decode the same tokens as a plain
    one-shot admission of the same prompt."""
    _, _, model = pair
    base = _prompts([40], 91)[0]
    other = base[:32] + _prompts([8], 92)[0]
    traffic = [[(base, 8, {})], [(other, 8, {})]]
    plain = _run(tcont.ContinuousScheduler(model, n_slots=2, chunk_size=4, cache_dtype=torch.float32), traffic)
    for kw in (dict(prefill_chunk=16), dict(prefix_cache=2), dict(prefix_cache=2, prefill_chunk=16)):
        sched = tcont.ContinuousScheduler(model, n_slots=2, chunk_size=4, prompt_multiple=16,
                                          cache_dtype=torch.float32, **kw)
        rows = _run(sched, traffic)
        assert [r.tokens for r in rows] == [r.tokens for r in plain], kw
        assert sched.prefix_hits == (1 if kw.get("prefix_cache") else 0)


def test_mid_stream_admission_and_stream_deltas(pair):
    """A second request admitted while the first is mid-decode (proven through its
    stream queue): both rows equal their unbatched outputs, and the first row's stream
    concatenates to its tokens."""
    _, _, model = pair
    pa, pb = _prompts([6, 9], 11)
    sched = tcont.ContinuousScheduler(model, n_slots=2, chunk_size=2, prompt_multiple=16, cache_dtype=torch.float32)
    try:
        qa: queue.Queue = queue.Queue()
        ra = sched.submit(pa, max_tokens=20, stream_q=qa)
        first = qa.get(timeout=TIMEOUT)
        rb = sched.submit(pb, max_tokens=8)
        assert ra.event.wait(timeout=TIMEOUT) and rb.event.wait(timeout=TIMEOUT)
        pieces = list(first)
        while (d := qa.get(timeout=60)) is not None:
            pieces.extend(d)
    finally:
        sched.close()
    assert ra.tokens == _isolated(model, pa, 20) and rb.tokens == _isolated(model, pb, 8)
    assert pieces == ra.tokens and sched.admissions == 2


def test_per_row_eos_and_mixed_sampling(pair):
    """Each row stops on its own stop token (the greedy row's 5th token), a sampled row
    shares the batch and emits its budget of in-vocabulary tokens; the greedy rows are
    exact, as in the JAX scheduler."""
    params, jcfg, model = pair
    p = _prompts([5], 31)[0]
    full = _isolated(model, p, 10)
    eos = full[4]
    traffic = [[(p, 10, dict(eos_id=eos)), (_prompts([4], 32)[0], 10, {}),
                (_prompts([7], 21)[0], 12, dict(sampling=(1.1, 9, 0.9, 0.0)))]]
    got = _run(tcont.ContinuousScheduler(model, n_slots=2, chunk_size=3, cache_dtype=torch.float32), traffic)
    want = _run(jcont.ContinuousScheduler(params, jcfg, n_slots=2, chunk_size=3, prompt_multiple=16,
                                          cache_dtype=jnp.float32), traffic)
    assert got[0].tokens == want[0].tokens == full[: full.index(eos) + 1] and got[0].finish_reason == "stop"
    assert got[1].tokens == want[1].tokens and got[1].finish_reason == "length"
    assert len(got[2].tokens) == 12 and all(0 <= t < 256 for t in got[2].tokens)


@pytest.mark.parametrize("kw", [{}, dict(prefill_chunk=16), dict(prefix_cache=2), dict(prefix_cache=2, prefill_chunk=16)])
def test_int8_cache_matches_generate(pair, kw):
    """The int8 cache (data and scale written in place, prefixes copied as pairs): each
    row equals the port's ``generate`` with the int8 cache."""
    _, _, model = pair
    base = _prompts([35], 71)[0]
    other = base[:32] + _prompts([5], 72)[0]
    sched = tcont.ContinuousScheduler(model, n_slots=2, chunk_size=4, prompt_multiple=16, cache_dtype=torch.int8,
                                      **kw)
    rows = _run(sched, [[(base, 6, {})], [(other, 6, {})]])
    for ids, r in zip((base, other), rows):
        assert r.tokens == _isolated(model, ids, 6, cache_dtype=torch.int8)
    assert sched.prefix_hits == (1 if kw.get("prefix_cache") else 0)


def test_prefix_cache_lru_eviction(pair):
    """prefix_cache=1: a second prefix evicts the first, so the first prompt's return is
    a miss (and harvests again); every row exact."""
    _, _, model = pair
    pa, pb = _prompts([20, 21], 61)
    sched = tcont.ContinuousScheduler(model, n_slots=2, chunk_size=4, prompt_multiple=16, cache_dtype=torch.float32,
                                      prefix_cache=1)
    rows = _run(sched, [[(pa, 6, {})], [(pb, 6, {})], [(pa, 6, {})]])
    for ids, r in zip((pa, pb, pa), rows):
        assert r.tokens == _isolated(model, ids, 6)
    assert sched.prefix_hits == 0 and len(sched.prefixes) == 1


SIGS = [(0.0, 0, 1.0, 0.0), (0.8, 0, 1.0, 0.0), (1.2, 7, 1.0, 0.0), (0.9, 0, 0.7, 0.0), (1.0, 13, 0.85, 0.05),
        (2.0, 0, 1.0, 0.2)]


@pytest.mark.parametrize("sig", SIGS)
def test_rows_sampler_draws_what_the_scalar_sampler_draws(sig):
    """Equal rows and one generator state: ``sample_logits_rows`` draws the tokens of
    ``generate.sample_logits`` (the law of llama_x_tpu/serve/continuous.py:50-54), and
    ``filter_logits_rows`` keeps what the JAX package's keeps."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 97)).astype(np.float32)
    t, k, p, mp = sig
    rows = tcont.sampling_tensors([sig] * 4, "cpu")
    for seed in range(3):
        want = sample_logits(torch.from_numpy(logits), t, k, p, mp, torch.Generator().manual_seed(seed))
        got = tcont.sample_logits_rows(torch.from_numpy(logits), *rows, torch.Generator().manual_seed(seed))
        assert torch.equal(got, want), (sig, seed)
    if t > 0:
        ours = tcont.filter_logits_rows(torch.from_numpy(logits), *rows).numpy()
        theirs = np.asarray(jcont.filter_logits_rows(
            jnp.asarray(logits), jnp.full((4,), t, jnp.float32), jnp.full((4,), k, jnp.int32),
            jnp.full((4,), p, jnp.float32), jnp.full((4,), mp, jnp.float32)))
        np.testing.assert_array_equal(np.isinf(ours), np.isinf(theirs))
        np.testing.assert_allclose(ours[~np.isinf(ours)], theirs[~np.isinf(theirs)], rtol=1e-6, atol=1e-6)


def test_mixed_rows_sampler_follows_each_rows_law():
    """Rows with different parameters in one call: a greedy row takes the raw argmax, a
    top-k 1 row the argmax too, and a sampled row only ever draws inside its nucleus."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    rows = tcont.sampling_tensors([(0.0, 0, 1.0, 0.0), (1.0, 1, 1.0, 0.0), (1.0, 0, 0.5, 0.0)], "cpu")
    allowed = torch.isfinite(tcont.filter_logits_rows(logits, *rows)[2])
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        tok = tcont.sample_logits_rows(logits, *rows, gen)
        assert tok[0] == logits[0].argmax() and tok[1] == logits[1].argmax() and bool(allowed[tok[2]])
