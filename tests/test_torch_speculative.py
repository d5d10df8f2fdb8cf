"""The port's speculative decoding (models/speculative.py) and speculative continuous
batching (serve/speculative.py) against the JAX package's on the same weights (fp32
``tiny_config`` trees carried across with ``params_from_jax``), on the CPU.

Held: greedy speculative output equals the JAX package's and the target's own greedy
``generate``, token for token, at gamma 1, 4 and 9 (9: a verify of 10 query rows, which
the card reads through the flash kernel's offsets form), for one row and for ragged rows,
with eos padding; a self-draft accepts every proposal (the number of target passes is
the formula's); ``speculative_accept``'s first token follows the target row p, the first
draft is accepted with probability sum(min(p, q)), and after a rejection the token
follows norm(max(p - q, 0)) (40k draws, 4-sigma bounds); rows that accept at different
rates (sampled, and greedy with a draft near the target in the tightest caches the entry
check allows) each run to their count as in JAX, no row writing past it; the scheduler's greedy rows equal
JAX's scheduler and ``generate`` with slot reuse at gamma 3 and 8, beside sampled rows,
with per-row stop tokens, and over the int8 cache against the port's ``generate``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_x_tpu.models import llama as jllama
from llama_x_tpu.models.speculative import generate_speculative as jgenerate_speculative
from llama_x_tpu.serve import speculative as jspec
from llama_x_tpu_torch.models import llama as tllama
from llama_x_tpu_torch.models.convert import params_from_jax
from llama_x_tpu_torch.models.generate import generate
from llama_x_tpu_torch.models.speculative import generate_speculative, speculative_accept
from llama_x_tpu_torch.serve import speculative as tspec

torch.set_num_threads(2)
TIMEOUT = 300
DRAFT = dict(num_layers=1, embed_dim=32, num_heads=2, num_kv_heads=2, head_dim=16, intermediate_dim=64)


def _pair(cfg_kw, seed):
    jcfg = jllama.tiny_config(**cfg_kw)
    params = jllama.init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    return params, jcfg, params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(**cfg_kw), device="cpu")


@pytest.fixture(scope="module")
def models():
    """(target, draft) pairs, each (JAX params, JAX config, port model)."""
    return _pair(dict(max_seq_len=128), 0), _pair(dict(max_seq_len=128, **DRAFT), 1)


def _prompts(lens, seed, V=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V, n)] for n in lens]


def _greedy(model, prompt, n, **kw):
    return generate(model, prompt, max_new_tokens=n, cache_dtype=torch.float32, **kw)


@pytest.mark.parametrize("gamma", [1, 4, 9])
def test_greedy_speculative_matches_jax_and_target_greedy(models, gamma):
    (tp, tc, tm), (dp, dc, dm) = models
    prompt = np.random.default_rng(0).integers(0, 256, (1, 8)).astype(np.int32)
    got, stats = generate_speculative(tm, dm, torch.from_numpy(prompt).long(), max_new_tokens=24, gamma=gamma,
                                      cache_dtype=torch.float32)
    want, jstats = jgenerate_speculative(tp, tc, dp, dc, jnp.asarray(prompt), max_new_tokens=24, gamma=gamma,
                                         cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, _greedy(tm, torch.from_numpy(prompt).long(), 24))
    assert stats["target_passes"] == int(jstats["target_passes"]) and int(stats["tokens_emitted"][0]) == 24


def test_ragged_speculative_rows_with_eos(models):
    """Three ragged rows (right-padded, ``prompt_lens``) and a stop token taken from the
    greedy trajectory: equal to JAX's and to the target's greedy ``generate``, padded
    after the first eos."""
    (tp, tc, tm), (dp, dc, dm) = models
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 256, (3, 9)).astype(np.int32)
    lens = np.array([9, 4, 6], np.int32)
    ref = _greedy(tm, torch.from_numpy(prompt).long(), 12, prompt_lens=torch.from_numpy(lens))
    eos = int(ref[0, 3])
    got, _ = generate_speculative(tm, dm, torch.from_numpy(prompt).long(), max_new_tokens=12, gamma=3, eos_id=eos,
                                  pad_id=0, cache_dtype=torch.float32, prompt_lens=torch.from_numpy(lens))
    want, _ = jgenerate_speculative(tp, tc, dp, dc, jnp.asarray(prompt), max_new_tokens=12, gamma=3, eos_id=eos,
                                    pad_id=0, cache_dtype=jnp.float32, prompt_lens=jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, _greedy(tm, torch.from_numpy(prompt).long(), 12, prompt_lens=torch.from_numpy(lens),
                                    eos_id=eos, pad_id=0))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_self_draft_accepts_every_proposal(models, temperature):
    """The target as its own draft: p == q, so every round emits gamma + 1 tokens and
    the target passes are 1 + ceil((n - 1) / (gamma + 1)); greedy output is exact."""
    (_, _, tm), _ = models
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (1, 8))).long()
    n, gamma = 25, 4
    got, stats = generate_speculative(tm, tm, prompt, max_new_tokens=n, gamma=gamma, temperature=temperature,
                                      top_p=0.95, generator=torch.Generator().manual_seed(5), cache_dtype=torch.float32)
    assert stats["target_passes"] == 1 + math.ceil((n - 1) / (gamma + 1))
    assert got.shape == (1, n) and int(got.max()) < 256
    if temperature == 0.0:
        assert torch.equal(got, _greedy(tm, prompt, n))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("eager", [False, True])
def test_sampled_rows_that_accept_at_different_rates_run_to_their_count(models, seed, eager):
    """Four sampled rows whose acceptance differs: a row that reaches its count freezes
    while the others go on, and it never writes past its count. In caches of exactly the
    length the entry check allows (target P + n + gamma + 1, draft P + n + gamma), on these
    draws an uncapped row runs past the token buffer and the caches. Every row emits
    max_new_tokens, as in JAX."""
    (tp, _, _), (dp, _, _) = models
    P, n, gamma = 8, 6, 4
    tc, dc = jllama.tiny_config(max_seq_len=P + n + gamma + 1), jllama.tiny_config(max_seq_len=P + n + gamma, **DRAFT)
    tm = params_from_jax(jax.tree.map(np.asarray, tp), tllama.tiny_config(max_seq_len=P + n + gamma + 1), device="cpu")
    dm = params_from_jax(jax.tree.map(np.asarray, dp), tllama.tiny_config(max_seq_len=P + n + gamma, **DRAFT),
                         device="cpu")
    prompt = np.random.default_rng(0).integers(0, 256, (4, P)).astype(np.int32)
    kw = dict(max_new_tokens=n, gamma=gamma, temperature=1.0)
    got, stats = generate_speculative(tm, dm, torch.from_numpy(prompt).long(), generator=torch.Generator().manual_seed(seed),
                                      cache_dtype=torch.float32, eager=eager, **kw)
    _, jstats = jgenerate_speculative(tp, tc, dp, dc, jnp.asarray(prompt), key=jax.random.PRNGKey(seed),
                                      cache_dtype=jnp.float32, **kw)
    assert stats["tokens_emitted"].tolist() == np.asarray(jstats["tokens_emitted"]).tolist() == [6] * 4
    assert got.shape == (4, 6) and int(got.max()) < 256


def test_greedy_rows_with_mixed_acceptance_in_the_tightest_caches():
    """A draft near the target (the target's weights plus seeded noise of half their
    spread) accepts at a different rate in each row, in caches of exactly the length the
    entry check allows (target P + n + gamma + 1, draft P + n + gamma): the tokens, the
    target passes and the tokens emitted are JAX's."""
    P, n, gamma = 8, 6, 4
    jcfg, dcfg = jllama.tiny_config(max_seq_len=P + n + gamma + 1), jllama.tiny_config(max_seq_len=P + n + gamma)
    params = jllama.init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(3)
    dparams = jax.tree.map(lambda a: np.asarray(a) + 0.5 * np.asarray(a).std()
                           * rng.standard_normal(a.shape).astype(np.float32), params)
    tm = params_from_jax(jax.tree.map(np.asarray, params), tllama.tiny_config(max_seq_len=P + n + gamma + 1),
                         device="cpu")
    dm = params_from_jax(dparams, tllama.tiny_config(max_seq_len=P + n + gamma), device="cpu")
    prompt = np.random.default_rng(0).integers(0, 256, (4, P)).astype(np.int32)
    want, jstats = jgenerate_speculative(params, jcfg, jax.tree.map(jnp.asarray, dparams), dcfg, jnp.asarray(prompt),
                                         max_new_tokens=n, gamma=gamma, cache_dtype=jnp.float32)
    for eager in (False, True):
        got, stats = generate_speculative(tm, dm, torch.from_numpy(prompt).long(), max_new_tokens=n, gamma=gamma,
                                          cache_dtype=torch.float32, eager=eager)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats["target_passes"] == int(jstats["target_passes"]) == 6
        assert stats["tokens_emitted"].tolist() == np.asarray(jstats["tokens_emitted"]).tolist()


def test_speculative_accept_follows_its_formula():
    """The rejection step over 40k independent rows of one (p, q) pair, drafts drawn
    from q: the first token's law is p_0; the first draft is accepted with probability
    sum_x min(p_0(x), q_0(x)); a first token after a rejection follows
    norm(max(p_0 - q_0, 0)); m lies in [1, gamma + 1]."""
    rng = np.random.default_rng(7)
    V, gamma, n = 11, 3, 40_000
    q = torch.from_numpy(rng.dirichlet(np.ones(V) * 0.6, size=gamma).astype(np.float32))
    p = torch.from_numpy(rng.dirichlet(np.ones(V) * 0.6, size=gamma + 1).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    drafts = torch.stack([torch.multinomial(q[i], n, replacement=True, generator=gen) for i in range(gamma)], dim=1)
    emitted, m = speculative_accept(drafts, q.expand(n, gamma, V), p.expand(n, gamma + 1, V), gen)
    first = emitted[:, 0]
    law = torch.bincount(first, minlength=V).double() / n
    np.testing.assert_allclose(law.numpy(), p[0].numpy(), atol=0.012)  # per-bin s.e. <= 0.0025
    accepted = first == drafts[:, 0]
    p_accept = float(torch.minimum(p[0], q[0]).sum())
    assert abs(float(accepted.double().mean()) - p_accept) < 4 * math.sqrt(p_accept * (1 - p_accept) / n)
    rejected = first[m == 1]
    resid = torch.clamp(p[0] - q[0], min=0)
    resid = resid / resid.sum()
    law_r = torch.bincount(rejected, minlength=V).double() / len(rejected)
    np.testing.assert_allclose(law_r.numpy(), resid.numpy(), atol=4 * math.sqrt(0.25 / len(rejected)))
    assert int(m.min()) >= 1 and int(m.max()) <= gamma + 1


def _run(sched, rows_kw):
    try:
        handles = [sched.submit(ids, max_tokens=n, **kw) for ids, n, kw in rows_kw]
        for h in handles:
            assert h.event.wait(timeout=TIMEOUT) and h.error is None, h.error
    finally:
        sched.close()
    return handles


@pytest.fixture(scope="module")
def sched_models():
    """The JAX scheduler test's pair: a 64-position target and a 1-layer draft."""
    return _pair(dict(max_seq_len=64), 0), _pair(dict(max_seq_len=64, num_layers=1), 7)


@pytest.mark.parametrize("gamma", [3, 8])
def test_scheduler_greedy_rows_match_the_jax_scheduler(sched_models, gamma):
    """3 requests through 2 slots beside a sampled row: each greedy row equals the JAX
    scheduler's and the target's unbatched ``generate``; the sampled row emits its budget
    of in-vocabulary tokens; a row with its own stop token stops there. At gamma 8 the
    verify is 9 query rows over the slots (the offsets form's read on the card)."""
    (tp, tc, tm), (dp, dc, dm) = sched_models
    prompts = _prompts([5, 11, 8, 7], 3)
    full = _greedy(tm, torch.tensor([prompts[0]]), 10)[0].tolist()
    eos = full[4]
    rows = [(prompts[0], 10, dict(eos_id=eos)), (prompts[1], 10, {}), (prompts[2], 10, {}),
            (prompts[3], 12, dict(sampling=(1.1, 9, 0.9, 0.0)))]
    common = dict(n_slots=2, chunk_size=2, gamma=gamma, prompt_multiple=16)
    got = _run(tspec.SpeculativeScheduler(tm, dm, cache_dtype=torch.float32, **common), rows)
    want = _run(jspec.SpeculativeScheduler(tp, tc, dp, dc, cache_dtype=jnp.float32, **common), rows)
    assert got[0].tokens == want[0].tokens == full[: full.index(eos) + 1] and got[0].finish_reason == "stop"
    for i in (1, 2):
        assert got[i].tokens == want[i].tokens == _greedy(tm, torch.tensor([prompts[i]]), 10)[0].tolist()
    assert len(got[3].tokens) == 12 and all(0 <= t < 256 for t in got[3].tokens)


def test_scheduler_self_draft_full_acceptance_and_int8(sched_models):
    """Draft == target: every round emits gamma + 1 tokens (3 or 4 rounds for 13 tokens
    at gamma 3: the in-flight chunk may add one); the int8 caches give the target's
    ``generate`` with the int8 cache."""
    (_, _, tm), (_, _, dm) = sched_models
    p = _prompts([6], 41)[0]
    sched = tspec.SpeculativeScheduler(tm, tm, n_slots=1, chunk_size=1, gamma=3, cache_dtype=torch.float32)
    (r,) = _run(sched, [(p, 13, {})])
    assert r.tokens == _greedy(tm, torch.tensor([p]), 13)[0].tolist() and 3 <= sched.rounds_run <= 4
    p8 = _prompts([9], 51)[0]
    (r8,) = _run(tspec.SpeculativeScheduler(tm, dm, n_slots=2, chunk_size=2, gamma=3, cache_dtype=torch.int8),
                 [(p8, 8, {})])
    assert r8.tokens == generate(tm, torch.tensor([p8]), max_new_tokens=8, cache_dtype=torch.int8)[0].tolist()


def test_scheduler_refuses_what_does_not_compose(sched_models):
    (_, _, tm), (_, _, dm) = sched_models
    for kw in (dict(prefix_cache=2), dict(prefill_chunk=16)):
        with pytest.raises(ValueError, match="compose"):
            tspec.SpeculativeScheduler(tm, dm, **kw)


def test_generate_cli_with_a_draft_model_prints_plain_greedy(tmp_path, capsys):
    """``generate_cli --model <dir> --draft_model <dir>``: speculative decoding from HF
    directories prints what the plain command prints (greedy, fp32 weights; a vocabulary
    of 512 holds the byte tokenizer's ids)."""
    from llama_x_tpu_torch import generate_cli
    from llama_x_tpu_torch.models.hf import save_llama_hf

    tm = _pair(dict(max_seq_len=128, vocab_size=512), 0)[2]
    dm = _pair(dict(max_seq_len=128, vocab_size=512, **DRAFT), 1)[2]
    save_llama_hf(tm, tmp_path / "target", dtype=torch.float32)
    save_llama_hf(dm, tmp_path / "draft", dtype=torch.float32)
    common = ["--model", str(tmp_path / "target"), "--device", "cpu", "--prompt", "hello", "--max_new_tokens", "12",
              "--no_eos", "--kv_dtype", "bf16"]
    capsys.readouterr()
    generate_cli.main(common)
    plain = capsys.readouterr()
    generate_cli.main([*common, "--draft_model", str(tmp_path / "draft"), "--gamma", "3"])
    spec = capsys.readouterr()
    assert spec.out == plain.out and "target passes" in spec.err
