"""The hybrid decoder (models/nemotron_h.py) and its state-space kernels' plain versions
(ops/ssd.py: K8 and K9) against the plain float32 reference (tests/plain_nemotron_h.py) on the
CPU, and the serving scheduler (serve/continuous.py) over the hybrid.

Held, in float32 on seeded weights:
- full-forward logits of the port against the reference's position-by-position recurrence:
  within 2e-4 of the logits' scale (both are f32; the port's SSD runs in chunks of 16, the
  reference step by step, so sums run in another order, and the port rounds the conv's output
  to the model's dtype, here f32);
- K8's plain version against the recurrence over a span from a given state, with pad
  positions after ``length`` (they must leave the state unchanged) and a snapshot at an
  interior offset, at 1e-5 relative (f32 sums in another order); K9's plain version against
  one step of the recurrence, done lanes untouched;
- through ``ContinuousScheduler``, token for token: a multi-chunk prefill then decoding (the
  state crosses chunk boundaries), against the reference's greedy tokens; a prefix-cache hit
  (the snapshot restored) against the same prompt with no hit, and the counters of both.
"""

import time

import pytest
import torch

from llama_x_tpu_torch.models import nemotron_h as nh
from llama_x_tpu_torch.ops import ssd
from llama_x_tpu_torch.serve import continuous as cont
from tests import plain_nemotron_h as ref

torch.set_num_threads(2)
TIMEOUT = 300


def _cfg_dict(c: nh.HybridConfig) -> dict:
    return dict(mamba_heads=c.mamba_heads, mamba_head_dim=c.mamba_head_dim, n_groups=c.n_groups,
                ssm_state=c.ssm_state, num_heads=c.num_heads, num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                eps=c.norm_eps)


def _weights(model: nh.Hybrid) -> dict:
    f = lambda t: t.detach().float()  # noqa: E731
    layers = []
    for blk in model.layers:
        w = dict(kind=blk.kind, norm=f(blk.norm.scale))
        m = blk.mixer
        if blk.kind == "M":
            w.update(in_proj=f(m.in_proj.weight), conv_w=f(m.conv_weight), conv_b=f(m.conv_bias), A_log=f(m.A_log),
                     dt_bias=f(m.dt_bias), D=f(m.D), gate_norm=f(m.norm_weight), out_proj=f(m.out_proj.weight))
        elif blk.kind == "*":
            w.update(wq=f(m.wq.weight), wk=f(m.wk.weight), wv=f(m.wv.weight), wo=f(m.wo.weight))
        else:
            w.update(up=f(m.up.weight), down=f(m.down.weight))
        layers.append(w)
    return dict(embed=f(model.tok_embeddings), norm=f(model.norm.scale), head=f(model.output.weight), layers=layers)


@pytest.fixture(scope="module")
def tiny():
    cfg = nh.tiny_config(max_seq_len=160)
    model = nh.init(cfg, seed=3, dtype=torch.float32, device="cpu")
    return cfg, model, _weights(model)


def _prompt(n, seed, V=256):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, V, (n,), generator=g).tolist()


def test_full_forward_matches_the_reference(tiny):
    cfg, model, w = tiny
    toks = _prompt(70, 1)
    got = nh.forward(model, torch.tensor([toks]))[0]
    want = ref.forward(_cfg_dict(cfg), w, toks)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


def _recurrence(x, dt, Bm, Cm, A, D, dt_bias, S0):
    """Position by position, as the reference: (y [T, H, P], the state after each position)."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    S, ys, states = S0.clone(), [], []
    for t in range(x.shape[0]):
        d = torch.nn.functional.softplus(dt[t] + dt_bias)
        S = torch.exp(d * A)[:, None, None] * S + (d[:, None] * x[t])[:, :, None] * Bm[t].repeat_interleave(
            rep, 0)[:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", S, Cm[t].repeat_interleave(rep, 0)) + D[:, None] * x[t])
        states.append(S)
    return torch.stack(ys), states


@pytest.mark.parametrize("T,length,snap,fresh", [(40, 40, 23, False), (48, 37, 37, False), (16, 5, 1, True),
                                                 (33, 33, -1, True)])
def test_k8_plain_matches_the_recurrence(T, length, snap, fresh):
    H, P, G, N = 4, 8, 2, 16
    g = torch.Generator().manual_seed(T + length)
    xbc = torch.randn(T, H * P + 2 * G * N, generator=g)
    dt = torch.randn(T, H, generator=g)
    A = -torch.rand(H, generator=g) * 4 - 0.5
    D, dt_bias = torch.randn(H, generator=g), torch.randn(H, generator=g) - 2
    lanes = torch.randn(3, H, P, N, generator=g)
    before = lanes.clone()
    slot = torch.tensor([1])
    snap_out = torch.zeros(H, P, N)
    y = ssd.ssd_scan_plain(xbc, dt, A, D, dt_bias, lanes, slot, torch.tensor([length]), torch.tensor([snap]),
                           snap_out, heads=H, head_dim=P, groups=G, state_dim=N, fresh=fresh)
    x = xbc[:, :H * P].reshape(T, H, P)
    Bm = xbc[:, H * P:H * P + G * N].reshape(T, G, N)
    Cm = xbc[:, H * P + G * N:].reshape(T, G, N)
    S0 = torch.zeros(H, P, N) if fresh else before[1]
    want_y, states = _recurrence(x[:length], dt[:length], Bm[:length], Cm[:length], A, D, dt_bias, S0)

    def close(a, b):
        return float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))

    assert close(y[:length], want_y)
    assert close(lanes[1], states[-1])  # the pads after length leave the state as it was
    assert torch.equal(lanes[0], before[0]) and torch.equal(lanes[2], before[2])
    if snap > 0:
        assert close(snap_out, states[snap - 1])
    else:
        assert not snap_out.any()


def test_k9_plain_matches_one_step_of_the_recurrence():
    H, P, G, N, K, Bn = 4, 8, 2, 16, 4, 3
    C = H * P + 2 * G * N
    g = torch.Generator().manual_seed(5)
    xbc, dt = torch.randn(Bn, C, generator=g), torch.randn(Bn, H, generator=g)
    conv_w, conv_b = torch.randn(C, K, generator=g) * 0.5, torch.randn(C, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4 - 0.5
    D, dt_bias = torch.randn(H, generator=g), torch.randn(H, generator=g) - 2
    conv_state, state = torch.randn(Bn, K - 1, C, generator=g), torch.randn(Bn, H, P, N, generator=g)
    conv0, state0 = conv_state.clone(), state.clone()
    done = torch.tensor([False, True, False])
    y = ssd.ssd_step_plain(xbc, dt, conv_w, conv_b, A, D, dt_bias, conv_state, state, done, heads=H, head_dim=P,
                           groups=G, state_dim=N)
    for b in range(Bn):
        if done[b]:
            assert torch.equal(state[b], state0[b]) and torch.equal(conv_state[b], conv0[b]) and not y[b].any()
            continue
        win = torch.cat([conv0[b], xbc[b][None]])
        act = torch.nn.functional.silu(conv_b + (conv_w.T * win).sum(0))
        x = act[:H * P].reshape(1, H, P)
        want_y, states = _recurrence(x, dt[b][None], act[H * P:H * P + G * N].reshape(1, G, N),
                                     act[H * P + G * N:].reshape(1, G, N), A, D, dt_bias, state0[b])
        assert float((y[b] - want_y[0]).abs().max()) <= 1e-5 * float(want_y.abs().max())
        assert float((state[b] - states[0]).abs().max()) <= 1e-5 * float(states[0].abs().max())
        assert torch.equal(conv_state[b], win[1:])


def _serve(model, rows, **kw):
    sched = cont.ContinuousScheduler(model, cache_dtype=torch.float32, **kw)
    try:
        handles = []
        for wave in rows:
            hs = [sched.submit(ids, max_tokens=n) for ids, n in wave]
            for h in hs:
                assert h.event.wait(TIMEOUT) and h.error is None, h.error
            handles += hs
        return [h.tokens for h in handles], sched
    finally:
        sched.close()


@pytest.mark.parametrize("chunk", [0, 32])
def test_scheduler_prefill_then_decode_matches_the_reference(tiny, chunk):
    """Prompts of 70 and 45 tokens: with 32-token chunks the state crosses two and one chunk
    boundaries before the first token; then 6 decode steps over both slots."""
    cfg, model, w = tiny
    prompts = [_prompt(70, 11), _prompt(45, 12)]
    got, sched = _serve(model, [[(p, 6) for p in prompts]], n_slots=2, chunk_size=4, prompt_multiple=16,
                        prefill_chunk=chunk)
    for p, toks in zip(prompts, got):
        assert toks == ref.greedy(_cfg_dict(cfg), w, p, 6)
    assert sched.prefill_dispatches == (3 + 2 if chunk else 0)


@pytest.mark.parametrize("chunk", [0, 32])
def test_prefix_hit_equals_the_same_prompt_with_no_hit(tiny, chunk):
    """A second turn that starts with the first turn's prompt takes its harvested prefix (K/V
    and the snapshot of the SSM and conv states at P0) and prefills the rest alone: its tokens
    equal those of the same prompt served with the prefix cache off."""
    cfg, model, w = tiny
    first = _prompt(50, 21)
    second = first + _prompt(40, 22)
    kw = dict(n_slots=2, chunk_size=4, prompt_multiple=16, prefill_chunk=chunk)
    hit, sched = _serve(model, [[(first, 4)], [(second, 5)]], prefix_cache=4, **kw)
    miss, _ = _serve(model, [[(first, 4)], [(second, 5)]], **kw)
    assert hit == miss
    assert sched.prefix_hits == 1 and sched.prefix_tokens_reused == 48
    assert sched.prefix_state_hits == 1
    assert sched.state_snapshots == 2  # 48 of the first prompt, 80 of the second
    per = sum(t[:, 0].nbytes for t in sched.state[7:])
    assert sched.state_bytes_copied == 3 * per  # two snapshots and one restore


@pytest.mark.parametrize("chunk", [0, 32])
def test_paused_holds_the_worker_at_the_top_of_its_loop(tiny, chunk):
    """``paused()`` returns once the worker is at the top of its loop, idle or between
    iterations, and holds it there: inside the block no chunk is dispatched or collected and a
    row submitted meanwhile takes no slot; after it both rows are served as without a pause."""
    cfg, model, w = tiny
    first, second = _prompt(70, 31), _prompt(45, 32)
    sched = cont.ContinuousScheduler(model, cache_dtype=torch.float32, n_slots=2, chunk_size=2, prompt_multiple=16,
                                     prefill_chunk=chunk)
    try:
        with sched.paused():  # idle worker
            pass
        a = sched.submit(first, max_tokens=60)
        while not a.tokens and not a.event.is_set():
            time.sleep(0.005)
        with sched.paused():
            seen = (sched.dispatches, sched.prefill_dispatches, len(a.tokens))
            b = sched.submit(second, max_tokens=4)
            time.sleep(0.3)
            assert (sched.dispatches, sched.prefill_dispatches, len(a.tokens)) == seen
            assert b.slot is None and not b.event.is_set()
        for h in (a, b):
            assert h.event.wait(TIMEOUT) and h.error is None, h.error
    finally:
        sched.close()
    assert a.tokens == ref.greedy(_cfg_dict(cfg), w, first, 60)
    assert b.tokens == ref.greedy(_cfg_dict(cfg), w, second, 4)
