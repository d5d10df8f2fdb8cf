"""Traffic kind ``offline_batch``: batches of ragged prompts decoded to a fixed length
through the program's ``generate_stream``, one batch after another, as an offline job
(evaluations, synthetic data) sends them. No scheduler: a change to the continuous
scheduler shows in the chat cells and not here.

The mix's parameters (a ``benchmark/traffic/<mix>.json`` of this kind): ``batch`` rows,
prompt lengths uniform over the quantiles of [``prompt_min``, ``prompt_max``] right-padded
to ``prompt_pad``, ``new_tokens`` each, greedy with no stop token, ``chunk_size`` decode
steps a delivery. Every batch holds the same set of lengths in an order drawn from the
seed; token ids are uniform over the vocabulary. Batch ``i`` of seed ``s`` depends on
(s, i) alone.
"""

from __future__ import annotations

import time

import numpy as np


def batch(mix: dict, cfg: dict, seed: int, i: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids [B, prompt_pad] right-padded with 0, lengths [B]) of batch ``i``."""
    rng = np.random.default_rng([int(seed) % (2**63), i])
    B = mix["batch"]
    lens = np.linspace(mix["prompt_min"], mix["prompt_max"], B).round().astype(np.int64)
    lens = rng.permutation(lens)
    ids = np.zeros((B, mix["prompt_pad"]), np.int64)
    for r, n in enumerate(lens):
        ids[r, :n] = rng.integers(0, cfg["vocab_size"], n)
    return ids, lens


def generate(mix: dict, cfg: dict, seed: int, n: int) -> list[tuple[np.ndarray, np.ndarray]]:
    return [batch(mix, cfg, seed, i) for i in range(n)]


def run(ctx) -> dict:
    import torch

    from benchmark import port, weights
    from benchmark.traffic.chat_sessions import judge
    from benchmark.trace import Window, span
    from llama_x_tpu_torch.models.generate import generate_stream

    cfg, mix = ctx.cfg, ctx.mix
    dev = ctx.device

    def serve(i):
        ids, lens = batch(mix, cfg, ctx.seed, i)
        prompt = torch.from_numpy(ids).to(dev)
        out = []
        with span("bench.submit"):
            for block in generate_stream(model, prompt, max_new_tokens=mix["new_tokens"], chunk_size=mix["chunk_size"],
                                         cache_dtype=torch.int8, prompt_lens=torch.from_numpy(lens).to(dev)):
                with span("bench.collect"):
                    out.append(block.cpu())
        return ids, lens, torch.cat(out, dim=1).tolist()

    with span("bench.warmup"):
        model = port.build(cfg, weights.draw(cfg, ctx.seed, dev), dict(dynamic_int8_act=True))
        serve(2**32)
        ctx.sync()
    ctx.setup_done()
    ctx.reset_peak()
    done, tokens, i, traced = [], 0, 0, None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        with Window(enabled=ctx.trace and traced is None and time.perf_counter() - t0 >= ctx.seconds / 2) as w:
            ids, lens, toks = serve(i)
        if w.enabled:
            traced = dict(summary=w.summary)
        tokens += sum(len(t) for t in toks)
        done += [({"prompt": ids[r, :lens[r]].tolist()}, toks[r]) for r in range(len(toks))]
        i += 1
    window = time.perf_counter() - t0
    ctx.program_done()
    del model
    ctx.free()
    with span("bench.reference"):
        checks, extra = judge(ctx, done)
    obs = dict(cfg=cfg, window_s=window, batches=i, trace=traced)
    return dict(e2e=dict(serve_tokens_per_s=tokens / window), obs=obs, checks=checks, attempted=len(done), failed=0,
                extra=extra)
