"""Traffic kind ``packed_sft``: supervised fine-tuning steps over packed documents, the
QLoRA training step of the program timed step after step.

The mix's parameters (a ``benchmark/traffic/<mix>.json`` of this kind): ``seq_len``,
``microbatch_rows`` (rows a microbatch), ``accumulation``, document lengths lognormal
(``doc_median``, ``doc_sigma``) clipped to [``doc_min``, ``doc_max``], and
``label_share``, the share of each document under the loss (its response half).

Every step packs documents into full rows of ``seq_len`` (the last document of a row is
cut to fit), each with its own segment id; labels are the next token within the
document on its response part, -100 elsewhere. Lengths come from a fixed set of
quantiles of the distribution, in an order drawn from the seed, so every seed asks the
same mix of work; token ids are uniform over the vocabulary. Step ``i`` of seed ``s``
depends on (s, i) alone.

The cell: set-up draws the weights and the adapter (``benchmark/weights.py``), builds
the program's model (``benchmark/port.py``), its optimizer (the program's AdamW, fp32
moments) and ONE train step (``train/trainer.py:make_train_step``), and drives that
step through its first three steps on the seed's batches 0-2 (the first runs eagerly and
captures its graphs, the second and third replay them); the window then calls the same
step on batches 3, 4, ... The reference follows the first three steps
(``benchmark/reference/model.py``).

``FAULTS`` are faults planted under the timed path on the card (``benchmark.run
--fault``), to read the numbers compared on a broken program.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

QUANTILES = 64
FIRST_STEPS = 3


def _replay_half():
    """The step graph's replay given microbatch 0 in place of each of its microbatches, so
    every replayed step takes its mean over half of its batch; the eager first step is left
    sound. Returns the undo."""
    from llama_x_tpu_torch.train import step_graph

    real = step_graph.Runner.replay

    def replay(self, state, name, entry, batch, accum, micro, update):
        if entry.micro is not None:
            batch = {k: v[:1].expand(accum, *v.shape[1:]) for k, v in batch.items()}
        return real(self, state, name, entry, batch, accum, micro, update)

    step_graph.Runner.replay = replay
    return lambda: setattr(step_graph.Runner, "replay", real)


FAULTS = {"replay_half": _replay_half}


def doc_lengths(mix: dict) -> list[int]:
    """The fixed set of document lengths: ``QUANTILES`` quantiles of the lognormal."""
    dist = statistics.NormalDist(np.log(mix["doc_median"]), mix["doc_sigma"])
    out = []
    for i in range(QUANTILES):
        n = int(round(np.exp(dist.inv_cdf((i + 0.5) / QUANTILES))))
        out.append(min(max(n, mix["doc_min"]), mix["doc_max"]))
    return out


def pack_row(rng: np.random.Generator, lengths: list[int], seq_len: int) -> list[int]:
    """Document lengths that fill one row exactly, drawn in a seeded order from ``lengths``."""
    docs, fill = [], 0
    while fill < seq_len:
        for n in rng.permutation(lengths):
            n = min(int(n), seq_len - fill)
            if n < 2:  # a one-position remainder joins the document before it
                docs[-1] += n
            else:
                docs.append(n)
            fill += n
            if fill == seq_len:
                break
    return docs


def step_batch(mix: dict, vocab: int, seed: int, step: int) -> dict:
    """Step ``step``'s batch: numpy ``inputs`` / ``labels`` / ``segment_ids`` [accum, rows,
    seq_len] and ``docs`` (each row's document lengths, in microbatch order)."""
    rng = np.random.default_rng([int(seed) % (2**63), step])
    S, A, R = mix["seq_len"], mix["accumulation"], mix["microbatch_rows"]
    lengths = doc_lengths(mix)
    inputs = np.zeros((A, R, S), np.int32)
    labels = np.full((A, R, S), -100, np.int32)
    seg = np.zeros((A, R, S), np.int32)
    docs = []
    for a in range(A):
        for r in range(R):
            row_docs = pack_row(rng, lengths, S)
            docs.append(row_docs)
            start = 0
            for d, n in enumerate(row_docs, start=1):
                toks = rng.integers(0, vocab, n + 1)
                inputs[a, r, start:start + n] = toks[:n]
                seg[a, r, start:start + n] = d
                cut = n - int(round(n * mix["label_share"]))
                labels[a, r, start + cut:start + n] = toks[cut + 1:n + 1]
                start += n
    return {"inputs": inputs, "labels": labels, "segment_ids": seg, "docs": docs}


def generate(mix: dict, cfg: dict, seed: int, n: int) -> list[dict]:
    """The first ``n`` step batches of ``seed``."""
    return [step_batch(mix, cfg["vocab_size"], seed, i) for i in range(n)]


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------


def _leaf(name: str) -> str:
    """The program's parameter name (layers.3.attention.wq.lora_a) as the reference's leaf
    (3.wq.lora_a)."""
    parts = name.split(".")
    return f"{parts[1]}.{parts[-2]}.{parts[-1]}"


def run(ctx) -> dict:
    import torch

    from benchmark import port, weights
    from benchmark.trace import Window, span
    from llama_x_tpu_torch.train.optim import AdamW
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step
    from llama_x_tpu_torch.train_metamathqa import loss_fn

    cfg, mix, eng = ctx.cfg, ctx.mix, ctx.workload["engine"]
    dev = ctx.device
    with span("bench.warmup"):
        tensors = weights.draw(cfg, ctx.seed, dev, lora_rank=eng["lora_rank"])
        settings = dict(activation_checkpointing=True, remat_policy=eng["remat_policy"],
                        fused_ce_chunks=eng["fused_ce_chunks"], dynamic_int8_act=True, dynamic_int8_bwd=True,
                        int8_head=True)
        model = port.build(cfg, tensors, settings, lora_scale=eng["lora_alpha"] / eng["lora_rank"])
        opt = AdamW([p for p in model.parameters() if p.requires_grad], eng["lr"])
        state = TrainState(model, opt)
        train_step = make_train_step(loss_fn)
        names = [_leaf(n) for n, _ in state.trainable]

        def feed(i):
            b = step_batch(mix, cfg["vocab_size"], ctx.seed, i)
            return b, {k: torch.from_numpy(b[k]).to(dev) for k in ("inputs", "labels", "segment_ids")}

        snap = {"p0": {n: p.detach().clone() for n, (_, p) in zip(names, state.trainable)}, "losses": []}
        for i in range(FIRST_STEPS):
            metrics = train_step(state, feed(i)[1])
            snap["losses"].append(metrics["loss"])
            if i < 2:  # after the eager step and after the first replayed one
                snap[f"mu{i + 1}"] = {n: m.clone() for n, m in zip(names, opt.mu)}
        snap["p3"] = {n: p.detach().clone() for n, (_, p) in zip(names, state.trainable)}
        ctx.sync()
    ctx.setup_done()

    # the window: steps 3, 4, ... until the seconds are spent, two steps in flight at most
    ctx.reset_peak()
    trace_at = ctx.seconds / 2 if ctx.trace else None
    steps, tokens, traced = [], 0, None
    pending = []
    i = FIRST_STEPS
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        b, batch = feed(i)
        if trace_at is not None and traced is None and time.perf_counter() - t0 >= trace_at:
            ctx.sync()
            tt = time.perf_counter()
            with Window() as w:
                with span("bench.train_step"):
                    train_step(state, batch)
            traced = dict(summary=w.summary, docs=b["docs"], wall=time.perf_counter() - tt,
                          labels=int((b["labels"] != -100).sum()))
        else:
            with span("bench.train_step"):
                train_step(state, batch)
        pending.append(ctx.event())
        if len(pending) > 2:
            pending.pop(0).synchronize()
        steps.append(b["docs"])
        tokens += int((b["segment_ids"] != 0).sum())
        i += 1
    ctx.sync()
    window = time.perf_counter() - t0
    peak_window = ctx.peak()
    obs = dict(steps=len(steps), window_s=window, tokens=tokens, peak_window_bytes=peak_window, trace=traced,
               cfg=cfg, mix=mix, engine=eng)
    if traced is not None:
        obs["step_s"] = (window - traced["wall"]) / max(len(steps) - 1, 1)
    ctx.program_done()
    losses = [float(x) for x in snap["losses"]]
    b1 = opt.b1
    # the gradients as AdamW got them: mu_t = b1 * mu_(t-1) + (1 - b1) * g_t, from mu_0 = 0
    prog = dict(losses=losses, g1={n: m / (1 - b1) for n, m in snap["mu1"].items()},
                g2={n: (m - b1 * snap["mu1"][n]) / (1 - b1) for n, m in snap["mu2"].items()},
                p0=snap["p0"], p3=snap["p3"])
    del state, opt, model, tensors, train_step
    ctx.free()

    with span("bench.reference"):
        checks, extra = judge(ctx, prog, [step_batch(mix, cfg["vocab_size"], ctx.seed, i) for i in range(FIRST_STEPS)])
    e2e = dict(train_tokens_per_s=tokens / window)
    return dict(e2e=e2e, obs=obs, checks=checks, attempted=len(steps), failed=0, extra=extra)


def _norms(d: dict) -> dict:
    return {n: float(t.float().norm()) for n, t in d.items()}


def _worst(prog: dict, ref: dict, names) -> float:
    """The largest gap between the two sides' norms of a leaf, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the widest relative gap of the first three steps' losses, of
    the leaf norms of the first gradient (the eager step's) and of the second (the first
    replayed step's), and of the leaf norms of the change after three steps (leaves whose
    reference gradient is under a thousandth of the median leaf's left out: they move by
    round-off alone)."""
    g_p, g_r = _norms(prog["g1"]), _norms(ref["g1"])
    med = statistics.median(g_r.values())
    out = dict(loss_gap=max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
               grad_gap=_worst(g_p, g_r, list(g_r)))
    if "g2" in prog:
        out["grad2_gap"] = _worst(_norms(prog["g2"]), _norms(ref["g2"]), list(g_r))
    if "p3" in prog:
        moved = [n for n in g_r if g_r[n] >= 1e-3 * med]
        d_p = _norms({n: prog["p3"][n].float() - prog["p0"][n].float() for n in moved})
        d_r = _norms({n: ref["p3"][n].float() - ref["p0"][n].float() for n in moved})
        out["change_gap"] = _worst(d_p, d_r, moved)
    return out


def judge(ctx, prog: dict, batches: list[dict]) -> tuple[list, dict]:
    """The program's first three steps against the reference's from the same inputs; with
    ``ctx.control`` also the control's readings (the reference at 4 bits in the program's
    place) and the half-batch fault's: in the first step (its loss and gradient over one of
    its two microbatches, the mean taken over it alone), and in the second step alone (the
    first replayed one on the card)."""
    import torch

    from benchmark import weights
    from benchmark.reference import model as ref

    ref.no_tf32()
    eng = ctx.workload["engine"]
    micro = [[(torch.from_numpy(b["inputs"][a, 0]).to(ctx.device), torch.from_numpy(b["labels"][a, 0]).to(ctx.device),
               b["docs"][a]) for a in range(b["inputs"].shape[0])] for b in batches]
    scale = eng["lora_alpha"] / eng["lora_rank"]
    first_micro = {}

    def reference(bits: int, keep_micro: bool = False) -> dict:
        t = weights.draw(ctx.cfg, ctx.seed, ctx.device, lora_rank=eng["lora_rank"])
        names = ref.leaf_names(ctx.cfg)
        p0 = {n: ref.adapter(t, n).clone() for n in names}

        def on_step(i, per):
            if keep_micro and i <= 2:
                first_micro[i] = per[0]

        b = dict(act=bits, grad=bits, head=bits, lora_scale=scale)
        losses, g = ref.train_steps(ctx.cfg, t, micro, b, eng["lr"], on_step=on_step)
        return dict(losses=losses, g1=g[0], g2=g[1], p0=p0, p3={n: ref.adapter(t, n).clone() for n in names})

    t0 = time.perf_counter()
    r = reference(8, keep_micro=ctx.control)
    ctx.log(f"reference: {len(micro)} steps in {time.perf_counter() - t0:.1f} s")
    readings = gaps(prog, r)
    extra = {}
    if ctx.control:
        extra["control"] = gaps(reference(4), r)
        (l1, h1), (l2, h2) = first_micro[1], first_micro[2]
        extra["half_batch"] = gaps(dict(losses=[l1], g1=h1), dict(losses=r["losses"][:1], g1=r["g1"]))
        extra["half_batch_step2"] = gaps(dict(losses=[l2], g1=r["g1"], g2=h2),
                                         dict(losses=r["losses"][1:2], g1=r["g1"], g2=r["g2"]))
    return [(k, v, ctx.limits[k]) for k, v in readings.items()], extra
