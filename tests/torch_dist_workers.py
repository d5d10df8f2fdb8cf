"""Worker processes for the port's multi-process CPU tests (context, data, tensor, fsdp and
pipeline parallelism over gloo). Imports torch, numpy and the port, never JAX: the tests compute their JAX
references in the parent process.

    python tests/torch_dist_workers.py JOB RANK

JOB is a pickle the test wrote (inputs, mesh, world size, a ``file://`` store path under the
test's temporary directory, so no port is fixed); each rank writes ``JOB.rank<R>`` with its
results. ``run_ranks`` starts the ranks, waits with a timeout of its own and kills them all
when one fails or the time runs out, so a deadlock fails the test instead of hanging it.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from llama_x_tpu_torch.models import llama
from llama_x_tpu_torch.models.convert import named_tensors, params_from_jax
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.ops.ring_attention import ring_attention
from llama_x_tpu_torch.parallel.mesh import all_reduce, init_distributed, make_mesh, use_mesh
from llama_x_tpu_torch.parallel.sharding import shard_batch
from llama_x_tpu_torch.parallel.ulysses import ulysses_attention
from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

ROOT = Path(__file__).resolve().parent.parent


def run_ranks(job: dict, tmp_path: Path, timeout: float = 120.0) -> list:
    """Run ``job`` in job["world"] worker processes; returns each rank's results."""
    path = Path(tmp_path) / f"job_{job['kind']}_{os.getpid()}.pkl"
    job = dict(job, store=str(Path(tmp_path) / f"store_{path.stem}"))
    path.write_bytes(pickle.dumps(job))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(path), str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(job["world"])]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{job['kind']}: the ranks did not finish within {timeout} s (deadlock?)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(f"{job['kind']}: rank {r} exited {rc}:\n{o[-3000:]}" for r, rc, o in bad))
    return [pickle.loads(Path(f"{path}.rank{r}").read_bytes()) for r in range(job["world"])]


# ---------------------------------------------------------------------------
# jobs (in the worker processes)
# ---------------------------------------------------------------------------


def _mask(case: dict, sl) -> MaskInfo:
    seg, prefix = case.get("seg"), case.get("prefix")
    return MaskInfo(causal=case["causal"], segment_ids=None if seg is None else torch.from_numpy(seg[:, sl]),
                    prefix_len=None if prefix is None else torch.from_numpy(prefix))


def attention_job(job: dict, mesh) -> list:
    """Ring attention (``impl`` "xla" or "flash") or Ulysses over each case: this rank's
    output and input gradients (a seeded cotangent) of its slice."""
    n, i = mesh.axis_size("cp"), mesh.index("cp")
    out = []
    for case in job["cases"]:
        S = case["q"].shape[1]
        sl = slice(i * (S // n), (i + 1) * (S // n))
        q, k, v = (torch.from_numpy(np.ascontiguousarray(case[x][:, sl])).requires_grad_(True) for x in "qkv")
        mi = _mask(case, sl)
        if case["attn"] == "ring":
            o = ring_attention(q, k, v, mesh, mi, impl=case["impl"])
        else:
            o = ulysses_attention(q, k, v, mesh, mi)
        o.backward(torch.from_numpy(np.ascontiguousarray(case["do"][:, sl])))
        out.append({"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(), "dv": v.grad.numpy()})
    return out


def model_job(job: dict, mesh) -> dict:
    """The loss and the trainable gradients of the port's model at cp n, for each
    ``attn_impl``: the loss summed over the ranks' shares, the gradients over the ranks."""
    res = {}
    tokens = torch.from_numpy(job["tokens"]).long()
    labels = torch.from_numpy(job["labels"])
    seg = None if job["seg"] is None else torch.from_numpy(job["seg"])
    for impl in job["impls"]:
        cfg = llama.tiny_config(**job["config"]).replace(attn_impl=impl)
        model = params_from_jax(job["params"], cfg, device="cpu", freeze_prefixes=job["freeze"])
        with use_mesh(mesh):
            loss = llama.forward(model, tokens, labels=labels, segment_ids=seg)
            loss.backward()
        grads = {k: all_reduce(mesh, torch.from_numpy(g)).numpy() for k, g in named_tensors(model, grads=True).items()}
        res[impl] = (float(all_reduce(mesh, loss.detach())), grads)
    return res


class Recorder:
    """A plain SGD step that keeps the gradients it was handed (what a train step hands its
    optimizer after the all-reduce)."""

    def __init__(self, params, lr: float = 1e-2):
        self.params, self.lr, self.grads = list(params), lr, None

    def step(self, grads, norm=None) -> None:
        self.grads = [g.clone() for g in grads]
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p -= self.lr * g.to(p.dtype)


def step_job(job: dict, mesh) -> dict:
    """One train step of the port's trainer over the mesh: each rank takes its dp block of
    the step batch (the model its cp slice of the sequence); the loss, the grad norm and the
    gradients handed to the optimizer."""
    cfg = llama.tiny_config(**job["config"]).replace(attn_impl=job["impl"])
    model = params_from_jax(job["params"], cfg, device="cpu", freeze_prefixes=job["freeze"])
    opt = Recorder([p for p in model.parameters() if p.requires_grad])
    state = TrainState(model, opt)

    def loss_fn(m, mb):
        loss = llama.forward(m, mb["inputs"].long(), segment_ids=mb["segment_ids"], labels=mb["labels"])
        return loss, (mb["labels"] != -100).sum()

    step = make_train_step(loss_fn, mesh=mesh, eager=True)
    with use_mesh(mesh):
        metrics = step(state, shard_batch(job["batch"], mesh))
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "n_tokens": int(metrics["n_tokens"]), "grads": [g.numpy() for g in opt.grads]}


def _port_model(job: dict, case: dict):
    cfg = llama.tiny_config(**case["config"])
    return params_from_jax(case.get("params", job.get("params")), cfg, device="cpu",
                           freeze_prefixes=case.get("freeze", job.get("freeze", ())))


def sharded_step_job(job: dict, mesh) -> list:
    """For each case: the port's model placed on the mesh by ``shard_params``, one train step
    of ``make_train_step`` over its batch (each rank its rows), with AdamW (``optim``) or a
    gradient recorder; the loss, the grad norm, the gradients handed to the optimizer (whole)
    and every tensor after the update (whole), as the unsharded model names them."""
    from llama_x_tpu_torch.parallel.sharding import full_state_dict, shard_params
    from llama_x_tpu_torch.parallel.mesh import AXES
    from llama_x_tpu_torch.parallel.tensor import gather_now
    from llama_x_tpu_torch.train.optim import AdamW

    out = []
    for case in job["cases"]:
        twin = _port_model(job, case)
        model = shard_params(_port_model(job, case), mesh)
        params = [p for p in model.parameters() if p.requires_grad]
        opt = case.get("optim")
        if opt is None:
            optimizer = Recorder(params)
        else:
            optimizer = AdamW(params, opt["lr"], weight_decay=opt.get("wd", 0.0), clip_grad_norm=opt.get("clip"),
                              state_bits=opt.get("bits"), mesh=mesh)
        state = TrainState(model, optimizer)

        def loss_fn(m, mb):
            loss = llama.forward(m, mb["inputs"].long(), segment_ids=mb.get("segment_ids"), labels=mb["labels"])
            return loss, (mb["labels"] != -100).sum()

        step = make_train_step(loss_fn, mesh=mesh, eager=True)
        metrics = [step(state, shard_batch(case["batch"], mesh)) for _ in range(case.get("steps", 1))]
        full = full_state_dict(model)
        twin.load_state_dict(full)
        res = {"loss": [float(m["loss"]) for m in metrics], "grad_norm": [float(m["grad_norm"]) for m in metrics],
               "after": named_tensors(twin)}
        if opt is None:
            names = [n for n, p in model.named_parameters() if p.requires_grad]
            res["grads"] = {n: gather_now(g, mesh, AXES, like=p).numpy() for n, g, p in zip(names, optimizer.grads, params)}
        else:
            res["opt_state"] = optimizer.state_dict()
        out.append(res)
    return out


def pipeline_job(job: dict, mesh) -> list:
    """pipeline_loss cases over the mesh's pp axis (with dp when the mesh has it): each
    rank its batch rows; the loss, and with ``grads`` the gradients of every parameter (a
    stage's own, summed over pp and dp as a train step sums them) and of the prefix."""
    from llama_x_tpu_torch.parallel.pipeline import pipeline_loss
    from llama_x_tpu_torch.parallel.sharding import shard_params
    from llama_x_tpu_torch.train.trainer import reduce_gradients

    out = []
    for case in job["cases"]:
        model = shard_params(_port_model(job, case), mesh)
        batch = shard_batch({k: v[None] for k, v in case["batch"].items()}, mesh)
        mb = {k: torch.from_numpy(np.ascontiguousarray(v[0])) for k, v in batch.items()}
        prefix = None
        if "prefix" in mb:
            prefix = mb["prefix"].clone().requires_grad_(True)
        loss = pipeline_loss(model, mb["tokens"].long(), mb["labels"], mesh, case["micro"],
                             segment_ids=mb.get("seg"), prefix_embeds=prefix, prefix_lm=case.get("prefix_lm", False))
        res = {"loss": float(loss)}
        if case.get("grads"):
            named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
            inputs = [p for _, p in named] + ([prefix] if prefix is not None else [])
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
            pg = [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]
            pg = reduce_gradients(mesh, [p for _, p in named], pg)
            parts = [None] * mesh.axis_size("pp")
            dist.all_gather_object(parts, {n: g.numpy() for (n, _), g in zip(named, pg)}, group=mesh.group("pp"))
            res["grads"] = {k: v for part in parts for k, v in part.items()}
            if prefix is not None:
                g = torch.zeros_like(prefix) if grads[-1] is None else grads[-1].detach()
                res["prefix_grad"] = all_reduce(mesh, g, "dp+pp").numpy()
        out.append(res)
    return out


def units_job(job: dict, mesh) -> dict:
    """Small checks of the tp collectives at a tp axis: the row-parallel quantizer's codes on
    this rank's columns, and the vocabulary-parallel cross-entropy (plain and fused, a
    vocabulary that does not divide) with the gradients of its inputs, gathered whole."""
    from llama_x_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy, vocab_parallel_cross_entropy
    from llama_x_tpu_torch.parallel.mesh import all_gather, shard_bounds
    from llama_x_tpu_torch.ops.int8 import quantize_int8_rowwise
    from llama_x_tpu_torch.parallel.tensor import copy_to_tp

    n, i = mesh.axis_size("tp"), mesh.index("tp")
    x = torch.from_numpy(job["x"])
    lo, hi = shard_bounds(x.shape[1], n, i)
    q, scale = quantize_int8_rowwise(x[:, lo:hi].contiguous(), mesh)
    out = {"codes": all_gather(mesh, q, "tp", 1, total=x.shape[1]).numpy(), "scale": scale.numpy()}
    h, w, lab = (torch.from_numpy(job[k]) for k in ("h", "w", "labels"))
    V = w.shape[0]
    lo, hi = shard_bounds(V, n, i)
    for kind in ("plain", "fused"):
        hg = h.clone().requires_grad_(True)
        wl = w[lo:hi].clone().requires_grad_(True)
        if kind == "plain":
            loss = vocab_parallel_cross_entropy(copy_to_tp(hg, mesh) @ wl.T, lab, mesh, V)
        else:
            wl.shard_spec, wl.full_shape = ("tp", None), tuple(w.shape)
            loss = fused_linear_cross_entropy(hg, wl, lab, 4, kernel_grad=True, mesh=mesh, vocab=V)
        gh, gw = torch.autograd.grad(loss, [hg, wl])
        out[kind] = (float(loss), gh.numpy(), all_gather(mesh, gw, "tp", 0, total=V).numpy())
    return out


def collectives_job(job: dict, mesh) -> dict:
    """The slice-5b collectives over each axis of job["axes"]: ``all_gather`` of this rank's
    uneven columns of job["x"], ``reduce_scatter`` of rank-scaled rows through the
    all-reduce and cut and through the backend's own reduce-scatter, ``all_reduce`` with
    max; each with the bytes ``Mesh.comm`` counted for it."""
    from llama_x_tpu_torch.parallel import mesh as pm

    x = torch.from_numpy(job["x"])
    mine = x * (mesh.rank + 1)
    out = {}
    for axis in job["axes"]:
        n, i = mesh.axis_size(axis), mesh.index(axis)
        lo, hi = pm.shard_bounds(x.shape[1], n, i)

        def counted(fn):
            before = mesh.comm.bytes
            return fn().numpy(), mesh.comm.bytes - before

        out[axis, "gather"] = counted(lambda: pm.all_gather(mesh, x[:, lo:hi].contiguous(), axis, 1,
                                                            total=x.shape[1]))
        for native in (False, True):
            pm.NATIVE_REDUCE_SCATTER = (mesh.backend,) if native else ()
            out[axis, "scatter", native] = counted(lambda: pm.reduce_scatter(mesh, mine, axis, 0))
        out[axis, "max"] = counted(lambda: pm.all_reduce(mesh, mine, axis, op="max"))
    return out


def checkpoint_job(job: dict, mesh) -> float:
    """A checkpoint of one process restored into a model sharded on the mesh, one AdamW8bit
    step there, and a checkpoint of that (rank 0 writes it): the step's loss."""
    from llama_x_tpu_torch.parallel.sharding import shard_params
    from llama_x_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from llama_x_tpu_torch.train.optim import get_optimizer

    model = shard_params(_port_model(job, job), mesh)
    state = TrainState(model, get_optimizer("AdamW8bit", [p for p in model.parameters() if p.requires_grad], 1e-2,
                                            mesh=mesh))
    restore_checkpoint(job["load"], state)

    def loss_fn(m, mb):
        return llama.forward(m, mb["inputs"].long(), labels=mb["labels"]), (mb["labels"] != -100).sum()

    loss = float(make_train_step(loss_fn, mesh=mesh, eager=True)(state, shard_batch(job["batch"], mesh))["loss"])
    save_checkpoint(job["save"] if mesh.rank == 0 else None, state, state.step)
    return loss


def hf_job(job: dict, mesh) -> dict:
    """``load_llama(mesh=)`` of an HF directory, float and int8 on load: every tensor whole."""
    from llama_x_tpu_torch.models.hf import load_llama
    from llama_x_tpu_torch.parallel.sharding import full_state_dict

    out = {}
    for quantize in (None, "int8"):
        model = load_llama(job["path"], dtype=torch.float32, device="cpu", quantize=quantize, mesh=mesh)
        out[quantize] = {k: v.numpy() for k, v in full_state_dict(model).items()}
        out[f"{quantize}_local"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return out


def pp_step_job(job: dict, mesh) -> list:
    """The train step over the mesh with the GPipe loss (``reduce_batch=False``, as the
    trainers' pp branches give it), AdamW: per step the loss and the label count, and every
    tensor after the steps (whole, every stage's), as the JAX tree names them. An ``audio``
    batch runs the audio stem outside the pipeline, its tokens the prefix."""
    from llama_x_tpu_torch.models.audio import audio_embed
    from llama_x_tpu_torch.parallel.pipeline import pipeline_loss
    from llama_x_tpu_torch.parallel.sharding import full_state_dict, shard_params
    from llama_x_tpu_torch.train.optim import AdamW

    out = []
    for case in job["cases"]:
        model = shard_params(_port_model(job, case), mesh)
        state = TrainState(model, AdamW([p for p in model.parameters() if p.requires_grad], case["lr"],
                                        weight_decay=case.get("wd", 0.0), mesh=mesh))

        def loss_fn(m, mb, case=case):
            prefix = None
            if "audio" in mb:
                prefix = audio_embed(m.audio_embed, m.audio_config, mb["audio"], dtype=m.tok_embeddings.dtype)
            loss = pipeline_loss(m, mb["tokens"].long(), mb["labels"], mesh, case["micro"], prefix_embeds=prefix,
                                 prefix_lm=case.get("prefix_lm", False), reduce_batch=False)
            return loss, (mb["labels"] != -100).sum()

        step = make_train_step(loss_fn, mesh=mesh, eager=True)
        batch = shard_batch(case["batch"], mesh)
        metrics = [step(state, batch) for _ in range(case["steps"])]
        twin = _port_model(job, case)
        twin.load_state_dict(full_state_dict(model))
        out.append({"loss": [float(m["loss"]) for m in metrics], "n_tokens": [int(m["n_tokens"]) for m in metrics],
                    "after": named_tensors(twin)})
    return out


def serve_job(job: dict, mesh) -> dict:
    """Serving on a model sharded over the mesh's tp axis (replicated over dp): ``generate``
    with an int8 cache, greedy speculative decoding (target and draft sharded), and the
    continuous scheduler's admission / chunked prefill / decode cycle. Tokens of each."""
    from llama_x_tpu_torch.models.generate import generate
    from llama_x_tpu_torch.models.speculative import generate_speculative
    from llama_x_tpu_torch.parallel.sharding import shard_params
    from llama_x_tpu_torch.serve import continuous as cont

    model = shard_params(_port_model(job, job), mesh)
    prompt = torch.from_numpy(job["prompt"]).long()
    # a model on a mesh decodes eagerly: its collectives cannot be captured in a CUDA graph
    out = {"generate": generate(model, prompt, max_new_tokens=8, cache_dtype=torch.int8, eager=True).numpy()}
    draft = shard_params(_port_model(job, dict(job, params=job["draft_params"], config=job["draft_config"])), mesh)
    out["speculative"] = generate_speculative(model, draft, prompt, max_new_tokens=8, gamma=3,
                                              cache_dtype=torch.float32, eager=True)[0].numpy()
    cfg, heads = model.config, llama.local_kv_heads(model)
    n_slots, greedy = 4, (0.0, 0, 1.0, 0.0)
    state = cont.init_state(cfg, n_slots, torch.float32, "cpu", kv_heads=heads)
    # a model on a mesh admits eagerly too
    inputs = cont.AdmitBuffers(model, state[0])
    f0, state = cont.admit_row(model, state, inputs, 0, prompt[0].tolist(), greedy, -1, eager=True)
    for start in (0, 8):  # chunked prefill of row 1: 8 + 8
        cont.prefill_chunk(model, inputs, prompt[1, start:start + 8].tolist(), start, 8, eager=True)
    f1, state = cont.install_row(model, state, 1, inputs, 16, greedy, -1, eager=True)
    zs = torch.zeros(n_slots)
    toks, _ = cont.decode_rows(model, state, 7, None, zs, torch.zeros(n_slots, dtype=torch.int64), torch.ones(n_slots),
                               zs, torch.full((n_slots,), -1), torch.full((n_slots,), 8), eager=True)
    out["continuous"] = torch.cat([torch.stack([f0, f1])[:, None], toks[:2]], dim=1).numpy()
    return out


JOBS = {"attention": attention_job, "model": model_job, "step": step_job, "sharded_step": sharded_step_job,
        "pipeline": pipeline_job, "units": units_job, "checkpoint": checkpoint_job, "hf": hf_job,
        "pp_step": pp_step_job, "serve": serve_job, "collectives": collectives_job}


def main(path: str, rank: int) -> None:
    torch.set_num_threads(1)
    job = pickle.loads(Path(path).read_bytes())
    init_distributed("gloo", "cpu", init_method=f"file://{job['store']}", rank=rank, world_size=job["world"])
    try:
        mesh = make_mesh(**job["mesh"])
        result = JOBS[job["kind"]](job, mesh)
        Path(f"{path}.rank{rank}").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
