"""Worker processes for the port's multi-process CPU tests (context and data parallelism
over gloo). Imports torch, numpy and the port, never JAX: the tests compute their JAX
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
        r, rc, o = bad[0]
        raise AssertionError(f"{job['kind']}: rank {r} exited {rc}:\n{o[-4000:]}")
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

    def step(self, grads) -> None:
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

    step = make_train_step(loss_fn, mesh=mesh)
    with use_mesh(mesh):
        metrics = step(state, shard_batch(job["batch"], mesh))
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "n_tokens": int(metrics["n_tokens"]), "grads": [g.numpy() for g in opt.grads]}


JOBS = {"attention": attention_job, "model": model_job, "step": step_job}


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
