"""Two-process multi-host dry run (port of tools/dryrun_multihost.py): two processes join one
``torch.distributed`` group through ``env://`` (MASTER_ADDR / MASTER_PORT on this host,
gloo), build a dp mesh over both, each feeds only its own rows of the global batch, and the
losses of the steps are checked against a single-process run of the same steps over the
whole batch. A real multi-host launch takes the same path with one process per host
(``torch.distributed.run --nnodes``), over nccl between cards.

    python -m llama_x_tpu_torch.dryrun_multihost                 # on the card: 2 workers + the reference
    python -m llama_x_tpu_torch.dryrun_multihost --device cpu    # the same on the CPU
    python -m llama_x_tpu_torch.dryrun_multihost --worker OUT    # one process of the pair (reads env://)

On the card both workers share it (gloo stages their exchanges through host memory) and the
model is bf16 (the flash kernels take bf16 and heads of 64 or 128); on the CPU it is fp32, as
the JAX tool's. Prints ``dryrun_multihost OK`` and exits 0 when the losses agree: within 1e-5
in fp32, within 1e-3 of |loss| in bf16 (the tolerance of one step at another batch split).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

N_PROC, N_STEPS, ROWS_PER_PROC = 2, 2, 2


def _losses(mesh, device) -> list[float]:
    """A tiny model trained N_STEPS with AdamW over ``mesh`` on ``device``; this process feeds
    only its rows of the global batch. Returns the per-step losses."""
    import numpy as np
    import torch

    from llama_x_tpu_torch.adapters.lora import set_trainable
    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.parallel.sharding import shard_batch
    from llama_x_tpu_torch.train.optim import get_optimizer
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step, trainable_parameters

    config = llama.tiny_config(max_seq_len=64, head_dim=64)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = llama.init(config, seed=0, dtype=dtype, device=device)
    set_trainable(model)  # every tensor trains (the JAX trainable_mask of a plain model)
    state = TrainState(model, get_optimizer("AdamW", trainable_parameters(model), 1e-3, mesh=mesh))

    def loss_fn(m, mb):
        return llama.forward(m, mb["tokens"].long(), labels=mb["labels"]), (mb["labels"] != -100).sum()

    step = make_train_step(loss_fn, mesh=mesh, eager=True)  # two processes over gloo: step_graph.eager_reason
    rng = np.random.default_rng(7)
    gtok = rng.integers(0, config.vocab_size, (1, N_PROC * ROWS_PER_PROC, 32)).astype(np.int32)
    glab = np.roll(gtok, -1, axis=-1).astype(np.int32)
    glab[..., -1] = -100
    batch = shard_batch({"tokens": gtok, "labels": glab}, mesh)  # this host's rows only
    return [float(step(state, batch)["loss"]) for _ in range(N_STEPS)]


def worker(out_path: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    from llama_x_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    dev = init_distributed("gloo", device)  # rank, world size and the rendezvous from env://
    try:
        assert dist.get_world_size() == N_PROC
        mesh = make_mesh(dp=N_PROC)
        losses = _losses(mesh, dev)
        if mesh.rank == 0:
            Path(out_path).write_text(json.dumps(losses))
        print(f"worker {mesh.rank} OK: losses={losses}", flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--worker", metavar="OUT", default=None, help="run one process of the pair (reads env://)")
    args = p.parse_args(argv)
    from llama_x_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.worker is not None:
        worker(args.worker, dev.type)
        return 0
    root = str(Path(__file__).resolve().parent.parent)
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "losses.json")
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(N_PROC),
                   LOCAL_WORLD_SIZE=str(N_PROC), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
        procs = [subprocess.Popen([sys.executable, "-m", "llama_x_tpu_torch.dryrun_multihost", "--device", dev.type,
                                   "--worker", out],
                                  env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=root,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(N_PROC)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(log)
                raise SystemExit(f"worker {r} failed rc={p.returncode}")
        dist_losses = json.loads(Path(out).read_text())

    from llama_x_tpu_torch.parallel.mesh import make_mesh

    ref_losses = _losses(make_mesh(), dev)  # one process, the whole batch
    for a, b in zip(dist_losses, ref_losses):
        if abs(a - b) >= (1e-5 if dev.type == "cpu" else 1e-3 * abs(b)):
            raise SystemExit(f"losses differ: {dist_losses} vs single-process {ref_losses}")
    print(f"dryrun_multihost OK ({dev}): {N_PROC} processes, losses {dist_losses} == single-process {ref_losses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
