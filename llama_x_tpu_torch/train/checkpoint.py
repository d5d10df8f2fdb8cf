"""Checkpoint save / resume of a training run (port of
llama_x_tpu/train/checkpoint.py, in the port's own file format).

Layout as in the JAX package: ``<dir>/step_<N>/`` per save plus a ``last`` pointer
file; ``restore_checkpoint`` loads a step directory into an existing ``TrainState``
(same model structure and optimizer), exactly: parameters, int8 buffers, optimizer
moments (fp32 or quantized), optimizer count and step all come back bit for bit. The
file is ``state.pt`` (``torch.save`` of plain tensors and ints). Reading the JAX
package's ``.npz`` / Orbax checkpoints comes with the HF import / export slice.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from llama_x_tpu_torch.train.trainer import TrainState


def _point_last(ckpt_dir: Path, name: str) -> None:
    tmp = ckpt_dir / ".last.tmp"
    tmp.write_text(name)
    os.replace(tmp, ckpt_dir / "last")


def save_checkpoint(ckpt_dir: str | Path, state: TrainState, step: int) -> Path:
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step:08d}"
    if not path.exists():
        # the end-of-training save lands on the last interval save's step when
        # n_steps % ckpt_interval == 0: the bytes would be the same, so keep them
        path.mkdir()
        record = {
            "step": state.step,
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
        }
        tmp = path / ".state.pt.tmp"
        torch.save(record, tmp)
        os.replace(tmp, path / "state.pt")
    _point_last(ckpt_dir, path.name)
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    ckpt_dir = Path(ckpt_dir)
    pointer = ckpt_dir / "last"
    if pointer.exists():
        p = ckpt_dir / pointer.read_text().strip()
        if p.exists():
            return p
    steps = sorted(ckpt_dir.glob("step_*"))
    return steps[-1] if steps else None


def restore_checkpoint(path: str | Path, state: TrainState) -> TrainState:
    """Load ``path`` (a step directory) into ``state``, in place; returns it."""
    record = torch.load(Path(path) / "state.pt", map_location="cpu", weights_only=True)
    with torch.no_grad():
        own = state.model.state_dict()
        missing = set(own) ^ set(record["model"])
        if missing:
            raise ValueError(f"checkpoint and model disagree on tensors: {sorted(missing)[:8]}")
        for name, t in own.items():
            t.copy_(record["model"][name])
    state.optimizer.load_state_dict(record["optimizer"])
    state.step = int(record["step"])
    return state
