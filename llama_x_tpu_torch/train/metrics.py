"""Observability of a training run (port of llama_x_tpu/train/metrics.py): the run
logger (a JSONL file beside the checkpoints, plus config.json), the tokens-per-second
meter, and device memory from ``torch.cuda``. The JAX package's optional wandb sink
and its ``jax.profiler`` hook are not carried over: the JSONL file is the sink, and
``torch.profiler`` is driven by the caller where a trace is wanted.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch


class RunLogger:
    def __init__(self, save_dir: str | Path, config: dict | None = None):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.f = open(self.save_dir / "metrics.jsonl", "a")
        if config is not None:
            (self.save_dir / "config.json").write_text(json.dumps(config, indent=2, default=str))

    def log(self, metrics: dict, step: int):
        rec = {"step": step, **{k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def finish(self):
        self.f.close()


class Throughput:
    """Tokens (and seconds of audio) per second between two reads of ``rates``."""

    def __init__(self):
        self.n_tokens = 0
        self.audio_secs = 0.0
        self.t0 = time.perf_counter()

    def update(self, n_tokens: int, audio_secs: float = 0.0):
        self.n_tokens += int(n_tokens)
        self.audio_secs += audio_secs

    def rates(self) -> dict:
        t1 = time.perf_counter()
        dt = max(t1 - self.t0, 1e-9)
        out = {"toks_per_second": self.n_tokens / dt}
        if self.audio_secs:
            out["audio_secs_per_second"] = self.audio_secs / dt
        self.n_tokens, self.audio_secs, self.t0 = 0, 0.0, t1
        return out


def device_memory_stats(device=None) -> dict:
    """Bytes in use and their peak on a CUDA device, in GB; {} for the CPU, where
    PyTorch keeps no such count (0.0 would be a lie)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    return {
        "memory_in_use_gb": torch.cuda.memory_allocated(dev) / 1e9,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
