"""Observability of a training run (port of llama_x_tpu/train/metrics.py): the run
logger (a JSONL file beside the checkpoints, plus config.json, and wandb where a project is
named and wandb can be imported), the tokens-per-second meter, device memory from
``torch.cuda``, and the ``--profile`` trace (``Profiler``: ``torch.profiler`` where the JAX
package has ``jax.profiler``).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch


class RunLogger:
    def __init__(self, save_dir: str | Path, config: dict | None = None, project: str | None = None,
                 run_name: str | None = None):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.f = open(self.save_dir / "metrics.jsonl", "a")
        self.wandb = None
        if project is not None:
            try:
                import wandb
            except ImportError:
                print(f"--project {project}: wandb is not installed; logging to {self.save_dir / 'metrics.jsonl'} only")
            else:
                self.wandb = wandb.init(project=project, name=run_name, config=config, dir=str(self.save_dir))
        if config is not None:
            (self.save_dir / "config.json").write_text(json.dumps(config, indent=2, default=str))

    def log(self, metrics: dict, step: int):
        rec = {"step": step, **{k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def finish(self):
        self.f.close()
        if self.wandb is not None:
            self.wandb.finish()


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


class Profiler:
    """``torch.profiler`` over steps 5 and 6 of a run (schedule wait 1, warmup 4, active 2,
    the reference trainer's), written to ``log_dir`` as a Chrome trace. It records CPU
    activity, and the card's kernels when ``device`` is a CUDA device. ``step()`` after each
    train step; ``close()`` at the end of the run."""

    def __init__(self, log_dir: str | Path, device, wait: int = 1, warmup: int = 4, active: int = 2):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities, schedule=schedule(wait=wait, warmup=warmup, active=active, repeat=1),
                            on_trace_ready=self._write)
        self.prof.start()

    def _write(self, prof):
        prof.export_chrome_trace(str(self.log_dir / f"trace_step{prof.step_num}.json"))

    def step(self):
        self.prof.step()

    def close(self):
        self.prof.stop()
