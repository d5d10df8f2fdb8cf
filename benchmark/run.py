"""Runs one cell of the benchmark once and prints its result as the last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks for. It loads
and warms up the program (``setup_s``), measures for ``--seconds``, judges what the timed
path produced against the plain reference, and prints one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``, which profiles a short stretch of the run; a
trace that holds fewer records of the port's kernels than its launch counters count flags
each device-trace metric with ``lost_records``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, also the last lines on standard error.

Development options: ``--control`` also computes the control's readings (the reference
at 4 bits where the configuration states 8) and the faults the reference can show, and
prints them under ``extra``; ``--fault <name>`` plants a fault of the cell's traffic kind
(its ``FAULTS``) under the timed path, whose run has to read ``correct`` false;
``--set key=value`` overrides a parameter of the cell's traffic mix (the rate sweep). None
is part of a measured run.

Everything the program builds or caches stays inside the checkout: its kernels under
``llama_x_tpu_torch/build/``, and the toolchains' caches under ``.bench_cache/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "llama_x_tpu"}
DRAIN_SECONDS = 60.0


def cache_dirs(root: Path) -> None:
    """The toolchains' caches at fixed paths inside the checkout."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


class Context:
    """What a traffic kind's ``run`` gets: the cell's data, the run's arguments and the
    device's few services."""

    def __init__(self, spec, cell: str, seed: int, seconds: float, trace: bool, device: str, control: bool = False,
                 overrides: dict | None = None, log=None):
        self.workload = spec.cell(cell)
        self.cfg = spec.config(self.workload["config"])
        self.mix = {**spec.mix(self.workload["traffic"]), **(overrides or {})}
        self.limits = self.workload["limits"]
        self.seed, self.seconds, self.trace = seed, float(seconds), trace
        self.device, self.control = device, control
        self.drain_seconds = DRAIN_SECONDS
        self.cuda = device.startswith("cuda")
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def event(self):
        import torch

        if not self.cuda:
            return _Done()
        e = torch.cuda.Event()
        e.record()
        return e

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - T_START

    def reset_peak(self) -> None:
        """Start a peak of the window's own; the process's peak so far is kept."""
        if self.cuda:
            import torch

            self.memory_peak_bytes = max(self.memory_peak_bytes, self.peak())
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        if not self.cuda:
            return 0
        import torch

        return torch.cuda.max_memory_allocated()

    def program_done(self) -> None:
        """The program's part is over: its peak memory since the process started."""
        self.sync()
        self.memory_peak_bytes = max(self.memory_peak_bytes, self.peak())

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


class _Done:
    def synchronize(self) -> None:
        pass


def run_cell(root: Path, cell: str, seed: int, seconds: float, trace: bool, device: str, control: bool = False,
             overrides: dict | None = None, log=None, fault: str | None = None) -> dict:
    """One run of ``cell`` (the data under ``root``) on ``device``: the result object."""
    import torch

    from benchmark import spec as spec_mod

    spec = spec_mod.Spec(root)
    ctx = Context(spec, cell, seed, seconds, trace, device, control, overrides, log)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = spec_mod.kind(ctx.mix["kind"])
    undo = kind.FAULTS[fault]() if fault else None
    try:
        out = kind.run(ctx)
    finally:
        if undo is not None:
            undo()
    checks = {name: {"value": value, "limit": limit} for name, value, limit in out["checks"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    summary = (out["obs"].get("trace") or {}).get("summary") if trace else None
    if trace:
        metrics = {}
        for m in spec.per_layer(cell):
            value = spec.reader(m["name"]).read(out["obs"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": ctx.setup_s, **out["e2e"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in spec.end_to_end(cell)}
    dev = {"platform": "gpu" if ctx.cuda else "cpu",
           "kind": torch.cuda.get_device_name() if ctx.cuda else "cpu",
           "count": ctx.workload["chips"], "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
        ctx.log("trace records of the port's kernels against its launch counters: " + json.dumps(
            {k: [summary["group_records"][k], summary["launched"].get(k, 0)] for k in summary["group_records"]
             if summary["group_records"][k] or summary["launched"].get(k, 0)}))
        ctx.log(f"trace: {summary['records']} device records, busy {summary['busy_s']:.6f} s of "
                f"{summary['window_s']:.6f} s")
        lost = {k: [n, summary["launched"].get(k, 0)] for k, n in summary["group_records"].items()
                if n != summary["launched"].get(k, 0)}
        if lost:  # the profiler dropped records: what it read stands flagged, beside the shortfall
            ctx.log(f"trace lost records {json.dumps(lost)}: its device-trace metrics read an incomplete trace")
            for m in spec.per_layer(cell):
                if m["source"] == "device_trace" and m["name"] in metrics:
                    metrics[m["name"]]["lost_records"] = lost
    if out.get("extra"):
        result["extra"] = out["extra"]
    result["checks"] = checks
    return result


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    p.add_argument("--control", action="store_true", help="also read the control and the reference's faults")
    p.add_argument("--fault", help="plant this fault of the cell's traffic kind under the timed path")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override a parameter of the cell's traffic mix (the rate sweep)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_dirs(ROOT)
    import torch

    from benchmark import spec as spec_mod

    chips = spec_mod.Spec(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}: no result", file=sys.stderr)
        return 2
    overrides = {k: json.loads(v) for k, v in (s.split("=", 1) for s in args.set)}
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", args.control, overrides,
                      fault=args.fault)
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"modules that no run may load were loaded: {found}: no result", file=sys.stderr)
        return 3
    if "extra" in result:
        print("extra " + json.dumps(result["extra"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
