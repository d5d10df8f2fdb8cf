"""Spans, the profiled sub-window and what is read from its device trace.

``span(name)`` is a ``torch.profiler.record_function`` range around a call the
benchmark makes into the program (``bench.train_step``, ``bench.submit``,
``bench.collect``, ``bench.warmup``, ``bench.reference``). ``Window`` profiles a short
steady stretch inside the measured window (host and device activity) and reduces the
trace to plain numbers: the busy seconds (the union of the device records' intervals
within the window, not their sum: records on two streams overlap), the device seconds
of each kernel group, the longest idle gaps named by what the host was doing in them,
and the records counted against the program's launch counters.

Which kernels are the port's own comes from the program (``ops/launches.py``: each
counted wrapper's kernel name) and from the companions its wrappers launch beside them
(K5's dq kernel, K3's merge kernel), listed here.
"""

from __future__ import annotations

import re
import time

import torch

# the kernels each counted wrapper launches besides the one its counter names
COMPANIONS = {
    "flash_attention_bwd": r"flash_bwd_dq_kernel<\d+, \w+, false>",
    "decode_attention_int8": r"decode_merge_kernel",
}
SPAN_PREFIX = "bench."
WINDOW = "bench.trace_window"
MAX_ENTRIES = 10
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


def span(name: str):
    return torch.profiler.record_function(name)


def launch_counts() -> dict[str, int]:
    from llama_x_tpu_torch.ops import launches

    return {name: fn.launches for name, fn in launches.COUNTED.items()}


def port_kernels() -> dict[str, tuple[re.Pattern, re.Pattern]]:
    """{counted wrapper: (the pattern of the kernel its counter counts, the pattern of
    every kernel it launches)}."""
    from llama_x_tpu_torch.ops import launches

    out = {}
    for name, fn in launches.COUNTED.items():
        pat = fn.device_kernel.pattern
        every = f"(?:{pat})|(?:{COMPANIONS[name]})" if name in COMPANIONS else pat
        out[name] = (fn.device_kernel, re.compile(every))
    return out


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Window:
    """``with Window() as w:`` profiles the block; ``w.summary`` after it. ``host``: host
    activity too (the thread that opens the window: the spans and the ops it runs); without
    it the device's alone, as for a program whose launches come from its own thread."""

    def __init__(self, enabled: bool = True, host: bool = True):
        self.enabled, self.host = enabled, host
        self.summary: dict | None = None

    def __enter__(self):
        if not self.enabled:
            return self
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self.counts0 = launch_counts()
        on_card = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if self.host or not on_card else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.outer = span(WINDOW)
        self.outer.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        _sync()
        wall = time.perf_counter() - self.t0
        self.outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        if exc[0] is None:
            launched = {k: v - self.counts0.get(k, 0) for k, v in launch_counts().items()}
            self.summary = reduce(self.prof, wall, launched)
        return False


def reduce(prof, wall: float, launched: dict[str, int]) -> dict:
    """The trace as numbers (see the module docstring)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, host = [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.name().startswith(SPAN_PREFIX):  # a range shows on the device too
            dev.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == cpu:
            if e.name() == WINDOW:
                lo, hi = e.start_ns(), e.end_ns()
            else:
                host.append((e.name(), e.start_ns(), e.end_ns()))
    if lo is None:  # no host range: the device records' extent
        lo = min((a for _, a, _ in dev), default=0)
        hi = max((b for _, _, b in dev), default=0)
    dev = [(n, max(a, lo), min(b, hi)) for n, a, b in dev if b > lo and a < hi]
    merged = _merge([(a, b) for _, a, b in dev])
    busy_ns = sum(b - a for a, b in merged)
    by_name: dict[str, float] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
    patterns = port_kernels()
    groups = {name: 0.0 for name in patterns}
    records = {name: 0 for name in patterns}
    own = 0.0
    for n, a, b in dev:
        for name, (counted, every) in patterns.items():
            if every.search(n):
                groups[name] += (b - a) / 1e9
                records[name] += bool(counted.search(n))
                own += (b - a) / 1e9
                break
    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_host_at(host, (a + b) // 2), (b - a) / 1e9] for a, b in gaps[:MAX_ENTRIES]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:MAX_ENTRIES]
    top = [(n[:NAME_CHARS], v) for n, v in top]
    return dict(window_s=(hi - lo) / 1e9, host_wall_s=wall, busy_s=busy_ns / 1e9, records=len(dev),
                device_s=sum(by_name.values()), own_s=own, group_s=groups, group_records=records,
                launched=launched, device_ops=[[n, s] for n, s in top], idle_gaps=idle)


def _host_at(host, t: int) -> str:
    """What the host was doing at ``t``: the benchmark's span over it, else the shortest
    host event over it, else "no host event" (also where host activity was not traced)."""
    best = None
    for n, a, b in host:
        if a <= t <= b:
            if n.startswith("bench."):
                return n
            if best is None or b - a < best[1]:
                best = (n, b - a)
    return best[0] if best else "no host event"



def idle_share(obs: dict) -> float | None:
    """1 - busy / window of the profiled stretch, in %."""
    s = (obs.get("trace") or {}).get("summary")
    if not s or not s["window_s"] or not s["records"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def pass_share(obs: dict) -> float | None:
    """Device time of the kernels that are not the port's own (PyTorch's elementwise,
    copy, reduction and library passes) over all device time of the stretch, in %."""
    s = (obs.get("trace") or {}).get("summary")
    if not s or not s["device_s"]:
        return None
    return 100.0 * (s["device_s"] - s["own_s"]) / s["device_s"]
