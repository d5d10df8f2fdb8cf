"""Launch counts of the kernel wrappers, in one registry.

Every wrapper that launches a kernel of the port joins ``COUNTED`` where it is defined
(``counted``), with the name its kernel carries in a device trace (``fn.device_kernel``,
a regular expression), so that a profiler trace can confirm a count. It calls ``add``
where it launches its kernel, on the current stream:

- outside a CUDA graph's capture ``add`` adds one to ``fn.launches``;
- while the current stream is being captured nothing launches: the launch goes to the tally
  that ``tally(stream)`` opened for that stream (models/decode_graph.py and
  train/step_graph.py open one around each capture), whichever thread issues it. The
  autograd engine runs the backward of CUDA nodes on a device thread of its own, and the
  serving scheduler captures on its worker thread: a tally keyed by the capturing stream
  gets both. Every replay of the graph credits each wrapper with its tally (a capture with
  no tally open on its stream counts once, at capture).

A ``Work`` counter (say, the positions a scan covered) is credited the same way, by any amount
an ``add``; it is no kernel, so it joins no trace check.
"""

from __future__ import annotations

import contextlib
import re
import threading
from collections import Counter

import torch

COUNTED: dict = {}  # name -> wrapper, in the order the modules define them
_tallies: dict[int, dict] = {}  # the handle of a capturing stream -> its capture's tally
_lock = threading.Lock()


def counted(name: str, fn, device_kernel: str):
    """Register ``fn`` as the counted wrapper ``name`` whose kernel a trace names
    ``device_kernel``; its count starts at 0."""
    fn.launches = 0
    fn.device_kernel = re.compile(device_kernel)
    COUNTED[name] = fn
    return fn


class Work:
    """A count of work a wrapper's launches did, credited as launches are (``add(work, n)``)."""

    def __init__(self):
        self.launches = 0


def capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def _stream_handle(stream=None) -> int:
    """The handle of ``stream`` (default: the current stream of the current device); 0 where
    there is no card."""
    if stream is None:
        if not torch.cuda.is_available():
            return 0
        stream = torch.cuda.current_stream()
    return stream.cuda_stream


def add(fn, n: int = 1) -> None:
    """One launch of ``fn``'s kernel on the current stream (or ``n`` units of a ``Work``)."""
    if _tallies and capturing():
        key = _stream_handle()
        with _lock:
            tally = _tallies.get(key)
            if tally is not None:
                tally[fn] = tally.get(fn, 0) + n
                return
    with _lock:
        fn.launches += n


@contextlib.contextmanager
def tally(stream=None):
    """The launches captured on ``stream`` (default: the current stream) inside the block,
    from any thread: {wrapper: launches}."""
    key = _stream_handle(stream)
    t: dict = {}
    with _lock:
        if key in _tallies:
            raise RuntimeError("a tally is already open on this stream")
        _tallies[key] = t
    try:
        yield t
    finally:
        with _lock:
            del _tallies[key]


def traced_counts(kernel_names) -> dict[str, int]:
    """{the wrappers of one kernel, joined by " + ": the kernels of that name among
    ``kernel_names``} (a device trace's, one name per kernel that ran)."""
    by_name = Counter(kernel_names)
    groups: dict[str, list[str]] = {}
    for name, fn in COUNTED.items():
        groups.setdefault(fn.device_kernel.pattern, []).append(name)
    return {" + ".join(names): sum(n for k, n in by_name.items() if re.search(pattern, k))
            for pattern, names in groups.items()}


def check_trace(kernel_names, counts: dict[str, int], what: str) -> dict[str, int]:
    """Hold ``counts`` ({name: launches} over a window) to a device trace of that window:
    for each kernel, the launches of the wrappers that launch it must equal the kernels of
    that name in the trace. Raises where they differ; -> ``traced_counts``."""
    traced = traced_counts(kernel_names)
    for group, seen in traced.items():
        want = sum(counts.get(name, 0) for name in group.split(" + "))
        if seen != want:
            raise AssertionError(f"{what}: the wrappers counted {want} launches of {group}, the device trace shows "
                                 f"{seen} of its kernels")
    return traced
