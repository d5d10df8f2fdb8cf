"""Launch counts of the kernel wrappers, in one registry.

Every wrapper that launches a kernel of the port joins ``COUNTED`` where it is defined
(``counted``), with the name its kernel carries in a device trace (``fn.device_kernel``,
a regular expression), so that a profiler trace can confirm a count. It calls ``add``
where it launches its kernel, on the current stream:

- outside a CUDA graph's capture ``add`` adds one to ``fn.launches``;
- while the current stream is being captured nothing launches: inside ``tally()`` (which
  models/decode_graph.py opens around a capture) the launch goes to the capture's tally,
  and every replay of the graph credits each wrapper with its tally (a capture outside
  ``tally()`` counts once, at capture).
"""

from __future__ import annotations

import contextlib
import re
import threading
from collections import Counter

import torch

COUNTED: dict = {}  # name -> wrapper, in the order the modules define them
_local = threading.local()


def counted(name: str, fn, device_kernel: str):
    """Register ``fn`` as the counted wrapper ``name`` whose kernel a trace names
    ``device_kernel``; its count starts at 0."""
    fn.launches = 0
    fn.device_kernel = re.compile(device_kernel)
    COUNTED[name] = fn
    return fn


def capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def add(fn) -> None:
    """One launch of ``fn``'s kernel on the current stream."""
    tally = getattr(_local, "tally", None)
    if tally is not None and capturing():
        tally[fn] = tally.get(fn, 0) + 1
    else:
        fn.launches += 1


@contextlib.contextmanager
def tally():
    """The launches this thread captures inside the block: {wrapper: launches}."""
    _local.tally = t = {}
    try:
        yield t
    finally:
        _local.tally = None


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
