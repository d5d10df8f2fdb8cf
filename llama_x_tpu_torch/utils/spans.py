"""A flight recorder of spans inside the program: what the serving scheduler's worker, its
requests and its graph replays did, and when.

A span is a name, an id, the id of the span that caused it (the span open around it on
the same thread, or the one given), the request it belongs to where it has one, the
thread, its start and end on ``time.perf_counter_ns()`` and a few attributes. Spans are
kept in memory, the newest ``CAPACITY`` of them; older ones are dropped and counted
(``dropped()``). Nothing is written out: the program's readers run in process and read
``snapshot()``.

The recorder is on by default and costs a few Python calls a span; ``enable(False)`` turns
it off (nothing is recorded, no device event is taken and nothing waits for the device). It never calls a profiler API:
a ``torch.profiler`` range opened from the scheduler's worker thread while it replays
graphs hung the card.

Clocks. ``to_trace_ns`` maps a span time onto the clock of a ``torch.profiler`` (kineto)
trace, whose timestamps are nanoseconds since the Unix epoch, through a pair of
(``perf_counter_ns``, ``time_ns``) readings taken together. Device work is timed by
``DeviceClock``: CUDA events around each graph replay and each block of plain copies that
one thread launches, read back once that work is known to be done, and mapped onto the
host clock through an anchor event recorded on an idle, synchronized device.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

CAPACITY = 65536

now = time.perf_counter_ns


def _clock_pair() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) read together: the tightest of a few tries."""
    best = None
    for _ in range(5):
        a = now()
        wall = time.time_ns()
        b = now()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1], best[2]


class Span:
    __slots__ = ("name", "id", "parent", "request", "thread", "start", "end", "attrs")

    def __init__(self, name: str, id: int, parent: int | None, request: int | None, thread: int, start: int,
                 end: int | None, attrs: dict):
        self.name, self.id, self.parent, self.request = name, id, parent, request
        self.thread, self.start, self.end, self.attrs = thread, start, end, attrs

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, request={self.request}, "
                f"start={self.start}, end={self.end}, {self.attrs})")


class _Open:
    """``with recorder.span(...) as s``: ``s`` is the ``Span``, timed from entry to exit."""

    __slots__ = ("rec", "span")

    def __init__(self, rec: Recorder, span: Span):
        self.rec, self.span = rec, span

    def __enter__(self) -> Span:
        stack = self.rec._stack()
        self.span.parent = stack[-1].id if stack else None
        stack.append(self.span)
        self.span.start = now()
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.end = now()
        self.rec._stack().pop()
        self.rec._keep(self.span)
        return False


class _Off:
    """What ``span`` and ``DeviceClock.interval`` give while the recorder is off."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Recorder:
    """The spans of a process (``RECORDER``, behind this module's functions)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = True
        self.spans: deque[Span] = deque(maxlen=capacity)
        self.lost = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.perf0, self.wall0 = _clock_pair()

    def _stack(self) -> list[Span]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.lost += 1
            self.spans.append(span)

    def span(self, name: str, request: int | None = None, **attrs):
        """A span around a ``with`` block on this thread, under the span open around it."""
        if not self.on:
            return OFF
        return _Open(self, Span(name, next(self.ids), None, request, threading.get_ident(), 0, None, attrs))

    def record(self, name: str, start: int, end: int, parent: int | None = None, request: int | None = None,
               thread: int | None = None, **attrs) -> None:
        """A span whose times are already known (a request's phases, a device interval)."""
        if self.on:
            self._keep(Span(name, next(self.ids), parent, request, thread or threading.get_ident(), start, end,
                            attrs))

    def current(self) -> Span | None:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def outermost(self) -> Span | None:
        stack = self._stack()
        return stack[0] if stack else None

    def snapshot(self) -> list[Span]:
        with self.lock:
            return list(self.spans)

    def to_trace_ns(self, t: int) -> int:
        return t + (self.wall0 - self.perf0)


RECORDER = Recorder()


def enable(on: bool = True) -> None:
    """Record spans (the default) or not."""
    RECORDER.on = bool(on)


def span(name: str, request: int | None = None, **attrs):
    return RECORDER.span(name, request, **attrs)


def record(name: str, start: int, end: int, parent: int | None = None, request: int | None = None, **attrs) -> None:
    RECORDER.record(name, start, end, parent, request, **attrs)


def snapshot() -> list[Span]:
    """The spans kept, oldest first."""
    return RECORDER.snapshot()


def dropped() -> int:
    """Spans dropped for the bound."""
    return RECORDER.lost


def to_trace_ns(t: int) -> int:
    """A ``perf_counter_ns`` time (a span's start or end) on a kineto trace's clock."""
    return RECORDER.to_trace_ns(t)


class DeviceClock:
    """Device intervals of the work one thread launches on the current stream: a start and
    an end CUDA event around each graph replay and each block of plain copies
    (``interval``, through ``on_device`` from code that does not own the clock), read at
    ``collect`` once the thread has waited for that work anyway, and kept as spans of the
    recorder on the host clock: an anchor event recorded on an idle, synchronized device
    (``settle``) gives the host time of the device's clock, and every interval is placed
    by its start's elapsed time from the anchor, its end by its own two events.

    A start event runs as soon as the stream reaches it: on an idle device, before the
    host has finished launching the work behind it. So an interval around one launch (a
    graph replay, ``one_launch``) starts no earlier than the host's return from that
    launch, and keeps as ``cut_ns`` the time it left out between its start event and that
    return. The work's true start lies in that stretch: a slow launch may hold the device
    idle (which the cut rightly leaves out) or let the graph's first kernels run before it
    returns (which the cut wrongly leaves out), so the interval with and without ``cut_ns``
    bounds the replay's device time from both sides. Idle time between the kernels inside one replay
    is inside its interval either way.

    ``bind`` makes it the clock of the calling thread. ``event`` and ``synchronize`` are the
    CUDA ones by default (tests substitute fakes). The events come from a pool and go back
    to it when read."""

    def __init__(self, device=None, event=None, synchronize=None, recorder: Recorder = RECORDER):
        import torch

        self.rec = recorder
        self._event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self._sync = synchronize or (lambda: torch.cuda.synchronize(device))
        self.free: list = []
        # (name, parent id, thread, attrs, start event, end event, host time the launch returned or None)
        self.pending: deque = deque()  # in launch order
        self.anchor = None  # (event, host ns)

    def _take(self):
        ev = self.free.pop() if self.free else self._event()
        ev.record()
        return ev

    def bind(self) -> None:
        self.rec.local.clock = self

    def unbind(self) -> None:
        self.rec.local.clock = None

    def interval(self, name: str, one_launch: bool = False, **attrs):
        """A device interval around a ``with`` block that launches work on the current
        stream: its parent the span open on this thread, ``stage`` the outermost one. A no-op
        while the recorder is off or before the first anchor."""
        if not self.rec.on or self.anchor is None:
            return OFF
        return _Interval(self, name, one_launch, attrs)

    def collect(self) -> None:
        """Every pending interval whose work has run, as a span (in launch order: the stream
        runs its work in order, so the first one not done ends the pass)."""
        if self.anchor is None:
            return
        a_ev, a_ns = self.anchor
        while self.pending and self.pending[0][5].query():
            name, parent, thread, attrs, ev0, ev1, launched = self.pending.popleft()
            start = a_ns + round(a_ev.elapsed_time(ev0) * 1e6)
            end = start + round(ev0.elapsed_time(ev1) * 1e6)
            if launched is not None:
                cut = min(max(launched - start, 0), end - start)
                start += cut
                attrs["cut_ns"] = cut
            self.rec.record(name, start, end, parent, None, thread, **attrs)
            self.free += (ev0, ev1)

    def settle(self) -> None:
        """With the device idle: wait for it, read every pending interval, and take the
        anchor again (so that the two clocks' drift does not add up). Nothing while the
        recorder is off."""
        if not self.rec.on:
            return
        self._sync()
        self.collect()
        if self.anchor is not None:
            self.free.append(self.anchor[0])
        ev = self._take()
        self.anchor = (ev, now())
        ev.synchronize()


class _Interval:
    __slots__ = ("clock", "name", "one_launch", "attrs", "ev0")

    def __init__(self, clock: DeviceClock, name: str, one_launch: bool, attrs: dict):
        self.clock, self.name, self.one_launch, self.attrs = clock, name, one_launch, attrs

    def __enter__(self) -> _Interval:
        self.ev0 = self.clock._take()
        return self

    def __exit__(self, *exc) -> bool:
        launched = now() if self.one_launch else None
        clock = self.clock
        ev1 = clock._take()
        parent, outer = clock.rec.current(), clock.rec.outermost()
        if outer is not None:
            self.attrs["stage"] = outer.name
        clock.pending.append((self.name, parent.id if parent else None, threading.get_ident(), self.attrs, self.ev0,
                              ev1, launched))
        return False


def on_device(name: str, one_launch: bool = False, **attrs):
    """``DeviceClock.interval`` of the calling thread's clock; a no-op on a thread that has
    none (every caller but a scheduler's worker on the card)."""
    clock = getattr(RECORDER.local, "clock", None)
    return OFF if clock is None else clock.interval(name, one_launch, **attrs)
