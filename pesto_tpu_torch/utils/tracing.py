"""Spans of the program's stages, on the clock the profiler stamps its
events with.

A span is one stage of one call: `Span(name, start_ns, end_ns, span_id,
parent_id, thread, attrs)`. Its stamps are unix nanoseconds, as Kineto
stamps its events, so a span can be laid over a `torch.profiler` trace:
the monotonic clock plus its offset to `time.time_ns()` fixed at the
recording's first stamp, as the profiler fixes its own at its start, so a
step of the wall clock moves no stamp of one recording against another.
`thread` is the native thread id, the one the trace names. A span's parent is the span open on its thread
when it began, or the one passed as `parent` (a stage whose work runs in
worker threads passes itself to them).

Spans and launch stamps are recorded only while a `torch.profiler` session
is active on the thread that opens them, inside a `record()` block, or
under a recorded parent. Otherwise a span costs a flag check and records
nothing, with one exception: a span given `sums` always adds its length to
them (the always-on stage totals, such as `Predictor.stage_ms`).

The recorder keeps what it records in memory, up to a cap that counts what
it drops, until `take()` hands it over and clears it. `launch(name)` is
the stamp that `ops._build.Entry` writes just before each C launch call.
"""

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch

CAP = 1 << 16  # spans, and launch stamps, kept until take()

_profiler_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int  # 0: none
    thread: int
    attrs: dict


class Launch(NamedTuple):
    name: str  # the C entry point
    ns: int  # just before the C call
    thread: int


class Recording(NamedTuple):
    spans: list
    launches: list
    dropped: int  # spans and stamps past the cap


class Sums:
    """Always-on totals of spans in ms by key (and plain counts), read and
    written under `lock`."""

    def __init__(self, init: dict):
        self.ms = dict(init)
        self.lock = threading.Lock()

    def add(self, key, ns: int) -> None:
        with self.lock:
            self.ms[key] += ns / 1e6

    def count(self, key) -> None:
        with self.lock:
            self.ms[key] += 1


_OFF = contextlib.nullcontext()  # the span that records nothing


class _Timed:
    """A span that records nothing but adds its length to `sums`."""

    __slots__ = ("sums", "key", "start")

    def __init__(self, sums, key):
        self.sums, self.key = sums, key

    def __enter__(self):
        self.start = time.monotonic_ns()
        return None

    def __exit__(self, *exc):
        self.sums.add(self.key, time.monotonic_ns() - self.start)
        return False


class _Live:
    """A span being recorded: `attrs` may be added to until it ends, and it
    is the `parent` of spans that other threads open for it."""

    __slots__ = ("rec", "name", "span_id", "parent_id", "attrs", "sums", "key", "start", "thread")

    def __init__(self, rec, name, parent, sums, key, attrs):
        self.rec, self.name, self.attrs, self.sums, self.key = rec, name, attrs, sums, key
        self.span_id = next(rec._ids)
        self.parent_id = parent.span_id if parent is not None else None

    def __enter__(self):
        stack = self.rec._stack()
        if self.parent_id is None:
            self.parent_id = stack[-1].span_id if stack else 0
        stack.append(self)
        self.thread = threading.get_native_id()
        self.start = self.rec._now()
        return self

    def __exit__(self, *exc):
        end = self.rec._now()
        self.rec._stack().pop()
        if self.sums is not None:
            self.sums.add(self.key, end - self.start)
        self.rec._keep(Span(self.name, self.start, end, self.span_id, self.parent_id, self.thread, self.attrs))
        return False


class Recorder:
    """The buffer of spans and launch stamps (module functions below use
    one per process)."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self._lock = threading.Lock()
        self._local = threading.local()
        self._forced = 0  # open record() blocks
        self._ids = itertools.count(1)
        self._offset = None  # unix ns - monotonic ns, fixed at the first stamp after take()
        self._spans, self._launches, self._dropped = [], [], 0

    def span(self, name: str, parent=None, sums: Sums = None, key=None, **attrs):
        """A context manager around one stage: yields the live span when it
        records, else None. A span whose parent records records too. With
        `sums`, its length in ms is added to `sums.ms[key]` in any case."""
        if parent is not None or self._forced > 0 or _profiler_enabled():
            return _Live(self, name, parent, sums, key, attrs)
        if sums is not None:
            return _Timed(sums, key)
        return _OFF

    def launch(self, name: str) -> None:
        """Stamp a kernel launch of the C entry point `name` while recording."""
        if self._forced > 0 or _profiler_enabled():
            stamp = Launch(name, self._now(), threading.get_native_id())
            with self._lock:
                if len(self._launches) < self.cap:
                    self._launches.append(stamp)
                else:
                    self._dropped += 1

    @contextlib.contextmanager
    def record(self):
        """Record inside the block whether or not a profiler runs."""
        with self._lock:
            self._forced += 1
        try:
            yield
        finally:
            with self._lock:
                self._forced -= 1

    def take(self) -> Recording:
        """What was recorded since the last take(); clears the buffer."""
        with self._lock:
            out = Recording(self._spans, self._launches, self._dropped)
            self._spans, self._launches, self._dropped = [], [], 0
            self._offset = None
        return out

    def _now(self) -> int:
        offset = self._offset
        if offset is None:
            offset = self._offset = time.time_ns() - time.monotonic_ns()
        return time.monotonic_ns() + offset

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.cap:
                self._spans.append(span)
            else:
                self._dropped += 1

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack


RECORDER = Recorder()
span = RECORDER.span
launch = RECORDER.launch
record = RECORDER.record
take = RECORDER.take
