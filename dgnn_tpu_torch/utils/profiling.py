"""Profiling of the port: one recorder of host spans, of the hub-block
kernels' row spans and of a replay series, and the Chrome trace exporter
(port of ``dgnn_tpu/utils/profiling.py``'s ``trace``).

Host spans.  ``span(name)`` is a context manager around a stretch of host
work.  It records the name, the start and the end (``time.perf_counter_ns``)
and the name of the span open around it in the same thread (its parent).
Per-name totals (count, seconds) are kept for the whole process, and for
the spans with no parent apart (``totals(roots=True)``); the raw spans go to
a buffer of the last ``SPAN_BUFFER`` (``spans()``, ``last(name)``).  ``reset()`` clears all
three.  While ``torch.profiler`` records (``recording()``), a span also
opens a record function under its name, so it sits among the profiler's
host events on the clock of the device trace, and ``trace()``'s Chrome
trace holds it; otherwise none is made.  The record function is of the
profiler's op kind (``_RecordFunctionFast``), not
``torch.profiler.record_function``'s user annotation: the profiler mirrors
a user annotation on the device as an event of its own over the kernels it
encloses, which a reader of the device trace would count as a kernel.
Names are dotted and start with ``dgnn.``: the host build
(``dgnn.graph.*``, ``dgnn.data.*``), the kernel library
(``dgnn.kernels.*``) and the device-resident loop (``dgnn.stepgraph.*``).

Row spans.  The dense hub-block kernels (csrc/dense_gat.cu,
csrc/dense_gmm.cu) take a flag word and an [R, 2] buffer: while the word is
set, lane 0 of each block row's warp stores ``%globaltimer`` (ns) at the
row's start and at its end.  The recorder owns the word (``probe_args``
makes it at the first eager launch, outside any capture) and sets it in
stream order by a host-to-device copy, never a kernel, when the profiler's
state has changed since the last write (``sync_probes``: the wrappers'
eager calls and ``StepGraph.replay`` ask).  A launch captured into a
``StepGraph`` gets a buffer of its own for the graph's life, so a graph
captured with the probes off writes row spans on the replays a profiler
records.  ``row_spans()`` reads the launches of the last profiled replay,
or of the eager launches since the probes were last switched on.  The
GAT forward (K5) keeps two counts a row after its stamps ([R, 4]): its
edges walked a second time (where its largest score lay too far under
the TPU kernel's bound) and its edges, which ``row_raises()`` reads from
the same launches.

Replay series.  ``StepGraph.replay`` records a CUDA event after a call's
launches at most once every ``SAMPLE_EVERY_S`` of host time, with the
replays so far and whether a profiler recorded (``ReplaySeries``); two
samples give the device milliseconds a replay between them.

``row_tail``, ``tail_pct`` and ``slow_share`` are the arithmetic the
benchmark's readers apply to the row spans and the series.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["trace", "span", "spans", "last", "totals", "reset", "recording", "Span",
           "Record", "Recorder", "RECORDER", "ReplaySeries", "probe_args",
           "row_spans", "row_raises", "replay_points", "row_tail",
           "tail_pct", "slow_share", "SPAN_BUFFER", "SAMPLE_EVERY_S",
           "SLOWER", "FASTEST"]

# raw spans kept (the totals count every span)
SPAN_BUFFER = 65536
# host seconds between two samples of a replay series, and samples kept
SAMPLE_EVERY_S = 0.05
SERIES_BUFFER = 16384
# ``slow_share``: an interval is slow where its ms a replay exceed by more
# than SLOWER the median of the fastest FASTEST of the intervals
SLOWER = 0.03
FASTEST = 0.1
# eager probed launches kept
EAGER_LAUNCHES = 64


def recording() -> bool:
    """Whether torch.profiler records now."""
    return torch.autograd._profiler_enabled()


def _annotation(name: str):
    """The profiler's host event of a span: a record function of the op
    kind (no device-side mirror)."""
    return torch._C._profiler._RecordFunctionFast(name)


class Record(collections.namedtuple("Record",
                                    "name start_ns end_ns parent")):
    """One finished span: name, start and end (perf_counter_ns), parent's
    name."""

    __slots__ = ()

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

# one probed hub-block launch: kernel name, block rows, its [R, W] buffer
# (W 2: the stamps; 4: the stamps, then a row's edges walked again and its
# edges)
_Launch = collections.namedtuple("_Launch", "name rows buf")


class Span:
    """A span of ``Recorder``; ``seconds`` holds its length once closed."""

    __slots__ = ("_rec", "name", "parent", "start_ns", "end_ns", "_rf")

    def __init__(self, rec: "Recorder", name: str):
        self._rec, self.name = rec, name
        self.parent = self._rf = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        stack = self._rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if recording():
            self._rf = _annotation(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._rec._stack().pop()
        self._rec._close(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class ReplaySeries:
    """CUDA events recorded after replay calls' launches, at most one every
    ``SAMPLE_EVERY_S`` of host time, each with the replays issued before it
    and whether a profiler recorded at the time.  An event after a call is
    the point in the stream before the next one, and its making (some 26 us
    on the host) falls after the call's launch, outside a request's path."""

    def __init__(self, rec: "Recorder"):
        self._rec = rec
        self.samples = collections.deque(maxlen=SERIES_BUFFER)
        self.count = 0
        self._next = 0.0

    def after(self, n: int, profiled: bool) -> None:
        """Called after a call that replayed ``n`` times."""
        self.count += n
        now = time.perf_counter()
        if now >= self._next:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.samples.append((ev, self.count, profiled))
            self._next = now + SAMPLE_EVERY_S
            self._rec.series = self

    def points(self) -> list:
        """(device ms since the first sample kept, replays issued before
        the sample, profiled) a sample, waiting for the last one."""
        if not self.samples:
            return []
        first, last = self.samples[0][0], self.samples[-1][0]
        last.synchronize()
        return [(first.elapsed_time(ev), c, p) for ev, c, p in self.samples]


class Recorder:
    """The port's one recorder (``RECORDER``): host spans, the hub-block
    kernels' probe flag and row-span buffers, the last replay series."""

    def __init__(self):
        self._local = threading.local()   # each thread's open spans
        self._lock = threading.Lock()     # the totals' updates
        self._spans = collections.deque(maxlen=SPAN_BUFFER)
        self._totals, self._roots = {}, {}
        self._flag = None        # int32 [1] on the device: probes on
        self._flag_on = False    # what was last written to it
        self._host = None        # pinned int32 [0, 1], the copies' sources
        self._capture = None     # launches of the capture under way
        self._eager = collections.deque(maxlen=EAGER_LAUNCHES)
        self._last = ()          # launches of the last profiled replay
        self.series = None       # the ReplaySeries last sampled

    # -- host spans -----------------------------------------------------
    def span(self, name: str) -> Span:
        return Span(self, name)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _close(self, s: Span) -> None:
        self._spans.append(Record(s.name, s.start_ns, s.end_ns, s.parent))
        with self._lock:
            for table, on in ((self._totals, True),
                              (self._roots, s.parent is None)):
                if on:
                    t = table.setdefault(s.name, [0, 0.0])
                    t[0] += 1
                    t[1] += s.seconds

    def spans(self) -> list:
        return list(self._spans)

    def last(self, name: str) -> Record | None:
        """The newest buffered span named ``name``."""
        return next((r for r in reversed(self._spans) if r.name == name),
                    None)

    def totals(self, roots: bool = False) -> dict:
        table = self._roots if roots else self._totals
        with self._lock:
            return {k: (c, s) for k, (c, s) in table.items()}

    def reset(self) -> None:
        self._spans.clear()
        with self._lock:
            self._totals.clear()
            self._roots.clear()
        self._eager.clear()
        self._last = ()
        self.series = None

    # -- row spans of the hub-block kernels -------------------------------
    def _write_flag(self, on: bool) -> None:
        i = int(on)
        self._flag.copy_(self._host[i:i + 1], non_blocking=True)

    def sync_probes(self) -> None:
        """Set the flag word to whether a profiler records, where that
        changed since the last write (never inside a capture)."""
        on = recording()
        if self._flag is None or on == self._flag_on:
            return
        self._write_flag(on)
        self._flag_on = on
        if on:
            self._eager.clear()

    def probe_args(self, name: str, rows: int, device, width: int = 2):
        """(flag, buffer) for a hub-block launch of kernel ``name`` over
        ``rows`` block rows ([rows, width] int64), or (None, None): no
        probe.  In a capture by ``StepGraph`` the buffer lives as long as
        the graph; other captures get none.  An eager launch gets one only
        while a profiler records."""
        device = torch.device(device)
        if torch.cuda.is_current_stream_capturing():
            if (self._capture is None or self._flag is None
                    or self._flag.device != device):
                return None, None
            buf = torch.empty((rows, width), dtype=torch.int64,
                              device=device)
            self._capture.append(_Launch(name, rows, buf))
            return self._flag, buf
        if self._flag is None:
            self._flag = torch.zeros(1, dtype=torch.int32, device=device)
            self._host = torch.tensor([0, 1], dtype=torch.int32).pin_memory()
            self._flag_on = False
        if self._flag.device != device:
            return None, None
        self.sync_probes()
        if not self._flag_on:
            return None, None
        buf = torch.empty((rows, width), dtype=torch.int64, device=device)
        if self._last is not self._eager:
            self._eager.clear()
            self._last = self._eager
        self._eager.append(_Launch(name, rows, buf))
        return self._flag, buf

    def begin_capture(self) -> None:
        self._capture = []

    def end_capture(self) -> tuple:
        launches, self._capture = tuple(self._capture or ()), None
        return launches

    def replayed(self, launches: tuple) -> None:
        """A graph holding ``launches`` replays while a profiler records."""
        self._last = launches

    def forget(self, launches: tuple) -> None:
        """A graph holding ``launches`` is freed."""
        if launches and self._last is launches:
            self._last = ()

    def row_spans(self) -> list:
        """(kernel name, [R, 2] int64 ns: start and end a block row) of each
        probed launch of the last profiled replay, read now."""
        return [(l.name, l.buf[:, :2].cpu().numpy()) for l in self._last
                if l.rows > 0]

    def row_raises(self) -> list:
        """(kernel name, [R, 2] int64: a block row's edges walked a second
        time, and its edges) of each probed launch of the last profiled
        replay that counts them (K5), read now."""
        return [(l.name, l.buf[:, 2:4].cpu().numpy()) for l in self._last
                if l.rows > 0 and l.buf.shape[1] >= 4]


RECORDER = Recorder()


def span(name: str) -> Span:
    """A span named ``name`` of the port's recorder (a context manager)."""
    return RECORDER.span(name)


def spans() -> list:
    """The recorder's buffered spans (``Record``s), oldest first."""
    return RECORDER.spans()


def last(name: str) -> Record | None:
    """The recorder's newest buffered span named ``name``, or None."""
    return RECORDER.last(name)


def totals(roots: bool = False) -> dict:
    """name -> (count, seconds) of every span, or of those with no parent."""
    return RECORDER.totals(roots)


def reset() -> None:
    """Clear the spans, the totals and what the readers read."""
    RECORDER.reset()


def probe_args(name: str, rows: int, device, width: int = 2):
    return RECORDER.probe_args(name, rows, device, width)


def row_spans() -> list:
    return RECORDER.row_spans()


def row_raises() -> list:
    return RECORDER.row_raises()


def replay_points() -> list:
    """The points (``ReplaySeries.points``) of the series last sampled."""
    return [] if RECORDER.series is None else RECORDER.series.points()


def row_tail(rows: np.ndarray) -> tuple[float, float]:
    """(T, t95) of one launch's row spans ([R, 2]: start, end a row, ns):
    T the last end less the first start; t95 the time after the first
    start by which 95 % of the rows had ended (nearest rank)."""
    rows = np.asarray(rows, np.int64)
    t0 = rows[:, 0].min()
    ends = np.sort(rows[:, 1] - t0)
    k = max(math.ceil(0.95 * len(ends)), 1) - 1
    return float(ends[-1]), float(ends[k])


def tail_pct(launches) -> float | None:
    """The launches' tail, %: sum(T - t95) over sum(T) (``row_tail``) over
    ``launches`` ([R, 2] arrays); None without a launch of any length."""
    pairs = [row_tail(r) for r in launches if len(r)]
    whole = sum(t for t, _ in pairs)
    if whole <= 0:
        return None
    return 100.0 * sum(t - t95 for t, t95 in pairs) / whole


def slow_share(points) -> float | None:
    """The share, %, of the replays that lie in slow intervals of a replay
    series.  ``points``: (device ms, replays before, profiled) a sample, in
    order (``ReplaySeries.points``).  The intervals are those between two
    unprofiled samples, the series' first interval left out (it holds the
    replays before a steady loop: warm-up, first steps waited for).  An
    interval is slow where its ms a replay exceed by more than ``SLOWER``
    the median of the fastest ``FASTEST`` of the intervals.  None without
    an interval."""
    iv = [((t1 - t0) / (c1 - c0), c1 - c0)
          for (t0, c0, p0), (t1, c1, p1) in zip(points[1:], points[2:])
          if not (p0 or p1) and c1 > c0]
    if not iv:
        return None
    per = sorted(ms for ms, _ in iv)
    ref = float(np.median(per[:max(1, int(len(per) * FASTEST))]))
    slow = sum(n for ms, n in iv if ms > ref * (1.0 + SLOWER))
    return 100.0 * slow / sum(n for _, n in iv)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (CPU, and CUDA where torch sees
    a card) and write ``<logdir>/trace.json`` (chrome://tracing, Perfetto),
    the recorder's spans among its host events.  Yields the profiler, whose
    ``key_averages()`` sum the events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
