"""Spans and counts of the program's own work, recorded while a
torch.profiler trace runs.

    with spans.span("field") as sp:
        ...
        sp.add(queries=m, chunks=n)

A span is a name, a start and an end, the span it ran inside (its parent,
on the same thread) and optional counts. The recorder keeps in memory the
spans of the last profiled window: it records exactly while a
`torch.profiler` trace runs (torch's own flag,
`torch.autograd.profiler._is_profiler_enabled`), and the first span it
records after one that ran with no profiler starts a new window, which
drops the spans of the one before. So nothing turns it on but a profiler:
the benchmark's `--trace 1` window and the `trainer.profiler: jax` preset
(`utils/profiling.py::torch_trace`, which also starts a window itself).

With no profiler running, `span` costs one flag check and reads no clock,
unless the caller passes a `sink` dict: the engine's `timings` get each
phase's host-clock seconds under the span's name whether or not a trace
runs. No span synchronises the device. While recording, each span also
enters `torch.profiler.record_function` under its name, so a trace with
CPU activity shows the spans on the kernels' timeline.

Timestamps are `time.time_ns()`, the CLOCK_REALTIME nanoseconds that
`_KinetoEvent.start_ns()` reports for every event of a torch.profiler
trace (torch 2.11 and 2.13; tests/test_torch_spans.py holds a span to its
user annotation within 100 us): device intervals and program spans
compare with no offset.

Spans and counts the program records:

| Span | Where | Counts |
|---|---|---|
| `encode`, `encode.pass`, `encode.graph`, `encode.net`, `encode.accumulate` | `recon/field.py::LatentEncoder`: the call, each pass, each chunk's graph build (K1, subsampling; on the card the copy of its inputs and the replay of the captured build), network (on the card its replay) and scatter-add | `encode`: `chunks`, `replays` (chunks run from a captured CUDA graph), `captures` (made in the call) |
| `field`, `field.sort`, `field.chunk`, `readback` | `recon/field.py::FieldEvaluator.__call__`: the call, the host Morton order and upload, each chunk, the values' copy to the host | `field`: `queries`; `readback`: `bytes` |
| `field.refine`, `readback` | `FieldEvaluator.refine_bisection`: the call, the failed certificates' count and the vertices' copy to the host | `field.refine`: `queries`; `readback`: `bytes` |
| `field.patch` | `FieldEvaluator._field` where the patch is wider than the decoder's k (PPSurf 100NN, 200NN): the patch's own kNN at k=P (K1), under `field.chunk` in a grid evaluation and under `field.refine` in every bisection round, the failed certificates' plain rounds included; none at P <= k or in POCO | `queries` (the chunk's rows) |
| `grow`, `mesh`, `refine`, `clean` | `recon/engine.py::reconstruct_mesh`, filling `timings` | `mesh`, `clean` on the card route (a CUDA reconstruction, `ops/mesh.py`): `faces` (marching cubes' faces in `mesh`, the cleaned mesh's in `clean`) and `upload_bytes` (copied to the card in the phase); none on the host route |
| `step.forward`, `step.backward`, `step.optimizer` | `train/loop.py::train_step` | |
| `train_step N` | `Trainer.fit` | |
| `data.wait` | `data/datasets.py::_PrefetchIterator`: the consumer blocked on its next batch | |

`utils/profiling.py::attribute` sums each span name's counts into its
row of the table `torch_trace` writes: the window's queries and bytes
read back beside the device and idle seconds of the same spans.
"""
from __future__ import annotations

import threading
import time
import typing

from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

clock = time.time_ns  # the profiler's clock (module docstring)


class Span:
    """One recorded span: nanoseconds on `clock`, the enclosing span of
    the same thread, counts by name."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "counts")

    def __init__(self, name: str, parent: typing.Optional["Span"]):
        self.name = name
        self.parent = parent
        self.start_ns = self.end_ns = 0
        self.counts: typing.Dict[str, float] = {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Off:
    """The span with no profiler running and no sink: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def add(self, **counts) -> None:
        return None


_OFF = _Off()


class _Timed(_Off):
    """The span with no profiler running that writes its host-clock
    seconds into a sink dict."""

    __slots__ = ("name", "sink", "t0")

    def __init__(self, name: str, sink: typing.Dict[str, float]):
        self.name, self.sink = name, sink

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.sink[self.name] = time.perf_counter() - self.t0


class _Recording:
    """The span while a profiler runs: recorded, and annotated in the trace."""

    __slots__ = ("rec", "name", "sink", "span", "annotation")

    def __init__(self, rec: "Recorder", name: str, sink):
        self.rec, self.name, self.sink = rec, name, sink

    def __enter__(self):
        stack = self.rec._stack()
        self.span = s = Span(self.name, stack[-1] if stack else None)
        stack.append(s)
        self.rec.spans.append(s)
        self.annotation = record_function(self.name)
        s.start_ns = clock()  # the annotation's interval lies inside the span's
        self.annotation.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.annotation.__exit__(None, None, None)
        s = self.span
        s.end_ns = clock()
        self.rec._stack().pop()
        if self.sink is not None:
            self.sink[s.name] = s.seconds

    def add(self, **counts) -> None:
        c = self.span.counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v


class Recorder:
    """The spans of the last profiled window, in the order they started
    (module docstring)."""

    def __init__(self):
        self.spans: typing.List[Span] = []
        self._local = threading.local()
        self._window = False  # the last span ran under a profiler

    def _stack(self) -> typing.List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, sink: typing.Optional[typing.Dict[str, float]] = None):
        """A context manager around one piece of work; `add(**counts)` on
        what it yields adds counts to the span (module docstring)."""
        if not _profiler._is_profiler_enabled:
            if self._window:
                self._window = False
            return _OFF if sink is None else _Timed(name, sink)
        if not self._window:
            self.start_window()
        return _Recording(self, name, sink)

    def start_window(self) -> None:
        """Drop the spans recorded so far: the next ones form a new window."""
        self.spans = []
        self._window = True


RECORDER = Recorder()  # the process's one recorder, as its profiler is one
span = RECORDER.span
