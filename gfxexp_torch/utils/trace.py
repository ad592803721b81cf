"""The port's tracing: named spans of its work and one registry of counters.

Spans. `with span("gfx.<layer>[.<stage>]"):` marks a stretch of the host
work that launches a layer's or a stage's kernels. While a torch profiler
records, the span is a range among the profiler's CPU events, on the clock
the device kernels are traced on, nested under the span around it: an
operator who runs `torch.profiler` around an app finds the spans in their
trace, and each kernel's launch call (its correlation id) falls inside the
spans that launched it. Otherwise a span costs one flag check and hands
back a shared object that does nothing.

The range is opened at function scope (`_RecordFunctionFast`), not as a
user annotation (`torch.profiler.record_function`): the profiler also
draws a user annotation on the device's timeline, as an event spanning
the kernels launched inside it, and a device trace would count that event
among the device's operations.

A span name contains a dot, and no span is named like the frame loops'
passes (`update`, `gbuffer`, `restir`, `pathTrace`, `svgf`) or like a walk
kernel (`*_walk*`), which traces already name.

Counters. `count(name, n)` adds to a host-side integer under a dotted name
(`walk.kernel1.closest`, `wide.syncs`, `tfdm.rounds`); counting never reads
the device. `counters(prefix)` reads them, `reset_counters(prefix)` forgets
them: a counter nothing has added to since its reset reads as absent.
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_counts: dict = {}


class _Off:
    """The span outside a profiler: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager marking the work inside it as span `name`: a
    profiler range while a torch profiler records, else nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    _counts[name] = _counts.get(name, 0) + n


def counters(prefix: str = "") -> dict:
    """The counters whose names start with `prefix`, by name (a copy)."""
    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = None) -> None:
    """Forget the counters whose names start with `prefix` (every counter
    without one)."""
    if prefix is None:
        _counts.clear()
        return
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]
