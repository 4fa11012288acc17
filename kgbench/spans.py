"""What the readers of the port's stage spans share. The port opens
``okst.*`` ranges (``openkeonspark_tpu_torch/obs.py``) while a profiler
records, so they land in a traced slice's host events on the device's
clock. A reader names its spans and divides by the count of its unit's own
span in the slice (``okst.train.step``, ``okst.eval.evaluation``,
``okst.eval.chunk``, ``okst.topk.query``), never by the benchmark's count
of units; where either span is absent (a program without them, or one
that renamed them) it reads None.

Times are host milliseconds inside the spans while the profiler records,
which slows the host about twofold: they say where a unit's host time
goes and how it moves, not its untraced level. A sync is a host runtime
call that blocks until the device is done (:data:`SYNCS`)."""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from kgbench.trace import Slice, merged

SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def spans(sl: Slice, name: str) -> List[Tuple[float, float]]:
    return [(s, e) for n, s, e in sl.host if n == name]


def ms_per(sl: Slice, name: str, unit: str) -> Optional[float]:
    """Milliseconds inside the ``name`` spans over the count of ``unit``
    spans."""
    got, units = spans(sl, name), spans(sl, unit)
    if not got or not units:
        return None
    return 1e3 * sum(e - s for s, e in got) / len(units)


def syncs_per(sl: Slice, within: str, unit: str) -> Optional[float]:
    """Syncs that start inside a ``within`` span, over the count of
    ``unit`` spans."""
    inside, units = merged(spans(sl, within)), spans(sl, unit)
    if not inside or not units:
        return None
    starts = [s for s, _ in inside]
    n = 0
    for name, s, _ in sl.host:
        if name in SYNCS:
            i = bisect.bisect_right(starts, s) - 1
            n += i >= 0 and s <= inside[i][1]
    return n / len(units)
