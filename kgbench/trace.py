"""The traced slice: a short steady run of the window's own unit under
``torch.profiler`` (CPU and CUDA activities), read back from its Chrome
trace into plain interval lists that the per-layer metric readers take.

The slice is marked by a ``kgbench.slice`` range; its length is the
traced window, and only events inside it count. Device events are the
kernels, copies and fills (``kernel``, ``gpu_memcpy``, ``gpu_memset``);
the device is busy on the union of their intervals. Host events are the
operators, runtime calls and annotations of the thread that ran the
slice. The trace is written under ``TMPDIR`` and deleted once read."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

MARK = "kgbench.slice"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
HOST_CATS = {"cpu_op", "operator", "cuda_runtime", "runtime", "cuda_driver",
             "user_annotation"}

Event = Tuple[str, float, float]   # (name, start, end), seconds


@dataclass
class Slice:
    """What one traced slice holds: its window (seconds on the trace's
    clock), the device events and the host events inside it, and the
    units of work it ran, by name (``steps``, ``chunks``, ``queries``…)."""
    start: float
    end: float
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    counts: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(
            [(s, e) for _, s, e in self.device]))

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no device event ran, in %;
        None when the slice saw no device event at all."""
        if not self.device or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def launches(self) -> int:
        return len(self.device)

    def device_time(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.device if match(n))


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def parse(trace: dict, counts: dict) -> Slice:
    """The :class:`Slice` in a Chrome trace that ``torch.profiler``
    exported, clipped to its ``kgbench.slice`` range."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat", "").lower() == "user_annotation"]
    if not marks:
        raise ValueError(f"the trace has no {MARK!r} range")
    m = marks[0]
    t0, t1 = m["ts"] * 1e-6, (m["ts"] + m["dur"]) * 1e-6
    sl = Slice(start=t0, end=t1, counts=dict(counts))
    for e in events:
        cat = e.get("cat", "").lower()
        s, d = e["ts"] * 1e-6, e["dur"] * 1e-6
        lo, hi = max(s, t0), min(s + d, t1)
        if hi < lo:
            continue
        if cat in DEVICE_CATS:
            sl.device.append((e["name"], lo, hi))
        elif cat in HOST_CATS and e.get("tid") == m.get("tid") \
                and e is not m:
            sl.host.append((e["name"], lo, hi))
    return sl


def profile(unit: Callable[[], None], n: int, counts: dict,
            cuda: bool) -> Slice:
    """Run ``unit`` ``n`` times under the profiler inside the
    ``kgbench.slice`` range and read the trace back."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(MARK):
            for _ in range(n):
                unit()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="kgbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return parse(trace, counts)


def innermost(host: List[Event], points: List[float]) -> List[str]:
    """For each of the ascending ``points``, the name of the innermost
    host event that spans it, or ``"(python)"``: one sweep over the
    events (nested on one thread) in order of start, with a stack of the
    ones still open."""
    evs = sorted(host, key=lambda h: (h[1], -h[2]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(evs) and evs[i][1] <= p:
            while stack and stack[-1][2] < evs[i][1]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][2] < p:
            stack.pop()
        out.append(stack[-1][0] if stack else "(python)")
    return out


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the host event that ran through each gap's middle (the
    innermost one; ``"(python)"`` where none did), seconds each."""
    by_op = defaultdict(float)
    for n, s, e in sl.device:
        by_op[n[:160]] += e - s
    busy = merged([(s, e) for _, s, e in sl.device])
    edges = [sl.start] + [x for span in busy for x in span] + [sl.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    by_host = defaultdict(float)
    for (s, e), name in zip(gaps, innermost(
            sl.host, [0.5 * (s + e) for s, e in gaps])):
        by_host[name[:160]] += e - s
    pick = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(by_op), "idle_gaps": pick(by_host)}
