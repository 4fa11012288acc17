"""The port's tools: benchmarks, breakdowns, quality anchors, the
acceptance runbook, probes and dataset helpers, one module each, run as

    python -m openkeonspark_tpu_torch.tools.<name> [flags]

Each is the counterpart of the JAX package's tool of the same name under
``tools/`` and keeps its flags and JSON keys. A tool that runs on a device
adds ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path)
and a ``"device"`` key: the card's name and power limit as ``nvidia-smi``
reads them, or ``"cpu"``. No tool falls back to the CPU when the card is
missing. Timings read the host clock after ``torch.cuda.synchronize()``:
where the JAX tool fused S steps into one program, the port runs the same
S steps eagerly, so the host's launch time is part of what it measures.
Every ``main(argv=None)`` returns what it printed, for callers in Python.

The shared helpers below resolve the device, label it and time work on
it."""

from __future__ import annotations

import argparse
import subprocess
import time
from typing import Callable, Dict, Optional

import torch

from openkeonspark_tpu_torch.runtime import resolve_device


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu); no fallback")


def device_label(dev: torch.device) -> str:
    """``"name, power limit"`` of the card (``nvidia-smi``), or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[dev.index or 0].strip()


def open_device(name: str):
    """(device, label) of the ``--device`` flag; raises when a card is
    asked for and there is none."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev, device_label(dev)


def clock(dev: torch.device) -> float:
    """The host clock once the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def timed_best(fn: Callable, dev: torch.device, repeats: int = 3) -> float:
    """Best seconds of ``repeats`` calls of ``fn()`` after one untimed call
    (the kernel build and first allocations)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = clock(dev)
        fn()
        best = min(best, clock(dev) - t0)
    return best


def launch_counts() -> Dict[str, int]:
    """A snapshot of every kernel wrapper's launch counter
    (``ops/rank.py``, ``ops/grouped.py``, ``ops/scatter.py``,
    ``ops/merge.py``, ``ops/rotate_train.py``)."""
    from openkeonspark_tpu_torch.ops import (grouped, merge, rank,
                                             rotate_train, scatter)
    return {k: v for mod in (rank, grouped, scatter, merge, rotate_train)
            for k, v in mod.LAUNCHES.items()}


def launched_since(before: Dict[str, int]) -> Dict[str, int]:
    """The kernels launched since the snapshot ``before``, with their
    counts (counters are read, never reset, so a caller's own count of
    the same calls stays whole)."""
    now = launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def device_ms(fn: Callable, dev: torch.device) -> Optional[float]:
    """Device milliseconds of one call of ``fn()`` under torch.profiler
    (the kernels' and copies' device time), or None on the CPU. A process
    launches more slowly once the profiler has traced, so callers take
    this after their timings."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t and "cuda" in str(e.device_type).lower():
            total += t
    return total / 1e3
