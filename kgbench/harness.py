"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

Everything a cell is made of is found by name in files of the benchmark:
the cell in ``workloads/<cell>.json`` (configuration, traffic, chips,
the compared numbers' limits and the control), the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``
(which may set configuration keys too) run by ``traffic/<kind>.py``, and
each per-layer metric's reader in ``metrics/<metric>.py``.
``BENCHMARK.json`` says which metrics a cell reports. A new cell,
configuration, mix or metric is a new file and a new entry."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import ExitStack
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "openkeonspark_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> dict:
    """The cell's workload file with its configuration and traffic mix."""
    w = read_json(HERE / "workloads" / f"{name}.json")
    return {"workload": w,
            "config": read_json(HERE / "configs" / f"{w['config']}.json"),
            "mix": read_json(HERE / "traffic" / f"{w['traffic']}.json")}


def traffic_module(kind: str):
    return importlib.import_module(f"kgbench.traffic.{kind}")


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "kgbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) entries of ``bench`` that ``cell`` reports.
    An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one without it is reported wherever the metric it moves
    is."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names
                              else [])]
    return e2e, layer


def process_start() -> float:
    """The epoch second this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[0].strip() if out else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def execute(cell: str, seed: int, seconds: float, trace: bool, device,
            control: bool = False, faults: tuple = (),
            overrides: Optional[dict] = None,
            started: Optional[float] = None) -> dict:
    """Run ``cell`` once and return its result record (not printed).
    ``overrides`` replaces keys of the configuration and the mix (the
    tests' small sizes); ``control`` and ``faults`` are for the
    calibration and the tests."""
    import torch
    from kgbench import trace as tr
    from kgbench.common import Run, sync

    started = process_start() if started is None else started
    files = load_cell(cell)
    over = overrides or {}
    # a mix may set configuration keys of its own (a mix of 16 negatives)
    run = Run(workload=files["workload"],
              config={**files["config"], **files["mix"].get("config", {}),
                      **over.get("config", {})},
              mix={**files["mix"], **over.get("mix", {})},
              seed=seed, device=torch.device(device), control=control,
              faults=tuple(faults))
    mod = traffic_module(run.mix["kind"])
    e2e_specs, layer_specs = cell_metrics(benchmark(), cell)
    dev = run.device
    if run.cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)

    with ExitStack() as stack:
        for f in run.faults:
            mod.FAULTS[f](run, stack)
        traffic = mod.Traffic(run)
        t_prepare = time.time()
        traffic.prepare()
        sync(dev)
        setup_s = time.time() - started
        t0 = time.perf_counter()
        units, ends = 0, []
        while True:
            traffic.unit()
            units += 1
            sync(dev)
            elapsed = time.perf_counter() - t0
            ends.append(elapsed)
            if elapsed >= seconds:
                break
        measured = traffic.e2e(elapsed, units)
        sl = None
        if trace:
            n = run.mix["trace_units"]
            sl = tr.profile(traffic.unit, n, traffic.counts(n), run.cuda)
        peak = torch.cuda.max_memory_allocated(dev) if run.cuda else 0
        traffic.free()
        if run.cuda:
            torch.cuda.empty_cache()
        checks = traffic.compare()
        shapes = traffic.shapes()

    limits = run.workload["limits"]
    record = {"correct": all(checks[k] <= limits[k] for k in limits),
              "attempted": traffic.counts(units)[traffic.unit_name],
              "failed": 0}
    metrics = {}
    if trace:
        ctx = SimpleNamespace(slice=sl, shapes=shapes, window_s=elapsed,
                              window=traffic.counts(units))
        for m in layer_specs:
            v = metric_reader(m["name"])(ctx)
            if v is None:
                continue
            # a share of a peak or a roofline comes with the bound that
            # sets it ("bytes" or "operations")
            v, bound = v if isinstance(v, tuple) else (v, None)
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
            if bound:
                metrics[m["name"]]["bound"] = bound
    else:
        have = {**measured, "setup_s": setup_s}
        for m in e2e_specs:
            metrics[m["name"]] = {"value": float(have[m["name"]]),
                                  "unit": m["unit"]}
    record["metrics"] = metrics
    record["device"] = {
        "platform": "gpu" if run.cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if run.cuda else "cpu",
        "count": run.workload["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        record["device"].update(busy_s=sl.busy_s(), window_s=sl.window_s)
        record["breakdown"] = tr.breakdown(sl)
    record["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    record["_notes"] = {"units": units, "window_s": elapsed, "checks": checks,
                        "setup_s": setup_s,
                        "before_prepare_s": t_prepare - started,
                        "unit_s": [b - a for a, b in zip([0.0] + ends, ends)],
                        "last_loss": getattr(traffic, "last_loss", None)}
    return record


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Run one cell of the benchmark once and print its "
                    "result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()

    import torch
    chips = read_json(HERE / "workloads" / f"{args.workload}.json")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kgbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    rec = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda:0", started=started)
    bad = banned_modules()
    if bad:
        print(f"kgbench: the run loaded {', '.join(bad)}; the port and "
              "the benchmark must not import them", file=sys.stderr)
        return 3
    notes = rec.pop("_notes")
    rec["device"]["power_limit"] = power_limit()
    checks = rec.pop("checks")
    rec["checks"] = checks          # the compared numbers come last
    u = sorted(notes["unit_s"])
    q = [1e3 * u[int(f * (len(u) - 1))] for f in (0.25, 0.5, 0.75)]
    print(f"kgbench: {args.workload} seed {args.seed}: {notes['units']} "
          f"units in {notes['window_s']:.3f} s (a unit's ms, quartiles: "
          f"{q[0]:.3f} {q[1]:.3f} {q[2]:.3f}), set-up "
          f"{notes['setup_s']:.3f} s ({notes['before_prepare_s']:.3f} s "
          f"before the traffic's set-up), last loss {notes['last_loss']}",
          file=sys.stderr)
    print(json.dumps(rec), flush=True)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0
