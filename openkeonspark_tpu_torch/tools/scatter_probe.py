"""Scatter-floor probe: narrow-row scatter-add variants at the flagship
shapes on one device.

Counterpart of ``tools/scatter_probe.py`` (``:39-200``): the same shapes
(``SHAPES``), Zipf skew and random relabelling of the id stream, K
scatter applications a timed run (the table updated in place, ids varying
per application), median of ``--repeats`` runs, less the no-op floor.
Variants:

- ``xla_scatter``: the port's scatter for narrow rows, a masked
  ``index_add_`` (``train/optim.py::scatter_add_rows``), the counterpart
  of the JAX tool's XLA scatter; its atomics add in no fixed order;
- ``sgd_sum``: the port's SGD path for narrow tables (``train/optim.py::
  add_rows_summed``: a step's deltas summed per row in a dense fp32
  table, each sum added once);
- ``b5``: kernel B5, the sorted-run scatter
  (``ops/scatter.py::scatter_add_rows_sorted``), checked bit for bit
  against its plain version at the probe's shape before it is timed, and
  its launches a run counted;
- ``sort_gather``: the entry fee of every sorted-run variant (stable sort
  of the ids, the deltas gathered in that order, one row consumed);
- the no-op floor: one step that only nudges the table's first row
  (the variants update in place, so no step pays for a table pass).

Each variant's ``max_rel_err`` is its table after one run against a
float64 sum of the same K applications. The JAX tool's ``tile_mxu_scatter``
(``:46-87``, with its ``--tile`` / ``--smax``) is not ported: it is a
workaround that aggregates sorted segments as one-hot matrix products on
the TPU's MXU because the TPU's scatter pays a fixed cost a row; on the
card the sorted-run kernel B5 and the masked ``index_add_`` are the
candidates.

Usage: python -m openkeonspark_tpu_torch.tools.scatter_probe
           [--shape flagship|config1|transd|big] [--skew 0.8] [--scan 100]
           [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from openkeonspark_tpu_torch.ops import scatter as scatter_ops
from openkeonspark_tpu_torch.tools import (add_device_flag, clock,
                                           launch_counts, launched_since,
                                           open_device)
from openkeonspark_tpu_torch.train.optim import (add_rows_summed,
                                                 scatter_add_rows)

SHAPES = {
    # (rows, d, stream): stream = merged update rows per step
    "flagship": (14541, 200, 3 * 2721),    # config #2 TransE ent updates
    "config1": (3000, 64, 3 * 400),
    "transd": (14541, 200, 6 * 2721),
    "big": (2_000_000, 256, 3 * 10000),    # config #5 scale
}


def noop(table, ids, delta):
    table[:1].add_(ids[:1, None].to(table.dtype), alpha=1e-12)


def sort_gather(table, ids, delta):
    order = torch.sort(ids, stable=True).indices
    table[:1].add_(delta[order][:1])


VARIANTS = {
    "xla_scatter": scatter_add_rows,
    "sgd_sum": add_rows_summed,
    "b5": scatter_ops.scatter_add_rows_sorted,
    "sort_gather": sort_gather,
}


def id_stream(rows, stream, K, skew, seed=1):
    """[K, stream] int64 ids: Zipf(``skew``) popularity (uniform at 0),
    hub ids spread over the table by a random relabelling."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        w = 1.0 / np.arange(1, rows + 1, dtype=np.float64) ** skew
        w /= w.sum()
        ids = rng.choice(rows, size=(K, stream), p=w)
    else:
        ids = rng.integers(0, rows, size=(K, stream))
    return rng.permutation(rows)[ids].astype(np.int64)


def apply_all(fn, table, ids_all, delta):
    for k in range(ids_all.shape[0]):
        fn(table, ids_all[k], delta)
    return table


def probe(rows, d, stream, K, skew, dev, repeats=5):
    """The probe's record at one shape (times in seconds a step)."""
    ids_all = torch.from_numpy(id_stream(rows, stream, K, skew)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    table0 = torch.randn(rows, d, generator=g, device=dev)
    delta = torch.randn(stream, d, generator=g, device=dev)

    ref = table0.double()
    for k in range(K):
        ref.index_add_(0, ids_all[k], delta.double())
    scale = float(ref.abs().max())

    before = launch_counts()
    first = {name: apply_all(fn, table0.clone(), ids_all, delta)
             for name, fn in VARIANTS.items() if name != "sort_gather"}
    b5_launches = launched_since(before).get("scatter_add_rows_sorted", 0)
    plain = apply_all(scatter_ops.scatter_add_rows_sorted_ref,
                      table0.clone(), ids_all, delta)
    b5_equal = torch.equal(first["b5"].view(torch.int32),
                           plain.view(torch.int32))
    errs = {name: float((out.double() - ref).abs().max()) / max(scale, 1e-9)
            for name, out in first.items()}
    del first, plain, ref

    def timed(fn):
        work = table0.clone()
        apply_all(fn, work, ids_all, delta)              # warm
        ts = []
        for _ in range(repeats):
            t0 = clock(dev)
            apply_all(fn, work, ids_all, delta)
            ts.append((clock(dev) - t0) / K)
        return statistics.median(ts)

    floor = timed(noop)
    times = {name: max(timed(fn) - floor, 1e-9)
             for name, fn in VARIANTS.items()}
    return times, floor, errs, b5_equal, b5_launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="flagship", choices=sorted(SHAPES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--scan", type=int, default=100)
    ap.add_argument("--skew", type=float, default=0.8,
                    help="Zipf exponent of the id stream (0 = uniform)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    rows, d, stream = SHAPES[args.shape]
    times, floor, errs, b5_equal, b5_launches = probe(
        rows, d, stream, args.scan, args.skew, dev, args.repeats)
    rec = {"shape": args.shape, "rows": rows, "d": d, "stream": stream,
           "skew": args.skew, "scan": args.scan}
    for name, key in (("xla_scatter", "xla"), ("sgd_sum", "sgd_sum"),
                      ("b5", "b5")):
        rec[f"{name}_us"] = round(times[name] * 1e6, 2)
        rec[f"{key}_ns_per_row"] = round(times[name] / stream * 1e9, 2)
    rec.update({
        "speedup_b5": round(times["xla_scatter"] / times["b5"], 3),
        "sort_gather_us": round(times["sort_gather"] * 1e6, 2),
        "noop_floor_us": round(floor * 1e6, 2),
        "max_rel_err": errs,
        "b5_equals_plain": b5_equal,
        "b5_launches": b5_launches,
        "device": label,
    })
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
