"""Per-device memory budget of a (model, shape, grid): sharded tables,
optimizer slots, the replicated sampler store, hot companions and the
exchange workspace, against the card's memory.

Counterpart of ``tools/hbm_budget.py`` (``budget`` ``:42-83``, ``main``
``:86-110``), with the same per-device formula. Two of its inputs are
the card's and the port's own, not the TPU's constants:

- the device memory is ``torch.cuda.get_device_properties(dev)
  .total_memory``; with ``--device cpu`` there is no card, so the rows
  carry no ``hbm_frac`` / ``fits``;
- the sampler store's bytes per triple are measured with
  ``DeviceSampler.store_bytes()`` on the port's own store (int64 records
  and windows), built from a ``random_kg`` of the configuration's
  vocabulary and at most 200,000 of its triples (:data:`STORE_SAMPLE`).

Usage: python -m openkeonspark_tpu_torch.tools.hbm_budget [--config 5]
           [--mesh 2x2x2] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from openkeonspark_tpu_torch.tools import add_device_flag, open_device

CONFIG5 = dict(model="transe", d=256, n_ent=2_000_000, n_rel=4000,
               n_train=10_000_000, batch_per_dev=10000)
CONFIG2 = dict(model="transe", d=200, n_ent=14541, n_rel=237,
               n_train=272115, batch_per_dev=2721)

OPT_SLOTS = {"sgd": 0, "adam": 2, "adagrad": 1, "adadelta": 2}
STORE_SAMPLE = 200_000     # triples of the store whose bytes are measured


def budget(spec, mesh, opt="sgd", hot_rows=0, wire_bytes=2,
           microbatches=2, slack_rows=1.25, *, store_b_per_triple: float,
           hbm_bytes: Optional[float]):
    """One row of the ledger: the JAX tool's formula, with the sampler
    store's bytes per triple and the device memory passed in (no
    ``hbm_frac`` / ``fits`` when ``hbm_bytes`` is None)."""
    n_grid = 1
    for s in mesh:
        n_grid *= s
    if len(mesh) == 3:
        H, Di, M = mesh
    else:
        H, (Di, M) = 1, mesh
    d = spec["d"]
    rows = -(-spec["n_ent"] // n_grid) * n_grid
    slots = OPT_SLOTS[opt]
    ent_table = rows * d * 4 / n_grid * (1 + slots)
    rel_table = spec["n_rel"] * d * 4 * (1 + slots) / min(n_grid,
                                                          spec["n_rel"])
    store = spec["n_train"] * store_b_per_triple
    hot = hot_rows * d * 4 * (1 + slots)
    # exchange workspace: per microbatch chunk, gather + update streams of
    # ~4*b_sub ids each -> dedup scratch (2 sorts x 8 B) + bucketed a2a
    # buffers (<= stream x d x wire both stages), the peak of one chunk
    d_glob = H * Di
    b_sub = spec["batch_per_dev"] * n_grid // d_glob // M // microbatches
    stream = 4 * b_sub
    workspace = (stream * 16                      # dedup sort scratch
                 + 2 * stream * d * wire_bytes    # stage-1 a2a in+out
                 + 2 * stream * d * wire_bytes    # stage-2 a2a in+out
                 + stream * d * 4) * slack_rows   # f32 accum copies
    total = ent_table + rel_table + store + hot + workspace
    row = {
        "mesh": "x".join(map(str, mesh)), "devices": n_grid, "opt": opt,
        "ent_table_MB": round(ent_table / 1e6, 1),
        "rel_table_MB": round(rel_table / 1e6, 1),
        "sampler_store_MB": round(store / 1e6, 1),
        "hot_companions_MB": round(hot / 1e6, 1),
        "exchange_workspace_MB": round(workspace / 1e6, 1),
        "total_MB": round(total / 1e6, 1),
    }
    if hbm_bytes is not None:
        row["hbm_frac"] = round(total / hbm_bytes, 3)
        row["fits"] = total < 0.9 * hbm_bytes
    return row


def store_bytes_per_triple(spec, n_sample: int = STORE_SAMPLE) -> float:
    """Bytes a training triple costs the port's device sampler: its
    ``store_bytes()`` over its triples, for a ``random_kg`` of the
    configuration's vocabulary and ``min(n_train, n_sample)`` triples
    (built on the CPU: the layout, not the device, sets the bytes)."""
    from openkeonspark_tpu_torch.data import build_kg_index, random_kg
    from openkeonspark_tpu_torch.sampling.device import DeviceSampler
    ds = random_kg(n_ent=spec["n_ent"], n_rel=spec["n_rel"],
                   n_triples=min(spec["n_train"], n_sample), n_valid=0,
                   n_test=0, seed=7)
    store = DeviceSampler.build(ds, build_kg_index(ds, for_eval=False),
                                torch.device("cpu"))
    return store.store_bytes() / ds.n_train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", type=int, default=5, choices=[2, 5])
    ap.add_argument("--mesh", default="")
    ap.add_argument("--opt", default="sgd", choices=sorted(OPT_SLOTS))
    ap.add_argument("--hot-rows", type=int, default=4096)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    spec = CONFIG5 if args.config == 5 else CONFIG2
    hbm = (torch.cuda.get_device_properties(dev).total_memory
           if dev.type == "cuda" else None)
    per_triple = store_bytes_per_triple(spec)

    meshes = ([tuple(int(x) for x in args.mesh.split("x"))] if args.mesh
              else [(1, 1), (2, 2), (2, 2, 2), (4, 2, 2)])
    rows = [budget(spec, m, opt=args.opt, hot_rows=args.hot_rows
                   if len(m) == 3 else 0, store_b_per_triple=per_triple,
                   hbm_bytes=hbm) for m in meshes]
    print("| mesh | devices | ent tbl | rel tbl | store | hot | "
          "workspace | total | HBM frac | fits |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        frac = f"{r['hbm_frac']:.1%}" if "hbm_frac" in r else "no card"
        fits = ("yes" if r["fits"] else "NO") if "fits" in r else "no card"
        print(f"| {r['mesh']} | {r['devices']} | {r['ent_table_MB']} | "
              f"{r['rel_table_MB']} | {r['sampler_store_MB']} | "
              f"{r['hot_companions_MB']} | {r['exchange_workspace_MB']} | "
              f"{r['total_MB']} MB | {frac} | {fits} |")
    out = {"config": args.config, "opt": args.opt,
           "store_B_per_triple": per_triple, "hbm_bytes": hbm,
           "device": label, "rows": rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
