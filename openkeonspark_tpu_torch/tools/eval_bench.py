"""Link-prediction evaluation throughput per model (test triples/s).

Counterpart of ``tools/eval_bench.py`` (``:38-132``): the full evaluator
(both directions, raw + filtered) at d=200 on ``random_kg`` 14,541 / 237
/ 272,115 with ``--n_test`` (20,000) test triples, per model and
``eval_dtype``, tables from a seed. One warm-up evaluation of the same
shape, then ``--repeats`` timed ones (host clock after
``torch.cuda.synchronize()``); the median, with min / max as the spread,
and ``filt_mr`` (random tables: near n_ent / 2; far smaller flags a
counting fault). The routes are ``eval/link_prediction.py::eval_route``'s:
B1 (TransE), B2 (TransD), B3 (RotatE), B1 relation by relation on
projected tables (TransR, TransH); ``--no-pallas`` sends every model to
the generic route (no kernel). Each line carries the rank kernels'
launches of one evaluation (0 on the CPU, whose plain versions launch
nothing).

The JAX tool's anchor, ``bench_eval_anchor.json``, holds TPU medians and
is never read. ``--write-anchor`` merges this run's medians into
``bench_eval_anchor_torch.json`` at the repository root, with the device
they were taken on; a later run on the same device prints ``vs_anchor``.

Usage: python -m openkeonspark_tpu_torch.tools.eval_bench
           [--models transe,transh,transr,transd,rotate]
           [--dtypes float32,bfloat16] [--repeats 5] [--write-anchor]
           [--device cuda]
Prints one JSON line per (model, dtype).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, random_kg
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.tools import (add_device_flag, clock,
                                           launch_counts, launched_since,
                                           open_device)
from openkeonspark_tpu_torch.train.step import init_state

ANCHOR_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "bench_eval_anchor_torch.json")


def eval_dataset(n_test: int):
    return random_kg(n_ent=14541, n_rel=237, n_triples=272115,
                     n_valid=1000, n_test=n_test, seed=7)


def eval_config(name: str, eval_chunk=None, eval_block=None,
                no_pallas=False) -> Config:
    cfg = Config(model=name, hidden_size=200)
    if name == "transr":
        cfg = cfg.replace(ent_size=200, rel_size=100)
    if eval_chunk is not None:
        cfg = cfg.replace(eval_chunk=eval_chunk)
    if eval_block is not None:
        cfg = cfg.replace(eval_block=eval_block)
    if no_pallas:
        cfg = cfg.replace(use_pallas_eval=False)
    return cfg


def eval_tables(cfg: Config, ds, dev: torch.device):
    """The seeded tables a model is evaluated on (the same on every
    device)."""
    return init_state(get_model(cfg.model), cfg, ds.n_ent, ds.n_rel,
                      torch.Generator().manual_seed(3), dev).params


def bench_eval(params, cfg: Config, ds, idx, dev, repeats: int):
    """(record, the last LinkPredictionResult) of one (model, dtype)."""
    before = launch_counts()
    res = link_prediction(params, cfg, ds, idx, triples=ds.test)   # warm
    launches = launched_since(before)
    rates = []
    for _ in range(repeats):
        t0 = clock(dev)
        res = link_prediction(params, cfg, ds, idx, triples=ds.test)
        rates.append(len(ds.test) / (clock(dev) - t0))
    med = statistics.median(rates)
    rec = {
        "model": cfg.model, "eval_dtype": cfg.eval_dtype,
        "n_test": int(len(ds.test)), "n_ent": ds.n_ent,
        "triples_per_sec": round(med, 1),
        "spread": [round(min(rates), 1), round(max(rates), 1)],
        "repeats": repeats,
        "filt_mr": round(res.filt_avg.mr, 1),
        "launches_per_eval": launches,
    }
    return rec, res


def merge_anchor(path: str, device: str, n_test: int, repeats: int,
                 medians: dict) -> dict:
    """Merge ``medians`` into the anchor file at ``path`` and write it
    back: the other models' medians stay when they were taken on the same
    device, and are dropped otherwise."""
    anchor = {}
    if os.path.exists(path):
        with open(path) as f:
            anchor = json.load(f)
        if anchor.get("device") != device:
            anchor = {}
    anchor.update({"device": device, "n_test": n_test, "repeats": repeats})
    anchor.setdefault("medians", {}).update(medians)
    with open(path, "w") as f:
        json.dump(anchor, f, indent=1)
    return anchor


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models",
                    default="transe,transh,transr,transd,rotate")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--n_test", type=int, default=20000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--write-anchor", action="store_true",
                    help="merge the medians into the port's anchor file")
    ap.add_argument("--eval-chunk", type=int, default=None,
                    help="override cfg.eval_chunk (sweep knob)")
    ap.add_argument("--eval-block", type=int, default=None)
    ap.add_argument("--no-pallas", action="store_true",
                    help="the generic route, no rank kernel (sweep knob)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)

    ds = eval_dataset(args.n_test)
    idx = build_kg_index(ds, for_eval=True)
    anchor = {}
    if os.path.exists(ANCHOR_PATH):
        with open(ANCHOR_PATH) as f:
            anchor = json.load(f)
    same_card = anchor.get("device") == label

    out, medians = [], {}
    for name in args.models.split(","):
        cfg0 = eval_config(name, args.eval_chunk, args.eval_block,
                           args.no_pallas)
        params = eval_tables(cfg0, ds, dev)
        for dt in args.dtypes.split(","):
            rec, _ = bench_eval(params, cfg0.replace(eval_dtype=dt), ds,
                                idx, dev, args.repeats)
            key = f"{name}/{dt}"
            medians[key] = rec["triples_per_sec"]
            a = anchor.get("medians", {}).get(key) if same_card else None
            if a:
                rec["anchor"] = a
                rec["vs_anchor"] = round(rec["triples_per_sec"] / a, 3)
            rec["device"] = label
            print(json.dumps(rec), flush=True)
            out.append(rec)

    if args.write_anchor:
        merge_anchor(ANCHOR_PATH, label, args.n_test, args.repeats, medians)
        print(f"# anchor written to {ANCHOR_PATH}", flush=True)
    return out


if __name__ == "__main__":
    main()
