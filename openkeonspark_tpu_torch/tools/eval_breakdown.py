"""Per-stage link-prediction time: where an evaluation's time goes between
the card and the host.

Counterpart of ``tools/eval_breakdown.py`` (``:48-209``). Cumulative
prefixes of the tail direction's per-chunk pipeline of TransE link
prediction — known windows (``eval/link_prediction.py::known_matrix``
over ``known_windows``) → queries (``ops/rank.py::transe_queries``) →
gold scores (``transe_candidate_scores``, B1's id scorer) → candidate
sweep (``count_better_transe``, B1) → known-true filter — each run over
every chunk of the test triples, timed with the host clock after
``torch.cuda.synchronize()``; the isolated count at the evaluator's shape
(chunk 0's queries, as many launches as chunks); and the end-to-end
``link_prediction``. Both directions run the same pipeline, so the JAX
tool takes the host's share as the end-to-end time less twice the last
prefix; in the port the prefixes are eager and pay their own launches,
so that difference can fall below zero, and the summary also carries the
end-to-end evaluation's device time from ``torch.profiler`` (taken last)
and its share of the unprofiled wall time. The JAX tool's TPU layouts
(``Packed1D``, ``prepare_table``) have no counterpart.

Usage: python -m openkeonspark_tpu_torch.tools.eval_breakdown
           [--n-test 2048] [--chunk 0 (= the port's default)]
           [--device cuda]
Prints one JSON line per measurement + a summary line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import H, R, T, build_kg_index, random_kg
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.eval.link_prediction import (known_matrix,
                                                          known_windows)
from openkeonspark_tpu_torch.models import TransE, init_tables
from openkeonspark_tpu_torch.ops import rank as rank_ops
from openkeonspark_tpu_torch.runtime import eval_chunk_size
from openkeonspark_tpu_torch.tools import (add_device_flag, device_ms,
                                           launch_counts, launched_since,
                                           open_device, timed_best)

STAGES = ("filter_windows", "query_prep", "gold_scores", "candidate_sweep",
          "known_filter")


def chunk_pipeline(params, cfg, triples, index, n_ent, dev):
    """(stage name → ``run()`` summing that prefix over every chunk of the
    tail direction, chunk count, chunk, k_max, chunk 0's count inputs)."""
    chunk = eval_chunk_size(cfg)
    offs, k_max, vals_t, _ = known_windows(index, triples, dev)
    offt, cntt = offs[0], offs[1]
    n = len(triples)
    pad = (-n) % chunk
    nc = (n + pad) // chunk

    def chunks(a, dtype=torch.int32):
        a = np.concatenate([a, np.repeat(a[:1], pad)]) if pad else a
        return torch.from_numpy(np.ascontiguousarray(
            a.reshape(nc, chunk))).to(dev, dtype)

    h, t, r = (chunks(triples[:, k]) for k in (H, T, R))
    ot, ct = chunks(offt), chunks(cntt)
    E = params["ent_embeddings"]
    rows, p = E.shape[0], cfg.p_norm

    def prefix(depth):
        def stage(c):
            kn = known_matrix(vals_t, ot[c], ct[c], k_max, rows)
            acc = kn.sum().float()
            if depth == 0:
                return acc
            q, sign = rank_ops.transe_queries(params, h[c].long(),
                                              t[c].long(), r[c].long(),
                                              "tail")
            if depth == 1:
                return acc + q.sum()
            gold = rank_ops.transe_candidate_scores(q, E, t[c], sign, p)
            if depth == 2:
                return acc + gold.sum()
            raw = rank_ops.count_better_transe(q, E, gold, t[c], sign, p,
                                               n_ent)
            if depth == 3:
                return acc + raw.sum().float()
            ks = rank_ops.transe_candidate_scores(q, E, kn, sign, p)
            kvalid = (kn < n_ent) & (kn != t[c][:, None])
            kb = ((ks < gold[:, None]) & kvalid).sum(1, dtype=torch.int32)
            return acc + (raw - kb).sum().float()

        def run():
            acc = torch.zeros((), device=dev)
            for c in range(nc):
                acc += stage(c)
            return acc
        return run

    q0, sign0 = rank_ops.transe_queries(params, h[0].long(), t[0].long(),
                                        r[0].long(), "tail")
    gold0 = rank_ops.transe_candidate_scores(q0, E, t[0], sign0, p)
    first = (q0, E, gold0, t[0], sign0, p, n_ent)
    return ({name: prefix(i) for i, name in enumerate(STAGES)}, nc, chunk,
            k_max, first)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-test", type=int, default=2048)
    ap.add_argument("--n-ent", type=int, default=14541)
    ap.add_argument("--d", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=0,
                    help="eval chunk (0 = the port's default)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    lines = []

    def emit(rec):
        rec["device"] = label
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    ds = random_kg(n_ent=args.n_ent, n_rel=237, n_triples=272115,
                   n_valid=1000, n_test=max(1000, args.n_test), seed=7)
    cfg = Config(model="transe", hidden_size=args.d,
                 eval_chunk=args.chunk or None)
    index = build_kg_index(ds, for_eval=True)
    params = init_tables(torch.Generator().manual_seed(0),
                         TransE.tables(cfg, ds.n_ent, ds.n_rel), dev)
    triples = ds.test[: args.n_test]
    n = len(triples)
    before = launch_counts()
    runs, nc, chunk, k_max, first = chunk_pipeline(params, cfg, triples,
                                                   index, ds.n_ent, dev)

    cum = {}
    with torch.no_grad():
        for name, run in runs.items():
            cum[name] = timed_best(run, dev)
            emit({"stage": name,
                  "ms_per_direction": round(cum[name] * 1e3, 2)})

        def iso_kernel():
            acc = torch.zeros((), device=dev)
            for _ in range(nc):
                acc += rank_ops.count_better_transe(*first).sum().float()
            return acc

        t_iso = timed_best(iso_kernel, dev)
    kernel_scores_s = nc * chunk * ds.n_ent / t_iso
    emit({"stage": "isolated_kernel_same_shapes",
          "ms_per_direction": round(t_iso * 1e3, 2),
          "scores_per_sec": round(kernel_scores_s / 1e9, 2)})

    def e2e():
        return link_prediction(params, cfg, ds, index, triples=triples)

    best = timed_best(e2e, dev)
    e2e_tps = n / best
    launches = launched_since(before)
    dms = device_ms(e2e, dev)        # profiled last
    prev, attr = 0.0, {}
    for name in STAGES:
        attr[name] = cum[name] - prev
        prev = cum[name]
    host = best - 2 * cum["known_filter"]
    emit({
        "model": "transe", "d": args.d, "n_ent": ds.n_ent,
        "n_test": n, "chunk": chunk, "k_max": k_max,
        "ms_attributed_per_direction": {k: round(v * 1e3, 2)
                                        for k, v in attr.items()},
        "ms_host_and_dispatch": round(host * 1e3, 2),
        "end_to_end_triples_per_sec": round(e2e_tps, 1),
        "end_to_end_scores_per_sec_G": round(e2e_tps * 2 * ds.n_ent / 1e9,
                                             2),
        "isolated_kernel_scores_per_sec_G": round(kernel_scores_s / 1e9, 2),
        "kernel_share_of_direction": round(
            attr["candidate_sweep"] / cum["known_filter"], 3),
        "end_to_end_device_ms": None if dms is None else round(dms, 2),
        "end_to_end_device_busy": (None if dms is None
                                   else round(dms / (best * 1e3), 3)),
        "launches": launches,
    })
    return lines


if __name__ == "__main__":
    main()
