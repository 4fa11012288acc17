"""Real-data acceptance runbook: the five BASELINE configs end to end —
train, evaluate, gate filtered MRR / Hits@10 against the literature's
ranges — and one pass/fail table.

Counterpart of ``tools/acceptance.py`` (``CONFIGS`` ``:45-67``,
``make_stand_ins`` ``:69-97``, ``run_config`` ``:100-191``, ``main``
``:194-251``), with the same runbook and gates. Until the real splits are
on disk, ``--stand-in`` writes planted synthetic stand-ins in the same
OpenKE text layout and runs the identical pipeline with ceiling-aware
gates:

    python -m openkeonspark_tpu_torch.tools.acceptance --data-root /data/kge
      # expects <root>/fb15k237, <root>/wn18rr, <root>/fb15k,
      #         <root>/fb15k237_subset (optional), <root>/dbpedia (cfg 5)

| cfg | dataset | model | gate |
|---|---|---|---|
| 1 | FB15K-237 subset | TransE d=64 | loss decreases ≥3× (parity cfg) |
| 2 | FB15K-237 | TransE d=200 | filt MRR ≥ 0.26, Hits@10 ≥ 0.42 |
| 3 | WN18RR | TransH d=200 | filt Hits@10 ≥ 0.35 |
| 4 | FB15K | TransR 200/100 | filt Hits@10 ≥ 0.55 |
| 5 | DBpedia-scale | TransE d=256 | multi-device train runs; ≥1M t/s |

Config 5's multi-device run is ``--ranks N`` processes of
``cli.launch`` on a (N/2, 2) grid (hierarchical with N/2 ranks a host, as
the JAX tool's mesh): gloo with ``--device cpu``, NCCL with one card a
rank on ``--device cuda``, where the JAX tool took ``--cpu-devices N``
virtual devices. With fewer than two ranks, or more ranks than cards, it
SKIPs, as the JAX tool does on one device. Exit code 1 on any FAIL.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import (build_kg_index, load_dataset,
                                          planted_kg, random_kg,
                                          save_dataset)
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.tools import add_device_flag, open_device
from openkeonspark_tpu_torch.train.loop import train

CONFIGS = [
    dict(n=1, dataset="fb15k237_subset", model="transe", d=64,
         alpha=0.01, margin=1.0, neg=1, bern=False, epochs=50, nbatches=50,
         gates={}, note="per-step parity config; gate = loss falls >=3x"),
    dict(n=2, dataset="fb15k237", model="transe", d=200,
         alpha=0.01, margin=1.0, neg=1, bern=True, epochs=500, nbatches=100,
         gates={"filt_mrr": 0.26, "filt_hits10": 0.42},
         note="lit. anchors 0.28-0.31 MRR / 0.44-0.47 H@10 (BASELINE 0)"),
    dict(n=3, dataset="wn18rr", model="transh", d=200,
         alpha=0.01, margin=2.0, neg=1, bern=True, epochs=500, nbatches=100,
         gates={"filt_hits10": 0.35},
         note="TransE-family WN18RR reproductions land ~0.40-0.50 H@10"),
    dict(n=4, dataset="fb15k", model="transr", d=200, d_rel=100,
         alpha=0.01, margin=1.0, neg=1, bern=True, epochs=500, nbatches=100,
         gates={"filt_hits10": 0.55},
         note="TransR paper FB15K filtered H@10 0.687"),
    dict(n=5, dataset="dbpedia", model="transe", d=256,
         alpha=0.01, margin=1.0, neg=1, bern=True, epochs=3, nbatches=100,
         gates={"min_tps": 1e6}, multi_device=True,
         note="edge-partitioned >=2 devices; throughput gate, no lit "
              "quality anchor exists for arbitrary DBpedia snapshots"),
]
RANKS_TIMEOUT = 1800       # seconds config 5's ranks may take


def make_stand_ins(root: str, quick: bool):
    """Planted-structure stand-ins in the real text layout, the files the
    JAX tool writes (the sizes exercise the harness; quality_anchors owns
    quality)."""
    s = 0.25 if quick else 1.0
    specs = {
        "fb15k237_subset": dict(n_ent=300, n_rel=8, n_triples=6000),
        "fb15k237": dict(n_ent=int(2000 * s) or 400, n_rel=30,
                         n_triples=int(40000 * s) or 8000),
        "wn18rr": dict(n_ent=int(2000 * s) or 400, n_rel=11,
                       n_triples=int(30000 * s) or 6000),
        "fb15k": dict(n_ent=int(2000 * s) or 400, n_rel=30,
                      n_triples=int(40000 * s) or 8000),
        "dbpedia": dict(),
    }
    for name, sp in specs.items():
        d = os.path.join(root, name)
        if os.path.exists(os.path.join(d, "train2id.txt")):
            continue
        if name == "dbpedia":
            ds = random_kg(n_ent=3000, n_rel=40, n_triples=60000,
                           n_valid=500, n_test=500, seed=11)
        else:
            ds = planted_kg(**sp, n_valid=300, n_test=300, dim=8,
                            noise=0.0, seed=5)
        save_dataset(ds, d)
    return root


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_ranks(cfg: Config, path: str, n_ranks: int, dev: torch.device,
                echo=print):
    """``cfg`` on ``n_ranks`` processes of ``cli.launch`` (one
    device each) on the JAX tool's (N/2, 2) grid: per-epoch records of
    rank 0's log (``--log_path``). Every rank is killed when one fails or
    at :data:`RANKS_TIMEOUT`."""
    bs = cfg.resolve_batch_size(load_dataset(path).n_train)
    bs = max(2 * n_ranks, bs - bs % (2 * n_ranks))
    with tempfile.TemporaryDirectory(prefix="okst_acceptance_") as work:
        log = os.path.join(work, "log.jsonl")
        flags = ["--input", path, "--output", os.path.join(work, "out"),
                 "--model", cfg.model, "--hidden_size", str(cfg.hidden_size),
                 "--alpha", str(cfg.alpha), "--margin", str(cfg.margin),
                 "--negative_ent", str(cfg.negative_ent),
                 "--bern", str(int(cfg.bern)),
                 "--train_times", str(cfg.train_times),
                 "--nbatches", str(cfg.nbatches), "--batch_size", str(bs),
                 "--mesh_data", "-1", "--mesh_model", "2",
                 "--chips_per_host", str(max(1, n_ranks // 2)),
                 "--log_every", "1", "--log_path", log,
                 "--device", dev.type, "--coordinator",
                 f"localhost:{_free_port()}",
                 "--num_processes", str(n_ranks)]
        # the ranks import this package from wherever it lies
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep
                   .join(filter(None, (root, os.environ.get("PYTHONPATH")))))
        outs = [os.path.join(work, f"rank{p}.out") for p in range(n_ranks)]
        procs = []
        try:
            for p, out in enumerate(outs):
                with open(out, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "openkeonspark_tpu_torch.cli.launch", *flags,
                         "--process_id", str(p)], env=env, stdout=f,
                        stderr=subprocess.STDOUT))
            deadline = time.monotonic() + RANKS_TIMEOUT
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(
                        p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for out in outs:
            with open(out) as f:
                texts.append(f.read())
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"cli.launch rank {bad[0]} exited "
                               f"{procs[bad[0]].returncode}:\n"
                               f"{texts[bad[0]][-3000:]}")
        for line in texts[0].splitlines():
            if "process(es)" in line:
                echo(line)
        with open(log) as f:
            return [r for r in map(json.loads, f) if "loss" in r]


def run_config(spec, data_root: str, stand_in: bool, quick: bool,
               dev: torch.device, ranks: int = 0, echo=print):
    """One config's record. ``ranks`` is config 5's process count (0: one
    per card on a card, one on the CPU)."""
    path = os.path.join(data_root, spec["dataset"])
    if not os.path.exists(os.path.join(path, "train2id.txt")):
        return dict(config=spec["n"], dataset=spec["dataset"],
                    status="SKIP", reason=f"no dataset at {path}")
    epochs = spec["epochs"]
    if stand_in and spec["n"] != 1:   # cfg 1 is tiny; full epochs keep
        epochs = max(3, epochs // (20 if quick else 1))  # its loss gate
    cfg = Config(model=spec["model"], hidden_size=spec["d"],
                 ent_size=spec.get("d_rel") and spec["d"],
                 rel_size=spec.get("d_rel"),
                 alpha=spec["alpha"], margin=spec["margin"],
                 negative_ent=spec["neg"], bern=spec["bern"],
                 train_times=epochs, nbatches=spec["nbatches"],
                 log_every=0)

    t0 = time.perf_counter()
    if spec.get("multi_device"):
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        n_dev = ranks or (cards if dev.type == "cuda" else 1)
        if n_dev < 2 or (dev.type == "cuda" and n_dev > cards):
            return dict(config=spec["n"], dataset=spec["dataset"],
                        status="SKIP",
                        reason=f"needs >=2 devices, have {n_dev} rank(s)"
                               + (f" on {cards} card(s); NCCL takes one "
                                  "card a rank" if dev.type == "cuda"
                                  else ""))
        history = train_ranks(cfg, path, n_dev, dev, echo)
        losses = [h["loss"] for h in history]
        tps_all = [h["triples_per_sec"] for h in history]
        lp_state = None
    else:
        ds = load_dataset(path)
        res = train(cfg, ds, dev, echo=lambda *_: None)
        losses = [h.loss for h in res.history]
        tps_all = [h.triples_per_sec for h in res.history]
        lp_state = res.state
    wall = time.perf_counter() - t0
    tps = float(np.median(tps_all))
    final_loss = losses[-1] if losses else float("nan")

    out = dict(config=spec["n"], dataset=spec["dataset"],
               model=spec["model"], epochs=epochs,
               final_loss=round(final_loss, 3),
               triples_per_sec=round(tps, 1), wall_s=round(wall, 1))
    checks = {}
    first_loss = losses[0] if losses else float("nan")
    if spec["n"] == 1:
        checks["loss_falls_3x"] = final_loss * 3 <= first_loss
    gates = dict(spec["gates"])
    if "min_tps" in gates:
        min_tps = gates.pop("min_tps")
        # stand-ins: the gate is that the multi-device pipeline runs and
        # makes progress, not a throughput
        checks["throughput"] = (tps >= min_tps if not stand_in
                                else tps > 0 and np.isfinite(final_loss))
    if gates:
        ds = load_dataset(path)
        index = build_kg_index(ds, for_eval=True)
        lp = link_prediction(lp_state.params, cfg, ds, index)
        out["filt_mrr"] = round(lp.filt_avg.mrr, 4)
        out["filt_hits10"] = round(lp.filt_avg.hits10, 4)
        if stand_in:
            # stand-in gates: planted structure genuinely recovered (well
            # off the random floor), not the real splits' literature numbers
            floor = 10.0 / ds.n_ent
            checks["filt_hits10_recovered"] = \
                lp.filt_avg.hits10 >= max(0.15, 5 * floor)
        else:
            for k, lo in gates.items():
                checks[k] = out[k] >= lo
    out["checks"] = {k: bool(v) for k, v in checks.items()}
    out["status"] = "PASS" if all(checks.values()) else "FAIL"
    out["note"] = spec["note"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", default="",
                    help="directory holding the real splits (OpenKE text "
                         "layout, one subdir per dataset)")
    ap.add_argument("--stand-in", action="store_true",
                    help="generate planted synthetic stand-ins (harness "
                         "self-test; gates switch to recovery thresholds)")
    ap.add_argument("--quick", action="store_true",
                    help="stand-in mode at reduced sizes/epochs")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--ranks", type=int, default=0,
                    help="processes of config 5's multi-device run (0: one "
                         "per card with --device cuda, one on the CPU)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)

    root = args.data_root
    if args.stand_in:
        root = root or os.path.join(tempfile.gettempdir(),
                                    "okst_acceptance_standin")
        os.makedirs(root, exist_ok=True)
        make_stand_ins(root, args.quick)
    elif not root:
        ap.error("--data-root required (or use --stand-in)")

    want = {int(x) for x in args.configs.split(",")}
    rows = []
    for spec in CONFIGS:
        if spec["n"] not in want:
            continue
        r = run_config(spec, root, args.stand_in, args.quick, dev,
                       args.ranks)
        r["device"] = label
        rows.append(r)
        print(json.dumps(r), flush=True)

    print("\n| cfg | dataset | model | status | filt MRR | filt H@10 "
          "| t/s |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['config']} | {r['dataset']} | {r.get('model', '-')} "
              f"| **{r['status']}** | {r.get('filt_mrr', '-')} "
              f"| {r.get('filt_hits10', '-')} "
              f"| {r.get('triples_per_sec', '-')} |")
    bad = [r for r in rows if r["status"] == "FAIL"]
    summary = {"metric": "acceptance",
               "mode": "stand_in" if args.stand_in else "real",
               "pass": sum(r["status"] == "PASS" for r in rows),
               "fail": len(bad),
               "skip": sum(r["status"] == "SKIP" for r in rows),
               "device": label}
    print(json.dumps(summary))
    if bad:
        raise SystemExit(1)
    return rows, summary


if __name__ == "__main__":
    main()
