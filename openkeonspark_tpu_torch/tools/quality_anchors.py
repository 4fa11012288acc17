"""Per-family quality anchors: train each model on its family-matched
planted KG and record filtered Hits@10 / MRR, normalised by the
generator's own ceiling.

Counterpart of ``tools/quality_anchors.py`` (``SPECS`` ``:31-75``,
``main`` ``:77-169``). Each KG is generated from a hidden model of the
family (``data/synth.py::planted_kg``), so the family's trainer must
recover a high filtered Hits@10; the KG's split and ambiguity cap what any
model can score, so each run also ranks the generator's hidden tables
through the same evaluator (:func:`ceiling`: carried across by
``ckpt/checkpoint.py::params_from_numpy``, p=2, the generator's Euclidean
planting rule) and reports ``recovery = trained / ceiling``. Training is
``train/loop.py::train`` on the device (kernels B4 in TransR's steps),
ranking ``eval/link_prediction.py`` (B1, B2, B3; B1 relation by relation
for TransR and TransH).

Usage: python -m openkeonspark_tpu_torch.tools.quality_anchors
  [--models transe,transh,transr,transd,distmult,complex,rotate]
  [--epochs-scale 1] [--scale 1] [--device cuda]
Prints one JSON line per family.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, planted_kg
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.tools import add_device_flag, open_device
from openkeonspark_tpu_torch.train.loop import train

# (kg kwargs, cfg kwargs) per family: the JAX tool's, which mirror the
# recovery tests' alphas scaled to this KG size; RotatE needs the
# self-adversarial loss and 32 negatives; the bilinear models anchor on a
# translation-planted KG (no bilinear generator exists)
SPECS = {
    "transe": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16),
               dict(hidden_size=100, alpha=0.1, margin=2.0,
                    train_times=150, negative_ent=4)),
    "transh": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16),
               dict(hidden_size=100, alpha=0.005, margin=2.0,
                    train_times=200, negative_ent=4)),
    "transr": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16),
               dict(ent_size=100, rel_size=50, alpha=0.01, margin=2.0,
                    train_times=200, negative_ent=4)),
    "transd": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16),
               dict(hidden_size=100, alpha=0.01, margin=2.0,
                    train_times=200, negative_ent=4)),
    "rotate": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16),
               dict(hidden_size=50, alpha=0.05, margin=6.0,
                    train_times=200, negative_ent=32,
                    loss_mode="self_adv")),
    "distmult": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16,
                      kg_model="transe"),
                 dict(hidden_size=100, alpha=0.01, margin=2.0,
                      train_times=150, negative_ent=4)),
    "complex": (dict(n_ent=10000, n_rel=24, n_triples=200000, dim=16,
                     kg_model="transe"),
                dict(hidden_size=100, alpha=0.01, margin=2.0,
                     train_times=150, negative_ent=4)),
}


def planted(name: str, scale: float = 1.0):
    """(ds, hidden tables, generator family, its dim) of a family's KG,
    ``n_ent`` and ``n_triples`` scaled by ``scale``."""
    kg_kw = dict(SPECS[name][0])
    if scale != 1.0:
        kg_kw["n_ent"] = max(200, int(kg_kw["n_ent"] * scale))
        kg_kw["n_triples"] = max(4000, int(kg_kw["n_triples"] * scale))
    kg_model = kg_kw.pop("kg_model", name)
    n_test = min(5000, kg_kw["n_triples"] // 8)
    ds, hidden = planted_kg(n_valid=min(2000, n_test), n_test=n_test,
                            noise=0.0, seed=1, model=kg_model,
                            head_frac=0.5, with_params=True, **kg_kw)
    return ds, hidden, kg_model, kg_kw["dim"]


def ceiling(kg_model: str, dim: int, ds, hidden, index,
            dev: torch.device):
    """The generator's hidden tables ranked on the test split by the
    port's evaluator on ``dev``: hidden dim, p=2 (the generator plants by
    squared-Euclidean nearest neighbours; RotatE's ``dim`` counts table
    lanes, its complex dim is half)."""
    hs = dim // 2 if kg_model == "rotate" else dim
    cfg = Config(model=kg_model, hidden_size=hs, p_norm=2,
                 **({"ent_size": dim, "rel_size": max(2, dim // 2)}
                    if kg_model == "transr" else {}))
    params = params_from_numpy(hidden, get_model(kg_model), cfg, ds.n_ent,
                               ds.n_rel, dev)
    return link_prediction(params, cfg, ds, index, triples=ds.test)


def run_family(name: str, dev: torch.device, epochs_scale: float = 1.0,
               scale: float = 1.0, p_norm: int = 0, negative_ent: int = 0,
               margin: float = 0.0) -> dict:
    """Train ``name`` on its planted KG and rank it beside the ceiling."""
    ds, hidden, kg_model, dim = planted(name, scale)
    cfg_kw = dict(SPECS[name][1])
    cfg_kw["train_times"] = int(cfg_kw["train_times"] * epochs_scale)
    if p_norm:
        cfg_kw["p_norm"] = p_norm
    if negative_ent:
        cfg_kw["negative_ent"] = negative_ent
    if margin:
        cfg_kw["margin"] = margin
    cfg = Config(model=name, nbatches=100, **cfg_kw)
    t0 = time.time()
    res = train(cfg, ds, dev, echo=lambda *a, **k: None)
    train_s = time.time() - t0
    idx = build_kg_index(ds, for_eval=True)
    ceil = ceiling(kg_model, dim, ds, hidden, idx, dev)
    t0 = time.time()
    lp = link_prediction(res.state.params, cfg, ds, idx, triples=ds.test)
    eval_s = time.time() - t0
    return {
        "model": name, "n_ent": ds.n_ent,
        "p_norm": cfg.p_norm, "margin": cfg.margin,
        "negative_ent": cfg.negative_ent,
        "n_train": int(ds.n_train),
        "final_loss": round(res.final_loss, 3),
        "train_s": round(train_s, 1), "eval_s": round(eval_s, 1),
        "filt_hits10": round(lp.filt_avg.hits10, 4),
        "filt_mrr": round(lp.filt_avg.mrr, 4),
        "filt_hits10_tail": round(lp.filt_tail.hits10, 4),
        "filt_hits10_head": round(lp.filt_head.hits10, 4),
        "ceiling_hits10": round(ceil.filt_avg.hits10, 4),
        "ceiling_mrr": round(ceil.filt_avg.mrr, 4),
        "recovery_hits10": round(lp.filt_avg.hits10
                                 / max(ceil.filt_avg.hits10, 1e-9), 4),
        "recovery_mrr": round(lp.filt_avg.mrr
                              / max(ceil.filt_avg.mrr, 1e-9), 4),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="transe,transh,transr,transd")
    ap.add_argument("--epochs-scale", type=float, default=1.0,
                    help="multiply each spec's train_times")
    ap.add_argument("--p-norm", type=int, default=0,
                    help="override the trained model's score norm (0 = "
                         "spec default L1); the ceiling always scores p2")
    ap.add_argument("--negative-ent", type=int, default=0,
                    help="override negatives per positive (0 = spec)")
    ap.add_argument("--margin", type=float, default=0.0,
                    help="override margin (0 = spec)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale n_ent AND n_triples by this factor")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev, label = open_device(args.device)
    out = []
    for name in args.models.split(","):
        rec = run_family(name, dev, args.epochs_scale, args.scale,
                         args.p_norm, args.negative_ent, args.margin)
        rec["device"] = label
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
