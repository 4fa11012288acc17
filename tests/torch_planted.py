"""Planted recovery for the port, the bar of ``tests/test_synth_planted.py``
(``:26-48``): a model trained through the port's loop on the CPU must reach
RECOVERY_FRAC of the per-direction filtered Hits@10 that the generator's
own hidden tables reach through the port's evaluator (the ceiling). Each
model has the JAX test's KG shape and hyperparameters (``:61-165``); the
bilinear models train on a translation-planted KG against the TransE
ceiling, as there."""

import numpy as np
import torch

from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.config import Config
from openkeonspark_tpu_torch.data import build_kg_index, planted_kg
from openkeonspark_tpu_torch.eval import link_prediction
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.train.loop import train

RECOVERY_FRAC = 0.6
CPU = torch.device("cpu")
_KG = dict(n_ent=150, n_rel=4, n_triples=3000, n_valid=80, n_test=120,
           noise=0.0, seed=1)
_FIT = dict(margin=2.0, train_times=60, nbatches=15, negative_ent=2)
# model -> (planted family, planted dim, KG shape, training config)
PLANTED = {
    "transe": ("transe", 8,
               dict(n_ent=200, n_rel=6, n_triples=4000, n_valid=100,
                    n_test=200, noise=0.0, seed=1, head_frac=0.5),
               dict(hidden_size=24, alpha=0.1, margin=2.0, train_times=25,
                    nbatches=15, negative_ent=2)),
    "transh": ("transh", 6, _KG, dict(hidden_size=24, alpha=0.005, **_FIT)),
    "transr": ("transr", 6, _KG, dict(ent_size=24, rel_size=12, alpha=0.01,
                                      **_FIT)),
    "transd": ("transd", 6, _KG, dict(hidden_size=24, alpha=0.01, **_FIT)),
    "rotate": ("rotate", 8, _KG,
               dict(hidden_size=24, alpha=0.05, margin=6.0, train_times=80,
                    nbatches=15, negative_ent=4, loss_mode="self_adv")),
    "distmult": ("transe", 6, _KG, dict(hidden_size=24, alpha=0.05, **_FIT)),
    "complex": ("transe", 6, _KG, dict(hidden_size=24, alpha=0.05, **_FIT)),
}


def ceiling(family, ds, hidden, dim, index):
    """The hidden tables' link prediction (p = 2, the generator's squared
    Euclidean planting rule; RotatE's ``dim`` counts table lanes)."""
    if family == "rotate":
        dim //= 2
    cfg = Config(model=family, hidden_size=dim, p_norm=2, eval_chunk=64,
                 **({"ent_size": dim, "rel_size": max(2, dim // 2)}
                    if family == "transr" else {}))
    params = params_from_numpy(hidden, get_model(family), cfg, ds.n_ent,
                               ds.n_rel, CPU)
    return link_prediction(params, cfg, ds, index)


def assert_recovers(model):
    family, dim, kg, fit = PLANTED[model]
    ds, hidden = planted_kg(dim=dim, model=family, with_params=True, **kg)
    cfg = Config(model=model, eval_chunk=64, **fit)
    res = train(cfg, ds, CPU, echo=lambda *a: None)
    index = build_kg_index(ds, for_eval=True)
    lp = link_prediction(res.state.params, cfg, ds, index)
    ceil = ceiling(family, ds, hidden, dim, index)
    got = (lp.filt_tail.hits10, lp.filt_head.hits10)
    bar = (ceil.filt_tail.hits10, ceil.filt_head.hits10)
    assert np.isfinite(res.final_loss)
    assert all(g >= RECOVERY_FRAC * c for g, c in zip(got, bar)), \
        (model, got, bar)
    return got, bar
