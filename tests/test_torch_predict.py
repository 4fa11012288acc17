"""The port's ``predict_*`` functions against the JAX package's: the same
parameters (a caller written for the reference binds them alike), and
``predict_triple``'s score, threshold and verdict on the same tables, with
fitted per-relation thresholds and with an explicit one."""

import inspect

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu import eval as jax_eval
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval.classification import \
    fit_thresholds as jax_fit_thresholds
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch import eval as port_eval
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.eval.classification import fit_thresholds
from openkeonspark_tpu_torch.models import get_model

from torch_parity import port_config

CPU = torch.device("cpu")
# (model, p): every model, RotatE, DistMult and ComplEx without a norm
CASES = [("transe", 1), ("transe", 2), ("transh", 1), ("transd", 2),
         ("rotate", 1), ("transr", 2), ("distmult", 1), ("complex", 1)]
PREDICT = ("predict_head_entity", "predict_tail_entity", "predict_relation",
           "predict_triple")
# (h, t, r) queried: first, middle and last ids
QUERIES = ((0, 1, 0), (40, 17, 3), (82, 81, 5))


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=83, n_rel=6, n_triples=900, n_valid=60, n_test=30,
                   seed=11)
    return ds, build_kg_index(ds, for_eval=True)


def _setup(kg, model, p):
    ds, idx = kg
    cfg = Config(model=model, hidden_size=12 if model == "rotate" else 16,
                 p_norm=p, eval_block=32)
    st = init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(6))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tcfg = port_config(cfg)
    tp = params_from_numpy(jp, get_model(model), tcfg, ds.n_ent, ds.n_rel,
                           CPU)
    return ds, idx, cfg, st.params, tp, tcfg


@pytest.mark.parametrize("name", PREDICT)
def test_predict_parameters_match_jax(name):
    """Same parameter names in the same order, defaults included."""
    ours = inspect.signature(getattr(port_eval, name)).parameters
    ref = inspect.signature(getattr(jax_eval, name)).parameters
    assert list(ours) == list(ref)
    assert [v.default for v in ours.values()] == \
        [v.default for v in ref.values()]


@pytest.mark.parametrize("model,p", CASES)
def test_predict_triple_matches_jax(kg, model, p):
    """Fitted thresholds (``thresholds=``) and an explicit scalar
    (``threshold=``, midway between two of the queried scores): equal
    thresholds and verdicts, scores within float rounding of the other
    package's sum order."""
    ds, idx, cfg, jp, tp, tcfg = _setup(kg, model, p)
    thr, _ = fit_thresholds(tp, tcfg, ds, idx)
    jthr, _ = jax_fit_thresholds(jp, cfg, ds, idx)
    got = [port_eval.predict_triple(tp, tcfg, h, t, r, thresholds=thr)
           for h, t, r in QUERIES]
    want = [jax_eval.predict_triple(jp, cfg, h, t, r, thresholds=jthr)
            for h, t, r in QUERIES]
    for g, w in zip(got, want):
        assert g["score"] == pytest.approx(w["score"], rel=1e-5)
        assert g["threshold"] == pytest.approx(w["threshold"], rel=1e-5)
        assert g["is_true"] == w["is_true"]
    scores = sorted(w["score"] for w in want)
    mid = (scores[0] + scores[1]) / 2
    for h, t, r in QUERIES:
        g = port_eval.predict_triple(tp, tcfg, h, t, r, threshold=mid)
        w = jax_eval.predict_triple(jp, cfg, h, t, r, threshold=mid)
        assert g["threshold"] == w["threshold"] == mid
        assert g["is_true"] == w["is_true"]
        assert g["score"] == pytest.approx(w["score"], rel=1e-5)
    assert sum(port_eval.predict_triple(tp, tcfg, h, t, r,
                                        threshold=mid)["is_true"]
               for h, t, r in QUERIES) == 1


def test_predict_triple_reads_the_counts_from_the_tables(kg):
    """Tables with 8 pad rows score a triple as tables with one do, and
    the verdict needs a threshold."""
    ds, idx, cfg, _, tp, tcfg = _setup(kg, "transd", 1)
    padded = {k: torch.cat([v, torch.zeros(7, v.shape[1])])
              for k, v in tp.items()}
    for h, t, r in QUERIES:
        assert port_eval.predict_triple(padded, tcfg, h, t, r,
                                        threshold=1.0) == \
            port_eval.predict_triple(tp, tcfg, h, t, r, threshold=1.0)
    with pytest.raises(ValueError, match="threshold"):
        port_eval.predict_triple(tp, tcfg, 0, 1, 0)
