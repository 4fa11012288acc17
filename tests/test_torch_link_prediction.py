"""The port's evaluation slice as a whole against the JAX package: link
prediction ranks (generic and Pallas-interpret paths), the printed table,
triple classification and top-k prediction on the same tables."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.eval import predict_head_entity as jax_predict_head
from openkeonspark_tpu.eval import predict_tail_entity as jax_predict_tail
from openkeonspark_tpu.eval import triple_classification as jax_tc
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.eval import (link_prediction,
                                          predict_head_entity,
                                          predict_tail_entity,
                                          triple_classification)
from openkeonspark_tpu_torch.eval.link_prediction import guard_finite_params
from openkeonspark_tpu_torch.models import TransE

from torch_parity import transe_near_tie_counts

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=91, n_rel=7, n_triples=900, n_valid=40, n_test=40,
                   seed=3)
    return ds, build_kg_index(ds, for_eval=True)


def _setup(kg, p):
    ds, idx = kg
    cfg = Config(model="transe", hidden_size=16, p_norm=p, eval_chunk=16,
                 eval_block=32)
    st = init_state(jax_get_model("transe"), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(8))
    tp = params_from_numpy({k: np.asarray(v) for k, v in st.params.items()},
                           TransE, cfg, ds.n_ent, ds.n_rel, CPU)
    return ds, idx, cfg, st.params, tp


@pytest.fixture(scope="module")
def jax_results(kg):
    """JAX ranks per p, generic XLA path and Pallas interpret path."""
    out = {}
    for p in (1, 2):
        ds, idx, cfg, jp, _ = _setup(kg, p)
        generic = jax_link_prediction(jp, cfg, ds, idx)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OKST_PALLAS_INTERPRET", "1")
            pallas = jax_link_prediction(jp, cfg, ds, idx)
        out[p] = {"generic": generic, "pallas": pallas}
    return out


@pytest.mark.parametrize("path", ["generic", "pallas"])
@pytest.mark.parametrize("p", [1, 2])
def test_ranks_match_jax(kg, jax_results, p, path):
    ds, idx, cfg, _, tp = _setup(kg, p)
    got = link_prediction(tp, cfg, ds, idx)
    want = jax_results[p][path]
    ties = transe_near_tie_counts(tp["ent_embeddings"][:ds.n_ent].numpy(),
                                  tp["rel_embeddings"][:ds.n_rel].numpy(),
                                  ds.test, p)
    for k in want.ranks:
        # exact where no candidate is a near-tie; elsewhere off by at most
        # the near-tie count
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    if all((got.ranks[k] == want.ranks[k]).all() for k in want.ranks):
        assert got.format_table() == want.format_table()


def test_filtered_ranks_never_worse_than_raw(kg):
    ds, idx, cfg, _, tp = _setup(kg, 1)
    res = link_prediction(tp, cfg, ds, idx)
    assert (res.ranks["filt_head"] <= res.ranks["raw_head"]).all()
    assert (res.ranks["filt_tail"] <= res.ranks["raw_tail"]).all()
    assert (res.ranks["filt_tail"] >= 0).all()
    assert 0 < res.filt_avg.mrr <= 1 and res.filt_avg.mr >= 1


def test_ranks_do_not_depend_on_chunking(kg):
    """Ragged last chunk, one-query chunks and tiny dispatch groups give
    the same ranks as the default chunking."""
    ds, idx, cfg, _, tp = _setup(kg, 2)
    want = link_prediction(tp, cfg, ds, idx).ranks
    for kw in ({"eval_chunk": 7}, {"eval_chunk": 1},
               {"eval_chunk": 16, "eval_group_elems": 64}):
        got = link_prediction(tp, cfg.replace(**kw), ds, idx).ranks
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(kw))


@pytest.mark.parametrize("p", [1, 2])
def test_triple_classification_matches_jax(kg, p):
    ds, idx, cfg, jp, tp = _setup(kg, p)
    got = triple_classification(tp, cfg, ds, idx)
    want = jax_tc(jp, cfg, ds, idx)
    assert got["accuracy"] == want["accuracy"]
    assert got["valid_accuracy"] == want["valid_accuracy"]
    for k in ("precision", "recall", "f1"):
        assert got[k] == pytest.approx(want[k], rel=1e-5)


def test_thresholds_match_jax(kg):
    from openkeonspark_tpu.eval.classification import \
        fit_thresholds as jax_fit
    from openkeonspark_tpu_torch.eval.classification import fit_thresholds
    ds, idx, cfg, jp, tp = _setup(kg, 1)
    thr, acc = fit_thresholds(tp, cfg, ds, idx)
    jthr, jacc = jax_fit(jp, cfg, ds, idx)
    assert acc == jacc
    np.testing.assert_array_equal(thr.has_rel, jthr.has_rel)
    np.testing.assert_allclose(thr.per_rel, jthr.per_rel, rtol=1e-5)
    assert thr.fallback == pytest.approx(jthr.fallback, rel=1e-5)


@pytest.mark.parametrize("p", [1, 2])
def test_predict_matches_jax(kg, p):
    ds, idx, cfg, jp, tp = _setup(kg, p)
    for h, r in ((0, 0), (17, 3), (90, 6)):
        ids, scores = predict_tail_entity(tp, cfg, ds.n_ent, ds.n_rel, h, r,
                                          k=10)
        jids, jscores = jax_predict_tail(jp, cfg, ds.n_ent, ds.n_rel, h, r,
                                         k=10)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5)
        ids, _ = predict_head_entity(tp, cfg, ds.n_ent, ds.n_rel, h, r, k=10)
        jids, _ = jax_predict_head(jp, cfg, ds.n_ent, ds.n_rel, h, r, k=10)
        np.testing.assert_array_equal(ids, jids)
        assert (ids < ds.n_ent).all()


def test_known_matrix_matches_jax(kg):
    """The on-device known-true window equals the reference's host
    ``_known_matrix`` (same ids, same order, pad = n_ent)."""
    from openkeonspark_tpu.eval.link_prediction import _known_matrix
    from openkeonspark_tpu_torch.eval.link_prediction import known_matrix
    ds, idx = kg
    h, t, r = ds.test[:, 0], ds.test[:, 1], ds.test[:, 2]
    for gi, a in ((idx.hr_all, h), (idx.tr_all, t)):
        off, cnt = gi.lookup(a, r)
        k_max = int(cnt.max()) + 3
        got = known_matrix(torch.from_numpy(gi.sorted_vals),
                           torch.from_numpy(off), torch.from_numpy(cnt),
                           k_max, ds.n_ent)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), _known_matrix(gi, a, r, k_max, ds.n_ent))


def test_guard_finite_params_refuses_nan(kg):
    ds, idx, cfg, _, tp = _setup(kg, 1)
    guard_finite_params(tp)
    bad = dict(tp, rel_embeddings=tp["rel_embeddings"].clone())
    bad["rel_embeddings"][2, 3] = float("nan")
    with pytest.raises(ValueError, match="rel_embeddings"):
        guard_finite_params(bad)
    with pytest.raises(ValueError, match="non-finite"):
        link_prediction(bad, cfg, ds, idx)
