"""The port's evaluation of TransH, TransD and RotatE against the JAX
package on the same tables: link-prediction ranks (the JAX generic path
and its Pallas kernel path in interpret mode; TransH on both of its
routes), triple classification, the top-k queries and the evaluate CLI's
printed table."""

import jax
import numpy as np
import pytest
import torch

from openkeonspark_tpu.ckpt import export_parameters as jax_export
from openkeonspark_tpu.config import Config
from openkeonspark_tpu.data.dataset import save_dataset
from openkeonspark_tpu.data.index import build_kg_index
from openkeonspark_tpu.data.synth import random_kg
from openkeonspark_tpu.eval import link_prediction as jax_link_prediction
from openkeonspark_tpu.eval import predict_head_entity as jax_predict_head
from openkeonspark_tpu.eval import predict_relation as jax_predict_rel
from openkeonspark_tpu.eval import predict_tail_entity as jax_predict_tail
from openkeonspark_tpu.eval import triple_classification as jax_tc
from openkeonspark_tpu.models import get_model as jax_get_model
from openkeonspark_tpu.train.step import init_state
from openkeonspark_tpu_torch.ckpt import params_from_numpy
from openkeonspark_tpu_torch.cli import evaluate
from openkeonspark_tpu_torch.eval import (link_prediction,
                                          predict_head_entity,
                                          predict_relation,
                                          predict_tail_entity,
                                          triple_classification)
from openkeonspark_tpu_torch.eval.link_prediction import use_grouped_route
from openkeonspark_tpu_torch.models import get_model
from openkeonspark_tpu_torch.ops import rank

from torch_parity import MAX_NEAR_TIE_SHARE, model_near_tie_counts

CPU = torch.device("cpu")
# (model, p) pairs: RotatE has no norm to choose
CASES = [("transh", 1), ("transh", 2), ("transd", 1), ("transd", 2),
         ("rotate", 1)]
TRANSH_KERNEL = "OKST_EVAL_TRANSH_KERNEL"


@pytest.fixture(scope="module")
def kg():
    ds = random_kg(n_ent=97, n_rel=6, n_triples=1200, n_valid=30,
                   n_test=100, seed=5)
    return ds, build_kg_index(ds, for_eval=True)


def _cfg(model, p):
    return Config(model=model, hidden_size=12 if model == "rotate" else 16,
                  p_norm=p, eval_chunk=16, eval_block=32)


def _setup(kg, model, p):
    ds, idx = kg
    cfg = _cfg(model, p)
    st = init_state(jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
                    jax.random.key(4))
    jp = {k: np.asarray(v) for k, v in st.params.items()}
    tp = params_from_numpy(jp, get_model(model), cfg, ds.n_ent, ds.n_rel,
                           CPU)
    return ds, idx, cfg, st.params, tp


def _jax_ranks(kg, model, p, path):
    """The JAX package's ranks: ``generic`` (XLA), ``kernel`` (its Pallas
    route in interpret mode: the fused count for TransD and RotatE, the
    grouped projection + TransE count for TransH) or, for TransH,
    ``transh_kernel`` (its TransH count, the A/B switch)."""
    ds, idx, cfg, jp, _ = _setup(kg, model, p)
    with pytest.MonkeyPatch.context() as mp:
        if path != "generic":
            mp.setenv("OKST_PALLAS_INTERPRET", "1")
        if path == "transh_kernel":
            mp.setenv("OKST_EVAL_FORCE_GENERIC", "1")
            mp.setenv(TRANSH_KERNEL, "1")
        return jax_link_prediction(jp, cfg, ds, idx)


@pytest.fixture(scope="module")
def jax_results(kg):
    out = {}
    for model, p in CASES:
        paths = ["generic", "kernel"] + (["transh_kernel"]
                                         if model == "transh" else [])
        for path in paths:
            out[model, p, path] = _jax_ranks(kg, model, p, path)
    return out


def _assert_ranks_match(got, want, ties):
    """Exact where no candidate is a near-tie; elsewhere off by at most the
    near-tie count; near-tie queries (of both directions) rare."""
    for k in want.ranks:
        diff = np.abs(got.ranks[k] - want.ranks[k])
        assert (diff <= ties[k.split("_")[1]]).all(), k
    share = np.concatenate([ties["head"], ties["tail"]]) > 0
    assert share.mean() < MAX_NEAR_TIE_SHARE
    if all((got.ranks[k] == want.ranks[k]).all() for k in want.ranks):
        assert got.format_table() == want.format_table()


def _ties(ds, tp, model, p):
    tables = {k: v[:-1].numpy() for k, v in tp.items()}
    return model_near_tie_counts(model, tables, ds.test, p)


@pytest.mark.parametrize("path", ["generic", "kernel"])
@pytest.mark.parametrize("model,p", CASES)
def test_ranks_match_jax(kg, jax_results, model, p, path, monkeypatch):
    """The port's default route (B2, B3 per chunk; TransH relation by
    relation through B1) against both JAX paths."""
    monkeypatch.delenv(TRANSH_KERNEL, raising=False)
    ds, idx, cfg, _, tp = _setup(kg, model, p)
    assert use_grouped_route(cfg) == (model == "transh")
    got = link_prediction(tp, cfg, ds, idx)
    _assert_ranks_match(got, jax_results[model, p, path],
                        _ties(ds, tp, model, p))


@pytest.mark.parametrize("path", ["generic", "kernel", "transh_kernel"])
@pytest.mark.parametrize("p", [1, 2])
def test_transh_kernel_route_matches_jax(kg, jax_results, p, path,
                                         monkeypatch):
    """OKST_EVAL_TRANSH_KERNEL=1 sends TransH chunk by chunk through B6's
    count (its plain version here) and nothing else does."""
    ds, idx, cfg, _, tp = _setup(kg, "transh", p)
    monkeypatch.setenv(TRANSH_KERNEL, "1")
    assert not use_grouped_route(cfg)
    lines = []
    got = link_prediction(tp, cfg, ds, idx, log=lines.append)
    assert not any("grouped" in s for s in lines)
    _assert_ranks_match(got, jax_results["transh", p, path],
                        _ties(ds, tp, "transh", p))
    monkeypatch.setenv(TRANSH_KERNEL, "0")
    assert use_grouped_route(cfg)


@pytest.mark.parametrize("model,p", CASES)
def test_ranks_do_not_depend_on_chunking(kg, model, p, monkeypatch):
    """One-query and ragged chunks give the default chunking's ranks, and
    filtered ranks never exceed raw ones."""
    monkeypatch.delenv(TRANSH_KERNEL, raising=False)
    ds, idx, cfg, _, tp = _setup(kg, model, p)
    want = link_prediction(tp, cfg, ds, idx).ranks
    for d in ("head", "tail"):
        assert (want[f"filt_{d}"] <= want[f"raw_{d}"]).all()
        assert (want[f"filt_{d}"] >= 0).all()
    for kw in ({"eval_chunk": 7}, {"eval_chunk": 1}):
        got = link_prediction(tp, cfg.replace(**kw), ds, idx).ranks
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(kw))


def test_plain_flag_takes_the_plain_versions(kg, monkeypatch):
    """plain=True (the card's reference path) gives the same ranks on the
    CPU, where the wrappers take the plain versions anyway, and counts no
    kernel launch either way."""
    monkeypatch.setenv(TRANSH_KERNEL, "1")
    for model, p in CASES:
        ds, idx, cfg, _, tp = _setup(kg, model, p)
        rank.reset_launch_counts()
        a = link_prediction(tp, cfg, ds, idx)
        b = link_prediction(tp, cfg, ds, idx, plain=True)
        for k in a.ranks:
            np.testing.assert_array_equal(a.ranks[k], b.ranks[k])
        assert not any(rank.LAUNCHES.values())


@pytest.mark.parametrize("model,p", CASES)
def test_triple_classification_matches_jax(kg, model, p):
    ds, idx, cfg, jp, tp = _setup(kg, model, p)
    got = triple_classification(tp, cfg, ds, idx)
    want = jax_tc(jp, cfg, ds, idx)
    assert got["accuracy"] == want["accuracy"]
    assert got["valid_accuracy"] == want["valid_accuracy"]
    for k in ("precision", "recall", "f1"):
        assert got[k] == pytest.approx(want[k], rel=1e-5)


@pytest.mark.parametrize("model,p", CASES)
def test_predict_matches_jax(kg, model, p):
    ds, idx, cfg, jp, tp = _setup(kg, model, p)
    for a, r in ((0, 0), (17, 3), (96, 5)):
        ids, scores = predict_tail_entity(tp, cfg, ds.n_ent, ds.n_rel, a, r,
                                          k=10)
        jids, jscores = jax_predict_tail(jp, cfg, ds.n_ent, ds.n_rel, a, r,
                                         k=10)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5)
        ids, scores = predict_head_entity(tp, cfg, ds.n_ent, ds.n_rel, a, r,
                                          k=10)
        jids, jscores = jax_predict_head(jp, cfg, ds.n_ent, ds.n_rel, a, r,
                                         k=10)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5)
        ids, scores = predict_relation(tp, cfg, ds.n_ent, ds.n_rel, a, 3,
                                       k=4)
        jids, jscores = jax_predict_rel(jp, cfg, ds.n_ent, ds.n_rel, a, 3,
                                        k=4)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(scores, jscores, rtol=1e-5)


@pytest.mark.parametrize("model,p", CASES)
def test_cli_prints_jax_table(kg, tmp_path, model, p, capsys, monkeypatch):
    """``cli.evaluate --device cpu`` on a JAX export prints the JAX
    package's link-prediction table and answers the top-k queries."""
    monkeypatch.delenv(TRANSH_KERNEL, raising=False)
    ds, idx, cfg, jp, _ = _setup(kg, model, p)
    save_dataset(ds, str(tmp_path / "kg"))
    jax_export(jp, jax_get_model(model), cfg, ds.n_ent, ds.n_rel,
               str(tmp_path / "ckpt" / "embedding.vec.json"))
    evaluate.main(["--input", str(tmp_path / "kg"), "--checkpoint",
                   str(tmp_path / "ckpt"), "--model", model, "--hidden_size",
                   str(cfg.hidden_size), "--p_norm", str(p), "--eval_chunk",
                   "16", "--device", "cpu", "--link_prediction",
                   "--triple_classification", "--predict_tail", "0,0",
                   "--predict_head", "1,2", "--topk", "5"])
    out = capsys.readouterr().out
    assert jax_link_prediction(jp, cfg, ds, idx).format_table() in out
    assert "triple classification: {'accuracy':" in out
    assert "top-5 tails for (0, r=0, ?):" in out
    assert "top-5 heads for (?, r=2, 1):" in out
